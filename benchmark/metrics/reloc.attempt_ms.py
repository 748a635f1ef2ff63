"""reloc.attempt_ms: mean time of a relocalization attempt (the lost
frame's front end, relocalizer.attempt_recovery and its read, under
StageTimer's "reloc"), in the traced run's stage-timer segment."""

from benchmark.metrics import common


def read(data):
    return common.stage_mean_ms(data, "reloc")
