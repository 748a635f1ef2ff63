"""tracking.step_ms: mean time of the tracking step (frame_step under
StageTimer's "frame_step", ended by a synchronisation), per tracked frame,
in the traced run's stage-timer segment."""

from benchmark.metrics import common


def read(data):
    return common.stage_mean_ms(data, "frame_step")
