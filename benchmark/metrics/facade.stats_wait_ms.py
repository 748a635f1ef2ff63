"""facade.stats_wait_ms: mean wait of the facade's stats read
(SLAMSystem._read_stats under StageTimer's "stats_pull"), per tracked
frame, in the traced run's stage-timer segment."""

from benchmark.metrics import common


def read(data):
    return common.stage_mean_ms(data, "stats_pull")
