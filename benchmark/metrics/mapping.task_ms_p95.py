"""mapping.task_ms_p95: 95th percentile of the per-frame mapping task's
time (SLAMSystem._mapmaker_step under StageTimer's "mapmaker", ended by a
synchronisation), in the traced run's stage-timer segment."""

from benchmark.metrics import common


def read(data):
    return common.stage_percentile_ms(data, "mapmaker", 95)
