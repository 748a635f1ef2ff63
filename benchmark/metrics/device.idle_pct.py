"""device.idle_pct: 100 minus the share of the profiled segment's wall time
in which the device ran an operation (the union of its kernel, copy and
set intervals in torch.profiler's trace)."""


def read(data):
    dev = data["device"]
    if dev is None or dev.busy_s <= 0 or dev.window_s <= 0:
        return None
    return 100.0 * (1.0 - dev.busy_s / dev.window_s)
