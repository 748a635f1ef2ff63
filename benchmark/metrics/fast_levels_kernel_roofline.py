"""fast_levels_kernel_roofline: share of its roofline that csrc/fast.cu's
fast_levels_kernel reaches: its least time (9 B a pixel over the frame's
pyramid at 3.35 TB/s, the larger of that and its operations at 67
TFLOP/s; reference/roofline.py) for every launch in the profiled segment,
over their device time in the trace."""

from benchmark.reference import roofline


def read(data):
    dev = data["device"]
    if dev is None:
        return None
    times = dev.kernel_times("fast_levels_kernel")
    if not times or sum(times) <= 0:
        return None
    least = roofline.fast_levels_least_s(*data["frame"])
    return 100.0 * least * len(times) / sum(times)
