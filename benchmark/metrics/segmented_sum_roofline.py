"""segmented_sum_roofline: share of its roofline that csrc/segsum.cu's
segmented sum (segsum_staged, segsum_sliced) reaches over the profiled
segment: the summed least times of its launches, each from the work its
plan holds (reference/roofline.segsum_bytes: kept terms, rows that take
terms, the plan's indices), over their summed device time in the trace.
Nothing where no launch ran, or where the trace holds another number of
launches than the wrapper made."""

from benchmark.reference import roofline


def read(data):
    dev = data["device"]
    if dev is None or not data["segsum"]:
        return None
    times = dev.kernel_times("segsum_")
    if len(times) != len(data["segsum"]) or sum(times) <= 0:
        return None
    least = sum(roofline.segsum_least_s(*work) for work in data["segsum"])
    return 100.0 * least / sum(times)
