"""What the traced run reads from torch.profiler's raw events, and the
benchmark's own host spans around calls into the port.

The profiler records the CUDA activity alone: the CUDA runtime's calls on
the host and the device's kernels, copies and sets. Its raw events are
summarised in memory (no Chrome trace is written): the union of the
device's busy intervals, the kernel launches (cudaLaunchKernel,
cudaLaunchKernelExC, cuLaunchKernel and cuLaunchKernelEx), the device
time by operation, and the idle gaps between busy intervals, each put
down to the innermost host span open when it began. The reading of raw
events and the busy union follow the port's ``chip_smoke.device_profile``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
SYNC_CALL = "cudaDeviceSynchronize"
NAME_CHARS = 96  # operation names in the breakdown are cut to this length
TOP = 10         # entries of each breakdown list


def busy_union(spans):
    """Total length of the union of intervals (start, end), and the union
    as a sorted list of disjoint intervals."""
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def short_name(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


class HostSpans:
    """Host intervals (perf_counter_ns) of named calls, recorded by
    wrappers the benchmark puts around the port's functions while a traced
    segment runs. Names are ranked innermost first in ``order``."""

    def __init__(self, order):
        self.order = list(order)
        self.spans: Dict[str, List[Tuple[int, int]]] = {n: [] for n in order}

    def wrap(self, name, fn):
        spans = self.spans[name]

        def wrapped(*args, **kwargs):
            t0 = time.perf_counter_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                spans.append((t0, time.perf_counter_ns()))

        return wrapped

    @contextlib.contextmanager
    def span(self, name):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.spans[name].append((t0, time.perf_counter_ns()))

    def labels(self, at_ns, outside: str):
        """The innermost span name open at each host time in at_ns, or
        `outside` where none is."""
        at = np.asarray(at_ns, np.int64)
        out = np.full(at.shape, outside, dtype=object)
        done = np.zeros(at.shape, bool)
        for name in self.order:
            spans = sorted(self.spans[name])
            if not spans:
                continue
            starts = np.asarray([a for a, _ in spans], np.int64)
            ends = np.asarray([b for _, b in spans], np.int64)
            i = np.searchsorted(starts, at, side="right") - 1
            inside = (i >= 0) & (at < ends[np.maximum(i, 0)]) & ~done
            out[inside] = name
            done |= inside
        return out


@dataclasses.dataclass
class DeviceSummary:
    """What one profiled segment read."""

    window_s: float
    busy_s: float
    launches: int
    frames: int
    kernel_s: Dict[str, List[float]]   # device op name -> durations (s)
    idle_by_label: Dict[str, float]   # host span name -> idle seconds

    def kernel_times(self, needle: str) -> List[float]:
        return [d for name, ds in self.kernel_s.items() if needle in name
                for d in ds]

    def breakdown(self) -> dict:
        ops = sorted(((short_name(n), sum(ds)) for n, ds in
                      self.kernel_s.items()), key=lambda kv: -kv[1])
        merged: Dict[str, float] = {}
        for name, s in ops:
            merged[name] = merged.get(name, 0.0) + s
        top = sorted(merged.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.idle_by_label.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n, s] for n, s in top],
                "idle_gaps": [[n, s] for n, s in gaps]}


def summarise(events, device_type, seg_ns: Tuple[int, int],
              calib_ns: Optional[int], spans: Optional[HostSpans],
              frames: int, outside: str = "harness") -> DeviceSummary:
    """Reduce the profiler's raw events over one segment. seg_ns: the
    segment's host bounds (perf_counter_ns); calib_ns: the host time just
    before the segment's first cudaDeviceSynchronize, which ties the
    profiler's clock to the host's (None: the gaps go unlabelled)."""
    device, launches = [], 0
    first_sync = None
    kernel_s: Dict[str, List[float]] = {}
    for e in events:
        if e.device_type() == device_type:
            a = e.start_ns()
            d = e.duration_ns()
            device.append((a, a + d))
            kernel_s.setdefault(e.name(), []).append(d / 1e9)
            continue
        name = e.name()
        if name in LAUNCH_CALLS:
            launches += 1
        elif name == SYNC_CALL and first_sync is None:
            first_sync = e.start_ns()
    busy_ns, merged = busy_union(device)
    window_ns = seg_ns[1] - seg_ns[0]
    idle: Dict[str, float] = {}
    if merged and calib_ns is not None and first_sync is not None:
        offset = first_sync - calib_ns      # profiler clock - host clock
        lo, hi = seg_ns[0] + offset, seg_ns[1] + offset
        edges = [lo] + [x for ab in merged for x in ab] + [hi]
        starts = np.asarray(edges[0::2], np.int64)
        ends = np.asarray(edges[1::2], np.int64)
        keep = ends > starts
        starts, ends = np.maximum(starts[keep], lo), np.minimum(ends[keep], hi)
        keep = ends > starts
        starts, ends = starts[keep], ends[keep]
        labels = (spans.labels(starts - offset, outside) if spans
                  else np.full(starts.shape, outside, dtype=object))
        for label, length in zip(labels, (ends - starts) / 1e9):
            idle[label] = idle.get(label, 0.0) + float(length)
    return DeviceSummary(window_s=window_ns / 1e9, busy_s=busy_ns / 1e9,
                         launches=launches, frames=frames, kernel_s=kernel_s,
                         idle_by_label=idle)
