"""Per-stage wall-clock timing and profiler trace capture.

Port of the JAX package's ``utils/profiling.py``. A stage is done when the
device has finished its work, not when the host has issued it, so a timed
stage calls ``sync`` on its outputs: ``torch.cuda.synchronize`` on the
device of each CUDA tensor among them, nothing for CPU tensors.

Usage:
    timer = StageTimer()
    with timer.stage("track"):
        out = track_map(...)
        timer.sync(out)
    print(timer.report())
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, List, Optional

import torch


def _cuda_devices(value, found):
    """Collects the CUDA devices of the tensors in value (a tensor, a
    dataclass of tensors, or a tuple, list or dict of those)."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            found.add(value.device)
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        for f in dataclasses.fields(value):
            _cuda_devices(getattr(value, f.name), found)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _cuda_devices(v, found)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, found)


class StageTimer:
    """Accumulates wall-clock samples per named stage."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.samples: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield self
            return
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.samples.setdefault(name, []).append(
                time.perf_counter() - t0)

    def sync(self, *outputs):
        """Wait until the device work producing `outputs` is done, so the
        enclosing stage measures compute, not issue. Nothing while disabled:
        a synchronisation per stage would serialise the frame loop for
        nothing when no one is timing it."""
        if not self.enabled:
            return
        devices = set()
        _cuda_devices(outputs, devices)
        for device in devices:
            torch.cuda.synchronize(device)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self.samples.items():
            xs_s = sorted(xs)
            n = len(xs_s)
            out[name] = {
                "count": n,
                "total_s": sum(xs_s),
                "mean_ms": 1e3 * sum(xs_s) / n,
                "p50_ms": 1e3 * xs_s[n // 2],
                "max_ms": 1e3 * xs_s[-1],
            }
        return out

    def report(self) -> str:
        rows = sorted(self.summary().items(), key=lambda kv: -kv[1]["total_s"])
        lines = [f"{'stage':<24}{'count':>7}{'total s':>10}{'mean ms':>10}"
                 f"{'p50 ms':>10}{'max ms':>10}"]
        for name, s in rows:
            lines.append(
                f"{name:<24}{s['count']:>7d}{s['total_s']:>10.3f}"
                f"{s['mean_ms']:>10.2f}{s['p50_ms']:>10.2f}"
                f"{s['max_ms']:>10.2f}")
        return "\n".join(lines)

    def reset(self):
        self.samples.clear()


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """Records the enclosed work with torch.profiler (host operators, and
    the CUDA kernels where a card is present) and writes it as a Chrome
    trace, ``trace.json``, into log_dir; None records nothing. The
    counterpart of the JAX package's xla_trace."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
