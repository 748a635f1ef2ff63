"""Dataclasses of tensors: the port's counterpart of the JAX package's
NamedTuple pytrees (map stores, frames, camera, SBI)."""

from __future__ import annotations

import dataclasses
import functools

import torch


@functools.lru_cache(maxsize=256)
def const(values, device, dtype=torch.float32):
    """A constant tensor made once per (values, device, dtype). Creating
    it from host data on every call would copy from pageable memory, which
    waits for the device's stream; the per-frame path calls this instead.
    Callers must not modify the result."""
    return torch.tensor(values, dtype=dtype, device=device)


def default_device(device=None) -> torch.device:
    """The device a constructor of this package builds its state on: the
    one the caller names, else the CUDA card. Without a card there is no
    silent fall-back to the CPU: the caller asks for it by name."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available and no device was named: pass "
            'device="cpu" to build and run on the CPU'
        )
    return torch.device("cuda")


def _move(value, device):
    if isinstance(value, torch.Tensor):
        return value.to(device)
    if isinstance(value, TensorTree):
        return value.to(device)
    if isinstance(value, tuple):
        return tuple(_move(v, device) for v in value)
    return value


class TensorTree:
    """Mixin for dataclasses whose fields are tensors, tuples of tensors or
    other TensorTrees."""

    def to(self, device):
        return dataclasses.replace(
            self,
            **{f.name: _move(getattr(self, f.name), device)
               for f in dataclasses.fields(self)},
        )

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)
