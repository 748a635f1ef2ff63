"""Dataclasses of tensors: the port's counterpart of the JAX package's
NamedTuple pytrees (map stores, frames, camera, SBI)."""

from __future__ import annotations

import dataclasses
import functools

import torch


@functools.lru_cache(maxsize=None)
def const(values, device, dtype=torch.float32):
    """A constant tensor made once per (values, device, dtype). Creating
    it from host data on every call would copy from pageable memory, which
    waits for the device's stream; the per-frame path calls this instead.
    Callers must not modify the result. The cache keeps every constant for
    the life of the process: a captured CUDA graph reads them by address
    (models/step_graph.py), so none may be freed."""
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


def tree_map(fn, value):
    """`value` (a tensor, a tuple or a TensorTree) with every tensor x
    replaced by fn(x), structure kept."""
    if isinstance(value, torch.Tensor):
        return fn(value)
    if isinstance(value, TensorTree):
        return value._map(fn)
    if isinstance(value, tuple):
        return tuple(tree_map(fn, v) for v in value)
    return value


def tree_leaves(value):
    """The tensors of a tensor, a tuple or a TensorTree, in field order."""
    out = []
    tree_map(lambda x: out.append(x) or x, value)
    return out


class TensorTree:
    """Mixin for dataclasses whose fields are tensors, tuples of tensors or
    other TensorTrees."""

    def _map(self, fn):
        return dataclasses.replace(
            self,
            **{f.name: tree_map(fn, getattr(self, f.name))
               for f in dataclasses.fields(self)},
        )

    def to(self, device):
        return self._map(lambda x: x.to(device))

    def clone(self):
        """A deep copy: every tensor cloned (functions that write a store
        in place, such as keyframe.insert_keyframe, leave the copy alone)."""
        return self._map(torch.clone)

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)
