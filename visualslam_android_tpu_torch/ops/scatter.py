"""Fixed-order segmented sums: bundle adjustment's scatter sums.

``segmented_sum(out, plan, src)`` adds every row of ``src`` [M, ...] into
the row of ``out`` [R, ...] that a row index names, in place, as
``out.index_add_(0, index, src)`` does. The index comes as a ``Plan``,
made once by ``make_plan(index, R, keep)``: the stable argsort of the
index and the offset of each output row's terms in that order; terms
outside ``keep`` sort past the last row and are never read. Bundle
adjustment makes its plans once per call, since its indices do not change
between LM iterations, and leaves out the measurements that are invalid
when the call starts: they add exact zeros to every sum, and on a map
most of the table's slots are such, all with one camera index, which would
make one row hold most of the terms.

On a CUDA tensor the wrapper launches the hand-written kernel of
``csrc/segsum.cu`` (``segmented_sum_kernel``), which adds each row's terms
in a fixed order without atomics, so a run repeats itself bit for bit; an
error from its build or launch propagates. On a CPU tensor it runs the plain
version, ``segmented_sum_reference``: ``index_add_`` over the sorted index,
which adds each row's terms in their original order (the sort is stable),
bit for bit what ``index_add_`` over the unsorted index gives.

This replaces no Pallas kernel: it is the card's form of the JAX package's
``.at[].add`` in ``models/bundle.py``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from visualslam_android_tpu_torch.ops import cuda_build
from visualslam_android_tpu_torch.utils.tensors import TensorTree

# Kernel launches in this process: the wrapper adds one where it has
# launched its kernel, and nowhere else (as ops/fast.LAUNCHES).
LAUNCHES = {"segmented_sum": 0}

# Values per row (F) the kernel takes: the 6-vectors and the 6x6 blocks.
KERNEL_WIDTHS = (6, 36)
MAX_THREADS = 256

_SOURCE = "segsum.cu"


@dataclasses.dataclass(frozen=True)
class Plan(TensorTree):
    """The order of a segmented sum over n_rows output rows."""

    sorted_index: torch.Tensor  # [M] int64, the row index in sorted order
    #                             (n_rows for a term left out)
    perm: torch.Tensor          # [M] int32, stable argsort of the index
    row_start: torch.Tensor     # [n_rows + 1] int32, each row's first term
    #                             (row_start[n_rows]: the terms kept)

    @property
    def n_rows(self) -> int:
        return self.row_start.shape[0] - 1


def make_plan(index, n_rows: int, keep=None) -> Plan:
    """The plan of a sum into n_rows rows by `index` (any shape, flattened;
    values in [0, n_rows)). keep (bool, index's shape, or None for all):
    the terms to add; a term left out must be one that would add zeros.
    A stable sort and a search of the n_rows + 1 row bounds in it: no host
    read."""
    index = index.reshape(-1).long()
    if index.numel() >= 2 ** 31 or n_rows >= 2 ** 31 - 1:
        raise ValueError(f"make_plan takes fewer than 2^31 terms and rows, "
                         f"got {index.numel()} and {n_rows}")
    if keep is not None:
        index = torch.where(keep.reshape(-1), index, n_rows)
    sorted_index, perm = torch.sort(index, stable=True)
    bounds = torch.arange(n_rows + 1, device=index.device)
    row_start = torch.searchsorted(sorted_index, bounds, out_int32=True)
    return Plan(sorted_index=sorted_index, perm=perm.to(torch.int32),
                row_start=row_start)


def threads_for(n_terms: int, n_rows: int) -> int:
    """The kernel's threads per row: a power of two in [32, MAX_THREADS],
    about four terms a thread at the mean row length. It depends on the
    shapes alone, so one problem always adds in the same order."""
    mean = -(-n_terms // max(n_rows, 1))
    threads = 32
    while threads < MAX_THREADS and 4 * threads < mean:
        threads *= 2
    return threads


@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.load(_SOURCE)
    lib.segmented_sum.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.segmented_sum.restype = ctypes.c_int
    return lib


def build_kernel() -> str:
    """Compile the kernel now (it is otherwise built at first launch);
    returns the library path."""
    return cuda_build.build(_SOURCE)


def _check(out, plan: Plan, src):
    if out.dtype != torch.float32 or src.dtype != torch.float32:
        raise ValueError(f"segmented_sum takes float32 tensors, got "
                         f"{out.dtype} and {src.dtype}")
    if out.dim() < 1 or out.shape[1:] != src.shape[1:]:
        raise ValueError(f"segmented_sum: rows of out {tuple(out.shape)} and "
                         f"src {tuple(src.shape)} differ in shape")
    if plan.n_rows != out.shape[0] or plan.perm.shape[0] != src.shape[0]:
        raise ValueError(
            f"segmented_sum: a plan of {plan.perm.shape[0]} terms into "
            f"{plan.n_rows} rows for src {tuple(src.shape)} into out "
            f"{tuple(out.shape)}")
    device = out.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"segmented_sum runs on cpu or cuda, got {device}")
    if any(t.device != device for t in (src, plan.perm, plan.row_start)):
        raise ValueError("segmented_sum takes tensors of one device")


def segmented_sum(out, plan: Plan, src):
    """out[index[m]] += src[m] for every m, in place; returns out. CUDA
    tensors go through the kernel, CPU tensors through
    segmented_sum_reference."""
    _check(out, plan, src)
    if out.device.type == "cpu":
        return segmented_sum_reference(out, plan, src)
    width = math.prod(out.shape[1:])
    if width not in KERNEL_WIDTHS:
        raise ValueError(f"segmented_sum's kernel takes rows of "
                         f"{KERNEL_WIDTHS} values, got {tuple(out.shape[1:])}")
    if not out.is_contiguous():
        raise ValueError("segmented_sum adds into a contiguous out")
    n_rows, n_terms = out.shape[0], src.shape[0]
    if n_terms == 0 or n_rows == 0:
        return out
    src = src.contiguous()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = _library().segmented_sum(
            out.data_ptr(), src.data_ptr(), plan.perm.data_ptr(),
            plan.row_start.data_ptr(), n_rows, width,
            threads_for(n_terms, n_rows), stream)
    if err != 0:
        raise RuntimeError(f"segmented_sum launch failed: cudaError_t {err}")
    LAUNCHES["segmented_sum"] += 1
    return out


def segmented_sum_reference(out, plan: Plan, src):
    """Plain PyTorch segmented_sum: index_add_ over the sorted index, each
    row's terms in their original order, into out and a spare row that
    takes the terms left out."""
    spare = torch.cat([out, out.new_zeros(1, *out.shape[1:])])
    spare.index_add_(0, plan.sorted_index, src.index_select(0, plan.perm))
    return out.copy_(spare[:-1])
