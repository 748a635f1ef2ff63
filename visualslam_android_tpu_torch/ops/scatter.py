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
``csrc/segsum.cu``, which adds each row's terms in a fixed order without
atomics, so a run repeats itself bit for bit; an error from its build or
launch propagates. The order: T = ``threads_for(M, R)`` chains, chain t
summing the row's terms t, t + T, ... one after another from 0.0, then a
tree over the chains (at level s = T/2, ..., 1, slot u < s takes slot
u + s), then the result added to the row. The kernel takes one of two
paths by the shapes (``path_for``: many rows, a group of T / 32 warps a
row staging its terms through shared memory; few rows, groups over (row,
slice of the values)), both making exactly these additions;
``segmented_sum_ordered_reference`` makes them with elementwise PyTorch
adds, so it gives the kernel's bits. On a CPU tensor the wrapper runs
``segmented_sum_reference``: ``index_add_`` over the sorted index, which
adds each row's terms in their original order (the sort is stable), bit
for bit what ``index_add_`` over the unsorted index gives.

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

# Values per row (F) the kernel takes: the 6-vectors and the 6x6 blocks.
KERNEL_WIDTHS = (6, 36)
MAX_THREADS = 256
# The kernel's two paths (their codes in csrc/segsum.cu): "short", a group
# of T / 32 warps a row through shared memory, where the rows give at
# least SHORT_MIN_WARPS warps; else "long", groups over (row, slice of the
# values), which spreads few long rows over the card.
PATHS = ("short", "long")
SHORT_MIN_WARPS = 1024
_PATH_CODES = {"short": 1, "long": 2}
# Bytes of src's alignment the short path's cp.async pieces need, by F.
_SHORT_ALIGN = {36: 16, 6: 8}

# Kernel launches in this process: the wrapper adds one where it has
# launched its kernel, and nowhere else (as ops/fast.LAUNCHES); under
# "segmented_sum" all of them, under launch_kind(F, path) those of one
# width and path.
LAUNCHES = {"segmented_sum": 0}


def launch_kind(width: int, path: str) -> str:
    return f"segmented_sum F={width} {path}"


LAUNCHES.update({launch_kind(w, p): 0 for w in KERNEL_WIDTHS for p in PATHS})

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


def path_for(n_terms: int, n_rows: int) -> str:
    """The kernel's path for these shapes: "short" where the rows give at
    least SHORT_MIN_WARPS warps, else "long"."""
    warps = n_rows * threads_for(n_terms, n_rows) // 32
    return "short" if warps >= SHORT_MIN_WARPS else "long"


@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.load(_SOURCE)
    pointers = [ctypes.c_void_p] * 4
    lib.segmented_sum.argtypes = pointers + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.segmented_sum_rowblock.argtypes = pointers + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.segmented_sum.restype = ctypes.c_int
    lib.segmented_sum_rowblock.restype = ctypes.c_int
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


def _launch(out, plan: Plan, src, rowblock=False, path=None):
    """Launch csrc/segsum.cu's kernel on checked CUDA tensors: on `path`
    (default path_for's; a src not aligned for the short path's pieces
    takes the long one), or (rowblock) the first version, the yardstick.
    Returns the path launched (None on an empty sum, or for rowblock), or
    raises."""
    width = math.prod(out.shape[1:])
    if width not in KERNEL_WIDTHS:
        raise ValueError(f"segmented_sum's kernel takes rows of "
                         f"{KERNEL_WIDTHS} values, got {tuple(out.shape[1:])}")
    if not out.is_contiguous():
        raise ValueError("segmented_sum adds into a contiguous out")
    n_rows, n_terms = out.shape[0], src.shape[0]
    if n_terms == 0 or n_rows == 0:
        return None
    src = src.contiguous()
    pointers = (out.data_ptr(), src.data_ptr(), plan.perm.data_ptr(),
                plan.row_start.data_ptr())
    threads = threads_for(n_terms, n_rows)
    path = path_for(n_terms, n_rows) if path is None else path
    if path == "short" and src.data_ptr() % _SHORT_ALIGN[width]:
        path = "long"
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        if rowblock:
            path = None
            err = _library().segmented_sum_rowblock(
                *pointers, n_rows, width, threads, stream)
        else:
            err = _library().segmented_sum(
                *pointers, n_rows, width, threads, _PATH_CODES[path], stream)
    if err != 0:
        raise RuntimeError(f"segmented_sum launch failed: cudaError_t {err}")
    return path


def segmented_sum(out, plan: Plan, src):
    """out[index[m]] += src[m] for every m, in place; returns out. CUDA
    tensors go through the kernel, CPU tensors through
    segmented_sum_reference."""
    _check(out, plan, src)
    if out.device.type == "cpu":
        return segmented_sum_reference(out, plan, src)
    path = _launch(out, plan, src)
    if path is not None:
        LAUNCHES["segmented_sum"] += 1
        LAUNCHES[launch_kind(math.prod(out.shape[1:]), path)] += 1
    return out


def segmented_sum_rowblock(out, plan: Plan, src):
    """The kernel's first version (one block per row), which makes the
    same additions: a yardstick that only chip_smoke.py launches, on CUDA
    tensors; not counted in LAUNCHES."""
    _check(out, plan, src)
    _launch(out, plan, src, rowblock=True)
    return out


def segmented_sum_reference(out, plan: Plan, src):
    """Plain PyTorch segmented_sum: index_add_ over the sorted index, each
    row's terms in their original order, into out and a spare row that
    takes the terms left out."""
    spare = torch.cat([out, out.new_zeros(1, *out.shape[1:])])
    spare.index_add_(0, plan.sorted_index, src.index_select(0, plan.perm))
    return out.copy_(spare[:-1])


# Elements of the zero-padded [rows, steps, T, F] tensor that
# segmented_sum_ordered_reference builds at a time.
_ORDERED_GROUP_ELEMENTS = 1 << 24


def segmented_sum_ordered_reference(out, plan: Plan, src, threads=None):
    """Plain PyTorch segmented_sum in the kernel's order, bit for bit the
    kernel's result: each kept term placed at (row, step k // T, chain
    k % T) of a zero-padded [rows, steps, T, F] tensor (k its place in its
    row), the steps added in order onto 0.0, the tree levels run, the
    result added to the row; rows without terms keep their bits. threads:
    T (default threads_for(M, R), the kernel's). Adding a padding zero
    changes no bits: a chain's sum starts at +0.0 and is never -0.0. Reads
    the row lengths to the host; used by the tests and chip_smoke.py, on
    no path."""
    _check(out, plan, src)
    n_rows = plan.n_rows
    T = threads_for(src.shape[0], n_rows) if threads is None else threads
    width = math.prod(out.shape[1:])
    starts = plan.row_start.long()
    counts = starts[1:] - starts[:-1]
    hit = torch.nonzero(counts > 0).reshape(-1)
    if hit.numel() == 0:
        return out
    n_kept = int(starts[-1])
    terms = src.reshape(src.shape[0], width).index_select(
        0, plan.perm[:n_kept].long())
    rows = plan.sorted_index[:n_kept]
    k = torch.arange(n_kept, device=out.device) - starts[rows]
    slot = torch.cumsum(counts > 0, 0) - 1      # a hit row's place in hit
    term_slot = slot[rows]
    flat = out.reshape(n_rows, width).clone()
    hit_counts = counts[hit].tolist()
    hit_starts = starts[hit].tolist()
    a = 0
    while a < len(hit_counts):
        # A group of hit rows whose padded tensor stays within the budget.
        b, longest = a, 0
        while b < len(hit_counts):
            longest_b = max(longest, hit_counts[b])
            steps = -(-longest_b // T)
            if b > a and (b + 1 - a) * steps * T * width > \
                    _ORDERED_GROUP_ELEMENTS:
                break
            longest, b = longest_b, b + 1
        steps = -(-longest // T)
        t0, t1 = hit_starts[a], hit_starts[b - 1] + hit_counts[b - 1]
        pad = terms.new_zeros(b - a, steps, T, width)
        kk = k[t0:t1]
        pad[term_slot[t0:t1] - a, kk // T, kk % T] = terms[t0:t1]
        acc = terms.new_zeros(b - a, T, width)
        for step in range(steps):
            acc = acc + pad[:, step]
        s = T // 2
        while s >= 1:
            acc = acc[:, :s] + acc[:, s:2 * s]
            s //= 2
        flat[hit[a:b]] = flat[hit[a:b]] + acc[:, 0]
        a = b
    return out.copy_(flat.reshape(out.shape))
