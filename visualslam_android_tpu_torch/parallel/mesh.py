"""A one-axis device mesh over torch.distributed: the port's counterpart
of the JAX package's ``jax.sharding.Mesh`` with ``shard_map`` and the
``lax`` collectives.

One process per rank. Each rank runs the same program on its shard, and
the collectives below take the place of ``lax.psum``, ``all_gather``,
``psum_scatter``, ``ppermute`` and ``axis_index`` over the mesh axis.

The backend and the transport are the caller's choice, never picked by
catching an error:

- ``backend="nccl"`` with ``transport="device"``: every collective is an
  NCCL call on the rank's CUDA tensors;
- ``backend="gloo"`` with ``transport="host"``: each collective copies its
  tensor to the CPU, runs the gloo collective and copies the result back
  to the rank's device. The copies are counted in ``HOST_COPIES``. Several
  ranks may then share one card (NCCL refuses two ranks on one device).

Every collective first checks that all ranks entered it with the same
kind, shape and dtype (an all_gather of a 9-integer descriptor; not
counted as payload), and raises on every rank if not, where a mismatch
would otherwise hang or sum the wrong elements.

``COMM_SITES`` counts the payload of every collective by the site the
caller names (the items of ``parallel/sharded_ba.comm_bytes_per_lm_step``;
a call that names no site counts under its kind). The payload is what
every rank ends up holding: the reduced tensor of a psum, the gathered
tensor of an all_gather, the summed input of a psum_scatter, the sent
strip of a ppermute, the broadcast tensor. Callers set the counters to 0
with ``reset_counters`` and read them, as with ``ops/fast.LAUNCHES``.

``run_ranks`` starts the ranks of a program with torch.multiprocessing
(spawn) and a file-store rendezvous under a temporary directory, and
returns each rank's result as numpy. Any rank's exception, or the
timeout, raises in the caller, so a hang fails instead of waiting.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import shutil
import sys
import tempfile
import time
import warnings

import torch
import torch.distributed as dist

from visualslam_android_tpu_torch.utils.tensors import TensorTree

KINDS = ("psum", "all_gather", "psum_scatter", "ppermute", "broadcast")
COMM_SITES: dict = {}
HOST_COPIES = {"to_host": 0, "to_device": 0}

_PAIRS = {"nccl": "device", "gloo": "host"}
_DTYPES = (torch.float32, torch.float64, torch.int32, torch.int64,
           torch.uint8, torch.bool)
_MAX_DIMS = 6

# The tensor-in/tensor-out collectives of older releases; newer ones warn
# that they are renamed.
warnings.filterwarnings("ignore", message=r".*all_gather_into_tensor.*",
                        category=FutureWarning)
warnings.filterwarnings("ignore", message=r".*reduce_scatter_tensor.*",
                        category=FutureWarning)


def reset_counters():
    COMM_SITES.clear()
    HOST_COPIES.update(to_host=0, to_device=0)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One mesh axis over the ranks of the default process group."""

    rank: int
    size: int
    device: torch.device
    transport: str  # "device" | "host"


def resolve_device(device, rank: int) -> torch.device:
    """The rank's device: the one named, else the CUDA card rank mod the
    number of cards. Without a card there is no silent fall-back to the
    CPU: the caller asks for it by name."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available and no device was named: pass "
            'device="cpu" (with backend="gloo", transport="host") to run '
            "the ranks on the CPU"
        )
    return torch.device("cuda", rank % torch.cuda.device_count())


def _check_pair(backend, transport):
    if backend not in _PAIRS:
        raise ValueError(f"unknown backend {backend!r}")
    if _PAIRS[backend] != transport:
        raise ValueError(
            f"backend {backend!r} runs with transport "
            f"{_PAIRS[backend]!r}, not {transport!r}")


def init_mesh(backend: str, rank: int, world_size: int, init_method: str,
              transport: str, device=None, timeout: float = 600.0) -> Mesh:
    """Join the process group and return this rank's Mesh. device=None is
    the CUDA card (and raises where there is none). A failed
    initialization raises."""
    _check_pair(backend, transport)
    dev = resolve_device(device, rank)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"backend 'nccl' needs a CUDA device, not {dev}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout))
    return make_mesh(transport, device=dev)


def make_mesh(transport: str, device=None) -> Mesh:
    """The Mesh of the running default process group (the port's
    ``make_mesh``: every rank of the group on one axis)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group is running: call init_mesh")
    _check_pair(str(dist.get_backend()), transport)
    rank = dist.get_rank()
    return Mesh(rank=rank, size=dist.get_world_size(),
                device=resolve_device(device, rank), transport=transport)


def axis_index(mesh: Mesh) -> int:
    """lax.axis_index: this rank's position on the axis."""
    return mesh.rank


def _check(mesh: Mesh, kind: str, x):
    """x may enter the collective `kind` here, and every rank enters it
    with x's shape and dtype; raises otherwise (on every rank when the
    ranks differ)."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"a collective takes a tensor, not {type(x)}")
    if x.device != mesh.device:
        raise ValueError(f"tensor on {x.device}, the rank's device is "
                         f"{mesh.device}")
    if x.dtype not in _DTYPES or x.dim() > _MAX_DIMS:
        raise ValueError(f"collective of {x.dtype} {tuple(x.shape)}")
    if mesh.size == 1:
        return
    desc = ([KINDS.index(kind), _DTYPES.index(x.dtype), x.dim()]
            + list(x.shape) + [-1] * (_MAX_DIMS - x.dim()))
    dev = "cpu" if mesh.transport == "host" else mesh.device
    out = torch.empty(mesh.size * len(desc), dtype=torch.int64, device=dev)
    dist.all_gather_into_tensor(
        out, torch.tensor(desc, dtype=torch.int64, device=dev))
    rows = out.view(mesh.size, -1).tolist()
    if any(r != rows[0] for r in rows):
        raise ValueError(f"the ranks entered {kind} with different "
                         f"[kind, dtype, ndim, shape] descriptors: {rows}")


def _count(kind, site, nbytes):
    key = site or kind
    COMM_SITES[key] = COMM_SITES.get(key, 0) + nbytes


def _wire(mesh: Mesh, x):
    """A contiguous copy of x where the collective runs: on the CPU for
    the host transport (counted), else on the rank's device. bool goes as
    uint8."""
    if x.dtype == torch.bool:
        x = x.view(torch.uint8)
    if mesh.transport == "host":
        if x.device.type != "cpu":
            HOST_COPIES["to_host"] += x.numel() * x.element_size()
        return x.to("cpu", copy=True).contiguous()
    return x.clone(memory_format=torch.contiguous_format)


def _empty(mesh: Mesh, shape, dtype):
    dtype = torch.uint8 if dtype == torch.bool else dtype
    dev = "cpu" if mesh.transport == "host" else mesh.device
    return torch.empty(shape, dtype=dtype, device=dev)


def _back(mesh: Mesh, y, dtype):
    """The collective's result on the rank's device, in the caller's
    dtype."""
    if mesh.transport == "host" and mesh.device.type != "cpu":
        HOST_COPIES["to_device"] += y.numel() * y.element_size()
        y = y.to(mesh.device)
    return y.view(torch.bool) if dtype == torch.bool else y


def psum(mesh: Mesh, x, site=None):
    """lax.psum: the elementwise sum of x over the ranks, on every rank."""
    if x.dtype == torch.bool:
        raise ValueError("psum of a bool tensor")
    _check(mesh, "psum", x)
    buf = _wire(mesh, x)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    _count("psum", site, buf.numel() * buf.element_size())
    return _back(mesh, buf, x.dtype)


def all_gather(mesh: Mesh, x, site=None):
    """lax.all_gather(tiled=True) along axis 0: [n, ...] on each rank ->
    [size * n, ...], rank r's block at rows [r n, (r + 1) n)."""
    _check(mesh, "all_gather", x)
    buf = _wire(mesh, x)
    out = _empty(mesh, (mesh.size * x.shape[0],) + tuple(x.shape[1:]),
                 buf.dtype)
    dist.all_gather_into_tensor(out, buf)
    _count("all_gather", site, out.numel() * out.element_size())
    return _back(mesh, out, x.dtype)


def psum_scatter(mesh: Mesh, x, site=None):
    """lax.psum_scatter(scatter_dimension=0, tiled=True): [size * n, ...]
    summed over the ranks, rank r keeping rows [r n, (r + 1) n)."""
    if x.dtype == torch.bool or x.shape[0] % mesh.size:
        raise ValueError(f"psum_scatter of {x.dtype} {tuple(x.shape)} over "
                         f"{mesh.size} ranks")
    _check(mesh, "psum_scatter", x)
    buf = _wire(mesh, x)
    out = _empty(mesh, (x.shape[0] // mesh.size,) + tuple(x.shape[1:]),
                 buf.dtype)
    dist.reduce_scatter_tensor(out, buf, op=dist.ReduceOp.SUM)
    _count("psum_scatter", site, buf.numel() * buf.element_size())
    return _back(mesh, out, x.dtype)


def ppermute_right(mesh: Mesh, x, site=None):
    """lax.ppermute with perm [(d, d + 1) for d < size - 1]: rank r sends x
    to rank r + 1 and returns what rank r - 1 sent; rank 0 returns zeros
    and the last rank sends nothing."""
    _check(mesh, "ppermute", x)
    buf = _wire(mesh, x)
    recv = torch.zeros_like(buf)
    ops = []
    if mesh.rank < mesh.size - 1:
        ops.append(dist.P2POp(dist.isend, buf, mesh.rank + 1))
    if mesh.rank > 0:
        ops.append(dist.P2POp(dist.irecv, recv, mesh.rank - 1))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    _count("ppermute", site, buf.numel() * buf.element_size())
    return _back(mesh, recv, x.dtype)


def broadcast(mesh: Mesh, x, src: int, site=None):
    """x of rank `src` on every rank (the other ranks' x gives the shape
    and dtype only)."""
    _check(mesh, "broadcast", x)
    buf = _wire(mesh, x)
    dist.broadcast(buf, src)
    _count("broadcast", site, buf.numel() * buf.element_size())
    return _back(mesh, buf, x.dtype)


def gather_tree(mesh: Mesh, tree, site=None):
    """all_gather of every tensor of a TensorTree (or tuple) along its
    leading axis."""
    if isinstance(tree, TensorTree):
        return tree._map(lambda x: all_gather(mesh, x, site))
    return tuple(all_gather(mesh, x, site) for x in tree)


def shard_rows(mesh: Mesh, n: int):
    """The slice of rows [r n / size, (r + 1) n / size) this rank holds."""
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split over {mesh.size} ranks")
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


# ---------------------------------------------------------------------------
# Rank launcher
# ---------------------------------------------------------------------------


def to_numpy(value):
    """Tensors (in tuples, lists, dicts and TensorTrees) -> numpy."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, TensorTree):
        return value._map(lambda x: x.detach().cpu().numpy())
    if isinstance(value, dict):
        return {k: to_numpy(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(to_numpy(v) for v in value)
    return value


def _rank_main(rank, target, world_size, backend, transport, device,
               init_method, timeout, threads, args, out_dir):
    if threads:
        torch.set_num_threads(threads)
    mesh = init_mesh(backend, rank, world_size, init_method, transport,
                     device=device, timeout=timeout)
    try:
        result = to_numpy(target(mesh, *args))
    finally:
        dist.destroy_process_group()
    foreign = sorted(m for m in ("jax", "visualslam_android_tpu")
                     if m in sys.modules)
    if foreign:
        raise RuntimeError(f"rank {rank} imported {foreign}")
    path = os.path.join(out_dir, f"rank{rank}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(path + ".tmp", path)


def run_ranks(target, world_size: int, backend: str, transport: str,
              device=None, timeout: float = 600.0, args=(), threads=None):
    """Run target(mesh, *args) on `world_size` spawned ranks and return the
    ranks' results (numpy, as to_numpy makes them), in rank order.

    target must be a module-level function (the children import it) of a
    module that imports torch and this package only. device=None puts rank
    r on CUDA card r mod the number of cards, and raises without one;
    tests pass device="cpu", backend="gloo", transport="host". threads
    sets torch's thread count in each rank. A rank's exception is raised
    here; so is the timeout, after every rank has been stopped."""
    _check_pair(backend, transport)
    if device is None:
        resolve_device(None, 0)
    out_dir = tempfile.mkdtemp(prefix="vstpu_ranks_")
    init_method = "file://" + os.path.join(out_dir, "rendezvous")
    try:
        ctx = torch.multiprocessing.start_processes(
            _rank_main, nprocs=world_size, join=False, start_method="spawn",
            args=(target, world_size, backend, transport, device,
                  init_method, timeout, threads, tuple(args), out_dir))
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(0.0, min(1.0, deadline
                                                 - time.monotonic()))):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(
                    f"{world_size} ranks of {target.__name__} did not finish "
                    f"in {timeout} s")
        results = []
        for rank in range(world_size):
            with open(os.path.join(out_dir, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)

