"""Bundle adjustment with the points and their measurement rows sharded
over the ranks of a mesh.

Port of the JAX package's ``parallel/sharded_ba.py`` (SURVEY.md §2,
"sharded global BA"): each rank takes a contiguous block of the (padded)
points with their point-major measurement rows, the cameras are
replicated, and ``models/bundle.bundle_adjust(axis_name=mesh)`` sums the
camera-side arrays over the ranks. Every rank solves the same reduced
camera system and back-substitutes its own points; on return the
point-side outputs are all-gathered, so every rank holds the whole
BAResult, as the JAX package's out-specs give it.

Every function here runs on each rank of the mesh with the same global
problem (a rank reads only its own block of the point-side arrays).
``pack_problem_camblock`` and ``unpack_point_outputs`` are host numpy, as
in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from visualslam_android_tpu_torch.models.bundle import (
    BAProblem,
    BAResult,
    bundle_adjust,
)
from visualslam_android_tpu_torch.parallel import mesh as mesh_mod
from visualslam_android_tpu_torch.parallel.mesh import make_mesh  # noqa: F401

_POINT_FIELDS = ("points", "point_valid", "meas_kf", "meas_uv",
                 "meas_sqrt_inv_noise", "meas_valid")
_POINT_OUTPUTS = ("points", "meas_valid", "outlier_meas", "point_outliers")


def pad_problem(prob: BAProblem, multiple: int) -> BAProblem:
    """Pad the point dimension to a multiple of the mesh size: padded
    slots are invalid points with no valid measurement."""
    pad = (-prob.points.shape[0]) % multiple
    if pad == 0:
        return prob

    def pad_n(x):
        return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])

    return prob.replace(**{f: pad_n(getattr(prob, f)) for f in _POINT_FIELDS})


def pack_problem_camblock(prob: BAProblem, n_dev: int, band: int):
    """Pack points into camera-block bins for reduce_mode "halo": rank d
    gets exactly the points whose first observing camera lies in its block
    [d K/D, (d+1) K/D), so everything it adds to the reduced camera system
    lands in its own block or the first `band` rows of the next one (an
    observation span of at most `band`, the band assembly's own
    precondition, which raises here when it fails). Bins are padded to
    one size with invalid point slots.

    Returns (packed problem on prob's device, orig_idx [N'] int32 with -1
    on padding): unpack_point_outputs scatters point-side outputs back to
    the caller's order through it. Host numpy."""
    K = prob.cam_R.shape[0]
    if K % n_dev != 0:
        raise ValueError(f"K={K} not divisible by n_dev={n_dev}")
    rows = K // n_dev
    if band > rows:
        raise ValueError(f"band={band} > rows-per-device={rows}")

    kf = prob.meas_kf.cpu().numpy()
    mv = (prob.meas_valid & prob.point_valid[:, None]).cpu().numpy()
    has = mv.any(axis=1)
    lo = np.where(mv, kf, np.iinfo(np.int32).max).min(axis=1)
    hi = np.where(mv, kf, np.iinfo(np.int32).min).max(axis=1)
    if has.any() and int((hi - lo)[has].max()) > band:
        raise ValueError(
            f"camera span {int((hi - lo)[has].max())} exceeds band={band}")
    bins = np.where(has, np.clip(lo, 0, K - 1) // rows, 0)

    idx_by_bin = [np.nonzero(bins == d)[0] for d in range(n_dev)]
    cap = max(max((len(ix) for ix in idx_by_bin), default=1), 1)
    orig = np.full((n_dev, cap), -1, np.int32)
    for d, ix in enumerate(idx_by_bin):
        orig[d, :len(ix)] = ix
    orig = orig.reshape(-1)
    device = prob.points.device
    safe = torch.as_tensor(np.maximum(orig, 0).astype(np.int64),
                           device=device)
    pad = torch.as_tensor(orig < 0, device=device)

    packed = prob.replace(**{f: getattr(prob, f)[safe]
                             for f in _POINT_FIELDS})
    return packed.replace(
        point_valid=packed.point_valid & ~pad,
        meas_valid=packed.meas_valid & ~pad[:, None],
    ), orig


def unpack_point_outputs(res: BAResult, orig_idx, n_points: int) -> BAResult:
    """Scatter a packed run's point-side outputs back to the original
    point order (padding slots dropped)."""
    keep = np.nonzero(orig_idx >= 0)[0]
    device = res.points.device
    src = torch.as_tensor(keep.astype(np.int64), device=device)
    dst = torch.as_tensor(orig_idx[keep].astype(np.int64), device=device)

    def scat(x):
        out = x.new_zeros((n_points,) + tuple(x.shape[1:]))
        out[dst] = x[src]
        return out

    return res.replace(**{f: scat(getattr(res, f)) for f in _POINT_OUTPUTS})


def comm_bytes_per_lm_step(K, N_global, O, solver="pcg", cg_iters=250,
                           inner_iters=1, dtype_bytes=4,
                           assembly="scatter", band_halfwidth=16,
                           sigma_mode="gather", hist_bins=512,
                           reduce_mode="psum"):
    """The collectives' payload per LM outer step of
    ``bundle_adjust(axis_name=...)``, itemized (the JAX package's
    arithmetic, unchanged): what every rank ends up holding. A ring
    all-reduce moves ~2 (D-1)/D of its payload per rank, an all_gather
    (D-1)/D.

    - sigma_gather: sigma_mode "gather", the all_gather of the error table
      (err_sq f32 + ok, one byte, per measurement); "hist", one [hist_bins]
      f32 psum;
    - u_eps: U [K, 6, 6] + eps_a [K, 6];
    - solve: "pcg", E_corr [K, 6] and one [K, 6] per CG iteration per inner
      iteration; "band_pcg" or assembly "band", the band [K, 2P+1, 6, 6] +
      E_corr per inner iteration; else the dense [K, 6, K, 6] + E_corr;
    - halo (reduce_mode "halo"): the owned rows all-gathered (U, eps_a and
      the upper half band) and the halo strip sent to the right;
    - scalars: the objective and update-norm sums, (3 + inner) f32 as the
      JAX package counts them (port_scalar_bytes names the port's).
    """
    b = {}
    if sigma_mode == "hist":
        b["sigma_gather"] = hist_bins * dtype_bytes
    else:
        b["sigma_gather"] = N_global * O * (dtype_bytes + 1)
    if reduce_mode == "halo":
        row_inner = ((band_halfwidth + 1) * 36 + 6) * dtype_bytes
        b["u_eps"] = K * 42 * dtype_bytes
        b["solve"] = inner_iters * K * row_inner
        b["halo_strip"] = band_halfwidth * (
            42 + inner_iters * ((band_halfwidth + 1) * 36 + 6)
        ) * dtype_bytes
        b["scalars"] = (3 + inner_iters) * dtype_bytes
        b["total"] = sum(b.values())
        return b
    b["u_eps"] = K * 36 * dtype_bytes + K * 6 * dtype_bytes
    if solver == "pcg":
        b["solve"] = inner_iters * (K * 6 * dtype_bytes * (1 + cg_iters))
    elif solver == "band_pcg" or assembly == "band":
        b["solve"] = inner_iters * (
            K * (2 * band_halfwidth + 1) * 36 * dtype_bytes
            + K * 6 * dtype_bytes
        )
    else:
        b["solve"] = inner_iters * (
            K * 6 * K * 6 * dtype_bytes + K * 6 * dtype_bytes
        )
    b["scalars"] = (3 + inner_iters) * dtype_bytes
    b["total"] = sum(b.values())
    return b


def port_scalar_bytes(inner_iters=1, reduce_mode="psum", dtype_bytes=4):
    """The port's scalar psums per LM outer step, by name: the objective at
    the linearization, and per inner iteration the new objective with the
    points' update norm (one psum of two values); with reduce_mode "halo"
    the run's one check that every measurement lies in its rank's rows
    (bundle._check_halo_rows). comm_bytes_per_lm_step's "scalars" item is
    the JAX package's estimate of the same sums."""
    b = {"current_error": dtype_bytes,
         "new_error": inner_iters * dtype_bytes,
         "point_update_norm": inner_iters * dtype_bytes}
    if reduce_mode == "halo":
        b["halo_check"] = dtype_bytes
    return b


def sharded_bundle_adjust_program(
    prob: BAProblem, cam, mesh, max_iters: int = 20, point_block: int = 1024,
    assembly: str = "onehot", solver: str = "chol",
    cg_iters: int = 250, cg_tol: float = 1e-6, **ba_kwargs,
):
    """The rank program of sharded BA and its padded problem, not run yet
    (the counterpart of the JAX package's ``sharded_bundle_adjust_jit``):
    program(padded, cam) runs bundle_adjust on this rank's block of the
    points and returns its BAResult, point-side outputs the block's. The
    payload audit runs it alone to count one LM step's collectives."""
    padded = pad_problem(prob, mesh.size)

    def program(p: BAProblem, c):
        rows = mesh_mod.shard_rows(mesh, p.points.shape[0])
        shard = p.replace(**{f: getattr(p, f)[rows] for f in _POINT_FIELDS})
        return bundle_adjust(
            shard, c, max_iters=max_iters, point_block=point_block,
            axis_name=mesh, assembly=assembly, solver=solver,
            cg_iters=cg_iters, cg_tol=cg_tol, **ba_kwargs)

    return program, padded


def sharded_bundle_adjust(
    prob: BAProblem, cam, mesh, max_iters: int = 20, point_block: int = 1024,
    assembly: str = "onehot", solver: str = "chol",
    cg_iters: int = 250, cg_tol: float = 1e-6, **ba_kwargs,
) -> BAResult:
    """bundle_adjust with the points and measurements sharded over `mesh`,
    run on every rank. The point-side outputs come back whole (of the
    padded problem, all-gathered); the camera-side and scalar outputs are
    replicated and the same on every rank."""
    program, padded = sharded_bundle_adjust_program(
        prob, cam, mesh, max_iters=max_iters, point_block=point_block,
        assembly=assembly, solver=solver, cg_iters=cg_iters, cg_tol=cg_tol,
        **ba_kwargs)
    res = program(padded, cam)
    return res.replace(**{
        f: mesh_mod.all_gather(mesh, getattr(res, f), site="outputs")
        for f in _POINT_OUTPUTS})


def sharded_bundle_adjust_halo(
    prob: BAProblem, cam, mesh, band_halfwidth: int = 16,
    max_iters: int = 20, point_block: int = 1024,
    cg_iters: int = 250, cg_tol: float = 1e-6, **ba_kwargs,
) -> BAResult:
    """Locality-aware sharded band BA: pack points by camera block
    (pack_problem_camblock), run band_pcg with reduce_mode "halo" and
    unpack the point-side outputs to the caller's order. Camera-side and
    scalar outputs are replicated as usual."""
    K, N = prob.cam_R.shape[0], prob.points.shape[0]
    packed, orig = pack_problem_camblock(prob, mesh.size, band_halfwidth)
    res = sharded_bundle_adjust(
        packed, cam, mesh, max_iters=max_iters, point_block=point_block,
        assembly="band", solver="band_pcg", cg_iters=cg_iters,
        cg_tol=cg_tol, band_halfwidth=band_halfwidth, reduce_mode="halo",
        shard_rows=K // mesh.size,
        sigma_mode=ba_kwargs.pop("sigma_mode", "hist"), **ba_kwargs)
    return unpack_point_outputs(res, orig, N)
