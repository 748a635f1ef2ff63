"""Levenberg-Marquardt bundle adjustment with Schur complement.

Port of the JAX package's ``models/bundle.py`` (the reference's
jni/Bundle.{h,cc}; Hartley & Zisserman MVG Algorithm A6.4):

- per-measurement 2x6 camera (A) and 2x3 point (B) Jacobians with the
  sqrt-Tukey weight folded in (Do_LM_Step, Bundle.cc:241-321);
- robust sigma from the Tukey MAD estimator, at least 0.4
  (Bundle.cc:209-227);
- accumulators U (per camera), V (per point), eps_a, eps_b, W = A^T B;
- inner lambda loop: V* = V(1 + lambda*diag), the reduced camera system
  S = U* - sum_p W V*^-1 W^T over camera pairs (Bundle.cc:327-434), solved
  for the camera update, points back-substituted (Bundle.cc:437-462); a
  step is accepted iff the robust objective fell, lambda x0.3 on success
  and x(doubling factor) on failure (Bundle.cc:469-514, :609-617);
- convergence on a squared update below 1e-6, at most `max_iters` inner
  iterations in all (Bundle.cc:65-66);
- fixed and invalid cameras take no update (identity rows in the
  fixed-shape S);
- a measurement with z <= 0 or zero Tukey weight is ejected at the end of
  its LM step and reported (Bundle.cc:516-531, :620-640).

Measurements live in a point-major [N, O] table; U and eps_a are
scatter sums over it (``_scatter_sum``: ``ops/scatter.segmented_sum``, a
hand-written kernel on the card that adds in a fixed order, so a run
repeats itself bit for bit, driven by plans that ``bundle_adjust`` makes
once before its LM loop, ``_Plans``). The Schur correction is assembled from each
point's O x O camera-pair blocks, added by a flat pair index into the
dense S (``_schur_blocks_scatter``) or into its block band
(``_schur_blocks_band``: [K, 2P+1, 6, 6], every pair at most P keyframe
slots apart). Solvers:

- "chol": the dense [6K, 6K] system by a Cholesky factorization (from
  either assembly; the band is spread back to dense);
- "pcg": block-Jacobi preconditioned conjugate gradients that never form
  S (each product is a gather by camera, two small contractions and a
  scatter sum over the measurement table);
- "band_pcg": the same iteration on the block band.

The JAX package's one-hot contractions ("onehot") name the same sums and
run the scatter form here. The robust sigma is the exact masked median
("gather") or the log2-histogram median ("hist").

Over a mesh (``axis_name``, a ``parallel.mesh.Mesh``; the JAX package's
``shard_map`` axis) each rank holds a shard of the points and their
measurement rows, the cameras are replicated, and the camera-side sums go
through the mesh's collectives (``parallel/sharded_ba.py`` lays out the
shards): U and eps_a, the Schur correction (dense, band, or one [K, 6] per
CG product), the error table of the "gather" sigma or the histogram of the
"hist" one, and the objective and update sums. Every rank then solves the
same replicated camera system and back-substitutes its own points.
``reduce_mode="halo"`` (band_pcg, points packed by camera block,
``shard_rows`` cameras per rank) replaces the band's and U's psums by one
right-neighbour ppermute of the ``band_halfwidth``-row strip and a tiled
all_gather of the owned rows, with only the upper half band sent. Every
loop flag is computed from reduced, replicated values, so the ranks take
the same branches.

The two nested loops read the device once per inner iteration: three
flags (objective rose, objective fell, update below the limit) in one
transfer. The CG loop of JAX runs while the residual stays above the
tolerance; here it runs in chunks of ``CG_CHUNK`` iterations with an
on-device flag that freezes the iterate once the test fails, and reads the
flag once per chunk, so the result is the while loop's. ``HOST_READS``
counts both kinds of read; ``CG_STATS`` counts solves and iterations.
"""

from __future__ import annotations

import dataclasses

import torch

from visualslam_android_tpu_torch.ops import camera as cam_ops
from visualslam_android_tpu_torch.ops import lie
from visualslam_android_tpu_torch.ops import mestimator as me
from visualslam_android_tpu_torch.ops import scatter
from visualslam_android_tpu_torch.ops import wls as wls_ops
from visualslam_android_tpu_torch.parallel import mesh as mesh_mod
from visualslam_android_tpu_torch.utils.tensors import TensorTree

MIN_SIGMA_SQ = 0.16  # (0.4)^2, Bundle.cc:224

# Device-to-host reads made by bundle_adjust's loop control: "bundle_adjust"
# one per inner iteration, "cg" one per chunk of CG iterations, "halo_check"
# one per run with reduce_mode "halo" (every measurement of the rank's
# points in its camera rows). Callers set them to 0 and read them, as with
# ops/fast.LAUNCHES.
HOST_READS = {"bundle_adjust": 0, "cg": 0, "halo_check": 0}
# CG solves run and the iterations they took (frozen ones not counted).
CG_STATS = {"solves": 0, "iterations": 0}
# CG iterations issued between two reads of the convergence flag.
CG_CHUNK = 16

_ASSEMBLIES = ("scatter", "onehot", "band")
_SOLVERS = ("chol", "pcg", "band_pcg")
_SIGMA_MODES = ("gather", "hist")
_REDUCE_MODES = ("psum", "halo")


@dataclasses.dataclass(frozen=True)
class BAProblem(TensorTree):
    """Fixed-shape bundle problem."""

    cam_R: torch.Tensor      # [K, 3, 3]
    cam_t: torch.Tensor      # [K, 3]
    cam_fixed: torch.Tensor  # [K] bool (includes invalid slots)
    cam_valid: torch.Tensor  # [K] bool
    points: torch.Tensor     # [N, 3]
    point_valid: torch.Tensor  # [N] bool
    meas_kf: torch.Tensor    # [N, O] int32
    meas_uv: torch.Tensor    # [N, O, 2] level-0 pixels
    meas_sqrt_inv_noise: torch.Tensor  # [N, O] (1/2^level)
    meas_valid: torch.Tensor  # [N, O] bool


@dataclasses.dataclass(frozen=True)
class BAResult(TensorTree):
    cam_R: torch.Tensor
    cam_t: torch.Tensor
    points: torch.Tensor
    meas_valid: torch.Tensor      # with ejected measurements cleared
    outlier_meas: torch.Tensor    # [N, O] measurements ejected this run
    point_outliers: torch.Tensor  # [N] int32 ejected-obs count per point
    accepted: torch.Tensor        # [] int32 accepted LM steps
    converged: torch.Tensor       # [] bool
    sigma_squared: torch.Tensor   # [] final robust sigma^2


@dataclasses.dataclass(frozen=True)
class _Comm:
    """The cross-shard reductions of one bundle_adjust run; on one device
    (mesh None) each is the identity. Sites name the items of
    parallel/sharded_ba.comm_bytes_per_lm_step."""

    mesh: object = None  # parallel.mesh.Mesh
    halo: bool = False
    rows: int = 0        # cameras per rank (halo)
    band: int = 0        # halo strip rows (halo)

    def sum(self, tensors, site):
        """psum of a tuple of tensors of one dtype, in one collective."""
        if self.mesh is None:
            return tensors
        flat = mesh_mod.psum(
            self.mesh, torch.cat([x.reshape(-1) for x in tensors]), site=site)
        out, i = [], 0
        for x in tensors:
            out.append(flat[i:i + x.numel()].view(x.shape))
            i += x.numel()
        return tuple(out)

    def gather(self, x, site):
        return x if self.mesh is None else mesh_mod.all_gather(
            self.mesh, x, site=site)

    def cam_rows(self, tensors, site):
        """The sums over the ranks of camera-indexed tensors [K, ...]: one
        psum, or with the halo reduction one strip ppermute and one tiled
        all_gather of [K, F] with the tensors side by side."""
        if not self.halo:
            return self.sum(tensors, site)
        K = tensors[0].shape[0]
        flat = _halo_reduce_gather(
            torch.cat([x.reshape(K, -1) for x in tensors], dim=1), self.mesh,
            self.rows, self.band, site)
        out, i = [], 0
        for x in tensors:
            n = x[0].numel()
            out.append(flat[:, i:i + n].reshape(x.shape))
            i += n
        return tuple(out)


_ONE_DEVICE = _Comm()


def _halo_reduce_gather(x, mesh, rows: int, halo: int, site):
    """The sum over the ranks of x [K, F] when each rank's contributions
    lie in rows [k0, k1 + halo) of its own camera block [k0, k1) =
    [r rows, (r + 1) rows) (points packed by their first observing camera,
    sharded_ba.pack_problem_camblock): each rank sends the `halo` rows it
    spills into its right neighbour's block (one ppermute), adds what its
    left neighbour sent to its own first rows, and the owned rows are
    all-gathered (JAX ``bundle.py:267-297``). Contributions outside those
    rows would be lost: bundle_adjust checks first that there are none."""
    D, K = mesh.size, x.shape[0]
    if rows * D != K or halo > rows:
        raise ValueError(
            f"halo reduce needs K == rows*D and halo <= rows; got K={K}, "
            f"rows={rows}, D={D}, halo={halo}")
    idx = mesh_mod.axis_index(mesh)
    start = min((idx + 1) * rows, K - halo)  # the last rank sends nothing
    recv = mesh_mod.ppermute_right(mesh, x[start:start + halo],
                                   site="halo_strip")
    own = x[idx * rows:(idx + 1) * rows].clone()
    own[:halo] += recv
    return mesh_mod.all_gather(mesh, own, site=site)


def _band_lower_from_upper(S_half, band: int):
    """The full block band [K, 2*band+1, 6, 6] from its upper half S_half
    [K, band+1, 6, 6] (offsets 0..band) by block symmetry S[i, i-d] =
    S[i-d, i]^T, so only the half band is sent (JAX ``bundle.py:300``)."""
    K = S_half.shape[0]
    delta = band - torch.arange(band, device=S_half.device)  # band .. 1
    src = torch.arange(K, device=S_half.device)[:, None] - delta[None, :]
    vals = S_half[src.clamp(0, K - 1), delta[None, :].expand(K, band)]
    vals = torch.where((src >= 0)[..., None, None], vals.transpose(-1, -2),
                       0.0)
    return torch.cat([vals, S_half], dim=1)


def _project_all(cam, R, t, pts, prob: BAProblem):
    """Project every measurement: (pc [N, O, 3], err [N, O, 2] noise-
    scaled, err_sq [N, O], z_bad [N, O]). prob.meas_kf must lie in
    [0, K)."""
    kf = prob.meas_kf.long()
    pc = (R[kf] @ pts[:, None, :, None])[..., 0] + t[kf]
    z_bad = pc[..., 2] <= 0
    safe_z = torch.where(z_bad, 1.0, pc[..., 2])
    px = cam_ops.project(cam, pc[..., :2] / safe_z[..., None])
    err = (prob.meas_uv - px) * prob.meas_sqrt_inv_noise[..., None]
    return pc, err, torch.sum(err * err, dim=-1), z_bad


def _jacobians(cam, pc, Rm, sqrt_w, sqrt_inv_noise, cam_fixed_m):
    """A [N, O, 2, 6], B [N, O, 2, 3] with sqrt-weight and noise folded in
    (Bundle.cc:269-302); A is zero for fixed cameras.

    With J = d pixel / d pc (the camera's 2x2 derivative times the 2x3
    derivative of the perspective division), a camera motion
    [translation, rotation] moves pc by [I | -[pc]x] and a point motion by
    R, so A = [J | pc x J] (row by row) and B = J R."""
    z_ok = pc[..., 2] > 0
    inv_z = 1.0 / torch.where(z_ok, pc[..., 2], 1.0)
    m = pc[..., :2] * inv_z[..., None]
    _, derivs = cam_ops.project_derivs(cam, m)  # [N, O, 2, 2]
    zero = torch.zeros_like(inv_z)
    persp = torch.stack([
        torch.stack([inv_z, zero, -m[..., 0] * inv_z], dim=-1),
        torch.stack([zero, inv_z, -m[..., 1] * inv_z], dim=-1),
    ], dim=-2)  # [N, O, 2, 3]
    J = (derivs @ persp) * (sqrt_w * sqrt_inv_noise)[..., None, None]
    A = torch.cat(
        [J, torch.linalg.cross(pc[..., None, :].expand_as(J), J, dim=-1)],
        dim=-1,
    )
    A = torch.where(cam_fixed_m[..., None, None], 0.0, A)
    return A, J @ Rm


def _scatter_sum(out, plan, src):
    """out[index[m]] += src[m] along dim 0, in place, by the plan of
    index (ops/scatter.make_plan; src [M, ...]). On a CUDA tensor the
    segmented-sum kernel adds each row's terms in a fixed order, so two
    runs on the same inputs give the same bits (index_add_'s atomics add
    in no fixed order, and the SLAM runs built on them part); on the CPU
    index_add_ adds them in the index's order."""
    return scatter.segmented_sum(out, plan, src)


def _pair_index(kf, K):
    """Flat camera-pair index ii * K + jj [n O O] of a chunk of points'
    camera indices kf [n, O] (int64)."""
    return (kf[:, :, None] * K + kf[:, None, :]).reshape(-1)


def _band_index(kf, K, band: int):
    """Flat block-band index ii * (2 band + 1) + (jj - ii + band) [n O O]
    of a chunk's camera pairs; a pair further apart than `band` goes to the
    dead row K (2 band + 1)."""
    width = 2 * band + 1
    ii, jj = kf[:, :, None], kf[:, None, :]
    dd = jj - ii + band
    return torch.where((dd >= 0) & (dd < width), ii * width + dd,
                       K * width).reshape(-1)


def _band_dense_index(K, band: int, device):
    """Flat dense index ii * K + jj [K (2 band + 1)] of each band block."""
    jj, _ = _band_columns(K, band, device)
    ii = torch.arange(K, device=device)[:, None].expand_as(jj)
    return (ii * K + jj).reshape(-1)


@dataclasses.dataclass(frozen=True)
class _Plans:
    """The segmented-sum plans of one bundle_adjust run, made once before
    its LM loop (the indices do not change between LM iterations): the
    measurement table's camera index (U, eps_a, E_corr, the CG product)
    and, where the run's path needs them, each point chunk's camera-pair
    index (dense Schur assembly) or band index, and the band-to-dense
    index. A measurement that is not valid when the run starts adds
    zeros to every sum (its A, B and residual are masked, and validity
    only shrinks), so the plans leave it and its pairs out."""

    kf: scatter.Plan
    pairs: tuple = ()
    band: tuple = ()
    band_dense: scatter.Plan = None


def _make_plans(meas_kf, K, block: int, assembly: str = "scatter",
                solver: str = "chol", band: int = 16,
                meas_valid=None) -> _Plans:
    """The plans a run of (assembly, solver) needs, points in chunks of
    `block`; with meas_valid [N, O], only the valid measurements' terms.
    meas_kf must lie in [0, K)."""
    kf = meas_kf.long()
    starts = range(0, kf.shape[0], block)
    chunks = [kf[n0:n0 + block] for n0 in starts]
    if meas_valid is None:
        keep, pair_keep = None, [None] * len(chunks)
    else:
        keep = meas_valid
        pair_keep = [meas_valid[n0:n0 + block, :, None]
                     & meas_valid[n0:n0 + block, None, :] for n0 in starts]
    plans = dict(kf=scatter.make_plan(kf, K, keep))
    if solver == "band_pcg" or (solver == "chol" and assembly == "band"):
        plans["band"] = tuple(
            scatter.make_plan(_band_index(c, K, band),
                              K * (2 * band + 1) + 1, pk)
            for c, pk in zip(chunks, pair_keep))
    if solver == "chol" and assembly == "band":
        plans["band_dense"] = scatter.make_plan(
            _band_dense_index(K, band, kf.device), K * K)
    elif solver == "chol":
        plans["pairs"] = tuple(scatter.make_plan(_pair_index(c, K), K * K, pk)
                               for c, pk in zip(chunks, pair_keep))
    return _Plans(**plans)


def _e_corr_scatter(meas_kf, Y, eps_b, K, plan=None):
    """E_corr [K, 6] = sum over measurements of Y eps_b, added per camera
    (plan: of meas_kf, made here when None). Y is zero for bad and fixed
    measurements (the weights are folded into A and B), so dead slots add
    zeros."""
    if plan is None:
        plan = scatter.make_plan(meas_kf, K)
    e = (Y @ eps_b[:, None, :, None])[..., 0]  # [N, O, 6]
    return _scatter_sum(torch.zeros(K, 6, dtype=Y.dtype, device=Y.device),
                        plan, e.reshape(-1, 6))


def _schur_blocks_scatter(meas_kf, Y, W, eps_b, K, block: int, plans=None):
    """The Schur correction S_corr [K, 6, K, 6] and E_corr [K, 6] from
    per-point camera-PAIR blocks (the reference's off-diagonal scripts,
    jni/Bundle.cc:400-426, :580-607): for each point, every O x O pair
    (o, p) adds Y[o] W[p]^T to the block (kf[o], kf[p]). O(N O^2) work,
    whatever K. Points go through in chunks of `block`, which bounds the
    [block, O, O, 6, 6] temporary. meas_kf must lie in [0, K); plans
    (_Plans with pairs) are made here when None."""
    N, O = meas_kf.shape
    if plans is None:
        plans = _make_plans(meas_kf, K, block)
    E_corr = _e_corr_scatter(meas_kf, Y, eps_b, K, plans.kf)
    pairs = torch.zeros(K * K, 6, 6, dtype=Y.dtype, device=Y.device)
    for n0, plan in zip(range(0, N, block), plans.pairs):
        sl = slice(n0, n0 + block)
        # T[n, o, p] = Y[n, o] W[n, p]^T, added at ii * K + jj
        T = Y[sl, :, None] @ W[sl, None].transpose(-1, -2)
        _scatter_sum(pairs, plan, T.reshape(-1, 6, 6))
    return pairs.view(K, K, 6, 6).permute(0, 2, 1, 3), E_corr


def _schur_blocks_band(meas_kf, Y, W, eps_b, K, band: int, block: int,
                       plans=None):
    """The Schur correction in block-band form, S_band [K, 2*band+1, 6, 6]
    with S_band[i, d] the (i, i+d-band) camera-pair block, and E_corr
    [K, 6]. A pair further apart than `band` is dropped (the JAX package
    scatters it with mode="drop"): callers check max_pair_offset first.
    Dropped pairs go to a dead row past the band, which the scatter needs
    in range. meas_kf must lie in [0, K); plans (_Plans with band) are made
    here when None."""
    N, O = meas_kf.shape
    if plans is None:
        plans = _make_plans(meas_kf, K, block, solver="band_pcg", band=band)
    E_corr = _e_corr_scatter(meas_kf, Y, eps_b, K, plans.kf)
    width = 2 * band + 1
    dead = K * width
    out = torch.zeros(dead + 1, 6, 6, dtype=Y.dtype, device=Y.device)
    for n0, plan in zip(range(0, N, block), plans.band):
        sl = slice(n0, n0 + block)
        T = Y[sl, :, None] @ W[sl, None].transpose(-1, -2)
        _scatter_sum(out, plan, T.reshape(-1, 6, 6))
    return out[:dead].view(K, width, 6, 6), E_corr


def _band_columns(K, band: int, device):
    """(jj [K, 2*band+1] camera index of each band column, clamped into
    [0, K), in_range [K, 2*band+1] bool)."""
    jj = (torch.arange(K, device=device)[:, None]
          + torch.arange(-band, band + 1, device=device)[None, :])
    return jj.clamp(0, K - 1), (jj >= 0) & (jj < K)


def _band_to_dense(S_band, K, band: int, plan=None):
    """The dense correction [K, 6, K, 6] from its block band (plan: of
    _band_dense_index, made here when None)."""
    if plan is None:
        plan = scatter.make_plan(_band_dense_index(K, band, S_band.device),
                                 K * K)
    _, ok = _band_columns(K, band, S_band.device)
    vals = torch.where(ok[..., None, None], S_band, 0.0)
    dense = torch.zeros(K * K, 6, 6, dtype=S_band.dtype,
                        device=S_band.device)
    _scatter_sum(dense, plan, vals.reshape(-1, 6, 6))
    return dense.view(K, K, 6, 6).permute(0, 2, 1, 3)


def _cg_loop(apply_S, prec, b, cg_iters: int, cg_tol: float,
             chunk: int = None):
    """Preconditioned conjugate gradients on S x = b (S SPD through
    apply_S): the JAX package's while loop, which stops once |r|^2 <=
    cg_tol^2 |b|^2 or after cg_iters iterations. Iterations go out in
    chunks of `chunk` (CG_CHUNK when None); an on-device flag freezes x, r,
    z, p and rz once the test fails, so an iteration past the end changes
    nothing, and the flag is read once per chunk. Returns x."""
    chunk = CG_CHUNK if chunk is None else chunk
    thresh = (cg_tol * cg_tol) * torch.sum(b * b)
    x = torch.zeros_like(b)
    r = b
    z = prec(r)
    p = z
    rz = torch.sum(r * z)
    active = torch.sum(r * r) > thresh
    iters = torch.zeros((), dtype=torch.int32, device=b.device)
    done, n_iter = 0, 0
    while done < cg_iters:
        for _ in range(min(chunk, cg_iters - done)):
            Ap = apply_S(p)
            denom = torch.sum(p * Ap)
            alpha = torch.where(denom == 0.0, 0.0,
                                rz / torch.where(denom == 0.0, 1.0, denom))
            x_n = x + alpha * p
            r_n = r - alpha * Ap
            z_n = prec(r_n)
            rz_n = torch.sum(r_n * z_n)
            beta = torch.where(rz == 0.0, 0.0,
                               rz_n / torch.where(rz == 0.0, 1.0, rz))
            p_n = z_n + beta * p
            x = torch.where(active, x_n, x)
            r = torch.where(active, r_n, r)
            z = torch.where(active, z_n, z)
            p = torch.where(active, p_n, p)
            rz = torch.where(active, rz_n, rz)
            iters = iters + active.to(torch.int32)
            active = active & (torch.sum(r * r) > thresh)
        done += min(chunk, cg_iters - done)
        HOST_READS["cg"] += 1
        still, n_iter = torch.stack([active.to(torch.int32), iters]).tolist()
        if not still:
            break
    CG_STATS["solves"] += 1
    CG_STATS["iterations"] += n_iter
    return x


def _block_jacobi(M, free):
    """Inverses of the 6x6 diagonal blocks M [K, 6, 6] (identity for a
    camera that takes no update), without the synchronising error check
    of torch.linalg.inv."""
    eye6 = torch.eye(6, dtype=M.dtype, device=M.device)
    M = torch.where(free[:, None, None], M + 1e-9 * eye6, eye6)
    return torch.linalg.inv_ex(M).inverse


def _pcg_camera_solve(U_star, free, meas_kf, W, Vinv, b, cg_iters: int,
                      cg_tol: float, comm: _Comm = _ONE_DEVICE, plan=None):
    """Matrix-free block-Jacobi preconditioned CG on the reduced camera
    system S x = b, never forming S: one product is a gather of x by
    measurement, two small contractions and a scatter sum by camera, O(N O)
    whatever K. meas_kf must lie in [0, K); plan: of meas_kf, made here
    when None. Over a mesh the scatter side
    of each product is psummed, one [K, 6] per iteration, and the ranks
    iterate in lockstep on the replicated x."""
    Y = W @ Vinv[:, None]                  # [N, O, 6, 3]
    Wt = W.transpose(-1, -2)               # [N, O, 3, 6]
    kf = meas_kf.long()
    if plan is None:
        plan = scatter.make_plan(kf, U_star.shape[0])
    Minv = _block_jacobi(U_star, free)
    fr = free[:, None]

    def apply_S(x):
        u = torch.sum((Wt @ x[kf][..., None])[..., 0], dim=1)   # [N, 3]
        corr = (Y @ u[:, None, :, None])[..., 0]                 # [N, O, 6]
        corr = _scatter_sum(torch.zeros_like(x), plan, corr.reshape(-1, 6))
        corr, = comm.sum((corr,), "solve")
        out = (U_star @ x[..., None])[..., 0] + 1e-9 * x - corr
        return torch.where(fr, out, x)

    def prec(r):
        return (Minv @ r[..., None])[..., 0]

    return _cg_loop(apply_S, prec, torch.where(fr, b, 0.0), cg_iters, cg_tol)


def _band_pcg_solve(U_star, S_band, free, band: int, b, cg_iters: int,
                    cg_tol: float):
    """Block-Jacobi preconditioned CG on the block-band reduced system: one
    product is a banded block matvec over K (2*band+1) 6x6 blocks. The
    preconditioner is the diagonal block of S, U* - S_band[:, band]."""
    K = U_star.shape[0]
    jj, in_rng = _band_columns(K, band, U_star.device)
    Sb = torch.where((in_rng & free[jj])[..., None, None], S_band, 0.0)
    fr = free[:, None]

    def apply_S(x):
        xm = torch.where(fr, x, 0.0)
        corr = torch.sum((Sb @ xm[jj][..., None])[..., 0], dim=1)
        out = (U_star @ xm[..., None])[..., 0] + 1e-9 * xm - corr
        return torch.where(fr, out, x)

    Minv = _block_jacobi(U_star - Sb[:, band], free)

    def prec(r):
        return (Minv @ r[..., None])[..., 0]

    return _cg_loop(apply_S, prec, torch.where(fr, b, 0.0), cg_iters, cg_tol)


def pair_offset_tensor(meas_kf, meas_valid):
    """Largest |i - j| over co-observing camera pairs, as a [] int32 tensor
    on the table's device (0 without any valid measurement)."""
    big = torch.iinfo(torch.int32).max
    kf = meas_kf.to(torch.int32)
    hi = torch.where(meas_valid, kf, -big).amax(dim=1)
    lo = torch.where(meas_valid, kf, big).amin(dim=1)
    span = torch.where(meas_valid.any(dim=1), hi - lo, 0)
    return span.max() if span.numel() else torch.zeros(
        (), dtype=torch.int32, device=kf.device)


def max_pair_offset(meas_kf, meas_valid) -> int:
    """pair_offset_tensor read to the host: what decides whether a
    block-band assembly holds every pair."""
    return int(pair_offset_tensor(meas_kf, meas_valid))


def _check_modes(axis_name, assembly, solver, sigma_mode, reduce_mode,
                 shard_rows, band: int) -> _Comm:
    """The run's reductions, after checking its mode names (JAX
    ``bundle.py:513-518`` for the halo's preconditions)."""
    for kind, name, names in (("assembly", assembly, _ASSEMBLIES),
                              ("solver", solver, _SOLVERS),
                              ("sigma_mode", sigma_mode, _SIGMA_MODES),
                              ("reduce_mode", reduce_mode, _REDUCE_MODES)):
        if name not in names:
            raise ValueError(f"unknown {kind} {name!r}")
    if axis_name is not None and not isinstance(axis_name, mesh_mod.Mesh):
        raise TypeError(
            f"axis_name must be a parallel.mesh.Mesh (the ranks that hold "
            f"the point shards), not {axis_name!r}")
    halo = reduce_mode == "halo"
    if halo and (axis_name is None or solver != "band_pcg"
                 or shard_rows <= 0):
        raise ValueError(
            "reduce_mode='halo' requires axis_name, solver='band_pcg' and "
            "shard_rows=K/D (camera-block-packed points)")
    if axis_name is None:
        return _ONE_DEVICE
    return _Comm(mesh=axis_name, halo=halo, rows=shard_rows, band=band)


def _check_halo_rows(prob: BAProblem, meas_valid, comm: _Comm):
    """Every valid measurement of this rank's points must lie in its camera
    rows [k0, k1 + band): the halo reduction drops anything else (the JAX
    package does so silently, ROADMAP queue 3 c). One psum and one read,
    so every rank raises together."""
    k0 = mesh_mod.axis_index(comm.mesh) * comm.rows
    kf = prob.meas_kf
    outside = meas_valid & ((kf < k0) | (kf >= k0 + comm.rows + comm.band))
    n_out, = comm.sum((torch.sum(outside).to(prob.points.dtype),), "scalars")
    HOST_READS["halo_check"] += 1
    n_out = int(n_out)
    if n_out:
        raise ValueError(
            f"reduce_mode='halo': {n_out} measurements lie outside their "
            f"rank's camera rows plus the {comm.band}-row halo; pack the "
            f"points with parallel.sharded_ba.pack_problem_camblock")


def _linearize(prob: BAProblem, cam, R, t, pts, meas_valid, cam_fixed_m,
               min_sigma_sq, sigma_mode="gather", comm: _Comm = _ONE_DEVICE,
               plan=None):
    """The first half of an LM step (Bundle.cc:209-321) at (R, t, pts):
    robust sigma (exact median or, for sigma_mode "hist", the histogram
    median), the objective, the ejection mask and the accumulators (U and
    eps_a by `plan`, of prob.meas_kf, made here when None).
    Over a mesh the sigma, the objective, U and eps_a are the sums over
    every rank's shard. Returns a dict of tensors."""
    K = R.shape[0]
    dtype, device = pts.dtype, pts.device
    pc, err, err_sq, z_bad = _project_all(cam, R, t, pts, prob)
    ok = meas_valid & ~z_bad
    if sigma_mode == "hist":
        sigma_sq = me.find_sigma_squared_hist(
            err_sq.reshape(-1), ok.reshape(-1), me.TUKEY,
            axis_name=comm.mesh)
    else:
        # The exact median needs every rank's error table.
        sigma_sq = me.find_sigma_squared(
            comm.gather(err_sq.reshape(-1), "sigma_gather"),
            comm.gather(ok.reshape(-1), "sigma_gather"), me.TUKEY)
    sigma_sq = torch.clamp(sigma_sq, min=min_sigma_sq)
    sqrt_w = me.square_root_weight(err_sq, sigma_sq, me.TUKEY)
    bad = meas_valid & (z_bad | (sqrt_w == 0.0))
    good = meas_valid & ~bad
    n_bad = torch.sum(bad.to(dtype))
    current_error, = comm.sum((torch.sum(torch.where(
        good, me.objective_score(err_sq, sigma_sq, me.TUKEY), 0.0)) + n_bad,),
        "scalars")

    kf = prob.meas_kf.long()
    A, B = _jacobians(cam, pc, R[kf], torch.where(good, sqrt_w, 0.0),
                      prob.meas_sqrt_inv_noise, cam_fixed_m)
    gmask = good[..., None]
    eps = torch.where(gmask, err * sqrt_w[..., None], 0.0)[..., None]
    A = torch.where(gmask[..., None], A, 0.0)
    B = torch.where(gmask[..., None], B, 0.0)
    At, Bt = A.transpose(-1, -2), B.transpose(-1, -2)

    if plan is None:
        plan = scatter.make_plan(kf, K)
    U = _scatter_sum(torch.zeros(K, 6, 6, dtype=dtype, device=device),
                     plan, (At @ A).reshape(-1, 6, 6))
    eps_a = _scatter_sum(torch.zeros(K, 6, dtype=dtype, device=device),
                         plan, (At @ eps).reshape(-1, 6))
    U, eps_a = comm.cam_rows((U, eps_a), "u_eps")
    return dict(
        A=A, B=B, eps=eps[..., 0], U=U, eps_a=eps_a,
        V=torch.sum(Bt @ B, dim=1),            # [N, 3, 3]
        eps_b=torch.sum(Bt @ eps, dim=1)[..., 0],  # [N, 3]
        W=At @ B,                              # [N, O, 6, 3]
        sigma_sq=sigma_sq, current_error=current_error, n_bad=n_bad,
        bad=bad, good=good,
    )


def _damped(lin, prob: BAProblem, lam):
    """The damped blocks of the inner iteration at `lam`: (Vinv [N, 3, 3],
    Y = W Vinv [N, O, 6, 3], U* [K, 6, 6], free [K]). V* scales V's
    diagonal by (1 + lambda); a point with no good measurement has V = 0
    and gets a zero inverse (Bundle.cc:333-349)."""
    U, V, W = lin["U"], lin["V"], lin["W"]
    eye3 = torch.eye(3, dtype=V.dtype, device=V.device)
    eye6 = torch.eye(6, dtype=V.dtype, device=V.device)
    Vs = V + lam * V * eye3
    singular = (V[:, 0, 0] * V[:, 1, 1] * V[:, 2, 2] == 0.0)[:, None, None]
    Vinv = torch.where(
        singular, 0.0, wls_ops.inv3x3(torch.where(singular, eye3, Vs)))
    free = prob.cam_valid & ~prob.cam_fixed
    return Vinv, W @ Vinv[:, None], U * (1.0 + lam * eye6), free


def _reduced_system(lin, prob: BAProblem, lam, point_block,
                    assembly: str = "scatter", band: int = 16,
                    comm: _Comm = _ONE_DEVICE, plans: _Plans = None):
    """S [6K, 6K] and E [K, 6] of the reduced camera system at damping
    `lam` (Bundle.cc:327-434), with the inverse point blocks Vinv
    [N, 3, 3] the back-substitution needs. assembly "band" sums the block
    band of half-width `band` and spreads it to dense. plans: the run's
    _Plans, made here when None."""
    K = prob.cam_R.shape[0]
    dtype, device = lin["V"].dtype, lin["V"].device
    eye6 = torch.eye(6, dtype=dtype, device=device)
    Vinv, Y, U_star, free = _damped(lin, prob, lam)
    if plans is None:
        plans = _make_plans(prob.meas_kf, K, point_block, assembly, "chol",
                            band)
    if assembly == "band":
        S_band, E_corr = _schur_blocks_band(prob.meas_kf, Y, lin["W"],
                                            lin["eps_b"], K, band,
                                            point_block, plans)
        S_band, E_corr = comm.sum((S_band, E_corr), "solve")
        S_corr = _band_to_dense(S_band, K, band, plans.band_dense)
    else:
        S_corr, E_corr = _schur_blocks_scatter(prob.meas_kf, Y, lin["W"],
                                               lin["eps_b"], K, point_block,
                                               plans)
        S_corr, E_corr = comm.sum((S_corr, E_corr), "solve")
    kk = torch.arange(K, device=device)
    S = -S_corr
    S[kk, :, kk, :] += U_star
    S = torch.where(free[:, None, None, None] & free[None, None, :, None],
                    S, 0.0)
    # Fixed and invalid cameras: identity rows, zero right-hand side.
    S[kk, :, kk, :] += torch.where(free[:, None, None], 0.0, eye6)
    E = torch.where(free[:, None], lin["eps_a"] - E_corr, 0.0)
    Sm = S.reshape(K * 6, K * 6) + 1e-9 * torch.eye(
        K * 6, dtype=dtype, device=device)
    return Sm, E, Vinv, free


def _cg_camera_update(lin, prob: BAProblem, lam, point_block, solver: str,
                      band: int, cg_iters: int, cg_tol: float,
                      comm: _Comm = _ONE_DEVICE, plans: _Plans = None):
    """(camera update [K, 6], Vinv, free) of the inner iteration at `lam`
    by the CG solvers: "pcg" never forms S, "band_pcg" sums its block
    band first (over a mesh: one psum of the band, or with the halo
    reduction the upper half band through _halo_reduce_gather, then CG on
    the replicated band with no collective). plans: the run's _Plans, made
    here when None."""
    K = prob.cam_R.shape[0]
    Vinv, Y, U_star, free = _damped(lin, prob, lam)
    if plans is None:
        plans = _make_plans(prob.meas_kf, K, point_block, solver=solver,
                            band=band)
    if solver == "pcg":
        E_corr, = comm.sum(
            (_e_corr_scatter(prob.meas_kf, Y, lin["eps_b"], K, plans.kf),),
            "solve")
        E = torch.where(free[:, None], lin["eps_a"] - E_corr, 0.0)
        upd = _pcg_camera_solve(U_star, free, prob.meas_kf, lin["W"], Vinv,
                                E, cg_iters, cg_tol, comm, plans.kf)
    else:
        S_band, E_corr = _schur_blocks_band(prob.meas_kf, Y, lin["W"],
                                            lin["eps_b"], K, band,
                                            point_block, plans)
        if comm.halo:
            S_half, E_corr = comm.cam_rows((S_band[:, band:], E_corr),
                                           "solve")
            S_band = _band_lower_from_upper(S_half, band)
        else:
            S_band, E_corr = comm.sum((S_band, E_corr), "solve")
        E = torch.where(free[:, None], lin["eps_a"] - E_corr, 0.0)
        upd = _band_pcg_solve(U_star, S_band, free, band, E, cg_iters,
                              cg_tol)
    return upd, Vinv, free


def _back_substitute(lin, prob: BAProblem, cam, R, t, pts, cam_upd, Vinv,
                     free, update_conv, comm: _Comm = _ONE_DEVICE):
    """The second half of an inner iteration (Bundle.cc:440-514): point
    updates from the camera update, the new state, its objective at the
    same sigma. Returns a dict of tensors, `flags` among them: [objective
    rose, objective fell, update below the limit]. Over a mesh the point
    update norm and the objective are summed over the ranks in one psum,
    so every rank reads the same flags."""
    kf = prob.meas_kf.long()
    wtd = (lin["W"].transpose(-1, -2) @ cam_upd[kf][..., None])[..., 0]
    v3 = lin["eps_b"] - torch.sum(wtd, dim=1)
    pt_upd = (Vinv @ v3[..., None])[..., 0]
    pt_upd = torch.where(prob.point_valid[:, None], pt_upd, 0.0)
    pt_sq = torch.sum(pt_upd * pt_upd)

    dR, dt = lie.se3_exp(cam_upd)
    R_new, t_new = lie.se3_mul(dR, dt, R, t)
    R_new = torch.where(free[:, None, None], R_new, R)
    t_new = torch.where(free[:, None], t_new, t)
    pts_new = pts + pt_upd

    # FindNewError (Bundle.cc:537-561): same sigma, +1 per z-bad.
    _, _, err_sq_new, z_bad_new = _project_all(cam, R_new, t_new, pts_new,
                                               prob)
    good = lin["good"]
    new_error = (
        torch.sum(torch.where(
            good & ~z_bad_new,
            me.objective_score(err_sq_new, lin["sigma_sq"], me.TUKEY), 0.0))
        + torch.sum((good & z_bad_new).to(pts.dtype)) + lin["n_bad"]
    )
    pt_sq, new_error = comm.sum((pt_sq, new_error), "scalars")
    upd_sq = torch.sum(cam_upd * cam_upd) + pt_sq
    cur = lin["current_error"]
    flags = torch.stack([new_error > cur, new_error < cur,
                         upd_sq < update_conv])
    return dict(cam_upd=cam_upd, pt_upd=pt_upd, R_new=R_new, t_new=t_new,
                pts_new=pts_new, new_error=new_error, flags=flags)


def _solve_and_step(lin, prob: BAProblem, cam, R, t, pts, lam, point_block,
                    update_conv, assembly: str = "scatter",
                    solver: str = "chol", band: int = 16, cg_iters: int = 250,
                    cg_tol: float = 1e-6, comm: _Comm = _ONE_DEVICE,
                    plans: _Plans = None):
    """One inner iteration (Bundle.cc:327-514) at damping `lam`: solve the
    reduced system for the camera update, then _back_substitute. With
    solver "chol" the result also carries the system (S, E). plans: the
    run's _Plans, made where needed when None."""
    K = prob.cam_R.shape[0]
    extra = {}
    if solver == "chol":
        Sm, E, Vinv, free = _reduced_system(lin, prob, lam, point_block,
                                            assembly, band, comm, plans)
        # ridge=0: the reduced system already carries it. A factorization
        # that fails gives a NaN update, hence a NaN objective and a
        # rejected step.
        cam_upd = wls_ops.solve_spd(Sm, E.reshape(-1),
                                    ridge=0.0).reshape(K, 6)
        extra = dict(S=Sm, E=E)
    else:
        cam_upd, Vinv, free = _cg_camera_update(
            lin, prob, lam, point_block, solver, band, cg_iters, cg_tol, comm,
            plans)
    step = _back_substitute(lin, prob, cam, R, t, pts, cam_upd, Vinv, free,
                            update_conv, comm)
    return dict(step, **extra)


def _sanitized(prob: BAProblem):
    """(problem with meas_kf clamped into [0, K), measurement mask): a
    measurement counts only if it is valid, its point is, and its camera
    index names a slot. Dead slots may hold any index; the scatter sums
    may not see it."""
    K = prob.cam_R.shape[0]
    in_range = (prob.meas_kf >= 0) & (prob.meas_kf < K)
    meas_valid = prob.meas_valid & prob.point_valid[:, None] & in_range
    return (prob.replace(meas_kf=torch.clamp(prob.meas_kf, 0, K - 1)),
            meas_valid)


def bundle_adjust(
    prob: BAProblem, cam: cam_ops.Camera,
    max_iters: int = 20, point_block: int = 1024,
    axis_name=None,
    assembly: str = "onehot", solver: str = "chol",
    cg_iters: int = 250, cg_tol: float = 1e-6,
    update_conv: float = 1e-6, min_sigma_sq: float = MIN_SIGMA_SQ,
    lambda_init: float = 1e-4, lambda_good: float = 0.3,
    lambda_factor_init: float = 2.0,
    band_halfwidth: int = 16,
    sigma_mode: str = "gather",
    reduce_mode: str = "psum",
    shard_rows: int = 0,
) -> BAResult:
    """Full Bundle::Compute (Bundle.cc:136-178). max_iters bounds the TOTAL
    of inner iterations (the reference's mgvnMaxIterations); run it again
    with a small budget to go on.

    The arguments are the JAX package's: assembly "scatter" ("onehot"
    names the same sums and runs the scatter form) and "band" (every
    co-observing pair within band_halfwidth slots: callers check
    max_pair_offset, pairs further apart are dropped); solver "chol",
    "pcg" (the assembly is not read: S is never formed) and "band_pcg"
    (block band of band_halfwidth), the CG solvers bounded by cg_iters and
    cg_tol; sigma_mode "gather" or "hist".

    axis_name: None on one device, or the parallel.mesh.Mesh whose ranks
    each run this call on their shard of the points (the measurement rows
    with them) and the same cameras (parallel/sharded_ba.py); the
    point-side outputs are then the shard's, the rest replicated.
    reduce_mode "psum" sums the camera-side arrays over the ranks;
    "halo" (band_pcg only, shard_rows = K / D cameras per rank, points
    packed by sharded_ba.pack_problem_camblock) reduces them through
    _halo_reduce_gather, and raises if a measurement lies outside its
    rank's camera rows plus band_halfwidth."""
    comm = _check_modes(axis_name, assembly, solver, sigma_mode, reduce_mode,
                        shard_rows, band_halfwidth)
    dtype, device = prob.points.dtype, prob.points.device
    prob, meas_valid = _sanitized(prob)
    if comm.halo:
        _check_halo_rows(prob, meas_valid, comm)
    cam_fixed_m = prob.cam_fixed[prob.meas_kf.long()]
    # The scatter sums' plans: the indices do not change between LM
    # iterations, so they are sorted once here, without the measurements
    # that are not valid now.
    plans = _make_plans(prob.meas_kf, prob.cam_R.shape[0], point_block,
                        assembly, solver, band_halfwidth, meas_valid)

    R, t, pts = prob.cam_R, prob.cam_t, prob.points
    ejected = torch.zeros_like(meas_valid)
    accepted = torch.zeros((), dtype=torch.int32, device=device)
    converged_dev = torch.zeros((), dtype=torch.bool, device=device)
    sigma_sq = torch.full((), min_sigma_sq, dtype=dtype, device=device)
    lam, lam_factor = lambda_init, lambda_factor_init
    counter, converged = 0, False

    while not converged and counter < max_iters:
        lin = _linearize(prob, cam, R, t, pts, meas_valid, cam_fixed_m,
                         min_sigma_sq, sigma_mode, comm, plans.kf)
        # Inner lambda loop: raise the damping until the objective falls,
        # the update converges or the budget ends.
        while True:
            step = _solve_and_step(lin, prob, cam, R, t, pts, lam,
                                   point_block, update_conv, assembly,
                                   solver, band_halfwidth, cg_iters, cg_tol,
                                   comm, plans)
            HOST_READS["bundle_adjust"] += 1
            worse, better, conv = step["flags"].tolist()
            converged_dev = converged_dev | step["flags"][2]
            converged = converged or conv
            if worse:
                lam, lam_factor = lam * lam_factor, lam_factor * 2.0
            counter += 1
            if not worse or converged or counter >= max_iters:
                break
        # Accept if improved (Bundle.cc:504-514).
        if better:
            lam, lam_factor = lam * lambda_good, lambda_factor_init
            R, t, pts = step["R_new"], step["t_new"], step["pts_new"]
            accepted = accepted + 1
        # Eject outliers (Bundle.cc:516-531).
        meas_valid = meas_valid & ~lin["bad"]
        ejected = ejected | lin["bad"]
        sigma_sq = lin["sigma_sq"]

    return BAResult(
        cam_R=R, cam_t=t, points=pts, meas_valid=meas_valid,
        outlier_meas=ejected,
        point_outliers=torch.sum(ejected.to(torch.int32), dim=-1),
        accepted=accepted, converged=converged_dev, sigma_squared=sigma_sq,
    )


def reprojection_rms(prob: BAProblem, cam: cam_ops.Camera,
                     R=None, t=None, pts=None):
    """Diagnostic: noise-scaled RMS reprojection error over the valid
    measurements."""
    R = prob.cam_R if R is None else R
    t = prob.cam_t if t is None else t
    pts = prob.points if pts is None else pts
    prob, meas_valid = _sanitized(prob)
    _, _, err_sq, z_bad = _project_all(cam, R, t, pts, prob)
    ok = meas_valid & ~z_bad
    n = torch.clamp(torch.sum(ok), min=1)
    return torch.sqrt(torch.sum(torch.where(ok, err_sq, 0.0)) / n)
