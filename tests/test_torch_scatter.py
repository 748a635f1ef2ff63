"""The port's fixed-order segmented sum (ops/scatter.py) on the CPU, where
its wrapper runs the plain version: against index_add_ (bit for bit) and
the JAX package's `.at[].add` (f32 tolerance) at each bundle-adjustment
call site's shape, rows without terms, the plan's construction, and whole
bundle_adjust runs with plans against the same runs summed the old way.
The order-exact plain version (segmented_sum_ordered_reference), which
makes the kernel's additions in the kernel's order: on a row whose bits
depend on that order, at each call site, and as the sum of whole
bundle_adjust runs.

The kernel itself (csrc/segsum.cu) runs only on a CUDA card; chip_smoke.py
holds it against both plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from visualslam_android_tpu_torch.config import CameraConfig
from visualslam_android_tpu_torch.models import bundle as tb
from visualslam_android_tpu_torch.ops import camera as tcam
from visualslam_android_tpu_torch.ops import lie as tlie
from visualslam_android_tpu_torch.ops import mestimator as tme
from visualslam_android_tpu_torch.ops import scatter

torch.set_num_threads(2)

K, N, O, BLOCK, BAND = 12, 150, 5, 64, 3


def _kf(rng, n=N):
    """Camera indices of an odometry-like table: each point seen by up to
    O cameras from a random first one, clamped into [0, K)."""
    first = rng.integers(0, K, n)[:, None]
    return torch.as_tensor(np.minimum(first + np.arange(O)[None, :], K - 1)
                           .astype(np.int64))


def _site(name, rng):
    """(index [M] int64, n_rows, width F) of one bundle_adjust call site at
    a small size."""
    kf = _kf(rng)
    if name in ("U", "eps_a", "e_corr", "cg_product"):
        return kf.reshape(-1), K, 36 if name == "U" else 6
    if name == "pair_chunk":
        return tb._pair_index(kf[:BLOCK], K), K * K, 36
    if name == "band_chunk":
        # Offsets up to O - 1 = 4 > BAND: some pairs land in the dead row.
        index = tb._band_index(kf[:BLOCK], K, BAND)
        dead = K * (2 * BAND + 1)
        assert int((index == dead).sum()) > 0
        return index, dead + 1, 36
    if name == "band_to_dense":
        return tb._band_dense_index(K, BAND, "cpu"), K * K, 36
    raise ValueError(name)


SITES = ("U", "eps_a", "e_corr", "pair_chunk", "band_chunk",
         "band_to_dense", "cg_product")


@pytest.mark.parametrize("site", SITES)
def test_plain_segmented_sum_matches_index_add_and_jax(site):
    """The plain version is index_add_ bit for bit (each row's terms added
    in their original order) onto a non-zero out, and within f32 rounding
    of JAX's `.at[].add`, which adds in another order: rtol 1e-5 plus 1e-6
    of the largest sum of |terms| of a row (at most ~100 terms here)."""
    rng = np.random.default_rng(SITES.index(site))
    index, n_rows, F = _site(site, rng)
    shape = (6,) if F == 6 else (6, 6)
    src = torch.as_tensor(rng.normal(size=(index.numel(), *shape))
                          .astype(np.float32))
    out0 = torch.as_tensor(rng.normal(size=(n_rows, *shape))
                           .astype(np.float32))
    plan = scatter.make_plan(index, n_rows)
    got = scatter.segmented_sum(out0.clone(), plan, src)
    want = out0.clone().index_add_(0, index, src)
    assert torch.equal(got, want)
    jax_sum = np.asarray(jnp.asarray(out0.numpy()).at[index.numpy()].add(
        src.numpy()))
    abs_sum = np.zeros((n_rows, *shape))
    np.add.at(abs_sum, index.numpy(), np.abs(src.numpy()))
    np.testing.assert_allclose(got.numpy(), jax_sum, rtol=1e-5,
                               atol=1e-6 * abs_sum.max())


def test_rows_without_terms_stay_untouched():
    """Rows that no index names keep their bits (NaN and -0.0 included),
    also with a plan of no terms at all."""
    rng = np.random.default_rng(7)
    out0 = torch.as_tensor(rng.normal(size=(40, 6)).astype(np.float32))
    out0[3, 0], out0[5, 1] = float("nan"), -0.0
    index = torch.as_tensor(rng.choice([0, 1, 2, 10, 11, 39], 90))
    src = torch.as_tensor(rng.normal(size=(90, 6)).astype(np.float32))
    got = scatter.segmented_sum(out0.clone(), scatter.make_plan(index, 40),
                                src)
    hit = torch.zeros(40, dtype=torch.bool)
    hit[index] = True
    assert torch.equal(got[~hit].view(torch.int32),
                       out0[~hit].view(torch.int32))
    assert not torch.equal(got[hit], out0[hit])
    empty = scatter.make_plan(torch.zeros(0, dtype=torch.int64), 40)
    assert torch.equal(empty.row_start, torch.zeros(41, dtype=torch.int32))
    got = scatter.segmented_sum(out0.clone(), empty, src[:0])
    assert torch.equal(got.view(torch.int32), out0.view(torch.int32))


# Operators that read a device's memory into the host: what make_plan must
# not dispatch (unique_consecutive, nonzero and masked_select size their
# output from the data; item and is_nonzero read a value).
_HOST_READS = {"_local_scalar_dense", "item", "is_nonzero", "nonzero",
               "masked_select", "unique_consecutive", "_unique2", "unique_dim",
               "equal", "_assert_async"}


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def test_make_plan_sorts_once_and_reads_nothing_back():
    """make_plan: a stable argsort and the n_rows + 1 row bounds, each row's
    terms contiguous in the plan's order, and no operator that reads the
    data back to the host."""
    rng = np.random.default_rng(3)
    index = torch.as_tensor(rng.integers(0, 30, 500))
    with _Ops() as ops:
        plan = scatter.make_plan(index, 33)
    assert ops.names and not set(ops.names) & _HOST_READS, ops.names
    assert "sort" in ops.names and "searchsorted" in ops.names
    assert plan.perm.dtype == plan.row_start.dtype == torch.int32
    assert plan.n_rows == 33
    assert torch.equal(plan.perm.long(),
                       torch.as_tensor(np.argsort(index.numpy(),
                                                  kind="stable")))
    counts = np.bincount(index.numpy(), minlength=33)
    assert np.array_equal(plan.row_start.numpy(),
                          np.concatenate([[0], np.cumsum(counts)]))
    assert torch.equal(plan.sorted_index, index[plan.perm.long()])


def test_terms_left_out_of_the_plan_are_not_added():
    """make_plan's keep: the terms left out add nothing (their values may
    be anything), the rest are added as index_add_ adds them; with the
    left-out values zero the sum is index_add_ over every term."""
    rng = np.random.default_rng(9)
    index = torch.as_tensor(rng.integers(0, 20, 400))
    keep = torch.as_tensor(rng.uniform(size=400) < 0.3)
    src = torch.as_tensor(rng.normal(size=(400, 6, 6)).astype(np.float32))
    out0 = torch.as_tensor(rng.normal(size=(20, 6, 6)).astype(np.float32))
    plan = scatter.make_plan(index, 20, keep)
    assert int(plan.row_start[-1]) == int(keep.sum())
    got = scatter.segmented_sum(out0.clone(), plan, src)
    assert torch.equal(got, out0.clone().index_add_(0, index[keep],
                                                    src[keep]))
    zeroed = torch.where(keep[:, None, None], src, 0.0)
    assert torch.equal(scatter.segmented_sum(out0.clone(), plan, zeroed),
                       out0.clone().index_add_(0, index, zeroed))


def test_segmented_sum_checks_its_arguments():
    """A plan made for other shapes, or another dtype, raises."""
    index = torch.tensor([0, 2, 2])
    plan = scatter.make_plan(index, 4)
    with pytest.raises(ValueError, match="plan"):
        scatter.segmented_sum(torch.zeros(5, 6), plan, torch.ones(3, 6))
    with pytest.raises(ValueError, match="plan"):
        scatter.segmented_sum(torch.zeros(4, 6), plan, torch.ones(2, 6))
    with pytest.raises(ValueError, match="shape"):
        scatter.segmented_sum(torch.zeros(4, 6), plan, torch.ones(3, 7))
    with pytest.raises(ValueError, match="float32"):
        scatter.segmented_sum(torch.zeros(4, 6, dtype=torch.float64), plan,
                              torch.ones(3, 6, dtype=torch.float64))


@pytest.mark.parametrize("n_terms,n_rows,threads", [
    (100, 200, 32), (2048 * 16, 2048, 32), (512, 4, 32), (516, 4, 64),
    (2048 * 16, 32, 256),
    (1024 * 256, 1024, 64), (0, 10, 32), (10, 0, 32)])
def test_threads_for_depends_on_the_mean_row(n_terms, n_rows, threads):
    """About four terms a thread at the mean row length, 32 to 256."""
    assert scatter.threads_for(n_terms, n_rows) == threads


@pytest.mark.parametrize("n_terms,n_rows,path", [
    (1024 * 256, 128 * 128, "short"), (1024 * 256, 65 * 65, "short"),
    (1024 * 256, 32 * 32, "short"), (2048 * 16, 32, "long"),
    (2048 * 16, 128, "long"), (4096 * 16, 512, "long"), (100, 200, "long")])
def test_path_for_takes_the_short_path_where_rows_fill_1024_warps(
        n_terms, n_rows, path):
    """The kernel's path depends on the shapes alone: the pair and band
    chunks (many rows) take the short path, U and the CG product at 32-512
    keyframe slots the long one."""
    assert scatter.path_for(n_terms, n_rows) == path
    assert (n_rows * scatter.threads_for(n_terms, n_rows) // 32
            >= scatter.SHORT_MIN_WARPS) == (path == "short")


def _odometry_problem(seed, n_cams=10, n_pts=160, o_max=6):
    """A small bundle problem from seeded numpy draws: cameras along x,
    each point seen by up to o_max consecutive cameras from a random first
    one, 0.3 px of noise, 4 measurements moved by 40 px, camera 0 fixed,
    two dead camera slots and dead point slots with garbage indices."""
    rng = np.random.default_rng(seed)
    cam = tcam.make_camera(CameraConfig().params(), 640, 480, device="cpu")
    K_pad, N_pad = n_cams + 2, n_pts + 8
    mus = np.zeros((K_pad, 6), np.float32)
    mus[:n_cams, 0] = -0.15 * np.arange(n_cams)
    R, t = tlie.se3_exp(torch.as_tensor(mus))
    pts = np.stack([rng.uniform(-1.0, 2.5, n_pts), rng.uniform(-1.0, 1.0, n_pts),
                    rng.uniform(3.5, 6.0, n_pts)], -1).astype(np.float32)
    first = rng.integers(0, n_cams - 2, N_pad)
    meas_kf = np.minimum(first[:, None] + np.arange(o_max)[None, :],
                         n_cams - 1).astype(np.int32)
    valid = np.zeros((N_pad, o_max), bool)
    valid[:n_pts] = (first[:n_pts, None] + np.arange(o_max)[None, :]
                     < n_cams)
    pts_pad = np.zeros((N_pad, 3), np.float32)
    pts_pad[:n_pts] = pts
    kf_t = torch.as_tensor(meas_kf).long()
    pc = (R[kf_t] @ torch.as_tensor(pts_pad)[:, None, :, None])[..., 0] \
        + t[kf_t]
    uv = tcam.project(cam, pc[..., :2] / pc[..., 2:].clamp(min=0.1))
    uv = uv.numpy() + rng.normal(scale=0.3, size=uv.shape).astype(np.float32)
    moved = rng.choice(np.flatnonzero(valid & (meas_kf > 0)), 4,
                       replace=False)
    uv.reshape(-1, 2)[moved] += 40.0
    garbage = rng.choice(np.array([0, K_pad - 1, 99, -1], np.int32),
                         meas_kf.shape)
    meas_kf = np.where(valid, meas_kf, garbage)
    dmu = rng.normal(scale=0.01, size=(K_pad, 6)).astype(np.float32)
    dmu[0] = 0.0
    R2, t2 = tlie.se3_mul(*tlie.se3_exp(torch.as_tensor(dmu)), R, t)
    prob = tb.BAProblem(
        cam_R=R2, cam_t=t2,
        cam_fixed=torch.as_tensor(np.arange(K_pad) == 0)
        | torch.as_tensor(np.arange(K_pad) >= n_cams),
        cam_valid=torch.as_tensor(np.arange(K_pad) < n_cams),
        points=torch.as_tensor(pts_pad + rng.normal(
            scale=0.02, size=pts_pad.shape).astype(np.float32)),
        point_valid=torch.as_tensor(np.arange(N_pad) < n_pts),
        meas_kf=torch.as_tensor(meas_kf),
        meas_uv=torch.as_tensor(uv.astype(np.float32)),
        meas_sqrt_inv_noise=torch.ones(N_pad, o_max),
        meas_valid=torch.as_tensor(valid),
    )
    return prob, cam


@pytest.mark.parametrize("assembly,solver", [
    ("scatter", "chol"), ("band", "chol"), ("band", "band_pcg"),
    ("scatter", "pcg")])
def test_bundle_adjust_with_plans_is_bit_equal_to_index_add(
        monkeypatch, assembly, solver):
    """A 3-iteration bundle_adjust on the CPU with its plans made once
    (the measurements invalid at the start left out) gives the same bits
    as the same run with every scatter sum made by index_add_ over all its
    terms by their original index, on every path; and it moved."""
    prob, cam = _odometry_problem(11)
    kw = dict(max_iters=3, point_block=64, assembly=assembly, solver=solver,
              band_halfwidth=6, cg_iters=30)
    assert tb.max_pair_offset(prob.meas_kf, prob.meas_valid) <= 6
    new = tb.bundle_adjust(prob, cam, **kw)

    # The old way: each plan remembers its whole index, and every sum is
    # index_add_ over it.
    index_of = {}
    make_plan = scatter.make_plan

    def recording_make_plan(index, n_rows, keep=None):
        plan = make_plan(index, n_rows, keep)
        index_of[id(plan)] = index.reshape(-1).long()
        return plan

    monkeypatch.setattr(scatter, "make_plan", recording_make_plan)
    monkeypatch.setattr(tb, "_scatter_sum", lambda out, plan, src:
                        out.index_add_(0, index_of[id(plan)], src))
    old = tb.bundle_adjust(prob, cam, **kw)
    for name in ("cam_R", "cam_t", "points", "meas_valid", "outlier_meas",
                 "accepted", "converged", "sigma_squared"):
        assert torch.equal(getattr(new, name), getattr(old, name)), name
    assert int(new.accepted) >= 1
    assert int(new.outlier_meas.sum()) >= 1
    assert float(tb.reprojection_rms(prob, cam, new.cam_R, new.cam_t,
                                     new.points)) < float(
        tb.reprojection_rms(prob, cam))


def _chains_then_tree(terms, T):
    """The kernel's order on one row, by loops over float32 scalars: chain
    t sums terms t, t + T, ... from 0, then the tree (slot u < s takes
    slot u + s at s = T/2, ..., 1)."""
    chains = [np.float32(0.0)] * T
    for k, x in enumerate(terms):
        chains[k % T] = np.float32(chains[k % T] + x)
    s = T // 2
    while s >= 1:
        for u in range(s):
            chains[u] = np.float32(chains[u] + chains[u + s])
        s //= 2
    return chains[0]


@pytest.mark.parametrize("T", [32, 64])
def test_ordered_reference_adds_chains_then_the_tree(T):
    """A row whose sum depends on the order: 1e8 and -1e8 on chain 0
    cancel, 1.0, 0.5, 0.25 and 0.125 sit on chains 1 and 2. Chains then
    tree give 1.875 exactly; one term after another, 1e8 swallows 1.0 and
    0.5 (its ulp is 8) and gives 0.375. The row's terms lie interleaved
    with another row's in src, so the plan's order is what places them."""
    row = np.zeros(T + 3, np.float32)
    row[[0, 1, 2, T, T + 1, T + 2]] = [1e8, 1.0, 0.5, -1e8, 0.25, 0.125]
    assert _chains_then_tree(row, T) == np.float32(1.875)
    assert np.float32(np.cumsum(row, dtype=np.float32)[-1]) == \
        np.float32(0.375)
    rng = np.random.default_rng(T)
    other = rng.normal(size=T + 3).astype(np.float32)
    values = np.empty(2 * (T + 3), np.float32)
    values[0::2], values[1::2] = row, other
    index = torch.as_tensor(np.tile([2, 0], T + 3))
    src = torch.as_tensor(np.repeat(values[:, None], 6, 1))
    out0 = torch.zeros(3, 6)
    out0[1] = -0.0
    plan = scatter.make_plan(index, 3)
    got = scatter.segmented_sum_ordered_reference(out0.clone(), plan, src,
                                                  T)
    assert torch.all(got[2] == 1.875)
    assert torch.all(got[0] == _chains_then_tree(other, T))
    assert torch.equal(got[1].view(torch.int32), out0[1].view(torch.int32))
    # The CPU wrapper adds one term after another, as index_add_ does.
    plain = scatter.segmented_sum(out0.clone(), plan, src)
    assert torch.all(plain[2] == 0.375)
    # T defaults to the kernel's: threads_for(2 (T + 3), 3).
    assert scatter.threads_for(2 * (T + 3), 3) == 32
    default = scatter.segmented_sum_ordered_reference(out0.clone(), plan,
                                                      src)
    at_32 = scatter.segmented_sum_ordered_reference(out0.clone(), plan, src,
                                                    32)
    assert torch.equal(default.view(torch.int32), at_32.view(torch.int32))


@pytest.mark.parametrize("site", SITES)
def test_ordered_reference_matches_jax_at_each_site(site):
    """The order-exact plain version, at the kernel's T for each bundle
    site's shape, against JAX's `.at[].add`, which adds in another order:
    each element within 1e-5 of the row's sum of |terms| and |old value|
    (f32 rounding over at most ~100 additions); rows without terms keep
    their bits; and with every row of the table long enough to fill the
    chains, bit for bit the loops of _chains_then_tree."""
    rng = np.random.default_rng(100 + SITES.index(site))
    index, n_rows, F = _site(site, rng)
    shape = (6,) if F == 6 else (6, 6)
    src = torch.as_tensor(rng.normal(size=(index.numel(), *shape))
                          .astype(np.float32))
    out0 = torch.as_tensor(rng.normal(size=(n_rows, *shape))
                           .astype(np.float32))
    plan = scatter.make_plan(index, n_rows)
    got = scatter.segmented_sum_ordered_reference(out0.clone(), plan, src)
    jax_sum = np.asarray(jnp.asarray(out0.numpy()).at[index.numpy()].add(
        src.numpy()))
    bound = np.abs(out0.numpy()).astype(np.float64)
    np.add.at(bound, index.numpy(), np.abs(src.numpy()))
    assert np.all(np.abs(got.numpy() - jax_sum) <= 1e-5 * bound)
    hit = torch.zeros(n_rows, dtype=torch.bool)
    hit[index] = True
    assert torch.equal(got[~hit].view(torch.int32),
                       out0[~hit].view(torch.int32))
    T = scatter.threads_for(index.numel(), n_rows)
    flat_src = src.reshape(index.numel(), F).numpy()
    flat_got = got.reshape(n_rows, F).numpy()
    for r in np.flatnonzero(hit.numpy())[:8]:
        terms = flat_src[index.numpy() == r]
        for f in range(F):
            want = np.float32(out0.reshape(n_rows, F)[r, f].item()
                              + _chains_then_tree(terms[:, f], T))
            assert flat_got[r, f] == want


def _objective_at(prob, cam, res, sigma_sq):
    """The robust objective of a result at a given sigma^2 (Tukey scores
    plus one per ejected measurement)."""
    sp, valid = tb._sanitized(prob.replace(meas_valid=res.meas_valid))
    _, _, err_sq, z_bad = tb._project_all(cam, res.cam_R, res.cam_t,
                                          res.points, sp)
    score = tme.objective_score(err_sq, sigma_sq)
    return float(torch.sum(torch.where(valid & ~z_bad, score, 0.0))
                 + res.outlier_meas.sum())


@pytest.mark.parametrize("assembly,solver", [
    ("scatter", "chol"), ("band", "chol"), ("band", "band_pcg"),
    ("scatter", "pcg")])
def test_bundle_adjust_in_the_kernels_order_lands_on_the_sequential_run(
        monkeypatch, assembly, solver):
    """The card's order on the CPU: a 3-iteration bundle_adjust with every
    scatter sum made by the order-exact plain version ends near the same
    run summed one term after another (the CPU wrapper's index_add_
    order): within 1% in rms and 1e-4 relative in objective, both at the
    sequential run's sigma. The two add the same terms in other orders, so
    each sum parts in its last bits; three LM steps carry that far below
    these bounds unless a step's or an ejection's decision flips, which is
    what the bounds would catch."""
    prob, cam = _odometry_problem(11)
    kw = dict(max_iters=3, point_block=64, assembly=assembly, solver=solver,
              band_halfwidth=6, cg_iters=30)
    seq = tb.bundle_adjust(prob, cam, **kw)
    calls = []

    def ordered(out, plan, src):
        calls.append(plan.n_rows)
        return scatter.segmented_sum_ordered_reference(out, plan, src)

    monkeypatch.setattr(tb, "_scatter_sum", ordered)
    card = tb.bundle_adjust(prob, cam, **kw)
    assert calls
    rms = [float(tb.reprojection_rms(prob, cam, r.cam_R, r.cam_t, r.points))
           for r in (seq, card)]
    obj = [_objective_at(prob, cam, r, seq.sigma_squared)
           for r in (seq, card)]
    assert abs(rms[1] - rms[0]) <= 0.01 * rms[0], rms
    assert abs(obj[1] - obj[0]) <= 1e-4 * obj[0], obj
    assert int(card.accepted) >= 1
    assert rms[1] < float(tb.reprojection_rms(prob, cam))
