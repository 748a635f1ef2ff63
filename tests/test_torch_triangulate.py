"""The port's two-view triangulation against the JAX package's on seeded
inputs, from wide to near-degenerate baselines, and its null vector
without a host read.

Both packages form the same f32 A^T A; the JAX package takes its null
vector by a 4x4 ``eigh``, the port by inverse and Rayleigh-quotient
iteration in float64 (``triangulate._null_vector``: no host read, where
``torch.linalg.eigh`` on the card checks its error flag on the host). The
truth here is the float64 eigenvector of A^T A built in float64 from the
same f32 inputs. Errors are relative to each point's largest coordinate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from visualslam_android_tpu.models import triangulate as jtri
from visualslam_android_tpu.ops import lie as jlie
from visualslam_android_tpu_torch.models import triangulate as ttri

torch.set_num_threads(2)

N_PTS = 2000


def _views(baseline, seed=5):
    """Points 2..6 m in front of camera A, camera B `baseline` m to the
    side with a small rotation, B's view with 0.5 px of noise at focal 270:
    the triangulate arguments as numpy f32."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-1.5, 1.5, N_PTS), rng.uniform(-1, 1, N_PTS),
                  rng.uniform(2, 6, N_PTS)], -1).astype(np.float32)
    Rb, tb = jax.tree.map(np.asarray, jlie.se3_exp(jnp.asarray(
        [baseline, 0.02 * baseline, 0.01 * baseline, 0.01, -0.05, 0.02],
        jnp.float32)))
    ma = X[:, :2] / X[:, 2:]
    Xb = X @ Rb.T + tb
    mb = (Xb[:, :2] / Xb[:, 2:] + rng.normal(scale=0.5 / 270,
                                             size=(N_PTS, 2))
          ).astype(np.float32)

    def bc(x, shape):
        return np.broadcast_to(x, (N_PTS, *shape)).copy()

    return (bc(np.eye(3, dtype=np.float32), (3, 3)), bc(np.zeros(3, np.float32),
                                                        (3,)),
            bc(Rb, (3, 3)), bc(tb, (3,)), ma.astype(np.float32), mb)


def _ata(args):
    """A^T A of the DLT rows, in the dtype of the arguments (torch)."""
    Ra, ta, Rb, tb, ma, mb = args
    rows = []
    for R, t, m in ((Ra, ta, ma), (Rb, tb, mb)):
        P = torch.cat([R, t[..., None]], dim=-1)
        rows += [m[..., 0:1] * P[..., 2, :] - P[..., 0, :],
                 m[..., 1:2] * P[..., 2, :] - P[..., 1, :]]
    A = torch.stack(rows, dim=-2)
    return A.transpose(-1, -2) @ A


def _dehom(x):
    return x[..., :3] / x[..., 3:]


def _truth(args):
    M = _ata([torch.as_tensor(a, dtype=torch.float64) for a in args])
    return _dehom(torch.linalg.eigh(M)[1][..., :, 0]).numpy()


def _run(args):
    jx = np.asarray(jtri.triangulate(*(jnp.asarray(a) for a in args)))
    tx = ttri.triangulate(*(torch.as_tensor(a) for a in args)).numpy()
    return jx, tx


def _rel(x, ref):
    return np.abs(x - ref).max(axis=1) / np.abs(ref).max(axis=1)


@pytest.mark.parametrize("baseline,tol", [(1.0, 1e-5), (0.3, 1e-4),
                                          (0.05, 3e-3)])
def test_triangulate_matches_jax(baseline, tol):
    """Well-posed baselines: the port within `tol` of the JAX package's
    point, about twice the JAX package's own largest error against the
    float64 truth at that baseline (4.5e-6, 5.5e-5, 1.5e-3: f32 eigh of
    A^T A loses accuracy as the baseline shrinks), and no further from the
    truth than the JAX package, worst case and median."""
    args = _views(baseline)
    jx, tx = _run(args)
    truth = _truth(args)
    assert _rel(tx, jx).max() < tol
    assert _rel(tx, truth).max() <= _rel(jx, truth).max()
    assert np.median(_rel(tx, truth)) <= np.median(_rel(jx, truth))


@pytest.mark.parametrize("baseline", [0.01, 0.002, 0.0005])
def test_near_degenerate_baselines(baseline):
    """Baselines of 1/200 to 1/4000 of the depth, where the f32 A^T A
    leaves the point ill-determined and the JAX package's points lie up to
    ~10x their size from the truth: every port point finite, its median
    error against the float64 truth no larger than the JAX package's, and
    its homogeneous vector the smallest eigenvector of the f32 A^T A (the
    Rayleigh quotient within 1e-9 of the largest eigenvalue above the
    smallest, in float64)."""
    args = _views(baseline)
    jx, tx = _run(args)
    truth = _truth(args)
    assert np.isfinite(tx).all()
    assert np.median(_rel(tx, truth)) <= np.median(_rel(jx, truth))
    M = _ata([torch.as_tensor(a) for a in args])
    x = ttri._null_vector(M).double()
    evals = torch.linalg.eigvalsh(M.double())
    rho = (x[:, None, :] @ M.double() @ x[:, :, None])[:, 0, 0]
    assert float((rho - evals[:, 0]).max()) <= 1e-9 * float(
        evals[:, -1].max())


def test_zero_baseline_gives_finite_points():
    """Both views from one centre: A^T A has a two-dimensional null space
    (every depth fits); the port returns a finite point in it for every
    pair, as the JAX package's eigh returns some vector of it."""
    args = _views(0.0)
    _, tx = _run(args)
    assert np.isfinite(tx).all()
    M = _ata([torch.as_tensor(a) for a in args]).double()
    X = torch.as_tensor(tx, dtype=torch.float64)
    xh = torch.cat([X, torch.ones(N_PTS, 1, dtype=torch.float64)], -1)
    xh = xh / torch.linalg.vector_norm(xh, dim=-1, keepdim=True)
    resid = (xh[:, None, :] @ M @ xh[:, :, None])[:, 0, 0]
    assert float(resid.max()) < 1e-6 * float(
        torch.diagonal(M, dim1=-2, dim2=-1).sum(-1).max())


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def test_triangulate_reads_nothing_back():
    """No eigh (its CUDA form checks an error flag on the host) and no
    other operator that reads the device: inv_ex and solve_ex leave their
    flags on the device."""
    args = [torch.as_tensor(a[:50]) for a in _views(0.3)]
    with _Ops() as ops:
        ttri.triangulate(*args)
    names = set(ops.names)
    assert not {n for n in names if "eigh" in n or "svd" in n}, names
    assert not names & {"_local_scalar_dense", "item", "is_nonzero",
                        "nonzero", "masked_select", "equal",
                        "_assert_async", "linalg_inv", "linalg_solve",
                        "_linalg_check_errors"}, names
