"""Rank programs of the multi-device paths: what each rank runs under
``parallel.mesh.run_ranks``, shared by the tests and ``chip_smoke.py``.

A spawned rank imports this module, torch and this package only.
``run_cases(mesh, cases)`` runs a list of named cases in order on one set
of ranks, so the ranks start once for all of them; each case names a
program of ``PROGRAMS`` and its keyword arguments. Inputs arrive as the
port's dataclasses of CPU tensors (or numpy) and are moved to the rank's
device; results go back as numpy (run_ranks converts them), with the
collectives' payload by site (``mesh.COMM_SITES``), the host transport's
copies and the wall time of the call.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from visualslam_android_tpu_torch.models import bundle
from visualslam_android_tpu_torch.ops import fast
from visualslam_android_tpu_torch.ops import mestimator as me
from visualslam_android_tpu_torch.ops import scatter
from visualslam_android_tpu_torch.parallel import mesh as mesh_mod
from visualslam_android_tpu_torch.parallel import replicated_tracking as rt
from visualslam_android_tpu_torch.parallel import sharded_ba
from visualslam_android_tpu_torch.parallel import sharded_mapping


def _dev(x, device):
    if isinstance(x, np.ndarray):
        return torch.as_tensor(x, device=device)
    return x.to(device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(mesh, fn):
    """fn's result, its wall ms between two device synchronisations, the
    collectives' payload by site, the host copies, the FAST launches and
    the segmented-sum launches."""
    mesh_mod.reset_counters()
    for key in fast.LAUNCHES:
        fast.LAUNCHES[key] = 0
    for key in scatter.LAUNCHES:
        scatter.LAUNCHES[key] = 0
    _sync(mesh.device)
    t0 = time.perf_counter()
    out = fn()
    _sync(mesh.device)
    ms = 1e3 * (time.perf_counter() - t0)
    return dict(result=out, ms=ms, sites=dict(mesh_mod.COMM_SITES),
                host_copies=dict(mesh_mod.HOST_COPIES),
                launches=dict(fast.LAUNCHES),
                scatter_launches=dict(scatter.LAUNCHES))


def bundle_adjust(mesh, prob, cam, mode="psum", warmup=False, **kwargs):
    """sharded_bundle_adjust (mode "psum") or sharded_bundle_adjust_halo
    (mode "halo") of the whole problem; with warmup, one LM iteration
    first, untimed. Also the LM and CG counts of the timed run."""
    prob, cam = _dev(prob, mesh.device), _dev(cam, mesh.device)
    run = (sharded_ba.sharded_bundle_adjust_halo if mode == "halo"
           else sharded_ba.sharded_bundle_adjust)
    if warmup:
        run(prob, cam, mesh, **dict(kwargs, max_iters=1))
    bundle.HOST_READS.update(bundle_adjust=0, cg=0, halo_check=0)
    bundle.CG_STATS.update(solves=0, iterations=0)
    out = _timed(mesh, lambda: run(prob, cam, mesh, **kwargs))
    out.update(lm_iterations=bundle.HOST_READS["bundle_adjust"],
               cg_reads=bundle.HOST_READS["cg"],
               cg_solves=bundle.CG_STATS["solves"],
               cg_iterations=bundle.CG_STATS["iterations"])
    return out


def lm_step_bytes(mesh, prob, cam, mode="psum", **kwargs):
    """One LM step (max_iters=1: one outer and one inner iteration) of the
    rank program alone (sharded_bundle_adjust_program), with the
    collectives' payload by site and the CG iterations it issued (whole
    chunks of bundle.CG_CHUNK, at most cg_iters)."""
    prob, cam = _dev(prob, mesh.device), _dev(cam, mesh.device)
    kwargs = dict(kwargs, max_iters=1)
    if mode == "halo":
        K = prob.cam_R.shape[0]
        band = kwargs.get("band_halfwidth", 16)
        prob, _ = sharded_ba.pack_problem_camblock(prob, mesh.size, band)
        kwargs.update(assembly="band", solver="band_pcg", reduce_mode="halo",
                      shard_rows=K // mesh.size)
    program, padded = sharded_ba.sharded_bundle_adjust_program(
        prob, cam, mesh, **kwargs)
    bundle.HOST_READS.update(bundle_adjust=0, cg=0, halo_check=0)
    out = _timed(mesh, lambda: program(padded, cam))
    cg_iters = kwargs.get("cg_iters", 250)
    out.update(n_global=padded.points.shape[0],
               cg_issued=min(bundle.HOST_READS["cg"] * bundle.CG_CHUNK,
                             cg_iters),
               inner=bundle.HOST_READS["bundle_adjust"])
    del out["result"]
    return out


def halo_reduce(mesh, contrib, rows, halo):
    """bundle._halo_reduce_gather of this rank's contribution
    contrib[rank] [K, F]."""
    x = _dev(contrib[mesh_mod.axis_index(mesh)], mesh.device)
    return bundle._halo_reduce_gather(x, mesh, rows, halo, "halo_test")


def hist_sigma(mesh, err_sq, mask, estimator=me.TUKEY):
    """find_sigma_squared_hist of this rank's contiguous block of the
    errors, over the mesh."""
    rows = mesh_mod.shard_rows(mesh, err_sq.shape[0])
    return me.find_sigma_squared_hist(
        _dev(err_sq[rows], mesh.device), _dev(mask[rows], mesh.device),
        estimator, axis_name=mesh)


def _warm_timed(mesh, fn, warmup):
    """_timed(fn), after one untimed call when warmup is set."""
    if warmup:
        fn()
    return _timed(mesh, fn)


def refind(mesh, slam_map, kf_idx, cam, point_mask, config, warmup=False):
    """sharded_refind_in_keyframe: (meas store, found, never_retry_new)."""
    sm, cam = _dev(slam_map, mesh.device), _dev(cam, mesh.device)
    out = _warm_timed(
        mesh, lambda: sharded_mapping.sharded_refind_in_keyframe(
            sm, kf_idx, cam, _dev(point_mask, mesh.device), config, mesh),
        warmup)
    new_map, found, never = out["result"]
    out["result"] = (new_map.meas, found, never)
    return out


def refind_scalable(mesh, slam_map, kf_idx, cam, point_mask, config,
                    warmup=False):
    """sharded_refind_scalable: (found, pos_zero, search_level,
    did_subpix). The map's keyframe pyramids are cut to this rank's slots
    where they lie, before the map moves to the rank's device."""
    sm = _dev(sharded_mapping.shard_keyframe_pyramids(slam_map, mesh),
              mesh.device)
    cam = _dev(cam, mesh.device)
    return _warm_timed(
        mesh, lambda: sharded_mapping.sharded_refind_scalable(
            sm, kf_idx, cam, _dev(point_mask, mesh.device), config, mesh),
        warmup)


def epipolar(mesh, slam_map, src_kf, target_kf, cam, level, config,
             warmup=False):
    """sharded_epipolar_search."""
    sm, cam = _dev(slam_map, mesh.device), _dev(cam, mesh.device)
    return _warm_timed(
        mesh, lambda: sharded_mapping.sharded_epipolar_search(
            sm, src_kf, target_kf, cam, level, config, mesh), warmup)


def tracking(mesh, frames, state, slam_map, cam, uniforms, config,
             warmup=0):
    """replicated_step_fn over frames [F, S, H, W] from `state`: the
    outputs of every step and the final state; with warmup, that many
    steps first from the same state, untimed."""
    dev = mesh.device
    state, sm, cam = _dev(state, dev), _dev(slam_map, dev), _dev(cam, dev)
    frames, uniforms = _dev(frames, dev), _dev(uniforms, dev)
    step = rt.replicated_step_fn(mesh, config)
    st = state
    for k in range(warmup):
        st, _ = step(frames[k], st, sm, cam, uniforms)

    def run():
        st, outs = state, []
        for k in range(frames.shape[0]):
            st, o = step(frames[k], st, sm, cam, uniforms)
            outs.append(o)
        return st, outs

    return _timed(mesh, run)


def collectives(mesh, shapes, reps=20):
    """Each collective of parallel/mesh on f32 zeros of shape
    shapes[rank] (every rank the same shape, or the call raises on every
    rank), reps times: {kind: median wall ms of one call, the shape check
    and the host copies included}."""
    x = torch.zeros(shapes[mesh_mod.axis_index(mesh)], device=mesh.device)
    calls = {
        "psum": lambda: mesh_mod.psum(mesh, x),
        "all_gather": lambda: mesh_mod.all_gather(mesh, x),
        "psum_scatter": lambda: mesh_mod.psum_scatter(
            mesh, x.reshape(-1)[:x.numel() // mesh.size * mesh.size]),
        "ppermute": lambda: mesh_mod.ppermute_right(mesh, x),
        "broadcast": lambda: mesh_mod.broadcast(mesh, x, 0),
    }
    out = {}
    for kind, call in calls.items():
        times = []
        for _ in range(reps):
            _sync(mesh.device)
            t0 = time.perf_counter()
            call()
            _sync(mesh.device)
            times.append(1e3 * (time.perf_counter() - t0))
        out[kind] = float(np.median(times))
    return out


PROGRAMS = {f.__name__: f for f in (
    bundle_adjust, lm_step_bytes, halo_reduce, hist_sigma, refind,
    refind_scalable, epipolar, tracking, collectives)}


def run_cases(mesh, cases):
    """Run cases [(name, program name, kwargs)] in order on this rank:
    {name: the program's result}."""
    return {name: PROGRAMS[prog](mesh, **kwargs)
            for name, prog, kwargs in cases}

