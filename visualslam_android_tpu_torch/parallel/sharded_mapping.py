"""Mapping work sharded over the ranks of a mesh: re-find and the epipolar
search.

Port of the JAX package's ``parallel/sharded_mapping.py`` (SURVEY.md §2,
"sharded re-find / epipolar search"; MapMaker::ReFind_Common,
jni/MapMaker.cc:967-1036, and AddPointEpipolar, :525-703). Both are
parallel along their batch axis:

- re-find: each rank takes a POINT shard of the point store and of the
  point-major measurement table and matches its points in the target
  keyframe; measurement writes are row-local, so the updated table is the
  shards all-gathered;
- the memory-scalable re-find shards the KEYFRAME PYRAMID STORE too (K/D
  pyramids a rank): each rank warps the templates of the points whose
  source keyframe it owns (direct gathers; the warp depends only on the
  target pose, which is replicated), the others' are zero, and one
  psum_scatter over the point axis hands every rank its points'
  templates. The target keyframe's pyramid and corner masks come from
  their owner by broadcast. (The JAX package exchanges source slabs, its
  TPU gather workaround, and sums one non-zero contribution in place of
  the broadcast.)
- epipolar search: each rank takes a CANDIDATE block of the source
  keyframe against the replicated target level.

Every function runs on each rank of the mesh with the same global map,
but for the memory-scalable re-find, whose map holds only the rank's
keyframe pyramids (``shard_keyframe_pyramids``); a rank reads only its own
shard of the sharded stores.
"""

from __future__ import annotations

import torch

from visualslam_android_tpu_torch.config import SLAMConfig
from visualslam_android_tpu_torch.models import map_store, mapmaker
from visualslam_android_tpu_torch.models.map_store import SLAMMap
from visualslam_android_tpu_torch.ops import match
from visualslam_android_tpu_torch.parallel import mesh as mesh_mod


def _point_shard(slam_map: SLAMMap, rows):
    """The map with its point store and measurement table cut to `rows`
    (the keyframe store whole)."""
    return slam_map.replace(points=slam_map.points._map(lambda x: x[rows]),
                            meas=slam_map.meas._map(lambda x: x[rows]))


def sharded_refind_in_keyframe(slam_map: SLAMMap, kf_idx: int, cam,
                               point_mask, config: SLAMConfig, mesh):
    """mapmaker.refind_in_keyframe with the point axis sharded over `mesh`
    (the point capacity must divide the mesh size; map capacities are
    powers of two). Returns the same (slam_map, found, never_retry_new),
    the point-major outputs all-gathered."""
    rows = mesh_mod.shard_rows(mesh, slam_map.points.n_slots)
    sm, found, never = mapmaker.refind_in_keyframe(
        _point_shard(slam_map, rows), kf_idx, cam, point_mask[rows], config)
    meas = mesh_mod.gather_tree(mesh, sm.meas, site="refind")
    found, never = mesh_mod.gather_tree(mesh, (found, never), site="refind")
    return slam_map.replace(meas=meas), found, never


def _pad_slots(x, n: int):
    """x [k, ...] padded with zero slots to [n, ...]."""
    if x.shape[0] == n:
        return x
    return torch.cat([x, x.new_zeros((n - x.shape[0],) + tuple(x.shape[1:]))])


def _kf_shard(n_slots: int, mesh):
    """(K', lo): the keyframe slots a rank holds, K' = ceil(K / D), and the
    first of them, r K' (the K axis padded to D K', JAX
    ``sharded_mapping.py:117-124``)."""
    k_loc = -(-n_slots // mesh.size)
    return k_loc, mesh_mod.axis_index(mesh) * k_loc


def shard_keyframe_pyramids(slam_map: SLAMMap, mesh) -> SLAMMap:
    """The map with its keyframe pyramids and corner masks cut to this
    rank's slots [r K', (r + 1) K') (zero slots past the last keyframe);
    every other store whole. Cut it where the map lies before moving it to
    the rank's device, so the rank never holds the other pyramids."""
    kfs = slam_map.keyframes
    k_loc, lo = _kf_shard(kfs.n_slots, mesh)

    def cut(stack):
        return tuple(_pad_slots(x[lo:lo + k_loc], k_loc) for x in stack)

    return slam_map.replace(keyframes=kfs.replace(
        pyramid=cut(kfs.pyramid), corner_mask=cut(kfs.corner_mask)))


def sharded_refind_scalable(slam_map: SLAMMap, kf_idx: int, cam, point_mask,
                            config: SLAMConfig, mesh):
    """Re-find in keyframe `kf_idx` (a host int) with the keyframe pyramid
    store sharded over the mesh: `slam_map` is shard_keyframe_pyramids'
    map, whose pyramids and corner masks are this rank's K' slots only.
    Two phases:

    1. templates: the rank warps, from its own pyramids, the templates of
       the points whose source keyframe it holds, zeroes the others', and
       one psum_scatter over the point axis gives every rank the [N/D]
       templates of its point shard (O(N P^2 / D) a rank, whatever K);
    2. search: the target keyframe's pyramid and corner masks come from
       their owner by broadcast (O(H W)), and each rank runs
       mapmaker._refind_search_core on its points.

    Returns (found [N], pos_zero [N, 2], search_level [N], did_subpix
    [N]) all-gathered; the caller inserts the measurements (point-major)
    as refind_in_keyframe does."""
    pts, kfs = slam_map.points, slam_map.keyframes
    N = pts.n_slots
    rows = mesh_mod.shard_rows(mesh, N)
    k_loc, lo = _kf_shard(kfs.n_slots, mesh)
    pyramid, cmask = kfs.pyramid, kfs.corner_mask
    if any(x.shape[0] != k_loc for x in pyramid + cmask):
        raise ValueError(
            f"the keyframe pyramids hold {pyramid[0].shape[0]} slots, not "
            f"this rank's {k_loc}: pass shard_keyframe_pyramids' map")
    owner = kf_idx // k_loc
    R, t = kfs.R[kf_idx], kfs.t[kf_idx]  # tiny: replicated

    # Phase 1: the templates this rank can make from its pyramids.
    _, warp_inv, search_level, _ = mapmaker._refind_geometry(
        cam, R, t, pts.pos_w, pts.pixel_right_w, pts.pixel_down_w, config)
    local_kf = pts.source_kf - lo
    own = (local_kf >= 0) & (local_kf < k_loc)
    tmpl = mapmaker.refind_templates(
        pyramid, local_kf.clamp(0, k_loc - 1), pts.source_level, pts.center,
        warp_inv, search_level, config)
    mine = torch.cat([torch.where(own[:, None, None], tmpl.data,
                                  0.0).reshape(N, -1),
                      (own & tmpl.bad).to(tmpl.data.dtype)[:, None]], dim=1)
    mine = mesh_mod.psum_scatter(mesh, mine, site="templates")
    P = tmpl.data.shape[-1]
    templates = match.finalize_templates(mine[:, :-1].reshape(-1, P, P),
                                         mine[:, -1] > 0.5)

    # Phase 2: the target keyframe from its owner, then the point shard.
    dtype = pyramid[0].dtype
    if owner == mesh_mod.axis_index(mesh):
        target = [p[kf_idx - lo] for p in pyramid] + [
            c[kf_idx - lo].to(dtype) for c in cmask]
    else:
        target = [torch.empty(x.shape[1:], dtype=dtype, device=x.device)
                  for x in pyramid + cmask]
    flat = mesh_mod.broadcast(
        mesh, torch.cat([x.reshape(-1) for x in target]), owner,
        site="target_keyframe")
    levels, i = [], 0
    for x in target:
        levels.append(flat[i:i + x.numel()].view(x.shape))
        i += x.numel()
    n_lv = len(pyramid)
    target_pyramid = tuple(levels[:n_lv])
    target_mask = tuple(m > 0.5 for m in levels[n_lv:])

    already = map_store.point_observed_in(slam_map.meas, kf_idx)
    active = (point_mask & pts.live() & ~already)[rows]
    out = mapmaker._refind_search_core(
        pts._map(lambda x: x[rows]), templates, R, t, target_pyramid,
        target_mask, cam, active, config)
    return mesh_mod.gather_tree(mesh, out, site="refind")


def sharded_epipolar_search(slam_map: SLAMMap, src_kf, target_kf, cam,
                            level: int, config: SLAMConfig,
                            mesh) -> mapmaker.EpipolarResult:
    """mapmaker.epipolar_search with the candidate axis sharded over `mesh`:
    the best candidates are chosen first (the parity contract, JAX
    ``sharded_mapping.py:209-215``), padded to a multiple of the mesh
    size, each rank searches its block against the replicated target
    level, and the blocks are all-gathered with the padding dropped."""
    kfs = slam_map.keyframes
    src = mapmaker._slot_index(src_kf, kfs.t.device)
    cand_xy, cand_ok = mapmaker.select_top_candidates(
        mapmaker._slot(kfs.cand_xy[level], src).to(kfs.t.dtype),
        mapmaker._slot(kfs.cand_valid[level], src),
        config.mapmaker.max_epi_candidates,
    )
    C = cand_xy.shape[0]
    padded = C + (-C) % mesh.size
    rows = mesh_mod.shard_rows(mesh, padded)
    res = mapmaker.epipolar_search_cands(
        slam_map, src_kf, target_kf, cam, level, config,
        _pad_slots(cand_xy, padded)[rows], _pad_slots(cand_ok, padded)[rows])
    res = mesh_mod.gather_tree(mesh, res, site="epipolar")
    return res._map(lambda x: x[:C])
