"""Frame-rate tracking: the reference's Tracking state machine
(src/Tracking.cc:267-506) as host orchestration over jitted kernels.

State flow per frame (stereo / RGB-D path first, like the reference's
50-line StereoInitialization vs the 370-line monocular path):

  NOT_INITIALIZED --(depth init)--> OK
  OK: TrackWithMotionModel (fallback TrackReferenceKeyFrame)
      -> TrackLocalMap -> NeedNewKeyFrame? -> CreateNewKeyFrame
  LOST: Relocalization (models.relocalization once BoW lands)

All per-frame math runs on device with fixed shapes; the host makes the
branch decisions from scalar pulls (inlier counts), mirroring the
reference's control flow without its mutexes.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from orb_slam2_comment_tpu import constants as C
from orb_slam2_comment_tpu.models import local_mapping as lm
from orb_slam2_comment_tpu.models import map_state as ms
from orb_slam2_comment_tpu.models.frame import Frame
from orb_slam2_comment_tpu.ops import bow
from orb_slam2_comment_tpu.ops import geometry as geo
from orb_slam2_comment_tpu.ops import matching, optim
from orb_slam2_comment_tpu.utils.config import MONOCULAR, SlamConfig

# Tracking states (Tracking.h:81-87)
NO_IMAGES_YET = -1
NOT_INITIALIZED = 0
OK = 1
LOST = 2

LOCAL_POINTS_CAP = 8192


def _inv_sigma2(cfg: SlamConfig) -> jnp.ndarray:
    return jnp.asarray(
        [1.0 / (cfg.scale_factor ** (2 * l)) for l in range(cfg.n_levels)],
        jnp.float32,
    )


# ---------------------------------------------------------------------------
# jitted kernels
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("cfg", "use_frustum_band"))
def _match_against_points(
    m: ms.MapState,
    pt_ids: jax.Array,       # [P] candidate point ids (-1 padded)
    Tcw: jax.Array,
    feats,
    uright: jax.Array,
    radius: jax.Array,
    cfg: SlamConfig,
    use_frustum_band: bool = True,
):
    """Project candidate map points into the frame and associate features
    (SearchByProjection(Frame, vector<MapPoint*>, th),
    src/ORBmatcher.cc:45-129 + Frame::isInFrustum, src/Frame.cc:269-326).

    Returns (assoc [N] point id or -1, n_matches, visible_mask [P]).
    """
    P = pt_ids.shape[0]
    pid = jnp.clip(pt_ids, 0, m.pt_pos.shape[0] - 1)
    ok = (pt_ids >= 0) & m.pt_valid[pid]
    X = m.pt_pos[pid]
    Xc = geo.transform_points(Tcw, X)
    uv = geo.project(cfg.K, Xc)
    h, w = cfg.height, cfg.width
    in_img = (
        (Xc[:, 2] > 0.05)
        & (uv[:, 0] >= 0) & (uv[:, 0] < w)
        & (uv[:, 1] >= 0) & (uv[:, 1] < h)
    )
    # distance-invariance band + viewing angle (isInFrustum)
    cam_center = -(Tcw[:3, :3].T @ Tcw[:3, 3])
    vec = X - cam_center
    dist = jnp.linalg.norm(vec, axis=-1)
    band = (dist >= 0.8 * m.pt_min_dist[pid]) & (dist <= 1.2 * m.pt_max_dist[pid])
    if use_frustum_band:
        view_cos = jnp.sum(vec * m.pt_normal[pid], axis=-1) / jnp.maximum(dist, 1e-9)
        frustum = band & (view_cos > 0.5)
    else:
        frustum = jnp.ones_like(band)
    visible = ok & in_img & frustum
    pred_oct = ms.predict_scale(
        dist, m.pt_max_dist[pid], cfg.scale_factor, cfg.n_levels
    )
    res = matching.match_projection(
        proj_xy=uv,
        proj_valid=visible,
        proj_desc=m.pt_desc[pid],
        proj_octave=pred_oct,
        feats=feats,
        radius=radius,
        scale_factors=jnp.asarray(cfg.orb.scales),
        max_dist=cfg.th_high,
        nn_ratio=0.8,
    )
    n = feats.xy.shape[0]
    assoc = _invert_matches(res, pt_ids, n)
    # features that already failed validity shouldn't hold associations
    assoc = jnp.where(feats.valid, assoc, -1)
    n_matches = jnp.sum(assoc >= 0)
    return assoc, n_matches, visible


def _invert_matches(res, row_ids, n_cols):
    """Row->col matches inverted to a per-column assignment, resolving
    collisions deterministically by best Hamming distance (a plain
    colliding scatter would be order-undefined on XLA and make runs
    non-reproducible). Encodes (distance, row-id) into one int key and
    scatter-mins it."""
    key = (
        jnp.clip(res.dist, 0, 511).astype(jnp.int32) * (1 << 20)
        + jnp.clip(row_ids, 0, (1 << 20) - 1)
    )
    key = jnp.where(res.ok & (row_ids >= 0), key, jnp.int32(0x7FFFFFFF))
    best = jnp.full((n_cols,), 0x7FFFFFFF, jnp.int32).at[res.idx].min(key)
    return jnp.where(best < 0x7FFFFFFF, best % (1 << 20), -1)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _pose_opt_from_assoc(
    m: ms.MapState,
    Tcw0: jax.Array,
    feats,
    uright: jax.Array,
    assoc: jax.Array,
    cfg: SlamConfig,
):
    """Motion-only BA on current associations (Optimizer::PoseOptimization)."""
    pid = jnp.clip(assoc, 0, m.pt_pos.shape[0] - 1)
    valid = (assoc >= 0) & m.pt_valid[pid] & feats.valid
    Xw = m.pt_pos[pid]
    obs = jnp.concatenate([feats.xy, uright[:, None]], axis=-1)
    is_stereo = uright >= 0
    res = optim.pose_optimize(
        Tcw0,
        Xw,
        obs,
        feats.octave,
        is_stereo,
        valid,
        _inv_sigma2(cfg),
        cfg.K,
        cfg.bf,
    )
    assoc_out = jnp.where(res.inliers, assoc, -1)
    return res.Tcw, assoc_out, res.n_inliers


@jax.jit
def _select_local_map(m: ms.MapState, assoc: jax.Array):
    """Local keyframes = KFs sharing observations with the current frame,
    capped at LOCAL_MAP_MAX_KFS (Tracking::UpdateLocalKeyFrames,
    src/Tracking.cc:1243-1339); local points = union of their observations
    (UpdateLocalPoints, :1215-1241). Returns (kf_ids, pt_ids) padded -1.

    When the union exceeds LOCAL_POINTS_CAP, points are kept by the
    covisibility strength of their strongest local observer (a plain 0/1
    top_k would keep the lowest slot indices — the OLDEST points — and
    silently drop exactly the recent points the frame can see, degrading
    tracking as the map grows past the cap)."""
    pmax = m.pt_pos.shape[0]
    kmax = m.kf_pose.shape[0]
    in_cur = jnp.zeros(pmax, bool).at[jnp.clip(assoc, 0, pmax - 1)].set(assoc >= 0)
    shared = in_cur[jnp.clip(m.kf_obs, 0, pmax - 1)] & (m.kf_obs >= 0)
    counts = jnp.where(m.kf_valid, jnp.sum(shared, axis=1), 0)
    k = min(C.LOCAL_MAP_MAX_KFS, kmax)
    top_counts, top_kfs = jax.lax.top_k(counts, k)
    kf_ids = jnp.where(top_counts > 0, top_kfs, -1)
    # local points scored by their strongest observer's shared-obs count
    obs_sel = m.kf_obs[jnp.clip(kf_ids, 0, kmax - 1)]            # [k, N]
    w = jnp.where(kf_ids >= 0, top_counts, 0)                    # [k]
    score = jnp.zeros(pmax, jnp.int32).at[
        jnp.clip(obs_sel.reshape(-1), 0, pmax - 1)
    ].max((w[:, None] * (obs_sel >= 0)).reshape(-1))
    score = jnp.where(m.pt_valid, score, 0)
    mask = score > 0
    n_cand = jnp.sum(mask)

    def _compact(_):
        # candidate count fits the cap: stream-compact by cumsum position
        # (O(Pmax) scan + scatter) instead of a top_k over the whole point
        # table
        pos = jnp.cumsum(mask) - 1
        dst = jnp.where(mask, jnp.minimum(pos, LOCAL_POINTS_CAP), LOCAL_POINTS_CAP)
        out = jnp.full((LOCAL_POINTS_CAP + 1,), -1, jnp.int32)
        out = out.at[dst].set(jnp.arange(pmax, dtype=jnp.int32))
        return out[:LOCAL_POINTS_CAP]

    def _topk(_):
        vals, ids = jax.lax.top_k(score, LOCAL_POINTS_CAP)
        return jnp.where(vals > 0, ids, -1)

    pt_ids = jax.lax.cond(n_cand <= LOCAL_POINTS_CAP, _compact, _topk, 0)
    return kf_ids, pt_ids


@jax.jit
def _update_point_counters(m: ms.MapState, pt_ids, visible, assoc):
    """IncreaseVisible for frustum-visible local points, IncreaseFound for
    inlier-associated points (Tracking::SearchLocalPoints + TrackLocalMap,
    src/Tracking.cc:930-975,1143-1193)."""
    pmax = m.pt_pos.shape[0]
    # one fused scatter-add into a [Pmax, 2] accumulator (two separate
    # scatters each pay the full scatter fixed cost)
    pid = jnp.clip(pt_ids, 0, pmax - 1)
    aid = jnp.clip(assoc, 0, pmax - 1)
    idx = jnp.concatenate([pid, aid])
    vis_upd = jnp.stack(
        [(visible & (pt_ids >= 0)).astype(jnp.int32),
         jnp.zeros_like(pid)], axis=-1,
    )
    fnd_upd = jnp.stack(
        [jnp.zeros_like(aid), (assoc >= 0).astype(jnp.int32)], axis=-1
    )
    upd = jnp.concatenate([vis_upd, fnd_upd])
    acc = jnp.zeros((pmax, 2), jnp.int32).at[idx].add(upd)
    return m._replace(
        pt_visible=m.pt_visible + acc[:, 0], pt_found=m.pt_found + acc[:, 1]
    )


@functools.partial(jax.jit, static_argnames=("cfg", "max_new", "create_all_depth"))
def _create_keyframe_kernel(
    m: ms.MapState,
    slot: jax.Array,          # scalar int32 keyframe slot
    pt_base: jax.Array,       # scalar int32 first free point slot
    frame_id: jax.Array,
    timestamp: jax.Array,
    Tcw: jax.Array,
    feats,
    uright: jax.Array,
    depth: jax.Array,
    assoc: jax.Array,
    parent: jax.Array,
    cfg: SlamConfig,
    max_new: int = 256,
    create_all_depth: bool = False,
):
    return _create_kf_core(
        m, slot, pt_base, frame_id, timestamp, Tcw, feats, uright, depth,
        assoc, parent, cfg, max_new, create_all_depth,
        enabled=jnp.asarray(True),
    )


def _create_kf_core(
    m: ms.MapState,
    slot: jax.Array,
    pt_base: jax.Array,
    frame_id: jax.Array,
    timestamp: jax.Array,
    Tcw: jax.Array,
    feats,
    uright: jax.Array,
    depth: jax.Array,
    assoc: jax.Array,
    parent: jax.Array,
    cfg: SlamConfig,
    max_new: int = 256,
    create_all_depth: bool = False,
    enabled: jax.Array = None,
    groups: jax.Array = None,   # [N] BoW FeatureVector node ids computed
                                # on device at creation (chunked mode —
                                # removes the host backfill and its
                                # scheduling-dependent landing time)
):
    """Insert a keyframe and spawn close stereo/RGBD points.

    Mirrors Tracking::CreateNewKeyFrame (src/Tracking.cc:1063-1141): new
    points for features with 0 < depth, unassociated, sorted by depth,
    stopping after MAX_CLOSE_STEREO_POINTS close ones (all of them at
    initialization, Tracking.cc:509-561 StereoInitialization).
    Returns (new_map, n_created).
    """
    n = feats.xy.shape[0]
    pmax = m.pt_pos.shape[0]
    max_new = min(max_new, pmax)  # contiguous-block write must fit
    if enabled is None:
        enabled = jnp.asarray(True)

    cand = feats.valid & (depth > 0) & (assoc < 0) & enabled
    if not create_all_depth:
        # take closest first; the reference stops once it has added 100
        # points closer than th_depth (or at least the 100 closest)
        pass
    order = jnp.argsort(jnp.where(cand, depth, 1e9))
    sel_rank = jnp.arange(n)
    take = cand[order] & (sel_rank < max_new)
    if not create_all_depth:
        close = depth[order] <= cfg.depth_threshold
        rank_ok = (sel_rank < C.MAX_CLOSE_STEREO_POINTS) | close
        # reference: beyond 100 points, only close ones are added — inverted:
        # it adds in depth order and stops when >100 AND current is far
        take = take & rank_ok & (sel_rank < max_new)

    feat_idx = order[:max_new]
    take = take[:max_new]
    # contiguous slots -> dynamic-slice writes (no sort-based scatters);
    # an overfull cursor creates nothing this keyframe (see the same
    # pattern in local_mapping.triangulate_with_neighbor)
    base_ok = pt_base <= pmax - max_new
    take = take & base_ok
    b0 = jnp.clip(pt_base, 0, pmax - max_new)
    new_ids = b0 + jnp.arange(max_new, dtype=jnp.int32)
    new_ids_c = new_ids

    # unproject selected features
    z = depth[feat_idx]
    uv = feats.xy[feat_idx]
    Xc = geo.backproject(cfg.K, uv, z)
    Twc = geo.inv_T(Tcw)
    Xw = geo.transform_points(Twc, Xc)
    cam_center = Twc[:3, 3]
    vec = Xw - cam_center
    dist = jnp.linalg.norm(vec, axis=-1)
    normal = vec / jnp.maximum(dist[:, None], 1e-9)
    lvl = feats.octave[feat_idx].astype(jnp.float32)
    max_dist = dist * (cfg.scale_factor ** lvl)
    # mfMaxDistance = dist*levelScaleFactor; mfMinDistance = mfMaxDistance /
    # scaleFactor^(nLevels-1) (MapPoint::UpdateNormalAndDepth,
    # src/MapPoint.cc:355-360). Stored UNMARGINED: the 0.8/1.2 invariance
    # margins (MapPoint.cc:373-383) are applied at query time by the
    # frustum/fuse band checks.
    min_dist = max_dist / (cfg.scale_factor ** (cfg.n_levels - 1))

    def put(arr, vals):
        cur = jax.lax.dynamic_slice_in_dim(arr, b0, max_new, axis=0)
        sel = take.reshape(take.shape + (1,) * (arr.ndim - 1))
        new = jnp.where(sel, jnp.asarray(vals, arr.dtype), cur)
        return jax.lax.dynamic_update_slice_in_dim(arr, new, b0, axis=0)

    m = m._replace(
        pt_pos=put(m.pt_pos, Xw),
        pt_valid=put(m.pt_valid, jnp.ones_like(take)),
        pt_desc=put(m.pt_desc, feats.desc[feat_idx]),
        pt_normal=put(m.pt_normal, normal),
        pt_min_dist=put(m.pt_min_dist, min_dist),
        pt_max_dist=put(m.pt_max_dist, max_dist),
        pt_ref_kf=put(m.pt_ref_kf, jnp.zeros_like(new_ids) + slot),
        pt_first_kf=put(m.pt_first_kf, jnp.zeros_like(new_ids) + slot),
        pt_visible=put(m.pt_visible, jnp.ones_like(new_ids)),
        pt_found=put(m.pt_found, jnp.ones_like(new_ids)),
    )

    # keyframe observation table: tracked associations + newly created
    kf_obs_row = assoc
    kf_obs_row = kf_obs_row.at[feat_idx].set(
        jnp.where(take, new_ids_c, kf_obs_row[feat_idx])
    )
    def put_row(arr, new):
        old = arr[slot]
        sel = jnp.reshape(enabled, (1,) * old.ndim) if old.ndim else enabled
        return arr.at[slot].set(jnp.where(sel, new, old))

    m = m._replace(
        kf_pose=put_row(m.kf_pose, Tcw),
        kf_valid=put_row(m.kf_valid, True),
        # born protected from culling until the loop closer releases it
        # (SetNotErase at queue push, src/LoopClosing.cc:110; cleared by
        # Tracker.set_kf_erasable once detection is harvested/skipped)
        kf_no_erase=put_row(m.kf_no_erase, True),
        kf_frame_id=put_row(m.kf_frame_id, frame_id),
        kf_timestamp=put_row(m.kf_timestamp, timestamp),
        kf_xy=put_row(m.kf_xy, feats.xy),
        kf_octave=put_row(m.kf_octave, feats.octave),
        kf_angle=put_row(m.kf_angle, feats.angle),
        kf_uright=put_row(m.kf_uright, uright),
        kf_depth=put_row(m.kf_depth, depth),
        kf_desc=put_row(m.kf_desc, feats.desc),
        kf_feat_valid=put_row(m.kf_feat_valid, feats.valid),
        kf_obs=put_row(m.kf_obs, kf_obs_row),
        kf_parent=put_row(m.kf_parent, parent),
    )
    if groups is not None:
        m = m._replace(kf_group=put_row(m.kf_group, groups))
    return m, jnp.sum(take), kf_obs_row


@functools.partial(jax.jit, static_argnames=("cfg",))
def _match_ref_kf(m: ms.MapState, ref_kf: jax.Array, feats, cfg: SlamConfig,
                  frame_groups: jax.Array = None):
    """Associate current features to the reference KF's map points by
    BoW-node-gated descriptor matching (TrackReferenceKeyFrame's
    SearchByBoW, src/Tracking.cc:757-799 / src/ORBmatcher.cc:159-288).

    The node gate is not just candidate pruning: it scopes the Lowe ratio
    test to same-node competitors, which changes acceptance on repetitive
    scenes — the reference semantics. When the KF has no indexed groups
    yet (its kf_group row is all -1, i.e. the host backfill from the
    KeyFrameDatabase has not landed) the gate falls back to the full
    Hamming match, a superset of the node-masked candidate set."""
    kf_desc = m.kf_desc[ref_kf]
    kf_obs = m.kf_obs[ref_kf]
    kf_ok = m.kf_feat_valid[ref_kf] & (kf_obs >= 0)
    dist = matching.hamming_from_packed(kf_desc, feats.desc)
    mask = kf_ok[:, None] & feats.valid[None, :]
    if frame_groups is not None:
        ga = m.kf_group[ref_kf]
        row_ungated = ~jnp.any(ga >= 0)
        node_ok = (ga[:, None] == frame_groups[None, :]) & (ga >= 0)[:, None]
        mask = mask & (node_ok | row_ungated)
    res = matching.match_generic(
        dist, mask, cfg.th_low, nn_ratio=0.7, mutual=True,
        angles_a=m.kf_angle[ref_kf], angles_b=feats.angle,
    )
    n = feats.xy.shape[0]
    assoc = _invert_matches(res, kf_obs, n)
    assoc = jnp.where(feats.valid, assoc, -1)
    return assoc, jnp.sum(assoc >= 0)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _track_vo_frame(
    last_feats,
    last_depth: jax.Array,    # [N] metric depth of the previous frame (-1 = none)
    last_uright: jax.Array,   # [N]
    T_last: jax.Array,
    T_pred: jax.Array,
    feats,
    uright: jax.Array,
    cfg: SlamConfig,
):
    """Visual-odometry tracking against the previous frame — the
    fixed-shape analogue of the temporal 'visual odometry' MapPoints the
    reference creates from the last frame's depth in localization-only
    mode (Tracking::UpdateLastFrame, src/Tracking.cc:801-865, consumed by
    the mbVO branch of Track(), src/Tracking.cc:333-391).

    Instead of allocating temporary map points, the previous frame's
    depth-bearing features are backprojected through its pose and matched
    into the current frame by projection; a motion-only LM solve gives the
    odometry pose. Returns (Tcw, n_inliers).
    """
    z = last_depth
    ok3d = last_feats.valid & (z > 0)
    Xc = geo.backproject(cfg.K, last_feats.xy, z)
    Xw = geo.transform_points(geo.inv_T(T_last), Xc)
    Xp = geo.transform_points(T_pred, Xw)
    uv = geo.project(cfg.K, Xp)
    h, w = cfg.height, cfg.width
    visible = (
        ok3d
        & (Xp[:, 2] > 0.05)
        & (uv[:, 0] >= 0) & (uv[:, 0] < w)
        & (uv[:, 1] >= 0) & (uv[:, 1] < h)
    )
    res = matching.match_projection(
        proj_xy=uv,
        proj_valid=visible,
        proj_desc=last_feats.desc,
        proj_octave=last_feats.octave,
        feats=feats,
        radius=jnp.asarray(15.0),
        scale_factors=jnp.asarray(cfg.orb.scales),
        max_dist=cfg.th_high,
        nn_ratio=0.9,
        angles_p=last_feats.angle,
    )
    n = feats.xy.shape[0]
    rows = jnp.where(visible, jnp.arange(n, dtype=jnp.int32), -1)
    assoc = _invert_matches(res, rows, n)
    valid = (assoc >= 0) & feats.valid
    pid = jnp.clip(assoc, 0, n - 1)
    obs = jnp.concatenate([feats.xy, uright[:, None]], axis=-1)
    out = optim.pose_optimize(
        T_pred, Xw[pid], obs, feats.octave, uright >= 0, valid,
        _inv_sigma2(cfg), cfg.K, cfg.bf,
    )
    return out.Tcw, out.n_inliers


# ---------------------------------------------------------------------------
# fused per-frame kernel (ONE device program, ONE host pull per frame)
#
# Every device->host transfer stalls the host; the
# reference's per-frame control flow (motion model -> fallback -> local map
# -> keyframe policy, src/Tracking.cc:267-506) is therefore evaluated
# entirely on device with jnp.where selection, and the host reads back a
# single small stats vector to run the Python state machine.
# ---------------------------------------------------------------------------

# stats vector layout
S_TRACKED = 0        # 1.0 if frame tracked
S_N_INL = 1          # final local-map inliers
S_USED_MOTION = 2    # 1.0 if the motion-model branch won
S_NEED_KF = 3        # keyframe policy decision
S_BEST_LOCAL = 4     # best covisible KF id (new reference KF)
S_N_MOTION = 5       # motion-model match count
S_N_REF = 6          # reference-KF match count
S_TRACKED_CLOSE = 7
S_NONTRACKED_CLOSE = 8
S_N_REF_MATCHES = 9  # reference-KF tracked points with >= minObs
S_COARSE_OK = 10     # motion/ref coarse stage succeeded
S_INL_M = 11         # motion-branch pose-opt inliers
S_INL_R = 12         # ref-branch pose-opt inliers
N_STATS = 13


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnums=(0,))
def _track_frame_fused(
    m: ms.MapState,
    feats,
    uright: jax.Array,
    depth: jax.Array,
    T_pred: jax.Array,
    T_last: jax.Array,
    have_velocity: jax.Array,
    last_assoc: jax.Array,
    ref_kf: jax.Array,
    frame_id: jax.Array,
    last_kf_frame_id: jax.Array,
    n_kfs: jax.Array,
    cfg: SlamConfig,
    voc_gate=None,
):
    return _track_core(
        m, feats, uright, depth, T_pred, T_last, have_velocity, last_assoc,
        ref_kf, frame_id, last_kf_frame_id, n_kfs, cfg, voc_gate=voc_gate,
    )


def _track_core(
    m: ms.MapState,
    feats,
    uright: jax.Array,
    depth: jax.Array,
    T_pred: jax.Array,        # motion-model prediction (== T_last if no velocity)
    T_last: jax.Array,
    have_velocity: jax.Array,  # scalar bool
    last_assoc: jax.Array,     # [N] previous frame's point associations
    ref_kf: jax.Array,         # scalar int32
    frame_id: jax.Array,
    last_kf_frame_id: jax.Array,
    n_kfs: jax.Array,
    cfg: SlamConfig,
    obs_counts: jax.Array = None,  # [Pmax] cached per-point observation
                                   # counts; recomputed only on map change
    voc_gate=None,                 # (children [Nn,k] i32, signed [Nn,256]
                                   # bf16) BoW tree for node-gated ref-KF
                                   # matching; None = full Hamming
    mapper_idle=None,              # scalar bool: live mapper-machine idle
                                   # flag (chunked mapper); None = the
                                   # lag-window heuristic
):
    """Returns (m', Tcw, assoc, stats[N_STATS] f32).

    Both the motion-model and reference-KF branches are computed
    unconditionally (each is a few small matmuls) and
    selected by priority, exactly reproducing the reference's fallback
    order without host round-trips.
    """
    th = 7.0 if cfg.sensor != MONOCULAR else 15.0
    n_feat = feats.xy.shape[0]

    # --- branch 1: motion model (TrackWithMotionModel, :867-928) ---------
    assoc_m1, n_m1, _ = _match_against_points(
        m, last_assoc, T_pred, feats, uright, jnp.asarray(th), cfg,
        use_frustum_band=False,
    )

    # widened retry (Tracking.cc:888-892) only when the narrow search came
    # up short — a real branch, because the retry is rare in steady state
    def _wide_retry(_):
        a2, n2, _ = _match_against_points(
            m, last_assoc, T_pred, feats, uright, jnp.asarray(2.0 * th), cfg,
            use_frustum_band=False,
        )
        return a2, n2

    assoc_m, n_m = jax.lax.cond(
        n_m1 < C.TRACK_MOTION_MIN_MATCHES,
        _wide_retry,
        lambda _: (assoc_m1, n_m1),
        0,
    )
    T_m, assoc_m, inl_m = _pose_opt_from_assoc(m, T_pred, feats, uright, assoc_m, cfg)
    motion_ok = have_velocity & (n_m >= C.TRACK_MOTION_MIN_MATCHES) & (inl_m >= 10)

    # --- branch 2: reference keyframe (TrackReferenceKeyFrame, :757-799) -
    # only evaluated when the motion model failed (the reference's exact
    # fallback order, Tracking.cc:342-352); skipping it saves its matching
    # and pose LM on every steady-state frame
    def _ref_branch(_):
        fg = None
        if voc_gate is not None:
            fg = bow.group_ids(voc_gate[0], voc_gate[1], feats.desc,
                               feats.valid, cfg.voc_levels)
        assoc_r, n_r = _match_ref_kf(m, ref_kf, feats, cfg, frame_groups=fg)
        T_r, assoc_r, inl_r = _pose_opt_from_assoc(
            m, T_last, feats, uright, assoc_r, cfg
        )
        return T_r, assoc_r, inl_r, n_r

    T_r, assoc_r, inl_r, n_r = jax.lax.cond(
        motion_ok,
        lambda _: (
            T_last,
            jnp.full((n_feat,), -1, assoc_m.dtype),
            jnp.asarray(0, inl_m.dtype),
            jnp.asarray(0, n_m.dtype),
        ),
        _ref_branch,
        0,
    )
    ref_ok = (n_r >= C.TRACK_REF_KF_MIN_MATCHES) & (inl_r >= 10)

    T1 = jnp.where(motion_ok, T_m, T_r)
    assoc1 = jnp.where(motion_ok, assoc_m, assoc_r)
    coarse_ok = motion_ok | ref_ok

    # --- local map (TrackLocalMap, :930-975) ------------------------------
    # NOTE: do NOT widen this radius adaptively — a wider window pulls in
    # competing candidates whose second-best distance defeats the Lowe
    # ratio test, and net matches DROP (measured: adaptive 3x widening
    # cost ~5-15 inliers/frame, compounding into tracking loss)
    kf_ids, pt_ids = _select_local_map(m, assoc1)
    th_local = 3.0 if cfg.sensor == "rgbd" else 1.0
    assoc2, n2, visible = _match_against_points(
        m, pt_ids, T1, feats, uright, jnp.asarray(th_local), cfg,
    )
    assoc_merged = jnp.where(assoc1 >= 0, assoc1, assoc2)
    T_f, assoc_f, inl_f = _pose_opt_from_assoc(m, T1, feats, uright, assoc_merged, cfg)
    tracked = coarse_ok & (inl_f >= C.TRACK_LOCAL_MAP_MIN_INLIERS)

    Tcw = jnp.where(tracked, T_f, T_last)
    assoc_out = jnp.where(tracked, assoc_f, -1)
    # point counters update on every coarse-tracked frame (the reference's
    # SearchLocalPoints runs before the final inlier gate)
    assoc_seen = jnp.where(coarse_ok, assoc_f, -1)
    m = _update_point_counters(m, pt_ids, visible & coarse_ok, assoc_seen)

    # --- keyframe policy (NeedNewKeyFrame, :977-1061) ---------------------
    best_local = kf_ids[0]
    ref_for_policy = jnp.where(best_local >= 0, best_local, ref_kf)
    min_obs = jnp.where(n_kfs <= 2, 2, 3)
    if obs_counts is None:
        obs_counts = ms.point_observation_counts(m)
    ref_obs = m.kf_obs[jnp.clip(ref_for_policy, 0, cfg.max_keyframes - 1)]
    ref_pid = jnp.clip(ref_obs, 0, cfg.max_points - 1)
    ref_ok_pts = (ref_obs >= 0) & m.pt_valid[ref_pid]
    n_ref_matches = jnp.sum(ref_ok_pts & (obs_counts[ref_pid] >= min_obs))
    if cfg.sensor != MONOCULAR:
        close = (depth > 0) & (depth < cfg.depth_threshold)
        tracked_close = jnp.sum((assoc_out >= 0) & close)
        nontracked_close = jnp.sum((assoc_out < 0) & close & feats.valid)
        need_close = (tracked_close < 100) & (nontracked_close > 70)
    else:
        tracked_close = jnp.asarray(0)
        nontracked_close = jnp.asarray(0)
        need_close = jnp.asarray(False)
    th_ref = 0.9 if cfg.sensor == MONOCULAR else 0.75
    th_ref_j = jnp.where(n_kfs < 2, 0.4, th_ref)
    frames_since = frame_id - last_kf_frame_id
    c1a = frames_since >= cfg.fps
    # c1b requires LOCAL MAPPING IDLE in the reference (bLocalMappingIdle,
    # src/Tracking.cc:1028-1037, mMinFrames=0) — the backpressure that
    # stops keyframe spam while the mapper digests the last insertion.
    # With the chunked mapper machine the caller passes the LIVE idle
    # flag (phase == 0 — the real SetAcceptKeyFrames semantics,
    # src/LocalMapping.cc:603-613). Fallback for the monolithic path: the
    # mapper pass for a keyframe lands ~pipeline_lag frames after its
    # creation, so the mapper is 'busy' for that window. c1c (urgent
    # close-point deficit) intentionally bypasses the gate, as in the
    # reference's InterruptBA-and-insert-anyway path (Tracking.cc:1043-1057).
    if mapper_idle is not None:
        c1b = jnp.asarray(mapper_idle) & (frames_since >= 1)
    else:
        busy_window = max(int(getattr(cfg, "pipeline_lag", 4)) + 1, 2)
        c1b = frames_since > busy_window
    c1c = (cfg.sensor != MONOCULAR) & (
        (inl_f < n_ref_matches * 0.25) | need_close
    )
    c2 = ((inl_f < n_ref_matches * th_ref_j) | need_close) & (inl_f > 15)
    need_kf = (
        tracked
        & (c1a | c1b | c1c)
        & c2
        & (n_kfs < cfg.max_keyframes - 1)
        & (not cfg.localization_only)
    )

    stats = jnp.zeros(N_STATS, jnp.float32)
    stats = stats.at[S_TRACKED].set(tracked.astype(jnp.float32))
    stats = stats.at[S_N_INL].set(inl_f.astype(jnp.float32))
    stats = stats.at[S_USED_MOTION].set(motion_ok.astype(jnp.float32))
    stats = stats.at[S_NEED_KF].set(need_kf.astype(jnp.float32))
    stats = stats.at[S_BEST_LOCAL].set(best_local.astype(jnp.float32))
    stats = stats.at[S_N_MOTION].set(n_m.astype(jnp.float32))
    stats = stats.at[S_N_REF].set(n_r.astype(jnp.float32))
    stats = stats.at[S_TRACKED_CLOSE].set(tracked_close.astype(jnp.float32))
    stats = stats.at[S_NONTRACKED_CLOSE].set(nontracked_close.astype(jnp.float32))
    stats = stats.at[S_N_REF_MATCHES].set(n_ref_matches.astype(jnp.float32))
    stats = stats.at[S_COARSE_OK].set(coarse_ok.astype(jnp.float32))
    stats = stats.at[S_INL_M].set(inl_m.astype(jnp.float32))
    stats = stats.at[S_INL_R].set(inl_r.astype(jnp.float32))
    return m, Tcw, assoc_out, stats


@jax.jit
def _compose_velocity(Tcw, T_last):
    """velocity = Tcw @ T_last^-1 (Tracking.cc:423-434), device-resident.
    Re-orthonormalized: the constant-velocity chain is the fastest
    off-SO(3) amplifier in the system (see geo.orthonormalize_R)."""
    return geo.orthonormalize_T(Tcw @ geo.inv_T(T_last))


@jax.jit
def _apply_velocity(velocity, T_last):
    return geo.orthonormalize_T(velocity @ T_last)


@jax.jit
def _relative_to_kf(Tcw, kf_pose):
    """Tcr for trajectory recovery (Tracking.cc:488-504)."""
    return Tcw @ geo.inv_T(kf_pose)


# ---------------------------------------------------------------------------
# whole-frame device program (frame build + track + keyframe creation)
#
# Every program dispatch and every host pull has a fixed cost. The per-frame
# pipeline is therefore ONE jitted program per sensor — ORB extraction,
# depth, tracking, the keyframe policy AND keyframe creation — carrying a
# small device-resident tracker state. The host never blocks: a puller
# thread drains one packed stats vector per frame and the host state
# machine (LOST handling, local mapping, loop closing) runs a frame or two
# behind, exactly like the reference's mapping/loop threads lag its
# tracking thread (src/System.cc:84-103).
# ---------------------------------------------------------------------------

_obs_counts_jit = jax.jit(ms.point_observation_counts)


_stack_cache = {}


def _stack_outs(outs):
    """Stack per-frame out vectors into one [B, OUT_LEN] array on device
    (one jitted stack per batch size; flush paths produce a few sizes)."""
    n = len(outs)
    fn = _stack_cache.get(n)
    if fn is None:
        fn = jax.jit(lambda *xs: jnp.stack(xs))
        _stack_cache[n] = fn
    return fn(*outs)


_stack_side_cache = {}


def _stack_with_side(outs, sides):
    """Stats batch + side-channel buffers (loop-detection packs) flattened
    into ONE 1D device array = ONE device->host transfer; folding the
    per-keyframe detect-pack pulls into the stats cadence removes a
    transfer per keyframe."""
    key = (len(outs), len(sides), int(sides[0].size))
    fn = _stack_side_cache.get(key)
    if fn is None:
        n_out = len(outs)

        def _impl(*xs):
            o = jnp.stack(xs[:n_out]).reshape(-1)
            return jnp.concatenate(
                [o] + [x.astype(jnp.float32) for x in xs[n_out:]])

        fn = jax.jit(_impl)
        _stack_side_cache[key] = fn
    return fn(*outs, *sides)


class _SideSlot:
    """Future-like handle for a side-channel buffer riding the next
    stats batch."""

    __slots__ = ("_value", "_force")

    def __init__(self, force):
        self._value = None
        self._force = force

    def done(self):
        return self._value is not None

    def result(self):
        if self._value is None:
            self._force()
        return self._value


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnums=(0, 3))
def _mapper_pump(m, n_pts, obs_counts, mp, cfg: SlamConfig):
    """One standalone mapper-machine chunk (drain path — growth,
    compaction, shutdown, host-path keyframes)."""
    return lm.mapper_machine_step(m, n_pts, obs_counts, mp, cfg)


class DeviceTrackState(NamedTuple):
    T_last: jax.Array            # [4,4] last tracked pose
    velocity: jax.Array          # [4,4] constant-velocity model
    have_vel: jax.Array          # scalar bool
    last_assoc: jax.Array        # [N] last frame's point associations
    ref_kf: jax.Array            # scalar int32
    n_kfs: jax.Array             # scalar int32
    n_pts: jax.Array             # scalar int32 point-slot cursor
    last_kf_frame_id: jax.Array  # scalar int32
    obs_counts: jax.Array        # [Pmax] cached per-point observation counts
                                 # (recomputed on KF create / map mutation)
    voc_children: jax.Array      # [Nn,k] i32 BoW tree for node-gated ref-KF
    voc_signed: jax.Array        # [Nn,256] bf16 matching (1-node dummy =
                                 # gate disabled; see bow.gate_arrays)
    mp: lm.MapperMachine         # chunked-mapper machine state (P6);
                                 # idle when cfg.chunked_mapper is False


# packed per-frame output vector layout (appended after stats[N_STATS])
X_KF_SLOT = N_STATS + 0   # created keyframe slot, or -1
X_REF_KF = N_STATS + 1    # reference KF after this frame
X_N_KFS = N_STATS + 2
X_N_PTS = N_STATS + 3
X_TRACKED = N_STATS + 4   # final tracked flag (incl. recent-reloc gate)
X_TCW = N_STATS + 5       # 16 floats
X_TCR = N_STATS + 21      # 16 floats
X_COMPACTED = N_STATS + 37  # 1.0 if the device compacted the point arena
OUT_LEN = N_STATS + 38


def _frame_step_core(m, ds: DeviceTrackState, feats, uright, depth, meta, cfg):
    """Track + keyframe policy + (masked) keyframe creation, all on device.

    meta: [3] f32 = (frame_id, timestamp, frames_since_relocalization).
    Returns (m', ds', out[OUT_LEN]).
    """
    frame_id = meta[0].astype(jnp.int32)
    timestamp = meta[1]
    since_reloc = meta[2].astype(jnp.int32)

    T_pred = jnp.where(
        ds.have_vel, geo.orthonormalize_T(ds.velocity @ ds.T_last), ds.T_last
    )
    m, Tcw, assoc, stats = _track_core(
        m, feats, uright, depth, T_pred, ds.T_last, ds.have_vel,
        ds.last_assoc, ds.ref_kf, frame_id, ds.last_kf_frame_id, ds.n_kfs, cfg,
        obs_counts=ds.obs_counts,
        voc_gate=(ds.voc_children, ds.voc_signed),
        mapper_idle=(ds.mp.phase == 0) if cfg.chunked_mapper else None,
    )
    tracked = stats[S_TRACKED] > 0
    # recently-relocalized frames require the stricter inlier floor
    # (Tracking.cc:967-971)
    reloc_gate = (since_reloc < int(cfg.fps)) & (
        stats[S_N_INL] < C.TRACK_LOCAL_MAP_MIN_INLIERS_RECENT_RELOC
    )
    tracked = tracked & ~reloc_gate
    # no keyframes inside the reloc window once the map is mature
    # (Tracking.cc:1000-1002: mnId < mnLastRelocFrameId + mMaxFrames
    # && nKFs > mMaxFrames)
    kf_reloc_block = (since_reloc < int(cfg.fps)) & (
        ds.n_kfs > int(cfg.fps)
    )

    best_local = stats[S_BEST_LOCAL].astype(jnp.int32)
    coarse_ok = stats[S_COARSE_OK] > 0
    ref1 = jnp.where(coarse_ok & (best_local >= 0), best_local, ds.ref_kf)

    need_kf = (stats[S_NEED_KF] > 0) & tracked & ~kf_reloc_block
    slot = ds.n_kfs

    def _do_create(m_):
        groups = None
        if cfg.chunked_mapper:
            # FeatureVector node ids computed on device at creation (the
            # reference's Frame::ComputeBoW at KF time) — no host backfill,
            # so the ref-KF node gate sees the row deterministically
            groups = bow.group_ids(ds.voc_children, ds.voc_signed,
                                   feats.desc, feats.valid, cfg.voc_levels)
        m2, n_created, row = _create_kf_core(
            m_, slot, ds.n_pts, frame_id, timestamp, Tcw, feats, uright,
            depth, assoc, ref1, cfg, enabled=jnp.asarray(True),
            groups=groups,
        )
        # the KF changed observations -> refresh the cached counts here,
        # inside the rare branch
        return m2, n_created.astype(jnp.int32), row, ms.point_observation_counts(m2)

    def _skip_create(m_):
        return m_, jnp.asarray(0, jnp.int32), assoc, ds.obs_counts

    # real branch, not a mask: keyframes are rare (~1 in 10-30 frames), so
    # skipping the create work pays for the cond on every non-KF frame
    m, n_created, kf_obs_row, obs_counts2 = jax.lax.cond(
        need_kf, _do_create, _skip_create, m
    )
    assoc_after = jnp.where(need_kf, kf_obs_row, assoc)
    ref2 = jnp.where(need_kf, slot, ref1)
    n_pts2 = ds.n_pts + n_created.astype(jnp.int32)

    mp = ds.mp
    la_next = jnp.where(tracked, assoc_after, ds.last_assoc)
    compacted = jnp.asarray(False)
    if cfg.chunked_mapper:
        # a new keyframe preempts the machine (the reference aborts the
        # running local BA and processes the queued KF: mbAbortBA,
        # src/LocalMapping.cc:77-85); then ONE bounded chunk executes this
        # frame — every frame pays at most one chunk (P6 complete)
        mp = mp._replace(
            phase=jnp.where(need_kf, jnp.asarray(1, jnp.int32), mp.phase),
            kf=jnp.where(need_kf, slot, mp.kf),
        )
        m, n_pts2, obs_counts2, mp = lm.mapper_machine_step(
            m, n_pts2, obs_counts2, mp, cfg
        )
        # Point-arena compaction decided and executed ON DEVICE at a
        # machine-idle boundary: slot churn (triangulation burns ~8 slots
        # per survivor) refills the cursor, and the old host-side trigger
        # fired at a scheduling-dependent frame — compaction renumbers
        # slots, which slot-order-sensitive selections (local-map cap, BA
        # window) can see, so a host-timed compaction made real-sequence
        # runs non-reproducible (r4: room ATE varied 6-106mm run to run).
        pmax_ = cfg.max_points
        n_live = jnp.sum(m.pt_valid.astype(jnp.int32))
        need_compact = (
            (mp.phase == 0)
            & (n_pts2 >= int(pmax_ * 0.85))
            & (n_live * 2 < n_pts2)
        )

        def _do_compact(op):
            m_, la_ = op
            m2, n_live2, remap = ms.compact_points(m_)
            la2 = jnp.where(
                la_ >= 0, remap[jnp.clip(la_, 0, pmax_ - 1)], -1)
            return (m2, la2, n_live2.astype(jnp.int32),
                    ms.point_observation_counts(m2))

        def _skip_compact(op):
            m_, la_ = op
            return m_, la_, n_pts2, obs_counts2

        m, la_next, n_pts2, obs_counts2 = jax.lax.cond(
            need_compact, _do_compact, _skip_compact, (m, la_next))
        compacted = need_compact

    ds2 = DeviceTrackState(
        T_last=jnp.where(tracked, Tcw, ds.T_last),
        velocity=jnp.where(
            tracked, geo.orthonormalize_T(Tcw @ geo.inv_T(ds.T_last)), ds.velocity
        ),
        have_vel=tracked,
        last_assoc=la_next,
        ref_kf=ref2,
        n_kfs=ds.n_kfs + need_kf.astype(jnp.int32),
        n_pts=n_pts2,
        last_kf_frame_id=jnp.where(need_kf, frame_id, ds.last_kf_frame_id),
        obs_counts=obs_counts2,
        voc_children=ds.voc_children,
        voc_signed=ds.voc_signed,
        mp=mp,
    )
    kmax = m.kf_pose.shape[0]
    Tcr = Tcw @ geo.inv_T(m.kf_pose[jnp.clip(ref2, 0, kmax - 1)])
    out = jnp.concatenate([
        stats,
        jnp.stack([
            jnp.where(need_kf, slot, -1).astype(jnp.float32),
            ref2.astype(jnp.float32),
            ds2.n_kfs.astype(jnp.float32),
            ds2.n_pts.astype(jnp.float32),
            tracked.astype(jnp.float32),
        ]),
        Tcw.reshape(-1).astype(jnp.float32),
        Tcr.reshape(-1).astype(jnp.float32),
        compacted.astype(jnp.float32)[None],
    ])
    return m, ds2, out


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnums=(0, 1))
def _frame_step_rgbd(m, ds, image, depth_map, meta, cfg: SlamConfig):
    from orb_slam2_comment_tpu.models.frame import undistort_points
    from orb_slam2_comment_tpu.ops import orb, stereo

    # inputs arrive in native sensor dtypes (uint8 gray, uint16 depth) and
    # are cast on device: a quarter (image) or half (depth) of the bytes
    # float32 would move
    image = image.astype(jnp.float32)
    feats, _ = orb._extract_impl(image, cfg.orb, (cfg.height, cfg.width))
    d = stereo.sample_depth_at(depth_map, feats.xy).astype(jnp.float32)
    if cfg.depth_map_factor != 1.0:
        d = d / cfg.depth_map_factor
    uright, depth = stereo.depth_to_uright(feats.xy, d, cfg.bf)
    feats = feats._replace(xy=undistort_points(feats.xy, cfg))
    return _frame_step_core(m, ds, feats, uright, depth, meta, cfg)


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnums=(0, 1))
def _frame_step_stereo(m, ds, image_l, image_r, meta, cfg: SlamConfig):
    from orb_slam2_comment_tpu.models.frame import undistort_points
    from orb_slam2_comment_tpu.ops import orb, stereo

    image_l = image_l.astype(jnp.float32)
    image_r = image_r.astype(jnp.float32)
    feats_l, pyr_l = orb._extract_impl(image_l, cfg.orb, (cfg.height, cfg.width))
    feats_r, pyr_r = orb._extract_impl(image_r, cfg.orb, (cfg.height, cfg.width))
    uright, depth = stereo.stereo_match(
        feats_l, feats_r, pyr_l, pyr_r, tuple(cfg.orb.scales), cfg.bf,
        min_z=cfg.baseline, n_levels=cfg.n_levels,
        th_stereo=min(75.0 * cfg.match_th_scale, 100.0),
    )
    feats_l = feats_l._replace(xy=undistort_points(feats_l.xy, cfg))
    return _frame_step_core(m, ds, feats_l, uright, depth, meta, cfg)


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnums=(0, 1))
def _frame_step_mono(m, ds, image, meta, cfg: SlamConfig):
    from orb_slam2_comment_tpu.models.frame import undistort_points
    from orb_slam2_comment_tpu.ops import orb

    image = image.astype(jnp.float32)
    feats, _ = orb._extract_impl(image, cfg.orb, (cfg.height, cfg.width))
    n = feats.xy.shape[0]
    feats = feats._replace(xy=undistort_points(feats.xy, cfg))
    uright = jnp.full((n,), -1.0)
    depth = jnp.full((n,), -1.0)
    return _frame_step_core(m, ds, feats, uright, depth, meta, cfg)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _extract_stage(image, cfg: SlamConfig):
    """Stage A of the split RGB-D pipeline: feature extraction only.

    Instead of shipping the full depth map (600KB u16), the host can pull
    the keypoint coordinates (8KB), sample the depth map host-side, and
    push just the per-keypoint samples (4KB) to stage B."""
    from orb_slam2_comment_tpu.ops import orb

    image = image.astype(jnp.float32)
    feats, _ = orb._extract_impl(image, cfg.orb, (cfg.height, cfg.width))
    return feats


def _track_stage_rgbd_core(m, ds, feats, depth_input, meta, cfg: SlamConfig):
    """Stage B: depth association + tracking + keyframe policy/creation.

    depth_input is either the FULL depth map [H, W] (sampled on device at
    the keypoint locations — the steady-state path; keeping the map on
    device removes the keypoint-xy device->host pull that used to gate
    every stage-B dispatch) or a pre-sampled [N] vector (host fallback
    paths)."""
    from orb_slam2_comment_tpu.models.frame import undistort_points
    from orb_slam2_comment_tpu.ops import stereo

    if depth_input.ndim == 2:
        h, w = depth_input.shape
        xi = jnp.clip(jnp.round(feats.xy[:, 0]).astype(jnp.int32), 0, w - 1)
        yi = jnp.clip(jnp.round(feats.xy[:, 1]).astype(jnp.int32), 0, h - 1)
        d = depth_input[yi, xi].astype(jnp.float32)
    else:
        d = depth_input.astype(jnp.float32)
    if cfg.depth_map_factor != 1.0:
        d = d / cfg.depth_map_factor
    uright, depth = stereo.depth_to_uright(feats.xy, d, cfg.bf)
    feats = feats._replace(xy=undistort_points(feats.xy, cfg))
    return _frame_step_core(m, ds, feats, uright, depth, meta, cfg)


_track_stage_rgbd = functools.partial(
    jax.jit, static_argnames=("cfg",), donate_argnums=(0, 1)
)(_track_stage_rgbd_core)


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnums=(0, 1))
def _step_and_extract_rgbd(
    m, ds, feats_prev, depth_prev, meta_prev, image_cur,
    cfg: SlamConfig,
):
    """Steady-state fused program: the PREVIOUS frame's stage B and the
    CURRENT frame's extraction in one dispatch: one program per frame
    instead of two."""
    from orb_slam2_comment_tpu.ops import orb

    m, ds, out_prev = _track_stage_rgbd_core(
        m, ds, feats_prev, depth_prev, meta_prev, cfg
    )
    image = image_cur.astype(jnp.float32)
    feats_cur, _ = orb._extract_impl(image, cfg.orb, (cfg.height, cfg.width))
    return m, ds, out_prev, feats_cur


# ---------------------------------------------------------------------------
# host-side tracker
# ---------------------------------------------------------------------------

@dataclass
class TrackOutput:
    state: int
    Tcw: Optional[np.ndarray]
    n_inliers: int
    created_kf: bool
    relative_to_kf: Optional[np.ndarray] = None  # Tcr for trajectory save
    ref_kf: int = -1


class LazyTrackOutput:
    """Handle returned by the async fused pipeline. Field access forces
    resolution of the frame's device stats (a host sync) — readers that
    only need throughput never touch the fields and never block."""

    __slots__ = ("_trk", "_fid")

    def __init__(self, trk, fid):
        self._trk = trk
        self._fid = fid

    def _get(self) -> TrackOutput:
        self._trk._flush_upto(self._fid)
        out = self._trk._resolved.get(self._fid)
        if out is None:  # resolved earlier and trimmed; synthesize from state
            t = self._trk
            return TrackOutput(t.state, t.last_Tcw, t.n_last_inliers, False,
                               ref_kf=t.ref_kf)
        return out

    @property
    def state(self):
        return self._get().state

    @property
    def Tcw(self):
        return self._get().Tcw

    @property
    def n_inliers(self):
        return self._get().n_inliers

    @property
    def created_kf(self):
        return self._get().created_kf

    @property
    def relative_to_kf(self):
        return self._get().relative_to_kf

    @property
    def ref_kf(self):
        return self._get().ref_kf


class Tracker:
    """Host orchestrator owning the map and the tracking state machine."""


    @property
    def STAGE_A_LAG(self):
        """Stage-A pipeline depth (cfg.pipeline_lag): how many frames the
        keypoint-xy pull has to reach the host before the host needs it
        for depth sampling."""
        return self.cfg.pipeline_lag

    def __init__(self, cfg: SlamConfig):
        self.cfg = cfg
        self.map = ms.empty_map(cfg.max_keyframes, cfg.max_points, self._n_slots())
        self.n_kfs = 0
        # the point-slot cursor lives on device so keyframe creation and
        # mapping never force a host sync
        self.n_pts_dev = jnp.asarray(0, jnp.int32)
        self.state = NO_IMAGES_YET
        self.velocity: Optional[np.ndarray] = None
        self.last_Tcw: Optional[np.ndarray] = None
        self.last_frame: Optional[Frame] = None
        self.ref_kf = -1
        self.last_kf_frame_id = -1
        self.last_reloc_frame_id = -(1 << 30)
        self.new_kf_callbacks = []   # local-mapping hook
        self.grow_callbacks = []     # capacity-tier hook (set by System)
        self.compact_callbacks = []  # point-arena compaction hook
        self.n_pts_host = 0          # host mirror, refreshed on KF events
        self.reloc_fn = None         # relocalization hook (set by System)
        # BoW node-gate tree (1-node dummy until a vocabulary is wired by
        # System.set_vocabulary_gate; dummy => gate is a no-op)
        self._voc_gate = bow.gate_arrays(None)
        self.n_last_inliers = 0
        self.compaction_epoch = 0    # bumps on ANY point-arena compaction
                                     # (host or device); consumers holding
                                     # point ids outside the map (background
                                     # GBA snapshot) must check it
        self._next_compact_kfs = 0   # top-tier compaction rate limit
        self._top_tier_warned = False
        self.vo = False              # mbVO: tracking on temporal VO points
                                     # (localization-only, Tracking.cc:333)
        self.trajectory = []         # (timestamp, Tcr, ref_kf, state)
        self.kf_ts_host = np.zeros(cfg.max_keyframes, np.float64)
        # async fused-pipeline state
        self.ds: Optional[DeviceTrackState] = None
        # Upload-lag queue: each entry is (dispatch_fn, args) for a frame
        # whose input arrays have been enqueued for host->device transfer
        # but whose device program has not been dispatched yet. Keeping one
        # frame queued means program_i consumes the image uploaded during
        # call i-1, so the upload of frame i overlaps the device program of
        # frame i-1 instead of serializing with it (a program cannot start
        # before its input lands).
        self._upQ = collections.deque()
        self._stageA = collections.deque()    # (frame_id, ts, feats, depth_map)
        self._pending = collections.deque()   # (frame_id, ts, out_array)
        self._batchQ = collections.deque()    # (entries, fut, side_slots, meta)
        self._sideQ = collections.deque()     # (flat_dev_array, shape, slot)
        self._resolved = {}                   # frame_id -> TrackOutput
        # Pull POOL: each device->host read is a round trip. Stats are
        # therefore pulled in BATCHES: every STATS_BATCH frames the packed
        # out vectors are stacked by one tiny device program and shipped
        # as a single transfer — 1/STATS_BATCH the transactions of a
        # one-pull-per-frame pool.
        self._io_pool = concurrent.futures.ThreadPoolExecutor(max_workers=6)

    # frames per stats pull; the resolution lag stays well inside
    # MAX_BATCHES
    STATS_BATCH = int(__import__("os").environ.get("STATS_BATCH", "16"))
    # Force-resolve beyond this many in-flight batches. Deep enough that
    # the host never blocks while the device still has queued work: a
    # blocking resolve with an empty device queue idles the device for a
    # full round trip. (3 x STATS_BATCH bounds the host's view of
    # keyframe events at ~48 frames of lag.)
    MAX_BATCHES = 6

    # -- async plumbing ------------------------------------------------------
    def _enqueue_out(self, fid, ts, out):
        self._pending.append((fid, ts, out))
        if len(self._pending) >= self.STATS_BATCH:
            self._ship_batch()

    SIDE_SLOTS = 2

    def enqueue_side(self, flat_dev, shape):
        """Attach a device buffer to the NEXT stats batch transfer; the
        returned slot resolves when that batch lands (used by the loop
        closer's detect packs — one transfer instead of one per
        keyframe)."""
        slot = _SideSlot(self._force_side)
        self._sideQ.append((flat_dev, shape, slot))
        return slot

    def _force_side(self):
        self._flush_upto(1 << 60)
        # a side buffer enqueued with no pending frames ships empty-stats
        while self._sideQ:
            a, shp, slot = self._sideQ.popleft()
            slot._value = np.asarray(a).reshape(shp)

    def _ship_batch(self):
        if not self._pending:
            return
        entries = list(self._pending)
        self._pending.clear()
        outs = [e[2] for e in entries]
        # pad partial batches to the fixed size: ONE compiled stack
        # program total (each distinct size would pay a compile on
        # the flush path); _resolve_batch zips against entries, so the
        # padding rows are never read
        while len(outs) < self.STATS_BATCH:
            outs.append(outs[-1])
        side_slots = []
        sides = []
        while self._sideQ and len(sides) < self.SIDE_SLOTS:
            a, shp, slot = self._sideQ.popleft()
            if sides and a.size != sides[0].size:
                self._sideQ.appendleft((a, shp, slot))
                break
            sides.append(a)
            side_slots.append((shp, slot))
        if sides:
            n_real = len(sides)
            while len(sides) < self.SIDE_SLOTS:
                sides.append(sides[-1])
            stacked = _stack_with_side(outs, sides)
            meta = (len(outs), int(outs[0].shape[0]), int(sides[0].size),
                    n_real)
        else:
            stacked = _stack_outs(outs)
            meta = None
        fut = self._io_pool.submit(np.asarray, stacked)
        self._batchQ.append((entries, fut, side_slots, meta))

    def _resolve_batch(self, entries, fut, side_slots=(), meta=None):
        arr = fut.result()  # re-raises worker exceptions
        if meta is not None:
            B, out_len, S, n_real = meta
            stats = arr[: B * out_len].reshape(B, out_len)
            for i, (shp, slot) in enumerate(side_slots[:n_real]):
                off = B * out_len + i * S
                slot._value = arr[off: off + S].reshape(shp)
        else:
            stats = arr
        for (fid, ts, _), row in zip(entries, stats):
            self._resolve_entry(fid, ts, row)

    def _flush_ready(self, max_batches: Optional[int] = None):
        """Resolve shipped batches whose transfers have landed;
        force-resolve (blocking) when too many are in flight."""
        if max_batches is None:
            max_batches = self.MAX_BATCHES
        while self._batchQ:
            entries, fut, side_slots, meta = self._batchQ[0]
            if not fut.done() and len(self._batchQ) <= max_batches:
                break
            self._batchQ.popleft()
            self._resolve_batch(entries, fut, side_slots, meta)

    def _drain_upload(self, n_keep: int = 0):
        """Dispatch queued-upload frames until at most n_keep remain."""
        while len(self._upQ) > n_keep:
            fn, args = self._upQ.popleft()
            fn(*args)

    def _flush_upto(self, fid: int):
        self._drain_upload(0)
        while self._stageA and self._stageA[0][0] <= fid:
            self._finish_stageA_front()
        if self._pending and self._pending[0][0] <= fid:
            self._ship_batch()
        while self._batchQ and self._batchQ[0][0] and (
                self._batchQ[0][0][0][0] <= fid):
            entries, fut, side_slots, meta = self._batchQ.popleft()
            self._resolve_batch(entries, fut, side_slots, meta)

    def _flush_all(self):
        self._flush_upto(1 << 60)
        self._drain_mapper()

    def _drain_mapper(self, known_phase: Optional[int] = None):
        """Pump the chunked mapper machine to idle with standalone chunk
        programs — the reference's LocalMapping drain before shutdown,
        growth, compaction, loop correction, or a host-path transition
        (System::Shutdown spin, src/System.cc:301-320)."""
        if self.ds is None or not self.cfg.chunked_mapper:
            return
        if known_phase is None:
            # don't pull the phase: int(mp.phase) blocks behind the whole
            # queued program stream (a stall at drain time) while
            # pumping a full pass unconditionally costs ~12 no-op-cheap
            # dispatches when the machine is already idle
            p = 1
        else:
            p = known_phase
        if p <= 0:
            return
        n_total = lm.machine_phase_count(self.cfg)
        for _ in range(n_total - p + 1):
            m2, n2, oc2, mp2 = _mapper_pump(
                self.map, self.ds.n_pts, self.ds.obs_counts, self.ds.mp,
                self.cfg,
            )
            self.map = m2
            self.ds = self.ds._replace(n_pts=n2, obs_counts=oc2, mp=mp2)
        self.n_pts_dev = self.ds.n_pts

    def _resolve_entry(self, fid: int, ts: float, s: np.ndarray):
        """Host state-machine update from one frame's packed stats —
        the lagged equivalent of the reference's per-frame bookkeeping
        (Tracking.cc:423-504)."""
        tracked = s[X_TRACKED] > 0
        Tcw = s[X_TCW:X_TCW + 16].reshape(4, 4).copy()
        Tcr = s[X_TCR:X_TCR + 16].reshape(4, 4).copy()
        self.n_kfs = int(s[X_N_KFS])
        ref = int(s[X_REF_KF])
        self.ref_kf = ref
        self.n_last_inliers = int(s[S_N_INL])
        kf_slot = int(s[X_KF_SLOT])
        self.n_pts_host = int(s[X_N_PTS])
        if len(s) > X_COMPACTED and s[X_COMPACTED] > 0:
            self.compaction_epoch += 1
            for cb in self.compact_callbacks:
                cb()
        if tracked:
            self.state = OK
            self.last_Tcw = Tcw
            self.trajectory.append((ts, Tcr, ref, OK))
        else:
            self.state = LOST
            self.velocity = None
        if kf_slot >= 0:
            import os
            import time as _t
            prof = os.environ.get("KF_PROF", "") not in ("", "0")
            block = os.environ.get("KF_PROF_BLOCK", "") not in ("", "0")
            t0 = _t.perf_counter()
            self.kf_ts_host[kf_slot] = ts
            self.last_kf_frame_id = fid
            self.n_pts_dev = self.ds.n_pts
            if block:
                import jax as _jax
                _jax.block_until_ready(self.map.kf_pose)
                print(f"# kf_prof pre-cb device drain "
                      f"+{(_t.perf_counter()-t0)*1e3:.1f}ms", flush=True)
            for cb in self.new_kf_callbacks:
                cb(kf_slot)
                if block:
                    import jax as _jax
                    _jax.block_until_ready(self.map.kf_pose)
                if prof:
                    print(f"# kf_prof cb={getattr(cb, '__qualname__', cb)} "
                          f"+{(_t.perf_counter()-t0)*1e3:.1f}ms", flush=True)
            if self.ds is not None and not self.cfg.chunked_mapper:
                # local mapping may have advanced the point cursor and
                # changed observations -> refresh the cached obs counts
                # (chunked mode: the device machine owns both)
                self.ds = self.ds._replace(
                    n_pts=jnp.asarray(self.n_pts_dev, jnp.int32)
                    if np.isscalar(self.n_pts_dev)
                    else self.n_pts_dev,
                    obs_counts=_obs_counts_jit(self.map),
                )
        out = TrackOutput(
            state=self.state,
            Tcw=Tcw if tracked else None,
            n_inliers=self.n_last_inliers,
            created_kf=kf_slot >= 0,
            relative_to_kf=Tcr if tracked else None,
            ref_kf=ref,
        )
        self._resolved[fid] = out
        if len(self._resolved) > 32:
            for k in sorted(self._resolved)[:-16]:
                del self._resolved[k]

    def _sync_ds_from_host(self, frame: Frame):
        """Rebuild the device tracker state after a host-path transition
        (initialization, staged retry, relocalization)."""
        vel = self.velocity if self.velocity is not None else np.eye(4)
        # jnp.array (copy=True) rather than jnp.asarray: the ds is donated
        # to the fused step kernels, and aliasing frame.Tcw / frame.assoc /
        # self.velocity here would delete the buffers the host-side
        # last_frame / last_Tcw / velocity still reference when tracking
        # later falls back to the host path (e.g. localization-only mode).
        self.ds = DeviceTrackState(
            T_last=jnp.array(frame.Tcw, jnp.float32).reshape(4, 4),
            velocity=jnp.array(vel, jnp.float32).reshape(4, 4),
            have_vel=jnp.asarray(self.velocity is not None),
            last_assoc=jnp.array(frame.assoc, jnp.int32),
            ref_kf=jnp.asarray(self.ref_kf, jnp.int32),
            n_kfs=jnp.asarray(self.n_kfs, jnp.int32),
            n_pts=jnp.asarray(self.n_pts_dev, jnp.int32)
            if np.isscalar(self.n_pts_dev) else self.n_pts_dev.astype(jnp.int32),
            last_kf_frame_id=jnp.asarray(self.last_kf_frame_id, jnp.int32),
            obs_counts=_obs_counts_jit(self.map),
            # copies: ds is donated every step; self._voc_gate must survive
            # for the next sync / the staged path's frame_groups
            voc_children=jnp.array(self._voc_gate[0], copy=True),
            voc_signed=jnp.array(self._voc_gate[1], copy=True),
            # fresh idle machine: host-path transitions either drained the
            # machine (_drain_mapper) or just created the map (init)
            mp=lm.empty_machine(self.cfg, self._n_slots()),
        )

    def set_vocabulary_gate(self, voc):
        """Wire a vocabulary into the BoW node gate (called by System once
        the vocabulary exists; updates the live device state too)."""
        self._voc_gate = bow.gate_arrays(voc)
        if self.ds is not None:
            self.ds = self.ds._replace(
                voc_children=jnp.array(self._voc_gate[0], copy=True),
                voc_signed=jnp.array(self._voc_gate[1], copy=True),
            )

    def set_kf_erasable(self, kf_id: int):
        """Release a keyframe to KeyFrameCulling (KeyFrame::SetErase,
        src/KeyFrame.h:101-103): called once the loop closer has harvested
        (or skipped) the KF's detection. Host-side map write; in-flight
        cull chunks at worst keep the KF protected a few frames longer."""
        self.map = self.map._replace(
            kf_no_erase=self.map.kf_no_erase.at[kf_id].set(False)
        )

    def set_kf_groups(self, kf_id: int, groups):
        """Backfill a keyframe's FeatureVector node ids (host write after
        KeyFrameDatabase.add; until it lands the KF's all -1 row keeps the
        ref-KF match ungated — the prior behavior)."""
        self.map = self.map._replace(
            kf_group=self.map.kf_group.at[kf_id].set(jnp.asarray(groups))
        )

    def frame_groups(self, feats):
        """Current frame's FeatureVector node ids under the active gate."""
        return bow.group_ids(self._voc_gate[0], self._voc_gate[1],
                             feats.desc, feats.valid, self.cfg.voc_levels)

    # -- fused async entry points -------------------------------------------
    def _fused_ok(self):
        # localization-only runs the host path: the VO fallback needs the
        # previous frame's features/depth, which the fused pipeline does
        # not retain host-side
        return (
            self.cfg.fused_tracking
            and self.state == OK
            and self.ds is not None
            and not self.cfg.localization_only
        )

    def _dispatch_fused(self, step_fn, frame_id, ts, *arrays):
        self._upQ.append(
            (self._dispatch_fused_now, (step_fn, frame_id, ts) + arrays)
        )
        self._drain_upload(n_keep=1)
        return LazyTrackOutput(self, frame_id)

    def _dispatch_fused_now(self, step_fn, frame_id, ts, *arrays):
        meta = jnp.asarray(
            np.asarray(
                [frame_id, ts, frame_id - self.last_reloc_frame_id], np.float32
            )
        )
        self.map, self.ds, out = step_fn(
            self.map, self.ds, *arrays, meta, self.cfg
        )
        self.n_pts_dev = self.ds.n_pts
        self._enqueue_out(frame_id, ts, out)

    def _finish_stageA_front(self):
        """Flush path: pull stage-A keypoints, sample the host depth map,
        dispatch a standalone stage B."""
        fid, ts, feats, depth_map = self._stageA.popleft()
        meta = jnp.asarray(
            np.asarray([fid, ts, fid - self.last_reloc_frame_id], np.float32)
        )
        self.map, self.ds, out = _track_stage_rgbd(
            self.map, self.ds, feats, depth_map, meta, self.cfg
        )
        self.n_pts_dev = self.ds.n_pts
        self._enqueue_out(fid, ts, out)

    def _dispatch_rgbd_upload(self, fid, ts, img, depth_map):
        """Dispatch one RGB-D frame whose image upload was enqueued a call
        earlier: frame fid's extraction fused with the tracking stage of
        the stage-A head (fid-STAGE_A_LAG), whose keypoint pull (issued at
        its dispatch) has had STAGE_A_LAG frame-times to reach the host,
        so the host rarely blocks; B stages still run
        strictly in frame order, so tracking semantics are identical to
        the reference's one-frame chain."""
        if len(self._stageA) >= self.STAGE_A_LAG:
            fid0, ts0, feats0, dm0 = self._stageA.popleft()
            meta0 = jnp.asarray(
                np.asarray(
                    [fid0, ts0, fid0 - self.last_reloc_frame_id],
                    np.float32,
                )
            )
            self.map, self.ds, out0, feats = _step_and_extract_rgbd(
                self.map, self.ds, feats0, dm0, meta0,
                img, self.cfg,
            )
            self.n_pts_dev = self.ds.n_pts
            self._enqueue_out(fid0, ts0, out0)
        else:
            feats = _extract_stage(img, self.cfg)
        # depth rides to the device with the image; stage B samples it
        # there (no host keypoint pull on the critical path)
        self._stageA.append((fid, ts, feats, jnp.asarray(depth_map)))

    def _maybe_grow(self):
        """Grow the map to the next capacity tier when ~85% full (checked
        against host mirrors only — no device sync in the hot loop; the
        point mirror is refreshed on every KF event, and points are only
        created on KF events). Growth drains the pipeline, pads every map
        array (ms.grow_map), and recompiles the jitted kernels once at the
        new shapes. cfg is swapped wholesale since capacities ride in it
        as static args; System propagates the new cfg via grow_callbacks.
        """
        cfg = self.cfg
        if not cfg.grow_capacity:
            return
        kmax, pmax = cfg.max_keyframes, cfg.max_points
        need_k = (self.n_kfs >= int(kmax * 0.85)) and (
            kmax < cfg.max_keyframes_cap)
        cursor_full = self.n_pts_host >= int(pmax * 0.85)
        if not (need_k or cursor_full):
            return
        dev_compacts = (cfg.chunked_mapper and cfg.fused_tracking
                        and self.ds is not None)
        if cursor_full and not need_k and not dev_compacts:
            # the cursor, not the live count, is what filled up: slot
            # churn (triangulation creates ~8 slots per survivor). If the
            # LIVE population still fits comfortably, compact the arena
            # instead of growing — same capacity, no recompile, bounded
            # total slots for arbitrarily long runs. (Chunked mode
            # compacts ON DEVICE at machine-idle boundaries instead —
            # deterministic position; see _frame_step_core.)
            self._flush_all()
            n_live = int(jnp.sum(self.map.pt_valid))
            if n_live < int(pmax * 0.5):
                self._compact_points()
                return
        need_p = cursor_full and (pmax < cfg.max_points_cap)
        if not (need_k or need_p):
            # cursor full and already at the top tier. Compaction only
            # helps when there are dead slots to reclaim: at high live
            # occupancy each trigger pays a full pipeline drain plus the
            # compaction program and the cursor refills within a few
            # keyframes — a repeating stall loop. Hysteresis: >=15%
            # reclaimable, and >=4 KFs since the previous attempt.
            if self.n_kfs < self._next_compact_kfs:
                return
            self._next_compact_kfs = self.n_kfs + 4
            self._flush_all()
            n_live = int(jnp.sum(self.map.pt_valid))
            if n_live >= int(pmax * 0.85):
                if not self._top_tier_warned:
                    print(f"[tracker] WARNING: point arena at top tier with "
                          f"{n_live}/{pmax} live; point creation degrades "
                          f"until culling frees slots")
                    self._top_tier_warned = True
                return
            print(f"[tracker] point arena at top tier "
                  f"(cursor {self.n_pts_host}/{pmax}); compacting")
            self._compact_points()
            return
        new_k = min(kmax * 4, cfg.max_keyframes_cap) if need_k else kmax
        new_p = min(pmax * 4, cfg.max_points_cap) if need_p else pmax
        self._flush_all()
        self.map = ms.grow_map(self.map, new_k, new_p)
        self.kf_ts_host = np.concatenate(
            [self.kf_ts_host, np.zeros(new_k - kmax, np.float64)])
        self.cfg = dataclasses.replace(
            cfg, max_keyframes=new_k, max_points=new_p)
        if self.ds is not None:
            # the machine is idle (the _flush_all above drained it); its
            # window capacities can change with the tier -> rebuild
            self.ds = self.ds._replace(
                obs_counts=_obs_counts_jit(self.map),
                mp=lm.empty_machine(self.cfg, self._n_slots()),
            )
        for cb in self.grow_callbacks:
            cb(self.cfg)

    def _compact_points(self):
        """Compact the point arena (ms.compact_points) and remap every
        point id held outside the map. Call only with the pipeline
        drained."""
        for cb in self.compact_callbacks:
            cb()  # e.g. abort background GBA whose snapshot holds old ids
        m2, n_live, remap = ms.compact_points(self.map)
        self.map = m2
        self.compaction_epoch += 1
        n_live_i = int(n_live)
        print(f"[tracker] compacted point arena: cursor "
              f"{self.n_pts_host} -> {n_live_i} live slots")
        self.n_pts_dev = jnp.asarray(n_live_i, jnp.int32)
        self.n_pts_host = n_live_i
        if self.ds is not None:
            la = self.ds.last_assoc
            pmax = self.map.pt_pos.shape[0]
            la2 = jnp.where(la >= 0, remap[jnp.clip(la, 0, pmax - 1)], -1)
            self.ds = self.ds._replace(
                last_assoc=la2,
                n_pts=jnp.asarray(n_live_i, jnp.int32),
                obs_counts=_obs_counts_jit(self.map),
            )
        if self.last_frame is not None and getattr(self.last_frame, "assoc", None) is not None:
            a = np.asarray(self.last_frame.assoc)
            rm = np.asarray(remap)
            self.last_frame.assoc = jnp.asarray(
                np.where(a >= 0, rm[np.clip(a, 0, len(rm) - 1)], -1))

    def track_rgbd_arrays(self, frame_id, ts, image, depth_map):
        # KF_PROF wraps the ONE production path with timestamps instead of
        # duplicating the dispatch sequence (profiled runs must measure
        # shipped behavior)
        import os as _os
        import time as _t
        prof = _os.environ.get("KF_PROF", "") not in ("", "0")
        t0 = _t.perf_counter() if prof else 0.0
        self._maybe_grow()
        t1 = _t.perf_counter() if prof else 0.0
        self._flush_ready()
        t2 = _t.perf_counter() if prof else 0.0
        if self._fused_ok():
            # steady state: ONE device program per frame, dispatched one
            # call late so the image upload overlaps the previous frame's
            # program (see _upQ comment in __init__)
            self._upQ.append(
                (self._dispatch_rgbd_upload,
                 (frame_id, ts, jnp.asarray(image), depth_map))
            )
            self._drain_upload(n_keep=1)
            if prof:
                t3 = _t.perf_counter()
                if t3 - t0 > 0.05:
                    print(f"# track_prof fid={frame_id} grow={(t1-t0)*1e3:.0f} "
                          f"flush={(t2-t1)*1e3:.0f} upload={(t3-t2)*1e3:.0f}",
                          flush=True)
            return LazyTrackOutput(self, frame_id)
        from orb_slam2_comment_tpu.models import frame as fr

        self._flush_all()
        return self.track(
            fr.build_frame_rgbd(frame_id, ts, image, depth_map, self.cfg)
        )

    def track_stereo_arrays(self, frame_id, ts, image_l, image_r):
        self._maybe_grow()
        self._flush_ready()
        if self._fused_ok():
            return self._dispatch_fused(
                _frame_step_stereo, frame_id, ts,
                jnp.asarray(image_l),
                jnp.asarray(image_r),
            )
        from orb_slam2_comment_tpu.models import frame as fr

        self._flush_all()
        return self.track(
            fr.build_frame_stereo(frame_id, ts, image_l, image_r, self.cfg)
        )

    def track_mono_arrays(self, frame_id, ts, image):
        self._maybe_grow()
        self._flush_ready()
        if self._fused_ok():
            return self._dispatch_fused(
                _frame_step_mono, frame_id, ts, jnp.asarray(image)
            )
        from orb_slam2_comment_tpu.models import frame as fr

        self._flush_all()
        return self.track(fr.build_frame_mono(frame_id, ts, image, self.cfg))

    def _n_slots(self):
        budgets = self.cfg.orb.level_budgets()
        return sum(budgets)

    @property
    def n_pts(self) -> int:
        """Host view of the device point counter (forces a sync; for
        inspection/tests, not the hot loop)."""
        return int(self.n_pts_dev)

    @n_pts.setter
    def n_pts(self, v):
        self.n_pts_dev = jnp.asarray(v, jnp.int32)

    # -- public API --------------------------------------------------------
    def track(self, frame: Frame) -> TrackOutput:
        self._flush_all()
        out = self._track_host(frame)
        # record trajectory (Tracking.cc:488-504); fused frames record at
        # resolve time instead
        if out.Tcw is not None and out.relative_to_kf is not None:
            self.trajectory.append(
                (frame.timestamp, np.asarray(out.relative_to_kf), out.ref_kf,
                 out.state)
            )
        elif out.Tcw is not None:
            self.trajectory.append(
                (frame.timestamp, np.eye(4), out.ref_kf, out.state)
            )
        if self.state == OK and self.cfg.fused_tracking:
            self._sync_ds_from_host(frame)
            if out.created_kf and self.cfg.chunked_mapper:
                # host-path keyframes (initialization, post-reloc) run the
                # machine to completion synchronously — the monolithic
                # path's semantics at a deterministic position
                self.ds = self.ds._replace(mp=self.ds.mp._replace(
                    phase=jnp.asarray(1, jnp.int32),
                    kf=jnp.asarray(self.ref_kf, jnp.int32)))
                self._drain_mapper(known_phase=1)
        return out

    def _track_host(self, frame: Frame) -> TrackOutput:
        cfg = self.cfg
        if self.state in (NO_IMAGES_YET, NOT_INITIALIZED):
            if cfg.sensor == MONOCULAR:
                # MonocularInitialization (src/Tracking.cc:563-737)
                if not hasattr(self, "mono_init") or self.mono_init is None:
                    from orb_slam2_comment_tpu.models.initializer import (
                        MonocularInitializer,
                    )

                    self.mono_init = MonocularInitializer(cfg)
                ok = self.mono_init.try_initialize(self, frame)
            else:
                ok = self._stereo_initialization(frame)
            self.state = OK if ok else NOT_INITIALIZED
            return TrackOutput(
                state=self.state,
                Tcw=np.asarray(frame.Tcw) if ok else None,
                n_inliers=0,
                created_kf=ok,
                ref_kf=self.ref_kf,
            )

        created_kf = False
        n_inliers = 0
        tracked = False
        stats = None
        if self.state == OK and not cfg.fused_tracking:
            # staged mode: the reference's exact fallback ladder with host
            # branch decisions (more device syncs; slightly more robust on
            # marginal frames because each stage re-decides from concrete
            # counts)
            tracked, n_inliers = self._staged_retry(frame)
        elif self.state == OK:
            T_last = jnp.asarray(self.last_Tcw)
            have_vel = self.velocity is not None
            T_pred = (
                _apply_velocity(self.velocity, T_last) if have_vel else T_last
            )
            self.map, Tcw, assoc, stats = _track_frame_fused(
                self.map,
                frame.feats,
                frame.uright,
                frame.depth,
                T_pred,
                T_last,
                jnp.asarray(have_vel),
                self.last_frame.assoc,
                jnp.asarray(self.ref_kf, jnp.int32),
                jnp.asarray(frame.frame_id, jnp.int32),
                jnp.asarray(self.last_kf_frame_id, jnp.int32),
                jnp.asarray(self.n_kfs, jnp.int32),
                cfg,
                voc_gate=self._voc_gate,
            )
            stats = np.asarray(stats)  # the single per-frame device pull
            tracked = stats[S_TRACKED] > 0
            n_inliers = int(stats[S_N_INL])
            # recently-relocalized frames require the stricter inlier floor;
            # the window is FRAME-ID based like the reference's
            # mnLastRelocFrameId + mMaxFrames (Tracking.cc:967-971)
            if (
                tracked
                and frame.frame_id - self.last_reloc_frame_id < cfg.fps
                and n_inliers < C.TRACK_LOCAL_MAP_MIN_INLIERS_RECENT_RELOC
            ):
                tracked = False
            if tracked:
                frame.Tcw = Tcw
                frame.assoc = assoc
            if stats[S_COARSE_OK] > 0:
                # the reference updates its reference KF inside
                # TrackLocalMap, before the final inlier gate
                best_local = int(stats[S_BEST_LOCAL])
                if best_local >= 0:
                    self.ref_kf = best_local
        if not tracked and self.state == OK and cfg.fused_tracking:
            # Redundant staged retry: the fused kernel trades a few
            # inliers for its single-dispatch structure; on marginal
            # frames re-run the coarse+local chain with host-side branch
            # decisions before declaring the frame lost (costs a handful
            # of device pulls, only on weak frames).
            tracked, n_inliers = self._staged_retry(frame)
            if tracked:
                stats = None
        vo_frame = False
        if not tracked and self.reloc_fn is not None:
            # Relocalization (Tracking.cc:436-448 -> Relocalization:1341).
            # In localization-only VO mode this runs every frame and is
            # preferred over the odometry solution (Tracking.cc:352-390).
            ok, Tcw_r, assoc_r = self.reloc_fn(frame)
            if ok:
                frame.Tcw = Tcw_r
                frame.assoc = assoc_r
                self.velocity = None
                self.last_reloc_frame_id = frame.frame_id
                self.last_Tcw = Tcw_r
                n_inliers = self._track_local_map(frame)
                tracked = n_inliers >= C.TRACK_LOCAL_MAP_MIN_INLIERS
                stats = None
        if (
            not tracked
            and cfg.localization_only
            and self.state == OK
            and cfg.sensor != MONOCULAR
            and self.last_frame is not None
            and self.last_Tcw is not None
            and self.last_frame.Tcw is not None
        ):
            # mbVO branch: off the map, keep odometry going against the
            # previous frame's depth points (Tracking.cc:333-391, temporal
            # points from UpdateLastFrame :801-865). Mono has no depth to
            # back VO points, as in the reference.
            #
            # Backproject through the stored pose of last_frame itself, not
            # self.last_Tcw: in fused/async mode last_frame is only updated
            # on host-path frames, so right after a mode switch it can be
            # older than last_Tcw — its depth must be lifted with the pose
            # it was tracked at.
            T_last = jnp.asarray(self.last_frame.Tcw)
            T_pred = (
                _apply_velocity(self.velocity, jnp.asarray(self.last_Tcw))
                if self.velocity is not None else jnp.asarray(self.last_Tcw)
            )
            Tcw_vo, ninl_vo = _track_vo_frame(
                self.last_frame.feats, self.last_frame.depth,
                self.last_frame.uright, T_last, T_pred,
                frame.feats, frame.uright, cfg,
            )
            if int(ninl_vo) >= 10:
                frame.Tcw = Tcw_vo
                frame.assoc = jnp.full((frame.n_feat,), -1, jnp.int32)
                n_inliers = int(ninl_vo)
                tracked = True
                vo_frame = True
                stats = None
        if not tracked:
            self.state = LOST
            return TrackOutput(LOST, None, 0, False, ref_kf=self.ref_kf)

        self.vo = vo_frame
        self.state = OK
        # motion model update (Tracking.cc:423-434), device-resident
        if self.last_Tcw is not None:
            self.velocity = _compose_velocity(
                frame.Tcw, jnp.asarray(self.last_Tcw)
            )
        self.last_Tcw = frame.Tcw
        self.last_frame = frame
        self.n_last_inliers = n_inliers

        need_kf = (
            stats is not None
            and stats[S_NEED_KF] > 0
            and self.n_kfs < cfg.max_keyframes - 1
        )
        if stats is None and not cfg.localization_only:
            # post-relocalization frame: fall back to the host-side policy
            need_kf = self._need_new_keyframe(frame, n_inliers)
        if need_kf:
            self._create_keyframe(frame)
            created_kf = True

        # Tcr stays on device; System batches the pull at save time
        Tcr = _relative_to_kf(frame.Tcw, self.map.kf_pose[self.ref_kf])
        return TrackOutput(
            state=self.state,
            Tcw=frame.Tcw,
            n_inliers=n_inliers,
            created_kf=created_kf,
            relative_to_kf=Tcr,
            ref_kf=self.ref_kf,
        )

    # -- stages -------------------------------------------------------------
    def _stereo_initialization(self, frame: Frame) -> bool:
        """Tracking::StereoInitialization (src/Tracking.cc:509-561):
        requires >=500 features; pose = identity; every positive-depth
        feature becomes a map point."""
        n_valid = int(jnp.sum(frame.feats.valid))
        if n_valid < 500:
            return False
        frame.Tcw = jnp.eye(4)
        assoc = jnp.full((frame.n_feat,), -1, jnp.int32)
        self.map, n_created, kf_obs_row = _create_keyframe_kernel(
            self.map,
            jnp.asarray(0, jnp.int32),
            jnp.asarray(0, jnp.int32),
            jnp.asarray(frame.frame_id, jnp.int32),
            jnp.asarray(frame.timestamp, jnp.float32),
            frame.Tcw,
            frame.feats,
            frame.uright,
            frame.depth,
            assoc,
            jnp.asarray(-1, jnp.int32),
            self.cfg,
            max_new=self._n_slots(),
            create_all_depth=True,
        )
        self.n_kfs = 1
        self.n_pts_dev = n_created.astype(jnp.int32)
        frame.assoc = kf_obs_row
        self.ref_kf = 0
        self.last_kf_frame_id = frame.frame_id
        self.kf_ts_host[0] = frame.timestamp
        self.last_Tcw = np.eye(4, dtype=np.float32)
        self.last_frame = frame
        for cb in self.new_kf_callbacks:
            cb(0)
        return self.n_pts > 0

    def _staged_retry(self, frame: Frame):
        """Per-stage tracking with host branch decisions (the reference's
        exact fallback ladder, Tracking.cc:300-345) — used when the fused
        kernel reports a weak frame."""
        cfg = self.cfg
        ok = False
        if self.velocity is not None:
            T_pred = _apply_velocity(self.velocity, jnp.asarray(self.last_Tcw))
            th = 7.0 if cfg.sensor != MONOCULAR else 15.0
            assoc, nm, _ = _match_against_points(
                self.map, self.last_frame.assoc, T_pred, frame.feats,
                frame.uright, jnp.asarray(th), cfg, use_frustum_band=False,
            )
            if int(nm) < C.TRACK_MOTION_MIN_MATCHES:
                assoc, nm, _ = _match_against_points(
                    self.map, self.last_frame.assoc, T_pred, frame.feats,
                    frame.uright, jnp.asarray(2 * th), cfg,
                    use_frustum_band=False,
                )
            if int(nm) >= C.TRACK_MOTION_MIN_MATCHES:
                Tcw, assoc, ninl = _pose_opt_from_assoc(
                    self.map, T_pred, frame.feats, frame.uright, assoc, cfg
                )
                if int(ninl) >= 10:
                    frame.Tcw = Tcw
                    frame.assoc = assoc
                    ok = True
        if not ok and self.ref_kf >= 0:
            assoc, nm = _match_ref_kf(
                self.map, jnp.asarray(self.ref_kf), frame.feats, cfg,
                frame_groups=self.frame_groups(frame.feats),
            )
            if int(nm) >= C.TRACK_REF_KF_MIN_MATCHES:
                Tcw, assoc, ninl = _pose_opt_from_assoc(
                    self.map, jnp.asarray(self.last_Tcw), frame.feats,
                    frame.uright, assoc, cfg,
                )
                if int(ninl) >= 10:
                    frame.Tcw = Tcw
                    frame.assoc = assoc
                    ok = True
        if not ok:
            return False, 0
        n_inl = self._track_local_map(frame)
        return n_inl >= C.TRACK_LOCAL_MAP_MIN_INLIERS, n_inl

    def _track_local_map(self, frame: Frame) -> int:
        """Tracking::TrackLocalMap (src/Tracking.cc:930-975): expand to the
        covisibility neighborhood, re-search, re-optimize."""
        cfg = self.cfg
        kf_ids, pt_ids = _select_local_map(self.map, frame.assoc)
        th = 3.0 if cfg.sensor == "rgbd" else 1.0  # Tracking.cc:1160-1170
        assoc2, n2, visible = _match_against_points(
            self.map, pt_ids, frame.Tcw, frame.feats, frame.uright,
            jnp.asarray(th), cfg,
        )
        # keep existing associations where the local search found none
        assoc = jnp.where(frame.assoc >= 0, frame.assoc, assoc2)
        Tcw, assoc, n_inl = _pose_opt_from_assoc(
            self.map, frame.Tcw, frame.feats, frame.uright, assoc, cfg
        )
        frame.Tcw = Tcw
        frame.assoc = assoc
        self.map = _update_point_counters(self.map, pt_ids, visible, assoc)
        # update reference KF = most-shared local KF (Tracking.cc:1330-1337)
        best = int(kf_ids[0])
        if best >= 0:
            self.ref_kf = best
        return int(n_inl)

    def _need_new_keyframe(self, frame: Frame, n_inliers: int) -> bool:
        """Tracking::NeedNewKeyFrame (src/Tracking.cc:977-1061), conditions
        c1a/c1b/c1c/c2 with the stereo close-point heuristics."""
        cfg = self.cfg
        if cfg.localization_only:
            return False
        if self.n_kfs >= cfg.max_keyframes - 1:
            return False
        # no keyframes inside the reloc window once the map is mature
        # (Tracking.cc:1000-1002)
        if (
            frame.frame_id - self.last_reloc_frame_id < cfg.fps
            and self.n_kfs > cfg.fps
        ):
            return False
        frames_since_kf = frame.frame_id - self.last_kf_frame_id
        # reference map points tracked with >=minObs observations
        min_obs = 2 if self.n_kfs <= 2 else 3
        obs_counts = ms.point_observation_counts(self.map)
        ref_obs = self.map.kf_obs[self.ref_kf]
        ref_ok = (ref_obs >= 0) & self.map.pt_valid[
            jnp.clip(ref_obs, 0, cfg.max_points - 1)
        ]
        n_ref_matches = int(
            jnp.sum(
                ref_ok
                & (obs_counts[jnp.clip(ref_obs, 0, cfg.max_points - 1)] >= min_obs)
            )
        )
        # close-point bookkeeping (stereo/rgbd, Tracking.cc:1005-1022)
        need_close = False
        if cfg.sensor != MONOCULAR:
            depth = np.asarray(frame.depth)
            assoc = np.asarray(frame.assoc)
            close = (depth > 0) & (depth < cfg.depth_threshold)
            tracked_close = int(((assoc >= 0) & close).sum())
            nontracked_close = int(((assoc < 0) & close).sum())
            need_close = tracked_close < 100 and nontracked_close > 70
        th_ref = 0.9 if cfg.sensor == MONOCULAR else 0.75
        if self.n_kfs < 2:
            th_ref = 0.4
        c1a = frames_since_kf >= cfg.fps
        c1b = frames_since_kf >= 1  # min frames (mapping is synchronous here)
        c1c = cfg.sensor != MONOCULAR and (
            n_inliers < n_ref_matches * 0.25 or need_close
        )
        c2 = (
            n_inliers < n_ref_matches * th_ref or need_close
        ) and n_inliers > 15
        return bool((c1a or c1b or c1c) and c2)

    def _create_keyframe(self, frame: Frame):
        """Tracking::CreateNewKeyFrame (src/Tracking.cc:1063-1141)."""
        slot = self.n_kfs
        self.map, n_created, kf_obs_row = _create_keyframe_kernel(
            self.map,
            jnp.asarray(slot, jnp.int32),
            self.n_pts_dev,
            jnp.asarray(frame.frame_id, jnp.int32),
            jnp.asarray(frame.timestamp, jnp.float32),
            frame.Tcw,
            frame.feats,
            frame.uright,
            frame.depth,
            frame.assoc,
            jnp.asarray(self.ref_kf, jnp.int32),
            self.cfg,
        )
        self.n_kfs += 1
        self.n_pts_dev = self.n_pts_dev + n_created.astype(jnp.int32)
        frame.assoc = kf_obs_row
        self.ref_kf = slot
        self.last_kf_frame_id = frame.frame_id
        self.kf_ts_host[slot] = frame.timestamp
        for cb in self.new_kf_callbacks:
            cb(slot)
