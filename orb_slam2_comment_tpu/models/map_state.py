"""Struct-of-arrays map state — the reference's shared-pointer map as
fixed-capacity device arrays.

Replaces the L2 data model of the reference (Frame/KeyFrame/MapPoint/Map,
SURVEY.md §1): instead of heap objects under fine-grained mutexes
(KeyFrame.h:232-234, Map.h:62), the map is one immutable pytree of padded
arrays. Updates are functional (`.at[].set`) inside jitted kernels; the
host orchestrator owns the authoritative reference and swaps it — the
single-writer equivalent of the reference's Map::mMutexMapUpdate.

"Deletion" (MapPoint::SetBadFlag / KeyFrame::SetBadFlag) is a cleared
validity bit; capacity is static (SlamConfig.max_keyframes/max_points).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from orb_slam2_comment_tpu import constants as C


class MapState(NamedTuple):
    # --- keyframes (capacity Kmax, feature slots N) ----------------------
    kf_pose: jax.Array       # [Kmax, 4, 4] Tcw
    kf_valid: jax.Array      # [Kmax] bool
    kf_frame_id: jax.Array   # [Kmax] int32 source frame id
    kf_timestamp: jax.Array  # [Kmax] f32
    kf_xy: jax.Array         # [Kmax, N, 2] keypoint pixels (undistorted)
    kf_octave: jax.Array     # [Kmax, N] int32
    kf_angle: jax.Array      # [Kmax, N] f32
    kf_uright: jax.Array     # [Kmax, N] f32 (-1 = mono)
    kf_depth: jax.Array      # [Kmax, N] f32 (-1 = none)
    kf_desc: jax.Array       # [Kmax, N, 8] uint32
    kf_feat_valid: jax.Array  # [Kmax, N] bool
    kf_obs: jax.Array        # [Kmax, N] int32 point id or -1
    kf_group: jax.Array      # [Kmax, N] int32 BoW FeatureVector node id
                             # (-1 = none/not yet indexed; an all -1 row
                             # disables node gating for that KF)
    kf_no_erase: jax.Array   # [Kmax] bool: protected from KeyFrameCulling
                             # while the loop closer holds the KF
                             # (KeyFrame::SetNotErase/SetErase protocol,
                             # src/KeyFrame.h:101-103, src/LoopClosing.cc:
                             # 110,257; set at creation, cleared once the
                             # KF's loop detection is harvested)
    kf_parent: jax.Array     # [Kmax] int32 spanning-tree parent (-1 = root)
    kf_Tcp: jax.Array        # [Kmax, 4, 4] pose relative to parent, frozen at
                             # cull time (KeyFrame::mTcp, src/KeyFrame.cc:540;
                             # identity while the KF is alive)
    # --- map points (capacity Pmax) ---------------------------------------
    pt_pos: jax.Array        # [Pmax, 3]
    pt_valid: jax.Array      # [Pmax] bool
    pt_desc: jax.Array       # [Pmax, 8] uint32 representative descriptor
    pt_normal: jax.Array     # [Pmax, 3] mean viewing direction
    pt_min_dist: jax.Array   # [Pmax] scale-invariance band
    pt_max_dist: jax.Array   # [Pmax]
    pt_ref_kf: jax.Array     # [Pmax] int32
    pt_first_kf: jax.Array   # [Pmax] int32 (culling window anchor)
    pt_visible: jax.Array    # [Pmax] int32 tracking 'visible' counter
    pt_found: jax.Array      # [Pmax] int32 tracking 'found' counter


def empty_map(max_kfs: int, max_pts: int, n_feat: int) -> MapState:
    return MapState(
        kf_pose=jnp.tile(jnp.eye(4), (max_kfs, 1, 1)),
        kf_valid=jnp.zeros(max_kfs, bool),
        kf_frame_id=jnp.full(max_kfs, -1, jnp.int32),
        kf_timestamp=jnp.zeros(max_kfs, jnp.float32),
        kf_xy=jnp.zeros((max_kfs, n_feat, 2), jnp.float32),
        kf_octave=jnp.zeros((max_kfs, n_feat), jnp.int32),
        kf_angle=jnp.zeros((max_kfs, n_feat), jnp.float32),
        kf_uright=jnp.full((max_kfs, n_feat), -1.0, jnp.float32),
        kf_depth=jnp.full((max_kfs, n_feat), -1.0, jnp.float32),
        kf_desc=jnp.zeros((max_kfs, n_feat, 8), jnp.uint32),
        kf_feat_valid=jnp.zeros((max_kfs, n_feat), bool),
        kf_obs=jnp.full((max_kfs, n_feat), -1, jnp.int32),
        kf_group=jnp.full((max_kfs, n_feat), -1, jnp.int32),
        kf_no_erase=jnp.zeros(max_kfs, bool),
        kf_parent=jnp.full(max_kfs, -1, jnp.int32),
        kf_Tcp=jnp.tile(jnp.eye(4), (max_kfs, 1, 1)),
        pt_pos=jnp.zeros((max_pts, 3), jnp.float32),
        pt_valid=jnp.zeros(max_pts, bool),
        pt_desc=jnp.zeros((max_pts, 8), jnp.uint32),
        pt_normal=jnp.zeros((max_pts, 3), jnp.float32),
        pt_min_dist=jnp.zeros(max_pts, jnp.float32),
        pt_max_dist=jnp.full(max_pts, 1e9, jnp.float32),
        pt_ref_kf=jnp.full(max_pts, -1, jnp.int32),
        pt_first_kf=jnp.full(max_pts, -1, jnp.int32),
        pt_visible=jnp.zeros(max_pts, jnp.int32),
        pt_found=jnp.zeros(max_pts, jnp.int32),
    )


def grow_map(m: MapState, new_kmax: int, new_pmax: int) -> MapState:
    """Functionally pad a MapState to a larger capacity tier. Every jitted
    kernel recompiles once at the new shapes (bounded: once per tier —
    SURVEY.md §7 'Hard parts' capacity bucketing). The reference has no
    equivalent because its pointer graph grows unboundedly; here growth is
    an explicit, rare host-side event.
    """
    kmax, n_feat = m.kf_obs.shape
    pmax = m.pt_pos.shape[0]
    if new_kmax < kmax or new_pmax < pmax:
        raise ValueError("capacity tiers only grow")
    if new_kmax == kmax and new_pmax == pmax:
        return m
    dk = new_kmax - kmax
    dp = new_pmax - pmax

    def pad_k(x, fill):
        pad_shape = (dk,) + x.shape[1:]
        return jnp.concatenate([x, jnp.full(pad_shape, fill, x.dtype)], axis=0)

    def pad_k_eye(x):  # [K,4,4] identity-padded
        return jnp.concatenate(
            [x, jnp.tile(jnp.eye(4, dtype=x.dtype), (dk, 1, 1))], axis=0)

    def pad_p(x, fill):
        pad_shape = (dp,) + x.shape[1:]
        return jnp.concatenate([x, jnp.full(pad_shape, fill, x.dtype)], axis=0)

    return MapState(
        kf_pose=pad_k_eye(m.kf_pose),
        kf_valid=pad_k(m.kf_valid, False),
        kf_frame_id=pad_k(m.kf_frame_id, -1),
        kf_timestamp=pad_k(m.kf_timestamp, 0),
        kf_xy=pad_k(m.kf_xy, 0),
        kf_octave=pad_k(m.kf_octave, 0),
        kf_angle=pad_k(m.kf_angle, 0),
        kf_uright=pad_k(m.kf_uright, -1.0),
        kf_depth=pad_k(m.kf_depth, -1.0),
        kf_desc=pad_k(m.kf_desc, 0),
        kf_feat_valid=pad_k(m.kf_feat_valid, False),
        kf_obs=pad_k(m.kf_obs, -1),
        kf_group=pad_k(m.kf_group, -1),
        kf_no_erase=pad_k(m.kf_no_erase, False),
        kf_parent=pad_k(m.kf_parent, -1),
        kf_Tcp=pad_k_eye(m.kf_Tcp),
        pt_pos=pad_p(m.pt_pos, 0),
        pt_valid=pad_p(m.pt_valid, False),
        pt_desc=pad_p(m.pt_desc, 0),
        pt_normal=pad_p(m.pt_normal, 0),
        pt_min_dist=pad_p(m.pt_min_dist, 0),
        pt_max_dist=pad_p(m.pt_max_dist, 1e9),
        pt_ref_kf=pad_p(m.pt_ref_kf, -1),
        pt_first_kf=pad_p(m.pt_first_kf, -1),
        pt_visible=pad_p(m.pt_visible, 0),
        pt_found=pad_p(m.pt_found, 0),
    )


@jax.jit
def compact_points(m: MapState):
    """Stream-compact live points to the low slots, freeing the arena tail.

    The reference deletes MapPoints on the heap; this fixed-shape arena
    instead burns a fresh slot per created point (triangulation churn can
    consume ~8 slots per surviving point on forward-motion scenes), so the
    cursor — not the live count — used to drive capacity growth and would
    eventually exhaust the top tier. Compaction is one device program:
    scatter live point rows to rank order and rewrite every kf_obs entry
    through the remap. Returns (m', n_live, remap) — the caller must also
    remap any point ids it holds outside the map (device tracker state's
    last_assoc) and abort an in-flight background GBA snapshot.
    """
    pmax = m.pt_pos.shape[0]
    valid = m.pt_valid
    rank = jnp.cumsum(valid.astype(jnp.int32)) - 1
    remap = jnp.where(valid, rank, -1)                      # old id -> new id
    dst = jnp.where(valid, rank, pmax)                      # drop row for dead

    def mv(arr, fill):
        out = jnp.full((pmax + 1,) + arr.shape[1:], fill, arr.dtype)
        return out.at[dst].set(arr, mode="drop")[:pmax]

    obs = m.kf_obs
    obs_new = jnp.where(
        (obs >= 0) & valid[jnp.clip(obs, 0, pmax - 1)],
        remap[jnp.clip(obs, 0, pmax - 1)], -1)
    return m._replace(
        pt_pos=mv(m.pt_pos, 0),
        pt_valid=mv(m.pt_valid, False),
        pt_desc=mv(m.pt_desc, 0),
        pt_normal=mv(m.pt_normal, 0),
        pt_min_dist=mv(m.pt_min_dist, 0),
        pt_max_dist=mv(m.pt_max_dist, 1e9),
        pt_ref_kf=mv(m.pt_ref_kf, -1),
        pt_first_kf=mv(m.pt_first_kf, -1),
        pt_visible=mv(m.pt_visible, 0),
        pt_found=mv(m.pt_found, 0),
        kf_obs=obs_new,
    ), jnp.sum(valid.astype(jnp.int32)), remap


@jax.jit
def covisibility_matrix(m: MapState) -> jax.Array:
    """[Kmax, Kmax] int32 all-pairs shared-observation counts — the full
    covisibility graph in one shot (the batched equivalent of running
    KeyFrame::UpdateConnections, src/KeyFrame.cc:289-330, for every KF).
    Computed as A @ A^T with A the [Kmax, Pmax] observation indicator,
    chunked over points so the indicator never materializes at full width;
    each chunk is one matmul.
    """
    kmax, n_feat = m.kf_obs.shape
    pmax = m.pt_pos.shape[0]
    chunk = min(pmax, 16384)
    n_chunks = (pmax + chunk - 1) // chunk
    obs_pt_ok = m.pt_valid[jnp.clip(m.kf_obs, 0, pmax - 1)]  # bad-point skip
    obs = jnp.where(
        m.kf_feat_valid & m.kf_valid[:, None] & obs_pt_ok, m.kf_obs, -1)

    def body(c, acc):
        lo = c * chunk
        # indicator for points [lo, lo+chunk): A[k, p-lo] = 1 if KF k sees p
        rel = obs - lo
        in_chunk = (rel >= 0) & (rel < chunk)
        A = jnp.zeros((kmax, chunk), jnp.bfloat16).at[
            jnp.arange(kmax)[:, None], jnp.clip(rel, 0, chunk - 1)
        ].max(in_chunk.astype(jnp.bfloat16))
        return acc + jnp.dot(
            A, A.T, preferred_element_type=jnp.float32
        )

    W = jax.lax.fori_loop(
        0, n_chunks, body, jnp.zeros((kmax, kmax), jnp.float32)
    ).astype(jnp.int32)
    W = jnp.where(m.kf_valid[:, None] & m.kf_valid[None, :], W, 0)
    return W * (1 - jnp.eye(kmax, dtype=jnp.int32))


@jax.jit
def covisibility_weights(m: MapState, k: jax.Array) -> jax.Array:
    """Shared-observation counts between keyframe k and every other KF
    (KeyFrame::UpdateConnections counting pass, src/KeyFrame.cc:289-330)."""
    obs_k = m.kf_obs[k]                       # [N]
    pmax = m.pt_pos.shape[0]
    in_k = jnp.zeros(pmax, bool).at[jnp.clip(obs_k, 0, pmax - 1)].set(obs_k >= 0)
    in_k = in_k & m.pt_valid
    shared = in_k[jnp.clip(m.kf_obs, 0, pmax - 1)] & (m.kf_obs >= 0)  # [Kmax, N]
    w = jnp.sum(shared, axis=1).astype(jnp.int32)
    w = jnp.where(m.kf_valid, w, 0)
    return w.at[k].set(0)


@jax.jit
def point_observation_counts(m: MapState) -> jax.Array:
    """[Pmax] observation count per point; a stereo observation counts as 2,
    matching MapPoint::AddObservation (src/MapPoint.cc:98-110: nObs += 2
    when mvuRight >= 0)."""
    pmax = m.pt_pos.shape[0]
    flat = m.kf_obs.reshape(-1)
    ok = (flat >= 0) & m.kf_valid.repeat(m.kf_obs.shape[1])
    wgt = jnp.where(m.kf_uright.reshape(-1) >= 0, 2, 1)
    return jnp.zeros(pmax, jnp.int32).at[jnp.clip(flat, 0, pmax - 1)].add(
        jnp.where(ok, wgt, 0).astype(jnp.int32)
    )


@functools.partial(jax.jit, static_argnames=("scale_factor", "n_levels"))
def update_point_stats(m: MapState, scale_factor: float = 1.2,
                       n_levels: int = 8) -> MapState:
    """Refresh normals and scale bands for all valid points from their
    current observations — batched MapPoint::UpdateNormalAndDepth
    (src/MapPoint.cc:330-371). Representative descriptors are refreshed
    separately by local_mapping.update_point_descriptors (the min-median
    ComputeDistinctiveDescriptors equivalent, src/MapPoint.cc:242-307).

    scale_factor/n_levels mirror the extractor pyramid (mfLevelScaleFactor
    and mnScaleLevels in MapPoint.cc:355-358); callers pass the cfg values.
    """
    Kmax, N = m.kf_obs.shape
    pmax = m.pt_pos.shape[0]
    flat_pt = m.kf_obs.reshape(-1)
    valid_obs = (flat_pt >= 0) & m.kf_valid.repeat(N) & m.kf_feat_valid.reshape(-1)
    pt_idx = jnp.clip(flat_pt, 0, pmax - 1)

    # --- normals: mean of unit vectors from camera centers to point -------
    # camera center in world = -R^T t
    Rt = m.kf_pose[:, :3, :3].transpose(0, 2, 1)
    cam_centers = -jnp.einsum("kij,kj->ki", Rt, m.kf_pose[:, :3, 3])
    centers_per_obs = jnp.repeat(cam_centers, N, axis=0)     # [Kmax*N, 3]
    vec = m.pt_pos[pt_idx] - centers_per_obs
    dist = jnp.linalg.norm(vec, axis=-1, keepdims=True)
    unit = vec / jnp.maximum(dist, 1e-9)
    nsum = jnp.zeros((pmax, 3)).at[pt_idx].add(jnp.where(valid_obs[:, None], unit, 0.0))
    cnt = jnp.zeros(pmax).at[pt_idx].add(valid_obs.astype(jnp.float32))
    normal = nsum / jnp.maximum(cnt[:, None], 1.0)

    # --- scale band from the reference KF observation ---------------------
    ref = jnp.clip(m.pt_ref_kf, 0, Kmax - 1)
    ref_center = cam_centers[ref]
    ref_dist = jnp.linalg.norm(m.pt_pos - ref_center, axis=-1)
    # octave of the observation in the ref KF: find feature index via kf_obs
    # (approximation: use level 0 band scaled by max factor — refined below)
    # locate this point's slot in its ref KF
    pids = jnp.arange(pmax)
    slot_match = m.kf_obs[ref] == pids[:, None]             # [Pmax, N]
    slot = jnp.argmax(slot_match, axis=1)
    has_slot = jnp.any(slot_match, axis=1)
    octv = jnp.where(has_slot, m.kf_octave[ref, slot], 0)
    sf = float(scale_factor)
    scale = sf ** octv.astype(jnp.float32)
    max_dist = ref_dist * scale
    min_dist = max_dist / (sf ** (float(n_levels) - 1.0))

    # Stored UNMARGINED (mfMaxDistance = dist*levelScaleFactor,
    # mfMinDistance = mfMaxDistance/sf^(nLevels-1), MapPoint.cc:355-360,
    # 367-368) to match every creation site; the 0.8/1.2 invariance margins
    # (MapPoint.cc:373-383) are applied at query time by the frustum/fuse
    # band checks. PredictScale consumes the unmargined mfMaxDistance
    # (MapPoint.cc:385-391).
    return m._replace(
        pt_normal=jnp.where(m.pt_valid[:, None], normal, m.pt_normal),
        pt_max_dist=jnp.where(m.pt_valid & has_slot, max_dist, m.pt_max_dist),
        pt_min_dist=jnp.where(m.pt_valid & has_slot, min_dist, m.pt_min_dist),
    )


def predict_scale(dist, max_dist, scale_factor: float, n_levels: int):
    """Scale level prediction from distance (MapPoint::PredictScale,
    src/MapPoint.cc:385-417)."""
    ratio = jnp.maximum(max_dist / jnp.maximum(dist, 1e-9), 1e-9)
    lvl = jnp.ceil(jnp.log(ratio) / jnp.log(scale_factor)).astype(jnp.int32)
    return jnp.clip(lvl, 0, n_levels - 1)
