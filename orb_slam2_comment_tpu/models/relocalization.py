"""Relocalization after tracking loss — Tracking::Relocalization
(src/Tracking.cc:1341-1502).

Pipeline per candidate keyframe from the BoW database:
  1. BoW-node-gated descriptor matching to the KF's map points
     (SearchByBoW; >=15 matches)
  2. batched PnP RANSAC for an initial pose (the EPnP role)
  3. pose_optimize; if inliers < 50, a widened projective re-search
     (SearchByProjection(F, KF, ...), src/ORBmatcher.cc:1472) and a final
     optimization; accept at >=50 inliers.

Device shape: the whole candidate ladder is ONE jitted program —
`lax.map` over a fixed candidate axis with masked validity, one host sync
per LOST frame. The reference bounds per-frame reloc cost by doing 5
RANSAC iterations per candidate per outer loop (Tracking.cc:1405-1411);
here the bound is the fixed candidate capacity RELOC_MAX_CANDIDATES and
the single fused dispatch (VERDICT r2 item 6: a LOST frame must cost
about one tracked frame, not seconds of per-candidate round-trips).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from orb_slam2_comment_tpu import constants as C
from orb_slam2_comment_tpu.models import map_state as ms
from orb_slam2_comment_tpu.models.tracking import (
    _inv_sigma2,
    _match_against_points,
    _pose_opt_from_assoc,
)
from orb_slam2_comment_tpu.ops import matching, ransac
from orb_slam2_comment_tpu.utils.config import SlamConfig

# fixed candidate capacity of the fused kernel (the DB's max_out default;
# candidates beyond this are rare and were already ranked worse)
RELOC_MAX_CANDIDATES = 5


@functools.partial(jax.jit, static_argnames=("cfg",))
def _reloc_kernel(m: ms.MapState, db_groups: jax.Array, cand_ids: jax.Array,
                  feats, uright: jax.Array, frame_groups: jax.Array,
                  cfg: SlamConfig):
    """Try every candidate in one program; return the FIRST success
    (reference semantics: the loop breaks on the first candidate reaching
    >=50 inliers, src/Tracking.cc:1488-1496).

    cand_ids: [RELOC_MAX_CANDIDATES] int32, -1 padded.
    Returns (ok_any, first_ok_index, Tcw [C,4,4], assoc [C,N], n_inl [C]).
    """
    kmax = m.kf_pose.shape[0]
    pmax = m.pt_pos.shape[0]
    n = feats.xy.shape[0]
    sig2 = jnp.asarray(
        [cfg.scale_factor ** (2 * l) for l in range(cfg.n_levels)])

    def per_cand(c):
        kf_j = jnp.clip(c, 0, kmax - 1)
        enabled = c >= 0
        # 1. Descriptor matching to the candidate KF's map points. The
        # reference scopes this to shared FeatureVector nodes (SearchByBoW)
        # — a CPU pruning trick that saves nothing on an accelerator, where
        # the dense Hamming matrix is one matmul (same switch as
        # loop_closing._compute_sim3). Mutual-best + ratio + rotation
        # consistency are the precision gates.
        kf_obs = m.kf_obs[kf_j]
        kf_ok = m.kf_feat_valid[kf_j] & (kf_obs >= 0)
        dist = matching.hamming_from_packed(m.kf_desc[kf_j], feats.desc)
        res = matching.match_generic(
            dist,
            kf_ok[:, None] & feats.valid[None, :],
            max_dist=cfg.th_low,
            nn_ratio=0.75,
            mutual=True,
            angles_a=m.kf_angle[kf_j],
            angles_b=feats.angle,
        )
        assoc = jnp.full((n,), -1, jnp.int32)
        assoc = assoc.at[res.idx].set(jnp.where(res.ok, kf_obs, -1))
        assoc = jnp.where(feats.valid, assoc, -1)
        pid = jnp.clip(assoc, 0, pmax - 1)
        valid = (assoc >= 0) & m.pt_valid[pid]
        enough_bow = jnp.sum(valid) >= 15
        valid = valid & enough_bow & enabled
        # 2. PnP RANSAC on the putative 2D-3D matches
        pnp = ransac.pnp_ransac(
            m.pt_pos[pid], feats.xy, feats.octave, valid, sig2, cfg.K)
        # 3. pose opt; widened projective re-search when short of inliers
        assoc_in = jnp.where(valid & pnp.ok, assoc, -1)
        Tcw, assoc2, n_inl = _pose_opt_from_assoc(
            m, pnp.Tcw, feats, uright, assoc_in, cfg)

        def _widen(_):
            pt_ids = m.kf_obs[kf_j]
            assoc3, _, _ = _match_against_points(
                m, pt_ids, Tcw, feats, uright,
                jnp.asarray(10.0), cfg, use_frustum_band=False)
            merged = jnp.where(assoc2 >= 0, assoc2, assoc3)
            return _pose_opt_from_assoc(m, Tcw, feats, uright, merged, cfg)

        needs_widen = (n_inl >= 10) & (n_inl < C.RELOC_MIN_INLIERS) & pnp.ok
        Tcw, assoc2, n_inl = jax.lax.cond(
            needs_widen, _widen, lambda _: (Tcw, assoc2, n_inl), 0)
        ok = (
            enabled & enough_bow & pnp.ok
            & (n_inl >= C.RELOC_MIN_INLIERS)
        )
        return ok, Tcw, assoc2, n_inl

    ok, Tcw, assoc, n_inl = jax.lax.map(per_cand, cand_ids)
    # first success wins (reference loop order); argmax of ok picks the
    # lowest true index
    first = jnp.argmax(ok)
    return jnp.any(ok), first, Tcw, assoc, n_inl


def relocalize(m: ms.MapState, db, frame, cfg: SlamConfig,
               rank_offset: int = 0):
    """Try to recover the camera pose of a lost frame with ONE fused
    device program over the top BoW candidates.

    rank_offset rotates through the ranked candidate list on consecutive
    failures (see AdaptiveRelocalizer) — the fused analogue of the
    reference's iterate-until-exhausted outer loop, which keeps giving
    every remaining candidate more RANSAC budget on each LOST frame
    (src/Tracking.cc:1405-1462, PnPsolver::iterate 5 its/frame).

    Returns (success, Tcw, assoc, n_candidates)."""
    from orb_slam2_comment_tpu.ops import bow as bow_mod

    words, groups, vec = bow_mod.transform(
        db.voc, frame.feats.desc, frame.feats.valid
    )
    candidates = db.detect_reloc_candidates(
        vec, valid_mask=m.kf_valid, m=m, query_words=words,
        max_out=4 * RELOC_MAX_CANDIDATES)
    if not candidates:
        return False, None, None, 0
    if rank_offset:
        candidates = candidates[rank_offset:] or candidates
    cand = np.full(RELOC_MAX_CANDIDATES, -1, np.int32)
    k = min(len(candidates), RELOC_MAX_CANDIDATES)
    cand[:k] = candidates[:k]
    ok_any, first, Tcw, assoc, n_inl = _reloc_kernel(
        m, db.groups, jnp.asarray(cand), frame.feats, frame.uright,
        groups, cfg)
    if not bool(ok_any):
        return False, None, None, len(candidates) + rank_offset
    i = int(first)
    return True, Tcw[i], assoc[i], len(candidates) + rank_offset


class AdaptiveRelocalizer:
    """Stateful retry ladder over relocalize(): each consecutive LOST
    frame advances rank_offset by RELOC_MAX_CANDIDATES so lower-ranked
    BoW candidates get their PnP shot once the top page is exhausted,
    wrapping when the list runs out (the reference exhausts each
    candidate's RANSAC budget over successive frames rather than
    retrying only the top 5 forever, src/Tracking.cc:1405-1462)."""

    def __init__(self):
        self.fail_streak = 0
        self._n_cand = RELOC_MAX_CANDIDATES

    def reset(self):
        self.fail_streak = 0

    def __call__(self, m, db, frame, cfg):
        pages = max(1, -(-self._n_cand // RELOC_MAX_CANDIDATES))
        offset = (self.fail_streak % pages) * RELOC_MAX_CANDIDATES
        ok, Tcw, assoc, n_cand = relocalize(
            m, db, frame, cfg, rank_offset=offset)
        self._n_cand = max(n_cand, 1)
        self.fail_streak = 0 if ok else self.fail_streak + 1
        return ok, Tcw, assoc
