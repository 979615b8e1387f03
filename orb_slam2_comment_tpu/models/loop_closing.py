"""Loop detection and correction — the reference's LoopClosing thread
(src/LoopClosing.cc) as a synchronous per-keyframe pass.

Stages (LoopClosing::Run, :57-88):
  DetectLoop   (:103-229): BoW candidates above the covisible-neighbor
               minimum score, validated by covisibility-consistency across
               3 consecutive detections.
  ComputeSim3  (:231-400): BoW-gated 3D-3D correspondences -> batched Horn
               Sim3 RANSAC -> sim3_optimize -> guided projection count.
  CorrectLoop  (:402-643): propagate the corrective Sim3 through the
               current covisibility neighborhood (poses + points), fuse
               duplicates, optimize the essential graph, then (optionally)
               a PCG global BA.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from orb_slam2_comment_tpu import constants as C
from orb_slam2_comment_tpu.models import map_state as ms
from orb_slam2_comment_tpu.models.local_mapping import (
    fuse_into_keyframe,
    fuse_point_set_into_keyframe,
)
from orb_slam2_comment_tpu.ops import bow as bow_mod
from orb_slam2_comment_tpu.ops import geometry as geo
from orb_slam2_comment_tpu.ops import matching, optim, ransac
from orb_slam2_comment_tpu.utils.config import MONOCULAR, SlamConfig


@jax.jit
def _detect_pack_sc(m, scores, common):
    """_detect_pack for a precomputed (scores, common) pair — the
    sparse/inverted-file database path (the score kernel runs in the DB's
    own jit; chaining device arrays keeps the one-pull property)."""
    W = ms.covisibility_matrix(m).astype(jnp.float32)
    return jnp.concatenate(
        [W, scores[:, None], common.astype(jnp.float32)[:, None],
         m.kf_valid.astype(jnp.float32)[:, None]], axis=1)


@jax.jit
def _detect_pack(m, db_bow, db_valid, query):
    """All device-side inputs of one keyframe's loop detection packed
    into a single [K, K+3] f32 buffer: covisibility matrix | BoW scores |
    shared-word counts | kf_valid. One output = one device->host pull."""
    from orb_slam2_comment_tpu.models.keyframe_database import _scores_kernel

    W = ms.covisibility_matrix(m).astype(jnp.float32)
    scores, common = _scores_kernel(db_bow, db_valid, query)
    return jnp.concatenate(
        [W, scores[:, None], common.astype(jnp.float32)[:, None],
         m.kf_valid.astype(jnp.float32)[:, None]], axis=1)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _sim3_gate_kernel(m, k1, k2, cfg: SlamConfig):
    """ComputeSim3's match + RANSAC gate as ONE program
    (src/LoopClosing.cc:231-320): FeatureVector-node-gated one-directional
    SearchByBoW(KF, KF) (src/ORBmatcher.cc:522 — the node gate SCOPES the
    Lowe ratio test to same-node competitors; against the full feature set
    the second-best on self-similar scenes defeats the ratio for most
    true pairs), then the batched Horn Sim3 RANSAC. Returns
    (scalars [n_bow, ransac_ok, n_inl, n_raw], idx, pair_ok, S12, inliers)
    so the host gate costs a single small pull."""
    obs2 = m.kf_obs[k2]
    ok2 = m.kf_feat_valid[k2] & (obs2 >= 0)
    ok1 = m.kf_feat_valid[k1] & (m.kf_obs[k1] >= 0)
    ga = m.kf_group[k1]
    gb = m.kf_group[k2]
    row_ungated = (~jnp.any(ga >= 0)) | (~jnp.any(gb >= 0))

    # gate-inactive detection (ADVICE r4): with no vocabulary groups, or a
    # degenerate single-node grouping (dummy 1-node tree), node_ok stops
    # scoping the ratio test — fall back to mutual-best as the precision
    # gate (the pre-node-gate code's behavior) instead of an unscoped
    # full-set ratio test.
    def _uniform(g, okm):
        valid = okm & (g >= 0)
        mx = jnp.max(jnp.where(valid, g, -1))
        mn = jnp.min(jnp.where(valid, g, mx))
        return mx == mn

    gate_inactive = row_ungated | (_uniform(ga, ok1) & _uniform(gb, ok2))
    node_ok = (ga[:, None] == gb[None, :]) & (ga >= 0)[:, None]
    dist = matching.hamming_from_packed(m.kf_desc[k1], m.kf_desc[k2])
    mask = ok1[:, None] & ok2[None, :] & (node_ok | gate_inactive)
    res = matching.match_generic(
        dist,
        mask,
        max_dist=cfg.th_low,
        nn_ratio=0.75,
        mutual=False,
        angles_a=m.kf_angle[k1],
        angles_b=m.kf_angle[k2],
    )
    mut_ok = matching._mutual_best(
        jnp.where(mask, dist, matching._INF), res.idx, res.ok)
    res = res._replace(ok=jnp.where(gate_inactive, mut_ok, res.ok))
    p1 = m.kf_obs[k1]
    p2 = obs2[res.idx]
    pmax = cfg.max_points
    pair_ok = (
        res.ok
        & (p1 >= 0) & (p2 >= 0)
        & m.pt_valid[jnp.clip(p1, 0, pmax - 1)]
        & m.pt_valid[jnp.clip(p2, 0, pmax - 1)]
    )
    X1w = m.pt_pos[jnp.clip(p1, 0, pmax - 1)]
    X2w = m.pt_pos[jnp.clip(p2, 0, pmax - 1)]
    Xc1 = geo.transform_points(m.kf_pose[k1], X1w)
    Xc2 = geo.transform_points(m.kf_pose[k2], X2w)
    sigma2 = jnp.asarray(
        [cfg.scale_factor ** (2 * l) for l in range(cfg.n_levels)]
    )
    rres = ransac.sim3_ransac(
        Xc1, Xc2, m.kf_xy[k1], m.kf_xy[k2][res.idx],
        m.kf_octave[k1], m.kf_octave[k2][res.idx],
        pair_ok, sigma2, cfg.K, cfg.K,
        fix_scale=cfg.sensor != MONOCULAR,
    )
    scalars = jnp.stack([
        jnp.sum(pair_ok).astype(jnp.float32),
        rres.ok.astype(jnp.float32),
        rres.n_inliers.astype(jnp.float32),
        jnp.sum(res.ok).astype(jnp.float32),
    ])
    return scalars, res.idx, pair_ok, rres.S12, rres.inliers


def _loop_dbg_on():
    import os
    return os.environ.get("LOOP_DEBUG", "") not in ("", "0")


def _loop_dbg(msg):
    if _loop_dbg_on():
        print(msg, flush=True)


@dataclass
class LoopCloser:
    cfg: SlamConfig
    tracker: object
    db: object                      # KeyFrameDatabase
    last_loop_kf: int = -(1 << 30)
    consistent_groups: list = field(default_factory=list)
    n_loops_closed: int = 0
    run_global_ba: bool = True
    # accepted loop edges (a, b, S_ba) — KeyFrame::AddLoopEdge
    # (src/KeyFrame.cc): they stay in every later essential graph
    # (src/Optimizer.cc:902-910)
    loop_edges: list = field(default_factory=list)
    # chunked background GBA (the reference's transient GBA thread, P2):
    # one LM iteration dispatched per frame via pump_background(); aborted
    # wholesale when a new loop corrects (mbStopGBA,
    # src/LoopClosing.cc:410-423) or on reset
    gba_background: bool = True
    _bg: object = None  # (prob, inv_s2, carry, it, snap_kf, snap_pt)
    # async loop-detection queue: (kf_id, packed_dev, born_pump) — see
    # process()/_drain_detect
    _detect_q: object = field(default_factory=__import__("collections").deque)
    _pump_count: int = 0

    # ------------------------------------------------------------------
    def process(self, kf_id: int):
        """Queue this keyframe for loop detection and harvest any ready
        one. Detection is ASYNCHRONOUS: the two device programs (all-pairs
        covisibility, BoW scores row) are dispatched now and their results
        harvested once the device->host pulls complete — usually on a
        later frame's pump. This is the reference's LoopClosing queue
        (src/LoopClosing.cc:57-101, mlpLoopKeyFrameQueue): the loop thread
        runs behind tracking, and a keyframe's detection never stalls the
        frame that created it."""
        if self.tracker.n_kfs < 5:
            self.tracker.set_kf_erasable(kf_id)
            return False
        if kf_id - self.last_loop_kf < C.LOOP_MIN_KFS_GAP:
            self.tracker.set_kf_erasable(kf_id)
            return False
        m = self.tracker.map
        # ONE packed program output -> ONE device->host pull on a side
        # thread instead of four. The packed buffer is a fresh program output, so no aliasing with
        # the donated live map (the bf5b832 class).
        if self.db.sparse:
            sc, cm = self.db.scores_device(kf_id=kf_id)
            packed = _detect_pack_sc(m, sc, cm)
        else:
            packed = _detect_pack(m, self.db.bow, self.db.valid,
                                  self.db.bow[kf_id])
        # ride the tracker's batched stats transfer (ONE transfer per
        # STATS_BATCH frames carries the packs too) instead of one pull
        # per keyframe
        # the side channel rides the fused pipeline's stats batches; the
        # staged/host mode never enqueues stats, so its packs would wait
        # for a ship that never comes — keep the pool pull there
        enq = getattr(self.tracker, "enqueue_side", None)
        if enq is not None and not getattr(self.tracker.cfg,
                                           "fused_tracking", False):
            enq = None
        if enq is not None:
            fut = enq(packed.reshape(-1), packed.shape)
        else:
            pool = getattr(self.tracker, "_io_pool", None)
            fut = (pool.submit(np.asarray, packed)
                   if pool is not None else None)
        self._detect_q.append((kf_id, packed, fut, self._pump_count))
        return self._drain_detect(force=False)

    def _drain_detect(self, force: bool) -> bool:
        """Harvest queued detections once the device has had a few frames
        to finish their programs (all of them when force=True). Pulling
        too early would block behind the keyframe burst's program queue.
        Returns True if a loop closed."""
        closed = False
        while self._detect_q:
            kf_id, packed, fut, born = self._detect_q[0]
            if not force and self._pump_count - born < 4:
                break
            # never block behind the device's program queue: the packed
            # result arrives via the async IO pool; until the future is
            # done (or is_ready() on the pool-less path), defer harvest
            if fut is not None:
                if not force and not fut.done():
                    break
            elif not force and not packed.is_ready():
                break
            self._detect_q.popleft()
            # detection harvested -> the KF becomes erasable again
            # (KeyFrame::SetErase, the end of the SetNotErase window)
            self.tracker.set_kf_erasable(kf_id)
            P = fut.result() if fut is not None else np.asarray(packed)
            kmax = P.shape[0]
            W = P[:, :kmax].astype(np.int32)
            s = P[:, kmax]
            c = P[:, kmax + 1].astype(np.int32)
            v = P[:, kmax + 2] > 0.5
            closed |= self._finish_detect(kf_id, W, s, c, v)
        return closed

    def _finish_detect(self, kf_id, W, scores_all, common_all, kf_valid):
        if kf_id - self.last_loop_kf < C.LOOP_MIN_KFS_GAP:
            return False
        cands = self._detect_loop(kf_id, W, scores_all, common_all, kf_valid)
        if not cands:
            return False
        # the covisibility/validity snapshot was packed ~4 pumps ago; a
        # candidate culled (or the current KF itself) in the interim would
        # flow into Sim3/correction with dead kf_obs/pose slots — re-check
        # against the CURRENT map before committing (the reference's
        # SetNotErase protocol guarantees liveness instead,
        # src/LoopClosing.cc:110,257)
        live = np.asarray(self.tracker.map.kf_valid)
        if not live[kf_id]:
            return False
        cands = [c for c in cands if live[c]]
        if not cands:
            return False
        # the reference tries EVERY enough-consistent candidate with its
        # own Sim3 solver and takes the first that survives
        # (mvpEnoughConsistentCandidates, src/LoopClosing.cc:231-350)
        for cand in cands:
            ok, S_cur_cand = self._compute_sim3(kf_id, cand)
            if ok:
                break
        else:
            return False
        # the reference's banner (src/LoopClosing.cc:404)
        print(f"Loop detected! kf={kf_id} <-> {cand}", flush=True)
        self._correct_loop(kf_id, cand, S_cur_cand)
        self.last_loop_kf = kf_id
        self.n_loops_closed += 1
        # queued detections' covisibility snapshots predate the correction;
        # release their SetNotErase holds along with the queue
        for q_kf, _, _, _ in self._detect_q:
            self.tracker.set_kf_erasable(q_kf)
        self._detect_q.clear()
        return True

    # ------------------------------------------------------------------
    def _detect_loop(self, kf_id: int, W, scores_all, common_all, kf_valid):
        """DetectLoop (src/LoopClosing.cc:103-229) on pre-pulled arrays."""
        import os

        dbg = os.environ.get("LOOP_DEBUG", "") not in ("", "0")
        m = self.tracker.map
        nbrs = np.where(W[kf_id] >= C.COVIS_MIN_WEIGHT)[0]
        nbrs = nbrs[nbrs != kf_id]
        if len(nbrs) == 0:
            return None
        min_score = max(float(scores_all[nbrs].min()), 0.0)
        candidates = self.db.detect_loop_candidates(
            m, kf_id, min_score, W=W, scores_common=(scores_all, common_all),
            kf_valid=kf_valid)
        if not candidates:
            if dbg:
                print(f"[loop] kf={kf_id} minScore={min_score:.3f} "
                      f"candidates=0", flush=True)
            self.consistent_groups = []
            return None
        # covisibility-consistency across 3 detections (mnCovisibility-
        # ConsistencyTh=3, src/LoopClosing.cc:152-211)
        new_groups = []
        enough = []
        prev = self.consistent_groups
        for c in candidates:
            cw = W[int(c)]
            group = set(np.where(cw > 0)[0].tolist()) | {int(c)}
            count = 0
            for pg, pc in prev:
                if group & pg:
                    count = max(count, pc + 1)
            new_groups.append((group, count))
            if count >= C.LOOP_CONSISTENCY_TH:
                enough.append(int(c))
        self.consistent_groups = new_groups
        if dbg:
            print(f"[loop] kf={kf_id} minScore={min_score:.3f} "
                  f"cands={candidates} consistency="
                  f"{[c for _, c in new_groups]} -> {enough}", flush=True)
        return enough

    # ------------------------------------------------------------------
    def _compute_sim3(self, kf_id: int, cand: int):
        """ComputeSim3 (src/LoopClosing.cc:231-400). Returns
        (ok, S12 [4,4]) with S12 mapping candidate-camera coords into
        current-camera coords.

        The match + RANSAC gate runs as ONE device program with ONE small
        scalar pull (_sim3_gate_kernel): impostor candidates — score-
        plausible but geometrically wrong pairs the consistency chain
        lets through on self-similar scenes — are rejected dozens of
        times per run, and two blocking pulls per attempt dominated the
        room_loop mean frame time."""
        cfg = self.cfg
        m = self.tracker.map
        k1, k2 = jnp.asarray(kf_id), jnp.asarray(cand)
        scalars, res_idx, pair_ok, S12_r, inl_r = _sim3_gate_kernel(
            m, k1, k2, cfg)
        sc = np.asarray(scalars)  # the ONE pull of the gate path
        n_bow, r_ok, r_ninl, n_raw = (int(sc[0]), bool(sc[1] > 0),
                                      int(sc[2]), int(sc[3]))
        if n_bow < C.LOOP_MIN_MATCHES_BOW:
            _loop_dbg(f"[loop] sim3 kf={kf_id}<->{cand}: bow pairs {n_bow} "
                      f"< {C.LOOP_MIN_MATCHES_BOW} (raw matches {n_raw})")
            return False, None
        res = type("R", (), {})()
        res.idx = res_idx
        pmax = cfg.max_points
        p1 = m.kf_obs[k1]
        T1 = m.kf_pose[k1]
        T2 = m.kf_pose[k2]
        obs2 = m.kf_obs[k2]
        X1w = m.pt_pos[jnp.clip(p1, 0, pmax - 1)]
        Xc1 = geo.transform_points(T1, X1w)
        uv1 = m.kf_xy[k1]
        sigma2 = jnp.asarray(
            [cfg.scale_factor ** (2 * l) for l in range(cfg.n_levels)]
        )
        fix_scale = cfg.sensor != MONOCULAR
        rres = type("R", (), {})()
        rres.ok = r_ok
        rres.n_inliers = r_ninl
        rres.S12 = S12_r
        rres.inliers = inl_r
        if not bool(rres.ok):
            _loop_dbg(f"[loop] sim3 kf={kf_id}<->{cand}: RANSAC failed "
                      f"({n_bow} pairs, best {int(rres.n_inliers)} inl)")
            import os
            dump = os.environ.get("LOOP_DUMP", "")
            if (dump and not os.path.exists(dump)
                    and kf_id >= int(os.environ.get("LOOP_DUMP_MIN_KF", "0"))):
                p2d = obs2[res.idx]
                X2d = m.pt_pos[jnp.clip(p2d, 0, pmax - 1)]
                np.savez(dump, Xc1=np.asarray(Xc1),
                         Xc2=np.asarray(geo.transform_points(T2, X2d)),
                         uv1=np.asarray(uv1),
                         uv2=np.asarray(m.kf_xy[k2][res.idx]),
                         oct1=np.asarray(m.kf_octave[k1]),
                         oct2=np.asarray(m.kf_octave[k2][res.idx]),
                         pair_ok=np.asarray(pair_ok),
                         T1=np.asarray(T1), T2=np.asarray(T2),
                         kf_id=kf_id, cand=cand)
                _loop_dbg(f"[loop] dumped failing sim3 problem to {dump}")
            return False, None
        # SearchBySim3 (src/ORBmatcher.cc:1102, called at LoopClosing.cc:323):
        # widen the correspondence set by mutual projection agreement under
        # the RANSAC Sim3, then re-run the Sim3 optimization on the union.
        j_guided, guided_ok = _sim3_guided_pairs(
            m, k1, k2, rres.S12, cfg
        )
        bow_pair_ok = pair_ok & rres.inliers
        j_union = jnp.where(bow_pair_ok, res.idx, j_guided)
        union_ok = bow_pair_ok | (
            guided_ok
            & ~bow_pair_ok
            & m.kf_feat_valid[k1]
            & (p1 >= 0)
            & m.pt_valid[jnp.clip(p1, 0, pmax - 1)]
        )
        p2u = obs2[j_union]
        union_ok = union_ok & (p2u >= 0) & m.pt_valid[jnp.clip(p2u, 0, pmax - 1)]
        X2w_u = m.pt_pos[jnp.clip(p2u, 0, pmax - 1)]
        Xc2_u = geo.transform_points(T2, X2w_u)
        uv2_u = m.kf_xy[k2][j_union]
        inv_s2_1 = 1.0 / sigma2[jnp.clip(m.kf_octave[k1], 0, cfg.n_levels - 1)]
        inv_s2_2 = 1.0 / sigma2[
            jnp.clip(m.kf_octave[k2][j_union], 0, cfg.n_levels - 1)
        ]
        ores = optim.sim3_optimize(
            rres.S12, Xc1, Xc2_u, uv1, uv2_u,
            inv_s2_1, inv_s2_2, union_ok,
            cfg.K, cfg.K, fix_scale=fix_scale,
        )
        if int(ores.n_inliers) < C.LOOP_MIN_INLIERS_SIM3:
            _loop_dbg(f"[loop] sim3 kf={kf_id}<->{cand}: opt inliers {int(ores.n_inliers)} < {C.LOOP_MIN_INLIERS_SIM3}")
            return False, None
        # final acceptance (LoopClosing.cc:352-398): project the loop
        # neighborhood's points into the current KF under the corrected
        # Scw and require >= 40 total matched features.
        n_total = int(
            _count_loop_matches(
                m, k1, k2, ores.S12, union_ok & ores.inliers, j_union, cfg
            )
        )
        if n_total < C.LOOP_MIN_TOTAL_MATCHES:
            _loop_dbg(f"[loop] sim3 kf={kf_id}<->{cand}: total matches {n_total} < {C.LOOP_MIN_TOTAL_MATCHES}")
            return False, None
        return True, ores.S12

    # ------------------------------------------------------------------
    def _correct_loop(self, kf_id: int, cand: int, S12):
        """CorrectLoop (src/LoopClosing.cc:402-643)."""
        cfg = self.cfg
        trk = self.tracker
        # the reference stops LocalMapping before correcting
        # (RequestStop + spin, src/LoopClosing.cc:408-423); here: drain
        # the chunked mapper machine so no in-flight BA window scatters
        # pre-correction poses over the corrected map
        drain = getattr(trk, "_drain_mapper", None)
        if drain is not None:
            drain()
        m = trk.map
        kmax = cfg.max_keyframes

        # corrected Sim3 of the current KF: Scw = S12 * T_cand_w
        T_cand = m.kf_pose[jnp.asarray(cand)]
        S_cw_corr = S12 @ T_cand
        T_cur = m.kf_pose[jnp.asarray(kf_id)]
        # correction magnitude diagnostics (LOOP_DEBUG)
        delta = np.asarray(S_cw_corr @ geo.inv_T(T_cur))
        dR = delta[:3, :3]
        ds_scale = float(np.cbrt(max(np.linalg.det(dR), 1e-12)))
        ang = float(np.degrees(np.arccos(
            np.clip((np.trace(dR / ds_scale) - 1) / 2, -1, 1))))
        _loop_dbg(f"[loop] correction kf={kf_id}: |t|="
                  f"{np.linalg.norm(delta[:3, 3]):.4f}m rot={ang:.2f}deg "
                  f"scale={ds_scale:.4f}")

        # build Sim3 estimates for every KF (scale 1 on their SE3 poses);
        # keep the PRE-correction poses for the essential graph's edge
        # measurements (NonCorrectedSim3)
        S0 = m.kf_pose
        poses_before = m.kf_pose
        # propagate correction to the current covisibility neighborhood:
        # S_i_corr = (T_i T_cur^-1) S_cw_corr  (src/LoopClosing.cc:443-474)
        w = np.asarray(ms.covisibility_weights(m, jnp.asarray(kf_id)))
        neigh = set(np.where(w >= C.COVIS_MIN_WEIGHT)[0].tolist()) | {kf_id}
        neigh_mask = np.zeros(kmax, bool)
        neigh_mask[list(neigh)] = True
        rel = jnp.einsum(
            "kij,jl->kil", m.kf_pose, geo.inv_T(T_cur)
        )  # T_i T_cur^-1
        S_corr_all = jnp.einsum("kij,jl->kil", rel, S_cw_corr)
        S_init = jnp.where(
            jnp.asarray(neigh_mask)[:, None, None], S_corr_all, S0
        )

        # correct the neighborhood's points before the graph opt
        # (p_corr = S_corr^-1 * S_old * p), then fuse loop duplicates
        m = _correct_points(m, jnp.asarray(neigh_mask), S_init)
        m = m._replace(
            kf_pose=jnp.where(
                jnp.asarray(neigh_mask)[:, None, None],
                _sim3_to_se3(S_init),
                m.kf_pose,
            )
        )
        trk.map = m
        # SearchAndFuse (src/LoopClosing.cc:587-643): project the LOOP
        # NEIGHBORHOOD's points (cand + its covisible KFs — the reference's
        # mvpLoopMapPoints) into EVERY corrected keyframe at radius 4; on
        # duplicates the loop point replaces the local one
        wl = np.asarray(ms.covisibility_weights(m, jnp.asarray(cand)))
        loop_kfs = [cand] + np.where(wl >= C.COVIS_MIN_WEIGHT)[0].tolist()
        obs = np.asarray(m.kf_obs[jnp.asarray(loop_kfs)]).ravel()
        pt_valid_np = np.asarray(m.pt_valid)
        lp = np.unique(obs[obs >= 0])
        lp = lp[pt_valid_np[lp]]
        cap = 4096
        if len(lp) > cap:
            print(f"[loop_closing] WARNING: loop neighborhood has {len(lp)} "
                  f"points; fusing only the first {cap} into corrected KFs")
        lp_vec = np.full(cap, -1, np.int64)
        lp_vec[: min(len(lp), cap)] = lp[:cap]
        lp_dev = jnp.asarray(lp_vec, jnp.int32)
        for nb in sorted(neigh):
            m, _ = fuse_point_set_into_keyframe(
                m, lp_dev, jnp.asarray(int(nb)), cfg
            )
        trk.map = m

        # essential graph: spanning tree + strong covis + the new loop edge
        # + every previously accepted loop edge (src/Optimizer.cc:902-910)
        ei, ej, Sji, valid_edges = _essential_edges(
            m, poses_before, trk.n_kfs, kf_id, cand, S12, self.loop_edges,
            topc=cfg.essential_topc,
        )
        self.loop_edges.append((cand, kf_id, np.asarray(S12)))
        # dense [7K,7K] Cholesky wins below a few hundred KFs; past that
        # the edge-indexed PCG solver is the only tractable option
        # (KITTI-00 scale, see essential_graph_optimize_sparse)
        if kmax <= 320:
            res = optim.essential_graph_optimize(
                m.kf_pose,
                m.kf_valid,
                jnp.asarray(np.arange(kmax) == cand),
                ei, ej, Sji, valid_edges,
                fix_scale=cfg.sensor != MONOCULAR,
            )
        else:
            # PCG must propagate the loop correction across the whole
            # spanning chain: depth ~ graph diameter, so scale with K
            # (static per capacity tier -> bounded recompiles)
            res = optim.essential_graph_optimize_sparse(
                m.kf_pose,
                m.kf_valid,
                jnp.asarray(np.arange(kmax) == cand),
                ei, ej, Sji, valid_edges,
                fix_scale=cfg.sensor != MONOCULAR,
                cg_iters=min(2 * kmax, 2400),
            )
        # recover SE3 poses (t /= s) and remap points via their reference KF
        S_new = res.S
        if _loop_dbg_on():
            dt_g = np.linalg.norm(
                np.asarray(S_new[:, :3, 3] - m.kf_pose[:, :3, 3]), axis=1)
            dt_g = dt_g[np.asarray(m.kf_valid)]
            _loop_dbg(f"[loop] essential graph: cost={float(res.cost):.3f} "
                      f"pose delta t p50={np.percentile(dt_g, 50):.4f} "
                      f"max={dt_g.max():.4f}m")
        m = _remap_points_after_graph(m, S_new)
        m = m._replace(kf_pose=jnp.where(
            m.kf_valid[:, None, None], _sim3_to_se3(S_new), m.kf_pose
        ))
        trk.map = m
        # full-map BA after the graph optimization (LoopClosing.cc:575-579
        # launches RunGlobalBundleAdjustment on a transient thread). A new
        # loop correction aborts any GBA still in flight
        # (src/LoopClosing.cc:410-423).
        self._bg = None
        if self.run_global_ba:
            if self.gba_background:
                self._start_background_gba(m)
            else:
                trk.map = m = _global_ba_kernel(m, cfg)
        # keep the tracker's host mirrors consistent
        trk.last_Tcw = np.asarray(m.kf_pose[jnp.asarray(kf_id)])
        trk.velocity = None
        if trk.ds is not None:
            # the fused pipeline's device pose must jump with the map
            trk.ds = trk.ds._replace(
                T_last=jnp.array(trk.last_Tcw, jnp.float32),
                have_vel=jnp.asarray(False),
            )

    # -- chunked background GBA (P2/P6 equivalent) ----------------------
    def _start_background_gba(self, m: ms.MapState):
        cfg = self.cfg
        prob, inv_s2 = _build_gba_problem(m, cfg)
        carry = optim.gba_init_carry(prob, inv_s2, cfg.K, cfg.bf)
        # prob.cam_valid/pt_valid are already donation-safe copies
        self._bg = [prob, inv_s2, carry, 0, prob.cam_valid, prob.pt_valid,
                    getattr(self.tracker, "compaction_epoch", 0)]

    def pump_background(self) -> bool:
        """Advance a pending background GBA by ONE bounded device chunk
        (one LM iteration). Called once per tracked frame by System; the
        chunk program interleaves with frame programs in the device queue,
        so the worst-case per-frame stall is one chunk, not the whole GBA.
        Returns True while a GBA is in flight. Also harvests any queued
        loop detection whose pulls completed (see process())."""
        self._pump_count += 1
        if self._detect_q:
            self._drain_detect(force=False)  # closure counters updated inside
        if self._bg is None:
            return False
        prob, inv_s2, carry, it, snap_kf, snap_pt, _se = self._bg
        cfg = self.cfg
        carry = optim.gba_chunk(
            prob, inv_s2, carry, jnp.asarray(it, jnp.int32),
            cfg.K, cfg.bf, n_iters=1,
        )
        it += 1
        self._bg[2] = carry
        self._bg[3] = it
        if it >= C.GBA_ITERS:
            self._apply_background()
            return False
        return True

    def finish_background(self):
        """Run any remaining chunks to completion (shutdown / trajectory
        save / map save: the reference waits for the GBA thread the same
        way, src/System.cc:312-316). Queued loop detections are forced
        through first — a closure launches a fresh GBA that then also
        completes here."""
        self._drain_detect(force=True)
        while self._bg is not None:
            self.pump_background()

    def abort_background(self):
        self._bg = None
        for q_kf, _, _, _ in self._detect_q:
            self.tracker.set_kf_erasable(q_kf)
        self._detect_q.clear()

    def _apply_background(self):
        prob, inv_s2, carry, it, snap_kf, snap_pt, snap_epoch = self._bg
        self._bg = None
        trk0 = self.tracker
        trk0._flush_all()
        if getattr(trk0, "compaction_epoch", 0) != snap_epoch:
            # the point arena was compacted (slots renumbered) while the
            # GBA chunks were in flight: the snapshot's point ids no
            # longer address the same landmarks — discard, as the
            # reference's mbStopGBA discards a GBA the map moved under
            # (src/LoopClosing.cc:410-423)
            print("[loop] background GBA discarded: point arena compacted "
                  "mid-flight", flush=True)
            return
        cfg = self.cfg
        trk = self.tracker
        res = optim.gba_result(prob, inv_s2, cfg.K, cfg.bf, carry)
        trk._flush_all()
        m = trk.map
        # the map may have GROWN to a larger capacity tier while the GBA
        # chunks were in flight; pad the snapshot-shaped results up to the
        # current shapes (new slots: not-in-snapshot -> spanning-tree /
        # ref-KF catch-up handles them like any mid-GBA creation)
        kmax = m.kf_pose.shape[0]
        pmax = m.pt_pos.shape[0]
        cam_T, pts = res.cam_T, res.pts
        if cam_T.shape[0] < kmax:
            pad = kmax - cam_T.shape[0]
            cam_T = jnp.concatenate(
                [cam_T, jnp.tile(jnp.eye(4), (pad, 1, 1))])
            snap_kf = jnp.concatenate([snap_kf, jnp.zeros(pad, bool)])
        if pts.shape[0] < pmax:
            pad = pmax - pts.shape[0]
            pts = jnp.concatenate([pts, jnp.zeros((pad, 3))])
            snap_pt = jnp.concatenate([snap_pt, jnp.zeros(pad, bool)])
        ref = trk.ref_kf if trk.ref_kf >= 0 else 0
        T_ref_old = np.asarray(m.kf_pose[jnp.asarray(ref)])
        m = _apply_gba_kernel(m, cam_T, pts, snap_kf, snap_pt)
        trk.map = m
        # carry the tracker's pose across the map jump: keep the pose
        # relative to the reference KF fixed (Tcr * T_ref_new — the same
        # relative-pose bridge the trajectory saver uses)
        if trk.last_Tcw is not None:
            T_ref_new = np.asarray(m.kf_pose[jnp.asarray(ref)])
            Tcr = trk.last_Tcw @ np.linalg.inv(T_ref_old)
            trk.last_Tcw = Tcr @ T_ref_new
        trk.velocity = None
        if trk.ds is not None:
            trk.ds = trk.ds._replace(
                T_last=jnp.array(trk.last_Tcw, jnp.float32)
                if trk.last_Tcw is not None else trk.ds.T_last,
                have_vel=jnp.asarray(False),
            )


@functools.partial(jax.jit, static_argnames=("cfg",))
def _sim3_guided_pairs(m, k1, k2, S12, cfg: SlamConfig):
    """SearchBySim3 (src/ORBmatcher.cc:1102-1326): project each KF's
    landmarks into the other camera under the Sim3 and keep pairs on which
    the two directed searches agree. Returns ([N] int32 kf2-feature index
    per kf1 feature, [N] bool)."""
    pmax = cfg.max_points
    scale_factors = jnp.asarray(cfg.orb.scales)
    T1, T2 = m.kf_pose[k1], m.kf_pose[k2]
    p1, p2 = m.kf_obs[k1], m.kf_obs[k2]
    X1 = m.pt_pos[jnp.clip(p1, 0, pmax - 1)]
    X2 = m.pt_pos[jnp.clip(p2, 0, pmax - 1)]
    ok1 = m.kf_feat_valid[k1] & (p1 >= 0) & m.pt_valid[jnp.clip(p1, 0, pmax - 1)]
    ok2 = m.kf_feat_valid[k2] & (p2 >= 0) & m.pt_valid[jnp.clip(p2, 0, pmax - 1)]
    S21 = geo.inv_T(S12)
    # KF2 landmarks -> camera 1 (sR embedded in the 4x4 keeps depth sign)
    Xc1_of_2 = geo.transform_points(S12, geo.transform_points(T2, X2))
    uv_in1 = geo.project(cfg.K, Xc1_of_2)
    # KF1 landmarks -> camera 2
    Xc2_of_1 = geo.transform_points(S21, geo.transform_points(T1, X1))
    uv_in2 = geo.project(cfg.K, Xc2_of_1)
    h, w = cfg.height, cfg.width
    inb = lambda uv, z: (
        (z > 0.0)
        & (uv[:, 0] >= 0) & (uv[:, 0] < w)
        & (uv[:, 1] >= 0) & (uv[:, 1] < h)
    )
    # th=7.5, octave-scaled radius, TH_HIGH, no ratio test — the
    # reference's SearchBySim3 parameters
    r21 = matching.match_projection(
        proj_xy=uv_in1,
        proj_valid=ok2 & inb(uv_in1, Xc1_of_2[:, 2]),
        proj_desc=m.kf_desc[k2],
        proj_octave=m.kf_octave[k2],
        feats=_feats_of(m, k1),
        radius=7.5,
        scale_factors=scale_factors,
        max_dist=float(C.TH_HIGH),
        nn_ratio=None,
    )
    r12 = matching.match_projection(
        proj_xy=uv_in2,
        proj_valid=ok1 & inb(uv_in2, Xc2_of_1[:, 2]),
        proj_desc=m.kf_desc[k1],
        proj_octave=m.kf_octave[k1],
        feats=_feats_of(m, k2),
        radius=7.5,
        scale_factors=scale_factors,
        max_dist=float(C.TH_HIGH),
        nn_ratio=None,
    )
    # agreement: feature i of KF1 matched j (r12), and j's projection
    # matched back to i (r21) — ORBmatcher.cc:1300-1322
    n = p1.shape[0]
    j = jnp.clip(r12.idx, 0, n - 1)
    agree = r12.ok & r21.ok[j] & (r21.idx[j] == jnp.arange(n))
    return jnp.where(agree, j, -1), agree


@functools.partial(jax.jit, static_argnames=("cfg",))
def _count_loop_matches(m, k1, k2, S12, sim3_ok, j_union, cfg: SlamConfig):
    """Acceptance count (LoopClosing.cc:352-398): project every landmark
    of the loop KF's covisibility group into the current KF under the
    corrected Scw = S12 T2w (SearchByProjection(KF, Scw, ...) with th=10)
    and count current-KF features matched either way."""
    pmax = cfg.max_points
    kmax = cfg.max_keyframes
    # loop group = candidate + its covisible neighbors (weight >= 15)
    wts = ms.covisibility_weights(m, k2)
    group = (wts >= C.COVIS_MIN_WEIGHT) & m.kf_valid
    group = group.at[k2].set(True)
    obs = jnp.clip(m.kf_obs, 0, pmax - 1)
    contributes = group[:, None] & (m.kf_obs >= 0) & m.kf_feat_valid
    loop_pt = (
        jnp.zeros(pmax, bool).at[obs.reshape(-1)].max(contributes.reshape(-1))
        & m.pt_valid
    )
    Scw = S12 @ m.kf_pose[k2]
    Xc = geo.transform_points(Scw, m.pt_pos)
    uv = geo.project(cfg.K, Xc)
    h, w = cfg.height, cfg.width
    vis = (
        loop_pt
        & (Xc[:, 2] > 0.0)
        & (uv[:, 0] >= 0) & (uv[:, 0] < w)
        & (uv[:, 1] >= 0) & (uv[:, 1] < h)
    )
    res = matching.match_projection(
        proj_xy=uv,
        proj_valid=vis,
        proj_desc=m.pt_desc,
        proj_octave=jnp.zeros(pmax, jnp.int32),
        feats=_feats_of(m, k1),
        radius=10.0,
        scale_factors=jnp.asarray(cfg.orb.scales),
        max_dist=float(C.TH_LOW),
        nn_ratio=None,
        octave_band=(0, cfg.n_levels),
    )
    n = m.kf_obs.shape[1]
    matched_feat = jnp.zeros(n, bool).at[
        jnp.clip(res.idx, 0, n - 1)
    ].max(res.ok)
    matched_feat = matched_feat | sim3_ok
    return jnp.sum(matched_feat)


def _build_gba_problem(m: ms.MapState, cfg: SlamConfig):
    """Assemble the full-map BAProblem (every valid KF, KF 0 fixed, every
    valid landmark) + per-level information weights from a MapState
    snapshot (Optimizer::GlobalBundleAdjustemnt vertex/edge construction,
    src/Optimizer.cc:49-172). Deliberately NOT jitted with donation: the
    snapshot must leave the live map alone — tracking keeps running on it
    while the background GBA chunks away."""
    kmax = m.kf_pose.shape[0]
    pmax = m.pt_pos.shape[0]
    n = m.kf_obs.shape[1]
    obs_pt_raw = m.kf_obs.reshape(-1)
    obs_pt = jnp.clip(obs_pt_raw, 0, pmax - 1)
    obs_valid = (
        (obs_pt_raw >= 0)
        & m.kf_feat_valid.reshape(-1)
        & jnp.repeat(m.kf_valid, n)
        & m.pt_valid[obs_pt]
    )
    prob = optim.BAProblem(
        # copies, not aliases: the snapshot must survive the fused
        # tracking kernels DONATING (and thus deleting) the live map
        # buffers while background GBA chunks are in flight (the
        # donated-buffer rule — see Tracker._sync_ds_from_host)
        cam_T=jnp.array(m.kf_pose, copy=True),
        cam_fixed=jnp.arange(kmax) == 0,
        cam_valid=jnp.array(m.kf_valid, copy=True),
        pts=jnp.array(m.pt_pos, copy=True),
        pt_valid=jnp.array(m.pt_valid, copy=True),
        obs_cam=jnp.repeat(jnp.arange(kmax, dtype=jnp.int32), n),
        obs_pt=obs_pt,
        obs_uvr=jnp.concatenate(
            [m.kf_xy, m.kf_uright[..., None]], axis=-1
        ).reshape(-1, 3),
        obs_oct=m.kf_octave.reshape(-1),
        obs_stereo=(m.kf_uright >= 0).reshape(-1),
        obs_valid=obs_valid,
    )
    inv_s2 = 1.0 / jnp.asarray(
        [cfg.scale_factor ** (2 * l) for l in range(cfg.n_levels)]
    )
    return prob, inv_s2


def _global_ba_kernel(m: ms.MapState, cfg: SlamConfig):
    """Synchronous full-map BA after a loop closure
    (RunGlobalBundleAdjustment, src/LoopClosing.cc:645-737), solved by the
    matrix-free Schur/PCG engine. The chunked/interruptible variant is
    BackgroundGBA below; this path remains for gba_background=False and
    for tests that need the correction applied immediately."""
    kmax = m.kf_pose.shape[0]
    prob, inv_s2 = _build_gba_problem(m, cfg)
    res = optim.global_bundle_adjustment(
        prob, inv_s2, cfg.K, cfg.bf, iters=C.GBA_ITERS
    )
    write_cam = m.kf_valid & (jnp.arange(kmax) != 0)
    return m._replace(
        kf_pose=jnp.where(write_cam[:, None, None], res.cam_T, m.kf_pose),
        pt_pos=jnp.where(m.pt_valid[:, None], res.pts, m.pt_pos),
    )


@jax.jit
def _apply_gba_kernel(m: ms.MapState, cam_T, pts, snap_kf, snap_pt):
    """Write a (possibly chunked/backgrounded) GBA result into the CURRENT
    map with the reference's catch-up reconciliation
    (src/LoopClosing.cc:676-737): KFs created during GBA are corrected
    through the spanning tree (Tcw_new = Tcw_old Twc_parent_old
    Tcw_parent_new, parents first), points created during GBA are remapped
    through their reference KF's pose change."""
    kmax = m.kf_pose.shape[0]
    pmax = m.pt_pos.shape[0]
    old_pose = m.kf_pose
    in_snap = snap_kf & m.kf_valid
    base = jnp.where(
        (in_snap & (jnp.arange(kmax) != 0))[:, None, None], cam_T, old_pose
    )

    # spanning-tree catch-up for post-snapshot KFs, in slot order (parents
    # precede children in slot order by construction of KF creation)
    def walk(pose_new, k):
        p = jnp.clip(m.kf_parent[k], 0, kmax - 1)
        has_parent = m.kf_parent[k] >= 0
        corr = old_pose[k] @ geo.inv_T(old_pose[p]) @ pose_new[p]
        is_new = m.kf_valid[k] & ~snap_kf[k] & has_parent
        pose_new = pose_new.at[k].set(
            jnp.where(is_new, corr, pose_new[k])
        )
        return pose_new, None

    new_pose, _ = jax.lax.scan(walk, base, jnp.arange(kmax))

    # points: snapshot points take the GBA positions; newer points are
    # remapped through their reference KF (mnBAGlobalForKF catch-up,
    # src/LoopClosing.cc:715-736)
    ref = jnp.clip(m.pt_ref_kf, 0, kmax - 1)
    Xc = jnp.einsum(
        "pij,pj->pi", old_pose[ref][:, :3, :3], m.pt_pos
    ) + old_pose[ref][:, :3, 3]
    Tinv = jax.vmap(geo.inv_T)(new_pose)[ref]
    X_remap = jnp.einsum("pij,pj->pi", Tinv[:, :3, :3], Xc) + Tinv[:, :3, 3]
    in_snap_pt = snap_pt & m.pt_valid
    new_pts = jnp.where(
        in_snap_pt[:, None], pts,
        jnp.where(m.pt_valid[:, None], X_remap, m.pt_pos),
    )
    return m._replace(kf_pose=new_pose, pt_pos=new_pts)


def _feats_of(m, k):
    from orb_slam2_comment_tpu.ops.orb import FrameFeatures

    return FrameFeatures(
        xy=m.kf_xy[k],
        response=jnp.zeros_like(m.kf_angle[k]),
        angle=m.kf_angle[k],
        octave=m.kf_octave[k],
        desc=m.kf_desc[k],
        valid=m.kf_feat_valid[k],
    )


def _sim3_to_se3(S):
    """[K,4,4] Sim3 -> SE3 by dividing translation by scale
    (src/Optimizer.cc:991-1010 'recover SE3 with t/=s')."""
    s = geo.sim3_scale(S)
    R = S[..., :3, :3] / s[..., None, None]
    t = S[..., :3, 3] / s[..., None]
    return geo.make_T(R, t)


def _correct_points(m, neigh_mask, S_corr):
    """Transform points of the corrected neighborhood:
    p' = S_corr_ref^-1 * T_old_ref * p (src/LoopClosing.cc:476-512)."""
    pmax = m.pt_pos.shape[0]
    kmax = m.kf_pose.shape[0]
    ref = jnp.clip(m.pt_ref_kf, 0, kmax - 1)
    in_neigh = neigh_mask[ref] & m.pt_valid
    T_old = m.kf_pose[ref]
    S_new = S_corr[ref]
    Xc = jnp.einsum("pij,pj->pi", T_old[:, :3, :3], m.pt_pos) + T_old[:, :3, 3]
    Sinv = geo.inv_T(S_new)
    Xw = jnp.einsum("pij,pj->pi", Sinv[:, :3, :3], Xc) + Sinv[:, :3, 3]
    return m._replace(
        pt_pos=jnp.where(in_neigh[:, None], Xw, m.pt_pos)
    )


def _remap_points_after_graph(m, S_new):
    """Remap every point through its reference KF's pose change
    (src/Optimizer.cc:1012-1043)."""
    kmax = m.kf_pose.shape[0]
    ref = jnp.clip(m.pt_ref_kf, 0, kmax - 1)
    T_old = m.kf_pose[ref]
    Xc = jnp.einsum("pij,pj->pi", T_old[:, :3, :3], m.pt_pos) + T_old[:, :3, 3]
    Sinv = geo.inv_T(S_new[ref])
    Xw = jnp.einsum("pij,pj->pi", Sinv[:, :3, :3], Xc) + Sinv[:, :3, 3]
    return m._replace(pt_pos=jnp.where(m.pt_valid[:, None], Xw, m.pt_pos))


@functools.partial(jax.jit, static_argnames=("topc",))
def _essential_edges_kernel(m, meas_poses, loop_a, loop_b, loop_ok, cand,
                            kf_id, S12, topc: int = 32):
    """Edge sets of the essential graph as ONE device program
    (src/Optimizer.cc:851-983): spanning-tree edges, per-KF top-`topc`
    covisibility edges with weight >= ESSENTIAL_MIN_WEIGHT (the reference
    takes all such edges; >32 per KF is unseen in practice), previously
    accepted loop edges (with their CURRENT relative pose, as the
    reference uses current estimates for all but the new constraint), and
    the new loop edge with its measured Sim3. Covisibility for all pairs
    is one chunked matmul (ms.covisibility_matrix) instead of O(K)
    per-KF device calls.
    """
    kmax = m.kf_pose.shape[0]
    # Edge MEASUREMENTS come from meas_poses — the poses BEFORE the loop
    # correction (the reference's NonCorrectedSim3, src/Optimizer.cc:
    # 851-983). The optimization initializes from the CORRECTED map, so
    # boundary edges (corrected neighborhood <-> untouched trajectory)
    # carry the loop's residual and the solver distributes the correction
    # along the spanning chain. Building measurements from the corrected
    # poses made every residual zero and the graph a no-op (r4 room_loop:
    # cost=0.000, pose delta 0, ATE stuck at drift level).
    poses = meas_poses
    inv_poses = jax.vmap(geo.inv_T)(poses)

    def rel_of(i, j):  # pose[j] @ inv(pose[i]), batched
        return jnp.einsum("eij,ejl->eil", poses[j], inv_poses[i])

    # spanning tree: (parent, k)
    st_j = jnp.arange(kmax, dtype=jnp.int32)
    st_i = jnp.clip(m.kf_parent, 0, kmax - 1)
    st_ok = (m.kf_parent >= 0) & m.kf_valid

    # strong covisibility, deduped to j > i, minus spanning-tree pairs and
    # the new loop pair (sInsertedEdges dedup, src/Optimizer.cc:887-930)
    W = ms.covisibility_matrix(m)
    upper = jnp.arange(kmax)[None, :] > jnp.arange(kmax)[:, None]
    is_parent = jnp.zeros((kmax, kmax), bool).at[
        st_i, st_j
    ].set(st_ok).at[st_j, st_i].set(st_ok)
    lo = jnp.minimum(cand, kf_id)
    hi = jnp.maximum(cand, kf_id)
    Wm = jnp.where(
        upper & ~is_parent & (W >= C.ESSENTIAL_MIN_WEIGHT), W, 0
    )
    Wm = Wm.at[lo, hi].set(0)
    # past loop-edge pairs are inserted explicitly below — zero them out of
    # the covisibility candidates too, or they'd be double-counted (the
    # reference dedups every inserted edge via sInsertedEdges,
    # src/Optimizer.cc:887-930). Invalid slots are clipped to (0,0), a
    # diagonal entry that `upper` already zeroed.
    la_ = jnp.clip(loop_a, 0, kmax - 1)
    lb_ = jnp.clip(loop_b, 0, kmax - 1)
    Wm = Wm.at[jnp.minimum(la_, lb_), jnp.maximum(la_, lb_)].set(
        jnp.zeros((), Wm.dtype))
    topc = min(topc, kmax)
    vals, idxs = jax.lax.top_k(Wm, topc)            # [K, topc]
    cv_i = jnp.repeat(jnp.arange(kmax, dtype=jnp.int32), topc)
    cv_j = idxs.reshape(-1).astype(jnp.int32)
    cv_ok = (vals.reshape(-1) >= C.ESSENTIAL_MIN_WEIGHT)
    # saturation diagnostic: KFs whose topc-th candidate still qualifies
    # had covisibility edges silently dropped (the reference takes ALL
    # edges with weight >= 100, src/Optimizer.cc:917)
    n_saturated = jnp.sum(vals[:, topc - 1] >= C.ESSENTIAL_MIN_WEIGHT)

    # past loop edges survive forever (Optimizer.cc:902-910)
    la = jnp.clip(loop_a, 0, kmax - 1)
    lb = jnp.clip(loop_b, 0, kmax - 1)

    # new loop edge: with S12 mapping cand-camera to cur-camera coords,
    # the measured relative Sim3 is exactly S_ji = S_cur_w S_cand_w^-1
    ei = jnp.concatenate([st_i, cv_i, la, cand[None].astype(jnp.int32)])
    ej = jnp.concatenate([st_j, cv_j, lb, kf_id[None].astype(jnp.int32)])
    ok = jnp.concatenate([st_ok, cv_ok, loop_ok, jnp.ones(1, bool)])
    Sji = jnp.concatenate([
        rel_of(st_i, st_j), rel_of(cv_i, cv_j), rel_of(la, lb), S12[None]
    ])
    return ei, ej, Sji, ok, n_saturated


def _essential_edges(m, meas_poses, n_kfs, kf_id, cand, S12,
                     past_loop_edges=(), topc: int = 32):
    """Host wrapper: pack the surviving loop-edge list to a fixed-width
    device array and call the one-kernel edge builder. Logs every silent
    truncation (SURVEY §7 "no silent caps")."""
    cap = 64  # static loop-edge capacity (KITTI 00 closes ~3 loops)
    edges = list(past_loop_edges)
    if len(edges) > cap:
        print(f"[loop_closing] WARNING: {len(edges)} accepted loop edges "
              f"exceed the essential-graph capacity {cap}; the oldest "
              f"{len(edges) - cap} constraints are dropped from this and "
              "future optimizations")
        edges = edges[-cap:]   # keep the most recent constraints
    la = np.zeros(cap, np.int32)
    lb = np.zeros(cap, np.int32)
    lok = np.zeros(cap, bool)
    for i, (a, b, _) in enumerate(edges):
        if a < n_kfs and b < n_kfs:
            la[i], lb[i], lok[i] = a, b, True
    ei, ej, Sji, ok, n_sat = _essential_edges_kernel(
        m, meas_poses, jnp.asarray(la), jnp.asarray(lb), jnp.asarray(lok),
        jnp.asarray(cand, jnp.int32), jnp.asarray(kf_id, jnp.int32),
        jnp.asarray(S12, jnp.float32), topc=topc,
    )
    n_sat = int(n_sat)
    if n_sat:
        print(f"[loop_closing] WARNING: covisibility edges truncated at "
              f"top-{topc} for {n_sat} keyframes (qualifying edges dropped; "
              "raise cfg.essential_topc — reference takes all >=100-weight "
              "edges, src/Optimizer.cc:917)")
    return ei, ej, Sji, ok
