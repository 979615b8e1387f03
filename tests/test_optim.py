"""Solver tests: pose-only BA, local BA with Schur, Sim3, pose graph."""

import jax.numpy as jnp
import numpy as np

from orb_slam2_comment_tpu.ops import geometry as geo
from orb_slam2_comment_tpu.ops import optim

K = (500.0, 500.0, 320.0, 240.0)
BF = 150.0
INV_S2 = jnp.asarray([1.0 / (1.2 ** (2 * l)) for l in range(8)]) ** -1  # placeholder
INV_SIGMA2 = jnp.asarray([1.0 / (1.2 ** (2 * l)) for l in range(8)])


def _pose_err(Ta, Tb):
    d = np.asarray(geo.se3_log(jnp.asarray(Ta) @ geo.inv_T(jnp.asarray(Tb))))
    return np.linalg.norm(d)


def _make_pose(xi):
    return np.asarray(geo.se3_exp(jnp.asarray(xi, jnp.float32)))


class TestPoseOptimize:
    def _problem(self, n=200, noise=0.5, outliers=0, stereo=True, seed=0):
        r = np.random.default_rng(seed)
        X = r.uniform(-3, 3, (n, 3)).astype(np.float32) + [0, 0, 8]
        T_gt = _make_pose([0.2, -0.1, 0.3, 0.02, -0.04, 0.03])
        Xc = np.asarray(geo.transform_points(jnp.asarray(T_gt), jnp.asarray(X)))
        uvr = np.array(geo.project_stereo(K, BF, jnp.asarray(Xc)))
        uvr += r.normal(0, noise, uvr.shape).astype(np.float32)
        is_st = np.full(n, stereo)
        valid = np.ones(n, bool)
        if outliers:
            idx = r.choice(n, outliers, replace=False)
            uvr[idx, :2] += r.uniform(20, 60, (outliers, 2)) * r.choice([-1, 1], (outliers, 2))
        return T_gt, X, uvr, is_st, valid

    def test_converges_from_perturbed(self):
        T_gt, X, uvr, is_st, valid = self._problem()
        T0 = _make_pose([0.25, -0.05, 0.45, 0.05, -0.01, 0.06])  # off by a lot
        res = optim.pose_optimize(
            jnp.asarray(T0), jnp.asarray(X), jnp.asarray(uvr),
            jnp.zeros(len(X), jnp.int32), jnp.asarray(is_st), jnp.asarray(valid),
            INV_SIGMA2, K, BF,
        )
        assert _pose_err(np.asarray(res.Tcw), T_gt) < 0.01
        assert int(res.n_inliers) > 180

    def test_rejects_outliers(self):
        T_gt, X, uvr, is_st, valid = self._problem(outliers=40)
        T0 = _make_pose([0.22, -0.08, 0.35, 0.03, -0.03, 0.04])
        res = optim.pose_optimize(
            jnp.asarray(T0), jnp.asarray(X), jnp.asarray(uvr),
            jnp.zeros(len(X), jnp.int32), jnp.asarray(is_st), jnp.asarray(valid),
            INV_SIGMA2, K, BF,
        )
        assert _pose_err(np.asarray(res.Tcw), T_gt) < 0.02
        n_in = int(res.n_inliers)
        assert 140 < n_in <= 165, n_in  # the 40 gross outliers excluded

    def test_mono_edges(self):
        T_gt, X, uvr, _, valid = self._problem(noise=0.3)
        T0 = _make_pose([0.18, -0.12, 0.33, 0.01, -0.05, 0.02])
        res = optim.pose_optimize(
            jnp.asarray(T0), jnp.asarray(X), jnp.asarray(uvr),
            jnp.zeros(len(X), jnp.int32), jnp.zeros(len(X), bool),
            jnp.asarray(valid), INV_SIGMA2, K, BF,
        )
        assert _pose_err(np.asarray(res.Tcw), T_gt) < 0.02


class TestLocalBA:
    def _problem(self, n_cam=6, n_pt=150, noise=0.4, seed=1):
        r = np.random.default_rng(seed)
        X_gt = r.uniform(-4, 4, (n_pt, 3)).astype(np.float32) + [0, 0, 10]
        cams_gt = []
        for i in range(n_cam):
            xi = np.array([0.4 * i, 0.02 * i, 0.05 * i, 0.0, 0.03 * i, 0.0], np.float32)
            cams_gt.append(_make_pose(xi))
        cams_gt = np.stack(cams_gt)
        obs_cam, obs_pt, obs_uvr = [], [], []
        for c in range(n_cam):
            Xc = np.asarray(geo.transform_points(jnp.asarray(cams_gt[c]), jnp.asarray(X_gt)))
            uvr = np.array(geo.project_stereo(K, BF, jnp.asarray(Xc)))
            uvr += r.normal(0, noise, uvr.shape).astype(np.float32)
            vis = (
                (Xc[:, 2] > 1) & (uvr[:, 0] > 0) & (uvr[:, 0] < 640)
                & (uvr[:, 1] > 0) & (uvr[:, 1] < 480)
            )
            for p in np.where(vis)[0]:
                obs_cam.append(c)
                obs_pt.append(p)
                obs_uvr.append(uvr[p])
        O = len(obs_cam)
        prob = optim.BAProblem(
            cam_T=jnp.asarray(cams_gt),
            cam_fixed=jnp.asarray([True, True] + [False] * (n_cam - 2)),
            cam_valid=jnp.ones(n_cam, bool),
            pts=jnp.asarray(X_gt),
            pt_valid=jnp.ones(n_pt, bool),
            obs_cam=jnp.asarray(obs_cam, jnp.int32),
            obs_pt=jnp.asarray(obs_pt, jnp.int32),
            obs_uvr=jnp.asarray(np.stack(obs_uvr)),
            obs_oct=jnp.zeros(O, jnp.int32),
            obs_stereo=jnp.ones(O, bool),
            obs_valid=jnp.ones(O, bool),
        )
        return prob, cams_gt, X_gt, r

    def test_recovers_perturbation(self):
        prob, cams_gt, X_gt, r = self._problem()
        # perturb free cameras and all points
        cam_T = np.asarray(prob.cam_T).copy()
        for c in range(2, len(cam_T)):
            d = r.normal(0, 0.02, 6).astype(np.float32)
            cam_T[c] = _make_pose(d) @ cam_T[c]
        pts = np.asarray(prob.pts) + r.normal(0, 0.05, X_gt.shape).astype(np.float32)
        prob_pert = prob._replace(cam_T=jnp.asarray(cam_T), pts=jnp.asarray(pts))
        res = optim.local_bundle_adjustment(prob_pert, INV_SIGMA2, K, BF)
        for c in range(2, len(cam_T)):
            before = _pose_err(cam_T[c], cams_gt[c])
            after = _pose_err(np.asarray(res.cam_T[c]), cams_gt[c])
            assert after < before * 0.2, (c, before, after)
        pt_err_before = np.linalg.norm(pts - X_gt, axis=1).mean()
        pt_err_after = np.linalg.norm(np.asarray(res.pts) - X_gt, axis=1).mean()
        assert pt_err_after < pt_err_before * 0.5
        assert bool(np.asarray(res.obs_inlier).mean() > 0.95)

    def test_fixed_cameras_untouched(self):
        prob, cams_gt, _, r = self._problem()
        res = optim.local_bundle_adjustment(prob, INV_SIGMA2, K, BF)
        np.testing.assert_array_equal(np.asarray(res.cam_T[:2]), cams_gt[:2])


class TestSim3:
    def test_recovers_sim3(self):
        r = np.random.default_rng(3)
        n = 80
        zeta_gt = np.array([0.3, -0.2, 0.5, 0.1, -0.05, 0.08, 0.25], np.float32)
        S12_gt = np.asarray(geo.sim3_exp(jnp.asarray(zeta_gt)))
        Xc2 = r.uniform(-2, 2, (n, 3)).astype(np.float32) + [0, 0, 6]
        Xc1 = np.asarray(geo.transform_points(jnp.asarray(S12_gt), jnp.asarray(Xc2)))
        obs1 = np.array(geo.project(K, jnp.asarray(Xc1)))
        obs2 = np.array(geo.project(K, jnp.asarray(Xc2)))
        obs1 += r.normal(0, 0.3, obs1.shape).astype(np.float32)
        obs2 += r.normal(0, 0.3, obs2.shape).astype(np.float32)
        S0 = np.asarray(geo.sim3_exp(jnp.asarray(zeta_gt + r.normal(0, 0.05, 7).astype(np.float32))))
        res = optim.sim3_optimize(
            jnp.asarray(S0), jnp.asarray(Xc1), jnp.asarray(Xc2),
            jnp.asarray(obs1), jnp.asarray(obs2),
            jnp.ones(n), jnp.ones(n), jnp.ones(n, bool), K, K,
        )
        assert int(res.n_inliers) > 70
        s_est = float(geo.sim3_scale(res.S12))
        assert abs(s_est - np.exp(0.25)) < 0.02
        d = np.asarray(geo.sim3_log(res.S12 @ geo.inv_T(jnp.asarray(S12_gt))))
        assert np.linalg.norm(d) < 0.02, d


class TestEssentialGraph:
    def test_corrects_drift(self):
        """Chain with exact relative measurements + a loop edge: the drifted
        estimates should snap back to consistency."""
        r = np.random.default_rng(4)
        n_kf = 12
        # ground truth: poses around a circle (loop!)
        S_gt = []
        for i in range(n_kf):
            th = 2 * np.pi * i / n_kf
            xi = np.array([np.sin(th) * 2, 0, (1 - np.cos(th)) * 2, 0, th, 0], np.float32)
            S_gt.append(np.asarray(geo.se3_exp(jnp.asarray(xi))))
        S_gt = np.stack(S_gt)
        # drifted initial estimates: accumulate noise along the chain
        S_est = [S_gt[0]]
        for i in range(1, n_kf):
            rel_gt = S_gt[i] @ np.linalg.inv(S_gt[i - 1])
            noise = np.asarray(geo.se3_exp(jnp.asarray(
                r.normal(0, 0.02, 6).astype(np.float32))))
            S_est.append(noise @ rel_gt @ S_est[i - 1])
        S_est = np.stack(S_est)
        # edges: consecutive chain (exact relative measurements) + loop edge
        ei, ej, Sji = [], [], []
        for i in range(n_kf - 1):
            ei.append(i)
            ej.append(i + 1)
            Sji.append(S_gt[i + 1] @ np.linalg.inv(S_gt[i]))
        ei.append(n_kf - 1)
        ej.append(0)
        Sji.append(S_gt[0] @ np.linalg.inv(S_gt[n_kf - 1]))
        E = len(ei)
        res = optim.essential_graph_optimize(
            jnp.asarray(S_est),
            jnp.ones(n_kf, bool),
            jnp.asarray([True] + [False] * (n_kf - 1)),
            jnp.asarray(ei, jnp.int32), jnp.asarray(ej, jnp.int32),
            jnp.asarray(np.stack(Sji)),
            jnp.ones(E, bool),
        )
        # relative consistency: every edge residual should be tiny
        S = np.asarray(res.S)
        errs = []
        for k in range(E):
            resid = np.asarray(geo.sim3_log(
                jnp.asarray(Sji[k]) @ jnp.asarray(S[ei[k]]) @ geo.inv_T(jnp.asarray(S[ej[k]]))
            ))
            errs.append(np.linalg.norm(resid))
        assert max(errs) < 5e-3, max(errs)
        # absolute: anchored at kf0, should be near ground truth
        for i in range(n_kf):
            d = np.asarray(geo.sim3_log(jnp.asarray(
                S[i] @ np.linalg.inv(
                    np.asarray(jnp.asarray(S_gt[i]))
                ))))
            assert np.linalg.norm(d) < 0.02, (i, d)


class TestPoseOptimizePallas:
    def test_matches_xla_path(self):
        """The single-kernel Triton LM (interpret mode) must agree with
        the XLA path: same inlier set, pose within float tolerance (both
        use closed-form Jacobians, summed in another order)."""
        import jax.numpy as jnp

        from orb_slam2_comment_tpu.ops import geometry as geo
        from orb_slam2_comment_tpu.ops import optim
        from orb_slam2_comment_tpu.ops.lm_pallas import pose_optimize_pallas

        K = (500.0, 500.0, 320.0, 240.0)
        BF = 50.0
        inv_s2 = jnp.asarray([1.0 / (1.2 ** (2 * l)) for l in range(8)])
        r = np.random.default_rng(3)
        N = 300
        Xw = jnp.asarray(
            r.uniform(-3, 3, (N, 3)).astype(np.float32) + [0, 0, 8]
        )
        T_gt = geo.se3_exp(
            jnp.asarray([0.1, -0.05, 0.08, 0.02, -0.03, 0.01], jnp.float32)
        )
        Xc = geo.transform_points(T_gt, Xw)
        uvr = np.array(geo.project_stereo(K, BF, Xc))
        uvr += r.normal(0, 0.4, uvr.shape)
        # 20% outliers
        out_idx = r.choice(N, N // 5, replace=False)
        uvr[out_idx, :2] += r.uniform(15, 40, (len(out_idx), 2))
        obs = jnp.asarray(uvr.astype(np.float32))
        octave = jnp.asarray(r.integers(0, 4, N).astype(np.int32))
        stereo = jnp.asarray(r.random(N) < 0.7)
        # unassociated slots, some behind the camera: their huge (masked)
        # Jacobians must not poison the normal equations
        valid_np = np.ones(N, bool)
        bad = r.choice(np.setdiff1d(np.arange(N), out_idx), 30,
                       replace=False)
        valid_np[bad] = False
        Xw = Xw.at[bad[:15], 2].set(-5.0)
        valid = jnp.asarray(valid_np)
        T0 = geo.se3_exp(
            jnp.asarray([0.08, -0.04, 0.06, 0.015, -0.02, 0.006], jnp.float32)
        )

        ref = optim.pose_optimize_xla(
            T0, Xw, obs, octave, stereo, valid, inv_s2, K, BF
        )
        got = pose_optimize_pallas(
            T0, Xw, obs, octave, stereo, valid, inv_s2, K, BF,
            interpret=True,
        )
        d = np.asarray(geo.se3_log(got.Tcw @ geo.inv_T(ref.Tcw)))
        assert np.linalg.norm(d) < 2e-3, d
        # both must be close to ground truth
        dg = np.asarray(geo.se3_log(got.Tcw @ geo.inv_T(T_gt)))
        assert np.linalg.norm(dg) < 5e-3, dg
        agree = np.mean(
            np.asarray(got.inliers) == np.asarray(ref.inliers)
        )
        assert agree > 0.98, agree
        # outliers must be rejected
        assert not np.asarray(got.inliers)[out_idx].any()


def test_analytic_edge_jacobians_match_jacfwd():
    """The analytic linearizeOplus (types_six_dof_expmap.cpp equivalent)
    must match the autodiff reference for all edge geometry."""
    import numpy as np
    import jax.numpy as jnp

    from orb_slam2_comment_tpu.ops import geometry as geo
    from orb_slam2_comment_tpu.ops import optim

    rng = np.random.default_rng(3)
    K = (520.0, 517.0, 320.0, 241.0)
    bf = 40.0
    for _ in range(8):
        T = geo.se3_exp(jnp.asarray(rng.normal(0, 0.4, 6), jnp.float32))
        X = jnp.asarray(rng.normal(0, 2, 3) + [0, 0, 5], jnp.float32)
        obs = jnp.asarray(rng.normal(0, 1, 3) + [300, 240, 290], jnp.float32)
        r1, Jc1, Jp1, d1 = optim._edge_jacobians_ad(T, X, obs, K, bf)
        r2, Jc2, Jp2, d2 = optim._edge_jacobians(T, X, obs, K, bf)
        for a, b in [(r1, r2), (Jc1, Jc2), (Jp1, Jp2), (d1, d2)]:
            err = float(jnp.max(jnp.abs(a - b)) / (1e-6 + jnp.max(jnp.abs(a))))
            assert err < 2e-3, (np.asarray(a), np.asarray(b))
