"""Batched RANSAC solvers: PnP (relocalization) and Sim3 (loop alignment).

Device redesign of the reference's hypothesis-at-a-time RANSAC loops:
hypotheses are embarrassingly parallel, so ALL of them are generated,
solved and scored in one batched program.

- pnp_ransac replaces PnPsolver (src/PnPsolver.cc: EPnP + adaptive
  RANSAC driven 5-iterations-at-a-time from Tracking::Relocalization,
  src/Tracking.cc:1341-1502). The minimal solver is batched EPnP
  (control points + barycentric coords + null-space betas with
  Gauss-Newton refinement, all three beta-approximation cases evaluated
  per hypothesis); refinement on the winning inlier set is a weighted
  DLT (PnPsolver::Refine role). Per-octave chi2 inlier gating matches
  the reference (PnPsolver::SetRansacParameters).
- sim3_ransac replaces Sim3Solver (src/Sim3Solver.cc): 3-point closed-form
  Horn 1987 absolute orientation (quaternion eigenvector method) with
  optional fixed scale, inliers checked by mutual reprojection in both
  cameras (Sim3Solver::CheckInliers).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from orb_slam2_comment_tpu.ops import geometry as geo


def _sample_indices(key, n_hyp, set_size, n, p_valid):
    """[n_hyp, set_size] indices drawn from valid entries (with replacement
    across hypotheses; per-hypothesis duplicates are tolerated — degenerate
    hypotheses simply score poorly)."""
    logits = jnp.where(p_valid, 0.0, -jnp.inf)
    return jax.random.categorical(
        key, logits[None, :], shape=(n_hyp, set_size)
    )


class PnPResult(NamedTuple):
    Tcw: jax.Array
    inliers: jax.Array
    n_inliers: jax.Array
    ok: jax.Array


# EPnP control-point pair indexing (PnPsolver::compute_rho /
# compute_L_6x10, src/PnPsolver.cc): pairs of the 4 control points and the
# beta-product column order [b11, b12, b22, b13, b23, b33, b14, b24, b34, b44]
_EPNP_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
_EPNP_B10 = ((0, 0), (0, 1), (1, 1), (0, 2), (1, 2), (2, 2),
             (0, 3), (1, 3), (2, 3), (3, 3))


def _epnp_poses(Xs, us, K):
    """Batched EPnP (Lepetit et al.; PnPsolver::compute_pose,
    src/PnPsolver.cc + PnPsolver.h:75-125): [H,S,3] world points and
    [H,S,2] pixels -> (R [3H,3,3], t [3H,3]) — three candidate poses per
    hypothesis, one per beta-approximation case, each Gauss-Newton
    refined. The caller scores all of them; the best wins, which subsumes
    the reference's per-case reprojection-error comparison."""
    fx, fy, cx, cy = K
    H, S = Xs.shape[0], Xs.shape[1]

    # 1. control points: centroid + principal directions
    #    (PnPsolver::choose_control_points)
    c0 = jnp.mean(Xs, axis=1)                              # [H,3]
    A = Xs - c0[:, None, :]
    cov = jnp.einsum("hsi,hsj->hij", A, A)
    lam, V = jnp.linalg.eigh(cov)                          # ascending
    sig = jnp.sqrt(jnp.maximum(lam, 1e-10) / S)            # [H,3]
    cws = jnp.concatenate(
        [c0[:, None, :], c0[:, None, :] + sig[..., None] * V.swapaxes(1, 2)],
        axis=1,
    )                                                      # [H,4,3]

    # 2. barycentric coordinates (compute_barycentric_coordinates):
    #    [cws^T; 1] alpha = [X; 1]
    C = jnp.concatenate(
        [cws.swapaxes(1, 2), jnp.ones((H, 1, 4), Xs.dtype)], axis=1
    ) + 1e-9 * jnp.eye(4)
    Xh = jnp.concatenate([Xs, jnp.ones((H, S, 1), Xs.dtype)], axis=-1)
    alpha = jnp.linalg.solve(C[:, None], Xh[..., None])[..., 0]  # [H,S,4]

    # 3. M matrix (fill_M) and its 4 smallest right singular vectors
    z = jnp.zeros((H, S, 4), Xs.dtype)
    r1 = jnp.stack(
        [alpha * fx, z, alpha * (cx - us[..., :1])], axis=-1
    ).reshape(H, S, 12)
    r2 = jnp.stack(
        [z, alpha * fy, alpha * (cy - us[..., 1:2])], axis=-1
    ).reshape(H, S, 12)
    M = jnp.concatenate([r1, r2], axis=1)                  # [H,2S,12]
    MtM = jnp.einsum("hki,hkj->hij", M, M)
    _, evec = jnp.linalg.eigh(MtM)
    v = evec[..., :4].swapaxes(1, 2).reshape(H, 4, 4, 3)   # [H, k, ctrl, 3]

    # 4. rho and L (compute_rho, compute_L_6x10)
    dcw = jnp.stack([cws[:, a] - cws[:, b] for a, b in _EPNP_PAIRS], axis=1)
    rho = jnp.sum(dcw * dcw, axis=-1)                      # [H,6]
    dv = jnp.stack(
        [v[:, :, a] - v[:, :, b] for a, b in _EPNP_PAIRS], axis=1
    )                                                      # [H,6,k,3]
    cols = []
    for a, b in _EPNP_B10:
        dot = jnp.sum(dv[:, :, a] * dv[:, :, b], axis=-1)
        cols.append(dot if a == b else 2.0 * dot)
    L = jnp.stack(cols, axis=-1)                           # [H,6,10]

    def lsq(cols_idx):
        Lc = L[..., jnp.asarray(cols_idx)]
        AtA = jnp.einsum("hki,hkj->hij", Lc, Lc)
        AtA = AtA + 1e-9 * jnp.eye(len(cols_idx))
        Atb = jnp.einsum("hki,hk->hi", Lc, rho)
        return jnp.linalg.solve(AtA, Atb[..., None])[..., 0]

    def sqrt_signed(x):
        return jnp.sqrt(jnp.abs(x))

    # betas_approx_1: columns (b11, b12, b13, b14)
    b4 = lsq((0, 1, 3, 6))
    s1 = jnp.sign(b4[:, 0:1])
    beta1_1 = sqrt_signed(b4[:, 0])
    denom = jnp.where(beta1_1 < 1e-8, 1.0, beta1_1)
    beta_c1 = jnp.concatenate(
        [beta1_1[:, None], s1 * b4[:, 1:] / denom[:, None]], axis=1
    )
    # betas_approx_2: columns (b11, b12, b22)
    b3 = lsq((0, 1, 2))
    beta1_2 = sqrt_signed(b3[:, 0]) * jnp.sign(b3[:, 1])
    beta2_2 = jnp.where(
        jnp.sign(b3[:, 2]) == jnp.sign(b3[:, 0]), sqrt_signed(b3[:, 2]), 0.0
    )
    beta_c2 = jnp.stack(
        [beta1_2, beta2_2, jnp.zeros(H), jnp.zeros(H)], axis=1
    )
    # betas_approx_3: columns (b11, b12, b22, b13, b23)
    b5 = lsq((0, 1, 2, 3, 4))
    beta1_3 = sqrt_signed(b5[:, 0]) * jnp.sign(b5[:, 1])
    beta2_3 = jnp.where(
        jnp.sign(b5[:, 2]) == jnp.sign(b5[:, 0]), sqrt_signed(b5[:, 2]), 0.0
    )
    d3 = jnp.where(jnp.abs(beta1_3) < 1e-8, 1.0, beta1_3)
    beta_c3 = jnp.stack(
        [beta1_3, beta2_3, b5[:, 3] / d3, jnp.zeros(H)], axis=1
    )

    def gauss_newton(beta):
        """5 iterations on f(beta) = L beta10(beta) - rho
        (PnPsolver::gauss_newton)."""
        def b10_and_jac(b):
            prods = jnp.stack(
                [b[:, a] * b[:, bb] for a, bb in _EPNP_B10], axis=1
            )                                              # [H,10]
            # d(beta_a * beta_b)/d(beta_k)
            Jcols = []
            for a, bb in _EPNP_B10:
                row = [jnp.zeros(H)] * 4
                row[a] = row[a] + b[:, bb]
                row[bb] = row[bb] + b[:, a]
                Jcols.append(jnp.stack(row, axis=1))
            J10 = jnp.stack(Jcols, axis=1)                 # [H,10,4]
            return prods, J10

        def step(b, _):
            prods, J10 = b10_and_jac(b)
            r = jnp.einsum("hkc,hc->hk", L, prods) - rho   # [H,6]
            Jf = jnp.einsum("hkc,hcj->hkj", L, J10)        # [H,6,4]
            AtA = jnp.einsum("hki,hkj->hij", Jf, Jf) + 1e-8 * jnp.eye(4)
            Atb = jnp.einsum("hki,hk->hi", Jf, r)
            return b - jnp.linalg.solve(AtA, Atb[..., None])[..., 0], None

        beta, _ = jax.lax.scan(step, beta, None, length=5)
        return beta

    Rs, ts = [], []
    for beta in (beta_c1, beta_c2, beta_c3):
        beta = gauss_newton(beta)
        cc = jnp.einsum("hk,hkcj->hcj", beta, v)           # [H,4ctrl,3]
        pcs = jnp.einsum("hsc,hcj->hsj", alpha, cc)        # [H,S,3]
        # cheirality: flip if points land behind the camera
        # (PnPsolver::compute_ccs sign fix)
        flip = jnp.sum(pcs[..., 2], axis=1) < 0
        pcs = jnp.where(flip[:, None, None], -pcs, pcs)
        R, _, t = _horn_batch(pcs, Xs, fix_scale=True)
        Rs.append(R)
        ts.append(t)
    return jnp.concatenate(Rs, axis=0), jnp.concatenate(ts, axis=0)


@functools.partial(jax.jit, static_argnames=("K", "n_hyp", "set_size"))
def pnp_ransac(
    Xw: jax.Array,          # [N, 3]
    uv: jax.Array,          # [N, 2]
    octave: jax.Array,      # [N]
    valid: jax.Array,       # [N] bool
    sigma2_levels: jax.Array,
    K: tuple,
    seed: int = 0,
    n_hyp: int = 128,
    set_size: int = 4,
) -> PnPResult:
    """Batched EPnP RANSAC (PnPsolver, src/PnPsolver.cc): minimal sets of
    4, EPnP control-point solver per hypothesis (3 beta cases each),
    chi2(2dof)-gated inliers, weighted-DLT refinement on the best
    hypothesis' inlier set (PnPsolver::Refine)."""
    fx, fy, cx, cy = K
    n = Xw.shape[0]
    key = jax.random.PRNGKey(seed)
    idx = _sample_indices(key, n_hyp, set_size, n, valid)  # [H, S]

    def dlt_poses(Xs, us, wgt):
        """Weighted DLT -> (R, t) per hypothesis, both null-vector signs.

        Xs [H,S,3], us [H,S,2], wgt [H,S] row weights. Hartley-normalizes
        the 3D points per hypothesis for conditioning.
        """
        wsum = jnp.maximum(jnp.sum(wgt, axis=1, keepdims=True), 1e-9)
        mu = jnp.sum(Xs * wgt[..., None], axis=1, keepdims=True) / wsum[..., None]
        Xc_ = Xs - mu
        scale = jnp.sqrt(
            jnp.sum(jnp.sum(Xc_ * Xc_, -1) * wgt, axis=1) / wsum[:, 0]
        )
        scale = jnp.maximum(scale, 1e-6)
        Xn = Xc_ / scale[:, None, None]
        xn = (us[..., 0] - cx) / fx
        yn = (us[..., 1] - cy) / fy
        Xh = jnp.concatenate([Xn, jnp.ones_like(Xn[..., :1])], axis=-1)
        z4 = jnp.zeros_like(Xh)
        r1 = jnp.concatenate([Xh, z4, -xn[..., None] * Xh], axis=-1)
        r2 = jnp.concatenate([z4, Xh, -yn[..., None] * Xh], axis=-1)
        A = jnp.concatenate([r1, r2], axis=1) * jnp.concatenate(
            [wgt, wgt], axis=1
        )[..., None] ** 0.5
        AtA = jnp.einsum("hki,hkj->hij", A, A)
        _, vecs = jnp.linalg.eigh(AtA)
        P = vecs[..., 0].reshape(-1, 3, 4)
        P = jnp.concatenate([P, -P], axis=0)  # null-vector sign ambiguity
        M = P[:, :, :3]
        U, S, Vt = jnp.linalg.svd(M)
        detUV = jnp.linalg.det(U @ Vt)
        Vt_fix = Vt.at[:, 2, :].multiply(jnp.sign(detUV)[:, None])
        R = U @ Vt_fix
        s = jnp.maximum(jnp.mean(S, axis=-1), 1e-12)
        t_n = P[:, :, 3] / s[:, None]
        # denormalize: Xn = (X - mu)/scale  =>  t = t_n*scale... careful:
        # x ~ R Xn + t_n = R (X-mu)/scale + t_n  =>  full pose acting on X is
        # (R, scale*t_n - R mu) up to projective scale*  — projection is
        # scale-invariant, so use Xc = R(X-mu) + scale*t_n.
        mu2 = jnp.concatenate([mu[:, 0], mu[:, 0]], axis=0)
        scale2 = jnp.concatenate([scale, scale], axis=0)
        t = scale2[:, None] * t_n - jnp.einsum("hij,hj->hi", R, mu2)
        return R, t

    def score(R, t):
        Xc = jnp.einsum("hij,nj->hni", R, Xw) + t[:, None, :]
        pu = fx * Xc[..., 0] / jnp.maximum(Xc[..., 2], 1e-9) + cx
        pv = fy * Xc[..., 1] / jnp.maximum(Xc[..., 2], 1e-9) + cy
        du = pu - uv[None, :, 0]
        dv = pv - uv[None, :, 1]
        s2 = sigma2_levels[jnp.clip(octave, 0, sigma2_levels.shape[0] - 1)]
        chi2 = (du * du + dv * dv) / s2[None, :]
        inl = (chi2 < 5.991) & (Xc[..., 2] > 0) & valid[None, :]
        return inl, jnp.sum(inl, axis=1)

    R, t = _epnp_poses(Xw[idx], uv[idx], K)
    inl, scores = score(R, t)
    best = jnp.argmax(scores)

    # refine on the best hypothesis' full inlier set (PnPsolver::Refine)
    w_ref = inl[best].astype(jnp.float32)
    R2, t2 = dlt_poses(Xw[None], uv[None], w_ref[None])
    inl2, scores2 = score(R2, t2)
    best2 = jnp.argmax(scores2)
    use_refined = scores2[best2] >= scores[best]
    R_f = jnp.where(use_refined, R2[best2], R[best])
    t_f = jnp.where(use_refined, t2[best2], t[best])
    inl_f = jnp.where(use_refined, inl2[best2], inl[best])
    n_inl = jnp.where(use_refined, scores2[best2], scores[best])
    return PnPResult(
        Tcw=geo.make_T(R_f, t_f),
        inliers=inl_f,
        n_inliers=n_inl,
        ok=n_inl >= 10,
    )


class Sim3Result(NamedTuple):
    S12: jax.Array          # [4,4] Sim3 mapping cam2 coords to cam1
    inliers: jax.Array
    n_inliers: jax.Array
    ok: jax.Array


def _horn_batch(X1, X2, fix_scale: bool):
    """Closed-form absolute orientation per hypothesis: X1 ~ s R X2 + t.

    Horn 1987 quaternion method (Sim3Solver::ComputeSim3,
    src/Sim3Solver.cc)."""
    c1 = jnp.mean(X1, axis=1, keepdims=True)
    c2 = jnp.mean(X2, axis=1, keepdims=True)
    q1 = X1 - c1
    q2 = X2 - c2
    M = jnp.einsum("hsi,hsj->hij", q2, q1)  # correlation (from-2 to-1)
    Sxx, Sxy, Sxz = M[:, 0, 0], M[:, 0, 1], M[:, 0, 2]
    Syx, Syy, Syz = M[:, 1, 0], M[:, 1, 1], M[:, 1, 2]
    Szx, Szy, Szz = M[:, 2, 0], M[:, 2, 1], M[:, 2, 2]
    N = jnp.stack(
        [
            jnp.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
            jnp.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
            jnp.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
            jnp.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
        ],
        axis=-2,
    )  # [H, 4, 4]
    evals, evecs = jnp.linalg.eigh(N)
    q = evecs[..., -1]  # largest eigenvalue -> quaternion (w, x, y, z)
    quat = jnp.stack([q[:, 1], q[:, 2], q[:, 3], q[:, 0]], axis=-1)  # to (x,y,z,w)
    R = geo.quat_to_rot(quat)
    if fix_scale:
        s = jnp.ones(X1.shape[0])
    else:
        # symmetric scale (Horn eq. 39): s = sqrt(sum|q1|^2 / sum|q2|^2)
        s = jnp.sqrt(
            jnp.sum(q1 * q1, axis=(1, 2)) / jnp.maximum(jnp.sum(q2 * q2, axis=(1, 2)), 1e-12)
        )
    t = c1[:, 0, :] - s[:, None] * jnp.einsum("hij,hj->hi", R, c2[:, 0, :])
    return R, s, t


@functools.partial(
    jax.jit, static_argnames=("K1", "K2", "fix_scale", "n_hyp")
)
def sim3_ransac(
    Xc1: jax.Array,          # [N,3] matched points in camera-1 frame
    Xc2: jax.Array,          # [N,3] same points in camera-2 frame
    uv1: jax.Array,          # [N,2] observed pixels in image 1
    uv2: jax.Array,          # [N,2] observed pixels in image 2
    octave1: jax.Array,
    octave2: jax.Array,
    valid: jax.Array,
    sigma2_levels: jax.Array,
    K1: tuple,
    K2: tuple,
    fix_scale: bool = False,
    seed: int = 0,
    # 512 batched hypotheses vs the reference's 300 sequential iterations
    # (Sim3Solver::SetRansacParameters, LoopClosing.cc:301): hypotheses are
    # embarrassingly parallel on the device, so sampling density is cheap
    n_hyp: int = 512,
    min_inliers: int = 20,
) -> Sim3Result:
    """Batched 3-point Horn RANSAC with mutual-reprojection inlier check
    (Sim3Solver::iterate + CheckInliers; chi2 gates 9.21 as in
    Sim3Solver.cc SetRansacParameters th2=9.21*sigma2)."""
    n = Xc1.shape[0]
    key = jax.random.PRNGKey(seed)
    idx = _sample_indices(key, n_hyp, 3, n, valid)
    R, s, t = _horn_batch(Xc1[idx], Xc2[idx], fix_scale)

    def proj(Kt, X):
        fx, fy, cx, cy = Kt
        u = fx * X[..., 0] / jnp.maximum(X[..., 2], 1e-9) + cx
        v = fy * X[..., 1] / jnp.maximum(X[..., 2], 1e-9) + cy
        return jnp.stack([u, v], -1)

    # S12: X1 = s R X2 + t; S21 = inverse
    X1_pred = s[:, None, None] * jnp.einsum("hij,nj->hni", R, Xc2) + t[:, None, :]
    Rt = jnp.swapaxes(R, 1, 2)
    X2_pred = jnp.einsum("hij,hnj->hni", Rt, (Xc1[None] - t[:, None, :])) / s[:, None, None]
    e1 = proj(K1, X1_pred) - uv1[None]
    e2 = proj(K2, X2_pred) - uv2[None]
    s2_1 = sigma2_levels[jnp.clip(octave1, 0, sigma2_levels.shape[0] - 1)]
    s2_2 = sigma2_levels[jnp.clip(octave2, 0, sigma2_levels.shape[0] - 1)]
    c1 = jnp.sum(e1 * e1, -1) / s2_1[None]
    c2 = jnp.sum(e2 * e2, -1) / s2_2[None]
    inl = (c1 < 9.21) & (c2 < 9.21) & valid[None]
    scores = jnp.sum(inl, axis=1)
    best = jnp.argmax(scores)
    S12 = geo.sim3_make(R[best], t[best], s[best])
    n_inl = scores[best]
    return Sim3Result(
        S12=S12, inliers=inl[best], n_inliers=n_inl, ok=n_inl >= min_inliers
    )
