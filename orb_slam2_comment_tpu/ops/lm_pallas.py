"""Pose-only LM as ONE Pallas kernel for the GPU (Triton route).

`optim.pose_optimize` (the reference's Optimizer::PoseOptimization,
src/Optimizer.cc:239-451) runs 4 rounds x 10 LM iterations. As XLA ops
each iteration is a handful of small kernels inside a device while loop,
so the 40 sequential iterations pay per-launch and loop-predicate costs
against a few microseconds of [N]-edge math. This kernel runs the whole
optimization in one Triton program: the edge arrays are [N_pow2] blocks
held in registers, the pose is 12 scalars, and each iteration is the
closed-form Jacobians, 27 block reductions for the 6x6 normal equations
and an unrolled 6x6 Cholesky.

Same semantics as optim.pose_optimize (damping schedule, Huber rounds,
chi2 reclassification between rounds, accept/reject rule); the
Jacobians are the closed form of optim._edge_jacobians. Checked against
the XLA path in interpret mode by tests/test_optim.py and on the card by
chip_smoke.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from orb_slam2_comment_tpu import constants as C
from orb_slam2_comment_tpu.ops import geometry as geo
from orb_slam2_comment_tpu.ops.optim import PoseOptResult

_EPS = 1e-12
_POSE_W = 16  # pose block: 9 rotation + 3 translation scalars, padded


def _chol6_solve(H, b):
    """Solve H x = b for symmetric positive-definite 6x6 given as a dict
    of scalars H[(i,j)] (i>=j) and list b; fully unrolled Cholesky."""
    L = {}
    for i in range(6):
        s = H[(i, i)]
        for k in range(i):
            s = s - L[(i, k)] * L[(i, k)]
        L[(i, i)] = jnp.sqrt(jnp.maximum(s, 1e-12))
        inv_d = 1.0 / L[(i, i)]
        for j in range(i + 1, 6):
            s = H[(j, i)]
            for k in range(i):
                s = s - L[(j, k)] * L[(i, k)]
            L[(j, i)] = s * inv_d
    y = [None] * 6
    for i in range(6):
        s = b[i]
        for k in range(i):
            s = s - L[(i, k)] * y[k]
        y[i] = s / L[(i, i)]
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[(k, i)] * x[k]
        x[i] = s / L[(i, i)]
    return x


def _se3_exp_scalars(dx):
    """geometry.se3_exp (T = [[R, J rho], [0,1]]) on 6 scalars.
    Returns (R as nested 3x3 list, t as list of 3)."""
    rho = dx[:3]
    wx, wy, wz = dx[3], dx[4], dx[5]
    th2 = wx * wx + wy * wy + wz * wz
    th = jnp.sqrt(th2 + _EPS)
    small = th2 <= _EPS
    a = jnp.where(small, 1.0 - th2 / 6.0, jnp.sin(th) / th)
    bb = jnp.where(
        small, 0.5 - th2 / 24.0, (1.0 - jnp.cos(th)) / (th2 + _EPS)
    )
    cc = jnp.where(
        small, 1.0 / 6.0 - th2 / 120.0,
        (th - jnp.sin(th)) / (th2 * th + _EPS),
    )
    W = [[0.0 * th, -wz, wy], [wz, 0.0 * th, -wx], [-wy, wx, 0.0 * th]]

    def matmul3(A, B):
        return [
            [sum(A[i][k] * B[k][j] for k in range(3)) for j in range(3)]
            for i in range(3)
        ]

    W2 = matmul3(W, W)
    eye = [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
    R = [
        [eye[i][j] + a * W[i][j] + bb * W2[i][j] for j in range(3)]
        for i in range(3)
    ]
    J = [
        [eye[i][j] + bb * W[i][j] + cc * W2[i][j] for j in range(3)]
        for i in range(3)
    ]
    t = [sum(J[i][k] * rho[k] for k in range(3)) for i in range(3)]
    return R, t


def _compose(Rd, td, R, t):
    Rn = [
        [sum(Rd[i][k] * R[k][j] for k in range(3)) for j in range(3)]
        for i in range(3)
    ]
    tn = [sum(Rd[i][k] * t[k] for k in range(3)) + td[i] for i in range(3)]
    return Rn, tn


def _wsum(pairs):
    """Block sum of sum_k a_k * b_k over the (a, b) pairs, skipping the
    structural zeros (None) of the Jacobian."""
    terms = [a * b for a, b in pairs if a is not None and b is not None]
    if not terms:
        return jnp.float32(0.0)
    return jnp.sum(sum(terms[1:], terms[0]))


def _make_kernel(K, bf, rounds, iters, robust_rounds):
    fx, fy, cx, cy = K

    def kernel(
        x_ref, y_ref, z_ref, u_ref, v_ref, ur_ref, invs2_ref, comp_ref,
        valid_ref, delta_ref, chi2th_ref, t0_ref, tout_ref, inl_ref,
    ):
        x_r, y_r, z_r = x_ref[...], y_ref[...], z_ref[...]
        u_o, v_o, ur_o = u_ref[...], v_ref[...], ur_ref[...]
        invs2 = invs2_ref[...]
        comp = comp_ref[...]
        valid0 = valid_ref[...]
        delta = delta_ref[...]
        chi2_th = chi2th_ref[...]

        def residuals(pose):
            (R00, R01, R02, R10, R11, R12, R20, R21, R22, t0, t1, t2) = pose
            xc = R00 * x_r + R01 * y_r + R02 * z_r + t0
            yc = R10 * x_r + R11 * y_r + R12 * z_r + t1
            zc = R20 * x_r + R21 * y_r + R22 * z_r + t2
            zi = 1.0 / jnp.maximum(zc, 1e-9)  # as geometry.project_stereo
            up = fx * xc * zi + cx
            vp = fy * yc * zi + cy
            urp = up - bf * zi
            return (u_o - up, v_o - vp, ur_o - urp), (xc, yc, zc, zi)

        def chi2_of(r):
            ru, rv, rur = r
            return invs2 * (ru * ru + rv * rv + comp * rur * rur)

        def robust_cost(r, mask, robust: bool):
            c2 = chi2_of(r) * mask
            if not robust:
                return jnp.sum(c2)
            d2 = delta * delta
            rho = jnp.where(
                c2 <= d2,
                c2,
                2.0 * delta * jnp.sqrt(jnp.maximum(c2, _EPS)) - d2,
            )
            return jnp.sum(jnp.where(mask > 0, rho, 0.0))

        def lm_round(pose, mask, robust: bool):
            def body(it, carry):
                pose, lam, cost = carry
                r, (xc, yc, zc, zi) = residuals(pose)
                ru, rv, rur = r
                if robust:
                    c2 = chi2_of(r) * mask
                    hw = jnp.where(
                        c2 <= delta * delta,
                        1.0,
                        delta / jnp.sqrt(jnp.maximum(c2, _EPS)),
                    )
                    w = invs2 * hw * mask
                else:
                    w = invs2 * mask
                wc = w * comp
                # dr/dxi = -dpred/dXc [I | -[Xc]x] (optim._edge_jacobians);
                # rows (u, v, ur), None marks a structural zero
                D00 = -fx * zi
                D02 = fx * xc * zi * zi
                D11 = -fy * zi
                D12 = fy * yc * zi * zi
                D22 = (fx * xc - bf) * zi * zi
                Ju = [D00, None, D02, D02 * yc, D00 * zc - D02 * xc,
                      -D00 * yc]
                Jv = [None, D11, D12, -D11 * zc + D12 * yc, -D12 * xc,
                      D11 * xc]
                Jur = [D00, None, D22, D22 * yc, D00 * zc - D22 * xc,
                       -D00 * yc]
                # weight the rows BEFORE the products: an unweighted edge
                # (w = 0) behind the camera has |J| ~ 1e20, whose square
                # overflows to inf and 0 * inf = NaN would poison H
                rows = [(w, Ju, ru), (w, Jv, rv), (wc, Jur, rur)]
                wrows = [[None if j is None else wt * j for j in J]
                         for wt, J, _ in rows]
                H = {}
                b = [None] * 6
                for i2 in range(6):
                    for j2 in range(i2 + 1):
                        H[(i2, j2)] = _wsum(
                            [(wj[i2], J[j2]) for wj, (_, J, _) in
                             zip(wrows, rows)])
                    b[i2] = -_wsum(
                        [(wj[i2], r) for wj, (_, _, r) in zip(wrows, rows)])
                for i2 in range(6):
                    H[(i2, i2)] = H[(i2, i2)] * (1.0 + lam) + 1e-9
                dx = _chol6_solve(H, b)
                Rd, td = _se3_exp_scalars(dx)
                R = [list(pose[0:3]), list(pose[3:6]), list(pose[6:9])]
                t = list(pose[9:12])
                Rn, tn = _compose(Rd, td, R, t)
                pose_new = tuple(Rn[0] + Rn[1] + Rn[2] + tn)
                r_new, _ = residuals(pose_new)
                new_cost = robust_cost(r_new, mask, robust)
                accept = new_cost < cost
                pose = tuple(
                    jnp.where(accept, pn, po)
                    for pn, po in zip(pose_new, pose)
                )
                lam = jnp.where(
                    accept,
                    jnp.maximum(lam * 0.5, 1e-9),
                    jnp.minimum(lam * 4.0, 1e6),
                )
                cost = jnp.where(accept, new_cost, cost)
                return (pose, lam, cost)

            r0, _ = residuals(pose)
            cost0 = robust_cost(r0, mask, robust)
            pose, _, _ = jax.lax.fori_loop(
                0, iters, body, (pose, jnp.float32(1e-3), cost0)
            )
            # chi2 reclassification (src/Optimizer.cc:391-428)
            r, (_, _, zc, _) = residuals(pose)
            c2 = chi2_of(r)
            new_mask = jnp.where(
                (c2 <= chi2_th) & (zc > 0) & (valid0 > 0), 1.0, 0.0
            )
            return pose, new_mask

        lane = jax.lax.broadcasted_iota(jnp.int32, (_POSE_W,), 0)
        t0v = t0_ref[...]
        pose = tuple(
            jnp.sum(jnp.where(lane == i, t0v, 0.0)) for i in range(12)
        )
        mask = valid0
        for rd in range(rounds):
            pose, mask = lm_round(pose, mask, robust=rd < robust_rounds)
        out = jnp.zeros((_POSE_W,), jnp.float32)
        for i in range(12):
            out = jnp.where(lane == i, pose[i], out)
        tout_ref[...] = out
        inl_ref[...] = mask

    return kernel


def _num_warps(n_pow2: int) -> int:
    """About eight edges per thread, 4 to 16 warps."""
    return max(4, min(16, n_pow2 // 256))


@functools.partial(
    jax.jit,
    static_argnames=("K", "bf", "rounds", "iters", "interpret"),
)
def pose_optimize_pallas(
    Tcw0: jax.Array,
    Xw: jax.Array,             # [N, 3]
    obs: jax.Array,            # [N, 3] (u, v, ur)
    octave: jax.Array,         # [N]
    is_stereo: jax.Array,      # [N] bool
    valid: jax.Array,          # [N] bool
    inv_sigma2_levels: jax.Array,
    K: tuple,
    bf: float,
    rounds: int = C.POSE_OPT_ROUNDS,
    iters: int = C.POSE_OPT_ITS_PER_ROUND,
    interpret: bool = False,
) -> PoseOptResult:
    """Drop-in replacement for optim.pose_optimize as one Triton kernel."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as pltriton

    n = Xw.shape[0]
    n_pad = max(16, 1 << (n - 1).bit_length())  # Triton blocks are 2^k

    def vec(x, fill=0.0):
        return jnp.pad(
            x.astype(jnp.float32), (0, n_pad - n), constant_values=fill
        )

    inv_s2 = inv_sigma2_levels[
        jnp.clip(octave, 0, inv_sigma2_levels.shape[0] - 1)
    ]
    delta = jnp.where(is_stereo, C.HUBER_STEREO, C.HUBER_MONO)
    chi2th = jnp.where(is_stereo, C.CHI2_STEREO, C.CHI2_MONO)

    T = geo.orthonormalize_T(Tcw0).astype(jnp.float32)
    t0 = jnp.zeros((_POSE_W,), jnp.float32).at[:12].set(
        jnp.concatenate([T[:3, :3].reshape(-1), T[:3, 3]])
    )

    kernel = _make_kernel(K, bf, rounds, iters, C.POSE_OPT_ROBUST_ROUNDS)
    tout, inl = pl.pallas_call(
        kernel,
        out_shape=(
            jax.ShapeDtypeStruct((_POSE_W,), jnp.float32),
            jax.ShapeDtypeStruct((n_pad,), jnp.float32),
        ),
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=_num_warps(n_pad), num_stages=1
        ),
        interpret=interpret,
        name="pose_lm",
    )(
        vec(Xw[:, 0]), vec(Xw[:, 1]), vec(Xw[:, 2], 1.0),
        vec(obs[:, 0]), vec(obs[:, 1]), vec(obs[:, 2]),
        vec(inv_s2), vec(is_stereo), vec(valid), vec(delta, 1.0),
        vec(chi2th, 1.0), t0,
    )
    Tcw = geo.orthonormalize_T(geo.make_T(tout[:9].reshape(3, 3), tout[9:12]))
    inliers = (inl[:n] > 0) & valid
    return PoseOptResult(Tcw=Tcw, inliers=inliers, n_inliers=jnp.sum(inliers))
