"""SE(3) / Sim(3) Lie-group math, camera models, and robust kernels.

Device-side replacement for the reference's g2o type layer
(`Thirdparty/g2o/g2o/types/se3quat.h:41`, `types/sim3.h`) and `Converter`
(`src/Converter.cc`). Everything is pure jnp, batched-friendly (all
functions vmap cleanly), float32, and differentiable — optimizer Jacobians
are taken with `jax.jacfwd` against local perturbations instead of the
reference's hand-written `linearizeOplus` blocks
(`types_six_dof_expmap.cpp`).

Conventions:
- Poses are 4x4 row-major `Tcw` (world -> camera), like the reference's
  `cv::Mat mTcw` (`include/Frame.h`).
- se3 tangent is `[rho(3), phi(3)]` = [translation, rotation]; the local
  update used by optimizers is LEFT multiplication `T <- exp(xi) @ T`,
  matching g2o's `VertexSE3Expmap::oplusImpl`
  (`types_six_dof_expmap.h:59-77`).
- sim3 tangent is `[rho(3), phi(3), sigma(1)]` with scale `s = exp(sigma)`.
  A Sim3 is stored as a 4x4 matrix with `S[:3,:3] = s*R`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


def hat(w):
    """Skew-symmetric matrix of a 3-vector (so(3) hat operator)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([z, -wz, wy], axis=-1),
            jnp.stack([wz, z, -wx], axis=-1),
            jnp.stack([-wy, wx, z], axis=-1),
        ],
        axis=-2,
    )


def so3_exp(phi):
    """Rodrigues formula, Taylor-safe at phi -> 0."""
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS)
    W = hat(phi)
    W2 = W @ W
    # sin(t)/t and (1-cos t)/t^2 with small-angle expansions
    a = jnp.where(theta2 > _EPS, jnp.sin(theta) / theta, 1.0 - theta2 / 6.0)
    b = jnp.where(theta2 > _EPS, (1.0 - jnp.cos(theta)) / (theta2 + _EPS), 0.5 - theta2 / 24.0)
    I = jnp.eye(3, dtype=phi.dtype)
    return I + a[..., None, None] * W + b[..., None, None] * W2


def so3_log(R):
    """Inverse of so3_exp. Handles angles near 0 and pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos_t)
    # vee of (R - R^T)/2
    w = 0.5 * jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    sin_t = jnp.sin(theta)
    scale = jnp.where(jnp.abs(sin_t) > 1e-5, theta / jnp.where(jnp.abs(sin_t) > 1e-5, sin_t, 1.0), 1.0)
    w_generic = w * scale[..., None]
    # Near pi: R ~ I + 2*W^2/theta^2 -> diag gives axis
    diag = jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1)
    axis2 = jnp.maximum((diag - cos_t[..., None]) / jnp.maximum(1.0 - cos_t[..., None], 1e-8), 0.0)
    axis = jnp.sqrt(axis2)
    # fix signs using off-diagonal sums (R + R^T terms)
    sxy = R[..., 0, 1] + R[..., 1, 0]
    sxz = R[..., 0, 2] + R[..., 2, 0]
    # choose sign of largest component positive, then others by products
    ax = axis[..., 0]
    ay = jnp.where(sxy >= 0, axis[..., 1], -axis[..., 1])
    az = jnp.where(sxz >= 0, axis[..., 2], -axis[..., 2])
    w_pi = jnp.stack([ax, ay, az], axis=-1) * theta[..., None]
    near_pi = theta > 3.0
    return jnp.where(near_pi[..., None], w_pi, w_generic)


def _so3_left_jacobian(phi):
    """Left Jacobian J of SO(3): exp(phi) translation coupling."""
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS)
    W = hat(phi)
    W2 = W @ W
    b = jnp.where(theta2 > _EPS, (1.0 - jnp.cos(theta)) / (theta2 + _EPS), 0.5 - theta2 / 24.0)
    c = jnp.where(
        theta2 > _EPS,
        (theta - jnp.sin(theta)) / (theta2 * theta + _EPS),
        1.0 / 6.0 - theta2 / 120.0,
    )
    I = jnp.eye(3, dtype=phi.dtype)
    return I + b[..., None, None] * W + c[..., None, None] * W2


def _so3_left_jacobian_inv(phi):
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS)
    W = hat(phi)
    W2 = W @ W
    half = 0.5 * theta
    cot = jnp.where(theta2 > _EPS, half / jnp.tan(half + _EPS), 1.0)
    k = jnp.where(theta2 > _EPS, (1.0 - cot) / (theta2 + _EPS), 1.0 / 12.0 + theta2 / 720.0)
    I = jnp.eye(3, dtype=phi.dtype)
    return I - 0.5 * W + k[..., None, None] * W2


def se3_exp(xi):
    """xi=[rho, phi] -> 4x4 transform. T = [[R, J rho], [0, 1]]."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    R = so3_exp(phi)
    J = _so3_left_jacobian(phi)
    t = jnp.einsum("...ij,...j->...i", J, rho)
    return make_T(R, t)


def se3_log(T):
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    phi = so3_log(R)
    Jinv = _so3_left_jacobian_inv(phi)
    rho = jnp.einsum("...ij,...j->...i", Jinv, t)
    return jnp.concatenate([rho, phi], axis=-1)


def make_T(R, t):
    """Assemble 4x4 from R [...,3,3], t [...,3]."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([R, t[..., :, None]], axis=-1)
    bottom = jnp.zeros(batch + (1, 4), dtype=R.dtype).at[..., 0, 3].set(1.0)
    return jnp.concatenate([top, bottom], axis=-2)


def orthonormalize_R(R):
    """Project a near-rotation back onto SO(3) by Gram-Schmidt.

    Float32 chains of `se3_exp(d) @ T` (tens of LM iterations per frame plus
    velocity compositions) drift R off the manifold at ~1e-5/op; because
    inv_T uses the transpose-inverse, the defect COMPOUNDS EXPONENTIALLY
    through the constant-velocity model (measured: ||R^T R - I|| ~ 1.5e-2 by
    frame 14, prediction error x2.5/frame, tracking dead by frame ~18 on
    every trajectory). A left-increment optimizer can never repair a
    non-orthonormal factor — exp(d) @ T preserves it — so the projection
    must happen at composition/output points."""
    x = R[..., :, 0]
    x = x / jnp.maximum(jnp.linalg.norm(x, axis=-1, keepdims=True), _EPS)
    y = R[..., :, 1]
    y = y - jnp.sum(x * y, axis=-1, keepdims=True) * x
    y = y / jnp.maximum(jnp.linalg.norm(y, axis=-1, keepdims=True), _EPS)
    z = jnp.cross(x, y)
    return jnp.stack([x, y, z], axis=-1)


def orthonormalize_T(T):
    """Re-project the rotation block of a rigid transform onto SO(3),
    keeping the translation."""
    return make_T(orthonormalize_R(T[..., :3, :3]), T[..., :3, 3])


def inv_T(T):
    """Inverse of a rigid transform (also valid for Sim3 matrices)."""
    A = T[..., :3, :3]
    t = T[..., :3, 3]
    # For Sim3, A = s R; inv(A) = R^T / s. General 3x3 inverse via solve is
    # overkill; use the similarity structure: inv(A) = A^T / s^2.
    s2 = jnp.sum(A[..., 0, :] * A[..., 0, :], axis=-1)
    Ainv = jnp.swapaxes(A, -1, -2) / s2[..., None, None]
    tinv = -jnp.einsum("...ij,...j->...i", Ainv, t)
    return make_T(Ainv, tinv)


# --- Sim(3) -------------------------------------------------------------

def sim3_make(R, t, s):
    """Sim3 as 4x4 with upper-left s*R."""
    return make_T(R * s[..., None, None], t)


def sim3_scale(S):
    """Recover scale from a Sim3 matrix (row norm of sR)."""
    return jnp.sqrt(jnp.sum(S[..., 0, :3] * S[..., 0, :3], axis=-1))


def sim3_exp(zeta):
    """zeta=[rho, phi, sigma] -> 4x4 Sim3 (s = exp(sigma)).

    Uses the closed-form W matrix of the Sim(3) exponential
    (mirrors g2o `types/sim3.h` constructor-from-vector behavior).
    """
    rho, phi, sigma = zeta[..., :3], zeta[..., 3:6], zeta[..., 6]
    s = jnp.exp(sigma)
    R = so3_exp(phi)
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS)
    W = hat(phi)
    W2 = W @ W
    I = jnp.eye(3, dtype=zeta.dtype)

    near_zero_sigma = jnp.abs(sigma) < 1e-5
    near_zero_theta = theta2 < _EPS
    sigma_safe = jnp.where(near_zero_sigma, 1.0, sigma)
    theta_safe = jnp.where(near_zero_theta, 1.0, theta)

    # coefficients of V = a*I + b*W + c*W2 such that t = V rho
    # (derivation: integral of exp(sigma u) exp(phi u) du over [0,1])
    A_ = jnp.where(near_zero_sigma, 1.0, (s - 1.0) / sigma_safe)
    # b,c handle rotation+scale coupling
    st, ct = jnp.sin(theta), jnp.cos(theta)
    denom = sigma_safe**2 + theta_safe**2
    b_full = (
        (sigma_safe * st + theta_safe * (1.0 - s * ct)) / (theta_safe * denom)
    ) * s / s  # keep dtype
    b_sigma0 = (1.0 - ct) / theta_safe**2
    b_theta0 = jnp.zeros_like(sigma)
    c_full = (A_ - ((s * ct - 1.0) * sigma_safe + s * st * theta_safe) / denom) / theta_safe**2
    c_sigma0 = (theta_safe - st) / theta_safe**3
    b = jnp.where(near_zero_theta, b_theta0, jnp.where(near_zero_sigma, b_sigma0, b_full))
    c = jnp.where(near_zero_theta, jnp.zeros_like(sigma), jnp.where(near_zero_sigma, c_sigma0, c_full))
    V = A_[..., None, None] * I + b[..., None, None] * W + c[..., None, None] * W2
    t = jnp.einsum("...ij,...j->...i", V, rho)
    return sim3_make(R, t, s)


def sim3_log(S):
    """Inverse of sim3_exp (numerical V-inverse via solve)."""
    s = sim3_scale(S)
    R = S[..., :3, :3] / s[..., None, None]
    t = S[..., :3, 3]
    sigma = jnp.log(s)
    phi = so3_log(R)
    # rebuild V from (phi, sigma) and solve V rho = t
    zeta0 = jnp.concatenate([jnp.zeros_like(phi), phi, sigma[..., None]], axis=-1)
    # extract V by pushing basis vectors through the exp's V (cheap: reuse formula)
    # Instead of re-deriving, apply sim3_exp to unit rho vectors:
    def v_col(e):
        z = jnp.concatenate([e, phi, sigma[..., None]], axis=-1)
        return sim3_exp(z)[..., :3, 3]

    eye = jnp.eye(3, dtype=S.dtype)
    V = jnp.stack([v_col(jnp.broadcast_to(eye[i], phi.shape)) for i in range(3)], axis=-1)
    rho = jnp.linalg.solve(V, t[..., None])[..., 0]
    del zeta0
    return jnp.concatenate([rho, phi, sigma[..., None]], axis=-1)


# --- Camera model -------------------------------------------------------

def transform_points(T, X):
    """Apply 4x4 (SE3 or Sim3) to points [...,3]."""
    return jnp.einsum("ij,...j->...i", T[:3, :3], X) + T[:3, 3]


def project(K, Xc):
    """Pinhole projection of camera-frame points [...,3] -> pixel [...,2].

    K = (fx, fy, cx, cy). Matches `Frame::isInFrustum` projection
    (src/Frame.cc:269-326).
    """
    fx, fy, cx, cy = K
    invz = 1.0 / jnp.maximum(Xc[..., 2], 1e-9)
    u = fx * Xc[..., 0] * invz + cx
    v = fy * Xc[..., 1] * invz + cy
    return jnp.stack([u, v], axis=-1)


def project_stereo(K, bf, Xc):
    """Stereo projection -> (u_left, v, u_right), u_right = u - bf/z.

    Mirrors `EdgeStereoSE3ProjectXYZ::cam_project`
    (types_six_dof_expmap.cpp) and `Frame::ComputeStereoFromRGBD`
    (src/Frame.cc:643-664).
    """
    fx, fy, cx, cy = K
    invz = 1.0 / jnp.maximum(Xc[..., 2], 1e-9)
    u = fx * Xc[..., 0] * invz + cx
    v = fy * Xc[..., 1] * invz + cy
    ur = u - bf * invz
    return jnp.stack([u, v, ur], axis=-1)


def backproject(K, uv, z):
    """Pixel + depth -> camera-frame 3D (src/Frame.cc:666 UnprojectStereo)."""
    fx, fy, cx, cy = K
    x = (uv[..., 0] - cx) * z / fx
    y = (uv[..., 1] - cy) * z / fy
    return jnp.stack([x, y, z], axis=-1)


# --- Robust kernels -----------------------------------------------------

def huber_weight(chi2, delta):
    """IRLS weight of the Huber kernel at squared error chi2.

    rho(e) = e            if e <= delta^2
             2 delta sqrt(e) - delta^2 otherwise
    weight = rho'(e) (g2o RobustKernelHuber, robust_kernel_impl.cpp).
    """
    d2 = delta * delta
    e = jnp.maximum(chi2, 1e-12)
    return jnp.where(chi2 <= d2, 1.0, delta / jnp.sqrt(e))


# --- Quaternions (trajectory IO: System.cc:322-418 TUM format) ----------

def rot_to_quat(R):
    """Rotation matrix -> quaternion (x, y, z, w), Shepperd's method."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def case0():
        s = jnp.sqrt(jnp.maximum(tr + 1.0, 1e-12)) * 2
        return jnp.stack([(m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s, 0.25 * s], axis=-1)

    def case1():
        s = jnp.sqrt(jnp.maximum(1.0 + m00 - m11 - m22, 1e-12)) * 2
        return jnp.stack([0.25 * s, (m01 + m10) / s, (m02 + m20) / s, (m21 - m12) / s], axis=-1)

    def case2():
        s = jnp.sqrt(jnp.maximum(1.0 + m11 - m00 - m22, 1e-12)) * 2
        return jnp.stack([(m01 + m10) / s, 0.25 * s, (m12 + m21) / s, (m02 - m20) / s], axis=-1)

    def case3():
        s = jnp.sqrt(jnp.maximum(1.0 + m22 - m00 - m11, 1e-12)) * 2
        return jnp.stack([(m02 + m20) / s, (m12 + m21) / s, 0.25 * s, (m10 - m01) / s], axis=-1)

    q = jnp.where(
        (tr > 0)[..., None],
        case0(),
        jnp.where(
            ((m00 >= m11) & (m00 >= m22))[..., None],
            case1(),
            jnp.where((m11 >= m22)[..., None], case2(), case3()),
        ),
    )
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quat_to_rot(q):
    """Quaternion (x, y, z, w) -> rotation matrix."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = 2.0 / jnp.maximum(n, 1e-12)
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return jnp.stack(
        [
            jnp.stack([1 - (yy + zz), xy - wz, xz + wy], axis=-1),
            jnp.stack([xy + wz, 1 - (xx + zz), yz - wx], axis=-1),
            jnp.stack([xz - wy, yz + wx, 1 - (xx + yy)], axis=-1),
        ],
        axis=-2,
    )


# --- Triangulation ------------------------------------------------------

def triangulate_linear(P1, P2, uv1, uv2):
    """DLT triangulation from two 3x4 projection matrices.

    Mirrors `Initializer::Triangulate` (src/Initializer.cc) /
    `LocalMapping::CreateNewMapPoints` SVD path (src/LocalMapping.cc:310).
    Solves the 4x4 system via eigendecomposition of A^T A (batched-safe,
    avoids full SVD).
    """
    rows = jnp.stack(
        [
            uv1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
            uv1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
            uv2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
            uv2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
        ],
        axis=-2,
    )
    AtA = jnp.einsum("...ki,...kj->...ij", rows, rows)
    # smallest eigenvector by inverse iteration (batched 4x4 eigh lowers to
    # a slow generic path; 4 shifted solves converge to machine
    # precision for these well-separated spectra)
    trace = jnp.trace(AtA, axis1=-2, axis2=-1)[..., None, None]
    M = AtA + 1e-7 * trace * jnp.eye(4, dtype=AtA.dtype) + 1e-12 * jnp.eye(4)
    X = jnp.ones(AtA.shape[:-2] + (4,), AtA.dtype)
    for _ in range(4):
        X = jnp.linalg.solve(M, X[..., None])[..., 0]
        X = X / jnp.maximum(jnp.linalg.norm(X, axis=-1, keepdims=True), 1e-30)
    w = X[..., 3]
    w = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    return X[..., :3] / w[..., None]


def fundamental_from_poses(K1, T1w, K2, T2w):
    """F12 such that x1^T F12 x2 = 0, from two world->cam poses.

    Mirrors `LocalMapping::ComputeF12` (src/LocalMapping.cc:536-553).
    """
    R1w, t1w = T1w[:3, :3], T1w[:3, 3]
    R2w, t2w = T2w[:3, :3], T2w[:3, 3]
    R12 = R1w @ R2w.T
    t12 = -R12 @ t2w + t1w
    fx1, fy1, cx1, cy1 = K1
    fx2, fy2, cx2, cy2 = K2
    K1m = jnp.array([[fx1, 0, cx1], [0, fy1, cy1], [0, 0, 1]], dtype=T1w.dtype)
    K2m = jnp.array([[fx2, 0, cx2], [0, fy2, cy2], [0, 0, 1]], dtype=T1w.dtype)
    return jnp.linalg.inv(K1m).T @ hat(t12) @ R12 @ jnp.linalg.inv(K2m)
