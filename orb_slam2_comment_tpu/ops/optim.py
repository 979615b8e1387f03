"""Batched Levenberg–Marquardt solvers: the g2o replacement.

Implements the complete factor vocabulary of the reference's Optimizer
(src/Optimizer.cc, include/Optimizer.h:39-57) as fixed-shape JAX solvers:

- pose_optimize            <- Optimizer::PoseOptimization (:239-451)
- local_bundle_adjustment  <- Optimizer::LocalBundleAdjustment (:453-778)
                              and Optimizer::BundleAdjustment (:49-237)
                              (full BA = local BA with every KF in the window)
- sim3_optimize            <- Optimizer::OptimizeSim3 (:1046-1244)
- essential_graph_optimize <- Optimizer::OptimizeEssentialGraph (:781-1044)

Design notes (accelerator-first, not a g2o translation):
- Jacobians come from jax.jacfwd of the residual against a local tangent
  perturbation (left-multiplied se3/sim3 exp), replacing the hand-written
  linearizeOplus of types_six_dof_expmap.cpp / types_seven_dof_expmap.cpp.
- Mono and stereo reprojection edges are unified: every observation is
  (u, v, u_right) with a per-component weight mask — mono simply zeroes
  the u_right row. One batched path, no ragged edge lists.
- Landmarks are eliminated by an explicit Schur complement (the
  setMarginalized(true) path of g2o's BlockSolver_6_3): Hpp is a batch of
  3x3 blocks inverted in closed form, and the reduced camera system is
  built with one dense matmul (small windows) — the matmul-friendly
  formulation of sparse BA.
- LM damping uses multiplicative lambda on the block diagonals with
  accept/reject, like g2o's OptimizationAlgorithmLevenberg.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from orb_slam2_comment_tpu import constants as C
from orb_slam2_comment_tpu.ops import geometry as geo

_BIG = 1e12


# ---------------------------------------------------------------------------
# Reprojection residuals (the 5 edge types)
# ---------------------------------------------------------------------------

def _residual_unified(Tcw, Xw, obs, K, bf):
    """(u, v, ur) residual; caller masks the ur row for mono edges.

    Covers EdgeSE3ProjectXYZ, EdgeStereoSE3ProjectXYZ and their OnlyPose
    variants (types_six_dof_expmap.h:80-205)."""
    Xc = geo.transform_points(Tcw, Xw)
    pred = geo.project_stereo(K, bf, Xc)
    return obs - pred, Xc[..., 2]


def _edge_jacobians_ad(Tcw, Xw, obs, K, bf):
    """jacfwd reference implementation (kept for the parity test — the
    analytic version below is cheaper per edge and bit-equivalent up to
    float rounding)."""

    def r_of(dc, dp):
        T = geo.se3_exp(dc) @ Tcw
        r, _ = _residual_unified(T, Xw + dp, obs, K, bf)
        return r

    z6 = jnp.zeros(6, Tcw.dtype)
    z3 = jnp.zeros(3, Tcw.dtype)
    r, depth = _residual_unified(Tcw, Xw, obs, K, bf)
    Jc = jax.jacfwd(r_of, argnums=0)(z6, z3)
    Jp = jax.jacfwd(r_of, argnums=1)(z6, z3)
    return r, Jc, Jp, depth


def _edge_jacobians(Tcw, Xw, obs, K, bf):
    """Per-edge residual + ANALYTIC Jacobians wrt camera tangent (6,
    layout [rho, phi] matching geo.se3_exp) and point (3).

    The reference's hand-written linearizeOplus
    (types_six_dof_expmap.cpp: EdgeSE3ProjectXYZ/EdgeStereoSE3ProjectXYZ)
    in the unified (u, v, ur) form: with Xc = R Xw + t and the stereo
    projection of geo.project_stereo,
        dpred/dXc = [[fx/z, 0, -fx x/z^2],
                     [0, fy/z, -fy y/z^2],
                     [fx/z, 0, (-fx x + bf)/z^2]]
        dXc/d[rho, phi] = [I | -[Xc]x],   dXc/dXw = R
    and dr = -dpred/dXc. Replaces a 9-tangent jacfwd evaluation per edge
    (the LM assemble pass is op-count bound)."""
    fx, fy, cx, cy = K
    Xc = geo.transform_points(Tcw, Xw)
    pred = geo.project_stereo(K, bf, Xc)
    r = obs - pred
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    invz = 1.0 / jnp.maximum(z, 1e-9)
    invz2 = invz * invz
    zr = jnp.zeros_like(x)
    # D = dr/dXc (sparse: D01 = D10 = D21 = 0). Everything below is
    # written ELEMENTWISE on purpose: stacking into [...,3,3] and calling
    # einsum lowers to tiny batched 3x3 dot_generals, which XLA pads to
    # its matrix tiles.
    D00 = -fx * invz
    D02 = fx * x * invz2
    D11 = -fy * invz
    D12 = fy * y * invz2
    D20 = -fx * invz
    D22 = (fx * x - bf) * invz2
    # M = D @ [Xc]x with [Xc]x rows (0,-z,y), (z,0,-x), (-y,x,0)
    M00 = -D02 * y
    M01 = -D00 * z + D02 * x
    M02 = D00 * y
    M10 = D11 * z - D12 * y
    M11 = D12 * x
    M12 = -D11 * x
    M20 = -D22 * y
    M21 = -D20 * z + D22 * x
    M22 = D20 * y
    # Jc = [D | -M]  (tangent layout [rho, phi] of geo.se3_exp)
    Jc = jnp.stack([
        jnp.stack([D00, zr, D02, -M00, -M01, -M02], axis=-1),
        jnp.stack([zr, D11, D12, -M10, -M11, -M12], axis=-1),
        jnp.stack([D20, zr, D22, -M20, -M21, -M22], axis=-1),
    ], axis=-2)                                        # [..., 3, 6]
    R = Tcw[..., :3, :3]
    R0 = R[..., 0, :]
    R1 = R[..., 1, :]
    R2 = R[..., 2, :]
    Jp = jnp.stack([
        D00[..., None] * R0 + D02[..., None] * R2,
        D11[..., None] * R1 + D12[..., None] * R2,
        D20[..., None] * R0 + D22[..., None] * R2,
    ], axis=-2)                                        # [..., 3, 3]
    return r, Jc, Jp, z


def _edge_weights(octave, is_stereo, valid, inv_sigma2_levels):
    """Per-edge information scale and per-component mask.

    info = invSigma2[octave] * I (src/Optimizer.cc:117-171)."""
    inv_s2 = inv_sigma2_levels[jnp.clip(octave, 0, inv_sigma2_levels.shape[0] - 1)]
    comp = jnp.stack(
        [
            jnp.ones_like(inv_s2),
            jnp.ones_like(inv_s2),
            is_stereo.astype(inv_s2.dtype),
        ],
        axis=-1,
    )
    return jnp.where(valid, inv_s2, 0.0), comp


def _edge_chi2(r, inv_s2, comp):
    return inv_s2 * jnp.sum(comp * r * r, axis=-1)


# ---------------------------------------------------------------------------
# Pose-only optimization (the per-frame hot loop)
# ---------------------------------------------------------------------------

class PoseOptResult(NamedTuple):
    Tcw: jax.Array
    inliers: jax.Array     # [N] bool
    n_inliers: jax.Array   # scalar int32


import os as _os

# A/B knob: restore the r4 delayed-acceptance schedule (n_iters trips,
# initial evaluation counted, trailing candidate dropped) for accuracy
# bisects.
LM_LEGACY_SCHEDULE = _os.environ.get("LM_LEGACY_SCHEDULE", "0") not in ("0", "")


@functools.partial(
    jax.jit, static_argnames=("K", "bf", "rounds", "iters")
)
def pose_optimize(
    Tcw0: jax.Array,
    Xw: jax.Array,             # [N, 3]
    obs: jax.Array,            # [N, 3] (u, v, ur); ur ignored for mono
    octave: jax.Array,         # [N]
    is_stereo: jax.Array,      # [N] bool
    valid: jax.Array,          # [N] bool
    inv_sigma2_levels: jax.Array,
    K: tuple,
    bf: float,
    rounds: int = C.POSE_OPT_ROUNDS,
    iters: int = C.POSE_OPT_ITS_PER_ROUND,
) -> PoseOptResult:
    """Motion-only BA: 4 rounds x 10 LM iterations with chi2 inlier
    reclassification between rounds; Huber active for the first two rounds
    (src/Optimizer.cc:239-451).

    On a GPU the whole LM runs as one Triton kernel (ops/lm_pallas.py);
    `pose_optimize_xla` is the reference semantics and the CPU path."""
    if jax.default_backend() == "gpu":
        from orb_slam2_comment_tpu.ops.lm_pallas import (
            pose_optimize_pallas as impl,
        )
    else:
        impl = pose_optimize_xla
    return impl(
        Tcw0, Xw, obs, octave, is_stereo, valid, inv_sigma2_levels,
        K, bf, rounds=rounds, iters=iters,
    )


@functools.partial(
    jax.jit, static_argnames=("K", "bf", "rounds", "iters")
)
def pose_optimize_xla(
    Tcw0, Xw, obs, octave, is_stereo, valid, inv_sigma2_levels,
    K: tuple, bf: float,
    rounds: int = C.POSE_OPT_ROUNDS,
    iters: int = C.POSE_OPT_ITS_PER_ROUND,
) -> PoseOptResult:
    """`pose_optimize` as plain XLA ops (same arguments)."""
    batched_jac = jax.vmap(_edge_jacobians, in_axes=(None, 0, 0, None, None))
    chi2_th = jnp.where(is_stereo, C.CHI2_STEREO, C.CHI2_MONO)
    delta = jnp.where(is_stereo, C.HUBER_STEREO, C.HUBER_MONO)

    def robust_cost(r, inv_s2, comp, robust):
        chi2 = _edge_chi2(r, inv_s2, comp)
        d2 = delta * delta
        rho = jnp.where(chi2 <= d2, chi2, 2.0 * delta * jnp.sqrt(jnp.maximum(chi2, 1e-12)) - d2)
        return jnp.sum(jnp.where(robust, rho, chi2))

    def lm_round(T, inlier_mask, robust: bool):
        def body(it, carry):
            T, lam, cost = carry
            r, Jc, _, _ = batched_jac(T, Xw, obs, K, bf)
            inv_s2, comp = _edge_weights(octave, is_stereo, valid & inlier_mask, inv_sigma2_levels)
            chi2 = _edge_chi2(r, inv_s2, comp)
            hw = geo.huber_weight(chi2, delta) if robust else jnp.ones_like(chi2)
            w = (inv_s2 * hw)[:, None] * comp           # [N, 3]
            H = jnp.einsum("nki,nk,nkj->ij", Jc, w, Jc)
            # with J = d r / d xi, the damped GN step is dx = -H^-1 J^T W r
            b = -jnp.einsum("nki,nk,nk->i", Jc, w, r)
            Hd = H + lam * jnp.diag(jnp.diag(H)) + 1e-9 * jnp.eye(6)
            dx = jnp.linalg.solve(Hd, b)
            T_new = geo.se3_exp(dx) @ T
            r_new, _ = jax.vmap(_residual_unified, in_axes=(None, 0, 0, None, None))(T_new, Xw, obs, K, bf)
            new_cost = robust_cost(r_new, inv_s2, comp, robust)
            accept = new_cost < cost
            T = jnp.where(accept, T_new, T)
            lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-9), jnp.minimum(lam * 4.0, 1e6))
            cost = jnp.where(accept, new_cost, cost)
            return (T, lam, cost)

        r0, _ = jax.vmap(_residual_unified, in_axes=(None, 0, 0, None, None))(T, Xw, obs, K, bf)
        inv_s2, comp = _edge_weights(octave, is_stereo, valid & inlier_mask, inv_sigma2_levels)
        cost0 = robust_cost(r0, inv_s2, comp, robust)
        T, _, _ = jax.lax.fori_loop(0, iters, body, (T, 1e-3, cost0))
        # reclassify: chi2 against the per-edge threshold, depth must be
        # positive (src/Optimizer.cc:391-428)
        r, depth = jax.vmap(_residual_unified, in_axes=(None, 0, 0, None, None))(T, Xw, obs, K, bf)
        inv_s2_all, comp_all = _edge_weights(octave, is_stereo, valid, inv_sigma2_levels)
        chi2 = _edge_chi2(r, inv_s2_all, comp_all)
        new_mask = (chi2 <= chi2_th) & (depth > 0) & valid
        return T, new_mask

    # project the initial guess onto SO(3): a non-orthonormal rotation (e.g.
    # from float32 velocity-composition drift) is unfixable by left-increment
    # updates and leaves the optimizer stuck near the initial pose
    T = geo.orthonormalize_T(Tcw0)
    mask = valid
    for rd in range(rounds):
        T, mask = lm_round(T, mask, robust=rd < C.POSE_OPT_ROBUST_ROUNDS)
    return PoseOptResult(Tcw=geo.orthonormalize_T(T), inliers=mask, n_inliers=jnp.sum(mask))


# ---------------------------------------------------------------------------
# Bundle adjustment with Schur complement on landmarks
# ---------------------------------------------------------------------------

class BAProblem(NamedTuple):
    """Fixed-shape BA window. Pad with valid=False."""

    cam_T: jax.Array       # [Nc, 4, 4] world->cam
    cam_fixed: jax.Array   # [Nc] bool (pose held constant)
    cam_valid: jax.Array   # [Nc] bool
    pts: jax.Array         # [Np, 3]
    pt_valid: jax.Array    # [Np] bool
    obs_cam: jax.Array     # [O] int32 camera index
    obs_pt: jax.Array      # [O] int32 point index
    obs_uvr: jax.Array     # [O, 3]
    obs_oct: jax.Array     # [O] int32
    obs_stereo: jax.Array  # [O] bool
    obs_valid: jax.Array   # [O] bool


class BAResult(NamedTuple):
    cam_T: jax.Array
    pts: jax.Array
    obs_inlier: jax.Array  # [O] bool — post-opt chi2 gate
    cost: jax.Array


def _inv33(M):
    """Closed-form batched 3x3 inverse with damping for empty blocks."""
    M = M + 1e-8 * jnp.eye(3, dtype=M.dtype)
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    Cc = d * h - e * g
    det = a * A + b * B + c * Cc
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    adj = jnp.stack(
        [
            jnp.stack([A, -(b * i - c * h), (b * f - c * e)], axis=-1),
            jnp.stack([B, (a * i - c * g), -(a * f - c * d)], axis=-1),
            jnp.stack([Cc, -(a * h - b * g), (a * e - b * d)], axis=-1),
        ],
        axis=-2,
    )
    return adj * inv_det[..., None, None]


class LBASystem(NamedTuple):
    """One linearization of the local-BA window, in matmul-friendly
    layouts (point axis LAST, so elementwise ops run along the long axis)."""

    Hcc: jax.Array    # [F, 6, 6] free-camera blocks
    bc: jax.Array     # [F, 6]
    Hpp9: jax.Array   # [9, Np]  point blocks, rows i*3+j
    bp3: jax.Array    # [3, Np]
    E: jax.Array      # [F, 6, 3, Np] cam-point coupling
    cost: jax.Array   # scalar robust cost at the linearization point
    n_in: jax.Array   # scalar chi2-inlier count


def _lba_core(
    prob: BAProblem,
    inv_sigma2_levels: jax.Array,
    K: tuple,
    bf: float,
    cam_major: bool,
    n_free: int | None = None,
):
    """Factory for the local-BA LM machinery: returns
    (build_system, cost_of, iterate_da) closures over one problem. Shared
    by the monolithic `local_bundle_adjustment` and the chunked mapper
    machine (models/local_mapping.mapper_machine_step), whose BA phases
    re-enter the same LM sequence across several frame programs (P6: the
    reference's interruptible LocalBundleAdjustment,
    src/Optimizer.cc:453-778 + mbAbortBA force-stop :517-518).

    n_free: static count of LEADING camera slots that may be free; slots
    >= n_free must be fixed (their Jc is zeroed regardless). The reduced
    camera system is built only over this prefix — with the default
    16-free/16-fixed window that halves the latency-bound dense solve."""
    Nc, Np = prob.cam_T.shape[0], prob.pts.shape[0]
    F = Nc if n_free is None else max(1, min(n_free, Nc))
    chi2_th = jnp.where(prob.obs_stereo, C.CHI2_STEREO, C.CHI2_MONO)
    delta = jnp.where(prob.obs_stereo, C.HUBER_STEREO, C.HUBER_MONO)
    batched_jac = jax.vmap(_edge_jacobians, in_axes=(0, 0, 0, None, None))
    cam_free_mask = (~prob.cam_fixed) & prob.cam_valid

    def assemble(cam_T, pts, obs_ok, robust):
        T_o = cam_T[prob.obs_cam]
        X_o = pts[prob.obs_pt]
        r, Jc, Jp, depth = batched_jac(T_o, X_o, prob.obs_uvr, K, bf)
        inv_s2, comp = _edge_weights(
            prob.obs_oct, prob.obs_stereo, obs_ok, inv_sigma2_levels
        )
        chi2 = _edge_chi2(r, inv_s2, comp)
        hw = jnp.where(robust, geo.huber_weight(chi2, delta), 1.0)
        # zero camera Jacobians of fixed/invalid cameras
        Jc = Jc * cam_free_mask[prob.obs_cam, None, None]
        w = (inv_s2 * hw)[:, None] * comp  # [O, 3]
        return r, Jc, Jp, w, chi2, depth

    def cost_of(cam_T, pts, obs_ok, robust):
        T_o = cam_T[prob.obs_cam]
        X_o = pts[prob.obs_pt]
        r, _ = jax.vmap(_residual_unified, in_axes=(0, 0, 0, None, None))(
            T_o, X_o, prob.obs_uvr, K, bf
        )
        inv_s2, comp = _edge_weights(
            prob.obs_oct, prob.obs_stereo, obs_ok, inv_sigma2_levels
        )
        chi2 = _edge_chi2(r, inv_s2, comp)
        return cost_from_chi2(chi2, obs_ok, robust)

    def cost_from_chi2(chi2, obs_ok, robust):
        d2 = delta * delta
        rho = jnp.where(
            chi2 <= d2,
            chi2,
            2.0 * delta * jnp.sqrt(jnp.maximum(chi2, 1e-12)) - d2,
        )
        n_in = jnp.sum(obs_ok & (chi2 <= chi2_th))
        return jnp.sum(jnp.where(robust, rho, chi2)), n_in

    def build_system(cam_T, pts, obs_ok, robust) -> LBASystem:
        # Block assembly WITHOUT scatters. The observation table is
        # REGULAR in the camera axis (obs_cam = repeat(arange)), so camera
        # blocks are reshape-sums; the irregular point axis becomes a
        # per-camera one-hot matmul.
        r, Jc, Jp, w, chi2, _ = assemble(cam_T, pts, obs_ok, robust)
        cost, n_in = cost_from_chi2(chi2, obs_ok, robust)
        JcW = Jc * w[:, :, None]                      # [O, 3, 6]
        JpW = Jp * w[:, :, None]                      # [O, 3, 3]
        if cam_major:
            N_per = prob.obs_cam.shape[0] // Nc
            Hcc = jnp.einsum("oki,okj->oij", JcW, Jc).reshape(
                Nc, N_per, 6, 6).sum(1)[:F]
            bc = -jnp.einsum("oki,ok->oi", JcW, r).reshape(
                Nc, N_per, 6).sum(1)[:F]
            # per-point contributions, packed to one [O, 30] matrix:
            # Hpp (9) | bp (3) | E=JcW^T Jp (18)
            hpp_o = jnp.einsum("oki,okj->oij", JpW, Jp).reshape(-1, 9)
            bp_o = -jnp.einsum("oki,ok->oi", JpW, r)
            e_o = jnp.einsum("oki,okj->oij", JcW, Jp).reshape(-1, 18)
            packed_o = jnp.concatenate([hpp_o, bp_o, e_o], axis=-1).reshape(
                Nc, N_per, 30)
            # onehot_pt is CONSTANT across LM iterations (closure over the
            # problem layout, built once below): one batched einsum
            # replaces 5 sort-based scatter-adds per iteration. Output
            # layout ckp puts the point axis LAST for the Schur math.
            out = jnp.einsum(
                "cnp,cnk->ckp", onehot_pt, packed_o,
                preferred_element_type=jnp.float32,
            )  # [Nc,30,Np]
            Hpp9 = out[:, :9, :].sum(0)
            bp3 = out[:, 9:12, :].sum(0)
            E = out[:F, 12:30, :].reshape(F, 6, 3, Np)
        else:
            # general (ragged) layout: scatter-based assembly
            Hcc = jnp.zeros((Nc, 6, 6)).at[prob.obs_cam].add(
                jnp.einsum("oki,okj->oij", JcW, Jc)
            )[:F]
            bc = jnp.zeros((Nc, 6)).at[prob.obs_cam].add(
                -jnp.einsum("oki,ok->oi", JcW, r)
            )[:F]
            Hpp = jnp.zeros((Np, 3, 3)).at[prob.obs_pt].add(
                jnp.einsum("oki,okj->oij", JpW, Jp)
            )
            bp = jnp.zeros((Np, 3)).at[prob.obs_pt].add(
                -jnp.einsum("oki,ok->oi", JpW, r)
            )
            E4 = jnp.zeros((Nc, Np, 6, 3)).at[prob.obs_cam, prob.obs_pt].add(
                jnp.einsum("oki,okj->oij", JcW, Jp)
            )
            Hpp9 = Hpp.reshape(Np, 9).T
            bp3 = bp.T
            E = E4[:F].transpose(0, 2, 3, 1)
        return LBASystem(Hcc=Hcc, bc=bc, Hpp9=Hpp9, bp3=bp3, E=E,
                         cost=cost, n_in=n_in)

    def solve_from_system(sys_: LBASystem, lam, cam_T, pts):
        """One damped Gauss-Newton step from an assembled system: Schur
        complement on the points, dense Cholesky on the free-camera
        prefix, back-substitution. Point-axis-last layouts throughout."""
        # camera damping + anchoring of dynamically-fixed prefix slots
        Hcc_d = sys_.Hcc + lam * jnp.eye(6) * jnp.maximum(
            jnp.einsum("cii->c", sys_.Hcc)[:, None, None] / 6.0, 1e-6
        )
        cfree = cam_free_mask[:F]
        Hcc_d = jnp.where(cfree[:, None, None], Hcc_d, jnp.eye(6))
        bc = jnp.where(cfree[:, None], sys_.bc, 0.0)
        # point damping + closed-form symmetric 3x3 inverse, SoA over [Np]
        h = sys_.Hpp9
        dmp = lam * jnp.maximum((h[0] + h[4] + h[8]) / 3.0, 1e-6) + 1e-8
        a, b_, c_ = h[0] + dmp, h[1], h[2]
        d_, e_, f_ = h[3], h[4] + dmp, h[5]
        g_, hh, i_ = h[6], h[7], h[8] + dmp
        A = e_ * i_ - f_ * hh
        B = -(d_ * i_ - f_ * g_)
        Cc = d_ * hh - e_ * g_
        det = a * A + b_ * B + c_ * Cc
        inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
        Hi = jnp.stack([
            jnp.stack([A, -(b_ * i_ - c_ * hh), (b_ * f_ - c_ * e_)]),
            jnp.stack([B, (a * i_ - c_ * g_), -(a * f_ - c_ * d_)]),
            jnp.stack([Cc, -(a * hh - b_ * g_), (a * e_ - b_ * d_)]),
        ]) * inv_det                                   # [3, 3, Np]
        E = sys_.E                                     # [F, 6, 3, Np]
        # EH[c,i,l] = sum_j E[c,i,j] * Hi[j,l] — unrolled elementwise
        EH = jnp.stack([
            sum(E[:, :, j, :] * Hi[j, l, :] for j in range(3))
            for l in range(3)
        ], axis=2)                                     # [F, 6, 3, Np]
        A2 = EH.reshape(F * 6, 3 * Np)
        B2 = E.reshape(F * 6, 3 * Np)
        ci = jnp.arange(F)
        Hcc_embed = jnp.zeros((F * 6, F * 6)).at[
            (ci[:, None, None] * 6 + jnp.arange(6)[None, :, None]),
            (ci[:, None, None] * 6 + jnp.arange(6)[None, None, :]),
        ].set(Hcc_d)
        S_mat = Hcc_embed - A2 @ B2.T
        rhs = bc.reshape(-1) - A2 @ sys_.bp3.reshape(-1)
        L = jnp.linalg.cholesky(S_mat + 1e-9 * jnp.eye(F * 6))
        dc = jax.scipy.linalg.cho_solve((L, True), rhs).reshape(F, 6)
        # back-substitute points: dp = Hpp^-1 (bp - E^T dc)
        t3 = (dc.reshape(-1) @ B2).reshape(3, Np)
        rp = sys_.bp3 - t3
        dp3 = jnp.stack([
            sum(Hi[j, l, :] * rp[j] for j in range(3)) for l in range(3)
        ])                                             # [3, Np]
        dcs = jax.vmap(lambda d, T: geo.se3_exp(d) @ T)(dc, cam_T[:F])
        head = jnp.where(cfree[:, None, None], dcs, cam_T[:F])
        cam_T_new = jnp.concatenate([head, cam_T[F:]], axis=0)
        pts_new = jnp.where(prob.pt_valid[:, None], pts + dp3.T, pts)
        return cam_T_new, pts_new

    def iterate_da(carry, n_iters, robust, tol):
        """Delayed-acceptance LM: the accept test for step k reuses step
        k+1's build_system pass (ONE linearization per iteration instead
        of two); on a rejection the system re-assembles at the last
        accepted state under a rare lax.cond branch. Guards: cost decrease
        + inlier survival; stall-based early termination."""
        cam_T, pts, lam, cost, n_in, obs_ok = carry

        extra = 0 if LM_LEGACY_SCHEDULE else 1

        def cond_fn(s):
            i, stall = s[0], s[1]
            # n_iters + 1 trips: trip 0 evaluates the INCOMING state (not
            # a step), trips 1..n_iters evaluate+accept the n_iters
            # candidate steps — so the final candidate is not discarded
            # and the effective step count matches the reference's 5+10
            # schedule (ADVICE r4).
            return (i < n_iters + extra) & (stall < 2)

        def body(s):
            (i, stall, cur_T, cur_pts, ref_T, ref_pts, ref_cost, ref_nin,
             lam) = s
            first = (i == 0) & (not LM_LEGACY_SCHEDULE)
            sys_cur = build_system(cur_T, cur_pts, obs_ok, robust)
            ok = (sys_cur.cost <= ref_cost) & (
                sys_cur.n_in.astype(jnp.float32)
                >= 0.6 * ref_nin.astype(jnp.float32)
            )

            def use_cur(_):
                return cur_T, cur_pts, sys_cur

            def use_ref(_):
                return ref_T, ref_pts, build_system(
                    ref_T, ref_pts, obs_ok, robust)

            lin_T, lin_pts, sys_ = jax.lax.cond(ok, use_cur, use_ref, 0)
            # trip 0 re-evaluates the incoming state: its trivially-"ok"
            # outcome must drive neither damping nor the stall counter
            lam = jnp.where(
                first, lam,
                jnp.where(ok, jnp.maximum(lam * 0.5, 1e-9),
                          jnp.minimum(lam * 4.0, 1e6)))
            new_T, new_pts = solve_from_system(sys_, lam, lin_T, lin_pts)
            improved = (ref_cost - sys_.cost) > tol * jnp.maximum(
                jnp.abs(ref_cost), 1.0)
            stall = jnp.where(first, stall,
                              jnp.where(improved, 0, stall + 1))
            return (i + 1, stall, new_T, new_pts, lin_T, lin_pts,
                    jnp.minimum(sys_.cost, ref_cost), sys_.n_in, lam)

        s0 = (jnp.asarray(0), jnp.asarray(0), cam_T, pts, cam_T, pts,
              cost, n_in, lam)
        s = jax.lax.while_loop(cond_fn, body, s0)
        ref_T, ref_pts, ref_cost, ref_nin, lam = s[4], s[5], s[6], s[7], s[8]
        # the trailing candidate step is unevaluated — return the last
        # ACCEPTED state, whose cost/inliers are known
        return (ref_T, ref_pts, lam, ref_cost, ref_nin, obs_ok)

    if cam_major:
        N_per_ = prob.obs_cam.shape[0] // Nc
        pl_ = prob.obs_pt.reshape(Nc, N_per_)
        # bf16: the one-hot is exact 0/1 and the [Nc, N_per, Np] buffer is
        # the LM iteration's largest device-memory tenant — halving it halves the
        # einsum's bandwidth cost; accumulation stays f32 via
        # preferred_element_type inside einsum
        onehot_pt = (
            pl_[:, :, None] == jnp.arange(Np)[None, None, :]
        ).astype(jnp.bfloat16)                        # [Nc, N_per, Np]
    else:
        onehot_pt = None

    return build_system, cost_of, iterate_da


# local-BA LM carry: (cam_T, pts, lam, cost, n_in, obs_ok)

def lba_init(prob: BAProblem, inv_sigma2_levels, K, bf, cam_major=True):
    """Initial LM carry for a (possibly chunked) local BA.

    SO(3)-projects the input poses (see pose_optimize): 15 LM steps of
    exp(d) @ T per window, windows chained over the whole run."""
    _, cost_of, _ = _lba_core(prob, inv_sigma2_levels, K, bf, cam_major)
    cam_T = geo.orthonormalize_T(prob.cam_T)
    cost0, n_in0 = cost_of(cam_T, prob.pts, prob.obs_valid, True)
    return (cam_T, prob.pts, jnp.asarray(1e-4), cost0, n_in0, prob.obs_valid)


def lba_iterate(prob: BAProblem, inv_sigma2_levels, carry, K, bf,
                n_iters: int, robust: bool, cam_major=True,
                tol: float = 1e-3, n_free=None):
    """Advance the LM carry by up to n_iters steps with early termination
    when two consecutive steps fail to reduce the cost by a relative tol
    (g2o's OptimizationAlgorithmLevenberg terminate criterion — the
    reference's fixed 5+10 schedule usually converges in fewer steps on
    incremental windows, and the saved iterations are pure device time)."""
    _, _, iterate_da = _lba_core(prob, inv_sigma2_levels, K, bf,
                                 cam_major, n_free)
    return iterate_da(carry, n_iters, robust, tol)


def lba_prune(prob: BAProblem, inv_sigma2_levels, carry, K, bf,
              cam_major=True):
    """Mid-schedule observation prune (src/Optimizer.cc:655-700): drop
    chi2/depth outliers from the active set and reset the damping."""
    _, cost_of, _ = _lba_core(prob, inv_sigma2_levels, K, bf, cam_major)
    cam_T, pts, _, _, _, _ = carry
    chi2_th = jnp.where(prob.obs_stereo, C.CHI2_STEREO, C.CHI2_MONO)
    T_o, X_o = cam_T[prob.obs_cam], pts[prob.obs_pt]
    r, depth = jax.vmap(_residual_unified, in_axes=(0, 0, 0, None, None))(
        T_o, X_o, prob.obs_uvr, K, bf
    )
    inv_s2, comp = _edge_weights(
        prob.obs_oct, prob.obs_stereo, prob.obs_valid, inv_sigma2_levels
    )
    chi2 = _edge_chi2(r, inv_s2, comp)
    obs_ok = prob.obs_valid & (chi2 <= chi2_th) & (depth > 0)
    cost1, n_in1 = cost_of(cam_T, pts, obs_ok, False)
    return (cam_T, pts, jnp.asarray(1e-4), cost1, n_in1, obs_ok)


def lba_finalize(prob: BAProblem, inv_sigma2_levels, carry, K, bf) -> BAResult:
    """Final chi2 classification for observation erasure
    (src/Optimizer.cc:711-757)."""
    cam_T, pts, _, cost, _, _ = carry
    chi2_th = jnp.where(prob.obs_stereo, C.CHI2_STEREO, C.CHI2_MONO)
    T_o, X_o = cam_T[prob.obs_cam], pts[prob.obs_pt]
    r, depth = jax.vmap(_residual_unified, in_axes=(0, 0, 0, None, None))(
        T_o, X_o, prob.obs_uvr, K, bf
    )
    inv_s2, comp = _edge_weights(
        prob.obs_oct, prob.obs_stereo, prob.obs_valid, inv_sigma2_levels
    )
    chi2 = _edge_chi2(r, inv_s2, comp)
    inlier = prob.obs_valid & (chi2 <= chi2_th) & (depth > 0)
    return BAResult(
        cam_T=geo.orthonormalize_T(cam_T), pts=pts, obs_inlier=inlier, cost=cost
    )


@functools.partial(jax.jit, static_argnames=("K", "bf", "iters1", "iters2",
                                              "cam_major", "n_free"))
def local_bundle_adjustment(
    prob: BAProblem,
    inv_sigma2_levels: jax.Array,
    K: tuple,
    bf: float,
    iters1: int = C.LOCAL_BA_ITS_PHASE1,
    iters2: int = C.LOCAL_BA_ITS_PHASE2,
    cam_major: bool = False,
    n_free: int | None = None,
) -> BAResult:
    """Two-phase local BA: iters1 LM steps, chi2-prune observations, iters2
    more steps, then a final outlier classification
    (src/Optimizer.cc:453-778: 5 iters -> prune -> 10 iters -> erase).

    The reduced camera system is built densely: with E the [Nc,Np] grid of
    6x3 cam-point coupling blocks (one obs per pair), S = Hcc - E Hpp^-1 E^T
    is a single [6Nc, 3Np] @ [3Np, 6Nc] matmul — a dense shape for the
    <=~100-camera windows the covisibility graph produces.
    """
    carry = lba_init(prob, inv_sigma2_levels, K, bf, cam_major)
    carry = lba_iterate(prob, inv_sigma2_levels, carry, K, bf, iters1,
                        robust=True, cam_major=cam_major, n_free=n_free)
    carry = lba_prune(prob, inv_sigma2_levels, carry, K, bf, cam_major)
    carry = lba_iterate(prob, inv_sigma2_levels, carry, K, bf, iters2,
                        robust=False, cam_major=cam_major, n_free=n_free)
    return lba_finalize(prob, inv_sigma2_levels, carry, K, bf)


# ---------------------------------------------------------------------------
# Sim3 optimization (loop alignment)
# ---------------------------------------------------------------------------

class Sim3Result(NamedTuple):
    S12: jax.Array
    inliers: jax.Array
    n_inliers: jax.Array


@functools.partial(
    jax.jit, static_argnames=("K1", "K2", "fix_scale", "iters")
)
def sim3_optimize(
    S12_0: jax.Array,       # [4,4] Sim3 cam2->cam1
    Xc1: jax.Array,         # [N,3] points in cam1 frame
    Xc2: jax.Array,         # [N,3] matched points in cam2 frame
    obs1: jax.Array,        # [N,2] pixels in image 1
    obs2: jax.Array,        # [N,2] pixels in image 2
    inv_sigma2_1: jax.Array,  # [N] info of obs1 edges
    inv_sigma2_2: jax.Array,  # [N]
    valid: jax.Array,       # [N] bool
    K1: tuple,
    K2: tuple,
    fix_scale: bool = False,
    chi2_th: float = 10.0,
    iters: int = 10,
) -> Sim3Result:
    """Single-vertex Sim3 LM with paired forward/inverse projection edges
    (Optimizer::OptimizeSim3, src/Optimizer.cc:1046-1244: 5 iters, prune
    chi2>th2, then 10 more; returns inlier count)."""

    def residuals(S12):
        S21 = geo.inv_T(S12)
        r1 = obs1 - geo.project(K1, geo.transform_points(S12, Xc2))
        r2 = obs2 - geo.project(K2, geo.transform_points(S21, Xc1))
        return r1, r2

    def chi2_of(S12):
        r1, r2 = residuals(S12)
        c1 = inv_sigma2_1 * jnp.sum(r1 * r1, axis=-1)
        c2 = inv_sigma2_2 * jnp.sum(r2 * r2, axis=-1)
        return c1, c2

    scale_mask = jnp.ones(7).at[6].set(0.0 if fix_scale else 1.0)

    def lm_body(it, carry):
        S12, lam, cost, ok = carry

        def r_of(dz):
            S = geo.sim3_exp(dz * scale_mask) @ S12
            r1, r2 = residuals(S)
            return jnp.concatenate([r1, r2], axis=0)  # [2N, 2]

        z = jnp.zeros(7)
        J = jax.jacfwd(r_of)(z)                       # [2N, 2, 7]
        r = r_of(z)
        w = jnp.concatenate([inv_sigma2_1 * ok, inv_sigma2_2 * ok])[:, None]
        H = jnp.einsum("nki,nk,nkj->ij", J, jnp.broadcast_to(w, r.shape), J)
        b = -jnp.einsum("nki,nk->i", J * jnp.broadcast_to(w, r.shape)[:, :, None], r)
        Hd = H + lam * jnp.diag(jnp.diag(H)) + 1e-8 * jnp.eye(7)
        dz = jnp.linalg.solve(Hd, b) * scale_mask
        S_new = geo.sim3_exp(dz) @ S12
        c1, c2 = chi2_of(S_new)
        new_cost = jnp.sum(jnp.where(ok, c1 + c2, 0.0))
        accept = new_cost < cost
        S12 = jnp.where(accept, S_new, S12)
        lam = jnp.where(accept, lam * 0.5, lam * 4.0)
        cost = jnp.where(accept, new_cost, cost)
        return (S12, lam, cost, ok)

    ok = valid
    c1, c2 = chi2_of(S12_0)
    cost0 = jnp.sum(jnp.where(ok, c1 + c2, 0.0))
    S12, _, _, _ = jax.lax.fori_loop(0, 5, lm_body, (S12_0, jnp.asarray(1e-3), cost0, ok))
    # prune: both-direction chi2 gate (src/Optimizer.cc:1171-1205)
    c1, c2 = chi2_of(S12)
    ok = valid & (c1 < chi2_th) & (c2 < chi2_th)
    cost1 = jnp.sum(jnp.where(ok, c1 + c2, 0.0))
    S12, _, _, _ = jax.lax.fori_loop(0, iters, lm_body, (S12, jnp.asarray(1e-3), cost1, ok))
    c1, c2 = chi2_of(S12)
    inl = valid & (c1 < chi2_th) & (c2 < chi2_th)
    return Sim3Result(S12=S12, inliers=inl, n_inliers=jnp.sum(inl))


# ---------------------------------------------------------------------------
# Essential-graph (pose-graph) optimization
# ---------------------------------------------------------------------------

class PoseGraphResult(NamedTuple):
    S: jax.Array      # [K, 4, 4] optimized Sim3 world->kf
    cost: jax.Array


@functools.partial(jax.jit, static_argnames=("fix_scale", "iters"))
def essential_graph_optimize(
    S0: jax.Array,          # [K, 4, 4] initial Sim3 (world->kf)
    kf_valid: jax.Array,    # [K] bool
    kf_fixed: jax.Array,    # [K] bool (the loop KF, src/Optimizer.cc:824)
    edge_i: jax.Array,      # [E] int32
    edge_j: jax.Array,      # [E] int32
    edge_Sji: jax.Array,    # [E, 4, 4] measured relative Sim3 (i -> j)
    edge_valid: jax.Array,  # [E] bool
    fix_scale: bool = False,
    iters: int = C.ESSENTIAL_GRAPH_ITERS,
) -> PoseGraphResult:
    """7-DoF pose graph over spanning-tree + loop + strong-covisibility
    edges with identity information (Optimizer::OptimizeEssentialGraph,
    src/Optimizer.cc:781-1044). Solved with damped GN; the normal matrix
    is assembled densely ([7K, 7K]) — fine for the <=1-2k keyframes the
    essential graph reaches, and one dense Cholesky beats a sparse
    solver at this scale.
    """
    Kn = S0.shape[0]
    scale_mask = jnp.ones(7).at[6].set(0.0 if fix_scale else 1.0)
    free = kf_valid & (~kf_fixed)

    def edge_residual(Si, Sj, Sji):
        return geo.sim3_log(Sji @ Si @ geo.inv_T(Sj))  # [7]

    def residual_of(S, di, dj):
        # perturb vertices i and j of one edge
        def f(di, dj, Si, Sj, Sji):
            Si_p = geo.sim3_exp(di * scale_mask) @ Si
            Sj_p = geo.sim3_exp(dj * scale_mask) @ Sj
            return edge_residual(Si_p, Sj_p, Sji)
        return f

    def total_cost(S):
        r = jax.vmap(edge_residual)(S[edge_i], S[edge_j], edge_Sji)
        return jnp.sum(jnp.where(edge_valid[:, None], r * r, 0.0))

    def gn_body(it, carry):
        S, lam, cost = carry
        Si, Sj = S[edge_i], S[edge_j]
        z = jnp.zeros(7)

        def per_edge(Si, Sj, Sji):
            f = lambda di, dj: edge_residual(
                geo.sim3_exp(di * scale_mask) @ Si,
                geo.sim3_exp(dj * scale_mask) @ Sj,
                Sji,
            )
            r = f(z, z)
            Ji = jax.jacfwd(f, argnums=0)(z, z)
            Jj = jax.jacfwd(f, argnums=1)(z, z)
            return r, Ji, Jj

        r, Ji, Jj = jax.vmap(per_edge)(Si, Sj, edge_Sji)
        ew = edge_valid.astype(jnp.float32)
        # mask fixed vertices
        free_i = free[edge_i].astype(jnp.float32)
        free_j = free[edge_j].astype(jnp.float32)
        Ji = Ji * (ew * free_i)[:, None, None]
        Jj = Jj * (ew * free_j)[:, None, None]
        rw = r * ew[:, None]
        # dense normal equations
        H = jnp.zeros((Kn, Kn, 7, 7))
        H = H.at[edge_i, edge_i].add(jnp.einsum("eki,ekj->eij", Ji, Ji))
        H = H.at[edge_j, edge_j].add(jnp.einsum("eki,ekj->eij", Jj, Jj))
        H = H.at[edge_i, edge_j].add(jnp.einsum("eki,ekj->eij", Ji, Jj))
        H = H.at[edge_j, edge_i].add(jnp.einsum("eki,ekj->eij", Jj, Ji))
        b = jnp.zeros((Kn, 7))
        # GN step: minimize ||r + J dx||^2 -> H dx = -J^T r
        b = b.at[edge_i].add(-jnp.einsum("eki,ek->ei", Ji, rw))
        b = b.at[edge_j].add(-jnp.einsum("eki,ek->ei", Jj, rw))
        Hf = H.transpose(0, 2, 1, 3).reshape(Kn * 7, Kn * 7)
        diag = jnp.diag(Hf)
        Hf = Hf + jnp.diag(lam * jnp.maximum(diag, 1e-6) + 1e-8)
        # anchor fixed/invalid vertices
        anchor = jnp.repeat(~free, 7)
        Hf = jnp.where(
            anchor[:, None] | anchor[None, :],
            jnp.where(
                jnp.eye(Kn * 7, dtype=bool), 1.0, 0.0
            ),
            Hf,
        )
        bf_ = jnp.where(anchor, 0.0, b.reshape(-1))
        dx = jnp.linalg.solve(Hf, bf_).reshape(Kn, 7) * scale_mask
        S_new = jax.vmap(lambda d, s: geo.sim3_exp(d) @ s)(dx, S)
        S_new = jnp.where(free[:, None, None], S_new, S)
        new_cost = total_cost(S_new)
        accept = new_cost < cost
        S = jnp.where(accept, S_new, S)
        lam = jnp.where(accept, lam * 0.5, lam * 4.0)
        cost = jnp.where(accept, new_cost, cost)
        return (S, lam, cost)

    cost0 = total_cost(S0)
    S, _, cost = jax.lax.fori_loop(0, iters, gn_body, (S0, jnp.asarray(1e-4), cost0))
    return PoseGraphResult(S=S, cost=cost)


@functools.partial(
    jax.jit, static_argnames=("fix_scale", "iters", "cg_iters")
)
def essential_graph_optimize_sparse(
    S0: jax.Array,          # [K, 4, 4] initial Sim3 (world->kf)
    kf_valid: jax.Array,    # [K] bool
    kf_fixed: jax.Array,    # [K] bool (the loop KF, src/Optimizer.cc:824)
    edge_i: jax.Array,      # [E] int32
    edge_j: jax.Array,      # [E] int32
    edge_Sji: jax.Array,    # [E, 4, 4] measured relative Sim3 (i -> j)
    edge_valid: jax.Array,  # [E] bool
    fix_scale: bool = False,
    iters: int = C.ESSENTIAL_GRAPH_ITERS,
    cg_iters: int = 100,
) -> PoseGraphResult:
    """Sparse large-map OptimizeEssentialGraph (src/Optimizer.cc:781-1044):
    identical residuals/edge sets to `essential_graph_optimize`, but the
    normal system is never materialized. H·v is computed edge-wise with
    per-edge [7,7] blocks + segment scatter-adds, solved by block-Jacobi
    preconditioned CG. Memory is O(E·49) instead of O(K²·49); at the
    reference's KITTI-00 scale (~1.3k KFs) the dense [7K,7K] Cholesky is
    architecturally impossible while this runs in a few MB. The scatter
    pattern is the same segment-sum shape the distributed BA shards, so
    the edge arrays can be sharded across a mesh unchanged.
    """
    Kn = S0.shape[0]
    scale_mask = jnp.ones(7).at[6].set(0.0 if fix_scale else 1.0)
    free = kf_valid & (~kf_fixed)

    def edge_residual(Si, Sj, Sji):
        return geo.sim3_log(Sji @ Si @ geo.inv_T(Sj))  # [7]

    def total_cost(S):
        r = jax.vmap(edge_residual)(S[edge_i], S[edge_j], edge_Sji)
        return jnp.sum(jnp.where(edge_valid[:, None], r * r, 0.0))

    def gn_body(it, carry):
        S, lam, cost = carry
        Si, Sj = S[edge_i], S[edge_j]
        z = jnp.zeros(7)

        def per_edge(Si, Sj, Sji):
            f = lambda di, dj: edge_residual(
                geo.sim3_exp(di * scale_mask) @ Si,
                geo.sim3_exp(dj * scale_mask) @ Sj,
                Sji,
            )
            r = f(z, z)
            Ji = jax.jacfwd(f, argnums=0)(z, z)
            Jj = jax.jacfwd(f, argnums=1)(z, z)
            return r, Ji, Jj

        r, Ji, Jj = jax.vmap(per_edge)(Si, Sj, edge_Sji)
        ew = edge_valid.astype(jnp.float32)
        Ji = Ji * (ew * free[edge_i].astype(jnp.float32))[:, None, None]
        Jj = Jj * (ew * free[edge_j].astype(jnp.float32))[:, None, None]
        rw = r * ew[:, None]
        # per-edge normal blocks (never assembled into a [K,K] matrix)
        Bii = jnp.einsum("eki,ekj->eij", Ji, Ji)   # [E,7,7]
        Bjj = jnp.einsum("eki,ekj->eij", Jj, Jj)
        Bij = jnp.einsum("eki,ekj->eij", Ji, Jj)
        b = jnp.zeros((Kn, 7)).at[edge_i].add(-jnp.einsum("eki,ek->ei", Ji, rw))
        b = b.at[edge_j].add(-jnp.einsum("eki,ek->ei", Jj, rw))
        # block-diagonal of H + LM damping; identity on anchored vertices
        Hd = jnp.zeros((Kn, 7, 7)).at[edge_i].add(Bii).at[edge_j].add(Bjj)
        dvec = jnp.einsum("kii->ki", Hd)
        Hd = Hd + jax.vmap(jnp.diag)(lam * jnp.maximum(dvec, 1e-6) + 1e-8)
        eye7 = jnp.eye(7)
        Hd = jnp.where(free[:, None, None], Hd, eye7)
        Minv = jnp.linalg.inv(Hd)  # block-Jacobi preconditioner [K,7,7]

        damp = lam * jnp.maximum(dvec, 1e-6) + 1e-8  # [K,7]

        def hv(v):
            vi, vj = v[edge_i], v[edge_j]
            ui = jnp.einsum("eij,ej->ei", Bii, vi) + jnp.einsum(
                "eij,ej->ei", Bij, vj)
            uj = jnp.einsum("eji,ej->ei", Bij, vi) + jnp.einsum(
                "eij,ej->ei", Bjj, vj)
            out = jnp.zeros((Kn, 7)).at[edge_i].add(ui).at[edge_j].add(uj)
            out = out + damp * v
            return jnp.where(free[:, None], out, v)  # identity on anchors

        bf_ = jnp.where(free[:, None], b, 0.0)

        def cg_step(t, st):
            x, rr, p, rz = st
            Ap = hv(p)
            denom = jnp.sum(p * Ap)
            alpha = jnp.where(denom > 1e-12, rz / jnp.maximum(denom, 1e-12), 0.0)
            x = x + alpha * p
            rr = rr - alpha * Ap
            zz = jnp.einsum("kij,kj->ki", Minv, rr)
            rz_new = jnp.sum(rr * zz)
            beta = jnp.where(rz > 1e-12, rz_new / jnp.maximum(rz, 1e-12), 0.0)
            p = zz + beta * p
            return (x, rr, p, rz_new)

        x0 = jnp.zeros((Kn, 7))
        z0 = jnp.einsum("kij,kj->ki", Minv, bf_)
        dx, _, _, _ = jax.lax.fori_loop(
            0, cg_iters, cg_step, (x0, bf_, z0, jnp.sum(bf_ * z0)))
        dx = dx * scale_mask
        S_new = jax.vmap(lambda d, s: geo.sim3_exp(d) @ s)(dx, S)
        S_new = jnp.where(free[:, None, None], S_new, S)
        new_cost = total_cost(S_new)
        accept = new_cost < cost
        S = jnp.where(accept, S_new, S)
        lam = jnp.where(accept, lam * 0.5, lam * 4.0)
        cost = jnp.where(accept, new_cost, cost)
        return (S, lam, cost)

    cost0 = total_cost(S0)
    S, _, cost = jax.lax.fori_loop(
        0, iters, gn_body, (S0, jnp.asarray(1e-4), cost0))
    return PoseGraphResult(S=S, cost=cost)


# ---------------------------------------------------------------------------
# Global BA: matrix-free Schur + preconditioned CG (scales past the dense
# window; also the computational core of distributed BA, parallel.dist_ba)
# ---------------------------------------------------------------------------

def _assemble_blocks(prob: BAProblem, cam_T, pts, obs_ok, inv_sigma2_levels,
                     K, bf, robust: bool):
    """Per-observation residuals, Jacobians and the block pieces of the
    normal equations. Everything here is segment-sum shaped: when the
    observation arrays are sharded across devices, XLA turns the
    scatter-adds into psums — this is the distributed-BA communication
    pattern (SURVEY.md §2c)."""
    Nc, Np = cam_T.shape[0], pts.shape[0]
    delta = jnp.where(prob.obs_stereo, C.HUBER_STEREO, C.HUBER_MONO)
    T_o = cam_T[prob.obs_cam]
    X_o = pts[prob.obs_pt]
    r, Jc, Jp, depth = jax.vmap(
        _edge_jacobians, in_axes=(0, 0, 0, None, None)
    )(T_o, X_o, prob.obs_uvr, K, bf)
    inv_s2, comp = _edge_weights(
        prob.obs_oct, prob.obs_stereo, obs_ok, inv_sigma2_levels
    )
    chi2 = _edge_chi2(r, inv_s2, comp)
    hw = jnp.where(robust, geo.huber_weight(chi2, delta), 1.0)
    cam_free = (~prob.cam_fixed) & prob.cam_valid
    Jc = Jc * cam_free[prob.obs_cam, None, None]
    w = (inv_s2 * hw)[:, None] * comp
    JcW = Jc * w[:, :, None]
    JpW = Jp * w[:, :, None]
    Hcc = jnp.zeros((Nc, 6, 6)).at[prob.obs_cam].add(
        jnp.einsum("oki,okj->oij", JcW, Jc)
    )
    bc = jnp.zeros((Nc, 6)).at[prob.obs_cam].add(
        -jnp.einsum("oki,ok->oi", JcW, r)
    )
    Hpp = jnp.zeros((Np, 3, 3)).at[prob.obs_pt].add(
        jnp.einsum("oki,okj->oij", JpW, Jp)
    )
    bp = jnp.zeros((Np, 3)).at[prob.obs_pt].add(
        -jnp.einsum("oki,ok->oi", JpW, r)
    )
    A = jnp.einsum("oki,okj->oij", JcW, Jp)  # [O, 6, 3] cam-point coupling
    return Hcc, bc, Hpp, bp, A, cam_free


def _gba_cost(prob: BAProblem, cam_T, pts, obs_ok, inv_sigma2_levels, K, bf,
              robust: bool):
    T_o = cam_T[prob.obs_cam]
    X_o = pts[prob.obs_pt]
    r, _ = jax.vmap(_residual_unified, in_axes=(0, 0, 0, None, None))(
        T_o, X_o, prob.obs_uvr, K, bf
    )
    inv_s2, comp = _edge_weights(
        prob.obs_oct, prob.obs_stereo, obs_ok, inv_sigma2_levels
    )
    chi2 = _edge_chi2(r, inv_s2, comp)
    delta = jnp.where(prob.obs_stereo, C.HUBER_STEREO, C.HUBER_MONO)
    d2 = delta * delta
    rho = jnp.where(
        chi2 <= d2, chi2,
        2.0 * delta * jnp.sqrt(jnp.maximum(chi2, 1e-12)) - d2,
    )
    return jnp.sum(jnp.where(robust, rho, chi2))


@functools.partial(
    jax.jit, static_argnames=("K", "bf", "iters", "cg_iters", "robust_iters")
)
def global_bundle_adjustment(
    prob: BAProblem,
    inv_sigma2_levels: jax.Array,
    K: tuple,
    bf: float,
    iters: int = C.GBA_ITERS,
    cg_iters: int = 40,
    robust_iters: int = 5,
) -> BAResult:
    """Full-map BA (Optimizer::GlobalBundleAdjustemnt/BundleAdjustment,
    src/Optimizer.cc:41-237) without materializing the camera-point
    coupling grid: the reduced camera system S = Hcc - E Hpp^-1 E^T is
    applied matrix-free inside a block-Jacobi preconditioned CG. Memory is
    O(observations), so this path scales to every keyframe/point in the
    map (and to multiple devices by sharding the observation axis)."""
    lm_step = _gba_make_lm_step(
        prob, inv_sigma2_levels, K, bf, cg_iters, robust_iters
    )

    cost0 = _gba_cost(
        prob, prob.cam_T, prob.pts, prob.obs_valid, inv_sigma2_levels, K, bf, True
    )
    carry = (prob.cam_T, prob.pts, jnp.asarray(1e-4), cost0, prob.obs_valid)
    carry, _ = jax.lax.scan(lm_step, carry, jnp.arange(iters))
    return _gba_finalize(prob, inv_sigma2_levels, K, bf, carry)


def _gba_make_lm_step(prob: BAProblem, inv_sigma2_levels, K, bf,
                      cg_iters: int, robust_iters: int):
    """One damped-GN/Schur/PCG iteration as a scannable step — shared by
    the monolithic solver above and the chunked background GBA
    (gba_chunk), which is the reference's transient-GBA-thread equivalent
    (P2/P6): fixed-iteration chunks dispatched between frames with an
    abort check in between (mbStopGBA, src/LoopClosing.cc:410-423;
    setForceStopFlag, src/Optimizer.cc:517-518)."""
    Nc, Np = prob.cam_T.shape[0], prob.pts.shape[0]

    def lm_step(carry, it):
        cam_T, pts, lam, cost, obs_ok = carry
        robust = it < robust_iters
        Hcc, bc, Hpp, bp, A, cam_free = _assemble_blocks(
            prob, cam_T, pts, obs_ok, inv_sigma2_levels, K, bf, robust
        )
        Hcc_d = Hcc + lam * jnp.eye(6) * jnp.maximum(
            jnp.einsum("cii->c", Hcc)[:, None, None] / 6.0, 1e-6
        )
        Hcc_d = jnp.where(cam_free[:, None, None], Hcc_d, jnp.eye(6))
        bc = jnp.where(cam_free[:, None], bc, 0.0)
        Hpp_d = Hpp + lam * jnp.eye(3) * jnp.maximum(
            jnp.einsum("pii->p", Hpp)[:, None, None] / 3.0, 1e-6
        )
        Hpp_inv = _inv33(Hpp_d)

        def schur_matvec(x):
            """x [Nc,6] -> (Hcc_d - E Hpp^-1 E^T) x via per-obs ops."""
            y = jnp.einsum("cij,cj->ci", Hcc_d, x)
            u = jnp.einsum("oij,oi->oj", A, x[prob.obs_cam])        # [O,3]
            sp = jnp.zeros((Np, 3)).at[prob.obs_pt].add(u)
            v = jnp.einsum("pij,pj->pi", Hpp_inv, sp)
            wv = jnp.einsum("oij,oj->oi", A, v[prob.obs_pt])        # [O,6]
            y = y - jnp.zeros((Nc, 6)).at[prob.obs_cam].add(wv)
            return jnp.where(cam_free[:, None], y, x)

        # rhs = bc - E Hpp^-1 bp
        v0 = jnp.einsum("pij,pj->pi", Hpp_inv, bp)
        rhs = bc - jnp.zeros((Nc, 6)).at[prob.obs_cam].add(
            jnp.einsum("oij,oj->oi", A, v0[prob.obs_pt])
        )
        rhs = jnp.where(cam_free[:, None], rhs, 0.0)

        # block-Jacobi preconditioner
        Minv = jnp.linalg.inv(Hcc_d + 1e-8 * jnp.eye(6))

        def precond(r_):
            return jnp.einsum("cij,cj->ci", Minv, r_)

        def cg_body(_, s):
            x, r_, p, rz = s
            Ap = schur_matvec(p)
            denom = jnp.sum(p * Ap)
            alpha = rz / jnp.where(jnp.abs(denom) < 1e-20, 1e-20, denom)
            x = x + alpha * p
            r_ = r_ - alpha * Ap
            z = precond(r_)
            rz_new = jnp.sum(r_ * z)
            beta = rz_new / jnp.where(jnp.abs(rz) < 1e-20, 1e-20, rz)
            p = z + beta * p
            return (x, r_, p, rz_new)

        x0 = jnp.zeros((Nc, 6))
        z0 = precond(rhs)
        dc = jax.lax.fori_loop(
            0, cg_iters, cg_body, (x0, rhs, z0, jnp.sum(rhs * z0))
        )[0]
        # back-substitute points
        u = jnp.einsum("oij,oi->oj", A, dc[prob.obs_cam])
        sp = jnp.zeros((Np, 3)).at[prob.obs_pt].add(u)
        dp = jnp.einsum("pij,pj->pi", Hpp_inv, bp - sp)

        cam_T_new = jax.vmap(lambda d, T: geo.se3_exp(d) @ T)(dc, cam_T)
        cam_T_new = jnp.where(cam_free[:, None, None], cam_T_new, cam_T)
        pts_new = jnp.where(prob.pt_valid[:, None], pts + dp, pts)
        new_cost = _gba_cost(
            prob, cam_T_new, pts_new, obs_ok, inv_sigma2_levels, K, bf, robust
        )
        accept = new_cost < cost
        cam_T = jnp.where(accept, cam_T_new, cam_T)
        pts = jnp.where(accept, pts_new, pts)
        lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-9),
                        jnp.minimum(lam * 4.0, 1e6))
        cost = jnp.where(accept, new_cost, cost)
        return (cam_T, pts, lam, cost, obs_ok), None

    return lm_step


def _gba_finalize(prob: BAProblem, inv_sigma2_levels, K, bf, carry) -> BAResult:
    cam_T, pts, lam, cost, obs_ok = carry
    chi2_th = jnp.where(prob.obs_stereo, C.CHI2_STEREO, C.CHI2_MONO)
    T_o, X_o = cam_T[prob.obs_cam], pts[prob.obs_pt]
    r, depth = jax.vmap(_residual_unified, in_axes=(0, 0, 0, None, None))(
        T_o, X_o, prob.obs_uvr, K, bf
    )
    inv_s2, comp = _edge_weights(
        prob.obs_oct, prob.obs_stereo, prob.obs_valid, inv_sigma2_levels
    )
    chi2 = _edge_chi2(r, inv_s2, comp)
    inlier = prob.obs_valid & (chi2 <= chi2_th) & (depth > 0)
    return BAResult(
        cam_T=geo.orthonormalize_T(cam_T), pts=pts, obs_inlier=inlier, cost=cost
    )


@functools.partial(jax.jit, static_argnames=("K", "bf"))
def gba_init_carry(prob: BAProblem, inv_sigma2_levels, K, bf):
    """Initial LM carry for chunked GBA (see _gba_make_lm_step)."""
    cost0 = _gba_cost(
        prob, prob.cam_T, prob.pts, prob.obs_valid, inv_sigma2_levels, K, bf,
        True,
    )
    return (prob.cam_T, prob.pts, jnp.asarray(1e-4), cost0, prob.obs_valid)


@functools.partial(
    jax.jit,
    static_argnames=("K", "bf", "n_iters", "cg_iters", "robust_iters"),
)
def gba_chunk(prob: BAProblem, inv_sigma2_levels, carry, it0,
              K, bf, n_iters: int = 1, cg_iters: int = 40,
              robust_iters: int = 5):
    """Advance chunked GBA by n_iters LM iterations from `carry`. Each
    call is ONE bounded device program, so the host can interleave frame
    programs between chunks and drop the remaining chunks on abort — the
    device-side equivalent of the reference's concurrent, interruptible GBA
    thread (src/LoopClosing.cc:575-579 + mbStopGBA)."""
    lm_step = _gba_make_lm_step(
        prob, inv_sigma2_levels, K, bf, cg_iters, robust_iters
    )
    carry, _ = jax.lax.scan(
        lm_step, carry, it0 + jnp.arange(n_iters)
    )
    return carry


@functools.partial(jax.jit, static_argnames=("K", "bf"))
def gba_result(prob: BAProblem, inv_sigma2_levels, K, bf, carry) -> BAResult:
    """Finalize a chunked GBA carry into a BAResult."""
    return _gba_finalize(prob, inv_sigma2_levels, K, bf, carry)
