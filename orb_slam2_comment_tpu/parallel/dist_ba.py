"""Distributed bundle adjustment over a jax.sharding.Mesh.

The reference is a single-process pthread pipeline with no distributed
backend (SURVEY.md §2c); this module is the multi-device scaling axis the
rebuild adds: the map's *observations* are sharded across devices, each
device assembles its partial normal-equation blocks, and the reduced
camera system is combined with psums — the
"Schur-reduced camera blocks psum, pose updates all-gathered" recipe of
BASELINE.json's north star.

Implementation: ops.optim.global_bundle_adjustment is already written as
segment-sums over the observation axis. Sharding the observation arrays
with a NamedSharding and jitting with those shardings makes XLA lower
every scatter-add into a partial-sum + psum over the mesh and keep the
replicated camera/point state consistent — the GSPMD "annotate and let
the compiler insert collectives" pattern. CG then runs on replicated
[Nc,6] state with device-local matvec partials psum-combined each
iteration (all inserted automatically).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from orb_slam2_comment_tpu.ops import optim

BA_AXIS = "ba"


def make_mesh(devices=None, axis: str = BA_AXIS) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def pad_problem(prob: optim.BAProblem, multiple: int) -> optim.BAProblem:
    """Pad the observation axis to a multiple of the mesh size (padded
    observations carry obs_valid=False and weigh zero)."""
    O = prob.obs_cam.shape[0]
    O_pad = -(-O // multiple) * multiple
    if O_pad == O:
        return prob
    pad = O_pad - O

    def padded(x, fill=0):
        return jnp.concatenate(
            [x, jnp.full((pad,) + x.shape[1:], fill, x.dtype)]
        )

    return prob._replace(
        obs_cam=padded(prob.obs_cam),
        obs_pt=padded(prob.obs_pt),
        obs_uvr=padded(prob.obs_uvr, 0.0),
        obs_oct=padded(prob.obs_oct),
        obs_stereo=padded(prob.obs_stereo, False),
        obs_valid=padded(prob.obs_valid, False),
    )


def shard_problem(prob: optim.BAProblem, mesh: Mesh) -> optim.BAProblem:
    """Place observation arrays sharded over the mesh, everything else
    replicated."""
    n = mesh.devices.size
    prob = pad_problem(prob, n)
    obs_sh = NamedSharding(mesh, P(BA_AXIS))
    rep = NamedSharding(mesh, P())

    def put(x, sh):
        return jax.device_put(x, sh)

    return optim.BAProblem(
        cam_T=put(prob.cam_T, rep),
        cam_fixed=put(prob.cam_fixed, rep),
        cam_valid=put(prob.cam_valid, rep),
        pts=put(prob.pts, rep),
        pt_valid=put(prob.pt_valid, rep),
        obs_cam=put(prob.obs_cam, obs_sh),
        obs_pt=put(prob.obs_pt, obs_sh),
        obs_uvr=put(prob.obs_uvr, obs_sh),
        obs_oct=put(prob.obs_oct, obs_sh),
        obs_stereo=put(prob.obs_stereo, obs_sh),
        obs_valid=put(prob.obs_valid, obs_sh),
    )


def distributed_global_ba(
    prob: optim.BAProblem,
    inv_sigma2_levels,
    K: tuple,
    bf: float,
    mesh: Mesh,
    iters: int = 10,
    cg_iters: int = 40,
) -> optim.BAResult:
    """Run the matrix-free Schur/PCG global BA with observations sharded
    over the mesh. Returns fully-replicated results."""
    sharded = shard_problem(prob, mesh)
    with jax.set_mesh(mesh):
        res = optim.global_bundle_adjustment(
            sharded, inv_sigma2_levels, K, bf, iters=iters, cg_iters=cg_iters
        )
    return jax.tree.map(_fetch_global, res)


def _fetch_global(x):
    """device_get that also works under multi-process jax.distributed:
    a replicated global array's value is any local shard; sharded arrays
    are allgathered across processes (DCN) first."""
    if jax.process_count() == 1:
        return jax.device_get(x)
    if getattr(x, "is_fully_replicated", False):
        return np.asarray(x.addressable_shards[0].data)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def distributed_essential_graph(
    S0,
    kf_valid,
    kf_fixed,
    edge_i,
    edge_j,
    edge_Sji,
    edge_valid,
    mesh: Mesh,
    fix_scale: bool = False,
    iters: int | None = None,
) -> optim.PoseGraphResult:
    """Pose-graph (essential-graph) optimization with the EDGE axis
    sharded over the mesh — the multi-host form of
    Optimizer::OptimizeEssentialGraph (src/Optimizer.cc:781-1044).

    Each device computes residuals + Jacobians for its edge shard; the
    scatter-adds into the dense normal system become partial sums + psum
    under GSPMD, and the replicated [7K,7K] solve runs identically on
    every device (K of the essential graph is small; communication is one
    all-reduce of H and b per GN iteration)."""
    n = mesh.devices.size
    E = edge_i.shape[0]
    E_pad = -(-E // n) * n
    if E_pad != E:
        pad = E_pad - E
        edge_i = jnp.concatenate([edge_i, jnp.zeros(pad, edge_i.dtype)])
        edge_j = jnp.concatenate([edge_j, jnp.zeros(pad, edge_j.dtype)])
        edge_Sji = jnp.concatenate(
            [edge_Sji, jnp.tile(jnp.eye(4, dtype=edge_Sji.dtype), (pad, 1, 1))]
        )
        edge_valid = jnp.concatenate(
            [edge_valid, jnp.zeros(pad, bool)]
        )
    esh = NamedSharding(mesh, P(BA_AXIS))
    rep = NamedSharding(mesh, P())
    kw = {} if iters is None else {"iters": iters}
    with jax.set_mesh(mesh):
        res = optim.essential_graph_optimize(
            jax.device_put(S0, rep),
            jax.device_put(kf_valid, rep),
            jax.device_put(kf_fixed, rep),
            jax.device_put(edge_i, esh),
            jax.device_put(edge_j, esh),
            jax.device_put(edge_Sji, esh),
            jax.device_put(edge_valid, esh),
            fix_scale=fix_scale,
            **kw,
        )
    return jax.tree.map(lambda x: jax.device_get(x), res)


def distributed_essential_graph_sparse(
    S0,
    kf_valid,
    kf_fixed,
    edge_i,
    edge_j,
    edge_Sji,
    edge_valid,
    mesh: Mesh,
    fix_scale: bool = False,
    iters: int | None = None,
    cg_iters: int = 300,
) -> optim.PoseGraphResult:
    """Edge-sharded SPARSE pose graph for KITTI-00-scale maps: the
    per-edge [7,7] normal blocks and the H·v matvec partials are computed
    on each device's edge shard and psum-combined by GSPMD every CG
    iteration — communication is O(K·49) per iteration regardless of edge
    count, riding ICI. The large-map companion of
    distributed_essential_graph (which psums a dense [7K,7K])."""
    n = mesh.devices.size
    E = edge_i.shape[0]
    E_pad = -(-E // n) * n
    if E_pad != E:
        pad = E_pad - E
        edge_i = jnp.concatenate([edge_i, jnp.zeros(pad, edge_i.dtype)])
        edge_j = jnp.concatenate([edge_j, jnp.zeros(pad, edge_j.dtype)])
        edge_Sji = jnp.concatenate(
            [edge_Sji, jnp.tile(jnp.eye(4, dtype=edge_Sji.dtype), (pad, 1, 1))]
        )
        edge_valid = jnp.concatenate([edge_valid, jnp.zeros(pad, bool)])
    esh = NamedSharding(mesh, P(BA_AXIS))
    rep = NamedSharding(mesh, P())
    kw = {} if iters is None else {"iters": iters}
    with jax.set_mesh(mesh):
        res = optim.essential_graph_optimize_sparse(
            jax.device_put(S0, rep),
            jax.device_put(kf_valid, rep),
            jax.device_put(kf_fixed, rep),
            jax.device_put(edge_i, esh),
            jax.device_put(edge_j, esh),
            jax.device_put(edge_Sji, esh),
            jax.device_put(edge_valid, esh),
            fix_scale=fix_scale,
            cg_iters=cg_iters,
            **kw,
        )
    return jax.tree.map(lambda x: jax.device_get(x), res)


def distributed_local_ba(m, kf_id, cfg, mesh: Mesh, iters: int = 15,
                         cg_iters: int = 20):
    """Local-mapping BA window (Optimizer::LocalBundleAdjustment,
    src/Optimizer.cc:453-778) as a distributed surface: the window is
    extracted exactly as the fused single-chip mapper does
    (local_mapping.build_ba_window), then its observation axis is sharded
    over the mesh and solved by the same Schur/PCG engine. Returns
    (BAResult, window BAProblem, cam_ids, pt_ids) — write back with
    local_mapping.scatter_ba_result."""
    from orb_slam2_comment_tpu.models.local_mapping import build_ba_window

    prob, cam_ids, pt_ids = build_ba_window(m, jnp.asarray(kf_id, jnp.int32),
                                            cfg)
    inv_s2 = jnp.asarray(
        [1.0 / cfg.scale_factor ** (2 * l) for l in range(cfg.n_levels)]
    )
    res = distributed_global_ba(
        prob, inv_s2, cfg.K, cfg.bf, mesh, iters=iters, cg_iters=cg_iters
    )
    return res, prob, cam_ids, pt_ids


def make_synthetic_ba_problem(n_cams=8, n_pts=128, obs_per_cam=64, seed=0,
                              K=(500.0, 500.0, 320.0, 240.0), bf=100.0,
                              noise=0.3, perturb=0.02):
    """Synthetic BA problem with known ground truth, used by tests, the
    multichip dry run, and bench."""
    r = np.random.default_rng(seed)
    X_gt = r.uniform(-4, 4, (n_pts, 3)).astype(np.float32) + [0, 0, 10]
    from orb_slam2_comment_tpu.ops import geometry as geo

    cams = []
    # total trajectory span stays ~2.4m regardless of n_cams so every
    # camera keeps the point cloud (z~10) in its frustum
    step = 2.4 / max(n_cams - 1, 1)
    rot = 0.08 / max(n_cams - 1, 1)
    for i in range(n_cams):
        xi = np.array(
            [step * i, 0.03 * step * i, 0.07 * step * i, 0.0, rot * i, 0.0],
            np.float32,
        )
        cams.append(np.asarray(geo.se3_exp(jnp.asarray(xi))))
    cams = np.stack(cams)
    obs_cam, obs_pt, obs_uvr = [], [], []
    for c in range(n_cams):
        pts_sel = r.choice(n_pts, size=obs_per_cam, replace=False)
        Xc = X_gt[pts_sel] @ cams[c][:3, :3].T + cams[c][:3, 3]
        fx, fy, cx, cy = K
        u = fx * Xc[:, 0] / Xc[:, 2] + cx
        v = fy * Xc[:, 1] / Xc[:, 2] + cy
        ur = u - bf / Xc[:, 2]
        uvr = np.stack([u, v, ur], 1) + r.normal(0, noise, (obs_per_cam, 3))
        obs_cam.extend([c] * obs_per_cam)
        obs_pt.extend(pts_sel.tolist())
        obs_uvr.append(uvr)
    O = len(obs_cam)
    cam_T0 = cams.copy()
    for c in range(2, n_cams):
        d = r.normal(0, perturb, 6).astype(np.float32)
        cam_T0[c] = np.asarray(geo.se3_exp(jnp.asarray(d))) @ cam_T0[c]
    pts0 = X_gt + r.normal(0, perturb * 2, X_gt.shape).astype(np.float32)
    prob = optim.BAProblem(
        cam_T=jnp.asarray(cam_T0),
        cam_fixed=jnp.asarray([True, True] + [False] * (n_cams - 2)),
        cam_valid=jnp.ones(n_cams, bool),
        pts=jnp.asarray(pts0),
        pt_valid=jnp.ones(n_pts, bool),
        obs_cam=jnp.asarray(obs_cam, jnp.int32),
        obs_pt=jnp.asarray(obs_pt, jnp.int32),
        obs_uvr=jnp.asarray(np.concatenate(obs_uvr).astype(np.float32)),
        obs_oct=jnp.zeros(O, jnp.int32),
        obs_stereo=jnp.ones(O, bool),
        obs_valid=jnp.ones(O, bool),
    )
    return prob, cams, X_gt
