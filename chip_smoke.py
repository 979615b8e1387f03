"""Smoke run of the SLAM main path on one GPU.

Drives the system once through the entry points a user calls, at the
published widths of its sensor configurations, and checks the results:

  1. device: JAX's device, the card's name and power limit; exits non-zero
     unless the default backend is a GPU (there is no CPU fallback);
  2. kernel parity at real widths: ORB extraction (TUM1 480x640 1000x8 and
     KITTI 376x1241 2000x8), the pose LM (the Triton kernel on the GPU) and
     one local-BA solve at the mapper's window, each against the same code
     jitted on the CPU in this process;
  3. RGB-D main path: System.track_rgbd at TUM fr1 shape on an orbit with
     an overshoot, so a loop closes (detection, Sim3, essential graph and
     the background GBA all run on the card); ATE <= 5 cm;
  4. stereo main path: System.track_stereo at KITTI shape on the head of
     the street sequence (a forward drive);
  5. distributed global BA on the mesh of the GPUs present.

Each phase prints its results; any failure makes the script exit non-zero
after the remaining phases ran. The last line of stdout is one JSON object
{"ok": true, "device": {"platform", "kind", "count"}}, printed only when
every phase passed.

Usage: python chip_smoke.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback

import numpy as np

K_TUM = (520.0, 520.0, 320.0, 240.0)
HW_TUM = (480, 640)
# KITTI00-02.yaml widths; K and baseline as tools/make_datasets.py
K_KITTI = (718.0, 718.0, 620.0, 188.0)
HW_KITTI = (376, 1241)
BASELINE_KITTI = 0.54

# parity tolerances (PERF.md, "Parity" gives the reason for each)
TOL_DESC_BITS = 1.0      # mean descriptor Hamming difference
TOL_POSE = 2e-3          # se3-log norm between the two poses
TOL_INLIER_AGREE = 0.98  # share of edges with the same inlier verdict
TOL_LBA_COST = 1e-4      # relative local-BA cost difference
TOL_ATE_RGBD = 0.05      # m


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def card_line() -> str:
    """nvidia-smi's name and power limit, from a child that stays off JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return out.stdout.strip() or f"nvidia-smi rc={out.returncode}"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"


def phase_device() -> dict:
    import jax

    devs = jax.devices()
    d = devs[0]
    print(f"[device] jax.devices()={devs}")
    print(f"[device] platform={d.platform} kind={d.device_kind} "
          f"count={len(devs)} jax={jax.__version__}")
    print(f"[device] card: {card_line()}")
    print(f"[device] matmul precision: "
          f"{jax.config.jax_default_matmul_precision} (f32 products stay "
          f"f32, no TF32)")
    if jax.default_backend() != "gpu":
        print(f"[device] FAIL: default backend is {jax.default_backend()!r},"
              " not a GPU", file=sys.stderr)
        sys.exit(2)
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}


# --- phase 2 ---------------------------------------------------------------

def _on_cpu(fn, *args):
    """fn(*args) jitted on the CPU device of this process (the reference)."""
    import jax

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        return jax.device_get(fn(*jax.device_put(args, cpu)))


def _render(hw, K, n_points, seed, extent=(12.0, 8.0, 18.0)):
    from orb_slam2_comment_tpu.utils import synthetic as syn

    scene = syn.make_scene(n_points=n_points, seed=seed, extent=extent)
    return syn.render(scene, np.eye(4, dtype=np.float32), K, hw, noise=1.0,
                      seed=seed)


def parity_extract(hw, K, n_features, n_levels, n_points) -> None:
    import jax
    import jax.numpy as jnp

    from orb_slam2_comment_tpu.ops import orb

    img = np.round(_render(hw, K, n_points, seed=1)).astype(np.float32)
    cfg = orb.ORBConfig(n_features=n_features, n_levels=n_levels)
    fn = lambda x: orb.extract(x, cfg)[0]  # noqa: E731
    g = jax.device_get(fn(jnp.asarray(img)))
    c = _on_cpu(fn, img)
    vg, vc = np.asarray(g.valid), np.asarray(c.valid)
    same_set = bool((vg == vc).all()) and bool(
        (np.asarray(g.xy)[vg] == np.asarray(c.xy)[vc]).all())
    same_oct = bool((np.asarray(g.octave)[vg] == np.asarray(c.octave)[vc])
                    .all()) if same_set else False
    both = vg & vc
    xor = np.bitwise_xor(np.asarray(g.desc)[both], np.asarray(c.desc)[both])
    ham = np.unpackbits(xor.view(np.uint8), axis=1).sum(axis=1)
    tag = f"{hw[0]}x{hw[1]} {n_features}x{n_levels}"
    print(f"[parity] extract {tag}: keypoints gpu={int(vg.sum())} "
          f"cpu={int(vc.sum())} identical={same_set} (tol: identical); "
          f"octaves identical={same_oct} (tol: identical); descriptor "
          f"Hamming mean={ham.mean():.4f} bits max={int(ham.max())} "
          f"(tol: mean <= {TOL_DESC_BITS})")
    check(same_set and same_oct, f"extract {tag}: keypoint sets differ")
    check(ham.mean() <= TOL_DESC_BITS, f"extract {tag}: descriptors differ")


def pose_problem(n: int = 1000, seed: int = 3):
    """Stereo/mono edges with 20% outliers (tests/test_optim.py setup),
    plus unassociated slots as tracking passes them: 10% of the edges
    invalid, half of those behind the camera."""
    import jax.numpy as jnp

    from orb_slam2_comment_tpu.ops import geometry as geo

    K, bf = (500.0, 500.0, 320.0, 240.0), 50.0
    r = np.random.default_rng(seed)
    Xw = r.uniform(-3, 3, (n, 3)).astype(np.float32) + [0, 0, 8]
    T_gt = geo.se3_exp(
        jnp.asarray([0.1, -0.05, 0.08, 0.02, -0.03, 0.01], jnp.float32))
    uvr = np.array(geo.project_stereo(K, bf, geo.transform_points(
        T_gt, jnp.asarray(Xw))))
    uvr += r.normal(0, 0.4, uvr.shape)
    out_idx = r.choice(n, n // 5, replace=False)
    uvr[out_idx, :2] += r.uniform(15, 40, (len(out_idx), 2))
    T0 = np.asarray(geo.se3_exp(jnp.asarray(
        [0.08, -0.04, 0.06, 0.015, -0.02, 0.006], jnp.float32)))
    valid = np.ones(n, bool)
    bad = r.choice(n, n // 10, replace=False)
    valid[bad] = False
    Xw[bad[: len(bad) // 2], 2] = -5.0
    args = (T0, Xw.astype(np.float32), uvr.astype(np.float32),
            r.integers(0, 8, n).astype(np.int32), r.random(n) < 0.7,
            valid,
            np.asarray([1.0 / (1.2 ** (2 * l)) for l in range(8)],
                       np.float32))
    return args, K, bf


def parity_pose(n: int = 1000) -> None:
    import jax
    import jax.numpy as jnp

    from orb_slam2_comment_tpu.ops import geometry as geo
    from orb_slam2_comment_tpu.ops import optim

    args, K, bf = pose_problem(n)
    g = jax.device_get(optim.pose_optimize(*map(jnp.asarray, args), K, bf))
    c = _on_cpu(lambda *a: optim.pose_optimize_xla(*a, K, bf), *args)
    d = float(np.linalg.norm(np.asarray(geo.se3_log(
        jnp.asarray(g.Tcw) @ geo.inv_T(jnp.asarray(c.Tcw))))))
    agree = float(np.mean(np.asarray(g.inliers) == np.asarray(c.inliers)))
    print(f"[parity] pose LM {n} edges: se3-log diff={d:.3e} (tol "
          f"{TOL_POSE}); inlier agreement={agree:.4f} (tol >= "
          f"{TOL_INLIER_AGREE}); inliers gpu={int(g.n_inliers)} "
          f"cpu={int(c.n_inliers)}")
    check(d <= TOL_POSE, "pose LM: poses differ")
    check(agree >= TOL_INLIER_AGREE, "pose LM: inlier sets differ")


def lba_problem(n_cams=32, n_pts=2048, n_per=1000, n_free=16, seed=0):
    """The mapper's local-BA window: 16 free + 16 fixed KFs, one row of
    n_features observations per KF, 2048 points (SlamConfig defaults)."""
    import jax.numpy as jnp

    from orb_slam2_comment_tpu.ops import geometry as geo
    from orb_slam2_comment_tpu.ops import optim

    K, bf = (500.0, 500.0, 320.0, 240.0), 50.0
    r = np.random.default_rng(seed)
    pts = r.uniform(-6, 6, (n_pts, 3)).astype(np.float32) + [0, 0, 10]
    cam_T = np.tile(np.eye(4, dtype=np.float32), (n_cams, 1, 1))
    cam_T[:, 0, 3] = -np.linspace(0, 2, n_cams).astype(np.float32)
    obs_pt = r.integers(0, n_pts, (n_cams, n_per)).astype(np.int32)
    uvr = np.stack([np.asarray(geo.project_stereo(K, bf, geo.transform_points(
        jnp.asarray(cam_T[c]), jnp.asarray(pts[obs_pt[c]]))))
        for c in range(n_cams)]).reshape(-1, 3)
    uvr += r.normal(0, 0.4, uvr.shape)
    # perturb the free cameras and the points so the solve has work to do
    cam_T[:n_free, :3, 3] += r.normal(0, 0.02, (n_free, 3))
    pts += r.normal(0, 0.05, pts.shape).astype(np.float32)
    cam_fixed = np.arange(n_cams) >= n_free
    o = n_cams * n_per
    prob = optim.BAProblem(
        cam_T=cam_T, cam_fixed=cam_fixed, cam_valid=np.ones(n_cams, bool),
        pts=pts.astype(np.float32), pt_valid=np.ones(n_pts, bool),
        obs_cam=np.repeat(np.arange(n_cams, dtype=np.int32), n_per),
        obs_pt=obs_pt.reshape(-1), obs_uvr=uvr.astype(np.float32),
        obs_oct=r.integers(0, 4, o).astype(np.int32),
        obs_stereo=r.random(o) < 0.7, obs_valid=r.random(o) < 0.95,
    )
    inv_s2 = np.asarray([1.0 / (1.2 ** (2 * l)) for l in range(8)],
                        np.float32)
    return prob, inv_s2, K, bf, n_free


def lba_solve(prob, inv_s2, K, bf, n_free, iters=5):
    """lba_init + one robust lba_iterate pass (the mapper's BA1 phase)."""
    import jax

    from orb_slam2_comment_tpu.ops import optim

    @jax.jit
    def run(prob, inv_s2):
        carry = optim.lba_init(prob, inv_s2, K, bf)
        c0 = carry[3]
        carry = optim.lba_iterate(prob, inv_s2, carry, K, bf, iters,
                                  robust=True, n_free=n_free)
        return c0, carry[3], carry[4]

    return run(prob, inv_s2)


def parity_lba() -> None:
    import jax

    prob, inv_s2, K, bf, n_free = lba_problem()
    g = jax.device_get(lba_solve(jax.device_put(prob), inv_s2, K, bf,
                                 n_free))
    c = _on_cpu(lambda p, s: lba_solve(p, s, K, bf, n_free), prob, inv_s2)
    rel = abs(float(g[1]) - float(c[1])) / max(abs(float(c[1])), 1.0)
    print(f"[parity] local BA {prob.cam_T.shape[0]} cams x "
          f"{prob.obs_cam.shape[0]} obs x {prob.pts.shape[0]} pts: cost "
          f"{float(c[0]):.2f} -> gpu {float(g[1]):.4f} cpu {float(c[1]):.4f}"
          f" rel diff={rel:.3e} (tol {TOL_LBA_COST}); inliers gpu="
          f"{int(g[2])} cpu={int(c[2])}")
    check(rel <= TOL_LBA_COST, "local BA: costs differ")


def phase_parity() -> None:
    parity_extract(HW_TUM, K_TUM, 1000, 8, 1400)
    parity_extract(HW_KITTI, K_KITTI, 2000, 8, 3000)
    parity_pose()
    parity_lba()


# --- phases 3-4 ------------------------------------------------------------

def _ate(system, gt_by_ts):
    """(frames with a pose, ATE RMSE in m) from the System's own per-frame
    trajectory, matched to ground truth by timestamp."""
    from orb_slam2_comment_tpu.utils import trajectory as traj

    fp = system._frame_poses()
    est = [T for _, T in fp]
    gt = [gt_by_ts[round(ts, 6)] for ts, _ in fp]
    return len(fp), traj.ate_rmse(est, gt)


def _drive(make_system, frames, track):
    system = make_system()
    t0 = time.perf_counter()
    for f in frames:
        track(system, f)
    system.shutdown()
    return system, time.perf_counter() - t0


def rgbd_setup(n_features=1000, n_levels=8, n_orbit=44, n_over=12):
    """(cfg, frames, gt_by_timestamp) of the RGB-D phase: TUM fr1 shape,
    uint8 gray and uint16 depth in mm, an orbit plus an overshoot that
    revisits its start."""
    from orb_slam2_comment_tpu.utils import synthetic as syn
    from orb_slam2_comment_tpu.utils.config import SlamConfig

    b = syn.DEFAULT_BASELINE
    cfg = SlamConfig(
        sensor="rgbd", fx=K_TUM[0], fy=K_TUM[1], cx=K_TUM[2], cy=K_TUM[3],
        bf=K_TUM[0] * b, width=HW_TUM[1], height=HW_TUM[0],
        n_features=n_features, n_levels=n_levels,
        max_keyframes=128, max_points=32768,
        match_th_scale=1.5, depth_map_factor=1000.0,
    )
    scene = syn.make_scene(n_points=1800, seed=0, extent=(14.0, 8.0, 20.0))
    base = syn.make_trajectory("orbit", n_frames=n_orbit)
    poses = np.concatenate([base, base[:n_over]])
    frames = []
    for f in syn.render_sequence(scene, poses, K=K_TUM, hw=HW_TUM,
                                 depth=True):
        f["image"] = np.clip(f["image"], 0, 255).astype(np.uint8)
        f["depth"] = np.clip(f["depth"] * 1000.0, 0, 65535).astype(np.uint16)
        frames.append(f)
    gt = {round(f["timestamp"], 6): f["Tcw_gt"] for f in frames}
    return cfg, frames, gt


def track_rgbd(system, f):
    system.track_rgbd(f["image"], f["depth"], f["timestamp"])


def run_rgbd(n_features=1000, n_levels=8, passes=2) -> None:
    """System.track_rgbd on an orbit + overshoot (a loop closes). The first
    pass compiles every program it meets; the second runs warm, so its
    wall time is the steady time and the difference is set-up."""
    import jax

    from orb_slam2_comment_tpu.models.system import System
    from orb_slam2_comment_tpu.models.tracking import OK

    cfg, frames, gt = rgbd_setup(n_features, n_levels)
    walls = []
    for p in range(passes):
        system, wall = _drive(lambda: System(cfg), frames, track_rgbd)
        walls.append(wall)
        n_ok, ate = _ate(system, gt)
        t = system.tracker
        print(f"[rgbd] pass {p}: frames={len(frames)} tracked={n_ok} "
              f"state={system.get_tracking_state()} KFs={t.n_kfs} "
              f"points={t.n_pts} loops={system.n_loops} "
              f"ATE={ate * 100:.3f} cm (tol {TOL_ATE_RGBD * 100:.0f} cm) "
              f"wall={wall:.3f} s")
        check(n_ok == len(frames), f"rgbd: tracked {n_ok}/{len(frames)}")
        check(system.get_tracking_state() == OK, "rgbd: tracking not OK")
        check(system.n_loops >= 1, "rgbd: no loop closed")
        check(ate <= TOL_ATE_RGBD, f"rgbd: ATE {ate:.4f} m")
    if passes > 1:
        print(f"[rgbd] set-up (compiles) ~ {walls[0] - walls[-1]:.3f} s; "
              f"steady wall {walls[-1]:.3f} s for {len(frames)} frames "
              f"({walls[-1] / len(frames) * 1e3:.3f} ms/frame); one smoke "
              f"run, not a benchmark")
    stats = jax.devices()[0].memory_stats() or {}
    print(f"[rgbd] peak_bytes_in_use={stats.get('peak_bytes_in_use')}")


def run_stereo(n_features=2000, n_levels=8, n_frames=60, hw=HW_KITTI,
               K=K_KITTI) -> None:
    """System.track_stereo at KITTI shape: the first frames of the street
    sequence of tools/make_datasets.py (a forward drive down a textured
    street canyon, 0.25 m per frame at 10 Hz), rendered in memory."""
    from orb_slam2_comment_tpu.models.system import System
    from orb_slam2_comment_tpu.models.tracking import OK
    from orb_slam2_comment_tpu.utils import render as rr
    from orb_slam2_comment_tpu.utils.config import SlamConfig

    cfg = SlamConfig(
        sensor="stereo", fx=K[0], fy=K[1], cx=K[2], cy=K[3],
        bf=K[0] * BASELINE_KITTI, width=hw[1], height=hw[0], fps=10.0,
        th_depth=40.0, n_features=n_features, n_levels=n_levels,
        max_keyframes=128, max_points=65536, match_th_scale=1.5,
    )
    scene = rr.make_street(seed=21, length=110.0)
    poses = rr.street_trajectory(400, length=100.0, seed=5)[:n_frames]
    frames = []
    for i, Tcw in enumerate(poses):
        left, _ = rr.render_quads(scene, Tcw, K, hw, noise=1.5,
                                  seed=1000 + i)
        right, _ = rr.render_quads(scene, Tcw, K, hw, noise=1.5,
                                   seed=5000 + i, baseline=BASELINE_KITTI)
        frames.append({
            "image": np.clip(left, 0, 255).astype(np.uint8),
            "image_right": np.clip(right, 0, 255).astype(np.uint8),
            "timestamp": i / 10.0, "Tcw_gt": Tcw.astype(np.float32),
        })
    gt = {round(f["timestamp"], 6): f["Tcw_gt"] for f in frames}

    def track(s, f):
        s.track_stereo(f["image"], f["image_right"], f["timestamp"])

    system, wall = _drive(lambda: System(cfg), frames, track)
    n_ok, ate = _ate(system, gt)
    t = system.tracker
    print(f"[stereo] {hw[0]}x{hw[1]} {n_features}x{n_levels}: "
          f"frames={len(frames)} tracked={n_ok} "
          f"state={system.get_tracking_state()} KFs={t.n_kfs} "
          f"points={t.n_pts} ATE={ate * 100:.3f} cm wall={wall:.3f} s "
          f"(compiles included)")
    check(n_ok == len(frames), f"stereo: tracked {n_ok}/{len(frames)}")
    check(system.get_tracking_state() == OK, "stereo: tracking not OK")


# --- phase 5 ---------------------------------------------------------------

def run_dist_ba() -> None:
    import jax
    import jax.numpy as jnp

    from orb_slam2_comment_tpu.parallel import dist_ba

    mesh = dist_ba.make_mesh(jax.devices())
    prob, _, _ = dist_ba.make_synthetic_ba_problem(
        n_cams=48, n_pts=2048, obs_per_cam=128)
    inv_s2 = jnp.asarray([1.0 / (1.2 ** (2 * l)) for l in range(8)])
    res = dist_ba.distributed_global_ba(
        prob, inv_s2, (500.0, 500.0, 320.0, 240.0), 100.0, mesh,
        iters=2, cg_iters=10)
    cost = float(res.cost)
    finite = bool(np.isfinite(cost)) and bool(
        np.isfinite(np.asarray(res.cam_T)).all())
    print(f"[dist_ba] mesh={dict(mesh.shape)} cost={cost:.4f} "
          f"finite={finite}")
    check(finite, "dist_ba: non-finite result")


def main() -> int:
    import orb_slam2_comment_tpu  # noqa: F401  (precision + compile cache)

    device = phase_device()
    failed = []
    for name, fn in [("parity", phase_parity), ("rgbd", run_rgbd),
                     ("stereo", run_stereo), ("dist_ba", run_dist_ba)]:
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # reported, and the run exits non-zero below
            traceback.print_exc()
            failed.append(name)
        print(f"[{name}] {'FAIL' if name in failed else 'ok'} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    if failed:
        print(f"FAILED phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
