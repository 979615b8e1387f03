"""Head-to-head accuracy/latency harness: C++ reference vs this framework.

Drives both systems over the IDENTICAL on-disk sequences produced by
tools/make_datasets.py, evaluates ATE RMSE against ground truth with the
standard Horn/Umeyama alignment (SE3 for RGB-D/stereo, Sim3 for mono —
the TUM benchmark convention the reference points at, README.md:188-192),
and reports per-frame tracking time from each system's own timing.

Reference binaries are expected at REF_BUILD (a patched headless build of
/root/reference; see BENCH_ACCURACY.md for the patch list).

usage:
  python tools/head_to_head.py --seq room_loop --system both
  python tools/head_to_head.py --all --system ours
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from orb_slam2_comment_tpu.utils import trajectory as traj  # noqa: E402

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
DATA = os.path.join(REPO, "data", "synth")
REF_BUILD = os.environ.get("REF_BUILD", "/tmp/refsrc")
REF_VOCAB = os.environ.get(
    "REF_VOCAB", os.path.join(REF_BUILD, "Vocabulary_synth.txt"))

SEQS = {
    "room_loop": {"kind": "tum_rgbd", "fps": 30.0},
    "desk": {"kind": "tum_rgbd", "fps": 30.0},
    "street": {"kind": "kitti_stereo", "fps": 10.0},
    # monocular on the SAME desk sequence (both systems' mono_tum).
    # Scored on the KEYFRAME trajectory with Sim3 alignment — the
    # reference's mono driver only saves KeyFrameTrajectory.txt
    # (Examples/Monocular/mono_tum.cc) and mono scale is free.
    "desk_mono": {"kind": "tum_mono", "fps": 30.0, "dir": "desk"},
}


# ---------------------------------------------------------------------------
# Trajectory file parsing + evaluation
# ---------------------------------------------------------------------------

def load_tum_traj(path):
    """-> (ts [N], Twc [N,4,4])"""
    ts, poses = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = [float(x) for x in line.split()]
            if len(v) < 8:
                continue
            t, tx, ty, tz, qx, qy, qz, qw = v[:8]
            n = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
            qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
            R = np.array([
                [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
                 2 * (qx * qz + qy * qw)],
                [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
                 2 * (qy * qz - qx * qw)],
                [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
                 1 - 2 * (qx * qx + qy * qy)],
            ])
            T = np.eye(4)
            T[:3, :3] = R
            T[:3, 3] = [tx, ty, tz]
            ts.append(t)
            poses.append(T)
    return np.array(ts), np.stack(poses) if poses else np.zeros((0, 4, 4))


def load_kitti_traj(path):
    """-> Twc [N,4,4] (one pose per frame, row-major 3x4)."""
    poses = []
    with open(path) as f:
        for line in f:
            v = [float(x) for x in line.split()]
            if len(v) < 12:
                continue
            T = np.eye(4)
            T[:3, :] = np.array(v[:12]).reshape(3, 4)
            poses.append(T)
    return np.stack(poses) if poses else np.zeros((0, 4, 4))


def associate(ts_a, ts_b, max_dt=0.02):
    """Nearest-timestamp matching -> (idx_a, idx_b)."""
    ia, ib = [], []
    j = 0
    for i, t in enumerate(ts_a):
        j = int(np.argmin(np.abs(ts_b - t)))
        if abs(ts_b[j] - t) <= max_dt:
            ia.append(i)
            ib.append(j)
    return np.array(ia, int), np.array(ib, int)


def evaluate_ate(est_centers, gt_centers, with_scale=False):
    """Umeyama-aligned ATE RMSE (meters) + the fitted scale."""
    aligned, (s, _, _) = traj.umeyama_align(
        est_centers, gt_centers, with_scale=with_scale)
    d = aligned - gt_centers
    rmse = float(np.sqrt(np.mean(np.sum(d * d, axis=1))))
    return rmse, s


def eval_tum(traj_path, gt_path, with_scale=False):
    ts_e, T_e = load_tum_traj(traj_path)
    ts_g, T_g = load_tum_traj(gt_path)
    ia, ib = associate(ts_e, ts_g)
    if len(ia) < 10:
        return {"error": f"only {len(ia)} associated poses"}
    ce = T_e[ia][:, :3, 3]
    cg = T_g[ib][:, :3, 3]
    rmse, s = evaluate_ate(ce, cg, with_scale)
    return {"ate_rmse_m": rmse, "scale": s, "n_poses": int(len(ia)),
            "coverage": float(len(ia)) / max(len(ts_g), 1)}


def eval_kitti(traj_path, gt_path, n_frames, with_scale=False):
    T_e = load_kitti_traj(traj_path)
    T_g = load_kitti_traj(gt_path)
    n = min(len(T_e), len(T_g))
    if n < 10:
        return {"error": f"only {n} poses"}
    rmse, s = evaluate_ate(T_e[:n, :3, 3], T_g[:n, :3, 3], with_scale)
    return {"ate_rmse_m": rmse, "scale": s, "n_poses": int(n),
            "coverage": float(len(T_e)) / max(n_frames, 1)}


# ---------------------------------------------------------------------------
# Runners
# ---------------------------------------------------------------------------

def run_reference(seq: str, workdir: str) -> dict:
    info = SEQS[seq]
    seq_dir = os.path.join(DATA, info.get("dir", seq))
    settings = os.path.join(seq_dir, "settings.yaml")
    os.makedirs(workdir, exist_ok=True)
    if info["kind"] == "tum_rgbd":
        exe = os.path.join(REF_BUILD, "Examples", "RGB-D", "rgbd_tum")
        cmd = [exe, REF_VOCAB, settings, seq_dir,
               os.path.join(seq_dir, "associations.txt")]
    elif info["kind"] == "tum_mono":
        exe = os.path.join(REF_BUILD, "Examples", "Monocular", "mono_tum")
        cmd = [exe, REF_VOCAB, settings, seq_dir]
    elif info["kind"] == "kitti_stereo":
        exe = os.path.join(REF_BUILD, "Examples", "Stereo", "stereo_kitti")
        cmd = [exe, REF_VOCAB, settings, seq_dir]
    else:
        raise ValueError(info["kind"])
    t0 = time.time()
    p = subprocess.run(cmd, cwd=workdir, capture_output=True, text=True,
                       timeout=3600)
    wall = time.time() - t0
    out = p.stdout + p.stderr
    res = {"wall_s": wall, "rc": p.returncode}
    m = re.search(r"median tracking time: ([0-9.e-]+)", out)
    if m:
        res["median_track_s"] = float(m.group(1))
    m = re.search(r"mean tracking time: ([0-9.e-]+)", out)
    if m:
        res["mean_track_s"] = float(m.group(1))
        res["fps"] = 1.0 / max(float(m.group(1)), 1e-9)
    res["loops"] = len(re.findall(r"Loop detected", out))
    tail = "\n".join(out.strip().splitlines()[-15:])
    res["log_tail"] = tail
    if info["kind"] == "tum_mono":
        traj_path = os.path.join(workdir, "KeyFrameTrajectory.txt")
        if os.path.exists(traj_path):
            res.update(eval_tum(traj_path,
                                os.path.join(seq_dir, "groundtruth.txt"),
                                with_scale=True))
        else:
            res["error"] = "no trajectory written"
        return res
    traj_path = os.path.join(workdir, "CameraTrajectory.txt")
    if os.path.exists(traj_path):
        if info["kind"] == "tum_rgbd":
            res.update(eval_tum(traj_path,
                                os.path.join(seq_dir, "groundtruth.txt")))
        else:
            res.update(eval_kitti(traj_path,
                                  os.path.join(seq_dir, "poses_gt.txt"),
                                  n_frames=400))
    else:
        res["error"] = "no trajectory written"
    return res


def run_ours(seq: str, workdir: str, repeat: int = 1) -> dict:
    """repeat=2 replays the sequence twice IN ONE PROCESS (run_dataset
    --runs) and reports the WARM run's timing: the first run pays the
    one-time jit compiles AND the per-process load of each cached
    executable onto the device — the analogue of the reference's
    ahead-of-time C++ build + OS loader, both untimed by its driver.
    Frames are pre-staged to device memory (RUN_PRESTAGE), matching the
    reference driver's timer which brackets Track* alone and reads
    images from the OS page cache (Examples/RGB-D/rgbd_tum.cc:84-104).
    Trajectories are bit-identical across runs
    (tests/test_determinism.py)."""
    info = SEQS[seq]
    seq_dir = os.path.join(DATA, info.get("dir", seq))
    settings = os.path.join(seq_dir, "settings.yaml")
    os.makedirs(workdir, exist_ok=True)
    env = dict(os.environ)
    if info["kind"] == "tum_rgbd":
        cmd = [sys.executable, "-u", os.path.join(REPO, "examples", "rgbd_tum.py"),
               "-", settings, seq_dir,
               os.path.join(seq_dir, "associations.txt")]
    elif info["kind"] == "tum_mono":
        cmd = [sys.executable, "-u",
               os.path.join(REPO, "examples", "mono_tum.py"),
               "-", settings, seq_dir]
    elif info["kind"] == "kitti_stereo":
        cmd = [sys.executable, "-u",
               os.path.join(REPO, "examples", "stereo_kitti.py"),
               "-", settings, seq_dir]
    else:
        raise ValueError(info["kind"])
    env["RUN_RUNS"] = str(max(repeat, 1))
    env.setdefault("RUN_PRESTAGE", "1")
    t0 = time.time()
    p = subprocess.run(cmd, cwd=workdir, capture_output=True, text=True,
                       timeout=5400, env=env)
    wall = time.time() - t0
    out = p.stdout + p.stderr
    res = {"wall_s": wall, "rc": p.returncode,
           "runs_in_process": max(repeat, 1),
           "prestaged": env["RUN_PRESTAGE"] not in ("", "0")}
    # our drivers print times in ms (examples/run_dataset.py)
    m = re.search(r"median tracking time: ([0-9.e-]+) ms", out)
    if m:
        res["median_track_s"] = float(m.group(1)) / 1e3
    m = re.search(r"mean tracking time:\s+([0-9.e-]+) ms", out)
    if m:
        res["mean_track_s"] = float(m.group(1)) / 1e3
        res["fps"] = 1e3 / max(float(m.group(1)), 1e-9)
    # with in-process replays, count loops from the TIMED (last) run only
    timed_out = out.rsplit("--- run ", 1)[-1]
    res["loops"] = len(re.findall(r"[Ll]oop (closed|detected)", timed_out))
    m = re.search(r"run wall incl\. drain: ([0-9.e-]+) s \(([0-9.]+) fps\)",
                  timed_out)
    if m:
        res["warm_wall_s"] = float(m.group(1))
        res["wall_fps"] = float(m.group(2))
    res["log_tail"] = "\n".join(out.strip().splitlines()[-15:])
    if info["kind"] == "tum_mono":
        kf_path = os.path.join(workdir, "KeyFrameTrajectory_kf_tum.txt")
        if os.path.exists(kf_path):
            res.update(eval_tum(kf_path,
                                os.path.join(seq_dir, "groundtruth.txt"),
                                with_scale=True))
            full = eval_tum(
                os.path.join(workdir, "KeyFrameTrajectory_tum.txt"),
                os.path.join(seq_dir, "groundtruth.txt"), with_scale=True)
            res["full_traj_ate_rmse_m"] = full.get("ate_rmse_m")
        else:
            res["error"] = "no trajectory written"
        return res
    traj_path = os.path.join(workdir, "CameraTrajectory_tum.txt")
    if os.path.exists(traj_path):
        if info["kind"] == "tum_rgbd":
            res.update(eval_tum(traj_path,
                                os.path.join(seq_dir, "groundtruth.txt")))
        else:
            res.update(eval_kitti(
                os.path.join(workdir, "CameraTrajectory_kitti.txt"),
                os.path.join(seq_dir, "poses_gt.txt"), n_frames=400))
    else:
        res["error"] = "no trajectory written"
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", action="append", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--system", choices=["ref", "ours", "both"],
                    default="both")
    ap.add_argument("--repeat", type=int, default=2,
                    help="runs of ours per sequence; timing from the "
                         "last (warm-compile-cache) run")
    ap.add_argument("--out", default=os.path.join(REPO, "data", "h2h"))
    args = ap.parse_args()
    seqs = list(SEQS) if args.all or not args.seq else args.seq
    results = {}
    for seq in seqs:
        results[seq] = {}
        if args.system in ("ref", "both"):
            print(f"[{seq}] reference ...", flush=True)
            results[seq]["reference"] = run_reference(
                seq, os.path.join(args.out, seq, "ref"))
            r = results[seq]["reference"]
            print(f"  -> ate={r.get('ate_rmse_m')} fps={r.get('fps')} "
                  f"rc={r['rc']}", flush=True)
        if args.system in ("ours", "both"):
            print(f"[{seq}] ours ...", flush=True)
            results[seq]["ours"] = run_ours(
                seq, os.path.join(args.out, seq, "ours"),
                repeat=args.repeat)
            r = results[seq]["ours"]
            print(f"  -> ate={r.get('ate_rmse_m')} fps={r.get('fps')} "
                  f"rc={r['rc']}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "results.json")
    existing = {}
    if os.path.exists(path):
        with open(path) as f:
            existing = json.load(f)
    for seq, d in results.items():
        existing.setdefault(seq, {}).update(d)
    with open(path, "w") as f:
        json.dump(existing, f, indent=1)
    print(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
