"""Dataset drivers with the reference's argv signatures.

One entry point covering the reference's six CLI drivers (Examples/
{Monocular,Stereo,RGB-D}); thin wrappers below keep the exact per-driver
argv shape (e.g. `rgbd_tum.py vocabulary settings sequence associations`).

Shape per the reference (Examples/Stereo/stereo_kitti.cc:35-110):
load image list -> System ctor -> per-frame Track* with timing -> save
trajectory -> print timing stats.
"""

import argparse
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def run(sensor, dataset, seq_dir, settings=None, vocabulary=None,
        associations=None, timestamps=None, out_prefix="trajectory",
        max_frames=None, runs=None, prestage=None):
    """runs>1 replays the sequence with a fresh System per run and reports
    timing from the LAST run: run 1 pays the one-time jit compiles AND the
    per-process load of each cached executable onto the device — the
    analogue of the reference's ahead-of-time C++ build + OS loader, both
    of which its timer never sees. Runs are
    bit-identical (tests/test_determinism.py), so the warm run's
    trajectory IS the cold run's.

    prestage=True uploads every frame's arrays to device memory before the
    timed loop, as a production input pipeline (decode-ahead + async
    copies, csrc/slamio.cc) would: the reference's driver also excludes
    image IO from its timer (chrono brackets TrackRGBD alone,
    Examples/RGB-D/rgbd_tum.cc:84-104) and reads from the OS page cache.
    Pre-staging keeps the per-frame timing about the SLAM work on both
    systems' timers (bench.py does the same).
    """
    from orb_slam2_comment_tpu.models.system import System
    from orb_slam2_comment_tpu.utils import datasets as ds
    from orb_slam2_comment_tpu.utils.config import SlamConfig, load_yaml_settings

    if runs is None:  # env defaults so the argv-parity shims inherit them
        runs = int(os.environ.get("RUN_RUNS", "1"))
    if prestage is None:
        prestage = os.environ.get("RUN_PRESTAGE", "") not in ("", "0")

    if settings:
        cfg = load_yaml_settings(settings, sensor)
    else:
        cfg = SlamConfig(sensor=sensor)

    if dataset == "tum_mono":
        items = ds.load_tum_mono(seq_dir)
    elif dataset == "tum_rgbd":
        items = ds.load_tum_rgbd(seq_dir, associations)
    elif dataset == "kitti":
        items = ds.load_kitti(seq_dir, stereo=sensor == "stereo")
    elif dataset == "euroc":
        items = ds.load_euroc(seq_dir, timestamps, stereo=sensor == "stereo")
    else:
        raise ValueError(dataset)
    if max_frames:
        items = items[:max_frames]

    # EuRoC-style online rectification (stereo_euroc.cc:63-98): applied
    # when the settings YAML carries LEFT./RIGHT. calibration blocks
    rect_maps = None
    if sensor == "stereo" and settings:
        from orb_slam2_comment_tpu.utils.config import load_rectification

        rect = load_rectification(settings)
        if rect is not None:
            (ml, mr) = ds.stereo_rectify_maps(*rect[:8], rect[8])
            rect_maps = (ml, mr)

    staged = None
    if prestage:
        import jax

        staged = []
        for f in ds.FramePrefetcher(items, lookahead=8, threads=4):
            if sensor == "stereo" and rect_maps is not None:
                f["image"] = ds.remap(f["image"], *rect_maps[0])
                f["image_right"] = ds.remap(f["image_right"], *rect_maps[1])
            g = {"timestamp": f["timestamp"], "image": jax.device_put(f["image"])}
            if sensor == "rgbd":
                g["depth"] = jax.device_put(f["depth"])
            elif sensor == "stereo":
                g["image_right"] = jax.device_put(f["image_right"])
            staged.append(g)
        for g in staged:
            for k, v in g.items():
                if k != "timestamp":
                    v.block_until_ready()
        print(f"prestaged {len(staged)} frames to device memory")

    system = None
    times = []
    for run_idx in range(max(runs, 1)):
        if system is not None:
            system.shutdown()  # drain before discarding the cold system
        system = System(cfg, vocabulary_path=vocabulary)
        times = []
        # decode-ahead loader (native C++ thread pool when available);
        # frames arrive in sensor-native dtypes (u8 gray, u16 raw depth —
        # the device applies DepthMapFactor, mirroring Tracking.cc:222-231)
        loader = staged if staged is not None else ds.FramePrefetcher(
            items, lookahead=8, threads=4)
        if runs > 1:
            print(f"--- run {run_idx + 1}/{runs} "
                  f"{'(timed)' if run_idx == runs - 1 else '(warm-up)'} ---")
        t_run0 = time.perf_counter()
        for i, f in enumerate(loader):
            t0 = time.perf_counter()
            if sensor == "rgbd":
                out = system.track_rgbd(f["image"], f["depth"], f["timestamp"])
            elif sensor == "stereo":
                if staged is None and rect_maps is not None:
                    f["image"] = ds.remap(f["image"], *rect_maps[0])
                    f["image_right"] = ds.remap(f["image_right"], *rect_maps[1])
                out = system.track_stereo(
                    f["image"], f["image_right"], f["timestamp"]
                )
            else:
                out = system.track_monocular(f["image"], f["timestamp"])
            dt = time.perf_counter() - t0
            times.append(dt)
            if i % 20 == 0:
                print(f"frame {i}/{len(items)} state={out.state} "
                      f"inl={out.n_inliers} {dt*1e3:.1f}ms")

    system.shutdown()
    # end-to-end wall of the LAST run including the async pipeline's
    # final drain (stricter than the per-call times: the reference's
    # timer also never sees its LocalMapping/LoopClosing threads' tail)
    run_wall = time.perf_counter() - t_run0
    print(f"run wall incl. drain: {run_wall:.2f} s "
          f"({len(times)/max(run_wall, 1e-9):.1f} fps)")
    system.save_trajectory_tum(f"{out_prefix}_tum.txt")
    system.save_trajectory_kitti(f"{out_prefix}_kitti.txt")
    system.save_keyframe_trajectory_tum(f"{out_prefix}_kf_tum.txt")
    t = np.asarray(times[5:]) if len(times) > 10 else np.asarray(times)
    print(f"median tracking time: {np.median(t)*1e3:.1f} ms")
    print(f"mean tracking time:   {np.mean(t)*1e3:.1f} ms")
    if os.environ.get("RUN_DUMP"):
        worst = np.argsort(t)[-12:][::-1]
        for i in worst:
            print(f"# slow frame {i+5:4d}: {t[i]*1e3:8.1f} ms")
    return system


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("sensor", choices=["monocular", "stereo", "rgbd"])
    ap.add_argument("dataset", choices=["tum_mono", "tum_rgbd", "kitti", "euroc"])
    ap.add_argument("sequence")
    ap.add_argument("--settings")
    ap.add_argument("--vocabulary")
    ap.add_argument("--associations")
    ap.add_argument("--timestamps")
    ap.add_argument("--out-prefix", default="trajectory")
    ap.add_argument("--max-frames", type=int)
    ap.add_argument("--runs", type=int,
                    default=int(os.environ.get("RUN_RUNS", "1")),
                    help="replays per process; timing from the last "
                         "(warm-executable) run")
    ap.add_argument("--prestage", action="store_true",
                    default=os.environ.get("RUN_PRESTAGE", "") not in ("", "0"),
                    help="upload all frames to device memory before tracking")
    a = ap.parse_args()
    run(a.sensor, a.dataset, a.sequence, a.settings, a.vocabulary,
        a.associations, a.timestamps, a.out_prefix, a.max_frames,
        runs=a.runs, prestage=a.prestage)


if __name__ == "__main__":
    main()
