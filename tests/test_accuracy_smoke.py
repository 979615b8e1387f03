"""Accuracy regression smoke on the rendered head-to-head data
(VERDICT r2 item 2 / r3 item 8: accuracy regressions must fail CI, not
just the benchmark round — and the gate must run from a clean checkout).

Runs the first 90 frames of the desk sequence — the same on-disk imagery
the C++ reference is measured on (BENCH_ACCURACY.md) — at the REFERENCE
thresholds (match_th_scale=1.0) and asserts full coverage and mm-class
ATE. Catches the round-2 class of failures: the 0.29m trajectory-saver
bursts (dead-KF re-parenting), tracking loss, and BA-window collapse all
blow the threshold by an order of magnitude.

When data/synth/desk (the full 400-frame h2h sequence) is absent, the
renderer regenerates the 90-frame head DETERMINISTICALLY into
data/synth_test/desk (same scene/trajectory seeds as
tools/make_datasets.py, so the imagery is bit-identical to the h2h
sequence's head) — the gate never silently skips.
"""

import os

import numpy as np
import pytest

# a long accuracy run, kept out of the default suite; opt in with
# RUN_SLOW_TESTS=1
pytestmark = pytest.mark.skipif(
    os.environ.get("RUN_SLOW_TESTS", "") in ("", "0"),
    reason="slow accuracy smoke is opt-in (RUN_SLOW_TESTS=1)",
)

REPO = os.path.join(os.path.dirname(__file__), "..")
SEQ_FULL = os.path.join(REPO, "data", "synth", "desk")
SEQ_TEST = os.path.join(REPO, "data", "synth_test", "desk")

N_FRAMES = 90
# measured 5.7-6.8 mm at r3/r4 heads (reference: 5.4 mm); ~2x headroom so
# day-to-day noise passes but a 2x regression fails (VERDICT r3 item 8)
ATE_LIMIT_M = 0.015


def _sequence_dir() -> str:
    if os.path.isdir(SEQ_FULL):
        return SEQ_FULL
    if not os.path.isdir(SEQ_TEST):
        # deterministic regeneration of the desk head: seeds and geometry
        # identical to tools/make_datasets.py::make_desk
        from orb_slam2_comment_tpu.utils import render as rr

        K_TUM = (520.0, 520.0, 320.0, 240.0)
        HW_TUM = (480, 640)
        scene = rr.make_room(seed=13, size=(7.0, 3.0, 7.0), n_boxes=6)
        poses = rr.desk_trajectory(400, seed=3)[:N_FRAMES]
        rr.write_tum_rgbd(SEQ_TEST, scene, poses, K_TUM, HW_TUM, fps=30.0)
        rr.write_settings_yaml(
            os.path.join(SEQ_TEST, "settings.yaml"), K_TUM, HW_TUM,
            fps=30.0, bf=40.0, depth_factor=rr.DEPTH_FACTOR_TUM,
            n_features=1000)
    return SEQ_TEST


def test_desk_head_ate():
    from orb_slam2_comment_tpu.models.system import System
    from orb_slam2_comment_tpu.utils import datasets as ds
    from orb_slam2_comment_tpu.utils.config import load_yaml_settings

    seq = _sequence_dir()
    cfg = load_yaml_settings(os.path.join(seq, "settings.yaml"), "rgbd")
    items = ds.load_tum_rgbd(
        seq, os.path.join(seq, "associations.txt"))[:N_FRAMES]
    system = System(cfg)
    for i, f in enumerate(ds.FramePrefetcher(items, lookahead=8, threads=4)):
        system.track_rgbd(f["image"], f["depth"], f["timestamp"])
    system.shutdown()

    # evaluate against ground truth with the h2h harness's own machinery
    import sys

    sys.path.insert(0, os.path.join(REPO, "tools"))
    from head_to_head import associate, evaluate_ate, load_tum_traj

    fp = system._frame_poses()
    assert len(fp) >= N_FRAMES - 2, f"coverage {len(fp)}/{N_FRAMES}"
    ts = np.array([t for t, _ in fp])
    centers = np.stack([np.linalg.inv(T)[:3, 3] for _, T in fp])
    gt_ts, gt_T = load_tum_traj(os.path.join(seq, "groundtruth.txt"))
    ia, ib = associate(ts, gt_ts)
    rmse, _ = evaluate_ate(centers[ia], gt_T[ib][:, :3, 3])
    assert rmse < ATE_LIMIT_M, f"desk head ATE {rmse*1000:.1f} mm"
