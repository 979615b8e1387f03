"""Device time of the layers that had hand-written kernels, on the GPU.

Times, from jax.profiler traces, what XLA makes of the plain version of
each layer at the sensor configurations' widths, and the hand-written
pose-LM kernel beside its XLA twin in the same process:

  fast_nms       FAST score + border + 3x3 NMS over a whole pyramid
  patch_gather   the per-keypoint [48, 48] patch gather
  pose_lm        Triton kernel vs pose_optimize_xla
  lba_build      local-BA system assembly at the mapper's window: the
                 one-hot einsum (cam_major=True) vs the scatter-add path

then traces a window of warm RGB-D frames of chip_smoke.py's phase 3:
device time per frame, the pose-LM kernel's share of it (its events are
named pose_lm), and the window's wall time. The tracer slows the host,
so the window's wall time and busy share overstate idle time.

Device time of a call is the sum of the durations of the events on the
GPU planes of the trace; busy time is their union.

Usage: python tools/kernel_times.py [out.json]
"""

from __future__ import annotations

import glob
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402


def device_events(trace_dir):
    """[(start_ns, dur_ns, name)] of every event on a GPU plane of the
    newest trace under trace_dir."""
    import jax

    pb = max(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                       recursive=True), key=os.path.getmtime)
    out = []
    for plane in jax.profiler.ProfileData.from_file(pb).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for e in line.events:
                out.append((e.start_ns, e.duration_ns, e.name))
    return out


def busy_ns(events):
    """Length of the union of the events' intervals."""
    total, end = 0.0, -np.inf
    for s, d, _ in sorted(events):
        if s + d > end:
            total += s + d - max(s, end)
            end = s + d
    return total


def trace(fn, n):
    """Device events of n calls of fn, traced after one warm call."""
    import jax

    jax.block_until_ready(fn())
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            for _ in range(n):
                jax.block_until_ready(fn())
        return device_events(d)


def time_layer(name, fn, n=20):
    """Wall time per call (no tracer) and device time per call."""
    import jax

    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(n):
        r = fn()
    jax.block_until_ready(r)
    wall = (time.perf_counter() - t0) / n
    ev = trace(fn, n)
    row = {"layer": name, "wall_us": wall * 1e6,
           "device_us": sum(d for _, d, _ in ev) / n / 1e3,
           "busy_us": busy_ns(ev) / n / 1e3, "events_per_call": len(ev) / n}
    print(f"[layer] {name}: wall {row['wall_us']:.1f} us/call, device "
          f"{row['device_us']:.1f} us/call (busy {row['busy_us']:.1f}), "
          f"{row['events_per_call']:.0f} device events/call", flush=True)
    return row


def layers():
    import jax
    import jax.numpy as jnp

    import chip_smoke as cs
    from orb_slam2_comment_tpu.ops import optim, orb
    from orb_slam2_comment_tpu.ops.lm_pallas import pose_optimize_pallas

    rows = []
    r = np.random.default_rng(0)
    for tag, hw, n_feat in [("tum", cs.HW_TUM, 1000),
                            ("kitti", cs.HW_KITTI, 2000)]:
        cfg = orb.ORBConfig(n_features=n_feat, n_levels=8)
        levels = [jnp.asarray(r.integers(0, 255, s).astype(np.float32))
                  for s in cfg.level_sizes(*hw)]
        f = jax.jit(lambda ls: [orb.fast_nms(x) for x in ls])
        rows.append(time_layer(f"fast_nms {tag} 8 levels",
                               lambda: f(levels)))
        pd = orb._PATCH_PAD
        hy, hx = hw[0] + 2 * pd - orb._PATCH_W, hw[1] + 2 * pd - orb._PATCH_W
        stack = jnp.asarray(r.normal(size=(
            8, hy + orb._PATCH_HP, hx + orb._PATCH_WX)).astype(np.float32))
        lvl = jnp.asarray(r.integers(0, 8, n_feat).astype(np.int32))
        ys = jnp.asarray(r.integers(0, hy + 1, n_feat).astype(np.int32))
        xs = jnp.asarray(r.integers(0, hx + 1, n_feat).astype(np.int32))
        g = jax.jit(orb.gather_patches)
        rows.append(time_layer(f"patch_gather {tag} {n_feat}",
                               lambda: g(stack, lvl, ys, xs)))
        img = jnp.asarray(r.integers(0, 255, hw).astype(np.float32))
        e = jax.jit(lambda x: orb.extract(x, cfg)[0])
        rows.append(time_layer(f"extract {tag} {n_feat}x8", lambda: e(img)))
    for n in (1000, 2000):
        args, K, bf = cs.pose_problem(n)
        a = [jnp.asarray(x) for x in args]
        pk = jax.jit(lambda *a: pose_optimize_pallas(*a, K, bf))
        px = jax.jit(lambda *a: optim.pose_optimize_xla(*a, K, bf))
        rows.append(time_layer(f"pose_lm kernel {n}", lambda: pk(*a)))
        rows.append(time_layer(f"pose_lm xla {n}", lambda: px(*a)))
    prob, inv_s2, K, bf, n_free = cs.lba_problem()
    prob = jax.device_put(prob)
    for cam_major in (True, False):
        build = optim._lba_core(prob, jnp.asarray(inv_s2), K, bf,
                                cam_major=cam_major, n_free=n_free)[0]
        b = jax.jit(lambda: build(prob.cam_T, prob.pts, prob.obs_valid,
                                  True))
        rows.append(time_layer(
            f"lba_build {'einsum' if cam_major else 'scatter'}", b))
    return rows


def rgbd_window(first=16, last=32):
    """Device time over frames [first, last) of a warm RGB-D run (the
    first run of the sequence compiles; the second is traced)."""
    import jax

    import chip_smoke as cs
    from orb_slam2_comment_tpu.models.system import System

    cfg, frames, _ = cs.rgbd_setup()
    cs._drive(lambda: System(cfg), frames, cs.track_rgbd)
    system = System(cfg)
    for f in frames[:first]:
        cs.track_rgbd(system, f)
    system.tracker._flush_upto(1 << 60)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        with jax.profiler.trace(d):
            for f in frames[first:last]:
                cs.track_rgbd(system, f)
            system.tracker._flush_upto(1 << 60)
            jax.block_until_ready(system.tracker.map.kf_pose)
        wall = time.perf_counter() - t0
        ev = device_events(d)
    system.shutdown()
    n = last - first
    row = {"frames": n, "wall_ms_per_frame": wall / n * 1e3,
           "device_us_per_frame": sum(d for _, d, _ in ev) / n / 1e3,
           "pose_lm_us_per_frame": sum(
               d for _, d, name in ev if "pose_lm" in name) / n / 1e3,
           "busy_share": busy_ns(ev) / (wall * 1e9),
           "events_per_frame": len(ev) / n}
    print(f"[rgbd window] frames {first}-{last}: {row}", flush=True)
    return row


def main():
    import jax

    import orb_slam2_comment_tpu  # noqa: F401
    from chip_smoke import card_line

    d = jax.devices()[0]
    print(f"# device: {d.platform} {d.device_kind} x{len(jax.devices())}; "
          f"card: {card_line()}")
    if d.platform != "gpu":
        sys.exit("kernel_times.py measures the GPU; no GPU backend found")
    out = {"device": d.device_kind, "card": card_line(),
           "layers": layers(), "rgbd_window": rgbd_window()}
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
