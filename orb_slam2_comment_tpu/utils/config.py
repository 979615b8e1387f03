"""System configuration — the reference's YAML settings surface.

Covers every key the reference parses (Tracking.cc:46-148 and
Examples/*/ *.yaml: Camera.{fx,fy,cx,cy,k1,k2,p1,p2,k3,bf,fps,RGB},
ThDepth, DepthMapFactor, ORBextractor.*, Viewer.*), plus the fixed
capacities that make the device map state static-shape.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from orb_slam2_comment_tpu import constants as C
from orb_slam2_comment_tpu.ops.orb import ORBConfig

MONOCULAR = "monocular"
STEREO = "stereo"
RGBD = "rgbd"


@dataclass(frozen=True)
class SlamConfig:
    sensor: str = RGBD
    # Camera intrinsics / model
    fx: float = 520.0
    fy: float = 520.0
    cx: float = 320.0
    cy: float = 240.0
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    bf: float = 156.0          # baseline(m) * fx  (Camera.bf)
    fps: float = 20.0
    rgb: bool = True           # Camera.RGB channel order
    width: int = 640
    height: int = 480
    th_depth: float = 35.0     # close/far split: depth < bf*ThDepth/fx (Tracking.cc:126)
    depth_map_factor: float = 1.0  # TUM RGB-D: 5000
    # ORB extraction
    n_features: int = C.DEFAULT_N_FEATURES
    scale_factor: float = C.DEFAULT_SCALE_FACTOR
    n_levels: int = C.DEFAULT_N_LEVELS
    ini_th_fast: float = float(C.DEFAULT_INI_TH_FAST)
    min_th_fast: float = float(C.DEFAULT_MIN_TH_FAST)
    # Static map capacities (fixed device shapes). These are the STARTING
    # tier: with grow_capacity the map grows x4 (to the caps below) when
    # ~85% full, recompiling the jitted kernels once per tier — bounded
    # recompilation for KITTI-00-scale trajectories (~1.3k KFs) without
    # charging small maps large-capacity kernel costs (SURVEY.md §7).
    max_keyframes: int = 256
    max_points: int = 32768
    grow_capacity: bool = field(default=True, compare=False)  # host-only
    max_keyframes_cap: int = 2048
    max_points_cap: int = 262144
    # Local-mapping window capacities (static shapes).
    # The reference takes ALL covisible KFs free + all other observers
    # fixed (src/Optimizer.cc:456-546) and 10-20 triangulation neighbors
    # (src/LocalMapping.cc:237); these fixed-shape caps are the
    # static-shape equivalent — raise for fidelity, lower for per-KF
    # latency.
    ba_free_kfs: int = 16
    ba_fixed_kfs: int = 16
    ba_points: int = 2048
    tri_neighbors: int = 10
    fuse_neighbors: int = 10
    # Essential-graph covisibility edges kept per KF (the reference takes
    # ALL edges with weight >= 100, src/Optimizer.cc:917; the fixed-shape
    # top-k is the static-shape equivalent — a saturation warning is logged when
    # the cap drops qualifying edges)
    essential_topc: int = 32
    # Pipeline toggles. enable_local_ba / enable_kf_culling / fps /
    # localization_only are read inside jitted programs (static cfg key);
    # the compare=False fields below are HOST-ONLY dispatch knobs, excluded
    # from the dataclass hash so flipping them never recompiles the
    # pipeline (device-static vs host config split).
    enable_local_ba: bool = True
    enable_loop_closing: bool = field(default=True, compare=False)
    enable_kf_culling: bool = True
    localization_only: bool = False
    # Chunked mapper machine (P6): run the LocalMapping pass as bounded
    # per-frame device chunks carried in DeviceTrackState, with a live
    # mapper-idle flag gating the keyframe policy's c1b and abort-on-new-
    # keyframe — the reference's mapping-THREAD semantics
    # (src/LocalMapping.cc:47-112, 603-613; mbAbortBA :77-85). False =
    # the monolithic synchronous per-KF pass (one program).
    # Device-static: changes the compiled frame program.
    chunked_mapper: bool = True
    # Tracking execution mode: True = single fused device program with one
    # host sync per frame; False = the
    # reference's staged fallback ladder with host branch decisions
    # (several syncs per frame, slightly more robust margins).
    fused_tracking: bool = field(default=True, compare=False)
    # Stage-A depth of the fused RGB-D pipeline: frame i's tracking stage
    # dispatches when frame i+pipeline_lag arrives, giving the keypoint-xy
    # device->host pull pipeline_lag frame-times to cross the link before
    # the host samples the depth map with it. Raise when device->host
    # reads are slow, lower for minimum result latency.
    # compare=False: host-only scheduling knob, excluded from the
    # dataclass hash/eq so changing it does NOT recompile the jitted
    # pipeline (cfg is the static jit key)
    pipeline_lag: int = field(default=4, compare=False)
    # Hamming acceptance scaling: 1.0 reproduces the reference thresholds
    # (TH_LOW=50/TH_HIGH=100, ORBmatcher.cc:37-38), tuned for real-image
    # ORB stability. Synthetic scenes with noisier descriptors run at
    # 1.4-1.6.
    match_th_scale: float = 1.0
    # BoW FeatureVector grouping depth for node-gated matching: tree
    # levels descended to produce group ids. 2 gives ~k^2 groups — the
    # reference's effective granularity (ORBvoc L=6 at levelsup=4 ->
    # nodes at depth 2, TemplatedVocabulary.h:135-146).
    voc_levels: int = 2

    @property
    def th_low(self):
        """Strict acceptance, scaled but capped well below the ~128-bit
        random-descriptor mean (beyond which the gate is meaningless)."""
        from orb_slam2_comment_tpu import constants as _C

        return min(float(_C.TH_LOW) * self.match_th_scale, 100.0)

    @property
    def th_high(self):
        """Loose acceptance: intentionally NOT scaled — TH_HIGH=100 already
        absorbs viewpoint drift, and raising it past the random mean lets
        garbage associations poison pose optimization."""
        from orb_slam2_comment_tpu import constants as _C

        return float(_C.TH_HIGH)

    @property
    def K(self):
        return (self.fx, self.fy, self.cx, self.cy)

    @property
    def baseline(self):
        return self.bf / self.fx

    @property
    def depth_threshold(self):
        """Meters below which a stereo/RGBD point counts as 'close'
        (mThDepth = mbf * ThDepth / fx, Tracking.cc:126-131)."""
        return self.bf * self.th_depth / self.fx

    @property
    def orb(self) -> ORBConfig:
        return ORBConfig(
            n_features=self.n_features,
            n_levels=self.n_levels,
            scale_factor=self.scale_factor,
            ini_th=self.ini_th_fast,
            min_th=self.min_th_fast,
        )

    @property
    def has_distortion(self):
        return any(abs(v) > 1e-12 for v in (self.k1, self.k2, self.p1, self.p2, self.k3))


def load_yaml_settings(path: str, sensor: str) -> SlamConfig:
    """Parse an ORB-SLAM2-style YAML settings file (same keys as the
    reference's cv::FileStorage usage, e.g. Examples/RGB-D/TUM1.yaml).

    Supports the OpenCV '%YAML:1.0' header and flat 'Key.sub: value' lines
    without requiring a yaml library.
    """
    vals = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or line.startswith("%") or ":" not in line:
                continue
            key, _, val = line.partition(":")
            key, val = key.strip(), val.strip()
            if not val:
                continue
            try:
                vals[key] = float(val)
            except ValueError:
                vals[key] = val

    def g(key, default):
        return vals.get(key, default)

    return SlamConfig(
        sensor=sensor,
        fx=g("Camera.fx", 520.0),
        fy=g("Camera.fy", 520.0),
        cx=g("Camera.cx", 320.0),
        cy=g("Camera.cy", 240.0),
        k1=g("Camera.k1", 0.0),
        k2=g("Camera.k2", 0.0),
        p1=g("Camera.p1", 0.0),
        p2=g("Camera.p2", 0.0),
        k3=g("Camera.k3", 0.0),
        bf=g("Camera.bf", 0.0),
        fps=g("Camera.fps", 30.0),
        rgb=bool(int(g("Camera.RGB", 1))),
        width=int(g("Camera.width", 640)),
        height=int(g("Camera.height", 480)),
        th_depth=g("ThDepth", 35.0),
        depth_map_factor=g("DepthMapFactor", 1.0),
        n_features=int(g("ORBextractor.nFeatures", 1000)),
        scale_factor=g("ORBextractor.scaleFactor", 1.2),
        n_levels=int(g("ORBextractor.nLevels", 8)),
        ini_th_fast=g("ORBextractor.iniThFAST", 20.0),
        min_th_fast=g("ORBextractor.minThFAST", 7.0),
        # extension key (not in the reference): Hamming acceptance scaling
        # for low-texture/synthetic footage, cf. SlamConfig.match_th_scale
        match_th_scale=g("Matcher.thScale", 1.0),
    )


def load_rectification(path: str):
    """Parse the LEFT./RIGHT. {K,D,R,P,height,width} stereo-rectification
    blocks from an EuRoC-style settings YAML (Examples/Stereo/EuRoC.yaml:
    34-76, consumed by stereo_euroc.cc:63-98 and ros_stereo.cc:71-108).

    Returns (K1, D1, R1, P1, K2, D2, R2, P2, (h, w)) as numpy arrays, or
    None when the file carries no rectification blocks. Handles the
    OpenCV '!!opencv-matrix' node format without a yaml library.
    """
    import re

    import numpy as np

    text = open(path).read()
    mats = {}
    for m in re.finditer(
        r"(LEFT|RIGHT)\.(K|D|R|P)\s*:\s*!!opencv-matrix"
        r".*?data\s*:\s*\[(.*?)\]",
        text,
        re.DOTALL,
    ):
        side, name, data = m.group(1), m.group(2), m.group(3)
        vals = [float(v) for v in re.split(r"[,\s]+", data.strip()) if v]
        mats[f"{side}.{name}"] = np.asarray(vals, np.float64)
    needed = [f"{s}.{n}" for s in ("LEFT", "RIGHT") for n in "KDRP"]
    if not all(k in mats for k in needed):
        return None
    hm = re.search(r"LEFT\.height\s*:\s*(\d+)", text)
    wm = re.search(r"LEFT\.width\s*:\s*(\d+)", text)
    h = int(hm.group(1)) if hm else 480
    w = int(wm.group(1)) if wm else 752
    return (
        mats["LEFT.K"], mats["LEFT.D"], mats["LEFT.R"], mats["LEFT.P"],
        mats["RIGHT.K"], mats["RIGHT.D"], mats["RIGHT.R"], mats["RIGHT.P"],
        (h, w),
    )
