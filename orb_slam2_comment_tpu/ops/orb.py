"""Oriented multi-scale FAST + rotated binary descriptors as fixed-shape XLA.

Replaces the reference `ORBextractor` (src/ORBextractor.cc:1043-1105
pipeline: ComputePyramid -> gridded FAST -> quadtree distribution ->
IC_Angle -> Gaussian blur -> rotated 256-bit descriptors), redesigned for
XLA:

- FAST corner detection is a *dense score map*: the score of a pixel is the
  maximum threshold t for which the segment test (>=9 contiguous of 16 ring
  pixels all brighter/darker by t) still passes. One map serves both the
  reference's dual thresholds (iniThFAST=20 strict / minThFAST=7 fallback,
  src/ORBextractor.cc:784-816): ranking by score naturally prefers
  strict-threshold corners, and the acceptance floor is minTh.
- The quadtree spatial distribution (DistributeOctTree,
  src/ORBextractor.cc:539-763) becomes bucketed top-k: per 32x32 cell top-k
  after 3x3 NMS, then a global top-n_l by score. Behavior-equivalent
  spatial spreading without pointer trees; validated downstream by
  trajectory error, not per-corner identity (SURVEY.md "Hard parts").
- Orientation is the intensity-centroid angle over the radius-15 circular
  patch (IC_Angle, src/ORBextractor.cc:77-106) computed with a dense disk
  mask instead of per-row umax tables.
- The descriptor is a rotated-BRIEF: 256 pixel-pair comparisons on the
  7x7 sigma=2 blurred level image (src/ORBextractor.cc:1086-1090). The
  sampling pattern is NOT the reference's learned table; it is generated
  from a fixed-seed Gaussian (sigma = patch/5, the classic BRIEF choice)
  because descriptors here only need self-consistency — the vocabulary is
  trained on these descriptors too (the reference's ORBvoc.txt is absent
  from the mirror).

Everything is static-shape: each pyramid level yields exactly its budget
of slots, invalid slots are masked. All per-level work is traced once per
(image-shape, config).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from orb_slam2_comment_tpu import constants as C

# FAST 9-16 ring offsets (dx, dy), standard Bresenham circle radius 3,
# ordered around the circle.
_RING = [
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
]
_ARC = 9  # contiguous ring pixels required


def _brief_pattern(
    seed: int = 42, n_bits: int = 256, clip: int = 13, min_sep: float = 5.0
) -> np.ndarray:
    """[n_bits, 4] int32 (x1, y1, x2, y2) Gaussian test pattern.

    Test endpoints are N(0, (PATCH/5)^2) clipped to +-13 so rotated offsets
    stay within the 19px border (13*sqrt2 ~ 18.4 < EDGE_THRESHOLD), with a
    minimum separation between the two points of each pair: after the 7x7
    sigma=2 pre-blur, endpoints closer than ~2 sigma compare nearly equal
    intensities and their bits flip under pixel noise (measured: enforcing
    >=5px separation drops the median true-match Hamming distance
    substantially on low-frequency texture). The reference gets the same
    effect from its offline-learned bit_pattern_31_
    (src/ORBextractor.cc:150-408), which is not copied here by design.
    """
    r = np.random.default_rng(seed)
    sigma = C.PATCH_SIZE / 5.0
    out = np.zeros((n_bits, 4), np.int32)
    n = 0
    while n < n_bits:
        p = np.clip(np.round(r.normal(0.0, sigma, size=4)), -clip, clip)
        if np.hypot(p[0] - p[2], p[1] - p[3]) >= min_sep:
            out[n] = p
            n += 1
    return out


_PATTERN = _brief_pattern()

# radius-15 disk for IC_Angle: per-row half-width (the reference's umax
# table, src/ORBextractor.cc:410-470, in closed form)
_R = C.HALF_PATCH_SIZE
_DISK_W = [int(math.floor(math.sqrt(_R * _R - dy * dy))) for dy in range(_R + 1)]

# 7x7 sigma=2 Gaussian (separable), matching cv::GaussianBlur(7,7,2,2)
_g = np.exp(-0.5 * (np.arange(-3, 4) / 2.0) ** 2)
_GAUSS7 = (_g / _g.sum()).astype(np.float32)


class ORBConfig(NamedTuple):
    """Static extraction config (Examples/*/ *.yaml ORBextractor.* keys)."""

    n_features: int = C.DEFAULT_N_FEATURES
    n_levels: int = C.DEFAULT_N_LEVELS
    scale_factor: float = C.DEFAULT_SCALE_FACTOR
    ini_th: float = float(C.DEFAULT_INI_TH_FAST)
    min_th: float = float(C.DEFAULT_MIN_TH_FAST)
    cell: int = 32  # spatial-distribution bucket size (px)

    @property
    def scales(self):
        return [self.scale_factor ** l for l in range(self.n_levels)]

    @property
    def sigma2(self):
        return [s * s for s in self.scales]

    def level_sizes(self, h: int, w: int):
        return [
            (max(int(round(h / s)), 64), max(int(round(w / s)), 64))
            for s in self.scales
        ]

    def level_budgets(self):
        """Geometric per-level feature budget (src/ORBextractor.cc:200-221)."""
        f = 1.0 / self.scale_factor
        n0 = self.n_features * (1 - f) / (1 - f ** self.n_levels)
        budgets = [max(int(round(n0 * f ** l)), 8) for l in range(self.n_levels)]
        budgets[-1] = max(self.n_features - sum(budgets[:-1]), 8)
        return budgets


class FrameFeatures(NamedTuple):
    """Fixed-shape per-image feature set (the reference's keypoint vectors +
    descriptor Mat, include/Frame.h keypoint/descriptor members)."""

    xy: jax.Array        # [N, 2] level-0 pixel coords (x, y)
    response: jax.Array  # [N] FAST score
    angle: jax.Array     # [N] orientation, radians
    octave: jax.Array    # [N] int32 pyramid level
    desc: jax.Array      # [N, 8] uint32 packed 256-bit descriptors
    valid: jax.Array     # [N] bool

    @property
    def n_max(self):
        return self.xy.shape[0]


def unpack_descriptors_signed(desc: jax.Array, dtype=jnp.bfloat16) -> jax.Array:
    """[N, 8] uint32 -> [N, 256] +-1 (dtype) for Hamming matmuls."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (desc[..., None] >> shifts) & jnp.uint32(1)  # [N, 8, 32]
    bits = bits.reshape(desc.shape[:-1] + (256,))
    return (2.0 * bits.astype(dtype) - 1.0).astype(dtype)


def pack_bits(bits: jax.Array) -> jax.Array:
    """[..., 256] bool -> [..., 8] uint32."""
    b = bits.reshape(bits.shape[:-1] + (8, 32)).astype(jnp.uint32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(b << shifts, axis=-1, dtype=jnp.uint32)


def fast_score_map(img: jax.Array) -> jax.Array:
    """Dense FAST 9-16 score: max threshold at which the pixel is a corner.

    score(p) = max over the 16 length-9 contiguous arcs of
               min over arc of (ring - center)   [bright arcs]
           or  min over arc of (center - ring)   [dark arcs]
    A pixel is a FAST corner at threshold t iff score > t — so this single
    map subsumes the reference's dual-threshold retry
    (src/ORBextractor.cc:784-816).
    """
    h, w = img.shape
    p = jnp.pad(img, 3, mode="edge")
    d = jnp.stack(
        [p[3 + dy:3 + dy + h, 3 + dx:3 + dx + w] - img for (dx, dy) in _RING]
    )  # [16, H, W] ring minus center
    dcat = jnp.concatenate([d, d[: _ARC - 1]], axis=0)  # wraparound
    m_bright = dcat[0:16]
    m_dark = -dcat[0:16]
    for j in range(1, _ARC):
        m_bright = jnp.minimum(m_bright, dcat[j:j + 16])
        m_dark = jnp.minimum(m_dark, -dcat[j:j + 16])
    return jnp.maximum(jnp.max(m_bright, axis=0), jnp.max(m_dark, axis=0))


def _nms3(score: jax.Array) -> jax.Array:
    """3x3 non-maximum suppression; keeps the lexicographic (score desc,
    index asc) maximum of each window — exact tie-break towards the
    top-left. (An epsilon index ramp added to the score is NOT exact: the
    1e-6 steps fall below the f32 ulp at score magnitudes >= 32, so equal
    scores could tie or not depending on how the compiler fuses the
    arithmetic.)"""
    h, w = score.shape
    idx = (
        jax.lax.broadcasted_iota(jnp.int32, (h, w), 0) * w
        + jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    )
    big = jnp.int32(1 << 30)
    best_v, best_i = score, idx
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            v = jnp.full((h, w), -jnp.inf, score.dtype)
            i2 = jnp.full((h, w), big, jnp.int32)
            ys = slice(max(dy, 0), h + min(dy, 0))
            yd = slice(max(-dy, 0), h + min(-dy, 0))
            xs = slice(max(dx, 0), w + min(dx, 0))
            xd = slice(max(-dx, 0), w + min(-dx, 0))
            v = v.at[yd, xd].set(score[ys, xs])
            i2 = i2.at[yd, xd].set(idx[ys, xs])
            take = (v > best_v) | ((v == best_v) & (i2 < best_i))
            best_v = jnp.where(take, v, best_v)
            best_i = jnp.where(take, i2, best_i)
    return jnp.where(best_i == idx, score, 0.0)


def fast_nms(img: jax.Array) -> jax.Array:
    """FAST score map of one pyramid level, zeroed inside the
    EDGE_THRESHOLD border (so patches and descriptors stay in bounds),
    then 3x3 NMS. XLA fuses the ring-difference min/max chains."""
    h, w = img.shape
    m = C.EDGE_THRESHOLD
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    inb = (ys >= m) & (ys < h - m) & (xs >= m) & (xs < w - m)
    return _nms3(jnp.where(inb, fast_score_map(img), 0.0))


def _moment_maps(img: jax.Array):
    """Dense IC_Angle moments (m10, m01) over the radius-15 disk at every
    pixel (src/ORBextractor.cc:77-106), via row cumulative sums.

    For each row offset dy the disk contributes a centered window of
    half-width w(dy); window sums come from one prefix-sum per row
    (box filter) and x-weighted sums from a second prefix-sum of x*I.
    The dense formulation is ~50 elementwise ops + 2 cumsums per level.
    """
    h, w = img.shape
    P = jnp.pad(img, _R)  # zero pad; keypoints are >= EDGE_THRESHOLD inside
    hp, wp = h + 2 * _R, w + 2 * _R
    # prefix sums along x with a leading zero column: sum over [a..b] is
    # Cz[:, b+1] - Cz[:, a]
    zero = jnp.zeros((hp, 1), img.dtype)
    Cz = jnp.concatenate([zero, jnp.cumsum(P, axis=1)], axis=1)
    xabs = jnp.arange(wp, dtype=img.dtype)
    Tz = jnp.concatenate([zero, jnp.cumsum(P * xabs, axis=1)], axis=1)
    xc = jnp.arange(w, dtype=img.dtype) + _R  # output centers, padded coords

    def win(A, row0, wd):
        # A[row0 : row0+h, xc-wd .. xc+wd] summed along x, for all outputs
        blk = A[row0:row0 + h]
        return blk[:, _R + wd + 1:_R + wd + 1 + w] - blk[:, _R - wd:_R - wd + w]

    m10 = jnp.zeros((h, w), img.dtype)
    m01 = jnp.zeros((h, w), img.dtype)
    for dy in range(0, _R + 1):
        wd = _DISK_W[dy]
        box_p = win(Cz, _R + dy, wd)
        ramp_p = win(Tz, _R + dy, wd) - xc[None, :] * box_p
        if dy == 0:
            m10 = m10 + ramp_p
        else:
            box_m = win(Cz, _R - dy, wd)
            ramp_m = win(Tz, _R - dy, wd) - xc[None, :] * box_m
            m10 = m10 + ramp_p + ramp_m
            m01 = m01 + dy * (box_p - box_m)
    return m10, m01


@functools.lru_cache(maxsize=None)
def _resize_matrix(n_in: int, n_out: int):
    """Bilinear interpolation as a dense [n_out, n_in] matrix (half-pixel
    centers, edge-clamped — matches jax.image.resize(method='linear')).

    Resizing becomes two matmuls instead of a gather-based resize."""
    scale = n_in / n_out
    x = (np.arange(n_out) + 0.5) * scale - 0.5
    x0 = np.floor(x).astype(np.int64)
    frac = (x - x0).astype(np.float32)
    lo = np.clip(x0, 0, n_in - 1)
    hi = np.clip(x0 + 1, 0, n_in - 1)
    M = np.zeros((n_out, n_in), np.float32)
    M[np.arange(n_out), lo] += 1.0 - frac
    M[np.arange(n_out), hi] += frac
    return M


def _resize_level(img: jax.Array, hw) -> jax.Array:
    h1, w1 = img.shape
    h2, w2 = hw
    Ry = jnp.asarray(_resize_matrix(h1, h2))
    Rx = jnp.asarray(_resize_matrix(w1, w2))
    return (Ry @ img) @ Rx.T


def _select_keypoints(score: jax.Array, budget: int, cell: int, min_th: float):
    """Bucketed top-k spatial distribution (quadtree equivalent).

    Returns (xy [budget,2] int32 level coords, response [budget], valid).
    """
    h, w = score.shape
    ch, cw = -(-h // cell), -(-w // cell)
    pad_h, pad_w = ch * cell - h, cw * cell - w
    s = jnp.pad(score, ((0, pad_h), (0, pad_w)))
    cells = s.reshape(ch, cell, cw, cell).transpose(0, 2, 1, 3).reshape(ch * cw, cell * cell)
    n_cells = ch * cw
    k_cell = min(max(-(-3 * budget // n_cells), 1), cell * cell)
    vals, idx = jax.lax.top_k(cells, k_cell)  # [n_cells, k_cell]
    # decode level coords
    cell_row = (jnp.arange(n_cells) // cw)[:, None]
    cell_col = (jnp.arange(n_cells) % cw)[:, None]
    yy = cell_row * cell + idx // cell
    xx = cell_col * cell + idx % cell
    vals = vals.reshape(-1)
    yy, xx = yy.reshape(-1), xx.reshape(-1)
    ok = vals > min_th
    # Spread bonus: the best corner of each cell outranks all non-best
    # corners, approximating the quadtree's one-per-leaf coverage.
    is_best = (jnp.arange(n_cells * k_cell) % k_cell) == 0
    rank_key = jnp.where(ok, vals + jnp.where(is_best, 1e4, 0.0), -jnp.inf)
    top_vals, top_idx = jax.lax.top_k(rank_key, budget)
    sel_valid = jnp.isfinite(top_vals)
    sel_x = jnp.where(sel_valid, xx[top_idx], 0)
    sel_y = jnp.where(sel_valid, yy[top_idx], 0)
    sel_resp = jnp.where(sel_valid, vals[top_idx], 0.0)
    return jnp.stack([sel_x, sel_y], axis=-1).astype(jnp.int32), sel_resp, sel_valid


def _ic_angle(img: jax.Array, xy: jax.Array) -> jax.Array:
    """Intensity-centroid orientation (src/ORBextractor.cc:77-106).

    xy: [N,2] int level coords. Border must already be respected.
    """
    h, w = img.shape
    m10, m01 = _moment_maps(img)
    x = jnp.clip(xy[:, 0], _R, w - 1 - _R)
    y = jnp.clip(xy[:, 1], _R, h - 1 - _R)
    return jnp.arctan2(m01[y, x], m10[y, x])


def _rotated_test_indices(xy, angle, wl, hl, base):
    """Flat sample indices of the rotated BRIEF test pattern.

    xy: [N,2] int level coords; wl/hl/base: [N] per-keypoint level width,
    height and flat offset into the concatenated pyramid. Returns [N, 512]
    int32 (256 first endpoints, then 256 second endpoints).
    """
    pat = jnp.asarray(_PATTERN, jnp.float32)  # [256, 4]
    ca, sa = jnp.cos(angle), jnp.sin(angle)   # [N]

    def rot(px, py):
        rx = jnp.round(ca[:, None] * px[None] - sa[:, None] * py[None]).astype(jnp.int32)
        ry = jnp.round(sa[:, None] * px[None] + ca[:, None] * py[None]).astype(jnp.int32)
        return rx, ry

    r1x, r1y = rot(pat[:, 0], pat[:, 1])
    r2x, r2y = rot(pat[:, 2], pat[:, 3])
    x0, y0 = xy[:, 0][:, None], xy[:, 1][:, None]
    rx = jnp.concatenate([r1x, r2x], axis=1)  # [N, 512]
    ry = jnp.concatenate([r1y, r2y], axis=1)
    gx = jnp.clip(x0 + rx, 0, wl[:, None] - 1)
    gy = jnp.clip(y0 + ry, 0, hl[:, None] - 1)
    return base[:, None] + gy * wl[:, None] + gx


# ---------------------------------------------------------------------------
# Descriptor path as one matmul
#
# Instead of sampling 512 rotated BRIEF points per keypoint as element
# gathers (the reference's computeOrbDescriptor,
# src/ORBextractor.cc:108-148):
#   1. extract one RAW patch per keypoint (a vmapped dynamic_slice, which
#      XLA lowers to one gather of whole blocks), and
#   2. multiply by a static matrix S [48*48, Q*256+2] whose columns hold
#      +/- 7x7 Gaussian stamps at the rotated test offsets — one bf16
#      matmul computes blur + sampling + comparison input for ALL Q
#      rotation buckets at once, plus the IC_Angle disk moments (m10,
#      m01) in the last two columns.
# The per-keypoint bucket (from the exact moment-based angle) then selects
# its 256 bits. Rotation is quantized to Q=64 buckets (5.6 deg); the
# reference itself rounds rotated offsets to the pixel grid (~0.5px), so
# at radius <=13px the added error (<=0.64px) is at the same scale.
# ---------------------------------------------------------------------------

_PATCH_R = 21          # pattern radius <=17.7 rotated -> +/-18, +3 blur taps
_PATCH_W = 2 * _PATCH_R + 1
# stored patch extent: [48, 48], the layout of S's rows. The 5 rows and
# columns past the 43-pixel footprint carry real pixels, but S's rows at
# those positions are zero, so they never contribute.
_PATCH_WX = _PATCH_W + 5
_PATCH_HP = _PATCH_W + 5
# keypoints keep EDGE_THRESHOLD=19 from level borders; the patch reaches
# 21px, so the padded level stack carries this much extra zero margin
_PATCH_PAD = _PATCH_R - C.EDGE_THRESHOLD + 1  # = 3 (1 slack for rounding)
_BRIEF_Q = 64


@functools.lru_cache(maxsize=None)
def _brief_matrix_np(qb: int = _BRIEF_Q, stride: int = _PATCH_WX) -> np.ndarray:
    """The S matrix over a row-major [_PATCH_HP, stride] patch layout:
    row index of pixel (y, x) is y*stride + x; rows/columns beyond
    _PATCH_W stay zero."""
    P, W = _PATCH_R, _PATCH_W
    g = _GAUSS7.astype(np.float64)
    pat = _PATTERN.astype(np.float64)  # [256, 4] = (x1, y1, x2, y2)
    S = np.zeros((_PATCH_HP * stride, qb * 256 + 2), np.float64)

    th = 2.0 * np.pi * np.arange(qb) / qb
    ca, sa = np.cos(th)[:, None], np.sin(th)[:, None]  # [Q,1]
    # reference rounding of rotated offsets (cvRound)
    rx = np.rint(np.stack([ca * pat[:, 0] - sa * pat[:, 1],
                           ca * pat[:, 2] - sa * pat[:, 3]], axis=-1)).astype(int)
    ry = np.rint(np.stack([sa * pat[:, 0] + ca * pat[:, 1],
                           sa * pat[:, 2] + ca * pat[:, 3]], axis=-1)).astype(int)
    # rx/ry: [Q, 256, 2] (endpoint 0 = first test point, subtracted)
    dyx = np.arange(-3, 4)
    gw = np.outer(g, g)  # [7,7]
    yy = (P + ry[..., None, None] + dyx[None, None, None, :, None])  # [Q,256,2,7,1]
    xx = (P + rx[..., None, None] + dyx[None, None, None, None, :])  # [Q,256,2,1,7]
    full = (qb, 256, 2, 7, 7)
    rows = np.broadcast_to(yy * stride + xx, full).ravel()
    cols = np.broadcast_to(
        (np.arange(qb)[:, None] * 256 + np.arange(256)[None, :])[..., None, None, None],
        full,
    ).ravel()
    sign = np.broadcast_to(
        np.asarray([-1.0, 1.0])[None, None, :, None, None], full
    ).ravel()
    wts = np.broadcast_to(gw[None, None, None], full).ravel() * sign
    np.add.at(S, (rows, cols), wts)

    # IC_Angle disk moments on the 31x31 subgrid (src/ORBextractor.cc:77-106)
    dy, dx = np.mgrid[-_R:_R + 1, -_R:_R + 1]
    disk = (dx * dx + dy * dy) <= _R * _R
    ys, xs = np.nonzero(disk)
    rr = (ys - _R + P) * stride + (xs - _R + P)
    S[rr, -2] = dx[disk]
    S[rr, -1] = dy[disk]
    return S.astype(np.float32)


_BRIEF_S_DEV: dict = {}


def _brief_matrix(qb: int = _BRIEF_Q) -> jax.Array:
    """S as a committed device array, one per default device (so a
    process that also runs on its CPU device, as chip_smoke.py's
    reference does, keeps each copy where it is used). The bf16 cast
    happens in numpy (ml_dtypes) and device_put takes the numpy buffer,
    so this stays concrete even when first reached inside a jit trace (a
    traced astype here would leak a tracer into the cache) and the ~75MB
    matrix is hoisted as a buffer instead of inlined into every HLO."""
    key = (qb, str(jax.config.jax_default_device))
    if key not in _BRIEF_S_DEV:
        import ml_dtypes

        # escape any enclosing trace: the cache must hold a CONCRETE array
        # (a cached tracer poisons every later trace)
        with jax.ensure_compile_time_eval():
            _BRIEF_S_DEV[key] = jnp.asarray(
                _brief_matrix_np(qb).astype(ml_dtypes.bfloat16)
            )
    return _BRIEF_S_DEV[key]


def gather_patches(stack: jax.Array, lvl, y0, x0) -> jax.Array:
    """[L, Hp, Wp] level stack and [N] level / top-left row / top-left
    column -> [N, _PATCH_HP, _PATCH_WX] blocks. A vmapped dynamic_slice,
    which XLA lowers to one gather of whole blocks."""
    def one(l, y, x):
        return jax.lax.dynamic_slice(
            stack, (l, y, x), (1, _PATCH_HP, _PATCH_WX))[0]

    return jax.vmap(one)(lvl, y0, x0)


@functools.partial(jax.jit, static_argnames=("cfg", "shape"))
def _extract_impl(image: jax.Array, cfg: ORBConfig, shape):
    h, w = shape
    sizes = cfg.level_sizes(h, w)
    budgets = cfg.level_budgets()

    # Per-level dense stages (score/NMS/select) are plain elementwise work;
    # the orientation + descriptor stage runs once across all levels as
    # one matmul (see _brief_matrix above).
    xy_lvl, resp_all, valid_all = [], [], []
    pyramid = []
    level_img = image
    for lvl in range(cfg.n_levels):
        if lvl > 0:
            level_img = _resize_level(level_img, sizes[lvl])
        pyramid.append(level_img)
        score = fast_nms(level_img)
        xy_l, resp, valid = _select_keypoints(score, budgets[lvl], cfg.cell, cfg.min_th)
        xy_lvl.append(xy_l)
        resp_all.append(resp)
        valid_all.append(valid)

    n_lvls = cfg.n_levels
    oct_np = np.concatenate(
        [np.full(budgets[l], l, np.int32) for l in range(n_lvls)]
    )
    oct_dev = jnp.asarray(oct_np)
    xy_all = jnp.concatenate(xy_lvl)                       # [N, 2] level coords
    n_slots = xy_all.shape[0]

    # one [48, 48] raw patch per keypoint from the zero-padded level stack
    # (selection enforces EDGE_THRESHOLD=19 > 18, so patches never cross a
    # level boundary into the padding; the 5 extra rows/columns carry real
    # pixels that multiply zero rows of S). The stack is just large enough
    # that every clipped top-left corner's block lies inside it.
    pd = _PATCH_PAD
    hi_y = h + 2 * pd - _PATCH_W  # largest top-left corner
    hi_x = w + 2 * pd - _PATCH_W
    padded = jnp.zeros(
        (n_lvls, hi_y + _PATCH_HP, hi_x + _PATCH_WX), jnp.float32)
    for l in range(n_lvls):
        padded = padded.at[
            l, pd : pd + sizes[l][0], pd : pd + sizes[l][1]
        ].set(pyramid[l])
    ys0 = jnp.clip(xy_all[:, 1] - _PATCH_R + pd, 0, hi_y)
    xs0 = jnp.clip(xy_all[:, 0] - _PATCH_R + pd, 0, hi_x)
    patches = gather_patches(padded, oct_dev, ys0, xs0)    # [N, 48, 48]
    S = _brief_matrix()
    out = jnp.dot(
        patches.reshape(n_slots, _PATCH_HP * _PATCH_WX).astype(jnp.bfloat16),
        S,
        preferred_element_type=jnp.float32,
    )                                                      # [N, Q*256 + 2]
    # exact IC_Angle moments (u8 pixels and +/-15 coords are bf16-exact,
    # f32 accumulation)
    ang_all = jnp.arctan2(out[:, -1], out[:, -2])
    qb = _BRIEF_Q
    bucket = jnp.mod(
        jnp.round(ang_all / (2.0 * jnp.pi / qb)).astype(jnp.int32), qb
    )
    onehot = (
        jax.lax.broadcasted_iota(jnp.int32, (n_slots, qb), 1) == bucket[:, None]
    ).astype(jnp.float32)
    sel = jnp.einsum(
        "nqb,nq->nb", out[:, : qb * 256].reshape(n_slots, qb, 256), onehot
    )
    desc_all = pack_bits(sel > 0)

    scale_per_slot = jnp.asarray(
        np.concatenate(
            [np.full(budgets[l], cfg.scales[l], np.float32) for l in range(n_lvls)]
        )
    )
    feats = FrameFeatures(
        xy=xy_all.astype(jnp.float32) * scale_per_slot[:, None],
        response=jnp.concatenate(resp_all),
        angle=ang_all,
        octave=oct_dev,
        desc=desc_all,
        valid=jnp.concatenate(valid_all),
    )
    return feats, pyramid


def extract(image: jax.Array, cfg: ORBConfig):
    """Extract features from a [H, W] float32 grayscale image (0..255).

    Returns (FrameFeatures, pyramid list of per-level images). The pyramid
    is consumed by stereo SAD refinement (ops.stereo), mirroring the
    reference's mvImagePyramid reuse in Frame::ComputeStereoMatches
    (src/Frame.cc:540-560).
    """
    return _extract_impl(image.astype(jnp.float32), cfg, image.shape)
