"""Data association: masked Hamming-distance matching as matmuls.

Device-side replacement for the reference `ORBmatcher` (src/ORBmatcher.cc):
its 10 search strategies are all "find the best Hamming match subject to a
candidate predicate". Here the predicate becomes a mask over a dense
[N, M] distance matrix computed as a single matmul:

    hamming(a, b) = (256 - signed_bits(a) @ signed_bits(b)^T) / 2

with signed bits in bf16 — integer-exact (|sums| <= 256) and at the
matrix units' bf16 rate. Candidate sparsity (search windows, scale bands,
epipolar bands, BoW nodes) that the reference exploits with grids and
inverted indices (Frame::GetFeaturesInArea, src/Frame.cc:327-394) is
expressed as masks; at N,M ~ 2000 the dense product is ~2 GFLOP per pair
— small for an accelerator, and it removes every data-dependent shape.

Search strategies map to the reference as:
- match_window            <- SearchForInitialization (src/ORBmatcher.cc:405)
- match_projection        <- SearchByProjection x4 variants
                             (src/ORBmatcher.cc:45,290,1328,1472)
- match_nodes             <- SearchByBoW x2 (src/ORBmatcher.cc:159,522)
- match_epipolar          <- SearchForTriangulation (src/ORBmatcher.cc:657)
- (fusion / sim3 searches are match_projection with different inputs;
   see models.local_mapping / models.loop_closing)

All functions are jittable with static shapes; invalid rows/cols are
masked to +inf distance.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from orb_slam2_comment_tpu import constants as C
from orb_slam2_comment_tpu.ops.orb import unpack_descriptors_signed

_INF = 1e9


def hamming_matrix(sa: jax.Array, sb: jax.Array) -> jax.Array:
    """[N,256] x [M,256] signed (+-1) bits -> [N,M] float32 Hamming.

    Equivalent to the reference's popcount DescriptorDistance
    (src/ORBmatcher.cc:1647-1664) over all pairs.
    """
    dots = jnp.dot(
        sa.astype(jnp.bfloat16),
        sb.astype(jnp.bfloat16).T,
        preferred_element_type=jnp.float32,
    )
    return (256.0 - dots) * 0.5


def hamming_from_packed(da: jax.Array, db: jax.Array) -> jax.Array:
    """Packed [N,8]/[M,8] uint32 descriptors -> [N,M] Hamming distances."""
    return hamming_matrix(
        unpack_descriptors_signed(da), unpack_descriptors_signed(db)
    )


class MatchResult(NamedTuple):
    idx: jax.Array    # [N] best column per row (garbage where ~ok)
    dist: jax.Array   # [N] best distance
    ok: jax.Array     # [N] bool accepted


def _best_two(dist: jax.Array):
    """Per-row best and second-best distances + both indices."""
    best = jnp.argmin(dist, axis=1)
    d1 = jnp.take_along_axis(dist, best[:, None], axis=1)[:, 0]
    masked = dist.at[jnp.arange(dist.shape[0]), best].set(_INF)
    best2 = jnp.argmin(masked, axis=1)
    d2 = jnp.take_along_axis(masked, best2[:, None], axis=1)[:, 0]
    return best, d1, d2, best2


def _mutual_best(dist: jax.Array, row_best: jax.Array, row_ok: jax.Array):
    """Keep only matches that are also the best along their column
    (the reference enforces this via per-column bookkeeping, e.g.
    vnMatches21 in SearchForInitialization)."""
    n, m = dist.shape
    col_best = jnp.argmin(dist, axis=0)  # [M]
    mutual = col_best[row_best] == jnp.arange(n)
    return row_ok & mutual


def rotation_consistency(
    angles_a: jax.Array,
    angles_b_matched: jax.Array,
    ok: jax.Array,
    n_bins: int = C.HISTO_LENGTH,
):
    """Keep matches whose rotation offset falls in the 3 dominant bins.

    Mirrors ComputeThreeMaxima (src/ORBmatcher.cc:1601-1645): bins 2 and 3
    are kept only if their count exceeds 0.1x the max bin.
    """
    rot = (angles_a - angles_b_matched) % (2 * jnp.pi)
    bins = jnp.clip((rot * n_bins / (2 * jnp.pi)).astype(jnp.int32), 0, n_bins - 1)
    hist = jnp.zeros((n_bins,), jnp.int32).at[bins].add(ok.astype(jnp.int32))
    top3, top3i = jax.lax.top_k(hist, 3)
    keep1 = top3i[0]
    keep2 = jnp.where(top3[1] > 0.1 * top3[0], top3i[1], -1)
    keep3 = jnp.where(top3[2] > 0.1 * top3[0], top3i[2], -1)
    in_top = (bins == keep1) | (bins == keep2) | (bins == keep3)
    return ok & in_top


def match_generic(
    dist: jax.Array,
    mask: jax.Array,
    max_dist: float,
    nn_ratio: float | None = None,
    mutual: bool = False,
    angles_a: jax.Array | None = None,
    angles_b: jax.Array | None = None,
    octaves_b: jax.Array | None = None,
) -> MatchResult:
    """Best-match with acceptance threshold, Lowe ratio, mutual-best and
    rotation-consistency filters. `mask` [N,M] bool marks candidates.

    When `octaves_b` is given, the ratio test only applies if best and
    second-best candidates sit at the SAME octave — the reference's
    projection search accepts a cross-octave second-best regardless of
    ratio (src/ORBmatcher.cc:113-121: `if(bestLevel==bestLevel2 &&
    bestDist>mfNNratio*bestDist2) continue`), because the same physical
    corner redetected at an adjacent pyramid level is not a competing
    hypothesis."""
    d = jnp.where(mask, dist, _INF)
    best, d1, d2, best2 = _best_two(d)
    ok = d1 <= max_dist
    if nn_ratio is not None:
        ratio_ok = d1 < nn_ratio * d2
        if octaves_b is not None:
            same_level = octaves_b[best] == octaves_b[best2]
            ratio_ok = ratio_ok | ~same_level
        ok = ok & ratio_ok
    if mutual:
        ok = _mutual_best(d, best, ok)
    if angles_a is not None:
        ok = rotation_consistency(angles_a, angles_b[best], ok)
    return MatchResult(idx=best, dist=d1, ok=ok)


# --- Concrete searches ---------------------------------------------------

def match_window(
    feats_a,
    feats_b,
    radius: float = 100.0,
    max_dist: float = float(C.TH_LOW),
    nn_ratio: float = 0.9,
    check_rotation: bool = True,
) -> MatchResult:
    """Windowed search for monocular initialization
    (SearchForInitialization, src/ORBmatcher.cc:405-520: windowSize=100,
    mfNNratio=0.9, level-0 only, mutual best, rotation check)."""
    dist = hamming_from_packed(feats_a.desc, feats_b.desc)
    dxy = feats_a.xy[:, None, :] - feats_b.xy[None, :, :]
    close = jnp.sum(dxy * dxy, axis=-1) <= radius * radius
    lvl0 = (feats_a.octave[:, None] == 0) & (feats_b.octave[None, :] == 0)
    mask = close & lvl0 & feats_a.valid[:, None] & feats_b.valid[None, :]
    return match_generic(
        dist, mask, max_dist, nn_ratio, mutual=True,
        angles_a=feats_a.angle if check_rotation else None,
        angles_b=feats_b.angle,
    )


def match_projection(
    proj_xy: jax.Array,       # [P, 2] projected candidate points (pixels)
    proj_valid: jax.Array,    # [P] bool (in frustum etc.)
    proj_desc: jax.Array,     # [P, 8] uint32 representative descriptors
    proj_octave: jax.Array,   # [P] predicted scale level
    feats,
    radius: jax.Array | float,          # scalar or [P] search radius (px, level-0)
    scale_factors: jax.Array,           # [L] per-level scale
    max_dist: float = float(C.TH_HIGH),
    nn_ratio: float | None = None,
    octave_band: tuple = (-1, 1),
    angles_p: jax.Array | None = None,
) -> MatchResult:
    """Project map points / previous-frame points into a frame and match
    within a scale-aware radius (SearchByProjection family,
    src/ORBmatcher.cc:45-129 and :1328-1470).

    Row i = candidate point; column j = frame feature. Radius is scaled by
    the predicted octave's scale factor, as the reference does with
    th*mvScaleFactors[nPredictedLevel].
    """
    radius = jnp.broadcast_to(jnp.asarray(radius, jnp.float32), proj_xy.shape[:1])
    r_eff = radius * scale_factors[jnp.clip(proj_octave, 0, scale_factors.shape[0] - 1)]
    dist = hamming_from_packed(proj_desc, feats.desc)
    dxy = proj_xy[:, None, :] - feats.xy[None, :, :]
    close = jnp.sum(dxy * dxy, axis=-1) <= (r_eff * r_eff)[:, None]
    d_oct = feats.octave[None, :] - proj_octave[:, None]
    oct_ok = (d_oct >= octave_band[0]) & (d_oct <= octave_band[1])
    mask = close & oct_ok & proj_valid[:, None] & feats.valid[None, :]
    return match_generic(
        dist, mask, max_dist, nn_ratio,
        angles_a=angles_p, angles_b=feats.angle,
        octaves_b=feats.octave,
    )


def match_nodes(
    desc_a: jax.Array,
    nodes_a: jax.Array,
    valid_a: jax.Array,
    feats_b,
    nodes_b: jax.Array,
    max_dist: float = float(C.TH_LOW),
    nn_ratio: float = 0.7,
    angles_a: jax.Array | None = None,
) -> MatchResult:
    """BoW-accelerated matching: only features under the same vocabulary
    node (at BOW_LEVELS_UP) are candidates — identical acceptance set to
    the reference's FeatureVector-aligned loop (SearchByBoW,
    src/ORBmatcher.cc:159-288), expressed as a node-equality mask."""
    dist = hamming_from_packed(desc_a, feats_b.desc)
    mask = (
        (nodes_a[:, None] == nodes_b[None, :])
        & (nodes_a[:, None] >= 0)
        & valid_a[:, None]
        & feats_b.valid[None, :]
    )
    return match_generic(
        dist, mask, max_dist, nn_ratio,
        angles_a=angles_a, angles_b=feats_b.angle,
    )


def epipolar_distance2(F12: jax.Array, xy1: jax.Array, xy2: jax.Array) -> jax.Array:
    """[N,M] squared point-to-epiline distance of xy2 vs lines of xy1.

    Mirrors CheckDistEpipolarLine (src/ORBmatcher.cc:1575-1599)."""
    ones = jnp.ones(xy1.shape[:1] + (1,), xy1.dtype)
    h1 = jnp.concatenate([xy1, ones], axis=-1)        # [N,3]
    # with x1^T F12 x2 = 0, the epiline of x1 in image 2 is l2 = F12^T x1
    lines = h1 @ F12
    a, b, c = lines[:, 0], lines[:, 1], lines[:, 2]
    num = a[:, None] * xy2[None, :, 0] + b[:, None] * xy2[None, :, 1] + c[:, None]
    den = a * a + b * b
    return (num * num) / jnp.maximum(den, 1e-12)[:, None]


def match_epipolar(
    feats_a,
    feats_b,
    F12: jax.Array,
    sigma2_levels: jax.Array,
    unmatched_a: jax.Array,
    unmatched_b: jax.Array,
    max_dist: float = float(C.TH_LOW),
    check_rotation: bool = False,
) -> MatchResult:
    """Epipolar-constrained search for triangulating new map points
    (SearchForTriangulation, src/ORBmatcher.cc:657-824). Candidates must
    lie within 3.84*sigma^2 of the epipolar line (the reference's chi2(1)
    gate) and be currently unmatched in both keyframes."""
    dist = hamming_from_packed(feats_a.desc, feats_b.desc)
    ed2 = epipolar_distance2(F12, feats_a.xy, feats_b.xy)
    s2 = sigma2_levels[jnp.clip(feats_b.octave, 0, sigma2_levels.shape[0] - 1)]
    epi_ok = ed2 < 3.84 * s2[None, :]
    mask = (
        epi_ok
        & (unmatched_a & feats_a.valid)[:, None]
        & (unmatched_b & feats_b.valid)[None, :]
    )
    return match_generic(
        dist, mask, max_dist, nn_ratio=None, mutual=True,
        angles_a=feats_a.angle if check_rotation else None,
        angles_b=feats_b.angle,
    )
