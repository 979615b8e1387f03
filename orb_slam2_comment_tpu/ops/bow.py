"""Bag-of-binary-words place recognition — the DBoW2 replacement.

The reference vendors DBoW2 (Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h):
a k-branch, depth-L vocabulary tree of binary ORB centroids, transforming a
descriptor set into a TF-IDF-weighted sparse word vector plus a node->
feature grouping (FeatureVector) used to restrict matching. Its pretrained
ORBvoc.txt is stripped from this mirror (.MISSING_LARGE_BLOBS), so this
module both *trains* a vocabulary (binary k-medians, host-side) and runs
the transform on device.

Device redesign:
- the tree lives as flat arrays (children table + packed centroids);
- descent is L gather+argmin steps over all descriptors at once, with the
  Hamming-to-children computed via the same signed-bits matmul as
  ops.matching (TemplatedVocabulary::transform's per-descriptor recursive
  descent, header:355, becomes one batched kernel);
- BoW vectors are DENSE [n_words] arrays — at the few-thousand-word
  vocabularies this framework trains, dense scoring is a single matmul,
  which beats sparse-map intersection on an accelerator by construction. (The
  reference's 1M-word text vocabulary can be loaded with load_orb_vocab
  and descended the same way; scoring then uses the same dense path over
  active words.)
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from orb_slam2_comment_tpu.ops.orb import pack_bits, unpack_descriptors_signed


class Vocabulary(NamedTuple):
    """Flat-array vocabulary tree.

    nodes are indexed breadth-first; node 0 is the root (no centroid).
    """

    children: jax.Array    # [n_nodes, k] int32 child node ids (-1 none)
    node_desc: jax.Array   # [n_nodes, 8] uint32 centroids
    node_word: jax.Array   # [n_nodes] int32 word id if leaf else -1
    word_weight: jax.Array  # [n_words] f32 IDF weights
    group_depth: int       # depth whose node id becomes the FeatureVector key
    depth: int
    k: int

    @property
    def n_words(self):
        return self.word_weight.shape[0]

    @property
    def n_nodes(self):
        return self.children.shape[0]


def np_unpack_bits(desc: np.ndarray) -> np.ndarray:
    """[..., 8] uint32 -> [..., 256] uint8, LSB-first per word — the same
    bit order as ops.orb.pack_bits / unpack_descriptors_signed (np.packbits
    would be MSB-first and silently permute bits)."""
    shifts = np.arange(32, dtype=np.uint32)
    bits = (desc[..., None] >> shifts) & np.uint32(1)
    return bits.reshape(desc.shape[:-1] + (256,)).astype(np.uint8)


def np_pack_bits(bits: np.ndarray) -> np.ndarray:
    """[..., 256] -> [..., 8] uint32, inverse of np_unpack_bits."""
    b = bits.reshape(bits.shape[:-1] + (8, 32)).astype(np.uint32)
    shifts = np.arange(32, dtype=np.uint32)
    return (b << shifts).sum(axis=-1).astype(np.uint32)


def _majority(bits: np.ndarray) -> np.ndarray:
    """Bitwise majority of [N, 256] -> [256] uint8."""
    return (bits.sum(axis=0) * 2 >= bits.shape[0]).astype(np.uint8)


def _hamming_np(a_bits: np.ndarray, b_bits: np.ndarray) -> np.ndarray:
    """[N,256]x[M,256] unpacked-bit Hamming via packed popcount (40x less
    memory than broadcasting the unpacked bits; np>=2.0 bitwise_count)."""
    ap = np_pack_bits(a_bits)
    bp = np_pack_bits(b_bits)
    return np.bitwise_count(ap[:, None, :] ^ bp[None, :, :]).sum(
        -1, dtype=np.int32)


def train_vocabulary(
    descriptors: np.ndarray,  # [N, 8] uint32 packed
    k: int = 10,
    depth: int = 3,
    levels_up: int = 1,
    seed: int = 0,
    iters: int = 8,
) -> Vocabulary:
    """Binary k-medians tree (the DBoW2 create() analogue,
    TemplatedVocabulary.h HKmeansStep). Host-side numpy; run once offline.
    """
    r = np.random.default_rng(seed)
    bits = np_unpack_bits(np.asarray(descriptors))  # [N, 256]

    children_rows = [np.full(k, -1, np.int64)]  # root placeholder row
    node_descs = [np.zeros(256, np.uint8)]      # root has no centroid
    node_parent = [-1]
    node_depth = [0]

    packed_all = np_pack_bits(bits)

    def _dists_argmin(pdata, cents):
        # chunked over rows: the full [N, k, 8] broadcast is ~50 GB at
        # the 100k-word trainer's 1.7M-descriptor corpus
        pc = np_pack_bits(cents)[None, :, :]
        out = np.empty(len(pdata), np.int64)
        CH = 1 << 17
        for lo in range(0, len(pdata), CH):
            d = np.bitwise_count(
                pdata[lo:lo + CH, None, :] ^ pc).sum(-1, dtype=np.int32)
            out[lo:lo + CH] = d.argmin(1)
        return out

    def split(node_id, idx, d):
        nonlocal children_rows, node_descs
        if d >= depth or len(idx) < k:
            return
        data = bits[idx]
        pdata = packed_all[idx]
        # k-medians init: random distinct samples
        sel = r.choice(len(idx), size=min(k, len(idx)), replace=False)
        cents = data[sel].copy()
        for _ in range(iters):
            assign = _dists_argmin(pdata, cents)
            for c in range(len(cents)):
                members = data[assign == c]
                if len(members):
                    cents[c] = _majority(members)
        assign = _dists_argmin(pdata, cents)
        row = np.full(k, -1, np.int64)
        for c in range(len(cents)):
            members = idx[assign == c]
            if len(members) == 0:
                continue
            child_id = len(node_descs)
            node_descs.append(cents[c])
            node_parent.append(node_id)
            node_depth.append(d + 1)
            children_rows.append(np.full(k, -1, np.int64))
            row[c] = child_id
            split(child_id, members, d + 1)
        children_rows[node_id] = row

    split(0, np.arange(len(bits)), 0)

    n_nodes = len(node_descs)
    children = np.stack(children_rows)[:n_nodes]
    is_leaf = (children < 0).all(axis=1)
    is_leaf[0] = False
    node_word = np.full(n_nodes, -1, np.int64)
    leaves = np.where(is_leaf)[0]
    node_word[leaves] = np.arange(len(leaves))

    # IDF weights from the training corpus (TemplatedVocabulary::setNodeWeights)
    packed = np_pack_bits(np.stack(node_descs))
    voc = Vocabulary(
        children=jnp.asarray(children, jnp.int32),
        node_desc=jnp.asarray(packed),
        node_word=jnp.asarray(node_word, jnp.int32),
        word_weight=jnp.ones(len(leaves), jnp.float32),
        group_depth=max(depth - levels_up, 1),
        depth=depth,
        k=k,
    )
    # compute IDF by transforming the corpus (chunked: one 1.7M-row
    # descent allocated hundreds of GB of intermediates)
    counts = np.zeros(len(leaves), np.int64)
    CH = 1 << 16
    desc_np = np.asarray(descriptors)
    for lo in range(0, len(desc_np), CH):
        ch = desc_np[lo:lo + CH]
        words, _, _ = transform(
            voc, jnp.asarray(ch), jnp.ones(len(ch), bool))
        w = np.asarray(words)
        w = w[w >= 0]
        np.add.at(counts, w, 1)
    n = max(len(bits), 1)
    idf = np.log(n / np.maximum(counts, 1)).astype(np.float32)
    idf[counts == 0] = 0.0
    return voc._replace(word_weight=jnp.asarray(idf))


@functools.partial(jax.jit, static_argnames=("voc_depth", "voc_k", "group_depth"))
def _transform_impl(
    children, node_desc_signed, node_word, desc, valid,
    voc_depth: int, voc_k: int, group_depth: int,
):
    n = desc.shape[0]
    sbits = unpack_descriptors_signed(desc)  # [N, 256] bf16
    # Per-level descent with gathered CHILD centroids only: distances to
    # all nodes at once is O(N * n_nodes) — 444 MB per 1000-descriptor
    # transform at the 100k-word tree, and 780 GB when the trainer's IDF
    # pass ran the whole corpus through it. The gathered form touches
    # k centroids per descriptor per level at every scale.
    node = jnp.zeros(n, jnp.int32)
    group = jnp.zeros(n, jnp.int32)
    nmax = node_desc_signed.shape[0]
    for d in range(voc_depth):
        ch = children[node]                      # [N, k]
        has = ch >= 0
        chc = jnp.clip(ch, 0, nmax - 1)
        cent = node_desc_signed[chc]             # [N, k, 256]
        dots = jnp.einsum("nc,nkc->nk", sbits, cent,
                          preferred_element_type=jnp.float32)
        dch = jnp.where(has, (256.0 - dots) * 0.5, 1e9)
        best = jnp.argmin(dch, axis=1)
        nxt = jnp.take_along_axis(chc, best[:, None], axis=1)[:, 0]
        any_child = jnp.any(has, axis=1)
        node = jnp.where(any_child, nxt, node)
        if d + 1 == group_depth:
            group = node
    words = jnp.where(valid, node_word[node], -1)
    group = jnp.where(valid, group, -1)
    return words, group


@functools.partial(jax.jit, static_argnames=("levels",))
def group_ids(children, node_desc_signed, desc, valid, levels: int):
    """Descend only `levels` levels -> FeatureVector group-node ids [N]
    (-1 for invalid features). This is the cheap per-frame transform the
    BoW-gated tracking path needs (SearchByBoW iterates FeatureVector
    nodes, src/ORBmatcher.cc:159-288); full word ids are not required.

    With the 1-node dummy tree (no vocabulary yet) every feature lands in
    group 0, which makes the node gate a no-op — callers never branch."""
    n = desc.shape[0]
    sbits = unpack_descriptors_signed(desc)
    node = jnp.zeros(n, jnp.int32)
    nmax = node_desc_signed.shape[0]
    for _ in range(levels):
        ch = children[node]
        has = ch >= 0
        chc = jnp.clip(ch, 0, nmax - 1)
        cent = node_desc_signed[chc]
        dots = jnp.einsum("nc,nkc->nk", sbits, cent,
                          preferred_element_type=jnp.float32)
        dch = jnp.where(has, -dots, 1e9)
        best = jnp.argmin(dch, axis=1)
        nxt = jnp.take_along_axis(chc, best[:, None], axis=1)[:, 0]
        node = jnp.where(jnp.any(has, axis=1), nxt, node)
    return jnp.where(valid, node, -1)


def gate_arrays(voc: "Vocabulary | None", k: int = 10):
    """(children int32, node_desc_signed bf16) for the tracking node gate;
    a 1-node dummy tree when no vocabulary exists yet.

    children is COPIED: the gate arrays ride inside the donated
    DeviceTrackState, and aliasing the Vocabulary's own buffer there would
    delete it under the KeyFrameDatabase (the donated-buffer rule in
    CLAUDE.md / tracking._sync_ds_from_host)."""
    if voc is None:
        return (jnp.full((1, k), -1, jnp.int32),
                jnp.zeros((1, 256), jnp.bfloat16))
    return (jnp.array(voc.children, copy=True),
            unpack_descriptors_signed(voc.node_desc))


def transform(voc: Vocabulary, desc: jax.Array, valid: jax.Array):
    """descriptors -> (word ids [N], group node ids [N], dense BoW [W]).

    The group ids play the role of DBoW2's FeatureVector keys at
    levelsup (Frame::ComputeBoW, src/Frame.cc:395-402)."""
    signed = unpack_descriptors_signed(voc.node_desc)
    words, group = _transform_impl(
        voc.children, signed, voc.node_word, desc, valid,
        voc.depth, voc.k, voc.group_depth,
    )
    vec = bow_vector(voc, words)
    return words, group, vec


@jax.jit
def _bow_vector_impl(word_weight, words):
    W = word_weight.shape[0]
    ok = words >= 0
    wid = jnp.clip(words, 0, W - 1)
    v = jnp.zeros(W, jnp.float32).at[wid].add(
        jnp.where(ok, word_weight[wid], 0.0)
    )
    n = jnp.sum(jnp.abs(v))
    return v / jnp.maximum(n, 1e-9)


def bow_vector(voc: Vocabulary, words: jax.Array) -> jax.Array:
    """L1-normalized TF-IDF vector (BowVector::addWeight + normalize)."""
    return _bow_vector_impl(voc.word_weight, words)


@jax.jit
def l1_score(a: jax.Array, b: jax.Array) -> jax.Array:
    """DBoW2 L1 similarity in [0,1]: 1 - 0.5*|a-b|_1 for L1-normalized
    vectors (ScoringObject.cpp L1Scoring::score). Batched over leading
    dims of either argument."""
    return 1.0 - 0.5 * jnp.sum(jnp.abs(a - b), axis=-1)


# ---------------------------------------------------------------------------
# Sparse BoW representation + inverted-file scoring
#
# The dense [K, W] database is a matmul-friendly design for the few-
# thousand-word vocabularies this repo trains, but the reference's
# KeyFrameDatabase is an inverted file built for its ~1M-word ORBvoc
# (src/KeyFrameDatabase.cc:33-37, TemplatedVocabulary.h:241): at that W a
# dense matrix is ~4 GB per 1k keyframes. The sparse path stores, per KF,
# its <=N (word, weight) pairs sorted by word — query cost is O(Q * L) in
# the posting-list length, independent of W.
# ---------------------------------------------------------------------------


@jax.jit
def sparse_bow(word_weight: jax.Array, words: jax.Array):
    """Per-feature word ids [N] -> sorted unique (word, weight) pairs,
    L1-normalized TF-IDF, padded with word = W (sentinel past any real
    word id) and weight = 0. Matches _bow_vector_impl's dense vector
    restricted to its nonzeros."""
    N = words.shape[0]
    W = word_weight.shape[0]
    sw = jnp.sort(jnp.where(words >= 0, words, W))
    valid = sw < W
    is_first = jnp.concatenate(
        [jnp.ones(1, bool), sw[1:] != sw[:-1]]) & valid
    pos = jnp.cumsum(is_first) - 1                    # unique index
    uw = jnp.full(N + 1, W, jnp.int32).at[
        jnp.where(is_first, pos, N)].set(sw, mode="drop")[:N]
    cnt = jnp.zeros(N + 1, jnp.float32).at[
        jnp.where(valid, pos, N)].add(
        jnp.where(valid, 1.0, 0.0), mode="drop")[:N]
    w = cnt * word_weight[jnp.clip(uw, 0, W - 1)]
    w = jnp.where(uw < W, w, 0.0)
    return uw, w / jnp.maximum(jnp.sum(w), 1e-9)


def _if_scores_impl(post_word, post_kf, post_w, q_words, q_w, kmax, L):
    P = post_word.shape[0]
    starts = jnp.searchsorted(post_word, q_words, side="left")
    ends = jnp.searchsorted(post_word, q_words, side="right")
    span = starts[:, None] + jnp.arange(L)[None, :]          # [Q, L]
    ok = (span < ends[:, None]) & (q_w > 0)[:, None]
    idx = jnp.clip(span, 0, P - 1)
    kfid = jnp.clip(post_kf[idx], 0, kmax - 1)
    vw = post_w[idx]
    qw = q_w[:, None]
    # shared-word L1 term: dense l1_score == 0.5 * sum_shared of this
    contrib = jnp.where(ok, qw + vw - jnp.abs(qw - vw), 0.0)
    flat_k = kfid.reshape(-1)
    both = jnp.stack(
        [contrib.reshape(-1), ok.reshape(-1).astype(jnp.float32)], axis=-1)
    acc = jnp.zeros((kmax, 2), jnp.float32).at[flat_k].add(both)
    scores = 0.5 * acc[:, 0]
    common = acc[:, 1].astype(jnp.int32)
    # sentinel/pad query slots (weight 0) hit the DB's own pad runs —
    # they contribute nothing and must not count as dropped postings
    n_dropped = jnp.sum(
        jnp.where(q_w > 0, jnp.maximum(ends - starts - L, 0), 0))
    return scores, common, n_dropped


_if_scores_jit = jax.jit(
    _if_scores_impl, static_argnames=("kmax", "L"))


def inverted_file_query(post_word, post_kf, post_w, q_words, q_w,
                        kmax: int, L: int = 96):
    """Inverted-file query (DetectLoopCandidates'/Reloc's gathering pass,
    src/KeyFrameDatabase.cc:76-139): for each query word, walk its
    posting list (capped at L entries — n_dropped reports overflow; at
    DBoW2 vocabulary scales lists are short by construction) and
    accumulate per-KF L1 scores + shared-word counts."""
    return _if_scores_jit(post_word, post_kf, post_w, q_words, q_w,
                          kmax=kmax, L=L)


@jax.jit
def build_postings(kf_words: jax.Array, kf_w: jax.Array,
                   kf_valid: jax.Array):
    """[Kmax, N] per-KF sorted sparse vectors -> one postings array
    sorted by word (invalid KFs' entries pushed to the end as sentinel).
    One device sort of Kmax*N keys, rebuilt lazily after DB changes."""
    Kmax, N = kf_words.shape
    flat_w = jnp.where(kf_valid[:, None], kf_words, jnp.int32(2 ** 30))
    flat_w = flat_w.reshape(-1)
    order = jnp.argsort(flat_w)
    return (flat_w[order],
            jnp.repeat(jnp.arange(Kmax, dtype=jnp.int32), N)[order],
            kf_w.reshape(-1)[order])


def save_vocabulary(path: str, voc: Vocabulary):
    np.savez_compressed(
        path,
        children=np.asarray(voc.children),
        node_desc=np.asarray(voc.node_desc),
        node_word=np.asarray(voc.node_word),
        word_weight=np.asarray(voc.word_weight),
        meta=np.asarray([voc.group_depth, voc.depth, voc.k]),
    )


def load_vocabulary(path: str) -> Vocabulary:
    z = np.load(path)
    g, d, k = (int(x) for x in z["meta"])
    return Vocabulary(
        children=jnp.asarray(z["children"]),
        node_desc=jnp.asarray(z["node_desc"]),
        node_word=jnp.asarray(z["node_word"]),
        word_weight=jnp.asarray(z["word_weight"]),
        group_depth=g,
        depth=d,
        k=k,
    )


def save_orb_vocab_text(path: str, voc: Vocabulary):
    """Write the upstream ORBvoc.txt format so vocabularies trained here
    are loadable by the reference implementation (and round-trip the
    native parser). Node ids are emitted in BFS order with parent links,
    matching TemplatedVocabulary::saveToTextFile."""
    children = np.asarray(voc.children)
    node_desc = (
        np.ascontiguousarray(np.asarray(voc.node_desc))
        .view(np.uint8).reshape(-1, 32)
    )
    node_word = np.asarray(voc.node_word)
    weights = np.zeros(children.shape[0], np.float32)
    ww = np.asarray(voc.word_weight)
    weights[node_word >= 0] = ww[node_word[node_word >= 0]]
    n = children.shape[0]
    parent_of = np.zeros(n, np.int64)
    rows = np.repeat(np.arange(n), children.shape[1])
    flat = children.reshape(-1)
    ok = flat > 0
    parent_of[flat[ok]] = rows[ok]
    with open(path, "w") as f:
        f.write(f"{voc.k} {voc.depth} 0 0\n")  # k L TF_IDF L1_NORM
        # DBoW2 convention (TemplatedVocabulary::saveToTextFile): file line
        # i-1 holds node id i; the parent field is the raw node id with
        # root = 0. Our internal row ids use the same numbering, so parents
        # are written unshifted.
        for nid in range(1, n):
            is_leaf = int(node_word[nid] >= 0)
            d = " ".join(str(int(v)) for v in node_desc[nid])
            f.write(f"{parent_of[nid]} {is_leaf} {d} {weights[nid]:.6f}\n")


def _parse_orb_vocab_py(path: str):
    """Pure-Python fallback tokenizer for the ORBvoc.txt format."""
    with open(path) as f:
        header = f.readline().split()
        k, L = int(header[0]), int(header[1])
        parents, leaf_flags, descs, weights = [], [], [], []
        for line in f:
            p = line.split()
            if len(p) < 35:
                continue
            parents.append(int(p[0]))
            leaf_flags.append(int(p[1]) != 0)
            descs.append([int(v) for v in p[2:34]])
            weights.append(float(p[34]))
    return (
        k, L,
        np.asarray(parents, np.int32),
        np.asarray(leaf_flags, np.uint8),
        np.asarray(descs, np.uint8).reshape(-1, 32),
        np.asarray(weights, np.float32),
    )


def load_orb_vocab(path: str, levels_up: int = 4) -> Vocabulary:
    """Parse the upstream ORBvoc.txt format (TemplatedVocabulary::
    loadFromTextFile, header:241): first line 'k L s1 s2', then one node
    per line: 'parent is_leaf d0..d31 weight'. Uses the native C++
    tokenizer (csrc/slamio.cc) when available — the upstream file is ~1M
    lines and a Python split() loop takes minutes."""
    from orb_slam2_comment_tpu._native import slamio

    if slamio is not None:
        k, L, parents, leaf_flags, descs, weights = slamio.parse_orb_vocab(path)
    else:
        k, L, parents, leaf_flags, descs, weights = _parse_orb_vocab_py(path)

    n = len(parents) + 1  # + root
    # vectorized tree assembly: children of each parent in file order.
    # File parent ids are raw DBoW2 node ids (root = 0, line i-1 <-> id i,
    # TemplatedVocabulary::loadFromTextFile:1389), identical to our row ids.
    par = np.clip(parents, 0, None).astype(np.int64)
    order = np.argsort(par, kind="stable")
    sorted_par = par[order]
    counts = np.bincount(sorted_par, minlength=n)
    first = np.concatenate([[0], np.cumsum(counts)])[:-1]
    slot_in_parent = np.arange(len(par)) - first[sorted_par]
    children = np.full((n, k), -1, np.int64)
    children[sorted_par, slot_in_parent % k] = order + 1
    node_desc = np.zeros((n, 32), np.uint8)
    node_desc[1:] = descs
    is_leaf = np.zeros(n, bool)
    is_leaf[1:] = leaf_flags.astype(bool)
    w = np.zeros(n, np.float32)
    w[1:] = weights
    node_word = np.full(n, -1, np.int64)
    leaves = np.where(is_leaf)[0]
    node_word[leaves] = np.arange(len(leaves))
    return Vocabulary(
        children=jnp.asarray(children, jnp.int32),
        node_desc=jnp.asarray(node_desc.view(np.uint32)),
        node_word=jnp.asarray(node_word, jnp.int32),
        word_weight=jnp.asarray(w[leaves]),
        group_depth=max(L - levels_up, 1),
        depth=L,
        k=k,
    )
