"""Bag-of-binary-words: vocabulary training, transform, and scoring.

JAX replacement for saiga's ``MiniBow2::TemplatedVocabulary``
(reference: Snake/LocalMapping/Bow.h:9-17, Frame.cpp:36-42 transform,
LoopDetector.cpp:73 scoring).  The tree descent is batched: at each level
every descriptor computes Hamming distance to its current node's k children
via one matmul and takes the argmin — no per-descriptor recursion.  BoW
vectors are dense (vocabulary_size,) tf-idf arrays, so frame-against-
database scoring is a single matrix product.

The reference loads a pretrained ``ORBvoc.minibow`` asset (System.cpp:44);
that asset isn't redistributable here, so the vocabulary is trained once per
session (or offline) with hierarchical k-medians over sampled descriptors —
`train_vocabulary` — and stored as npz.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from snakeslam_tpu.ops.descriptors import hamming_matrix


class Vocabulary(NamedTuple):
    """Flattened complete k-ary tree of binary cluster centers.

    node_bits[0] is the root (unused for matching); level l occupies
    k^1 + ... + k^l slots; leaves (words) are the last k^L nodes.
    """

    node_bits: jax.Array   # (n_nodes, 256) int8 cluster centers
    k: int
    levels: int
    n_words: int
    idf: jax.Array         # (n_words,) inverse document frequency weights


def _kmedians_binary(bits: np.ndarray, k: int, rng, iters: int = 8):
    """Binary k-medians (majority-vote centers, Hamming assignment)."""
    n = len(bits)
    if n <= k:
        centers = np.zeros((k, bits.shape[1]), dtype=np.int8)
        centers[:n] = bits
        assign = np.arange(n) % k
        return centers, assign
    centers = bits[rng.choice(n, k, replace=False)].astype(np.int8)
    for _ in range(iters):
        d = (bits[:, None, :] != centers[None, :, :]).sum(axis=2)
        assign = d.argmin(axis=1)
        for c in range(k):
            sel = assign == c
            if sel.any():
                centers[c] = (bits[sel].mean(axis=0) > 0.5).astype(np.int8)
            else:
                centers[c] = bits[rng.integers(n)]
    return centers, assign


def train_vocabulary(descriptors_bits: np.ndarray, k: int = 10,
                     levels: int = 3, seed: int = 0) -> Vocabulary:
    """Hierarchical k-medians over (N, 256) {0,1} descriptors."""
    rng = np.random.default_rng(seed)
    n_nodes = sum(k**l for l in range(1, levels + 1)) + 1
    node_bits = np.zeros((n_nodes, descriptors_bits.shape[1]), dtype=np.int8)

    # BFS: node 0 = root holding all descriptors
    groups = {0: descriptors_bits}
    next_slot = 1
    level_start = [1]
    for lvl in range(levels):
        new_groups = {}
        for parent, data in sorted(groups.items()):
            centers, assign = _kmedians_binary(data, k, rng)
            for c in range(k):
                node_bits[next_slot] = centers[c]
                new_groups[next_slot] = data[assign == c]
                next_slot += 1
        groups = new_groups
        level_start.append(next_slot)

    n_words = k**levels
    # idf from the training set occupancy
    counts = np.array(
        [max(len(groups.get(next_slot - n_words + w, [])), 1)
         for w in range(n_words)],
        dtype=np.float64,
    )
    idf = np.log(len(descriptors_bits) / counts).astype(np.float32)
    idf = np.maximum(idf, 0.1)
    return Vocabulary(
        node_bits=jnp.asarray(node_bits), k=k, levels=levels,
        n_words=n_words, idf=jnp.asarray(idf),
    )


def save_vocabulary(voc: Vocabulary, path):
    np.savez_compressed(
        path, node_bits=np.asarray(voc.node_bits), k=voc.k,
        levels=voc.levels, n_words=voc.n_words, idf=np.asarray(voc.idf),
    )


def load_vocabulary(path) -> Vocabulary:
    z = np.load(path)
    node_bits_np = z["node_bits"]
    idf_np = z["idf"]
    voc = Vocabulary(
        node_bits=jnp.asarray(node_bits_np), k=int(z["k"]),
        levels=int(z["levels"]), n_words=int(z["n_words"]),
        idf=jnp.asarray(idf_np),
    )
    # pre-populate the host-side descent caches from the numpy source so
    # the first transform never round-trips the tree through the device.
    # Entries carry the device array itself as element 0: the lookups
    # verify `cached[0] is voc.node_bits`, so a recycled id() can never
    # serve a stale tree, and the strong reference pins the array alive.
    _NP_VOC_CACHE.clear()
    _NP_VOC_CACHE[id(voc.node_bits)] = (voc.node_bits, node_bits_np, idf_np)
    _PACKED_VOC_CACHE.clear()
    _PACKED_VOC_CACHE[id(voc.node_bits)] = (
        voc.node_bits,
        np.ascontiguousarray(np.packbits(
            node_bits_np.astype(np.uint8), axis=-1,
            bitorder="little")).view(np.uint64),   # (nodes, 4)
        idf_np,
    )
    return voc


_VOC_FILE_CACHE: dict = {}
_RANDOM_VOC_CACHE: dict = {}


def random_vocabulary_cached(seed: int) -> Vocabulary:
    """Fallback vocabulary trained on uniform random bits (used only when
    no vocabulary file is available); cached per seed — hierarchical
    k-medians over 30k descriptors costs seconds and tests build many
    systems.  k=10, levels=4 -> 10k words, far above the per-frame feature
    count so histograms don't saturate (the reference's ORBvoc is k=10,
    L=6, System.cpp:44)."""
    voc = _RANDOM_VOC_CACHE.get(seed)
    if voc is None:
        rng = np.random.default_rng(seed + 1)
        train = rng.integers(0, 2, size=(30000, 256)).astype(np.int8)
        voc = train_vocabulary(train, k=10, levels=4, seed=seed)
        _RANDOM_VOC_CACHE.clear()
        _RANDOM_VOC_CACHE[seed] = voc
    return voc


def load_vocabulary_cached(path) -> Vocabulary:
    """Process-wide vocabulary cache: repeated SlamSystem constructions
    (benchmarks, tests) share one loaded tree instead of re-uploading
    ~3 MB per system."""
    import os

    key = (str(path), os.path.getmtime(path))
    voc = _VOC_FILE_CACHE.get(key)
    if voc is None:
        voc = load_vocabulary(path)
        _VOC_FILE_CACHE.clear()
        _VOC_FILE_CACHE[key] = voc
    return voc


@functools.partial(jax.jit, static_argnames=("k", "levels"))
def _transform(node_bits, idf, desc_bits, valid, k: int, levels: int):
    N = desc_bits.shape[0]
    node = jnp.zeros((N,), dtype=jnp.int32)  # parent within previous level
    level_offset = 1
    for lvl in range(levels):
        # children of node n at this level occupy
        # level_offset + n * k ... + k
        child_base = level_offset + node * k
        # distances to each child: gather child bits then Hamming
        child_idx = child_base[:, None] + jnp.arange(k)[None, :]
        child_bits = node_bits[child_idx]          # (N, k, 256)
        d = jnp.einsum(
            "nb,nkb->nk",
            desc_bits.astype(jnp.bfloat16),
            child_bits.astype(jnp.bfloat16),
            preferred_element_type=jnp.float32,
        )
        wa = jnp.sum(desc_bits.astype(jnp.float32), axis=1)
        wb = jnp.sum(child_bits.astype(jnp.float32), axis=2)
        ham = wa[:, None] + wb - 2.0 * d
        best = jnp.argmin(ham, axis=1).astype(jnp.int32)
        # child slot relative to level start
        rel = (node * k + best)
        node = rel
        level_offset = level_offset + k ** (lvl + 1)
    words = node  # (N,) in [0, k^levels)
    n_words = k**levels
    tf = jax.ops.segment_sum(
        jnp.where(valid, 1.0, 0.0), jnp.where(valid, words, n_words),
        num_segments=n_words + 1,
    )[:n_words]
    v = tf * idf
    norm = jnp.sum(jnp.abs(v))
    v = v / jnp.maximum(norm, 1e-9)
    return words, v


def transform(voc: Vocabulary, desc_bits: jax.Array, valid: jax.Array):
    """Descriptors -> (word ids (N,), dense L1-normalized BoW vector (W,))."""
    return _transform(voc.node_bits, voc.idf, desc_bits, valid,
                      voc.k, voc.levels)


def transform_np(voc: Vocabulary, desc_bits: np.ndarray,
                 valid: np.ndarray | None = None):
    """Host-side vocabulary transform (same descent as ``transform``).

    The tree descent over ~1k descriptors is ~2 MFLOP — tiny next to a
    blocking device call, so the per-keyframe BoW vector is computed on
    host.  Numpy copies of the tree are cached keyed by the
    node array object itself (a strong reference pins it, so its id can
    never be recycled onto a different vocabulary's array)."""
    cached = _NP_VOC_CACHE.get(id(voc.node_bits))
    if cached is None or cached[0] is not voc.node_bits:
        cached = (voc.node_bits,
                  np.asarray(voc.node_bits), np.asarray(voc.idf))
        _NP_VOC_CACHE.clear()
        _NP_VOC_CACHE[id(voc.node_bits)] = cached
    _, node_bits, idf = cached
    k, levels = voc.k, voc.levels
    db = np.asarray(desc_bits, dtype=np.float32)            # (N, 256)
    N = db.shape[0]
    wa = db.sum(axis=1)
    node = np.zeros(N, dtype=np.int64)
    level_offset = 1
    for lvl in range(levels):
        child_idx = (level_offset + node * k)[:, None] + np.arange(k)[None]
        child_bits = node_bits[child_idx].astype(np.float32)  # (N, k, 256)
        d = np.einsum("nb,nkb->nk", db, child_bits)
        ham = wa[:, None] + child_bits.sum(axis=2) - 2.0 * d
        best = ham.argmin(axis=1)
        node = node * k + best
        level_offset += k ** (lvl + 1)
    words = node.astype(np.int32)
    n_words = k ** levels
    if valid is None:
        valid = np.ones(N, dtype=bool)
    tf = np.bincount(words[valid], minlength=n_words).astype(np.float64)
    v = tf * idf
    norm = np.abs(v).sum()
    return words, v / max(norm, 1e-9)


_NP_VOC_CACHE: dict = {}
_PACKED_VOC_CACHE: dict = {}


def transform_packed_np(voc: Vocabulary, desc_packed: np.ndarray,
                        valid: np.ndarray | None = None):
    """Host-side descent on PACKED (n, 32) uint8 descriptors.

    XOR + hardware popcount (np.bitwise_count on uint64 lanes) beats the
    float einsum descent on host by >20x (32 word ops per comparison
    instead of 256 f32 lanes), which matters because the per-keyframe BoW
    vector sits on the back-end critical path.  Same tree, same result as
    ``transform_np``."""
    cached = _PACKED_VOC_CACHE.get(id(voc.node_bits))
    if cached is None or cached[0] is not voc.node_bits:
        node_bits = np.asarray(voc.node_bits)
        packed = np.packbits(node_bits.astype(np.uint8), axis=-1,
                             bitorder="little")
        cached = (
            voc.node_bits,
            np.ascontiguousarray(packed).view(np.uint64),   # (nodes, 4)
            np.asarray(voc.idf),
        )
        _PACKED_VOC_CACHE.clear()
        _PACKED_VOC_CACHE[id(voc.node_bits)] = cached
    _, node_packed, idf = cached
    k, levels = voc.k, voc.levels
    db = np.ascontiguousarray(desc_packed, dtype=np.uint8).view(np.uint64)
    N = db.shape[0]                                          # db: (N, 4)
    node = np.zeros(N, dtype=np.int64)
    level_offset = 1
    for lvl in range(levels):
        child_idx = (level_offset + node * k)[:, None] + np.arange(k)[None]
        child = node_packed[child_idx]                       # (N, k, 4)
        ham = np.bitwise_count(np.bitwise_xor(child, db[:, None, :])).sum(
            axis=-1, dtype=np.int32)
        node = node * k + ham.argmin(axis=1)
        level_offset += k ** (lvl + 1)
    words = node.astype(np.int32)
    n_words = k ** levels
    if valid is None:
        valid = np.ones(N, dtype=bool)
    tf = np.bincount(words[valid], minlength=n_words).astype(np.float64)
    v = tf * idf
    norm = np.abs(v).sum()
    return words, v / max(norm, 1e-9)


def score_l1(v1: jax.Array, v2: jax.Array) -> jax.Array:
    """DBoW2 L1 similarity: 1 - 0.5 * |v1 - v2|_1 (vectors L1-normalized).

    Works batched: v2 may be (K, W) -> returns (K,)."""
    diff = jnp.sum(jnp.abs(v1[None] - v2) if v2.ndim == 2
                   else jnp.abs(v1 - v2), axis=-1)
    return 1.0 - 0.5 * diff
