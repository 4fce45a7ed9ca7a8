"""ORB descriptor bit manipulation + Hamming distance as a matrix product.

JAX replacement for saiga's Hamming ``distance()`` / popcount loops
(reference: Snake/Tracking/SnakeORBMatcher.cpp:492 and the
``BruteForceMatcher<DescriptorORB>`` at Snake/Tracking/TrackingCoarse.cpp:350).

Design: descriptors are stored packed as (N, 32) uint8 (256 bits) on the
host, and unpacked to (N, 256) {0,1} planes on device.  The full pairwise
Hamming matrix is then one matmul:

    popcount(a ^ b) = sum(a) + sum(b) - 2 * dot(a, b)   for bits in {0,1}

which maps the entire matching workload onto the 128x128 systolic array
instead of scalar popcounts.  With bf16 inputs and f32 accumulation the dot
products (<= 256) are exact.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

DESC_BITS = 256
DESC_BYTES = 32


def unpack_bits_np(packed: np.ndarray) -> np.ndarray:
    """(N, 32) uint8 -> (N, 256) uint8 in {0,1} (host-side)."""
    return np.unpackbits(packed.astype(np.uint8), axis=-1, bitorder="little")


def pack_bits_np(bits: np.ndarray) -> np.ndarray:
    """(N, 256) {0,1} -> (N, 32) uint8 (host-side)."""
    return np.packbits(bits.astype(np.uint8), axis=-1, bitorder="little")


def unpack_bits(packed: jax.Array) -> jax.Array:
    """(..., 32) uint8 -> (..., 256) uint8 in {0,1} (device-side)."""
    shifts = jnp.arange(8, dtype=jnp.uint8)
    bits = (packed[..., :, None] >> shifts) & jnp.uint8(1)
    return bits.reshape(packed.shape[:-1] + (DESC_BITS,))


def hamming_matrix(bits_a: jax.Array, bits_b: jax.Array) -> jax.Array:
    """Pairwise Hamming distances via a bf16 matmul.

    Args:
      bits_a: (N, 256) bit planes in {0,1} (any integer/float dtype).
      bits_b: (M, 256).
    Returns:
      (N, M) int32 Hamming distances in [0, 256].
    """
    a = bits_a.astype(jnp.bfloat16)
    b = bits_b.astype(jnp.bfloat16)
    dot = jax.lax.dot_general(
        a,
        b,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    wa = jnp.sum(a.astype(jnp.float32), axis=-1)
    wb = jnp.sum(b.astype(jnp.float32), axis=-1)
    return (wa[:, None] + wb[None, :] - 2.0 * dot).astype(jnp.int32)


def hamming_distance(bits_a: jax.Array, bits_b: jax.Array) -> jax.Array:
    """Elementwise Hamming distance between aligned (..., 256) bit planes."""
    diff = jnp.not_equal(bits_a, bits_b)
    return jnp.sum(diff.astype(jnp.int32), axis=-1)


def hamming_np(a_packed: np.ndarray, b_packed: np.ndarray) -> np.ndarray:
    """Host oracle: pairwise Hamming on packed (N,32)/(M,32) uint8."""
    a = unpack_bits_np(a_packed)
    b = unpack_bits_np(b_packed)
    return (a[:, None, :] != b[None, :, :]).sum(axis=-1)
