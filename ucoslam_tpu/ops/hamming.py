"""Batched Hamming-distance matching for 256-bit binary descriptors.

This replaces three reference subsystems at once (SURVEY.md §2):
- xflann approximate-NN search (3rdparty/xflann/xflann/index.h:41)
- FrameMatcher descriptor loops (src/utils/framematcher.cpp:31-608)
- MapPoint::getDescDistance 64-bit XOR+popcount helpers (mappoint.h:138-177)

At device batch sizes a brute-force distance matrix beats any tree index. Two
interchangeable paths:

1. `hamming_matrix`   — XOR + `lax.population_count` on uint32 words.
2. `hamming_matrix_mxu` — descriptors unpacked to ±1 bf16 and fed to a matmul:
   for a, b in {-1,+1}^256, popcount(a XOR b) = (256 - <a, b>) / 2, so one
   (N,256)x(256,M) matmul computes the whole distance matrix at matmul speed.

Descriptors are stored packed as uint32[8] (256 bits).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

DESC_WORDS = 8  # 8 x uint32 = 256 bits
DESC_BITS = 256
INVALID_DIST = 10_000  # sentinel larger than any Hamming distance


def hamming_matrix(desc_a: jnp.ndarray, desc_b: jnp.ndarray) -> jnp.ndarray:
    """Full Hamming distance matrix via popcount.

    desc_a: (N, 8) uint32, desc_b: (M, 8) uint32 -> (N, M) int32.
    """
    x = jnp.bitwise_xor(desc_a[:, None, :], desc_b[None, :, :])
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)


def unpack_descriptor_bits(desc: jnp.ndarray, dtype=jnp.bfloat16) -> jnp.ndarray:
    """(N, 8) uint32 -> (N, 256) in {-1, +1} of `dtype` (bit 0 of word 0 first)."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (desc[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    bits = bits.reshape(desc.shape[0], DESC_BITS)
    return (bits.astype(jnp.float32) * 2.0 - 1.0).astype(dtype)


def hamming_matrix_mxu(desc_a: jnp.ndarray, desc_b: jnp.ndarray) -> jnp.ndarray:
    """Hamming distance matrix as a matmul via the ±1 bit-matmul identity.

    Exact for 256-bit descriptors: the dot product of ±1 vectors is an even
    integer in [-256, 256], well inside bf16's exact-integer range (|x|<=2^8
    with even parity), so no precision is lost.
    """
    a = unpack_descriptor_bits(desc_a)
    b = unpack_descriptor_bits(desc_b)
    dot = jnp.dot(a, b.T, preferred_element_type=jnp.float32)
    return ((DESC_BITS - dot) * 0.5).astype(jnp.int32)


def match_best2(
    dist: jnp.ndarray,
    valid_rows: jnp.ndarray | None = None,
    valid_cols: jnp.ndarray | None = None,
    extra_mask: jnp.ndarray | None = None,
):
    """Best and second-best match per row of a distance matrix.

    dist: (N, M) int32. valid_rows (N,), valid_cols (M,), extra_mask (N, M)
    are optional booleans; masked entries become INVALID_DIST.

    Returns (best_idx (N,), best_dist (N,), second_dist (N,)) where
    second_dist is the runner-up *at a different column* (for Lowe's ratio
    test as in FrameMatcher, framematcher.cpp:239-260).
    """
    d = dist
    if valid_cols is not None:
        d = jnp.where(valid_cols[None, :], d, INVALID_DIST)
    if extra_mask is not None:
        d = jnp.where(extra_mask, d, INVALID_DIST)
    best_idx = jnp.argmin(d, axis=1)
    best_dist = jnp.take_along_axis(d, best_idx[:, None], axis=1)[:, 0]
    d2 = jnp.where(
        jnp.arange(d.shape[1])[None, :] == best_idx[:, None], INVALID_DIST, d
    )
    second_dist = jnp.min(d2, axis=1)
    if valid_rows is not None:
        best_dist = jnp.where(valid_rows, best_dist, INVALID_DIST)
        second_dist = jnp.where(valid_rows, second_dist, INVALID_DIST)
    return best_idx, best_dist, second_dist


def mutual_best(dist: jnp.ndarray) -> jnp.ndarray:
    """(N, M) -> (N,) col index of mutual nearest neighbours, -1 otherwise."""
    fwd = jnp.argmin(dist, axis=1)
    bwd = jnp.argmin(dist, axis=0)
    mutual = bwd[fwd] == jnp.arange(dist.shape[0])
    return jnp.where(mutual, fwd, -1)


def filter_ambiguous_train_sized(
    best_idx: jnp.ndarray, best_dist: jnp.ndarray, num_cols: int
) -> jnp.ndarray:
    """Keep, per train column, only the query with the smallest distance.

    Counterpart of the reference `filter_ambiguous_query/train`
    (misc.h:35-37): no two rows may claim the same column. Returns a bool
    keep-mask over rows; `num_cols` is static at trace time.
    """
    col_min = jnp.full((num_cols,), INVALID_DIST, jnp.int32).at[best_idx].min(
        best_dist.astype(jnp.int32)
    )
    is_min = best_dist.astype(jnp.int32) == col_min[best_idx]
    # Tie-break: among equal minima keep the lowest row index.
    n = best_idx.shape[0]
    rows = jnp.arange(n, dtype=jnp.int32)
    row_of_min = jnp.full((num_cols,), n, jnp.int32).at[best_idx].min(
        jnp.where(is_min, rows, n)
    )
    return is_min & (row_of_min[best_idx] == rows)
