"""Frame-to-frame descriptor matching with ratio / orientation / epipolar gates.

Counterpart of the reference FrameMatcher (framematcher.{h:31-46,cpp:31-608}):
modes ALL/ASSIGNED/UNASSIGNED, Lowe ratio test, rotation-consistency
histogram (computeThreeMaxima :56), octave gate, and the epipolar variant
gated by chi2(1) = 3.84 sigma^2 (matchEpipolar :261,456). The xflann HKMeans
index and fBow2-aligned iteration both collapse into one dense Hamming
matrix — brute force is the fast path at device batch sizes.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ucoslam_tpu.config import CHI2_1D
from ucoslam_tpu.geometry.epipolar import epipolar_line_sq_dist
from ucoslam_tpu.mapping.frame import Frame
from ucoslam_tpu.ops.hamming import (
    INVALID_DIST,
    filter_ambiguous_train_sized,
    hamming_matrix,
    match_best2,
)

N_ROT_BINS = 30  # orientation consistency histogram bins (as ORB-SLAM)


class FrameMatches(NamedTuple):
    train_idx: jnp.ndarray  # (N1,) int32 match in frame2 per frame1 kpt, -1 none
    dist: jnp.ndarray  # (N1,) int32 descriptor distance
    valid: jnp.ndarray  # (N1,) bool
    n_matches: jnp.ndarray  # () int32


def _rotation_consistency(angle1, angle2, train_idx, valid):
    """Keep only matches whose angle difference falls in the 3 dominant
    histogram bins (FrameMatcher::computeThreeMaxima, framematcher.cpp:56)."""
    diff = angle1 - angle2[train_idx]
    two_pi = 2.0 * jnp.pi
    diff = jnp.mod(diff, two_pi)
    bins = jnp.clip((diff / two_pi * N_ROT_BINS).astype(jnp.int32), 0, N_ROT_BINS - 1)
    hist = jnp.zeros((N_ROT_BINS,), jnp.int32).at[jnp.where(valid, bins, 0)].add(
        valid.astype(jnp.int32)
    )
    top3 = jax.lax.top_k(hist, 3)[1]
    in_top = (bins[:, None] == top3[None, :]).any(-1)
    return valid & in_top


from functools import partial


@partial(
    jax.jit,
    static_argnames=(
        "only_unassigned_1",
        "only_unassigned_2",
        "check_rotation",
        "max_octave_diff",
    ),
)
def match_frames(
    f1: Frame,
    f2: Frame,
    max_desc_dist: jnp.ndarray,
    nn_ratio: jnp.ndarray = 0.8,
    only_unassigned_1: bool = False,
    only_unassigned_2: bool = False,
    check_rotation: bool = True,
    max_octave_diff: int = 2,
) -> FrameMatches:
    """MODE_ALL / MODE_UNASSIGNED matching (framematcher.h:35)."""
    d = hamming_matrix(f1.desc, f2.desc)
    v1 = f1.valid
    v2 = f2.valid
    if only_unassigned_1:
        v1 = v1 & (f1.ids < 0)
    if only_unassigned_2:
        v2 = v2 & (f2.ids < 0)
    oct_ok = jnp.abs(f1.octave[:, None] - f2.octave[None, :]) <= max_octave_diff
    idx, best, second = match_best2(d, valid_rows=v1, valid_cols=v2, extra_mask=oct_ok)
    accept = (
        (best <= max_desc_dist)
        & (best.astype(jnp.float32) < nn_ratio * second.astype(jnp.float32))
        & v1
    )
    if check_rotation:
        accept = _rotation_consistency(f1.angle, f2.angle, idx, accept)
    keep = filter_ambiguous_train_sized(idx, jnp.where(accept, best, INVALID_DIST), f2.n)
    accept = accept & keep
    return FrameMatches(
        train_idx=jnp.where(accept, idx, -1),
        dist=best,
        valid=accept,
        n_matches=jnp.sum(accept),
    )


@partial(jax.jit, static_argnames=("only_unassigned",))
def match_frames_epipolar(
    f1: Frame,
    f2: Frame,
    F12: jnp.ndarray,  # (3, 3) fundamental matrix, x2^T F12 x1 = 0
    sigma2_2: jnp.ndarray,  # (N2,) per-kpt variance in frame2
    max_desc_dist: jnp.ndarray,
    nn_ratio: jnp.ndarray = 0.8,
    only_unassigned: bool = True,
) -> FrameMatches:
    """Epipolar-gated matching for triangulating new points
    (FrameMatcher::matchEpipolar, framematcher.cpp:228,261)."""
    d = hamming_matrix(f1.desc, f2.desc)
    v1 = f1.valid
    v2 = f2.valid
    if only_unassigned:
        v1 = v1 & (f1.ids < 0)
        v2 = v2 & (f2.ids < 0)
    epi = epipolar_line_sq_dist(F12, f1.und_xy, f2.und_xy)  # (N1, N2)
    epi_ok = epi < CHI2_1D * sigma2_2[None, :]
    idx, best, second = match_best2(d, valid_rows=v1, valid_cols=v2, extra_mask=epi_ok)
    accept = (
        (best <= max_desc_dist)
        & (best.astype(jnp.float32) < nn_ratio * second.astype(jnp.float32))
        & v1
    )
    accept = _rotation_consistency(f1.angle, f2.angle, idx, accept)
    keep = filter_ambiguous_train_sized(idx, jnp.where(accept, best, INVALID_DIST), f2.n)
    accept = accept & keep
    return FrameMatches(
        train_idx=jnp.where(accept, idx, -1),
        dist=best,
        valid=accept,
        n_matches=jnp.sum(accept),
    )


@partial(jax.jit, static_argnames=("check_rotation",))
def match_frames_bow(
    f1: Frame,
    f2: Frame,
    vocab: jnp.ndarray,
    max_desc_dist: jnp.ndarray,
    nn_ratio: jnp.ndarray = 0.8,
    check_rotation: bool = True,
) -> FrameMatches:
    """Word-aligned matching (counterpart FrameMatcher_BoW,
    framematcher.cpp:362-456): only descriptor pairs quantized to the SAME
    vocabulary word are considered — the fBow2 node-aligned iteration
    (fbow.h:91-93) expressed as an equality mask over quantized word ids
    (mapping.kfdatabase.quantize_words). Tightens candidate matching at
    reloc/loop scale where unrestricted Hamming admits aliases.
    """
    from ucoslam_tpu.mapping.kfdatabase import quantize_words

    w1 = quantize_words(f1.desc, vocab)
    w2 = quantize_words(f2.desc, vocab)
    d = hamming_matrix(f1.desc, f2.desc)
    word_ok = w1[:, None] == w2[None, :]
    idx, best, second = match_best2(
        d, valid_rows=f1.valid, valid_cols=f2.valid, extra_mask=word_ok
    )
    accept = (
        (best <= max_desc_dist)
        & (best.astype(jnp.float32) < nn_ratio * second.astype(jnp.float32))
        & f1.valid
    )
    if check_rotation:
        accept = _rotation_consistency(f1.angle, f2.angle, idx, accept)
    keep = filter_ambiguous_train_sized(idx, jnp.where(accept, best, INVALID_DIST), f2.n)
    accept = accept & keep
    return FrameMatches(
        train_idx=jnp.where(accept, idx, -1),
        dist=best,
        valid=accept,
        n_matches=jnp.sum(accept),
    )
