"""Batched ORB keypoint extraction (FAST + IC-angle + rotated BRIEF).

Counterpart of the reference ORBextractor (src/featureextractors/
ORBextractor.{h:85,cpp:1139-1395}): image pyramid, per-level FAST with
spatially-distributed selection (quadtree DistributeOctTree :583 becomes a
per-cell top-k), intensity-centroid orientation, Gaussian blur, 256-bit
descriptors. The reference's level-parallel thread pool
(assignLevelsToThreads :1080) disappears: every level is one fused XLA
program and all keypoints across levels are processed as one batch.

Descriptor pattern: a fixed seeded-Gaussian BRIEF pattern (sigma = patch/5,
the original BRIEF recipe) rather than OpenCV's learned table — descriptors
are NOT bit-compatible with OpenCV ORB, which is fine: the engine only ever
compares its own descriptors (SURVEY.md §7 'behavioral, not bitwise').

Hot-path design: per-pixel gathers are the enemy, so orientation + blur +
descriptor sampling all run
from ONE 37x37 patch per keypoint, read with row-block dynamic slices:
  patch -> IC moments as a (N, 961) @ (961, 2) matmul -> angle
        -> in-patch separable Gaussian blur (shifted adds)
        -> rotated-BRIEF sampling as a one-hot matmul against one of 64
           precomputed rotation tables (angle quantized to 5.6 deg — below
           the nearest-pixel rounding noise of the pattern itself).
The descriptor stage is pure matmul work; the only gathers left are the N
patch reads.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ucoslam_tpu.ops.fast import fast_score_map, nms3x3, topk_grid
from ucoslam_tpu.ops.image import (
    build_pyramid,
    extract_patches,
    gaussian_kernel1d,
)

PATCH_RADIUS = 15
EDGE_MARGIN = 19  # keypoints closer than this to a level border are dropped
N_PAIRS = 256


PATTERN_RADIUS = 13  # max pattern norm: rotated samples stay inside the patch
DESC_BINS = 32  # rotation tables (11.25 deg quantization; rBRIEF is
# trained/stable to ~12 deg — the reference's rotated pattern uses the
# same granularity class — and halving the bins halves the descriptor
# matmul FLOPs, the single largest extract stage)


def _brief_pattern(seed: int = 42) -> np.ndarray:
    """(256, 2, 2) sampling-pair offsets, Gaussian sigma = patch/5, norms
    clipped to PATTERN_RADIUS so any rotation stays inside the 31x31 patch."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, PATCH_RADIUS / 5.0 * 2.0, size=(N_PAIRS, 2, 2))
    norm = np.linalg.norm(pts, axis=-1, keepdims=True).clip(1e-9)
    pts = pts * np.minimum(1.0, PATTERN_RADIUS / norm)
    return np.round(pts).astype(np.float32)


BRIEF_PATTERN = _brief_pattern()


def _rotation_tables() -> np.ndarray:
    """(DESC_BINS, P*P, 512) one-hot sampling tables: table[b] maps a
    flattened (2*PATCH_RADIUS+1)^2 patch to the 512 pattern samples rotated
    by 2*pi*b/DESC_BINS, nearest-pixel (cvRound-style, like OpenCV ORB)."""
    P = 2 * PATCH_RADIUS + 1
    flat = BRIEF_PATTERN.reshape(-1, 2)  # (512, 2) sample order: pair-major
    tables = np.zeros((DESC_BINS, P * P, 2 * N_PAIRS), np.float32)
    for b in range(DESC_BINS):
        a = 2.0 * np.pi * b / DESC_BINS
        ca, sa = np.cos(a), np.sin(a)
        rx = np.clip(np.round(ca * flat[:, 0] - sa * flat[:, 1]).astype(int)
                     + PATCH_RADIUS, 0, P - 1)
        ry = np.clip(np.round(sa * flat[:, 0] + ca * flat[:, 1]).astype(int)
                     + PATCH_RADIUS, 0, P - 1)
        tables[b, ry * P + rx, np.arange(2 * N_PAIRS)] = 1.0
    return tables


ROTATION_TABLES = _rotation_tables()


def _moment_kernel() -> np.ndarray:
    """(P*P, 2) disc-masked (x, y) weights for IC moments."""
    r = PATCH_RADIUS
    ys, xs = np.mgrid[-r: r + 1, -r: r + 1]
    disc = ((xs * xs + ys * ys) <= r * r).astype(np.float32)
    return np.stack([(xs * disc).reshape(-1), (ys * disc).reshape(-1)], -1)


MOMENT_KERNEL = _moment_kernel()
BLUR_K = 7  # in-patch Gaussian (matches the reference's GaussianBlur(7,7,2))
BLUR_SIGMA = 2.0


class Keypoints(NamedTuple):
    """Fixed-capacity SoA keypoint batch for one frame (level-0 pixel coords)."""

    xy: jnp.ndarray  # (N, 2) float32, raw (distorted) level-0 coords
    response: jnp.ndarray  # (N,) float32 FAST score
    octave: jnp.ndarray  # (N,) int32
    angle: jnp.ndarray  # (N,) float32 radians
    desc: jnp.ndarray  # (N, 8) uint32 packed 256-bit
    valid: jnp.ndarray  # (N,) bool

    @property
    def n(self) -> int:
        return self.xy.shape[0]


def _level_budgets(total: int, n_levels: int, scale_factor: float) -> list[int]:
    """Features per level proportional to level area (geometric decay)."""
    inv = 1.0 / scale_factor
    weights = np.array([inv ** (2 * lv) for lv in range(n_levels)])
    raw = weights / weights.sum() * total
    budgets = [max(8, int(round(r))) for r in raw]
    budgets[0] += total - sum(budgets)
    return budgets


class ORBExtractor:
    """Stateless jitted extractor; configuration fixed at construction.

    Counterpart of Feature2DSerializable::create(DESC_ORB)
    (feature2dserializable.h:66) + ORBextractor.
    """

    def __init__(
        self,
        max_features: int = 2048,
        n_levels: int = 8,
        scale_factor: float = 1.2,
        fast_threshold: float = 7.0,
        cell: int = 32,
        k_per_cell: int = 4,
        descriptor: str = "orb",
    ):
        self.max_features = max_features
        self.n_levels = n_levels
        self.scale_factor = scale_factor
        self.fast_threshold = fast_threshold
        self.cell = cell
        self.k_per_cell = k_per_cell
        self.budgets = _level_budgets(max_features, n_levels, scale_factor)
        self.scales = [scale_factor ** lv for lv in range(n_levels)]
        self._jit_cache = {}
        # descriptor family: "orb" (rBRIEF), "freak" (retina pairs), "surf"
        # (Haar 64-d + LSH binarization) — all share FAST detection and the
        # 256-bit packed format (features/descriptors.py)
        if descriptor not in ("orb", "freak", "surf"):
            raise ValueError(f"unknown descriptor family {descriptor!r}")
        self.descriptor = descriptor

    # -- public API -----------------------------------------------------
    def detect_and_compute(self, img: jnp.ndarray) -> Keypoints:
        """img: (H, W) float32 grayscale -> Keypoints with n = max_features."""
        key = img.shape
        if key not in self._jit_cache:
            self._jit_cache[key] = jax.jit(self._detect_and_compute)
        # threshold passed as a traced value: sensitivity adaptation
        # (setSensitivity) must not trigger recompilation
        return self._jit_cache[key](img, jnp.float32(self.fast_threshold))

    def sigma2(self, octave: jnp.ndarray) -> jnp.ndarray:
        """Per-keypoint measurement variance scale^2(octave) (ref frame.h:129)."""
        log_s = jnp.log(jnp.float32(self.scale_factor))
        return jnp.exp(2.0 * octave.astype(jnp.float32) * log_s)

    # -- implementation -------------------------------------------------
    def _detect_level(self, level_img: jnp.ndarray, budget: int, threshold):
        score = fast_score_map(level_img, threshold)
        score = nms3x3(score)
        h, w = level_img.shape
        ys = jnp.arange(h)[:, None]
        xs = jnp.arange(w)[None, :]
        interior = (
            (ys >= EDGE_MARGIN)
            & (ys < h - EDGE_MARGIN)
            & (xs >= EDGE_MARGIN)
            & (xs < w - EDGE_MARGIN)
        )
        score = jnp.where(interior, score, 0.0)
        xy, resp, valid = topk_grid(score, self.cell, self.k_per_cell, budget)
        return xy, resp, valid

    def _extract_support_patches(self, level_img: jnp.ndarray, xy: jnp.ndarray):
        """(N, 37, 37) raw patches: descriptor patch + blur support ring."""
        support = PATCH_RADIUS + BLUR_K // 2  # 18: blur support around patch
        need = 2 * support + 1
        h, w = level_img.shape
        if h < need or w < need:
            # levels smaller than one patch yield no valid keypoints
            # (EDGE_MARGIN) — pad so the slice shape stays legal
            level_img = jnp.pad(
                level_img, ((0, max(0, need - h)), (0, max(0, need - w)))
            )
        return extract_patches(level_img, xy, support)

    def _orient_and_describe(self, patches: jnp.ndarray):
        """Patch batch (all levels concatenated) -> IC angles + descriptors.

        All sampling is matmul work on the patch batch (see module
        docstring); the Gaussian blur the reference applies to the whole
        level before describing runs inside the patch instead. Batching all
        levels into one call amortizes the fixed einsum cost 8x.

        The descriptor family is selected at construction: rBRIEF (ORB),
        FREAK retina pairs, or SURF-LSH — all produce the packed 256-bit
        format consumed by ops/hamming.py.
        """
        P = 2 * PATCH_RADIUS + 1
        b = BLUR_K // 2

        # IC moments from the raw center patch (the reference computes the
        # angle on the unblurred level image)
        raw = patches[:, b:b + P, b:b + P].reshape(-1, P * P)
        mom = raw @ jnp.asarray(MOMENT_KERNEL)  # (N, 2)
        ang = jnp.arctan2(mom[:, 1], mom[:, 0])

        bidx = jnp.round(ang / (2.0 * jnp.pi) * DESC_BINS).astype(jnp.int32) % DESC_BINS
        onehot = jax.nn.one_hot(bidx, DESC_BINS, dtype=jnp.bfloat16)  # (N, B)

        if self.descriptor == "orb":
            # separable 7x7 blur, valid region = the 31x31 center
            k = gaussian_kernel1d(BLUR_K, BLUR_SIGMA)
            tmp = sum(float(k[i]) * patches[:, i:i + P, :] for i in range(BLUR_K))
            blur = sum(float(k[i]) * tmp[:, :, i:i + P] for i in range(BLUR_K))
            # rotated sampling: one-hot matmul against the angle's table
            tables = jnp.asarray(ROTATION_TABLES, jnp.bfloat16)  # (B, P*P, 512)
            samp = jnp.einsum(
                "np,bps,nb->ns", blur.reshape(-1, P * P).astype(jnp.bfloat16),
                tables, onehot,
            )  # (N, 512) pair-major: even = endpoint 0, odd = endpoint 1
            bits = (samp[:, 0::2] < samp[:, 1::2]).astype(jnp.uint32)  # (N, 256)
        elif self.descriptor == "freak":
            from ucoslam_tpu.features.descriptors import FREAK_PAIRS, freak_tables

            tables = jnp.asarray(freak_tables(), jnp.bfloat16)  # (B, P*P, 43)
            samp = jnp.einsum(
                "np,bps,nb->ns", raw.astype(jnp.bfloat16), tables, onehot
            )  # (N, 43) smoothed retina samples (Gaussians live in the table)
            pa = jnp.asarray(FREAK_PAIRS[:, 0])
            pb = jnp.asarray(FREAK_PAIRS[:, 1])
            bits = (samp[:, pa] < samp[:, pb]).astype(jnp.uint32)
        else:  # surf
            from ucoslam_tpu.features.descriptors import (
                surf_lsh_projection,
                surf_tables,
            )

            # central-difference gradients on the raw support patch
            # (SURF's Haar responses), valid over the 31x31 center
            gx = (patches[:, b:b + P, b + 1:b + 1 + P]
                  - patches[:, b:b + P, b - 1:b - 1 + P]) * 0.5
            gy = (patches[:, b + 1:b + 1 + P, b:b + P]
                  - patches[:, b - 1:b - 1 + P, b:b + P]) * 0.5
            # rotate gradients into the canonical keypoint frame using the
            # quantized angle (consistent with the subregion tables)
            a_q = 2.0 * jnp.pi * bidx.astype(jnp.float32) / DESC_BINS
            ca = jnp.cos(a_q)[:, None]
            sa = jnp.sin(a_q)[:, None]
            gxf = gx.reshape(-1, P * P)
            gyf = gy.reshape(-1, P * P)
            gxr = ca * gxf + sa * gyf
            gyr = -sa * gxf + ca * gyf
            tables = jnp.asarray(surf_tables(), jnp.bfloat16)  # (B, P*P, 16)
            pool = lambda m: jnp.einsum(  # noqa: E731
                "np,bps,nb->ns", m.astype(jnp.bfloat16), tables, onehot
            )
            feats = jnp.concatenate(
                [pool(gxr), pool(jnp.abs(gxr)), pool(gyr), pool(jnp.abs(gyr))],
                axis=-1,
            ).astype(jnp.float32)  # (N, 64)
            feats = feats / jnp.linalg.norm(feats, axis=-1, keepdims=True).clip(1e-6)
            proj = jnp.asarray(surf_lsh_projection())  # (64, 256)
            bits = (feats @ proj > 0.0).astype(jnp.uint32)
        shifts = jnp.arange(32, dtype=jnp.uint32)
        words = bits.reshape(-1, 8, 32) << shifts[None, None, :]
        return ang, jnp.sum(words, axis=-1, dtype=jnp.uint32)  # (N,), (N, 8)

    def _detect_and_compute(self, img: jnp.ndarray, threshold=7.0) -> Keypoints:
        levels = build_pyramid(img, self.n_levels, self.scale_factor)
        all_xy, all_resp, all_oct, all_valid, all_patches = [], [], [], [], []
        for lv, level_img in enumerate(levels):
            budget = self.budgets[lv]
            xy, resp, valid = self._detect_level(level_img, budget, threshold)
            all_patches.append(self._extract_support_patches(level_img, xy))
            all_xy.append(xy * self.scales[lv])
            all_resp.append(resp)
            all_oct.append(jnp.full((budget,), lv, jnp.int32))
            all_valid.append(valid)
        # orientation + descriptors for ALL levels' keypoints in one batch
        ang, desc = self._orient_and_describe(jnp.concatenate(all_patches))
        return Keypoints(
            xy=jnp.concatenate(all_xy),
            response=jnp.concatenate(all_resp),
            octave=jnp.concatenate(all_oct),
            angle=ang,
            desc=desc,
            valid=jnp.concatenate(all_valid),
        )
