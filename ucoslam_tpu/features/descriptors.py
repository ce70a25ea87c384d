"""Alternative binary descriptor tables: FREAK retina + SURF-LSH.

Counterpart of the reference GridExtractor descriptor families
(gridextractor.cpp:36-39 wraps OpenCV AKAZE/BRISK/FREAK/SURF over an image
grid). OpenCV's xfeatures2d (FREAK/SURF) is not available in this
environment, and the reference's per-keypoint scalar sampling loops are the
wrong shape for the device anyway — so both are re-derived from their papers as
patch-batch matmul pipelines that share the ORB extractor's detection +
patch machinery (features/orb.py):

- FREAK (Alahi et al., CVPR 2012): 43-point retinal pattern (1 fovea +
  7 rings x 6 points) with ring-proportional Gaussian receptive fields.
  Sampling = one (patch -> 43) weight matrix per quantized rotation bin;
  the descriptor is 256 point-pair intensity comparisons. The reference's
  FREAK is 512 bits; GridExtractor's unified 256-bit packing keeps the
  device Hamming pipeline (ops/hamming.py) uniform across descriptor types.

- SURF (Bay et al., ECCV 2006): per-pixel Haar-like gradients rotated into
  the keypoint frame, pooled over a Gaussian-weighted 4x4 subregion grid
  into the classic 64-d (sum dx, sum |dx|, sum dy, sum |dy|) vector — then
  binarized with a seeded random-hyperplane LSH (sign of 256 projections)
  so SURF rides the same 256-bit Hamming path. Hamming distance between
  LSH codes is proportional to the angular (~L2 on unit vectors) distance
  the reference gates at 0.125 (gridextractor.cpp:39):
  E[hamming] = 256 * angle / pi, so 0.125 rad -> ~10 bits; the gate in
  config.hamming_gate_for adds slack for quantization noise.

All tables are built once at import with fixed seeds (deterministic,
signature-stable).
"""

from __future__ import annotations

import functools

import numpy as np

PATCH_RADIUS = 15  # must match features/orb.py PATCH_RADIUS
DESC_BINS = 64  # rotation quantization, shared with the ORB tables
N_BITS = 256

_P = 2 * PATCH_RADIUS + 1


# --------------------------------------------------------------------------
# FREAK
# --------------------------------------------------------------------------

def _freak_pattern():
    """(43, 3) array of (x, y, sigma): retinal sampling points.

    Ring radii decrease exponentially toward the fovea; receptive-field
    sigma is proportional to inter-ring spacing (overlapping fields, per
    the FREAK paper fig. 4).
    """
    R = 13.0  # keep rotated samples inside the 31x31 patch
    ring_frac = [1.0, 0.78, 0.6, 0.45, 0.32, 0.22, 0.14]
    pts = [(0.0, 0.0, 0.6)]  # fovea
    for k, fr in enumerate(ring_frac):
        r = R * fr
        sigma = max(0.6, 0.45 * r * (ring_frac[0] - ring_frac[-1]) / len(ring_frac) + 0.25 * r / 3.0)
        # stagger alternate rings by half a step (retinal mosaic)
        phase = (np.pi / 6.0) * (k % 2)
        for j in range(6):
            a = phase + 2.0 * np.pi * j / 6.0
            pts.append((r * np.cos(a), r * np.sin(a), sigma))
    return np.asarray(pts, np.float32)  # (43, 3)


FREAK_POINTS = _freak_pattern()
N_FREAK = FREAK_POINTS.shape[0]


def _freak_pairs(seed: int = 7) -> np.ndarray:
    """(256, 2) comparison pairs, coarse-to-fine biased, seeded-deterministic.

    The paper learns decorrelated pairs from data; here pairs are drawn
    without replacement with probability weighted toward large inter-point
    distance (the paper's selected pairs are predominantly coarse), which
    reproduces the matching behavior without the training corpus.
    """
    rng = np.random.default_rng(seed)
    ii, jj = np.triu_indices(N_FREAK, k=1)
    d = np.linalg.norm(FREAK_POINTS[ii, :2] - FREAK_POINTS[jj, :2], axis=1)
    w = d + 1.0
    p = w / w.sum()
    sel = rng.choice(ii.shape[0], size=N_BITS, replace=False, p=p)
    return np.stack([ii[sel], jj[sel]], -1).astype(np.int32)


FREAK_PAIRS = _freak_pairs()


@functools.lru_cache(maxsize=1)
def freak_tables() -> np.ndarray:
    """(DESC_BINS, P*P, 43) Gaussian receptive-field sampling tables.

    tables[b] @ patch_flat = the 43 smoothed retina samples with the
    pattern rotated by 2*pi*b/DESC_BINS. Each column is a normalized
    Gaussian over the patch pixels around the rotated point center.
    """
    ys, xs = np.mgrid[-PATCH_RADIUS:PATCH_RADIUS + 1, -PATCH_RADIUS:PATCH_RADIUS + 1]
    xs = xs.reshape(-1).astype(np.float32)
    ys = ys.reshape(-1).astype(np.float32)
    tables = np.zeros((DESC_BINS, _P * _P, N_FREAK), np.float32)
    for b in range(DESC_BINS):
        a = 2.0 * np.pi * b / DESC_BINS
        ca, sa = np.cos(a), np.sin(a)
        cx = ca * FREAK_POINTS[:, 0] - sa * FREAK_POINTS[:, 1]
        cy = sa * FREAK_POINTS[:, 0] + ca * FREAK_POINTS[:, 1]
        sig = FREAK_POINTS[:, 2]
        d2 = (xs[:, None] - cx[None, :]) ** 2 + (ys[:, None] - cy[None, :]) ** 2
        w = np.exp(-d2 / (2.0 * sig[None, :] ** 2))
        w[d2 > (3.0 * sig[None, :]) ** 2] = 0.0
        tables[b] = w / w.sum(axis=0, keepdims=True).clip(1e-9)
    return tables


# --------------------------------------------------------------------------
# SURF
# --------------------------------------------------------------------------

SURF_GRID = 4  # 4x4 subregions
# canonical-frame half-extent covered by the grid: must satisfy
# SURF_HALF <= PATCH_RADIUS / sqrt(2) so the rotated grid stays inside the
# 31x31 support patch at EVERY rotation bin — at 45-degree bins, patch
# pixels only reach canonical coords with max(|u|,|v|) <= R/sqrt(2); a
# larger grid leaves the corner subregions empty and zeroes 16/64 features
# for those bins, making descriptors rotation-dependent.
SURF_HALF = 10.5


@functools.lru_cache(maxsize=1)
def surf_tables() -> np.ndarray:
    """(DESC_BINS, P*P, 16) rotated subregion pooling masks.

    For rotation bin b, each patch pixel is mapped into the keypoint's
    canonical frame (rotate by -theta); pixels landing inside the 4x4 grid
    contribute to their subregion with an overall Gaussian weight
    (sigma = 3.3, as in the SURF paper scaled to our fixed patch).
    """
    ys, xs = np.mgrid[-PATCH_RADIUS:PATCH_RADIUS + 1, -PATCH_RADIUS:PATCH_RADIUS + 1]
    xs = xs.reshape(-1).astype(np.float32)
    ys = ys.reshape(-1).astype(np.float32)
    g = np.exp(-(xs ** 2 + ys ** 2) / (2.0 * (0.4 * SURF_HALF * 2) ** 2))
    cellw = 2.0 * SURF_HALF / SURF_GRID
    tables = np.zeros((DESC_BINS, _P * _P, SURF_GRID * SURF_GRID), np.float32)
    for b in range(DESC_BINS):
        a = 2.0 * np.pi * b / DESC_BINS
        ca, sa = np.cos(a), np.sin(a)
        # canonical coords: rotate pixel offsets by -theta
        ux = ca * xs + sa * ys
        uy = -sa * xs + ca * ys
        gx = np.floor((ux + SURF_HALF) / cellw).astype(np.int64)
        gy = np.floor((uy + SURF_HALF) / cellw).astype(np.int64)
        inside = (gx >= 0) & (gx < SURF_GRID) & (gy >= 0) & (gy < SURF_GRID)
        cell = gy * SURF_GRID + gx
        idx = np.nonzero(inside)[0]
        tables[b, idx, cell[idx]] = g[idx]
    # normalize each subregion's mass so all cells weigh equally
    tot = tables.sum(axis=1, keepdims=True).clip(1e-9)
    return tables / tot


@functools.lru_cache(maxsize=1)
def surf_lsh_projection(seed: int = 1234) -> np.ndarray:
    """(64, 256) seeded random-hyperplane LSH projection."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((4 * SURF_GRID * SURF_GRID, N_BITS)).astype(np.float32)
