"""Whole-image ops: Gaussian blur, pyramid build, patch moments.

Counterpart of the reference's per-level image machinery
(ORBextractor::ComputePyramid, ORBextractor.cpp:1355; the GaussianBlur(7,7,2)
before descriptor sampling). Everything is expressed as XLA convolutions /
resizes so levels batch into matmuls instead of the reference's per-level
thread pool (ORBextractor.cpp:1080-1317).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    r = np.arange(ksize) - (ksize - 1) / 2.0
    k = np.exp(-(r * r) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _conv2d_single(img: jnp.ndarray, kernel: jnp.ndarray, pad: str = "SAME") -> jnp.ndarray:
    """(H, W) x (kh, kw) -> (H, W) convolution (cross-correlation)."""
    out = jax.lax.conv_general_dilated(
        img[None, None, :, :],
        kernel[None, None, :, :],
        window_strides=(1, 1),
        padding=pad,
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )
    return out[0, 0]


def gaussian_blur(img: jnp.ndarray, ksize: int = 7, sigma: float = 2.0) -> jnp.ndarray:
    """Separable Gaussian blur with reflect-101 borders.

    Matches cv2.GaussianBlur(img, (7,7), 2, 2, BORDER_REFLECT_101) closely
    enough for descriptor sampling (the reference blurs each level before
    computing rBRIEF).

    Implemented as explicit shifted-slice weighted sums rather than
    conv_general_dilated: the elementwise form compiles fast and fuses into
    one sweep over the image.
    """
    k = gaussian_kernel1d(ksize, sigma)
    pad = ksize // 2
    h, w = img.shape
    p = jnp.pad(img, ((pad, pad), (0, 0)), mode="reflect")
    tmp = sum(float(k[i]) * p[i : i + h, :] for i in range(ksize))
    p = jnp.pad(tmp, ((0, 0), (pad, pad)), mode="reflect")
    return sum(float(k[i]) * p[:, i : i + w] for i in range(ksize))


def pyramid_shapes(h: int, w: int, n_levels: int, scale_factor: float):
    """Static per-level (H_l, W_l) sizes, reference-compatible rounding."""
    shapes = []
    for lv in range(n_levels):
        s = 1.0 / (scale_factor ** lv)
        shapes.append((int(round(h * s)), int(round(w * s))))
    return shapes


def _resize_weight_mat(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) anti-aliased triangle-kernel interpolation matrix.

    Reproduces jax.image.resize(method='linear', antialias=True) exactly
    (same half-pixel sampling, kernel widened by the downscale ratio, weight
    renormalization, out-of-span zeroing) — but as an explicit matrix so the
    resize runs as a matmul instead of the gather-based scale-and-translate
    lowering.
    """
    scale = out_size / in_size
    kernel_scale = max(1.0, 1.0 / scale)
    sample_f = (np.arange(out_size) + 0.5) / scale - 0.5
    x = np.abs(sample_f[:, None] - np.arange(in_size)[None, :]) / kernel_scale
    weights = np.maximum(0.0, 1.0 - x)
    total = weights.sum(axis=1, keepdims=True)
    weights = np.where(np.abs(total) > 1e-6, weights / total, 0.0)
    in_span = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(in_span[:, None], weights, 0.0).astype(np.float32)


def resize_matmul(img: jnp.ndarray, out_shape: tuple[int, int]) -> jnp.ndarray:
    """Bilinear (anti-aliased) resize as two matmuls.

    Numerically matches jax.image.resize(img, out_shape, 'linear').
    """
    h, w = img.shape
    oh, ow = out_shape
    if (oh, ow) == (h, w):
        return img
    ah = jnp.asarray(_resize_weight_mat(h, oh))
    aw = jnp.asarray(_resize_weight_mat(w, ow))
    # HIGHEST: a reduced-precision matmul (bf16 passes, or TF32 on the GPU)
    # perturbs intensities by ~1 gray level and compounds across levels.
    hi = jax.lax.Precision.HIGHEST
    return jnp.matmul(jnp.matmul(ah, img, precision=hi), aw.T, precision=hi)


def build_pyramid(img: jnp.ndarray, n_levels: int, scale_factor: float):
    """(H, W) float32 -> list of per-level images (static shapes).

    Every level resizes DIRECTLY from level 0: the resize weights are
    anti-aliased (triangle filter scaled to the ratio, matching
    jax.image.resize 'linear'), so a single large downscale does not
    alias — and the levels become independent ops the device can overlap,
    instead of the reference's sequential prev-level chain which
    serialized 7 small matmuls behind each other."""
    h, w = img.shape
    shapes = pyramid_shapes(h, w, n_levels, scale_factor)
    levels = [img]
    for lv in range(1, n_levels):
        levels.append(resize_matmul(img, shapes[lv]))
    return levels


def patch_moment_maps(img: jnp.ndarray, radius: int = 15):
    """Dense intensity-centroid moment maps over a circular patch.

    Returns (m10, m01): each (H, W), where m10[y, x] = sum_{(u,v) in disc}
    u * I[y+v, x+u] — the moments used by ORB's IC-angle. NOTE: this dense
    conv form is a CPU/test reference; the production extractor computes
    moments only at keypoint locations via `keypoint_moments`).
    """
    d = 2 * radius + 1
    ys, xs = np.mgrid[-radius : radius + 1, -radius : radius + 1]
    disc = (xs * xs + ys * ys) <= radius * radius
    kx = (xs * disc).astype(np.float32)
    ky = (ys * disc).astype(np.float32)
    # conv_general_dilated performs cross-correlation, so the kernel taps
    # align with image offsets directly.
    m10 = _conv2d_single(img, jnp.asarray(kx))
    m01 = _conv2d_single(img, jnp.asarray(ky))
    return m10, m01


def keypoint_moments(img: jnp.ndarray, xy: jnp.ndarray, radius: int = 15):
    """IC moments (m10, m01) at keypoint locations only.

    xy: (N, 2) float pixel positions (rounded to int). Gathers the
    (2r+1)^2 disc per keypoint — N x 961 loads instead of a dense conv,
    which both runs and compiles fast.
    Returns (m10 (N,), m01 (N,)).
    """
    h, w = img.shape
    ys, xs = np.mgrid[-radius : radius + 1, -radius : radius + 1]
    disc = ((xs * xs + ys * ys) <= radius * radius).astype(np.float32)
    kx = jnp.asarray((xs * disc).astype(np.float32).reshape(-1))
    ky = jnp.asarray((ys * disc).astype(np.float32).reshape(-1))
    dy = jnp.asarray(ys.reshape(-1))
    dx = jnp.asarray(xs.reshape(-1))
    xi = jnp.clip(jnp.round(xy[:, 0]).astype(jnp.int32), 0, w - 1)
    yi = jnp.clip(jnp.round(xy[:, 1]).astype(jnp.int32), 0, h - 1)
    gy = jnp.clip(yi[:, None] + dy[None, :], 0, h - 1)  # (N, D)
    gx = jnp.clip(xi[:, None] + dx[None, :], 0, w - 1)
    vals = img[gy, gx]  # (N, D)
    m10 = vals @ kx
    m01 = vals @ ky
    return m10, m01


def extract_patches(img: jnp.ndarray, xy: jnp.ndarray, radius: int) -> jnp.ndarray:
    """(N, 2r+1, 2r+1) square patches centered at rounded xy.

    One batched 2-D gather. (A vmapped dynamic_slice lowered to a
    sequential per-keypoint loop, the largest stage of the extractor.)
    Out-of-range centers clamp to the image (only padded/invalid keypoints
    land there; their output is masked downstream).
    """
    P = 2 * radius + 1
    h, w = img.shape
    y0 = jnp.clip(jnp.round(xy[:, 1]).astype(jnp.int32) - radius, 0, h - P)
    x0 = jnp.clip(jnp.round(xy[:, 0]).astype(jnp.int32) - radius, 0, w - P)
    gy = y0[:, None, None] + jnp.arange(P)[None, :, None]
    gx = x0[:, None, None] + jnp.arange(P)[None, None, :]
    return img[gy, gx]


@partial(jax.jit, static_argnames=("mode",))
def bilinear_sample(img: jnp.ndarray, xy: jnp.ndarray, mode: str = "nearest") -> jnp.ndarray:
    """Sample image at continuous (x, y) locations.

    img: (H, W); xy: (..., 2) with x = column, y = row.
    mode 'nearest' matches OpenCV's cvRound sampling in the ORB descriptor;
    'bilinear' is available for sub-pixel uses (stereo refinement).
    """
    h, w = img.shape
    x = xy[..., 0]
    y = xy[..., 1]
    if mode == "nearest":
        xi = jnp.clip(jnp.round(x).astype(jnp.int32), 0, w - 1)
        yi = jnp.clip(jnp.round(y).astype(jnp.int32), 0, h - 1)
        return img[yi, xi]
    x0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, w - 2)
    y0 = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, h - 2)
    fx = jnp.clip(x - x0, 0.0, 1.0)
    fy = jnp.clip(y - y0, 0.0, 1.0)
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )


def rgb_to_gray(img: jnp.ndarray) -> jnp.ndarray:
    """BGR/RGB (H, W, 3) uint8/float -> grayscale float32 (H, W).

    Uses the OpenCV BGR weights (the reference converts with
    cv::COLOR_BGR2GRAY in FrameExtractor).
    """
    img = img.astype(jnp.float32)
    if img.ndim == 2:
        return img
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    return 0.114 * b + 0.587 * g + 0.299 * r
