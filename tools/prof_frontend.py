"""Frontend stage profiler: pyramid / FAST+topk / patches / describe.

Times jitted sub-pipelines of the ORB extractor on JAX's default backend
(the GPU where there is one; JAX_PLATFORMS=cpu forces the CPU, whose times
say nothing about the card) with pipelined dispatch. Run from the
repository root:

  python tools/prof_frontend.py [n_reps]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import jax
import jax.numpy as jnp


def timed(fn, args, n=20, label=""):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    outs = [fn(*args) for _ in range(n)]
    jax.block_until_ready(outs)
    dt = (time.perf_counter() - t0) / n
    print(f"{label:24s} {dt * 1e3:7.3f} ms")
    return dt


def main():
    from ucoslam_tpu.features.orb import ORBExtractor
    from ucoslam_tpu.ops.image import build_pyramid
    from ucoslam_tpu.io.synthetic import SyntheticSequence

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    seq = SyntheticSequence(n_frames=2, n_points=1500)
    img = jnp.asarray(seq.render(0))
    orb = ORBExtractor(max_features=2048, n_levels=8)
    thr = jnp.float32(orb.fast_threshold)

    pyr = jax.jit(lambda im: build_pyramid(im, orb.n_levels, orb.scale_factor))

    @jax.jit
    def detect_all(im, threshold):
        levels = build_pyramid(im, orb.n_levels, orb.scale_factor)
        return [
            orb._detect_level(lv_img, orb.budgets[lv], threshold)
            for lv, lv_img in enumerate(levels)
        ]

    @jax.jit
    def detect_and_patches(im, threshold):
        levels = build_pyramid(im, orb.n_levels, orb.scale_factor)
        out = []
        for lv, lv_img in enumerate(levels):
            xy, resp, valid = orb._detect_level(lv_img, orb.budgets[lv], threshold)
            out.append(orb._extract_support_patches(lv_img, xy))
        return jnp.concatenate(out)

    patches = detect_and_patches(img, thr)
    describe = jax.jit(orb._orient_and_describe)

    t_pyr = timed(pyr, (img,), n, "pyramid")
    t_det = timed(detect_all, (img, thr), n, "pyramid+detect(topk)")
    t_pat = timed(detect_and_patches, (img, thr), n, "  +patch extraction")
    t_desc = timed(describe, (patches,), n, "describe (alone)")
    t_full = timed(
        lambda im: orb.detect_and_compute(im), (img,), n, "full detect_and_compute"
    )
    print(
        f"\nattribution: pyramid {t_pyr * 1e3:.2f} | detect {1e3 * (t_det - t_pyr):.2f}"
        f" | patches {1e3 * (t_pat - t_det):.2f} | describe {t_desc * 1e3:.2f}"
        f" | full {t_full * 1e3:.2f} ms"
    )


if __name__ == "__main__":
    main()
