"""Quantify marker corner accuracy vs exact ground truth.

Renders the parity markers scene (ucoslam_tpu.io.synthetic), projects the
known marker poses to EXACT ground-truth corner positions, and measures
per-corner error for (a) the native C++ detector and (b) cv2.aruco with
subpixel refinement (a stand-in for the reference's vendored aruco, which
uses the same refinement family). VERDICT r3 item 9: native corner error
must reach sub-0.2 px to close the markers ATE gap.

Usage: python tools/corner_accuracy.py [--frames 40]
"""

from __future__ import annotations

import argparse
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def gt_corners_for_frame(seq, i):
    """id -> (4,2) exact projected corner positions (visible markers)."""
    import jax.numpy as jnp

    from ucoslam_tpu.markers.ippe import marker_object_points

    T = seq.poses[i]
    cam = seq.cam
    obj = np.asarray(marker_object_points(jnp.float32(seq.marker_size)))
    out = {}
    for mid, g2m in seq._marker_detector.poses.items():
        Tm = T @ g2m
        pts_c = obj @ Tm[:3, :3].T + Tm[:3, 3]
        if (pts_c[:, 2] <= 0.1).any():
            continue
        uv = np.asarray(cam.project(jnp.asarray(pts_c)))
        if (
            (uv[:, 0] < 5).any() or (uv[:, 0] >= cam.width - 5).any()
            or (uv[:, 1] < 5).any() or (uv[:, 1] >= cam.height - 5).any()
        ):
            continue
        out[mid] = uv
    return out


def best_match_err(det_corners, gt):
    """Min-over-cyclic-shift mean corner error (order conventions differ)."""
    errs = []
    for r in range(4):
        errs.append(np.linalg.norm(det_corners - np.roll(gt, r, 0), axis=1).mean())
    return min(errs)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args()

    from ucoslam_tpu.io.synthetic import SyntheticSequence
    from ucoslam_tpu.markers.native import detect_markers_native, native_available

    seq = SyntheticSequence(
        n_frames=150, n_points=1600, n_markers=10, marker_size=0.6,
        seed=args.seed,
    )
    try:
        import cv2
        import cv2.aruco as aruco

        d = aruco.getPredefinedDictionary(aruco.DICT_ARUCO_MIP_36h12)
        p = aruco.DetectorParameters()
        p.cornerRefinementMethod = aruco.CORNER_REFINE_SUBPIX
        cvdet = aruco.ArucoDetector(d, p)
    except ImportError:
        cvdet = None

    errs_native, errs_cv = [], []
    n_gt = n_det_native = n_det_cv = 0
    for i in range(0, 150, max(1, 150 // args.frames)):
        img = np.clip(seq.render(i), 0, 255).astype(np.uint8)
        gt = gt_corners_for_frame(seq, i)
        n_gt += len(gt)
        if native_available():
            ids, corners = detect_markers_native(img)
            for mid, c in zip(ids, corners):
                if int(mid) in gt:
                    n_det_native += 1
                    errs_native.append(best_match_err(c, gt[int(mid)]))
        if cvdet is not None:
            cs, ids2, _ = cvdet.detectMarkers(img)
            if ids2 is not None:
                for mid, c in zip(ids2.ravel(), cs):
                    if int(mid) in gt:
                        n_det_cv += 1
                        errs_cv.append(best_match_err(c.reshape(4, 2), gt[int(mid)]))

    def stats(name, errs, n_det):
        if not errs:
            print(f"{name}: no detections")
            return
        e = np.array(errs)
        print(
            f"{name}: n={n_det}/{n_gt} recall={n_det / max(n_gt, 1):.1%} "
            f"mean={e.mean():.3f}px median={np.median(e):.3f}px "
            f"p90={np.percentile(e, 90):.3f}px max={e.max():.3f}px"
        )

    stats("native", errs_native, n_det_native)
    stats("cv2   ", errs_cv, n_det_cv)


if __name__ == "__main__":
    main()
