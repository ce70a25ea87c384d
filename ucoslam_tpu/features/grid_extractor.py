"""Alternative-descriptor extractor plug point (AKAZE/BRISK/ORB-cv …).

Counterpart of the reference GridExtractor (gridextractor.{h:29,cpp:36-285}):
wraps OpenCV detectors over an image grid for descriptor types other than
the native ORB, with the per-type matching distance table
(gridextractor.cpp:36-39: AKAZE 120, BRISK 70, FREAK 70, SURF 0.125).

Only binary 256-bit descriptors integrate with the device Hamming pipeline;
AKAZE(MLDB-256)/BRISK are truncated/padded to 256 bits. This is a host-side
compatibility path — the native ORB extractor is the production frontend.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ucoslam_tpu.config import DescriptorType, Params
from ucoslam_tpu.features.orb import Keypoints

# reference per-type minimum descriptor distances (gridextractor.cpp:36-39)
DESC_DISTANCES = {
    DescriptorType.ORB: 50.0,
    DescriptorType.AKAZE: 120.0,
    DescriptorType.BRISK: 70.0,
    DescriptorType.FREAK: 70.0,
    DescriptorType.SURF: 0.125,
}


class GridExtractor:
    def __init__(self, params: Params):
        import cv2

        self.params = params
        t = params.kpDescriptorType
        if t == DescriptorType.AKAZE:
            self._det = cv2.AKAZE_create()
        elif t == DescriptorType.BRISK:
            self._det = cv2.BRISK_create()
        elif t == DescriptorType.ORB:
            self._det = cv2.ORB_create(nfeatures=params.maxKeyPointsPerFrame)
        else:
            raise ValueError(f"unsupported GridExtractor type {t}")
        self.n_slots = params.maxKeyPointsPerFrame

    @staticmethod
    def _decode_octave(kp_octave: int, desc_type: DescriptorType) -> int:
        """cv2 keypoint octave decoding per detector family.

        BRISK/AKAZE store a plain small integer. cv2 SIFT/ORB-style packed
        octaves keep the layer in bits 8-15 and a SIGNED octave in bits
        0-7 (-1 = upscaled base layer) — `octave & 0xFF` alone reads 255
        for -1. Handle both encodings.
        """
        o = int(kp_octave) & 0xFF
        if o >= 128:
            o -= 256  # signed byte: cv2's -1 upscaled octave
        return max(0, o)

    def _grid_select(self, kps, w: int, h: int, grid: int = 4):
        """Reference grid tiling (gridextractor.cpp:36-285): budget split
        across a grid x grid tile lattice, best-response first per tile, so
        detections cover the image instead of clustering on hot texture."""
        if not kps:
            return []
        per_tile = max(1, self.n_slots // (grid * grid))
        tiles: dict[tuple[int, int], list[int]] = {}
        for i, k in enumerate(kps):
            tx = min(int(k.pt[0] * grid / max(w, 1)), grid - 1)
            ty = min(int(k.pt[1] * grid / max(h, 1)), grid - 1)
            tiles.setdefault((ty, tx), []).append(i)
        chosen: list[int] = []
        leftovers: list[int] = []
        for idx in tiles.values():
            idx = sorted(idx, key=lambda i: -kps[i].response)
            chosen.extend(idx[:per_tile])
            leftovers.extend(idx[per_tile:])
        # fill any remaining budget globally by response
        leftovers.sort(key=lambda i: -kps[i].response)
        chosen.extend(leftovers[: max(0, self.n_slots - len(chosen))])
        return chosen[: self.n_slots]

    def detect_and_compute(self, img) -> Keypoints:
        import cv2

        arr = np.asarray(img)
        if arr.dtype != np.uint8:
            arr = np.clip(arr, 0, 255).astype(np.uint8)
        if arr.ndim == 3:
            arr = cv2.cvtColor(arr, cv2.COLOR_BGR2GRAY)
        kps, desc = self._det.detectAndCompute(arr, None)
        order = self._grid_select(kps, arr.shape[1], arr.shape[0])
        n = len(order)
        xy = np.zeros((self.n_slots, 2), np.float32)
        resp = np.zeros(self.n_slots, np.float32)
        octv = np.zeros(self.n_slots, np.int32)
        ang = np.zeros(self.n_slots, np.float32)
        packed = np.zeros((self.n_slots, 8), np.uint32)
        for j, i in enumerate(order):
            k = kps[i]
            xy[j] = k.pt
            resp[j] = k.response
            octv[j] = self._decode_octave(k.octave, self.params.kpDescriptorType)
            ang[j] = np.deg2rad(k.angle) if k.angle >= 0 else 0.0
            d = desc[i]
            raw = np.zeros(32, np.uint8)
            raw[: min(32, len(d))] = d[:32]
            packed[j] = raw.view(np.uint32)
        valid = np.arange(self.n_slots) < n
        return Keypoints(
            xy=jnp.asarray(xy),
            response=jnp.asarray(resp),
            octave=jnp.asarray(octv),
            angle=jnp.asarray(ang),
            desc=jnp.asarray(packed),
            valid=jnp.asarray(valid),
        )

    def sigma2(self, octave):
        log_s = jnp.log(jnp.float32(self.params.scaleFactor))
        return jnp.exp(2.0 * octave.astype(jnp.float32) * log_s)
