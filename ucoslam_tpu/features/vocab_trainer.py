"""Binary-descriptor vocabulary trainer (k-majority clustering).

Counterpart of the reference's offline fbow vocabulary creation
(3rdparty/fbow trains hierarchical k-means over ORB descriptors; the
shipped orb.fbow is downloaded by the GUI, README.txt:19). Device-native
design: flat k-majority clustering — assignment is one batched Hamming
argmin (a bit-matmul, ops/hamming.py), the update step is a bitwise
majority vote per cluster — and idf word weights from training-image
document frequency. The result is written with io/fbow.save_fbow, readable
by BOTH our kfdatabase and the reference fbow::Vocabulary::readFromFile
(verified head-to-head against the reference build in an earlier round).

Usage:
    python -m ucoslam_tpu.features.vocab_trainer --out data/vocab.fbow \
        [--words 2048] [--iters 8] [--frames 120]
"""

from __future__ import annotations

import argparse

import numpy as np


def harvest_descriptors(
    n_frames: int = 120, max_features: int = 1500, seeds=(11, 23, 37, 51),
):
    """ORB descriptors + image ids from rendered synthetic sequences.

    Several scenes (different seeds/trajectories) diversify texture
    statistics the way a photo corpus would for the reference.
    """
    from ucoslam_tpu.features.orb import ORBExtractor
    from ucoslam_tpu.io.synthetic import SyntheticSequence

    orb = ORBExtractor(max_features=max_features)
    descs, img_ids = [], []
    img = 0
    per_seq = max(1, n_frames // len(seeds))
    trajs = ["arc", "line", "loop", "orbit_out"]
    for si, seed in enumerate(seeds):
        seq = SyntheticSequence(
            n_frames=per_seq, n_points=1500, seed=seed,
            trajectory=trajs[si % len(trajs)], roll_deg=20.0 * (si % 2),
        )
        for i in range(per_seq):
            kps = orb.detect_and_compute(np.asarray(seq.render(i), np.float32))
            v = np.asarray(kps.valid)
            d = np.asarray(kps.desc)[v]
            descs.append(d)
            img_ids.append(np.full(len(d), img, np.int32))
            img += 1
    return np.concatenate(descs), np.concatenate(img_ids), img


def _hamming_assign(desc_u32: np.ndarray, cent_u32: np.ndarray, chunk=8192):
    """(N,) argmin Hamming cluster assignment, chunked on N."""
    import jax.numpy as jnp
    from ucoslam_tpu.ops.hamming import hamming_matrix

    out = np.empty(desc_u32.shape[0], np.int32)
    cent = jnp.asarray(cent_u32)
    for lo in range(0, desc_u32.shape[0], chunk):
        hi = min(lo + chunk, desc_u32.shape[0])
        d = hamming_matrix(jnp.asarray(desc_u32[lo:hi]), cent)
        out[lo:hi] = np.asarray(jnp.argmin(d, axis=1), np.int32)
    return out


def _majority_update(desc_u32, assign, k):
    """New centroids: per-cluster bitwise majority vote over 256 bits."""
    bits = np.unpackbits(
        desc_u32.view(np.uint8).reshape(len(desc_u32), -1), axis=1
    )  # (N, 256) 0/1
    sums = np.zeros((k, bits.shape[1]), np.int64)
    np.add.at(sums, assign, bits)
    counts = np.bincount(assign, minlength=k)[:, None]
    maj = (sums * 2 > counts).astype(np.uint8)
    return (
        np.packbits(maj, axis=1).view("<u4").reshape(k, -1).astype(np.uint32),
        counts[:, 0],
    )


def train_vocabulary(
    desc_u32: np.ndarray,
    img_ids: np.ndarray,
    n_images: int,
    k: int = 2048,
    iters: int = 8,
    seed: int = 0,
):
    """-> (centroids (k, 8) u32, idf weights (k,) f32)."""
    rng = np.random.default_rng(seed)
    n = desc_u32.shape[0]
    k = min(k, n)
    cent = desc_u32[rng.choice(n, k, replace=False)].copy()
    assign = None
    for it in range(iters):
        assign = _hamming_assign(desc_u32, cent)
        cent, counts = _majority_update(desc_u32, assign, k)
        # re-seed empty clusters from the largest ones' members
        empty = np.nonzero(counts == 0)[0]
        if len(empty):
            donors = rng.choice(n, len(empty), replace=False)
            cent[empty] = desc_u32[donors]
    assign = _hamming_assign(desc_u32, cent)
    # idf weight: log(N_images / images containing the word), DBoW2-style
    pairs = np.unique(np.stack([assign, img_ids[: len(assign)]]), axis=1)
    df = np.bincount(pairs[0], minlength=k).astype(np.float64)
    idf = np.log(n_images / np.clip(df, 1, None)).astype(np.float32)
    idf = np.clip(idf, 1e-3, None)
    return cent, idf


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="data/vocab.fbow")
    ap.add_argument("--words", type=int, default=2048)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from ucoslam_tpu.io.fbow import save_fbow

    print("harvesting descriptors ...", flush=True)
    desc, img_ids, n_images = harvest_descriptors(args.frames)
    print(f"  {len(desc)} descriptors from {n_images} images", flush=True)
    cent, w = train_vocabulary(
        desc, img_ids, n_images, k=args.words, iters=args.iters,
        seed=args.seed,
    )
    import os

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    save_fbow(args.out, cent, w)
    print(f"wrote {args.out}: {len(cent)} words")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
