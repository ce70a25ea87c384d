"""Two-pass benchmark harness: map (SLAM) then evaluate (LOCALIZATION).

Counterpart of tests/test_sequence.cpp (:156-420): pass 1 runs full SLAM
over the sequence with per-frame `|@#` signature lines, then
waitForFinished + globalOptimization and a map save; pass 2 re-runs the
same sequence in MODE_LOCALIZATION and the pass-2 trajectory is what gets
evaluated (the paper's protocol). Supports the `-recovery` rollback
behavior: on tracking loss, reload the last checkpoint, rewind 15 frames
and temporarily tighten keyframe params (test_sequence.cpp:268-296).

Usage:
  python -m ucoslam_tpu.apps.test_sequence --synthetic 60 --out-dir /tmp/run
  python -m ucoslam_tpu.apps.test_sequence --dataset tum_dir --camera cam.yml \\
      --out-dir results [--recovery] [--save-every 100]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def main(argv=None) -> int:
    from ucoslam_tpu.api import UcoSlam
    from ucoslam_tpu.config import Mode, Params
    from ucoslam_tpu.io.datasets import save_trajectory_tum
    from ucoslam_tpu.apps.run_slam import load_camera_yml

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset")
    ap.add_argument(
        "--format", choices=["tum", "euroc", "kitti"],
        help="dataset layout; sniffed from the directory when omitted",
    )
    ap.add_argument(
        "--preset",
        help="param preset (kitti/euroc/euroc_difficult/spm/tum); defaults "
        "to the detected format (test_generator_monocular.sh presets)",
    )
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--synthetic-traj", default="arc",
                    help="synthetic trajectory: arc|line|loop|orbit_out")
    ap.add_argument("--synthetic-points", type=int, default=1200)
    ap.add_argument("--synthetic-markers", type=int, default=0)
    ap.add_argument("--stereo", action="store_true")
    ap.add_argument("--rgbd", action="store_true",
                    help="RGB-D: feed depth frames through processRGBD (TUM "
                    "depth.txt, or the renderer's depth with --synthetic)")
    ap.add_argument("--gt", help="ground-truth file (KITTI poses.txt)")
    ap.add_argument("--camera")
    ap.add_argument(
        "--voc", default="auto",
        help="vocabulary .fbow; 'auto' = bundled data/vocab.fbow, 'none' = off",
    )
    ap.add_argument("--params")
    ap.add_argument("--out-dir", default="results")
    ap.add_argument("--recovery", action="store_true")
    ap.add_argument("--save-every", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--profile", action="store_true",
        help="dump a jax profiler trace of pass 1 into <out-dir>/trace",
    )
    ap.add_argument("--debug-level", type=int, default=0)
    ap.add_argument(
        "--dbg-str", action="append", default=[],
        help="debug string-registry entries key[=value] (Debug::addString)",
    )
    args = ap.parse_args(argv)
    from ucoslam_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    os.makedirs(args.out_dir, exist_ok=True)

    from ucoslam_tpu.utils import Debug, timers

    Debug.setLevel(args.debug_level)
    for s in args.dbg_str:
        k, _, v = s.partition("=")
        Debug.addString(k, v)

    params = Params.load_yml(args.params) if args.params else Params().replace(
        maxMapPoints=8192, maxKeyFrames=64, maxKeyPointsPerFrame=1024,
        maxDescDistance=60.0,
    )

    get_right = None
    get_depth = None
    if args.synthetic:
        from ucoslam_tpu.io.synthetic import SyntheticSequence

        seq = SyntheticSequence(
            n_frames=args.synthetic, seed=args.seed,
            trajectory=args.synthetic_traj, n_points=args.synthetic_points,
            n_markers=args.synthetic_markers,
        )
        cam = seq.cam
        n = seq.n_frames
        # render every frame once, before the timed loops: both passes read
        # the same images, and the host renderer's time is not the engine's
        if args.stereo:
            views = [seq.render_stereo(i) for i in range(n)]
            get_right = lambda i: views[i][1]  # noqa: E731
        elif args.rgbd:
            views = [seq.render_with_depth(i) for i in range(n)]
            # TUM convention: integer depth units, meters = raw * rgb_depthscale
            get_depth = lambda i: np.round(  # noqa: E731
                views[i][1] / cam.rgb_depthscale
            )
        else:
            views = [(seq.render(i),) for i in range(n)]
        get_img = lambda i: views[i][0]  # noqa: E731
        stamps = [i / 30.0 for i in range(n)]
        gt_path = os.path.join(args.out_dir, "groundtruth.txt")
        save_trajectory_tum(gt_path, stamps, [seq.gt_pose(i) for i in range(n)])
    else:
        from ucoslam_tpu.geometry.camera import CameraParams
        from ucoslam_tpu.io.datasets import (
            EurocSequence,
            KittiSequence,
            TumSequence,
            dataset_preset,
            detect_dataset_format,
        )

        fmt = args.format or detect_dataset_format(args.dataset)
        over, harness = dataset_preset(args.preset or fmt)
        if over and not args.params:
            params = params.replace(**over)
        if harness.get("recovery"):
            args.recovery = True
        gt_tuple = None
        if fmt == "euroc":
            ds = EurocSequence.open(args.dataset, stereo=args.stereo)
            cam = load_camera_yml(args.camera) if args.camera else ds.camera()
            n = len(ds)
            get_img = lambda i: ds.read(i)  # noqa: E731
            if args.stereo and ds.files1 is not None:
                get_right = lambda i: ds.read(i, 1)  # noqa: E731
            stamps = list(ds.stamps)
            gt_tuple = ds.gt
            gt_path = os.path.join(args.out_dir, "groundtruth.txt")
        elif fmt == "kitti":
            gt_file = args.gt or os.path.join(args.dataset, "poses.txt")
            ds = KittiSequence.open(args.dataset, poses_file=gt_file)
            cam = load_camera_yml(args.camera) if args.camera else ds.camera()
            n = len(ds)
            get_img = lambda i: ds.read(i)  # noqa: E731
            if args.stereo and ds.files1 is not None:
                get_right = lambda i: ds.read(i, 1)  # noqa: E731
            stamps = list(ds.stamps)
            gt_tuple = ds.gt
            gt_path = os.path.join(args.out_dir, "groundtruth.txt")
        else:
            tum = TumSequence.open(args.dataset)
            cam = (
                load_camera_yml(args.camera)
                if args.camera
                else CameraParams.create(500.0, 500.0, 320.0, 240.0)
            )
            n = len(tum)
            get_img = lambda i: tum.read_rgb(i)  # noqa: E731
            if args.rgbd:
                # reference processRGBD ingest (ucoslam.cpp:23-27): raw
                # 16-bit TUM depth scaled by rgb_depthscale in the extractor
                get_depth = lambda i: tum.read_depth_for(i)  # noqa: E731
            stamps = [tum.rgb[i][0] for i in range(n)]
            gt_path = os.path.join(args.dataset, "groundtruth.txt")
        if gt_tuple is not None:
            # re-emit EuRoC/KITTI ground truth in the TUM evaluation format
            gs, gc, gq = gt_tuple
            with open(gt_path, "w") as f:
                for t, c, q in zip(gs, gc, gq):
                    f.write(
                        f"{t:.6f} {c[0]:.6f} {c[1]:.6f} {c[2]:.6f} "
                        f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n"
                    )

    map_path = os.path.join(args.out_dir, "map.slm")
    ckpt_path = os.path.join(args.out_dir, "lost_track.slm")

    # ---------------- pass 1: SLAM ----------------
    import contextlib

    from ucoslam_tpu.utils.timers import profile_trace

    slam = UcoSlam()
    from ucoslam_tpu.io.fbow import default_vocab_path

    voc = args.voc if args.voc not in (None, "auto") else default_vocab_path()
    if args.voc == "none":
        voc = None
    slam.setParams(None, params, cam, vocabulary=voc)
    det = slam._extractor.marker_detector
    print(f"markerDetector={det.backend if det is not None else 'none'}")
    timers.reset()
    trace_cm = (
        profile_trace(os.path.join(args.out_dir, "trace"))
        if args.profile
        else contextlib.nullcontext()
    )
    t0 = time.time()
    i = 0
    last_ckpt_frame = 0
    p1_tracked = set()  # frame indices tracked at least once in pass 1
    frame_dt = []  # per-frame wall seconds (pass 1)
    recovered = 0
    recoveries_here = 0
    tightened_until = -1  # frame past which normal params are restored
    prefetched = (-1, None)
    with trace_cm:
        while i < n:
            t_frame = time.time()
            # overlap the next image's host->device upload with this
            # frame's host work (decode + device copy off the hot path)
            img_i = prefetched[1] if prefetched[0] == i else get_img(i)
            if i + 1 < n and get_right is None:
                nxt = get_img(i + 1)
                slam.prefetch(nxt)
                prefetched = (i + 1, nxt)
            if get_right is not None:
                pose = slam.processStereo(img_i, get_right(i), fseq=i)
            elif get_depth is not None:
                pose = slam.processRGBD(img_i, get_depth(i), fseq=i)
            else:
                pose = slam.process(img_i, fseq=i)
            if pose is not None:
                p1_tracked.add(i)
            if pose is not None and 0 <= tightened_until <= i:
                # re-acquired and past the loss point: restore normal KF
                # params (reference restores 5 frames past the loss,
                # tests/test_sequence.cpp:268-296)
                slam.updateParams(params)
                tightened_until = -1
            frame_dt.append(time.time() - t_frame)
            fps = (i + 1) / max(time.time() - t0, 1e-9)
            print(
                f"|@# Image {i + 1}/{n} fps={fps:.2f} "
                f"sig={slam.getSignatureStr()} {timers.report()}",
                flush=True,
            )
            if args.save_every and i > 0 and i % args.save_every == 0:
                slam.saveToFile(ckpt_path)
                last_ckpt_frame = i
                recoveries_here = 0
            if (
                args.recovery
                and pose is None
                and slam.map.n_keyframes > 2
                and os.path.exists(ckpt_path)
                and i - last_ckpt_frame > 15
                and recoveries_here < 3
            ):
                # rollback protocol: reload checkpoint, rewind 15 frames,
                # tighten KF params temporarily (test_sequence.cpp:268-296).
                # Deterministic replays re-lose identically, so at most 3
                # rollbacks per checkpoint region — then carry on forward
                # (reloc may still re-acquire the map later).
                slam.readFromFile(ckpt_path, cam)
                # tightened params must reach the live System's captured
                # copies (updateParams), not just the facade field —
                # readFromFile just rebuilt System from the checkpoint's
                # params, so a plain ._params assignment is a no-op
                slam.updateParams(slam._params.replace(
                    KFMinConfidence=0.9, KFCulling=0.9,
                    projDistThr=1.5 * slam._params.projDistThr,
                ))
                tightened_until = i + 5
                i = max(last_ckpt_frame, i - 15)
                recovered += 1
                recoveries_here += 1
                continue
            i += 1
    slam.waitForFinished()
    slam.globalOptimization()
    slam.saveToFile(map_path)
    t_map = time.time() - t0

    # ---------------- pass 2: LOCALIZATION ----------------
    slam2 = UcoSlam()
    slam2.readFromFile(map_path, cam)
    slam2.setMode(Mode.LOCALIZATION)
    slam2.resetTracker()
    t1 = time.time()
    est_stamps, est_poses = [], []
    prefetched = (-1, None)
    for i in range(n):
        img_i = prefetched[1] if prefetched[0] == i else get_img(i)
        if i + 1 < n and get_right is None:
            nxt = get_img(i + 1)
            slam2.prefetch(nxt)
            prefetched = (i + 1, nxt)
        if get_right is not None:
            pose = slam2.processStereo(img_i, get_right(i), fseq=i)
        elif get_depth is not None:
            pose = slam2.processRGBD(img_i, get_depth(i), fseq=i)
        else:
            pose = slam2.process(img_i, fseq=i)
        if pose is not None:
            est_stamps.append(stamps[i])
            est_poses.append(pose)
    t_track = time.time() - t1

    est_path = os.path.join(args.out_dir, "trajectory.txt")
    save_trajectory_tum(est_path, est_stamps, est_poses)
    import resource

    maxrss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    # steady-state fps: median per-frame wall time once the session is warm
    # (the first frames pay one-time costs -- cold XLA compiles -- that the
    # reference's in-process C++ never has; the all-in mappingFPS below
    # still reports them)
    warm = sorted(frame_dt[min(20, max(len(frame_dt) - 10, 0)):])
    steady = warm[len(warm) // 2] if warm else float("inf")
    print(f"steadyFPS={1.0 / max(steady, 1e-9):.2f} (median frame {steady * 1e3:.1f}ms)")
    print(
        f"mappingFPS={n / max(t_map, 1e-9):.2f} trackingFPS={n / max(t_track, 1e-9):.2f} "
        f"tracked={len(est_poses)}/{n} pass1_tracked={len(p1_tracked)}/{n} "
        f"recoveries={recovered} "
        f"keyframes={slam.map.n_keyframes} points={slam.map.n_points} "
        f"markers={int(np.asarray(slam.map.state.mk_pose_valid).sum())} "
        f"maxRSS={maxrss_mb:.0f}MB"
    )
    if os.path.exists(gt_path):
        from ucoslam_tpu.apps.compare_logs import evaluate

        out = evaluate(est_path, gt_path)
        if out:
            ate, pct, _ = out
            print(f"ATE={ate:.6f} perctFramesTracked={pct:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
