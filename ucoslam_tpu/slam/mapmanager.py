"""Local mapping: keyframe insertion, new-point creation, culling, fusion.

Counterpart of the reference MapManager (mapmanager.cpp, obfuscated; behavior
per SURVEY.md §3.3): per new keyframe — addKeyFrame (:1953), recent-point
culling, epipolar matching with covis neighbours -> triangulation
(:3728-3816,10093) bounded by maxNewPoints, stereo direct points, duplicate
fusion (:8720-9189), keyframe culling by redundancy (:6098), local BA
(:10815), loop closure.

Two dispatch modes, matching the reference's runSequential switch
(ucoslamtypes.h:90; thread machinery mapmanager.h:740,1178,1188):

- sequential (deterministic): the System calls new_keyframe() inline
  between frames.
- async (the reference's default): a mapping worker thread consumes a
  bounded queue of keyframe candidates (the reference's TSQueue) while
  tracking continues on immutable state snapshots. The map has a SINGLE
  WRITER — this worker; even the tracker's seen/visible counter bumps are
  routed through the queue, so no locks guard the (atomically swapped)
  functional MapState. Pose corrections from mapping (local BA / loop
  closure / metric rescale) are published as an update the tracker
  consumes at the next frame start (the reference's mapUpdate/bigChange,
  mapmanager.h:847,859).

Deliberate async-mode semantics (differences vs the reference's thread):
- seen/visible counter bumps are DROPPED under queue backpressure
  (enqueue_stats) — they only tune point culling, and starving the
  keyframe channel for them would be the worse trade;
- busy() admits one keyframe candidate in flight: the tracker keeps
  tracking on its snapshot instead of queueing stale candidates (the
  reference's TSQueue holds more but drops older entries when full);
- a running local BA is never interrupted by a new candidate (the
  reference's mapping thread checks an abort flag mid-BA); candidates
  arriving meanwhile are simply skipped by the busy() gate.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import jax
import jax.numpy as jnp

from ucoslam_tpu.config import Params
from ucoslam_tpu.geometry.camera import CameraParams
from ucoslam_tpu.geometry.epipolar import fundamental_from_poses
from ucoslam_tpu.geometry.triangulate import triangulate_checked
from ucoslam_tpu.mapping.frame import Frame
from ucoslam_tpu.mapping.map import FLAG_STEREO, Map
from ucoslam_tpu.matching.matcher import match_frames_epipolar


@jax.jit
def _frame_from_kf_op(st, slot) -> Frame:
    from ucoslam_tpu.mapping.frame import empty_markers

    return Frame(
        fseq=st.kf_fseq[slot],
        xy=st.kf_xy[slot],
        und_xy=st.kf_xy[slot],
        octave=st.kf_octave[slot],
        angle=jnp.zeros((st.N,), jnp.float32),
        response=jnp.zeros((st.N,), jnp.float32),
        desc=st.kf_desc[slot],
        depth=st.kf_depth[slot],
        valid=st.kf_kpt_valid[slot],
        ids=st.kf_ids[slot],
        pose_f2g=st.kf_pose[slot],
        markers=empty_markers(),
    )


def _frame_from_kf(world_map: Map, slot: int) -> Frame:
    """Materialize a keyframe slot back into a Frame view (one dispatch:
    the eager per-field slicing cost ~18 device round trips per call)."""
    return _frame_from_kf_op(world_map.state, jnp.int32(slot))


@jax.jit
def _epipolar_pair_op(st, cur_slot, nb_slot, cam, max_desc_dist, scale_factor):
    """Epipolar match + triangulate one keyframe pair, fully on device.

    Returns (ok, train_idx, X): per-cur-keypoint new-point candidates
    (FrameMatcher::matchEpipolar + Triangulate, mapmanager.cpp:3728-3816).
    """
    cur = _frame_from_kf_op(st, cur_slot)
    other = _frame_from_kf_op(st, nb_slot)
    F12 = fundamental_from_poses(cur.pose_f2g, other.pose_f2g, cam, cam)
    log_sf = jnp.log(scale_factor)
    sigma2_other = jnp.exp(2.0 * other.octave.astype(jnp.float32) * log_sf)
    matches = match_frames_epipolar(
        cur, other, F12, sigma2_other, max_desc_dist, only_unassigned=True
    )
    t_idx = jnp.where(matches.valid, matches.train_idx, 0)
    sigma2_1 = jnp.exp(2.0 * cur.octave.astype(jnp.float32) * log_sf)
    X, ok = triangulate_checked(
        cur.und_xy, other.und_xy[t_idx], cur.pose_f2g, other.pose_f2g,
        cam, cam, sigma2_1, sigma2_other[t_idx],
    )
    return ok & matches.valid, matches.train_idx, X


#: neighbour-batch width for the vmapped epipolar program (pad to fixed)
_EPI_MAX_NB = 6


@jax.jit
def _epipolar_pairs_vmap(st, cur_slot, nb_slots, cam, max_desc_dist, scale_factor):
    """All covis neighbours in one program: vmap over the neighbour axis
    turns six dispatches into one (the hamming/triangulation math batches
    for free)."""
    return jax.vmap(
        lambda nb: _epipolar_pair_op(
            st, cur_slot, nb, cam, max_desc_dist, scale_factor
        )
    )(nb_slots)


def fuse_duplicates_into_kf(world_map: Map, kf_slot: int, cam, params) -> int:
    """Merge duplicate map points seen by keyframe `kf_slot`
    (counterpart Map::fuseMapPoints, map.cpp:264; mapmanager.cpp:8720).

    Projects map points into the keyframe; when a projected point lands on
    a keypoint already assigned to a DIFFERENT point with a matching
    descriptor, the two are duplicates: keep the one with more
    observations, rewrite all references to the loser. Returns the number
    of points fused away. Also used by LoopDetector.correct_map to fuse
    duplicates across a just-closed loop seam (loopdetector.cpp:3024-3081).
    """
    from ucoslam_tpu.matching.projection import match_points_to_frame

    st = world_map.state
    cur = _frame_from_kf(world_map, kf_slot)
    m = match_points_to_frame(
        st.pt_pos, st.pt_desc, st.pt_normal, st.pt_min_dist, st.pt_max_dist,
        st.pt_active, cur, cam, cur.pose_f2g,
        jnp.float32(3.0),  # tight radius: only near-coincident points
        jnp.float32(params.maxDescDistance * 0.6),
        jnp.float32(params.scaleFactor),
    )
    kpt_idx, mvalid, ids = jax.device_get(
        (m.kpt_idx, m.point_valid, st.kf_ids[kf_slot])
    )
    obs_counts = world_map.point_observation_counts()
    # vectorized pair resolution: each projected point p that lands on
    # a keypoint already claimed by a different point q is a duplicate
    # pair (p, q); keep the better-observed one, remap the loser
    # everywhere with one gather (no per-pair array rewrites)
    p_all = np.nonzero(mvalid)[0]
    q_all = ids[kpt_idx[p_all]]
    sel = (q_all >= 0) & (q_all != p_all)
    p_all, q_all = p_all[sel], q_all[sel]
    if len(p_all) == 0:
        return 0
    # deterministic winner: more observations, ties to the lower slot
    # (also makes (p,q)/(q,p) orientations agree — no remap cycles)
    cp, cq = obs_counts[p_all], obs_counts[q_all]
    lo = np.minimum(p_all, q_all)
    hi = np.maximum(p_all, q_all)
    keep = np.where(cp > cq, p_all, np.where(cq > cp, q_all, lo))
    lose = np.where(cp > cq, q_all, np.where(cq > cp, p_all, hi))
    remap = np.arange(st.P, dtype=np.int32)
    remap[lose] = keep.astype(np.int32)
    # path-compress chains (a->b, b->c) to their final survivor
    for _ in range(2 + int(np.log2(max(len(p_all), 2)))):
        nxt = remap[remap]
        if (nxt == remap).all():
            break
        remap = nxt
    fused = np.nonzero(remap != np.arange(st.P))[0]
    world_map.points.free(fused)
    # apply the remap to every keyframe row ON DEVICE (uploading the (P,)
    # remap beats round-tripping the whole (K, N) kf_ids arena twice)
    world_map.state = _op_apply_remap(
        world_map.state, jnp.asarray(remap), jnp.asarray(world_map.points.active)
    )
    return len(fused)


@jax.jit
def _op_apply_remap(st, remap, pt_active):
    kf_ids = st.kf_ids
    remapped = remap[jnp.clip(kf_ids, 0, None)]
    return st._replace(
        kf_ids=jnp.where(kf_ids >= 0, remapped, kf_ids),
        pt_active=pt_active,
    )


class MapManager:
    """Sequential-mode local mapping driven by the System."""

    def __init__(self, params: Params, cam: CameraParams, kfdb=None):
        from ucoslam_tpu.mapping.kfdatabase import KeyFrameDataBase
        from ucoslam_tpu.slam.loopclosure import LoopDetector

        self.params = params
        self.cam = cam
        self.kf_counter = 0
        self.last_scale_correction = 1.0  # set when marker scale rescales the map
        # True once the map is known to be metric (marker/depth init, or
        # one marker-based rescale applied): metric maps are never
        # rescaled again — repeated corrections on noisy fits jitter the
        # whole world (the reference's scale is fixed at initialization)
        self.metric_locked = False
        self.kfdb = kfdb if kfdb is not None else KeyFrameDataBase(params.maxKeyFrames)
        self.loop_detector = LoopDetector(params, cam, self.kfdb)
        self.loop_closures = 0  # loops accepted (bigChange counter)
        # async dispatch state (started by start_async)
        self._queue: queue.Queue | None = None
        self._thread: threading.Thread | None = None
        self._idle = threading.Event()
        self._idle.set()
        self._update_lock = threading.Lock()
        self._pending_update: dict | None = None
        self._worker_error: BaseException | None = None
        self._pending_kf = 0  # keyframe candidates queued or in flight

    # ------------------------------------------------------------------
    # Async dispatch (the reference's mapping thread, mapmanager.h:1178)
    # ------------------------------------------------------------------
    def start_async(self, world_map: Map) -> None:
        """Spawn the mapping worker (non-runSequential mode)."""
        if self._thread is not None:
            return
        self._queue = queue.Queue(maxsize=4)  # the reference's bounded TSQueue
        self._thread = threading.Thread(
            target=self._worker_loop, args=(world_map,), daemon=True,
            name="ucoslam-mapper",
        )
        self._thread.start()

    def stop_async(self) -> None:
        if self._thread is None:
            return
        self._queue.put(("stop", None))
        self._thread.join(timeout=60)
        self._thread = None
        self._queue = None

    @property
    def is_async(self) -> bool:
        return self._thread is not None

    def busy(self) -> bool:
        """True when the keyframe channel is saturated (the reference's
        bounded TSQueue, tsqueue.h:30: candidates BUFFER while the mapper
        works — skipping every needed keyframe while one is in flight
        measurably degrades async accuracy because keyframe PLACEMENT
        diverges from the sequential schedule). Up to 2 candidates ride
        the queue; beyond that the tracker keeps tracking and retries.
        Stats messages don't count — they are cheap counter bumps."""
        return self._pending_kf >= 2

    def wait_idle(self) -> None:
        """Block until the worker drains (UcoSlam::waitForFinished)."""
        if self._queue is None:
            return
        self._queue.join()
        self._idle.wait()
        if self._worker_error is not None:
            err, self._worker_error = self._worker_error, None
            raise err

    def enqueue_keyframe(self, frame: Frame) -> bool:
        """Hand a keyframe candidate to the worker; False if the queue is
        full (mapper saturated — the tracker just keeps tracking)."""
        try:
            self._pending_kf += 1
            self._queue.put_nowait(("kf", frame))
            return True
        except queue.Full:
            self._pending_kf -= 1
            return False

    def enqueue_stats(self, vis_mask, seen_mask) -> None:
        """Route tracker counter bumps through the single writer."""
        try:
            self._queue.put_nowait(("stats", (vis_mask, seen_mask)))
        except queue.Full:
            pass  # counters are advisory; drop under backpressure

    def consume_update(self) -> dict | None:
        """Pop the pending pose-correction event (mapUpdate/bigChange):
        {'dT': 4x4 old-kf-pose^-1 @ new-kf-pose, 'scale': float,
        'big_change': bool} or None."""
        with self._update_lock:
            upd, self._pending_update = self._pending_update, None
        return upd

    def _publish_update(self, pose_before: np.ndarray, pose_after: np.ndarray,
                        scale: float, big_change: bool) -> None:
        dT = np.linalg.inv(pose_before) @ pose_after
        with self._update_lock:
            prev = self._pending_update
            if prev is not None:
                # compose: corrections apply oldest-first
                dT = prev["dT"] @ dT
                scale = prev["scale"] * scale
                big_change = big_change or prev["big_change"]
            self._pending_update = {
                "dT": dT.astype(np.float32), "scale": scale,
                "big_change": big_change,
            }

    def _worker_loop(self, world_map: Map) -> None:
        while True:
            kind, payload = self._queue.get()
            self._idle.clear()
            try:
                if kind == "stop":
                    return
                if kind == "stats":
                    world_map.bump_point_stats(*payload)
                elif kind == "kf":
                    frame = payload
                    pose_before = np.asarray(frame.pose_f2g).copy()
                    self.last_scale_correction = 1.0
                    loops_before = self.loop_closures
                    kf_slot = self.new_keyframe(world_map, frame)
                    pose_after = world_map.h("kf_pose")[kf_slot]
                    self._publish_update(
                        pose_before, pose_after,
                        self.last_scale_correction,
                        self.loop_closures != loops_before,
                    )
            except BaseException as e:  # surface on wait_idle
                self._worker_error = e
            finally:
                if kind == "kf":
                    self._pending_kf -= 1
                self._idle.set()
                self._queue.task_done()

    # ------------------------------------------------------------------
    def new_keyframe(
        self, world_map: Map, frame: Frame, host_ids=None, host_depth=None,
        host_valid=None,
    ) -> int:
        """Insert `frame` as a keyframe and grow the map around it.

        host_ids/host_depth/host_valid: host copies of the frame arrays if
        the caller already fetched them (the tracker's bundled transfer) —
        each np.asarray here is otherwise a separate device round trip."""
        p = self.params
        # capacity-doubling growth so long sequences never starve
        # (SURVEY §5 map-size scaling; the arenas are XLA-static per bucket)
        if world_map.keyframes.n_active >= world_map.state.K - 1:
            self.kfdb.grow(world_map.grow_keyframes())
        if world_map.points.n_active >= int(0.95 * world_map.state.P):
            world_map.grow_points()
        # async: the candidate's point ids were assigned against an older
        # state snapshot — drop ids whose slots were freed/recycled meanwhile
        ids = host_ids if host_ids is not None else np.asarray(frame.ids)
        if (ids >= 0).any():
            alive = world_map.h("pt_active")
            stale = (ids >= 0) & ~alive[np.clip(ids, 0, len(alive) - 1)]
            if stale.any():
                frame = frame._replace(
                    ids=jnp.asarray(np.where(stale, -1, ids).astype(np.int32))
                )
        kf_slot = world_map.add_keyframe(frame)
        self.kf_counter += 1

        if p.detectMarkers and bool(np.asarray(frame.markers.valid).any()):
            from ucoslam_tpu.slam.markermap import (
                record_marker_observations,
                resolve_marker_slots,
                update_marker_poses,
            )

            slots = resolve_marker_slots(world_map, frame.markers)
            record_marker_observations(world_map, kf_slot, frame.markers, slots)
            if not self.metric_locked:
                # keypoint-initialized map, scale unknown: markers stay
                # pose-less until ONE marker-based rescale makes the map
                # metric (a metric marker pose in a non-metric map would
                # poison every BA edge it touches)
                from ucoslam_tpu.slam.markermap import (
                    estimate_scale_from_pending_markers,
                )

                s = estimate_scale_from_pending_markers(world_map, self.cam, p)
                if s is not None and 0.05 < s < 20.0:
                    if abs(s - 1.0) > 0.02:
                        world_map.scale(s)
                        self.last_scale_correction = s
                    self.metric_locked = True
            if self.metric_locked:
                update_marker_poses(world_map, self.cam, p)

        self._create_stereo_points(
            world_map, kf_slot, frame,
            host_depth=host_depth, host_valid=host_valid, host_ids=ids,
        )
        self._create_epipolar_points(world_map, kf_slot, frame)
        self._fuse_duplicates(world_map, kf_slot)
        self._cull_recent_points(world_map)
        if world_map.n_keyframes >= 3:
            from ucoslam_tpu.optim.ba import local_bundle_adjustment
            from ucoslam_tpu.utils import timers

            with timers.stage("localBA"):
                # full local covis window (reference semantics) in
                # sequential mode; async mapping caps it — a long BA over
                # many keyframes in the worker publishes stale corrections
                # that measurably hurt tracking (async ATE regression)
                cap = p.maxLocalKeyFrames or (None if self._thread is None else 8)
                local_bundle_adjustment(
                    world_map, self.cam, kf_slot, n_iters=10,
                    max_window=cap,
                )
        # refresh point normals / scale bounds / representative descriptors
        # (updatePointNormalAndDistances, globaloptimizer_g2o.cpp:466-537)
        from ucoslam_tpu.mapping.map import op_update_point_stats

        world_map.state = op_update_point_stats(
            world_map.state,
            jnp.float32(p.scaleFactor),
            jnp.int32(p.nOctaveLevels),
        )
        self._cull_keyframes(world_map, kf_slot)

        # ---- loop closure (reference: mapping-thread loop detect) ----
        self.kfdb.add(kf_slot, frame.desc, frame.valid)
        from ucoslam_tpu.utils import timers

        with timers.stage("loop"):
            self._detect_and_close_loop(world_map, kf_slot, frame)
        return kf_slot

    # ------------------------------------------------------------------
    def _detect_and_close_loop(self, world_map: Map, kf_slot: int, frame: Frame):
        p = self.params
        info = None
        if p.detectMarkers:
            info = self.loop_detector.detect_from_markers(world_map, kf_slot, frame)
        if (info is None or not info.found) and p.detectKeyPoints:
            info = self.loop_detector.detect_from_keypoints(world_map, kf_slot, frame)
        if info is None or not info.found:
            return
        fix_scale = bool(np.asarray((world_map.state.kf_depth > 0).any()))
        if self.loop_detector.correct_map(world_map, info, fix_scale=fix_scale):
            self.loop_closures += 1
            from ucoslam_tpu.optim.ba import global_bundle_adjustment

            global_bundle_adjustment(world_map, self.cam, n_iters=10)

    # ------------------------------------------------------------------
    def _create_stereo_points(
        self, world_map: Map, kf_slot: int, frame: Frame, host_depth=None,
        host_valid=None, host_ids=None,
    ):
        """Direct points from per-keypoint depth (stereo/RGB-D), for
        unassigned keypoints with valid close depth (ref get3dStereoPoint)."""
        depth = host_depth if host_depth is not None else np.asarray(frame.depth)
        kvalid = host_valid if host_valid is not None else np.asarray(frame.valid)
        kids = host_ids if host_ids is not None else np.asarray(frame.ids)
        valid = kvalid & (depth > 0) & (kids < 0)
        if self.cam.bl > 0:
            valid &= depth < 40.0 * self.cam.bl
        idx = np.nonzero(valid)[0]
        if len(idx) == 0:
            return
        cap = self.params.maxNewPoints
        if len(idx) > cap:
            resp = np.asarray(frame.response)[idx]
            idx = idx[np.argsort(-resp)[:cap]]
        cam_pts = np.asarray(self.cam.unproject(frame.und_xy, frame.depth))[idx]
        T = np.asarray(frame.pose_f2g)
        R, t = T[:3, :3], T[:3, 3]
        world_pts = (cam_pts - t) @ R  # R^T (x - t)
        center = -R.T @ t
        rays = world_pts - center
        dist = np.linalg.norm(rays, axis=1).clip(1e-9)
        octave = np.asarray(frame.octave)[idx]
        sf = self.params.scaleFactor
        max_d = dist * sf**octave
        min_d = max_d / sf ** (self.params.nOctaveLevels - 1)
        avail = world_map.state.P - world_map.n_points
        if avail <= 0:
            return
        idx = idx[:avail]
        k = len(idx)
        slots = world_map.add_points(
            pos=world_pts[:k],
            normal=(rays / dist[:, None])[:k],
            desc=np.asarray(frame.desc)[idx],
            min_dist=min_d[:k],
            max_dist=max_d[:k],
            flags=np.full(k, FLAG_STEREO, np.int32),
            creation_kf=self.kf_counter,
        )
        world_map.set_observations(kf_slot, idx.astype(np.int32), slots)

    # ------------------------------------------------------------------
    def _create_epipolar_points(self, world_map: Map, kf_slot: int, frame: Frame):
        """Triangulate new points against the best covisible neighbours."""
        p = self.params
        covis = world_map.covis_matrix()
        weights = covis[kf_slot].copy()
        weights[kf_slot] = 0
        order = np.argsort(-weights)
        # the reference triangulates against the FULL covis neighbour set
        # (mapmanager.cpp:3728-3816); 6 covers the typical local window —
        # beyond that the maxNewPoints budget is exhausted anyway
        neighbours = [int(s) for s in order[:6] if weights[s] >= 10]
        if not neighbours:
            # marker-only bootstrap: no shared points yet — triangulate
            # against the most recent other keyframe
            others = [s for s in world_map.keyframes.active_slots() if s != kf_slot]
            if others:
                neighbours = [int(others[-1])]
        budget = p.maxNewPoints
        # mono conditioning gate (reference getFrameMedianDepth +
        # baseline_medianDepth_ratio_min): a neighbour whose baseline is
        # tiny relative to the scene depth triangulates garbage that BA
        # then has to absorb — skip it
        median_depth = world_map.frame_median_depth(kf_slot)
        min_baseline = p.baseline_medianDepth_ratio_min * max(median_depth, 1e-6)
        # baseline pre-filter from the cached host poses (no device trips)
        kf_pose = world_map.h("kf_pose")
        T1 = kf_pose[kf_slot]
        c1 = -T1[:3, :3].T @ T1[:3, 3]
        good = []
        for nb in neighbours:
            T2 = kf_pose[nb]
            c2 = -T2[:3, :3].T @ T2[:3, 3]
            if float(np.linalg.norm(c1 - c2)) >= max(1e-4, min_baseline):
                good.append(nb)
        if not good:
            return
        # ALL neighbours in one vmapped dispatch + one bundled fetch: the
        # pair programs are tiny, so per-dispatch round-trip
        # latency dominates a python loop over them
        st = world_map.state
        nb_pad = good + [good[-1]] * (_EPI_MAX_NB - len(good))
        ok_v, tidx_v, X_v = _epipolar_pairs_vmap(
            st, jnp.int32(kf_slot), jnp.asarray(nb_pad, jnp.int32), self.cam,
            jnp.float32(p.maxDescDistance), jnp.float32(p.scaleFactor),
        )
        # bundle the row slices into the same fetch (NOT h("kf_desc"):
        # that would round-trip the whole multi-MB descriptor arena)
        ok_v, tidx_v, X_v, cur_desc, cur_oct = jax.device_get((
            ok_v, tidx_v, X_v, st.kf_desc[kf_slot], st.kf_octave[kf_slot],
        ))
        results = [(ok_v[i], tidx_v[i], X_v[i]) for i in range(len(good))]
        taken = np.zeros(st.N, bool)  # kpt of cur already got a point
        for nb, (ok, train_idx, X) in zip(good, results):
            if budget <= 0:
                break
            idx1 = np.nonzero(ok & ~taken)[0]
            if len(idx1) == 0:
                continue
            if len(idx1) > budget:
                idx1 = idx1[:budget]
            avail = world_map.state.P - world_map.n_points
            if avail <= 0:
                break
            idx1 = idx1[:avail]
            taken[idx1] = True
            idx2 = train_idx[idx1]
            Xn = X[idx1]
            rays = Xn - c1
            dist = np.linalg.norm(rays, axis=1).clip(1e-9)
            octave = cur_oct[idx1]
            max_d = dist * p.scaleFactor**octave
            min_d = max_d / p.scaleFactor ** (p.nOctaveLevels - 1)
            slots = world_map.add_points(
                pos=Xn,
                normal=rays / dist[:, None],
                desc=cur_desc[idx1],
                min_dist=min_d,
                max_dist=max_d,
                flags=np.zeros(len(idx1), np.int32),
                creation_kf=self.kf_counter,
            )
            world_map.set_observations(kf_slot, idx1.astype(np.int32), slots)
            world_map.set_observations(nb, idx2.astype(np.int32), slots)
            budget -= len(idx1)

    # ------------------------------------------------------------------
    def _fuse_duplicates(self, world_map: Map, kf_slot: int):
        fuse_duplicates_into_kf(world_map, kf_slot, self.cam, self.params)

    # ------------------------------------------------------------------
    def _cull_keyframes(self, world_map: Map, kf_slot: int):
        """Remove redundant keyframes (KFCulling, mapmanager.cpp:6098):
        a covis neighbour whose tracked points are >= KFCulling-fraction
        observed by >= 3 other keyframes is redundant."""
        p = self.params
        if p.KFCulling >= 1.0 or world_map.n_keyframes <= 3:
            return
        covis = world_map.covis_matrix()
        obs_counts = world_map.point_observation_counts()
        candidates = [int(s) for s in np.nonzero(covis[kf_slot] > 0)[0] if s != kf_slot]
        # only candidate rows leave the device (full kf_ids is ~MBs)
        cand_rows = {}
        if candidates:
            rows = jax.device_get(world_map.state.kf_ids[jnp.asarray(candidates)])
            cand_rows = {c: rows[i] for i, c in enumerate(candidates)}
        # never cull the two oldest (gauge anchors)
        anchors = set(world_map.keyframes.active_slots()[:2].tolist())
        to_remove = []
        obs_counts = obs_counts.copy()
        for s in candidates:
            if s in anchors:
                continue
            ids = cand_rows[s]
            obs = ids[ids >= 0]
            if len(obs) < 10:
                continue
            redundant = (obs_counts[obs] >= 4).mean()
            if redundant > p.KFCulling:
                to_remove.append(s)
                # discount the victim's observations so a mutually-
                # redundant pair is never culled together (each was
                # redundant only because of the other)
                obs_counts[obs] -= 1
                if len(to_remove) >= 2:
                    # incremental like the reference, but up to two per
                    # round now that localization-coverage gates exist
                    # (VERDICT r4 item 10; stereo pass-2 at 100%)
                    break
        if to_remove:
            world_map.remove_keyframes(to_remove)
            self.kfdb.remove(to_remove)

    # ------------------------------------------------------------------
    def _cull_recent_points(self, world_map: Map):
        """Remove unreliable recent points (ref: visibility-ratio culling).

        A point is culled if (a) seen/visible ratio < 0.25 after being in
        the map for >= 2 keyframes, or (b) it is older than 3 keyframes and
        observed by fewer than minNumProjPoints keyframes.
        """
        active, n_seen, n_vis, creation = world_map.h(
            "pt_active", "pt_n_seen", "pt_n_visible", "pt_creation_kf"
        )
        if not active.any():
            return
        n_seen = n_seen.astype(np.float32)
        n_vis = n_vis.astype(np.float32).clip(1)
        age = self.kf_counter - creation
        obs_counts = world_map.point_observation_counts()
        bad_ratio = (n_seen / n_vis < 0.25) & (age >= 2)
        bad_obs = (age >= 3) & (obs_counts < self.params.minNumProjPoints)
        cull = active & (bad_ratio | bad_obs)
        if cull.any():
            world_map.remove_points(cull)
