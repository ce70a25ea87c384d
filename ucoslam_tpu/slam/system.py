"""Top-level SLAM orchestration and tracking state machine.

Counterpart of the reference System (system.{h,cpp}, obfuscated; behavior per
SURVEY.md §2/§3.2): per frame — extract (done by caller or FrameExtractor),
initialize if map empty, else track with motion-model prior; relocalize when
lost; keyframe decision -> MapManager; MODE_SLAM vs MODE_LOCALIZATION.
Sequential deterministic mode only (the reference's runSequential); the
mapping step runs inline between frames.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ucoslam_tpu.config import Mode, Params, TrackingState
from ucoslam_tpu.geometry.camera import CameraParams
from ucoslam_tpu.mapping.frame import Frame
from ucoslam_tpu.mapping.map import Map
from ucoslam_tpu.slam.initializer import MapInitializer
from ucoslam_tpu.slam.mapmanager import MapManager
from ucoslam_tpu.slam.tracker import Tracker


class System:
    def __init__(
        self,
        params: Params,
        cam: CameraParams,
        world_map: Map | None = None,
        kfdb=None,
    ):
        from ucoslam_tpu.utils.precision import force_f32_matmuls

        force_f32_matmuls()  # geometry/optim matmuls at full f32 (no TF32)
        params = params.effective()  # apply the extraParams escape hatch
        self.params = params
        self.cam = cam
        self.map = world_map or Map(params)
        self.tracker = Tracker(params, cam)
        self.initializer = MapInitializer(params, cam)
        self.manager = MapManager(params, cam, kfdb=kfdb)
        if kfdb is None:
            # no serialized database came with the map: derive the BoW
            # table from the loaded keyframes (checkpoints carry it —
            # api.readFromFile passes the restored kfdb)
            for s in self.map.keyframes.active_slots():
                self.manager.kfdb.add(
                    int(s), self.map.state.kf_desc[int(s)],
                    self.map.state.kf_kpt_valid[int(s)],
                )
        self.mode = Mode.SLAM
        self.state = TrackingState.LOST
        self.pose = None  # last pose_f2g (np 4x4) or None
        self.prev_pose = None
        self.velocity = np.eye(4, dtype=np.float32)  # motion model increment
        self.frames_since_kf = 0
        self.last_kf_inliers = 0
        self._last_kf_rot = None  # rotation (3x3) of the last-inserted KF
        self._lost_streak = 0  # consecutive lost frames (re-seed trigger)
        self._reseed_anchor = None  # dead-reckoned pose at re-seed ref frame
        self._reseed_ref_fseq = 0
        self._dead_pose = None  # motion-model extrapolation while lost
        self.stats_log = []
        # non-sequential: spawn the mapping worker (the reference's default
        # two-thread pipeline; runSequential=True keeps everything inline)
        if not params.runSequential:
            self.manager.start_async(self.map)

    # -- helpers --------------------------------------------------------
    def _prior(self) -> jnp.ndarray:
        if self.pose is None:
            return jnp.eye(4)
        return jnp.asarray(self.velocity @ self.pose)

    def _update_motion_model(self, new_pose: np.ndarray):
        if self.pose is not None:
            self.velocity = (new_pose @ np.linalg.inv(self.pose)).astype(np.float32)
        self.prev_pose = self.pose
        self.pose = new_pose.astype(np.float32)

    # -- main entry -----------------------------------------------------
    def process_frame(self, frame: Frame) -> np.ndarray | None:
        """Process one extracted frame; returns pose_f2g or None if lost.

        (counterpart UcoSlam::process -> System::process, ucoslam.cpp:20-28)
        """
        from ucoslam_tpu.utils import timers

        if self.manager.is_async:
            self._consume_map_update()
        if self.map.n_keyframes == 0:
            if self.mode == Mode.LOCALIZATION:
                return None
            return self._try_initialize(frame)

        if self.state == TrackingState.TRACKING:
            with timers.stage("track"):
                res = self.tracker.track(self.map, frame, self._prior())
        elif self.params.reLocalizationWithKeyPoints:
            # BoW-indexed candidates through the keyframe database; the
            # tracker falls back to brute force for a DummyDataBase
            with timers.stage("reloc"):
                res = self.tracker.relocalize(
                    self.map, frame, kfdb=self.manager.kfdb
                )
        else:
            from ucoslam_tpu.slam.tracker import TrackResult

            res = TrackResult(
                False, frame.pose_f2g, frame, 0, 0, np.zeros(0, np.int32)
            )

        if not res.ok and self.params.detectMarkers and (
            self.params.reLocalizationWithMarkers or self.state == TrackingState.TRACKING
        ):
            # marker fallback: pose from observed markers with known map
            # pose (Map::getBestPoseFromValidMarkers, map.cpp:1189), then
            # retry keypoint tracking from that pose as prior
            from ucoslam_tpu.slam.markermap import best_pose_from_valid_markers

            mk_pose = best_pose_from_valid_markers(self.map, frame.markers, self.cam)
            if mk_pose is not None:
                retry = self.tracker.track(self.map, frame, jnp.asarray(mk_pose))
                if retry.ok:
                    res = retry
                else:
                    res = res._replace(
                        ok=True,
                        pose_f2g=jnp.asarray(mk_pose),
                        frame=frame._replace(pose_f2g=jnp.asarray(mk_pose)),
                    )

        if not res.ok:
            self.state = TrackingState.LOST
            self._lost_streak += 1
            if self.pose is not None:
                # keep dead-reckoning through the outage: the motion model's
                # last per-frame increment extrapolates the anchor for a
                # potential fresh-segment re-seed
                base = self._dead_pose if self._dead_pose is not None else self.pose
                self._dead_pose = (self.velocity @ base).astype(np.float32)
            pose = self._try_reseed(frame)
            if pose is not None:
                self._log(frame, pose, self.last_kf_inliers)
                return pose
            self._log(frame, None, 0)
            return None

        self.state = TrackingState.TRACKING
        self._lost_streak = 0
        self._reseed_anchor = None
        self._dead_pose = None
        pose = np.asarray(res.pose_f2g)
        self._update_motion_model(pose)
        self.frames_since_kf += 1

        # point seen/visible counters: applied by the single map writer
        if res.vis_mask is not None:
            if self.manager.is_async:
                self.manager.enqueue_stats(res.vis_mask, res.seen_mask)
            else:
                self.map.bump_point_stats(res.vis_mask, res.seen_mask)

        need_kf = self.mode == Mode.SLAM and self._need_keyframe(res)
        # reference-count maintenance AFTER the decision: running max of
        # tracked inliers since the last keyframe (see _need_keyframe)
        self.last_kf_inliers = max(self.last_kf_inliers, res.n_inliers)

        if self.manager.is_async:
            if need_kf and not self.manager.busy():
                if self.manager.enqueue_keyframe(res.frame):
                    self.frames_since_kf = 0
                    self.last_kf_inliers = max(res.n_inliers, 1)
                    self._last_kf_rot = pose[:3, :3].copy()
            self._log(frame, pose, res.n_inliers)
            return pose

        if need_kf:
            self.manager.last_scale_correction = 1.0
            loops_before = self.manager.loop_closures
            with timers.stage("mapping"):
                kf_slot = self.manager.new_keyframe(
                    self.map, res.frame,
                    host_ids=res.host_ids, host_depth=res.host_depth,
                    host_valid=res.host_valid,
                )
            if self.manager.loop_closures != loops_before:
                # bigChange (mapmanager.h:859): a loop moved the world under
                # us — adopt the corrected keyframe pose, reset the motion
                # model
                pose = np.asarray(self.map.state.kf_pose[kf_slot]).copy()
                self.pose = pose
                self.prev_pose = None
                self.velocity = np.eye(4, dtype=np.float32)
            s = self.manager.last_scale_correction
            if s != 1.0:
                # the whole world (incl. this frame's pose) was rescaled
                self.pose[:3, 3] *= s
                if self.prev_pose is not None:
                    self.prev_pose = self.prev_pose.copy()
                    self.prev_pose[:3, 3] *= s
                self.velocity = self.velocity.copy()
                self.velocity[:3, 3] *= s
            self.frames_since_kf = 0
            # reset the reference count to THIS keyframe's tracked inliers;
            # the running max in subsequent frames absorbs the post-mapping
            # inlier surge from newly triangulated points
            self.last_kf_inliers = max(res.n_inliers, 1)
            self._last_kf_rot = pose[:3, :3].copy()
        self._log(frame, pose, res.n_inliers)
        return pose

    def _try_reseed(self, frame: Frame) -> np.ndarray | None:
        """Fresh-segment re-seed after unrecoverable tracking loss.

        The reference's harness gives up after its rollback budget and waits
        for relocalization (tests/test_sequence.cpp:268-296) — which a
        one-way trajectory never grants. Instead: once relocalization has
        failed `reseedAfterLostFrames` consecutive frames in SLAM mode, park
        a reference frame at the dead-reckoned global pose, then two-view
        initialize a NEW disconnected map segment there
        (initializer.reseed_two_view). Loop closure stitches the segments if
        the old map is ever re-observed (the BoW database spans both)."""
        p = self.params
        if (
            p.reseedAfterLostFrames <= 0
            or self.mode != Mode.SLAM
            or self.manager.is_async  # map writes belong to the worker
            or self._lost_streak < p.reseedAfterLostFrames
            or self._dead_pose is None
        ):
            return None
        if self._reseed_anchor is None:
            self.initializer.set_reference_frame(frame)
            self._reseed_anchor = self._dead_pose.copy()
            self._reseed_ref_fseq = int(frame.fseq)
            return None
        gap = max(1, int(frame.fseq) - self._reseed_ref_fseq)
        baseline = max(1e-3, float(np.linalg.norm(self.velocity[:3, 3])) * gap)
        status, cur, slots = self.initializer.reseed_two_view(
            frame, self.map, self._reseed_anchor, baseline,
            creation_kf=self.manager.kf_counter,
        )
        if status == "few_matches":
            # the scene moved past the parked reference: re-park here
            self.initializer.set_reference_frame(frame)
            self._reseed_anchor = self._dead_pose.copy()
            self._reseed_ref_fseq = int(frame.fseq)
            return None
        if status != "ok":
            return None  # low parallax so far: keep waiting for baseline
        for s in slots:  # register the segment with the BoW database
            self.manager.kfdb.add(
                int(s), self.map.state.kf_desc[int(s)],
                self.map.state.kf_kpt_valid[int(s)],
            )
        self.manager.kf_counter += 2
        self.state = TrackingState.TRACKING
        pose = np.asarray(cur.pose_f2g).astype(np.float32)
        self.pose = pose
        self.prev_pose = None
        self.velocity = np.eye(4, dtype=np.float32)
        self.frames_since_kf = 0
        self.last_kf_inliers = max(int(np.asarray(cur.ids >= 0).sum()), 30)
        self._last_kf_rot = pose[:3, :3].copy()
        self._lost_streak = 0
        self._reseed_anchor = None
        self._dead_pose = None
        return pose

    def _try_initialize(self, frame: Frame) -> np.ndarray | None:
        has_markers = self.params.detectMarkers and bool(
            np.asarray(frame.markers.valid).any()
        )
        has_kpts = bool(np.asarray(frame.valid).any())

        # Keypoint-poor, one-frame-allowed, or forced marker-only bootstrap
        # (mapinitializer ARUCO_initialize :2137)
        if has_markers and (
            self.params.forceInitializationFromMarkers
            or self.params.aruco_allowOneFrameInitialization
            or not has_kpts
        ):
            ok, cur = self.initializer.initialize_from_markers(frame, self.map)
            if ok:
                self.manager.metric_locked = True  # marker init is metric
                return self._finish_init(frame, cur)
        if self.params.forceInitializationFromMarkers:
            self.initializer.set_reference_frame(frame)
            self._log(frame, None, 0)
            return None
        depth_frame = bool(np.asarray(frame.depth > 0).any())
        if depth_frame:
            if self.initializer.initialize_from_depth(frame, self.map):
                self.manager.metric_locked = True  # stereo/RGB-D is metric
                self.state = TrackingState.TRACKING
                pose = np.eye(4, dtype=np.float32)
                self._update_motion_model(pose)
                self.manager.kf_counter = 1
                self.last_kf_inliers = int(np.asarray(frame.valid).sum())
                self._last_kf_rot = pose[:3, :3].copy()
                for s in self.map.keyframes.active_slots():
                    self.manager.kfdb.add(
                        int(s), self.map.state.kf_desc[int(s)],
                        self.map.state.kf_kpt_valid[int(s)],
                    )
                self._log(frame, pose, self.last_kf_inliers)
                return pose
            return None
        if self.initializer.ref_frame is None:
            self.initializer.set_reference_frame(frame)
            self._log(frame, None, 0)
            return None
        ref_markers = self.initializer.ref_frame.markers
        status, cur = self.initializer.initialize_two_view(frame, self.map)
        if status != "ok":
            # marker-only fallback: only after the keypoint path has failed
            # repeatedly (otherwise a zero-baseline marker init would beat
            # a one-frame-later hybrid init with precise geometry)
            self._init_failures = getattr(self, "_init_failures", 0) + 1
            if has_markers and self._init_failures > 5:
                ok, mcur = self.initializer.initialize_from_markers(frame, self.map)
                if ok:
                    self.manager.metric_locked = True
                    return self._finish_init(frame, mcur)
            # Re-seed only when the scene moved on (too few matches); a
            # geometric failure usually means insufficient baseline yet.
            if status == "few_matches":
                self.initializer.set_reference_frame(frame)
            self._log(frame, None, 0)
            return None

        # hybrid: keypoint geometry + marker metric scale
        # (the reference recovers real scale whenever markers are present)
        if has_markers:
            cur = self._apply_marker_scale(ref_markers, cur)
        return self._finish_init(frame, cur)

    def _apply_marker_scale(self, ref_markers, cur: Frame) -> Frame:
        from ucoslam_tpu.slam.markermap import (
            record_marker_observations,
            resolve_marker_slots,
        )

        got = self.initializer.marker_metric_scale(ref_markers, cur.markers)
        if got is None:
            return cur
        metric_baseline, ri, g2m = got
        T_cur = np.asarray(cur.pose_f2g).copy()
        map_baseline = float(np.linalg.norm(T_cur[:3, 3]))
        if map_baseline < 1e-6 or metric_baseline < 1e-6:
            return cur
        s = metric_baseline / map_baseline
        self.map.scale(s)
        self.manager.metric_locked = True  # hybrid init is metric now
        # register the marker (metric pose; global frame = ref camera is
        # unaffected by the scaling)
        kf_slots = self.map.keyframes.active_slots()
        slots_r = resolve_marker_slots(self.map, ref_markers)
        st = self.map.state
        self.map.state = st._replace(
            mk_pose=st.mk_pose.at[slots_r[ri]].set(jnp.asarray(g2m)),
            mk_pose_valid=st.mk_pose_valid.at[slots_r[ri]].set(True),
        )
        record_marker_observations(self.map, int(kf_slots[0]), ref_markers, slots_r)
        slots_c = resolve_marker_slots(self.map, cur.markers)
        record_marker_observations(self.map, int(kf_slots[1]), cur.markers, slots_c)
        T_cur[:3, 3] *= s
        return cur._replace(pose_f2g=jnp.asarray(T_cur.astype(np.float32)))

    def _finish_init(self, frame: Frame, cur: Frame) -> np.ndarray:
        self.state = TrackingState.TRACKING
        pose = np.asarray(cur.pose_f2g)
        self._update_motion_model(pose)
        self.manager.kf_counter = self.map.n_keyframes
        self.last_kf_inliers = max(int(np.asarray(cur.ids >= 0).sum()), 30)
        self._last_kf_rot = pose[:3, :3].copy()
        # the bootstrap keyframes must be BoW-searchable (relocalization and
        # loop candidates query the database over ALL keyframes)
        for s in self.map.keyframes.active_slots():
            self.manager.kfdb.add(
                int(s), self.map.state.kf_desc[int(s)],
                self.map.state.kf_kpt_valid[int(s)],
            )
        self._log(frame, pose, self.last_kf_inliers)
        return pose

    def _need_keyframe(self, res) -> bool:
        """Keyframe policy (reference: KFMinConfidence + thRefRatio +
        stereo close-point counts, system.cpp:1786 region,
        ucoslamtypes.h:95,150).

        A new keyframe is NEEDED when the tracked inlier count drops below
        thRefRatio x the reference count (the view drifted from the
        reference; `last_kf_inliers` is a RUNNING MAX since the last
        keyframe so a post-mapping inlier surge raises the bar instead of
        the old static-inflation which fired every frame and churned the
        map through insert+cull cycles), when tracking has gone stale, or
        — stereo/RGB-D — when tracked CLOSE points are scarce while the
        frame could create many (the reference's stereo close-point
        keyframe condition; close = z < 40*bl, imageparams.h:105). The
        frame QUALIFIES only when its match confidence — inliers/matches —
        is at least KFMinConfidence (ucoslamtypes.h:95)."""
        p = self.params
        if self.frames_since_kf < 1:
            return False
        # no capacity gate: the MapManager doubles the arenas when full
        ref = max(self.last_kf_inliers, 1)
        # stereo tolerates a deeper drop before re-keyframing (dense direct
        # depth keeps tracking strong; ORB-SLAM2 uses 0.75 stereo / 0.9 mono)
        th = p.thRefRatio if self.cam.bl <= 0 else min(p.thRefRatio, 0.75)
        need = (
            (res.n_inliers < th * ref and res.n_inliers > 15)
            or self.frames_since_kf >= 20
        )
        if not need and self.cam.bl > 0:
            # host copies came with the tracker's bundled fetch
            depth = res.host_depth if res.host_depth is not None else (
                np.asarray(res.frame.depth)
            )
            ids = res.host_ids if res.host_ids is not None else (
                np.asarray(res.frame.ids)
            )
            kvalid = res.host_valid if res.host_valid is not None else (
                np.asarray(res.frame.valid)
            )
            close = (depth > 0) & (depth < 40.0 * self.cam.bl)
            tracked_close = int((close & (ids >= 0)).sum())
            creatable = int((close & (ids < 0) & kvalid).sum())
            need = tracked_close < 100 and creatable > 70
        if (
            not need
            and p.kfRotationDeg > 0
            and self._last_kf_rot is not None
            and self.pose is not None
        ):
            # rotation-rate condition (LONGRUN r4 fix direction): a fast pan
            # sweeps features out of view before the inlier count decays —
            # insert once the view has rotated kfRotationDeg past the last
            # keyframe so the map keeps keyframes around the sweep
            dR = self.pose[:3, :3] @ self._last_kf_rot.T
            cosang = np.clip((np.trace(dR) - 1.0) / 2.0, -1.0, 1.0)
            need = np.degrees(np.arccos(cosang)) >= p.kfRotationDeg
        confidence = res.n_inliers / max(res.n_matches, 1)
        qualifies = res.n_inliers >= 20 and confidence >= p.KFMinConfidence
        if need and qualifies:
            return True
        # marker-carried tracking (few/no keypoint inliers but markers with
        # known pose observed): insert keyframes periodically so mapping can
        # triangulate once baseline appears (the reference's marker keyframe
        # policy via maxVisibleFramesPerMarker)
        if (
            p.detectMarkers
            and res.n_inliers < 20
            and self.frames_since_kf >= 4
            and bool(np.asarray(res.frame.markers.valid).any())
        ):
            return True
        return False

    def _log(self, frame, pose, n_inliers):
        self.stats_log.append(
            {
                "fseq": int(frame.fseq),
                "tracked": pose is not None,
                "n_inliers": n_inliers,
                "n_points": self.map.n_points,
                "n_kf": self.map.n_keyframes,
            }
        )

    def _consume_map_update(self) -> None:
        """Apply a pending mapping-side pose correction (the reference's
        mapUpdate / bigChange, mapmanager.h:847,859): the keyframe the
        candidate became moved under local BA / loop closure / rescale, so
        re-anchor the tracker pose relative to its corrected keyframe."""
        upd = self.manager.consume_update()
        if upd is None or self.pose is None:
            return
        self.pose = (self.pose @ upd["dT"]).astype(np.float32)  # pose @ P0^-1 @ P1
        if upd["big_change"] or upd["scale"] != 1.0:
            # loop closure / metric rescale: motion model is invalid
            self.prev_pose = None
            self.velocity = np.eye(4, dtype=np.float32)
        elif self.prev_pose is not None:
            # re-anchor the motion model too: velocity derives from
            # pose @ inv(prev_pose), so prev_pose must move into the
            # corrected world with the same dT or the next prior jitters
            self.prev_pose = (self.prev_pose @ upd["dT"]).astype(np.float32)
            self.velocity = (self.pose @ np.linalg.inv(self.prev_pose)).astype(
                np.float32
            )

    def wait_for_finished(self) -> None:
        """Drain pending mapping work (UcoSlam::waitForFinished)."""
        if self.manager.is_async:
            self.manager.wait_idle()
            self._consume_map_update()

    def shutdown(self) -> None:
        self.manager.stop_async()

    # -- public control (facade surface) --------------------------------
    def set_mode(self, mode: Mode) -> None:
        self.mode = mode

    def set_params(self, params: Params) -> None:
        """Propagate a live Params change into every captured copy.

        Tracker/MapManager/Initializer/LoopDetector all capture Params at
        __init__; the recovery protocol tightens KF params on a running
        System (the reference mutates the shared Params in place,
        tests/test_sequence.cpp:268-296), so a replace on the facade must
        reach them or the tightening is a silent no-op."""
        params = params.effective()
        self.params = params
        self.tracker.params = params
        self.initializer.params = params
        self.manager.params = params
        self.manager.loop_detector.params = params

    def reset_tracker(self) -> None:
        """Re-enter a known map (ucoslam.h:61 resetTracker)."""
        self.state = TrackingState.LOST
        self.pose = None
        self.velocity = np.eye(4, dtype=np.float32)
        self._lost_streak = 0
        self._reseed_anchor = None
        self._dead_pose = None

    def global_signature(self) -> int:
        """Determinism signature over map + params + TRACKER state.

        Counterpart UcoSlam::getSignatureStr (ucoslam.h:94): the reference
        rolls an order-sensitive Hash over ALL system internals — current
        pose, motion model, counters, mode — not just the map
        (system.cpp:2837-3102, hash.h:28). Order-sensitive composition
        (not XOR) so state-restore regressions are caught.
        """
        import hashlib

        h = hashlib.blake2b(digest_size=8)

        def upd_f(x):
            a = np.asarray(x, np.float64)
            h.update(np.round(a * 1e4).astype(np.int64).tobytes())

        h.update(self.map.signature().to_bytes(8, "little"))
        h.update(self.params.signature().to_bytes(8, "little", signed=False))
        upd_f(np.zeros((4, 4)) if self.pose is None else self.pose)
        upd_f(np.zeros((4, 4)) if self.prev_pose is None else self.prev_pose)
        upd_f(self.velocity)
        for v in (
            int(self.state), int(self.mode), self.frames_since_kf,
            self.manager.kf_counter, self.last_kf_inliers,
            int(self.manager.metric_locked),
        ):
            h.update(int(v).to_bytes(8, "little", signed=True))
        return int.from_bytes(h.digest(), "little")
