"""Per-frame tracking: projection matching + robust pose refinement.

Counterpart of the tracking half of the reference System (system.cpp, per
SURVEY.md §3.2): pose prior from the motion model, map-point projection
matching (Map::matchFrameToMapPoints anchor system.cpp:5339), motion-only
LM refine (PnPSolver::solvePnp :5381), and BoW/brute-force relocalization
when lost (:4923-5292).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ucoslam_tpu.config import Params
from ucoslam_tpu.geometry.camera import CameraParams
from ucoslam_tpu.mapping.frame import Frame
from ucoslam_tpu.mapping.map import Map, MapState
from ucoslam_tpu.matching.projection import match_points_to_frame
from ucoslam_tpu.ops.hamming import (
    INVALID_DIST,
    filter_ambiguous_train_sized,
    hamming_matrix,
    match_best2,
)
from ucoslam_tpu.optim.pnp import motion_only_lm, pnp_ransac


class TrackResult(NamedTuple):
    ok: bool
    pose_f2g: jnp.ndarray
    frame: Frame  # with ids assigned for inlier matches
    n_matches: int
    n_inliers: int
    matched_point_slots: np.ndarray  # (n,) int32 slots of inlier points
    vis_mask: jnp.ndarray | None = None  # (P,) bool — points searched this frame
    seen_mask: jnp.ndarray | None = None  # (P,) bool — points matched inlier
    # host copies fetched in the same bundled transfer as the pose (the
    # keyframe decision reads them; refetching costs a round trip each)
    host_ids: np.ndarray | None = None  # (N,) int32
    host_depth: np.ndarray | None = None  # (N,) float32
    host_valid: np.ndarray | None = None  # (N,) bool


#: marker corner rows appended to the motion-only LM (4 per frame marker)
_MK_ROWS = 64


@partial(jax.jit, static_argnames=("use_depth",))
def _track_step(
    state: MapState,
    frame: Frame,
    cam: CameraParams,
    prior: jnp.ndarray,
    proj_dist_thr: jnp.ndarray,
    max_desc_dist: jnp.ndarray,
    scale_factor: jnp.ndarray,
    mk_X: jnp.ndarray = None,  # (_MK_ROWS, 3) marker corner world points
    mk_uv: jnp.ndarray = None,  # (_MK_ROWS, 2) observed und. corners
    mk_valid: jnp.ndarray = None,  # (_MK_ROWS,) bool
    use_depth: bool = False,  # static: stereo/RGB-D rows in the LM
):
    """Jitted core: match active map points against the frame and refine.

    Marker corners of valid-pose map markers join the motion-only LM as
    fixed 3D->2D edges with the reference's weight balancing
    (MarkerEdgeOnlyProject, pnpsolver.cpp:280-330: w_markers = 0.3 of the
    total edge mass) — metric marker geometry steadies every frame's
    pose, not just keyframes.
    """
    if mk_X is None:
        mk_X = jnp.zeros((_MK_ROWS, 3))
        mk_uv = jnp.zeros((_MK_ROWS, 2))
        mk_valid = jnp.zeros((_MK_ROWS,), bool)
    P = state.pt_pos.shape[0]
    pt_slots = jnp.arange(P, dtype=jnp.int32)
    sigma2 = jnp.exp(
        2.0 * frame.octave.astype(jnp.float32) * jnp.log(scale_factor)
    )

    def match_and_refine(pose0, thr, iters, rounds):
        m = match_points_to_frame(
            state.pt_pos,
            state.pt_desc,
            state.pt_normal,
            state.pt_min_dist,
            state.pt_max_dist,
            state.pt_active,
            frame,
            cam,
            pose0,
            thr,
            max_desc_dist,
            scale_factor,
        )
        # Compact to KEYPOINT-major before the LM: the map has P >> N
        # slots and only matched keypoints carry observations, so
        # iterating the LM over (N,) rows instead of (P,) cuts the
        # per-iteration sweep ~8x.
        safe_k = jnp.where(m.point_valid, m.kpt_idx, frame.n)
        pt_of_kpt = jnp.full((frame.n,), -1, jnp.int32).at[safe_k].set(
            pt_slots, mode="drop"
        )
        obs_valid = pt_of_kpt >= 0
        X = state.pt_pos[jnp.clip(pt_of_kpt, 0)]
        # marker weight balancing (pnpsolver.cpp:305-310): w_markers +
        # w_kp = 1 with w_markers = 0.3; each marker-corner row's
        # information is weight_marker = (0.3 * totalNEdges / 0.7) /
        # KpWeightSum
        kp_w = jnp.sum(jnp.where(obs_valid, 1.0 / sigma2, 0.0))
        n_mk = mk_valid.reshape(-1, 4).any(1).sum().astype(jnp.float32)
        total_e = m.n_matched.astype(jnp.float32) + n_mk
        w_mk = (0.3 * total_e / 0.7) / jnp.clip(kp_w, 1e-6)
        sigma2_mk = 1.0 / jnp.clip(w_mk, 1e-9)
        X_all = jnp.concatenate([X, mk_X])
        uv_all = jnp.concatenate([frame.und_xy, mk_uv])
        sig_all = jnp.concatenate([sigma2, jnp.full((_MK_ROWS,), sigma2_mk)])
        valid_all = jnp.concatenate([obs_valid, mk_valid])
        if use_depth:
            # stereo/RGB-D: measured per-keypoint depth adds the disparity
            # residual u_r = u - bf/z to each matched row, gated at
            # chi2(3D) (EdgeStereoSE3ProjectXYZOnlyPose, pnpsolver.cpp:246)
            depth_all = jnp.concatenate(
                [frame.depth, jnp.zeros((_MK_ROWS,))]
            )
            res = motion_only_lm(
                pose0, X_all, uv_all, sig_all, valid_all, cam,
                depth=depth_all, bf=cam.bl * cam.fx,
                iters=iters, rounds=rounds,
            )
        else:
            res = motion_only_lm(
                pose0, X_all, uv_all, sig_all, valid_all, cam,
                iters=iters, rounds=rounds,
            )
        return m, pt_of_kpt, obs_valid, res

    # two-stage track (the reference's track-then-refine pipeline): wide
    # association from the motion-model prior, then a RE-MATCH from the
    # refined pose at a tight radius — the second association pass picks up
    # points the prior's error pushed outside their gate and sheds early
    # mismatches before the final refine
    _, _, _, res0 = match_and_refine(prior, proj_dist_thr, 10, 4)
    m, pt_of_kpt, obs_valid, res = match_and_refine(
        res0.pose_f2g, jnp.maximum(0.5 * proj_dist_thr, 6.0), 10, 2
    )
    inlier_kpt = res.inliers[: frame.n] & obs_valid  # (N,)
    res = res._replace(n_inliers=jnp.sum(inlier_kpt))
    ids = jnp.where(inlier_kpt, pt_of_kpt, -1)
    # map inliers back to point slots for the seen-counter mask
    safe_p = jnp.where(inlier_kpt, pt_of_kpt, P)
    inlier = jnp.zeros((P,), bool).at[safe_p].set(True, mode="drop")
    # seen/visible masks (MapPoint statistics, mappoint.h:73-74); returned as
    # masks so the single map-writer (System in sequential mode, the mapping
    # worker in async mode) applies the increments — the tracker never
    # mutates the shared map
    return (
        res.pose_f2g,
        ids,
        inlier,
        m.n_matched,
        res.n_inliers,
        m.point_valid,
        inlier,
    )


@jax.jit
def _reloc_match(state: MapState, frame: Frame, max_desc_dist: jnp.ndarray):
    """Brute-force 3D-2D candidate matches for relocalization."""
    d = hamming_matrix(state.pt_desc, frame.desc)  # (P, N)
    idx, best, second = match_best2(
        d,
        valid_rows=state.pt_active,
        valid_cols=frame.valid,
    )
    accept = (best <= max_desc_dist) & (
        best.astype(jnp.float32) < 0.75 * second.astype(jnp.float32)
    )
    keep = filter_ambiguous_train_sized(
        idx, jnp.where(accept, best, INVALID_DIST), frame.n
    )
    return jnp.where(accept & keep, idx, -1), accept & keep


class Tracker:
    def __init__(self, params: Params, cam: CameraParams):
        self.params = params
        self.cam = cam
        self._key = jax.random.PRNGKey(0xC0FFEE)
        # constant zero marker rows, created ONCE (three fresh device
        # uploads per frame otherwise — pure round-trip waste)
        self._zero_mk = (
            jnp.zeros((_MK_ROWS, 3), jnp.float32),
            jnp.zeros((_MK_ROWS, 2), jnp.float32),
            jnp.zeros((_MK_ROWS,), bool),
        )

    def _marker_rows(self, world_map: Map, frame: Frame):
        """Fixed 3D->2D corner correspondences for frame markers whose map
        pose is valid (MarkerEdgeOnlyProject inputs, pnpsolver.cpp:280-299)."""
        if not self.params.detectMarkers:
            return self._zero_mk
        f_valid = np.asarray(frame.markers.valid)
        if not f_valid.any():
            return self._zero_mk
        mk_X = np.zeros((_MK_ROWS, 3), np.float32)
        mk_uv = np.zeros((_MK_ROWS, 2), np.float32)
        mk_valid = np.zeros((_MK_ROWS,), bool)
        from ucoslam_tpu.markers.ippe import marker_object_points

        st = world_map.state
        map_ids = np.asarray(st.mk_id)
        pose_valid = np.asarray(st.mk_pose_valid)
        mk_pose = np.asarray(st.mk_pose)
        mk_size = np.asarray(st.mk_size)
        f_ids = np.asarray(frame.markers.id)
        und = np.asarray(frame.markers.und_corners)
        k = 0
        for i in np.nonzero(f_valid)[0]:
            sel = np.nonzero((map_ids == f_ids[i]) & pose_valid)[0]
            if not len(sel) or k + 4 > _MK_ROWS:
                continue
            s = int(sel[0])
            obj = np.asarray(marker_object_points(jnp.float32(float(mk_size[s]))))
            mk_X[k : k + 4] = obj @ mk_pose[s][:3, :3].T + mk_pose[s][:3, 3]
            mk_uv[k : k + 4] = und[i]
            mk_valid[k : k + 4] = True
            k += 4
        return jnp.asarray(mk_X), jnp.asarray(mk_uv), jnp.asarray(mk_valid)

    def track(self, world_map: Map, frame: Frame, prior: jnp.ndarray) -> TrackResult:
        from ucoslam_tpu.mapping.frame import strip_markers

        st = world_map.state
        p = self.params
        mk_X, mk_uv, mk_valid = self._marker_rows(world_map, frame)
        # the jitted step ignores markers; host-numpy marker leaves would
        # be re-uploaded on every call (a round trip each)
        frame_d = strip_markers(frame)
        pose, ids, inlier, n_matched, n_inliers, vis, seen = _track_step(
            st,
            frame_d,
            self.cam,
            prior,
            jnp.float32(p.projDistThr),
            jnp.float32(p.maxDescDistance),
            jnp.float32(p.scaleFactor),
            mk_X, mk_uv, mk_valid,
            use_depth=self.cam.bl > 0,
        )
        # ONE bundled transfer for everything the host-side control flow
        # needs (device_get issues the copies async then blocks once;
        # each separate fetch costs a full round trip)
        fetch = [pose, ids, inlier, n_matched, n_inliers, frame.depth,
                 frame.valid]
        pose_np, ids_np, inlier_np, n_matched, n_inl, depth_np, valid_np = (
            jax.device_get(tuple(fetch))
        )
        n_inl = int(n_inl)
        if n_inl < 15:
            # One retry with a widened search radius (the reference widens
            # projDistThr when tracking weakens).
            pose, ids, inlier, n_matched, n_inliers, vis, seen = _track_step(
                st,
                frame_d,
                self.cam,
                prior,
                jnp.float32(p.projDistThr * 2.5),
                jnp.float32(p.maxDescDistance),
                jnp.float32(p.scaleFactor),
                mk_X, mk_uv, mk_valid,
                use_depth=self.cam.bl > 0,
            )
            pose_np, ids_np, inlier_np, n_matched, n_inl = jax.device_get(
                (pose, ids, inlier, n_matched, n_inliers)
            )
            n_inl = int(n_inl)
        ok = n_inl >= 15
        slots = np.nonzero(inlier_np)[0].astype(np.int32)
        return TrackResult(
            ok=ok,
            pose_f2g=pose_np,
            frame=frame._replace(ids=ids, pose_f2g=pose),
            n_matches=int(n_matched),
            n_inliers=n_inl,
            matched_point_slots=slots,
            vis_mask=vis if ok else None,
            seen_mask=seen if ok else None,
            host_ids=ids_np,
            host_depth=depth_np,
            host_valid=valid_np,
        )

    def relocalize(
        self, world_map: Map, frame: Frame, kfdb=None
    ) -> TrackResult:
        """Relocalize a lost tracker.

        With a keyframe database (`kfdb`), this is the reference's BoW
        path (system.cpp:4923-5292): retrieve covis-grouped candidate
        keyframes (keyframedatabase.cpp:195-304), match the frame against
        each candidate's MAP POINTS and verify with PnP-RANSAC — cost
        O(candidates x N^2), independent of the total map size. Without
        one (DummyDataBase), fall back to brute-force matching against the
        whole point arena.
        """
        if kfdb is not None and not kfdb.dummy:
            from ucoslam_tpu.matching.kfmatch import match_keyframe_points_pnp_batch

            cands = kfdb.relocalization_candidates(
                frame.desc,
                frame.valid,
                world_map.keyframes.active,
                covis=world_map.covis_matrix(),
            )
            self._key, sub = jax.random.split(self._key)
            # all candidates verified in one vmapped dispatch; try the
            # best-supported verified pose first
            cms = match_keyframe_points_pnp_batch(
                world_map, frame, cands, self.cam, self.params, sub,
                min_matches=20, min_inliers=15,
            )
            for cm in sorted(cms, key=lambda c: -c.n_inliers):
                if cm.ok:
                    res = self.track(world_map, frame, jnp.asarray(cm.pose_f2g))
                    if res.ok:
                        return res
            return TrackResult(
                False, frame.pose_f2g, frame, 0, 0, np.zeros(0, np.int32)
            )
        st = world_map.state
        p = self.params
        kpt_idx, valid = _reloc_match(st, frame, jnp.float32(p.maxDescDistance))
        safe = jnp.where(valid, kpt_idx, 0)
        uv = frame.und_xy[safe]
        sigma2 = jnp.exp(
            2.0
            * frame.octave[safe].astype(jnp.float32)
            * jnp.log(jnp.float32(p.scaleFactor))
        )
        self._key, sub = jax.random.split(self._key)
        res = pnp_ransac(
            st.pt_pos, uv, sigma2, valid, self.cam, sub,
            n_hypotheses=p.ransacIters,
        )
        if int(res.n_inliers) < 20:
            return TrackResult(False, frame.pose_f2g, frame, 0, 0, np.zeros(0, np.int32))
        # refine with projection tracking from the RANSAC pose
        return self.track(world_map, frame, res.pose_f2g)
