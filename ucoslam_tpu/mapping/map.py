"""The shared world state: device-resident arenas of points/keyframes/markers.

Counterpart of the reference `Map` (src/map.{h:36-234,cpp:1334}) which owns
map_points (ReusableContainer), keyframes (FrameSet), map_markers (SafeMap),
the covisibility graph and the keyframe database. Here the whole world is a
pytree of fixed-capacity device arrays (`MapState`) mutated functionally by
jitted batch ops; a thin host `Map` wrapper owns slot allocation
(id-stable, lowest-free-first — the ReusableContainer contract) and
sequencing. No mutexes: the single-writer host orchestration plus functional
updates replace IoMutex/consitencyMutex (map.h:191-192).

Covisibility (covisgraph.h:39): instead of an edge map keyed by packed 64-bit
pairs, we keep the keyframe x point observation incidence implicit in
`kf_ids` and compute covis weights as an incidence matmul.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ucoslam_tpu.config import Params
from ucoslam_tpu.geometry.camera import CameraParams
from ucoslam_tpu.mapping.arena import Arena
from ucoslam_tpu.mapping.frame import MAX_MARKERS_PER_FRAME, Frame

# point status flags (reference mappoint.h flags BAD/STABLE/STEREO)
FLAG_BAD = 1
FLAG_STABLE = 2
FLAG_STEREO = 4


class MapState(NamedTuple):
    """All device-resident world state. Capacities are static."""

    # ---- map points (P slots) ----
    pt_pos: jnp.ndarray  # (P, 3) float32 world position
    pt_normal: jnp.ndarray  # (P, 3) float32 mean viewing direction
    pt_desc: jnp.ndarray  # (P, 8) uint32 representative descriptor
    pt_min_dist: jnp.ndarray  # (P,) float32 scale-invariance near bound
    pt_max_dist: jnp.ndarray  # (P,) float32 far bound
    pt_flags: jnp.ndarray  # (P,) int32 bitmask FLAG_*
    pt_n_seen: jnp.ndarray  # (P,) int32 frames where matched
    pt_n_visible: jnp.ndarray  # (P,) int32 frames where in frustum
    pt_creation_kf: jnp.ndarray  # (P,) int32 kf seq at creation (culling)
    pt_active: jnp.ndarray  # (P,) bool

    # ---- keyframes (K slots, N keypoint slots each) ----
    kf_pose: jnp.ndarray  # (K, 4, 4) float32 pose_f2g
    kf_fseq: jnp.ndarray  # (K,) int32 source frame index
    kf_active: jnp.ndarray  # (K,) bool
    kf_xy: jnp.ndarray  # (K, N, 2) float32 undistorted keypoints
    kf_octave: jnp.ndarray  # (K, N) int32
    kf_desc: jnp.ndarray  # (K, N, 8) uint32
    kf_depth: jnp.ndarray  # (K, N) float32
    kf_kpt_valid: jnp.ndarray  # (K, N) bool
    kf_ids: jnp.ndarray  # (K, N) int32 point slot or -1 (observation store)

    # ---- markers (M slots) ----
    mk_id: jnp.ndarray  # (M,) int32 aruco id (-1 empty)
    mk_pose: jnp.ndarray  # (M, 4, 4) float32 pose_g2m (marker->global)
    mk_pose_valid: jnp.ndarray  # (M,) bool 3d pose known
    mk_size: jnp.ndarray  # (M,) float32 side length (meters)
    mk_active: jnp.ndarray  # (M,) bool
    # marker observations: which keyframes see which marker slot
    kf_mk_slot: jnp.ndarray  # (K, Mf) int32 marker slot or -1
    kf_mk_corners: jnp.ndarray  # (K, Mf, 4, 2) float32 undistorted corners

    @property
    def P(self) -> int:
        return self.pt_pos.shape[0]

    @property
    def K(self) -> int:
        return self.kf_pose.shape[0]

    @property
    def N(self) -> int:
        return self.kf_xy.shape[1]


def empty_map_state(params: Params) -> MapState:
    P, K, N, M = (
        params.maxMapPoints,
        params.maxKeyFrames,
        params.maxKeyPointsPerFrame,
        params.maxMarkers,
    )
    Mf = MAX_MARKERS_PER_FRAME
    eye4 = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (K, 4, 4))
    return MapState(
        pt_pos=jnp.zeros((P, 3), jnp.float32),
        pt_normal=jnp.zeros((P, 3), jnp.float32),
        pt_desc=jnp.zeros((P, 8), jnp.uint32),
        pt_min_dist=jnp.zeros((P,), jnp.float32),
        pt_max_dist=jnp.full((P,), 1e9, jnp.float32),
        pt_flags=jnp.zeros((P,), jnp.int32),
        pt_n_seen=jnp.zeros((P,), jnp.int32),
        pt_n_visible=jnp.zeros((P,), jnp.int32),
        pt_creation_kf=jnp.zeros((P,), jnp.int32),
        pt_active=jnp.zeros((P,), bool),
        kf_pose=eye4,
        kf_fseq=jnp.full((K,), -1, jnp.int32),
        kf_active=jnp.zeros((K,), bool),
        kf_xy=jnp.zeros((K, N, 2), jnp.float32),
        kf_octave=jnp.zeros((K, N), jnp.int32),
        kf_desc=jnp.zeros((K, N, 8), jnp.uint32),
        kf_depth=jnp.zeros((K, N), jnp.float32),
        kf_kpt_valid=jnp.zeros((K, N), bool),
        kf_ids=jnp.full((K, N), -1, jnp.int32),
        mk_id=jnp.full((M,), -1, jnp.int32),
        mk_pose=jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (M, 4, 4)),
        mk_pose_valid=jnp.zeros((M,), bool),
        mk_size=jnp.zeros((M,), jnp.float32),
        mk_active=jnp.zeros((M,), bool),
        kf_mk_slot=jnp.full((K, Mf), -1, jnp.int32),
        kf_mk_corners=jnp.zeros((K, Mf, 4, 2), jnp.float32),
    )


# ----------------------------------------------------------------------
# Jitted functional mutation / query ops over MapState
# ----------------------------------------------------------------------


@jax.jit
def op_add_keyframe(state: MapState, slot: jnp.ndarray, frame: Frame) -> MapState:
    """Write a frame into keyframe slot (counterpart Map::addKeyFrame map.cpp:79)."""
    return state._replace(
        kf_pose=state.kf_pose.at[slot].set(frame.pose_f2g),
        kf_fseq=state.kf_fseq.at[slot].set(frame.fseq),
        kf_active=state.kf_active.at[slot].set(True),
        kf_xy=state.kf_xy.at[slot].set(frame.und_xy),
        kf_octave=state.kf_octave.at[slot].set(frame.octave),
        kf_desc=state.kf_desc.at[slot].set(frame.desc),
        kf_depth=state.kf_depth.at[slot].set(frame.depth),
        kf_kpt_valid=state.kf_kpt_valid.at[slot].set(frame.valid),
        kf_ids=state.kf_ids.at[slot].set(frame.ids),
    )


@jax.jit
def op_add_points(
    state: MapState,
    slots: jnp.ndarray,  # (B,) int32 target slots (from arena)
    use: jnp.ndarray,  # (B,) bool which rows are real
    pos: jnp.ndarray,  # (B, 3)
    normal: jnp.ndarray,  # (B, 3)
    desc: jnp.ndarray,  # (B, 8) uint32
    min_dist: jnp.ndarray,  # (B,)
    max_dist: jnp.ndarray,  # (B,)
    flags: jnp.ndarray,  # (B,) int32
    creation_kf: jnp.ndarray,  # () int32
) -> MapState:
    """Batched point creation (counterpart Map::addNewPoint map.cpp:47).

    Rows with use=False scatter into a scratch slot (P-1 is reserved? no —
    they scatter to their own slot but with active=False preserved by
    writing active=use)."""
    safe = jnp.where(use, slots, state.P - 1)
    # For inactive rows we still scatter to `safe` but re-write active with
    # `use`; slot P-1 stays a scratch slot only if never allocated — the
    # arena allocates lowest-first so P-1 is the last slot to be used.
    return state._replace(
        pt_pos=state.pt_pos.at[safe].set(jnp.where(use[:, None], pos, state.pt_pos[safe])),
        pt_normal=state.pt_normal.at[safe].set(
            jnp.where(use[:, None], normal, state.pt_normal[safe])
        ),
        pt_desc=state.pt_desc.at[safe].set(
            jnp.where(use[:, None], desc, state.pt_desc[safe])
        ),
        pt_min_dist=state.pt_min_dist.at[safe].set(
            jnp.where(use, min_dist, state.pt_min_dist[safe])
        ),
        pt_max_dist=state.pt_max_dist.at[safe].set(
            jnp.where(use, max_dist, state.pt_max_dist[safe])
        ),
        pt_flags=state.pt_flags.at[safe].set(jnp.where(use, flags, state.pt_flags[safe])),
        pt_n_seen=state.pt_n_seen.at[safe].set(jnp.where(use, 1, state.pt_n_seen[safe])),
        pt_n_visible=state.pt_n_visible.at[safe].set(
            jnp.where(use, 1, state.pt_n_visible[safe])
        ),
        pt_creation_kf=state.pt_creation_kf.at[safe].set(
            jnp.where(use, creation_kf, state.pt_creation_kf[safe])
        ),
        pt_active=state.pt_active.at[safe].set(
            jnp.where(use, True, state.pt_active[safe])
        ),
    )


@jax.jit
def op_set_observations(
    state: MapState, kf_slot: jnp.ndarray, kpt_idx: jnp.ndarray, point_ids: jnp.ndarray
) -> MapState:
    """Assign kf keypoints -> map points (Map::addMapPointObservation).

    kpt_idx (B,) int32 (−1 rows ignored), point_ids (B,) int32.
    """
    use = kpt_idx >= 0
    safe_idx = jnp.where(use, kpt_idx, 0)
    cur = state.kf_ids[kf_slot]
    new = cur.at[safe_idx].set(jnp.where(use, point_ids, cur[safe_idx]))
    return state._replace(kf_ids=state.kf_ids.at[kf_slot].set(new))


@jax.jit
def op_remove_points(state: MapState, remove_mask: jnp.ndarray) -> MapState:
    """Deactivate points and clear their observations everywhere
    (counterpart Map::removePoint + removeBadAssociations)."""
    ids = state.kf_ids
    obs_pt = jnp.where(ids >= 0, ids, 0)
    dead = remove_mask[obs_pt] & (ids >= 0)
    return state._replace(
        pt_active=state.pt_active & ~remove_mask,
        kf_ids=jnp.where(dead, -1, ids),
    )


@jax.jit
def op_remove_keyframes(state: MapState, remove_mask: jnp.ndarray) -> MapState:
    """Deactivate keyframes and drop their observations
    (counterpart Map::removeKeyFrames map.cpp:187)."""
    return state._replace(
        kf_active=state.kf_active & ~remove_mask,
        kf_ids=jnp.where(remove_mask[:, None], -1, state.kf_ids),
        kf_kpt_valid=state.kf_kpt_valid & ~remove_mask[:, None],
        kf_mk_slot=jnp.where(remove_mask[:, None], -1, state.kf_mk_slot),
    )


@jax.jit
def op_point_observation_counts(state: MapState) -> jnp.ndarray:
    """(P,) int32: number of active keyframes observing each point."""
    ids = jnp.where(state.kf_active[:, None], state.kf_ids, -1)
    flat = jnp.where(ids >= 0, ids, state.P).reshape(-1)
    counts = jnp.zeros((state.P + 1,), jnp.int32).at[flat].add(1)
    return counts[: state.P]


@jax.jit
def op_covis_matrix(state: MapState) -> jnp.ndarray:
    """(K, K) int32 covisibility weights = #points co-observed.

    Incidence matmul: O (K, P) in bf16 {0,1}; covis = O O^T.
    Counterpart of CovisGraph edge bookkeeping (covisgraph.h:63-64) — here
    recomputed exactly from the observation store when needed.
    """
    onehot = _incidence(state)
    covis = jnp.dot(onehot, onehot.T, preferred_element_type=jnp.float32)
    covis = covis.astype(jnp.int32)
    return covis * (1 - jnp.eye(state.K, dtype=jnp.int32))


def _incidence(state: MapState) -> jnp.ndarray:
    """(K, P) bf16 observation incidence matrix."""
    ids = jnp.where(
        state.kf_active[:, None] & (state.kf_ids >= 0), state.kf_ids, state.P
    )
    onehot = jnp.zeros((state.K, state.P + 1), jnp.bfloat16)
    onehot = onehot.at[jnp.arange(state.K)[:, None], ids].set(1.0)
    return onehot[:, : state.P]


@jax.jit
def _global_reproj_chi2_impl(state: MapState, cam: CameraParams) -> jnp.ndarray:
    """Mean reprojection chi2 over all observations
    (counterpart Map::globalReprojChi2 map.cpp:772)."""
    ids = state.kf_ids  # (K, N)
    obs_ok = (ids >= 0) & state.kf_active[:, None] & state.kf_kpt_valid
    pt = state.pt_pos[jnp.where(ids >= 0, ids, 0)]  # (K, N, 3)
    R = state.kf_pose[:, :3, :3]
    t = state.kf_pose[:, :3, 3]
    cam_pts = jnp.einsum("kij,knj->kni", R, pt) + t[:, None, :]
    uv = cam.project(cam_pts)
    r = uv - state.kf_xy
    chi2 = jnp.sum(r * r, -1)
    sigma2 = jnp.exp(
        2.0 * state.kf_octave.astype(jnp.float32) * jnp.log(jnp.float32(1.2))
    )
    chi2 = chi2 / sigma2
    obs_ok = obs_ok & (cam_pts[..., 2] > 0)
    total = jnp.sum(jnp.where(obs_ok, chi2, 0.0))
    count = jnp.sum(obs_ok)
    return total / jnp.maximum(count, 1)


@jax.jit
def op_update_point_stats(
    state: MapState, scale_factor: jnp.ndarray, n_levels: jnp.ndarray
) -> MapState:
    """Refresh per-point viewing normals, scale-invariance bounds and the
    representative descriptor from the current observation set.

    Counterpart of MapPoint::updateNormals/updateBestObservation semantics
    (mappoint.h; the reference refreshes after BA via
    updatePointNormalAndDistances, globaloptimizer_g2o.cpp:466-537 region).
    Representative descriptor := the most recent observing keyframe's
    descriptor (cheap stand-in for the min-median-distance medoid).
    """
    K, N, P = state.K, state.N, state.P
    ids = jnp.where(
        state.kf_active[:, None] & state.kf_kpt_valid & (state.kf_ids >= 0),
        state.kf_ids,
        P,
    )  # (K, N) -> P = trash row
    flat_ids = ids.reshape(-1)
    R = state.kf_pose[:, :3, :3]
    t = state.kf_pose[:, :3, 3]
    centers = -jnp.einsum("kji,kj->ki", R, t)  # (K, 3)
    X = state.pt_pos[jnp.where(flat_ids < P, flat_ids, 0)]  # (K*N, 3)
    cen = jnp.repeat(centers, N, axis=0)  # (K*N, 3)
    ray = X - cen
    dist = jnp.linalg.norm(ray, axis=-1).clip(1e-9)
    dirn = ray / dist[:, None]

    sum_dir = jnp.zeros((P + 1, 3)).at[flat_ids].add(dirn)
    cnt = jnp.zeros((P + 1,)).at[flat_ids].add(1.0)
    normal = sum_dir[:P] / cnt[:P, None].clip(1.0)
    nrm = jnp.linalg.norm(normal, axis=-1, keepdims=True)
    normal = jnp.where(nrm > 1e-6, normal / nrm.clip(1e-9), state.pt_normal)

    oct_flat = state.kf_octave.reshape(-1).astype(jnp.float32)
    log_sf = jnp.log(scale_factor)
    max_cand = dist * jnp.exp(oct_flat * log_sf)
    max_d = jnp.full((P + 1,), -1e9).at[flat_ids].max(max_cand)
    levels_span = jnp.exp((n_levels.astype(jnp.float32) - 1.0) * log_sf)
    has_obs = cnt[:P] > 0
    new_max = jnp.where(has_obs, max_d[:P], state.pt_max_dist)
    new_min = jnp.where(has_obs, new_max / levels_span, state.pt_min_dist)

    # representative descriptor: observation from the most recent keyframe
    fseq_flat = jnp.repeat(state.kf_fseq, N)
    best_seq = jnp.full((P + 1,), -1, jnp.int32).at[flat_ids].max(fseq_flat)
    is_best = (fseq_flat == best_seq[jnp.where(flat_ids < P, flat_ids, P)]) & (
        flat_ids < P
    )
    desc_flat = state.kf_desc.reshape(-1, 8)
    tgt = jnp.where(is_best, flat_ids, P)
    new_desc = jnp.zeros((P + 1, 8), jnp.uint32).at[tgt].max(desc_flat)
    new_desc = jnp.where(has_obs[:, None], new_desc[:P], state.pt_desc)

    return state._replace(
        pt_normal=jnp.where(state.pt_active[:, None], normal, state.pt_normal),
        pt_max_dist=jnp.where(state.pt_active, new_max, state.pt_max_dist),
        pt_min_dist=jnp.where(state.pt_active, new_min, state.pt_min_dist),
        pt_desc=jnp.where(state.pt_active[:, None], new_desc, state.pt_desc),
    )


@jax.jit
def op_bump_point_stats(
    state: MapState, vis_mask: jnp.ndarray, seen_mask: jnp.ndarray
) -> MapState:
    """Increment per-point visible/seen counters (MapPoint statistics,
    mappoint.h:73-74). Masks come from a tracking step; applied by the
    single map writer so async tracking never races the mapper."""
    return state._replace(
        pt_n_visible=state.pt_n_visible + vis_mask.astype(jnp.int32),
        pt_n_seen=state.pt_n_seen + seen_mask.astype(jnp.int32),
    )


@jax.jit
def op_apply_transform(state: MapState, T: jnp.ndarray) -> MapState:
    """Rigidly transform the whole map by T (global' = T @ global)
    (counterpart Map::applyTransform)."""
    R = T[:3, :3]
    t = T[:3, 3]
    new_pos = state.pt_pos @ R.T + t
    new_normal = state.pt_normal @ R.T
    T_inv = jnp.linalg.inv(T)
    new_kf_pose = state.kf_pose @ T_inv
    new_mk_pose = T @ state.mk_pose
    return state._replace(
        pt_pos=new_pos, pt_normal=new_normal, kf_pose=new_kf_pose, mk_pose=new_mk_pose
    )


@jax.jit
def op_scale_map(state: MapState, scale: jnp.ndarray) -> MapState:
    """Scale world (positions, translations, depths) by `scale`."""
    kf_pose = state.kf_pose.at[:, :3, 3].multiply(scale)
    mk_pose = state.mk_pose.at[:, :3, 3].multiply(scale)
    return state._replace(
        pt_pos=state.pt_pos * scale,
        pt_min_dist=state.pt_min_dist * scale,
        pt_max_dist=state.pt_max_dist * scale,
        kf_pose=kf_pose,
        kf_depth=state.kf_depth * scale,
        mk_pose=mk_pose,
    )


# ----------------------------------------------------------------------
# Host wrapper
# ----------------------------------------------------------------------


class Map:
    """Host-side owner of MapState + slot arenas.

    Mirrors the reference Map mutation API (map.h:86-92). All methods are
    eager (sequential mode); batched jitted ops do the heavy lifting.
    """

    def __init__(self, params: Params | None = None):
        self.params = params or Params()
        self._host_cache: dict = {}
        self.state = empty_map_state(self.params)
        self.points = Arena(self.params.maxMapPoints)
        self.keyframes = Arena(self.params.maxKeyFrames)
        self.markers = Arena(self.params.maxMarkers)

    # -- host mirror ----------------------------------------------------
    # The canonical state lives on device; host-side orchestration reads
    # small summaries of it constantly (keyframe policy, culling, covis
    # walks). Every np.asarray(state.x) is a device round trip, so
    # fetched fields are cached until the next state write (any
    # assignment to .state invalidates).

    @property
    def state(self) -> MapState:
        return self._state

    @state.setter
    def state(self, v: MapState) -> None:
        self._state = v
        self._host_cache.clear()

    def h(self, *names: str):
        """Cached host-numpy views of state fields; one bundled transfer
        for all missing names. `map.h('pt_active')` or
        `a, b = map.h('pt_active', 'kf_pose')`."""
        missing = [n for n in names if n not in self._host_cache]
        if missing:
            import jax

            vals = jax.device_get([getattr(self._state, n) for n in missing])
            for n, v in zip(missing, vals):
                self._host_cache[n] = v
        if len(names) == 1:
            return self._host_cache[names[0]]
        return tuple(self._host_cache[n] for n in names)

    # -- capacity growth ------------------------------------------------
    # XLA needs static shapes, so the arenas are fixed-capacity arrays —
    # but a long sequence must not starve (SURVEY §5 map-size scaling).
    # Doubling re-pads every affected array; jitted ops recompile once per
    # capacity bucket (log2 growth ⇒ a handful of compiles per run).

    def grow_points(self, new_P: int | None = None) -> int:
        P = self.state.P
        new_P = new_P or 2 * P
        if new_P <= P:
            return P
        st = self.state

        def pad(a, fill=0):
            ext = [(0, new_P - P)] + [(0, 0)] * (a.ndim - 1)
            return jnp.pad(a, ext, constant_values=fill)

        self.state = st._replace(
            pt_pos=pad(st.pt_pos),
            pt_normal=pad(st.pt_normal),
            pt_desc=pad(st.pt_desc),
            pt_min_dist=pad(st.pt_min_dist),
            pt_max_dist=pad(st.pt_max_dist, fill=1e9),
            pt_flags=pad(st.pt_flags),
            pt_n_seen=pad(st.pt_n_seen),
            pt_n_visible=pad(st.pt_n_visible),
            pt_creation_kf=pad(st.pt_creation_kf),
            pt_active=pad(st.pt_active, fill=False),
        )
        self.points.grow(new_P)
        self.params = self.params.replace(maxMapPoints=new_P)
        return new_P

    def grow_keyframes(self, new_K: int | None = None) -> int:
        K = self.state.K
        new_K = new_K or 2 * K
        if new_K <= K:
            return K
        st = self.state

        def pad(a, fill=0):
            ext = [(0, new_K - K)] + [(0, 0)] * (a.ndim - 1)
            return jnp.pad(a, ext, constant_values=fill)

        eye_tail = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (new_K - K, 4, 4))
        self.state = st._replace(
            kf_pose=jnp.concatenate([st.kf_pose, eye_tail]),
            kf_fseq=pad(st.kf_fseq, fill=-1),
            kf_active=pad(st.kf_active, fill=False),
            kf_xy=pad(st.kf_xy),
            kf_octave=pad(st.kf_octave),
            kf_desc=pad(st.kf_desc),
            kf_depth=pad(st.kf_depth),
            kf_kpt_valid=pad(st.kf_kpt_valid, fill=False),
            kf_ids=pad(st.kf_ids, fill=-1),
            kf_mk_slot=pad(st.kf_mk_slot, fill=-1),
            kf_mk_corners=pad(st.kf_mk_corners),
        )
        self.keyframes.grow(new_K)
        self.params = self.params.replace(maxKeyFrames=new_K)
        return new_K

    # -- keyframes ------------------------------------------------------
    def add_keyframe(self, frame: Frame) -> int:
        from ucoslam_tpu.mapping.frame import strip_markers

        slot = self.keyframes.alloc()
        self.state = op_add_keyframe(
            self.state, jnp.int32(slot), strip_markers(frame)
        )
        return slot

    def remove_keyframes(self, slots) -> None:
        mask = np.zeros(self.state.K, bool)
        mask[np.asarray(slots, int)] = True
        self.state = op_remove_keyframes(self.state, jnp.asarray(mask))
        self.keyframes.free(slots)

    # -- points ---------------------------------------------------------
    def add_points(
        self, pos, normal, desc, min_dist, max_dist, flags, creation_kf: int, use=None
    ) -> np.ndarray:
        """Allocate + write up to B points; returns slot ids (-1 for unused)."""
        pos = np.asarray(pos)
        b = len(pos)
        use = np.ones(b, bool) if use is None else np.asarray(use, bool)
        n_new = int(use.sum())
        slots_alloc = self.points.alloc_many(n_new)
        slots = np.full(b, -1, np.int32)
        slots[use] = slots_alloc
        self.state = op_add_points(
            self.state,
            jnp.asarray(np.where(use, slots, 0).astype(np.int32)),
            jnp.asarray(use),
            jnp.asarray(pos, jnp.float32),
            jnp.asarray(normal, jnp.float32),
            jnp.asarray(desc, jnp.uint32),
            jnp.asarray(min_dist, jnp.float32),
            jnp.asarray(max_dist, jnp.float32),
            jnp.asarray(flags, jnp.int32),
            jnp.int32(creation_kf),
        )
        return slots

    def remove_points(self, slots_or_mask) -> None:
        mask = np.zeros(self.state.P, bool)
        arr = np.asarray(slots_or_mask)
        if arr.dtype == bool:
            mask = arr
        else:
            mask[arr.astype(int)] = True
        self.state = op_remove_points(self.state, jnp.asarray(mask))
        self.points.free(np.nonzero(mask)[0])

    def set_observations(self, kf_slot: int, kpt_idx, point_ids) -> None:
        self.state = op_set_observations(
            self.state,
            jnp.int32(kf_slot),
            jnp.asarray(kpt_idx, jnp.int32),
            jnp.asarray(point_ids, jnp.int32),
        )

    # -- queries --------------------------------------------------------
    @property
    def n_points(self) -> int:
        return self.points.n_active

    @property
    def n_keyframes(self) -> int:
        return self.keyframes.n_active

    def covis_matrix(self) -> np.ndarray:
        if "covis_matrix" not in self._host_cache:
            self._host_cache["covis_matrix"] = np.asarray(
                op_covis_matrix(self.state)
            )
        return self._host_cache["covis_matrix"]

    def essential_graph(self, min_weight: int = 15) -> list[tuple[int, int, float]]:
        """Essential graph over active keyframes: the MAXIMUM spanning tree
        of the covisibility graph (Kruskal, counterpart CovisGraph::getEG,
        covisgraph.cpp:253-289) plus every edge at/above `min_weight`.

        Disconnected covis components are bridged by temporal-adjacency
        edges of weight 1 so the result always spans (the reference asserts
        connectivity; our maps can fragment after aggressive culling).
        Returns (slot_a, slot_b, weight) with slot_a < slot_b.
        """
        slots = self.keyframes.active_slots()
        K = len(slots)
        if K < 2:
            return []
        covis = self.covis_matrix()
        fseq = np.asarray(self.state.kf_fseq)[slots]
        order = np.argsort(fseq)
        # candidate edges from the covis matrix, vectorized (no K^2 loop)
        sub = covis[np.ix_(slots, slots)]
        ia, ib = np.nonzero(np.triu(sub, 1) > 0)
        cand: dict[tuple[int, int], float] = {
            (int(slots[x]), int(slots[y])): float(sub[x, y])
            for x, y in zip(ia, ib)
        }
        # weight-1 temporal bridges guarantee a spanning forest -> tree
        for x, y in zip(order[:-1], order[1:]):
            a, b = sorted((int(slots[x]), int(slots[y])))
            cand.setdefault((a, b), 1.0)

        parent = {int(s): int(s) for s in slots}

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        edges: list[tuple[int, int, float]] = []
        for (a, b), w in sorted(cand.items(), key=lambda kv: -kv[1]):
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[rb] = ra
                edges.append((a, b, w))
        # strong covisibility edges join the tree (reference correctMap uses
        # EG + high-covis links for the Sim3 relax)
        tree = {(a, b) for a, b, _ in edges}
        for (a, b), w in cand.items():
            if w >= min_weight and (a, b) not in tree:
                edges.append((a, b, w))
        return edges

    def point_observation_counts(self) -> np.ndarray:
        if "point_obs_counts" not in self._host_cache:
            self._host_cache["point_obs_counts"] = np.asarray(
                op_point_observation_counts(self.state)
            )
        return self._host_cache["point_obs_counts"]

    def global_reproj_chi2(self, cam: CameraParams) -> float:
        return float(_global_reproj_chi2_impl(self.state, cam))

    def reference_keyframe(self, frame_pose: np.ndarray) -> int:
        """Closest active keyframe by translation (getReferenceKeyFrame)."""
        act = self.keyframes.active_slots()
        if len(act) == 0:
            return -1
        poses = self.h("kf_pose")[act]
        centers = -np.einsum("kji,kj->ki", poses[:, :3, :3], poses[:, :3, 3])
        Rf = frame_pose[:3, :3]
        cf = -Rf.T @ frame_pose[:3, 3]
        d = np.linalg.norm(centers - cf, axis=1)
        return int(act[int(np.argmin(d))])

    def apply_transform(self, T) -> None:
        self.state = op_apply_transform(self.state, jnp.asarray(T, jnp.float32))

    def center_ref_system_in_marker(self, marker_id: int) -> bool:
        """Re-anchor the map's reference system at a marker
        (counterpart Map::centerRefSystemInMarker, map.cpp:302:
        applyTransform(pose_g2m^-1)): the marker becomes the world origin.
        Returns True when the marker exists with a valid pose (the
        reference's C++ quirkily returns false even on success)."""
        mk_id, mk_valid = self.h("mk_id", "mk_pose_valid")
        hits = np.nonzero((mk_id == marker_id) & mk_valid)[0]
        if len(hits) == 0:
            return False
        g2m = self.h("mk_pose")[hits[0]]
        self.apply_transform(np.linalg.inv(g2m).astype(np.float32))
        return True

    def bump_point_stats(self, vis_mask, seen_mask) -> None:
        # targeted invalidation: this runs every tracked frame and only
        # touches the two counter fields — wiping the whole host mirror
        # would force the per-frame signature to refetch ~800KB
        self._state = op_bump_point_stats(self.state, vis_mask, seen_mask)
        self._host_cache.pop("pt_n_seen", None)
        self._host_cache.pop("pt_n_visible", None)

    def scale(self, s: float) -> None:
        self.state = op_scale_map(self.state, jnp.float32(s))

    def frame_median_depth(self, kf_slot: int) -> float:
        """Median depth of the points a keyframe observes
        (counterpart Map::getFrameMedianDepth)."""
        kf_ids, kf_pose, pt_pos = self.h("kf_ids", "kf_pose", "pt_pos")
        ids = kf_ids[kf_slot]
        obs = ids[ids >= 0]
        if len(obs) == 0:
            return 1.0
        T = kf_pose[kf_slot]
        pts = pt_pos[obs]
        z = (pts @ T[:3, :3].T + T[:3, 3])[:, 2]
        return float(np.median(z))

    def remove_unused_keypoints(self) -> int:
        """Invalidate keyframe keypoints with no map-point assignment
        (counterpart utils/ucoslam_map_removeunusedkeypoint, map.h:61).
        Shrinks matching work and serialized size. Returns #removed."""
        st = self.state
        used = st.kf_kpt_valid & (st.kf_ids >= 0)
        removed = int(np.asarray(st.kf_kpt_valid).sum() - np.asarray(used).sum())
        self.state = st._replace(kf_kpt_valid=used)
        return removed

    # -- export (map.h:65 pcd/ply) --------------------------------------
    def export_pointcloud(self, path: str, with_keyframes: bool = True) -> None:
        """Write active points (+ keyframe centers) as ascii PLY or PCD."""
        st = self.state
        pts = np.asarray(st.pt_pos)[np.asarray(st.pt_active)]
        colors = np.tile(np.asarray([[90, 200, 90]], np.uint8), (len(pts), 1))
        if with_keyframes:
            kf_act = np.asarray(st.kf_active)
            poses = np.asarray(st.kf_pose)[kf_act]
            centers = (
                np.stack([-P[:3, :3].T @ P[:3, 3] for P in poses])
                if len(poses)
                else np.zeros((0, 3))
            )
            pts = np.concatenate([pts, centers])
            colors = np.concatenate(
                [colors, np.tile(np.asarray([[240, 120, 80]], np.uint8), (len(centers), 1))]
            )
        if path.endswith(".pcd"):
            with open(path, "w") as f:
                f.write(
                    "# .PCD v0.7 - Point Cloud Data\nVERSION 0.7\n"
                    "FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
                    f"WIDTH {len(pts)}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
                    f"POINTS {len(pts)}\nDATA ascii\n"
                )
                for p in pts:
                    f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        else:
            with open(path, "w") as f:
                f.write(
                    "ply\nformat ascii 1.0\n"
                    f"element vertex {len(pts)}\n"
                    "property float x\nproperty float y\nproperty float z\n"
                    "property uchar red\nproperty uchar green\nproperty uchar blue\n"
                    "end_header\n"
                )
                for p, c in zip(pts, colors):
                    f.write(
                        f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {c[0]} {c[1]} {c[2]}\n"
                    )

    # -- integrity ------------------------------------------------------
    def check_consistency(self) -> None:
        """Invariant sweep (counterpart Map::checkConsistency map.cpp:376)."""
        st = self.state
        ids = np.asarray(st.kf_ids)
        kf_active = np.asarray(st.kf_active)
        pt_active = np.asarray(st.pt_active)
        assert (kf_active == self.keyframes.active).all(), "kf arena desync"
        assert (pt_active == self.points.active).all(), "pt arena desync"
        obs = ids[kf_active]
        obs = obs[obs >= 0]
        if len(obs):
            assert pt_active[obs].all(), "observation of inactive point"

    def signature(self) -> int:
        """Deterministic content hash (counterpart Map::getSignature map.cpp:355).

        Hashes the quantized active content in slot order; identical
        logical maps produce identical signatures across runs.
        """
        h = hashlib.blake2b(digest_size=8)
        # through the host mirror: the map only mutates at keyframe rate,
        # so per-frame signature printing costs no device traffic between
        # keyframes (~800KB of fetches per call otherwise)
        fields = self.h(
            "pt_pos", "pt_active", "kf_pose", "kf_active", "kf_ids",
            "mk_id", "mk_pose",
        )
        for a, quant in zip(fields, (1e4, None, 1e4, None, None, None, 1e4)):
            if quant is not None:
                a = np.round(a.astype(np.float64) * quant).astype(np.int64)
            h.update(a.tobytes())
        return int.from_bytes(h.digest(), "little")
