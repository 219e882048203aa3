"""Map data model: fixed-capacity struct-of-arrays of torch tensors.

Port of ``dialog_tpu/containers.py``. The stores are NamedTuples of tensors with
the reference's field names, shapes and dtypes, except that the 256-bit
descriptors are ``int32`` bit-casts of the reference's ``uint32`` words
(torch has no uint32 popcount or shift on the CPU). Every update returns a
new ``MapState`` whose changed fields are fresh tensors, so callers may keep
old states, as with the reference's immutable pytrees.

Observation bookkeeping: ``KeyframeStore.obs_lm`` (per keyframe, per feature
landmark id, -1 = none) is the single source of truth; per-landmark
observation counts and the covisibility matrix derive from it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import ops
from .config import EngineConfig

INVALID_ID = -1


class FrameArrays(NamedTuple):
    """One frame's features. Capacity F = cfg.max_features."""

    uv: torch.Tensor        # f32[F, 2]  undistorted pixel coords
    uv_raw: torch.Tensor    # f32[F, 2]  raw (distorted) pixel coords
    response: torch.Tensor  # f32[F]
    octave: torch.Tensor    # i32[F]     pyramid level
    angle: torch.Tensor     # f32[F]     orientation (radians)
    desc: torch.Tensor      # i32[F, 8]  256-bit descriptor (u32 bit-cast)
    valid: torch.Tensor     # bool[F]
    u_right: torch.Tensor   # f32[F]     stereo right-x; <0 = monocular feature
    depth: torch.Tensor     # f32[F]     metric depth; <=0 = unknown


class KeyframeStore(NamedTuple):
    """All keyframes. K = cfg.max_keyframes, F = cfg.max_features."""

    R: torch.Tensor          # f32[K, 3, 3]  world->camera rotation
    t: torch.Tensor          # f32[K, 3]
    uv: torch.Tensor         # f32[K, F, 2]
    desc: torch.Tensor       # i32[K, F, 8]
    octave: torch.Tensor     # i32[K, F]
    angle: torch.Tensor      # f32[K, F]
    u_right: torch.Tensor    # f32[K, F]
    depth: torch.Tensor      # f32[K, F]
    feat_valid: torch.Tensor # bool[K, F]
    obs_lm: torch.Tensor     # i32[K, F]   landmark id per feature (-1 = none)
    valid: torch.Tensor      # bool[K]     alive keyframes
    frame_id: torch.Tensor   # i32[K]      source frame index
    timestamp: torch.Tensor  # f32[K]
    parent: torch.Tensor     # i32[K]      spanning-tree parent (-1 = root)
    seq: torch.Tensor        # i32[K]      monotonic insertion number
    cull_parent: torch.Tensor  # i32[K]    parent at cull time (-1 = never culled)
    cull_seq: torch.Tensor     # i32[K]    seq of the culled KF (stale-slot guard)
    cull_R: torch.Tensor       # f32[K, 3, 3]  R of T_rp at cull time
    cull_t: torch.Tensor       # f32[K, 3]     t of T_rp at cull time


class LandmarkStore(NamedTuple):
    """All landmarks. L = cfg.max_landmarks."""

    xyz: torch.Tensor        # f32[L, 3]
    desc: torch.Tensor       # i32[L, 8]
    normal: torch.Tensor     # f32[L, 3]   mean viewing direction
    dmin: torch.Tensor       # f32[L]      scale-invariance distance band
    dmax: torch.Tensor       # f32[L]
    ref_kf: torch.Tensor     # i32[L]      creating keyframe slot
    first_seq: torch.Tensor  # i32[L]      creating keyframe's insertion number
    n_obs: torch.Tensor      # i32[L]
    n_visible: torch.Tensor  # i32[L]
    n_found: torch.Tensor    # i32[L]
    valid: torch.Tensor      # bool[L]


class MapState(NamedTuple):
    kfs: KeyframeStore
    lms: LandmarkStore
    covis: torch.Tensor      # i32[K, K]  shared-landmark counts
    num_kfs: torch.Tensor    # i32 scalar: keyframes ever allocated (high-water)
    num_lms: torch.Tensor    # i32 scalar
    lm_dropped: torch.Tensor # i32 scalar: landmark candidates dropped (freelist empty)


def empty_map(cfg: EngineConfig, device="cuda") -> MapState:
    K, F, L = cfg.max_keyframes, cfg.max_features, cfg.max_landmarks
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    eye = torch.eye(3, **f32).expand(K, 3, 3).clone()
    kfs = KeyframeStore(
        R=eye,
        t=torch.zeros((K, 3), **f32),
        uv=torch.zeros((K, F, 2), **f32),
        desc=torch.zeros((K, F, 8), **i32),
        octave=torch.zeros((K, F), **i32),
        angle=torch.zeros((K, F), **f32),
        u_right=-torch.ones((K, F), **f32),
        depth=-torch.ones((K, F), **f32),
        feat_valid=torch.zeros((K, F), dtype=torch.bool, device=device),
        obs_lm=torch.full((K, F), INVALID_ID, **i32),
        valid=torch.zeros((K,), dtype=torch.bool, device=device),
        frame_id=torch.full((K,), INVALID_ID, **i32),
        timestamp=torch.zeros((K,), **f32),
        parent=torch.full((K,), INVALID_ID, **i32),
        seq=torch.full((K,), INVALID_ID, **i32),
        cull_parent=torch.full((K,), INVALID_ID, **i32),
        cull_seq=torch.full((K,), INVALID_ID, **i32),
        cull_R=eye.clone(),
        cull_t=torch.zeros((K, 3), **f32),
    )
    lms = LandmarkStore(
        xyz=torch.zeros((L, 3), **f32),
        desc=torch.zeros((L, 8), **i32),
        normal=torch.zeros((L, 3), **f32),
        dmin=torch.zeros((L,), **f32),
        dmax=torch.full((L,), float("inf"), **f32),
        ref_kf=torch.full((L,), INVALID_ID, **i32),
        first_seq=torch.full((L,), INVALID_ID, **i32),
        n_obs=torch.zeros((L,), **i32),
        n_visible=torch.zeros((L,), **i32),
        n_found=torch.zeros((L,), **i32),
        valid=torch.zeros((L,), dtype=torch.bool, device=device),
    )
    z = torch.zeros((), **i32)
    return MapState(
        kfs=kfs, lms=lms, covis=torch.zeros((K, K), **i32),
        num_kfs=z, num_lms=z.clone(), lm_dropped=z.clone(),
    )


# ---------------------------------------------------------------------------
# Allocation helpers
# ---------------------------------------------------------------------------


def first_free_kf_slot(m: MapState) -> torch.Tensor:
    """Index of the first dead keyframe slot (all alive -> 0, as the reference)."""
    return torch.argmin(m.kfs.valid.to(torch.int32))


def free_lm_slots(m: MapState, n: int) -> torch.Tensor:
    """First ``n`` free landmark slots, padded with L-1 (mask by lm_capacity_left)."""
    L = m.lms.valid.shape[0]
    return ops.nonzero_fixed(~m.lms.valid, n, L - 1).to(torch.int32)


def lm_capacity_left(m: MapState) -> torch.Tensor:
    return torch.sum(~m.lms.valid).to(torch.int32)


# ---------------------------------------------------------------------------
# Keyframe bookkeeping snapshot
# ---------------------------------------------------------------------------


def pack_map_meta(m: MapState) -> torch.Tensor:
    """Keyframe bookkeeping as ONE f32 vector (layout of the reference)."""
    K = m.kfs.valid.shape[0]
    f = torch.float32
    return torch.cat(
        [
            m.kfs.valid.to(f),
            m.kfs.parent.to(f),
            m.kfs.seq.to(f),
            m.kfs.R.reshape(K * 9),
            m.kfs.t.reshape(K * 3),
            m.kfs.cull_parent.to(f),
            m.kfs.cull_seq.to(f),
            m.kfs.cull_R.reshape(K * 9),
            m.kfs.cull_t.reshape(K * 3),
            m.lm_dropped.to(f).reshape(1),
        ]
    )


def map_meta_len(K: int) -> int:
    """Length of ``pack_map_meta``'s vector at K keyframe slots."""
    return 29 * K + 1


class MapMeta:
    """Host-side view of pack_map_meta (one attribute per packed field)."""

    __slots__ = (
        "valid", "parent", "seq", "R", "t",
        "cull_parent", "cull_seq", "cull_R", "cull_t", "lm_dropped",
    )

    def __init__(self, meta, K: int):
        if isinstance(meta, torch.Tensor):
            meta = meta.detach().cpu().numpy()
        meta = np.asarray(meta)
        self.valid = meta[:K] > 0.5
        self.parent = meta[K : 2 * K].astype(np.int32)
        self.seq = meta[2 * K : 3 * K].astype(np.int32)
        self.R = meta[3 * K : 12 * K].reshape(K, 3, 3)
        self.t = meta[12 * K : 15 * K].reshape(K, 3)
        self.cull_parent = meta[15 * K : 16 * K].astype(np.int32)
        self.cull_seq = meta[16 * K : 17 * K].astype(np.int32)
        self.cull_R = meta[17 * K : 26 * K].reshape(K, 3, 3)
        self.cull_t = meta[26 * K : 29 * K].reshape(K, 3)
        self.lm_dropped = int(meta[29 * K])


def parse_map_meta(meta, K: int):
    """Host-side inverse of pack_map_meta -> (valid, parent, seq, R, t)."""
    mm = MapMeta(meta, K)
    return mm.valid, mm.parent, mm.seq, mm.R, mm.t


# ---------------------------------------------------------------------------
# Covisibility maintenance
# ---------------------------------------------------------------------------


def covis_row_for_kf(m: MapState, k) -> torch.Tensor:
    """weight[j] = #landmarks observed by both k and j (i32[K], weight[k] = 0)."""
    L = m.lms.xyz.shape[0]
    obs_k = m.kfs.obs_lm[k]
    ok = (obs_k >= 0) & m.kfs.feat_valid[k]
    mark = torch.zeros((L + 1,), dtype=torch.int32, device=obs_k.device)
    mark = ops.scatter_set(mark, torch.where(ok, obs_k, L), 1)[:L]
    all_obs = m.kfs.obs_lm
    hits = torch.where(
        (all_obs >= 0) & m.kfs.feat_valid,
        mark[all_obs.clamp(0, L - 1).long()],
        0,
    )
    w = hits.sum(1).to(torch.int32)
    w = torch.where(m.kfs.valid, w, 0)
    return ops.scatter_set(w, torch.as_tensor(k, device=w.device).reshape(1), 0)


def update_covis_for_kf(m: MapState, k) -> MapState:
    w = covis_row_for_kf(m, k)
    covis = m.covis.clone()
    covis[k, :] = w
    covis[:, k] = w
    return m._replace(covis=covis)


def recount_lm_obs(m: MapState) -> MapState:
    """Recompute per-landmark observation counts from obs_lm."""
    L = m.lms.xyz.shape[0]
    obs = m.kfs.obs_lm
    ok = (obs >= 0) & m.kfs.feat_valid & m.kfs.valid[:, None]
    flat = torch.where(ok, obs, L).reshape(-1)
    counts = ops.scatter_add(
        torch.zeros((L,), dtype=torch.int32, device=obs.device), flat, 1
    )
    return m._replace(lms=m.lms._replace(n_obs=counts))


def permute_landmarks(m: MapState, perm: torch.Tensor) -> MapState:
    """The same map with its landmark slots renumbered: new slot j holds old
    landmark ``perm[j]`` (``perm`` a permutation of the L slots), and every
    keyframe's ``obs_lm`` follows. The engine fills slots from the bottom,
    so a global problem's live landmarks sit in its first rows; a random
    ``perm`` spreads them over the ranks of a sharded solve."""
    L = m.lms.xyz.shape[0]
    perm = perm.to(device=m.lms.xyz.device, dtype=torch.int64)
    new_of_old = torch.empty_like(perm)
    new_of_old[perm] = torch.arange(L, device=perm.device)
    obs = m.kfs.obs_lm
    obs_new = torch.where(obs >= 0, new_of_old[obs.clamp(min=0).long()].to(obs.dtype), obs)
    return m._replace(kfs=m.kfs._replace(obs_lm=obs_new), lms=LandmarkStore(*[x[perm] for x in m.lms]))


# ---------------------------------------------------------------------------
# Checkpoint: the reference's npz format (leaves in NamedTuple order,
# descriptors stored as uint32), so either package loads the other's maps
# ---------------------------------------------------------------------------


def _leaves(m: MapState) -> list:
    return list(m.kfs) + list(m.lms) + [m.covis, m.num_kfs, m.num_lms, m.lm_dropped]


def _from_leaves(leaves: list) -> MapState:
    nk, nl = len(KeyframeStore._fields), len(LandmarkStore._fields)
    kfs = KeyframeStore(*leaves[:nk])
    lms = LandmarkStore(*leaves[nk : nk + nl])
    return MapState(kfs, lms, *leaves[nk + nl :])


def save_map(m: MapState, path: str) -> None:
    from .interop import tensor_to_numpy

    np.savez_compressed(path, *[tensor_to_numpy(x, name) for x, name in _named_leaves(m)])


def _named_leaves(m: MapState):
    names = (
        [f"kfs.{f}" for f in KeyframeStore._fields]
        + [f"lms.{f}" for f in LandmarkStore._fields]
        + ["covis", "num_kfs", "num_lms", "lm_dropped"]
    )
    return list(zip(_leaves(m), names))


def load_map(cfg: EngineConfig, path: str, device="cuda") -> MapState:
    from .interop import numpy_to_tensor

    template = _named_leaves(empty_map(cfg, device="meta"))
    with np.load(path) as data:
        arrs = [data[k] for k in data.files]
    if len(arrs) != len(template):
        raise ValueError(
            f"checkpoint has {len(arrs)} arrays, expected {len(template)} "
            "(capacity/config mismatch?)"
        )
    out = []
    for i, (got, (want, name)) in enumerate(zip(arrs, template)):
        if tuple(got.shape) != tuple(want.shape):
            raise ValueError(
                f"checkpoint array {i} has shape {got.shape}, expected "
                f"{tuple(want.shape)} (capacity/config mismatch?)"
            )
        out.append(numpy_to_tensor(got, want.dtype, device))
    return _from_leaves(out)
