"""The projection search's glue around kernel B (CUDA: ``csrc/project.cu``).

``project_gate`` gathers the landmarks of ``ids`` and projects them into a
pose: the descriptor, the predicted pixel and octave, the visibility gate
(with ``frustum`` the isInFrustum gate too) and the octave-scaled search
radius squared that kernel B takes, all in one launch. Given the frame's
current ``lm_of_feat`` (the local-map search), it also drops the landmarks a
feature already holds from the gate, returns the frustum's verdict with them
put back (``seen``), and marks the features still free. ``invert_matches``
turns kernel B's per-landmark matches into the per-feature landmark id and
its count, optionally under a prior association, in one launch. Their plain
versions, ``project_gate_plain`` and ``invert_matches_plain``, are the same
steps in PyTorch; a wrapper given CPU tensors takes them. Neither replaces a
Pallas kernel: the JAX package leaves these steps to XLA inside the search.

The arithmetic is float32 in the plain version's order, each product and sum
rounded once; the logarithm and the power of the scale factor are the
device's, so a predicted octave or a gate may differ from the plain
version's where the value lies within rounding of a boundary.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import geometry as geo
from .. import ops
from ..containers import INVALID_ID
from . import common

MAX_SET_FEATURES = 16384   # the local-map form's features: its hash set (2 F slots) fits in 128 KB of shared memory


class Projection(NamedTuple):
    """What ``project_gate`` returns, sized like ``ids`` (``free`` like ``lm_of_feat``)."""

    desc: torch.Tensor     # i32[N, 8]
    uv: torch.Tensor       # f32[N, 2]
    octave: torch.Tensor   # i32[N]  predicted detection octave
    vis: torch.Tensor      # bool[N] open for kernel B
    radius2: torch.Tensor  # f32[N]  (radius * scale_factor ** octave) ** 2
    seen: torch.Tensor | None   # bool[N] the frustum's verdict with the held landmarks put back (with lm_of_feat)
    free: torch.Tensor | None   # bool[F] feat_valid & no landmark yet (with lm_of_feat)


def predict_scale(dist, dmax, scale_factor: float, n_levels: int):
    """Predicted detection octave from camera distance (MapPoint::PredictScale)."""
    ratio = torch.clamp(dmax / torch.clamp(dist, min=1e-6), min=1e-6)
    log_s = torch.log(ops.scalar(scale_factor, torch.float32, ratio.device))
    lvl = torch.ceil(torch.log(ratio) / log_s - 1e-4)
    return torch.clamp(lvl, 0, n_levels - 1).to(torch.int32)


def project_gate_plain(ids, xyz, desc, dmax, valid, R, t, fx, fy, cx, cy, width, height, scale_factor: float,
                       n_levels: int, radius: float, normal=None, dmin=None, view_cos_th: float = 0.5,
                       frustum: bool = False, lm_of_feat=None, feat_valid=None) -> Projection:
    L = xyz.shape[0]
    safe = torch.clamp(ids, 0, L - 1).long()
    ok = (ids >= 0) & (ids < L) & valid[safe]
    X = xyz[safe]
    dm = dmax[safe]
    uv, z = geo.project(R, t, X, fx, fy, cx, cy)
    inb = (uv[:, 0] >= 0) & (uv[:, 0] < width) & (uv[:, 1] >= 0) & (uv[:, 1] < height)
    cam_center = -R.T @ t
    ray = X - cam_center
    dist = torch.linalg.norm(ray, dim=-1)
    octave = predict_scale(dist, dm, scale_factor, n_levels)
    vis = ok & (z > 1e-3) & inb
    if frustum:
        cos_view = torch.sum(ray * normal[safe], dim=-1) / torch.clamp(dist, min=1e-9)
        vis = vis & (cos_view > view_cos_th) & (dist >= 0.8 * dmin[safe]) & (dist <= 1.2 * dm)
    r = radius * torch.pow(ops.scalar(scale_factor, torch.float32, uv.device), octave.to(torch.float32))
    seen = free = None
    if lm_of_feat is not None:
        already = torch.zeros((L + 1,), dtype=torch.bool, device=lm_of_feat.device)
        already = ops.scatter_set(already, torch.where(lm_of_feat >= 0, lm_of_feat, L), True)[:L][safe]
        seen = vis | already
        vis = vis & ~already
        free = feat_valid & (lm_of_feat < 0)
    return Projection(desc[safe], uv, octave, vis, r * r, seen, free)


def _gate_checks(ids, xyz, desc, dmax, valid, R, t, *, n_levels: int, normal=None, dmin=None,
                 frustum: bool = False, lm_of_feat=None, feat_valid=None, **_) -> int:
    """Raise on what ``project_gate_launch`` does not take; returns the
    local-map form's hash-set slots (a power of two, at least 2 F and 64),
    0 without ``lm_of_feat``."""
    dev, N, L = ids.device, ids.shape[0], xyz.shape[0]
    merge = lm_of_feat is not None
    F = lm_of_feat.shape[0] if merge else 0
    if L < 1:
        raise ValueError("project_gate: the landmark store has no slot")
    if n_levels < 1:
        raise ValueError(f"project_gate: n_levels is a count of levels, got {n_levels}")
    if F > MAX_SET_FEATURES:
        raise ValueError(f"project_gate: at most {MAX_SET_FEATURES} features in the local-map form, got {F}")
    if frustum and (normal is None or dmin is None):
        raise ValueError("project_gate: the frustum gate needs normal and dmin")
    if merge and feat_valid is None:
        raise ValueError("project_gate: lm_of_feat and feat_valid are given together")
    checks = [("ids", ids, torch.int32, (N,)), ("xyz", xyz, torch.float32, (L, 3)), ("desc", desc, torch.int32, (L, 8)),
              ("dmax", dmax, torch.float32, (L,)), ("valid", valid, torch.bool, (L,)),
              ("R", R, torch.float32, (3, 3)), ("t", t, torch.float32, (3,))]
    if frustum:
        checks += [("normal", normal, torch.float32, (L, 3)), ("dmin", dmin, torch.float32, (L,))]
    if merge:
        checks += [("lm_of_feat", lm_of_feat, torch.int32, (F,)), ("feat_valid", feat_valid, torch.bool, (F,))]
    for name, x, dt, shape in checks:
        common.require(x, name, dt, shape, dev)
    if desc.data_ptr() % 16:
        raise ValueError("desc: expected a tensor aligned to 16 bytes")
    return max(64, 1 << (2 * F - 1).bit_length()) if merge else 0


def project_gate(ids, xyz, desc, dmax, valid, R, t, fx, fy, cx, cy, width, height, scale_factor: float,
                 n_levels: int, radius: float, normal=None, dmin=None, view_cos_th: float = 0.5,
                 frustum: bool = False, lm_of_feat=None, feat_valid=None) -> Projection:
    """The landmarks ``ids`` i32[N] (outside [0, L): none) of the store
    (``xyz`` f32[L, 3], ``desc`` i32[L, 8], ``dmax`` f32[L], ``valid``
    bool[L]; with ``frustum`` also ``normal`` f32[L, 3] and ``dmin`` f32[L])
    projected through ``R`` f32[3, 3], ``t`` f32[3] (device tensors, never
    read by the host) and gated, with kernel B's search radius squared; with
    ``lm_of_feat`` i32[F] and ``feat_valid`` bool[F], the local-map form.
    On the card one launch, counted as ``project_gate``, into fresh tensors."""
    args = dict(fx=fx, fy=fy, cx=cx, cy=cy, width=width, height=height, scale_factor=scale_factor,
                n_levels=n_levels, radius=radius, normal=normal, dmin=dmin, view_cos_th=view_cos_th,
                frustum=frustum, lm_of_feat=lm_of_feat, feat_valid=feat_valid)
    if common.route(ids) == "cpu":
        return project_gate_plain(ids, xyz, desc, dmax, valid, R, t, **args)
    from .build import load

    slots = _gate_checks(ids, xyz, desc, dmax, valid, R, t, **args)
    dev, N, L = ids.device, ids.shape[0], xyz.shape[0]
    merge = lm_of_feat is not None
    F = lm_of_feat.shape[0] if merge else 0
    out_desc = torch.empty((N, 8), dtype=torch.int32, device=dev)
    uv = torch.empty((N, 2), dtype=torch.float32, device=dev)
    octave = torch.empty((N,), dtype=torch.int32, device=dev)
    vis = torch.empty((N,), dtype=torch.bool, device=dev)
    radius2 = torch.empty((N,), dtype=torch.float32, device=dev)
    seen = torch.empty((N,), dtype=torch.bool, device=dev) if merge else None
    free = torch.empty((F,), dtype=torch.bool, device=dev) if merge else None
    p = common.ptr
    err = load("project").project_gate_launch(
        p(ids), N, p(xyz), p(desc), p(dmax), p(valid), p(normal) if frustum else None, p(dmin) if frustum else None,
        L, p(R), p(t), float(fx), float(fy), float(cx), float(cy), float(width), float(height), float(scale_factor),
        int(n_levels), float(view_cos_th), float(radius), int(frustum), p(lm_of_feat) if merge else None,
        p(feat_valid) if merge else None, F, slots, p(out_desc), p(uv), p(octave), p(vis), p(radius2),
        p(seen) if merge else None, p(free) if merge else None, common.stream_ptr(dev))
    common.launches["project_gate"] += 1
    common.check(err, "project_gate")
    return Projection(out_desc, uv, octave, vis, radius2, seen, free)


def invert_matches_plain(match_ft, ids, F: int, L: int, prior=None):
    lm_of_feat = torch.full((F,), INVALID_ID, dtype=torch.int32, device=match_ft.device)
    tgt = torch.where(match_ft >= 0, match_ft, F)
    lm_of_feat = ops.scatter_set(lm_of_feat, tgt, torch.where(match_ft >= 0, ids, L).to(torch.int32))
    lm_of_feat = torch.where((lm_of_feat < 0) | (lm_of_feat >= L), INVALID_ID, lm_of_feat)
    if prior is not None:
        lm_of_feat = torch.where(prior >= 0, prior, lm_of_feat)
    return lm_of_feat, torch.sum((lm_of_feat >= 0).to(torch.int32))


def _invert_checks(match_ft, ids, F: int, L: int, prior) -> None:
    """Raise on what ``invert_matches_launch`` does not take."""
    dev, N = match_ft.device, match_ft.shape[0]
    if F < 0 or L < 1:
        raise ValueError(f"invert_matches: F and L are sizes, got {F} and {L}")
    checks = [("match_ft", match_ft, torch.int32, (N,)), ("ids", ids, torch.int32, (N,))]
    if prior is not None:
        checks.append(("prior", prior, torch.int32, (F,)))
    for name, x, dt, shape in checks:
        common.require(x, name, dt, shape, dev)


def invert_matches(match_ft, ids, F: int, L: int, prior=None):
    """(lm_of_feat i32[F] (-1 = none), n i64) from kernel B's ``match_ft``
    i32[N] over the landmarks ``ids`` i32[N]: feature f takes the id of the
    last row matched to it (rows matching outside [0, F) dropped; an id
    outside [0, L) gives none). With ``prior`` i32[F], the features it
    already holds keep their landmark. On the card one launch, counted as
    ``invert_matches``, into fresh tensors; nothing is read back."""
    if common.route(match_ft) == "cpu":
        return invert_matches_plain(match_ft, ids, F, L, prior)
    from .build import load

    _invert_checks(match_ft, ids, F, L, prior)
    dev, N = match_ft.device, match_ft.shape[0]
    out = torch.empty((F,), dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int64, device=dev)
    err = load("project").invert_matches_launch(
        common.ptr(match_ft), common.ptr(ids), N, int(F), int(L), common.ptr(prior) if prior is not None else None,
        common.ptr(out), common.ptr(count), common.stream_ptr(dev))
    common.launches["invert_matches"] += 1
    common.check(err, "invert_matches")
    return out, count
