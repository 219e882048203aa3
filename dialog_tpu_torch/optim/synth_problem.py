"""Synthetic BA problem generator (port of ``dialog_tpu/optim/synth_problem.py``).

Builds a ground-truth-known ``BAProblem``: cameras on an arc observing a box
of points, the poses (all but two gauge cameras) and the points perturbed.
The draws come from numpy in the reference's order, so the same seed gives
the reference's problem up to one f32 retraction. With ``stereo_frac > 0``
(and a config whose ``bf > 0``) that share of the observations also carries
the right-camera coordinate ``uR = u - bf/z``. ``chip_smoke.py`` takes its
seeded local-BA windows for kernel C's solve check from here.

``build_corridor_map`` builds a whole map at a given occupancy (the KITTI00
preset's capacities by default): keyframes along a straight corridor, each
making landmarks ahead of it and observing those of the keyframes just
before it, as ``tests/test_kitti_capacity.py`` builds it for the reference
(the same draws, so the same map), for ``chip_smoke.py``'s global-BA
capacity phase. ``perturb_block_local`` moves such a map off its truth
the way ``tests/test_block_ba.py``'s block-local corridor is moved, for
block bundle adjustment.

``make_pose_problem`` builds the inputs of one ``pose_optimization`` call
(motion-only BA, mono or stereo) with outliers, points behind the camera
and a start pose off the truth, for the pose LM kernel's checks on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``) and its CPU tests.

``make_projection_problem`` and ``make_match_problem`` build the inputs of
the projection search's glue kernels (``kernels/project.py``), with points
planted on and past every gate; ``projection_gates`` judges such a problem in
float64, for the kernels' checks on the card and the plain versions' CPU tests.

``make_pose_graph`` builds a seeded Sim3 pose graph of the engine's shape
(K keyframe slots, K tree + 4K covisibility + 1 loop edges): a ring of
keyframes whose states carry odometry and scale drift, closed by its loop
edge. It has no reference counterpart; the parity tests give the same
problem to both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import geometry as geo
from ..config import KITTI00, TUM1, EngineConfig
from ..containers import MapState, empty_map, recount_lm_obs
from .local_ba import BAProblem
from .pose_graph import PoseGraphProblem

FIXTURE_CFG = EngineConfig(
    max_local_kfs=8, max_fixed_kfs=4, max_local_lms=128, max_obs_per_lm=8
)


def make_problem(
    seed=0,
    n_cams=6,
    n_pts=100,
    noise_px=0.4,
    perturb=0.05,
    cfg: EngineConfig = FIXTURE_CFG,
    stereo_frac: float = 0.0,
    device="cuda",
):
    """Cameras on an arc looking at a point cloud; each point is seen by
    ``min(max_obs_per_lm, n_cams)`` cameras drawn at random.

    Returns ``(prob, Rs, ts, pts, n_cams, n_pts)`` with ground-truth poses
    and points (numpy) for assertion; ``prob``'s tensors are on ``device``.
    """
    rng = np.random.default_rng(seed)
    pts = np.stack(
        [
            rng.uniform(-3, 3, n_pts),
            rng.uniform(-2, 2, n_pts),
            rng.uniform(6, 10, n_pts),
        ],
        -1,
    ).astype(np.float32)
    Rs, ts = [], []
    for i in range(n_cams):
        a = (i / (n_cams - 1) - 0.5) * 2.0
        eye = np.array([a * 2.0, 0.1 * a, 0.0])
        fwd = np.array([0.0, 0.0, 8.0]) - eye
        fwd /= np.linalg.norm(fwd)
        right = np.cross(fwd, [0, -1, 0])
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd]).astype(np.float32)
        Rs.append(R)
        ts.append((-R @ eye).astype(np.float32))
    Rs, ts = np.stack(Rs), np.stack(ts)

    C = cfg.max_local_kfs + cfg.max_fixed_kfs
    P = cfg.max_local_lms
    O = cfg.max_obs_per_lm
    obs_cam = np.full((P, O), C, np.int32)
    obs_uv = np.zeros((P, O, 2), np.float32)
    obs_ur = np.full((P, O), -1.0, np.float32)
    obs_ok = np.zeros((P, O), bool)
    cam_pick = [
        rng.choice(n_cams, size=min(O, n_cams), replace=False)
        for _ in range(n_pts)
    ]
    for p in range(n_pts):
        for o, c in enumerate(cam_pick[p]):
            Xc = Rs[c] @ pts[p] + ts[c]
            u = cfg.fx * Xc[0] / Xc[2] + cfg.cx
            v = cfg.fy * Xc[1] / Xc[2] + cfg.cy
            obs_cam[p, o] = c
            obs_uv[p, o] = [u + rng.normal(0, noise_px), v + rng.normal(0, noise_px)]
            obs_ok[p, o] = True
            if stereo_frac > 0 and cfg.bf > 0 and rng.random() < stereo_frac:
                obs_ur[p, o] = (
                    u - cfg.bf / Xc[2] + rng.normal(0, noise_px)
                )

    # perturb poses (except the two gauge cams) and points
    R0 = np.zeros((C, 3, 3), np.float32)
    R0[:] = np.eye(3)
    t0 = np.zeros((C, 3), np.float32)
    R0[:n_cams] = Rs
    t0[:n_cams] = ts
    cam_opt = np.zeros((C,), bool)
    cam_opt[2:n_cams] = True
    for c in range(2, n_cams):
        xi = rng.normal(0, perturb, 6).astype(np.float32)
        Rp, tp = geo.se3_retract(
            torch.from_numpy(R0[c]), torch.from_numpy(t0[c]), torch.from_numpy(xi)
        )
        R0[c], t0[c] = Rp.numpy(), tp.numpy()
    xyz0 = np.zeros((P, 3), np.float32)
    xyz0[:n_pts] = pts + rng.normal(0, perturb * 2, (n_pts, 3))

    def dev(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

    prob = BAProblem(
        cam_slots=dev(np.r_[np.arange(n_cams), np.full(C - n_cams, 999)], torch.int32),
        cam_opt=dev(cam_opt),
        R=dev(R0),
        t=dev(t0),
        lm_ids=dev(np.r_[np.arange(n_pts), np.full(P - n_pts, cfg.max_landmarks)], torch.int32),
        xyz=dev(xyz0),
        obs_cam=dev(obs_cam),
        obs_uv=dev(obs_uv),
        obs_w=dev(obs_ok.astype(np.float32)),
        obs_ok=dev(obs_ok),
        obs_feat=torch.zeros((P, O), dtype=torch.int32, device=device),
        obs_ur=dev(obs_ur) if stereo_frac > 0 else None,
    )
    return prob, Rs, ts, pts, n_cams, n_pts


def make_pose_problem(seed: int = 0, n: int = 1024, stereo: bool = False, outlier_share: float = 0.04,
                      n_behind: int = 5, off: float = 0.02, valid_share: float = 0.95, device="cuda") -> dict:
    """The arguments of one ``pose_optimization`` call at 500 px focal length,
    640x480: ``n`` points 4-10 units ahead of a camera at a random pose,
    their pixels with 0.7 px of noise, the first ``outlier_share`` of them
    moved by up to 40 px (past the Huber knee), the next ``n_behind`` put
    behind the camera (z <= 1e-3), octave weights 1.2^-2k, about
    ``valid_share`` of them valid, and the start pose moved off the truth by
    a twist of N(0, ``off``) per component. With ``stereo`` about half of
    the observations carry a right-x at bf = 60 (the rest u_right = -1) and
    ``use_stereo`` is on."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 10, n)], -1).astype(np.float32)
    R, t = geo.se3_exp(torch.from_numpy((rng.normal(size=6) * 0.05).astype(np.float32)))
    R, t = R.numpy(), t.numpy()
    Xc = X @ R.T + t
    fx = fy = 500.0
    cx, cy, bf = 320.0, 240.0, 60.0
    uv = np.stack([fx * Xc[:, 0] / Xc[:, 2] + cx, fy * Xc[:, 1] / Xc[:, 2] + cy], -1)
    uv = (uv + rng.normal(0, 0.7, uv.shape)).astype(np.float32)
    ur = (uv[:, 0] - bf / Xc[:, 2] + rng.normal(0, 0.7, n)).astype(np.float32)
    ur[rng.random(n) < 0.5] = -1.0
    n_out = int(round(outlier_share * n))
    uv[:n_out] += rng.uniform(-40, 40, (n_out, 2)).astype(np.float32)
    behind = slice(n_out, min(n, n_out + n_behind))
    X[behind] = (Xc[behind] * np.array([1.0, 1.0, -1.0], np.float32) - t) @ R   # depth negated
    inv_s2 = (1.2 ** (-2.0 * rng.integers(0, 8, n))).astype(np.float32)
    valid = rng.random(n) < valid_share
    R0, t0 = geo.se3_retract(torch.from_numpy(R), torch.from_numpy(t),
                             torch.from_numpy((rng.normal(size=6) * off).astype(np.float32)))

    def dev(x):
        return torch.as_tensor(x).to(device).contiguous()

    return dict(R0=dev(R0), t0=dev(t0), X=dev(X), uv=dev(uv), inv_sigma2=dev(inv_s2), valid=dev(valid),
                fx=fx, fy=fy, cx=cx, cy=cy, u_right=dev(ur) if stereo else None, bf=bf if stereo else 0.0,
                use_stereo=stereo)


def camera(cfg: EngineConfig) -> dict:
    """A configuration's pinhole camera and image size, as ``project_gate`` takes them."""
    return dict(fx=cfg.fx, fy=cfg.fy, cx=cfg.cx, cy=cfg.cy, width=cfg.width, height=cfg.height)


def make_projection_problem(seed: int = 0, L: int = 32768, N: int = 1024, F: int = 0, cam: dict | None = None,
                            frustum: bool = False, radius: float = 6.0, device="cuda") -> dict:
    """The arguments of one ``kernels.project.project_gate`` call (8 levels at
    1.2, ``cam`` ``config.TUM1``'s camera unless given): a landmark store of ``L`` slots
    seen from a random pose, 10% of them invalid. Most points lie 0.5-20 m
    in front of the camera and up to 40 px off the image, 5% behind it,
    0.2% at the depth gate (z = 1e-3, 0, -1e-3) and 0.2% exactly on a
    border (u or v; a gate that rounding may flip either way); dmax
    is the distance times a power of the scale factor (30% of them jittered
    by 0.8-1.25), dmin the pyramid's span below, the normals mostly towards
    the camera. 5% of the points lie beyond their band (dmax 0.55-1 times
    the distance) and another 5% before it (dmin 0.9-1.6 times the
    distance), so each distance gate rejects a few percent of the rows.
    ``N`` ids, 5% at the sentinel L, 3% negative and 1% past L.
    With ``F``, the local-map form: a third of the features hold a landmark
    (half of those among the ids, 1% past L), 90% of them valid."""
    cam = cam or camera(TUM1)
    sf, levels = 1.2, 8
    rng = np.random.default_rng(seed)
    w = rng.normal(size=3) * 0.3
    R, t = geo.se3_exp(torch.from_numpy(np.concatenate([rng.normal(size=3), w]).astype(np.float32)))
    R, t = R.numpy().astype(np.float64), t.numpy().astype(np.float64)
    z = rng.uniform(0.5, 20.0, L)
    u = rng.uniform(-40, cam["width"] + 40, L)
    v = rng.uniform(-40, cam["height"] + 40, L)
    edge, on_u = rng.random(L) < 0.002, rng.random(L) < 0.5
    u = np.where(edge & on_u, rng.choice([0.0, float(cam["width"])], L), u)
    v = np.where(edge & ~on_u, rng.choice([0.0, float(cam["height"])], L), v)
    z = np.where(rng.random(L) < 0.05, -z, z)
    z = np.where(rng.random(L) < 0.002, rng.choice([1e-3, 0.0, -1e-3], L), z)
    xc = np.stack([(u - cam["cx"]) * z / cam["fx"], (v - cam["cy"]) * z / cam["fy"], z], -1)
    xyz = ((xc - t) @ R).astype(np.float32)    # R^T (xc - t)
    centre = -R.T @ t
    dist = np.linalg.norm(xyz - centre, axis=-1)
    k = rng.integers(0, levels, L)
    dmax = dist * sf ** k * np.where(rng.random(L) < 0.3, rng.uniform(0.8, 1.25, L), 1.0)
    band = rng.random(L)
    dmax = np.where(band < 0.05, dist * rng.uniform(0.55, 1.0, L), dmax).astype(np.float32)
    dmin = np.where((band >= 0.05) & (band < 0.1), dist * rng.uniform(0.9, 1.6, L), dmax / sf ** (levels - 1))
    ray = (xyz - centre) / np.maximum(dist, 1e-9)[:, None]
    normal = ray + rng.normal(size=(L, 3)) * rng.choice([0.1, 1.5], L)[:, None]
    ids = rng.integers(0, L, N)
    pick = rng.random(N)
    ids = np.where(pick < 0.05, L, ids)
    ids = np.where((pick >= 0.05) & (pick < 0.08), -rng.integers(1, 9, N), ids)
    ids = np.where((pick >= 0.08) & (pick < 0.09), L + rng.integers(1, 9, N), ids)

    def dev(x, dt=None):
        return torch.as_tensor(np.ascontiguousarray(x if dt is None else x.astype(dt))).to(device)

    p = dict(ids=dev(ids, np.int32), xyz=dev(xyz), desc=dev(rng.integers(-2**31, 2**31, (L, 8)), np.int32),
             dmax=dev(dmax), valid=dev(rng.random(L) >= 0.1), R=dev(R, np.float32), t=dev(t, np.float32), **cam,
             scale_factor=sf, n_levels=levels, radius=radius,
             normal=dev(normal / np.linalg.norm(normal, axis=-1, keepdims=True), np.float32),
             dmin=dev(dmin, np.float32), view_cos_th=0.5, frustum=frustum)
    if F:
        own = ids[(ids >= 0) & (ids < L)]
        lm = np.where(rng.random(F) < 0.5, rng.choice(own, F), rng.integers(0, L, F))
        lm = np.where(rng.random(F) < 0.33, lm, -1)
        lm = np.where(rng.random(F) < 0.01, L + 3, lm)
        p.update(lm_of_feat=dev(lm, np.int32), feat_valid=dev(rng.random(F) >= 0.1))
    return p


def projection_gates(p: dict) -> dict:
    """A ``make_projection_problem`` judged in float64, per row: ``ok`` (the
    id inside [0, L) and its landmark valid); ``gates``, each of
    ``project_gate``'s gates by name and its verdict (``z``, ``u0``, ``u1``,
    ``v0``, ``v1``; with the frustum gate ``view``, ``dmin``, ``dmax``);
    ``margin``, the least distance of the gates' quantities to their
    boundaries, relative to the boundary's size (u and v: to the image's);
    ``octave``, that of the octave's unrounded value to an integer; ``z``,
    the depth; ``scale``, |X| + |t|, the size of R X + t's terms; ``alone``,
    for each gate the rows it alone rejects while every quantity lies more
    than 1e-4 from its boundary (a version without that gate differs there)."""
    q = {k: v.cpu().numpy().astype(np.float64) if isinstance(v, torch.Tensor) else v for k, v in p.items()}
    L = q["xyz"].shape[0]
    s = np.clip(q["ids"], 0, L - 1).astype(np.int64)
    X, R, t = q["xyz"][s], q["R"], q["t"]
    xc = X @ R.T + t
    z = xc[:, 2]
    zs = np.where(np.abs(z) < 1e-9, 1e-9, z)
    u, v = p["fx"] * xc[:, 0] / zs + p["cx"], p["fy"] * xc[:, 1] / zs + p["cy"]
    ray = X + R.T @ t
    dist = np.linalg.norm(ray, axis=-1)
    dmax = q["dmax"][s]
    raw = np.log(np.maximum(dmax / np.maximum(dist, 1e-6), 1e-6)) / np.log(p["scale_factor"]) - 1e-4
    w, h = p["width"], p["height"]
    gates = {"z": z > 1e-3, "u0": u >= 0, "u1": u < w, "v0": v >= 0, "v1": v < h}
    rel = lambda a, b: np.abs(a - b) / np.maximum(1.0, np.abs(b))  # noqa: E731
    m = [rel(z, 1e-3), np.abs(u) / w, np.abs(u - w) / w, np.abs(v) / h, np.abs(v - h) / h]
    if p["frustum"]:
        cos_view = np.sum(ray * q["normal"][s], -1) / np.maximum(dist, 1e-9)
        dmin = q["dmin"][s]
        gates.update(view=cos_view > p["view_cos_th"], dmin=dist >= 0.8 * dmin, dmax=dist <= 1.2 * dmax)
        m += [rel(cos_view, p["view_cos_th"]), rel(dist, 0.8 * dmin), rel(dist, 1.2 * dmax)]
    margin = np.min(np.stack(m), 0)
    ok = (q["ids"] >= 0) & (q["ids"] < L) & (q["valid"][s] > 0)
    clear = ok & (margin > 1e-4)
    alone = {g: int(np.sum(clear & ~a & np.all([b for k, b in gates.items() if k != g], 0)))
             for g, a in gates.items()}
    return dict(ok=ok, gates=gates, margin=margin, octave=np.abs(raw - np.round(raw)), z=z,
                scale=np.linalg.norm(X, axis=-1) + np.linalg.norm(t), alone=alone)


def make_match_problem(seed: int = 0, N: int = 1024, F: int = 1024, L: int = 32768, prior: bool = False,
                       device="cuda") -> dict:
    """The arguments of one ``kernels.project.invert_matches`` call: kernel
    B's ``match_ft`` over ``N`` rows (60% a feature in [-3, F + 4), so -1,
    lower and past F; 40% among the first F / 8 features, so many rows share
    one), ids in [-2, L + 3), and with ``prior`` a prior association on 30%
    of the features."""
    rng = np.random.default_rng(seed)
    match = np.where(rng.random(N) < 0.6, rng.integers(-3, F + 4, N), rng.integers(0, max(F // 8, 1), N))

    def dev(x):
        return torch.as_tensor(x.astype(np.int32)).to(device)

    return dict(match_ft=dev(match), ids=dev(rng.integers(-2, L + 3, N)), F=F, L=L,
                prior=dev(np.where(rng.random(F) < 0.3, rng.integers(0, L, F), -1)) if prior else None)


def make_pose_graph(seed: int = 0, K: int = 256, n_live: int | None = None, drift: float = 0.02,
                    scale_drift: float = 0.995, device="cuda") -> PoseGraphProblem:
    """A ring of ``n_live`` keyframes (of ``K`` slots, the rest dead) on a
    circle of radius 3 looking outwards. The edges measure the true relative
    poses at scale 1: the tree (k -> k-1), covisibility pairs (k -> k-2 and
    k -> k-3) and the loop edge (last -> 0, weight 5); the rest of the 4K
    covisibility capacity is padding (``e_ok`` False). The node states
    compose the tree's measurements with a N(0, ``drift``) twist and the
    translation shrunk by ``scale_drift`` per step, from node 0, which is
    frozen; the nodes' scales start at 1."""
    n_live = K if n_live is None else n_live
    rng = np.random.default_rng(seed)
    gt_R, gt_t = [], []
    for k in range(n_live):
        th = 2.0 * np.pi * k / n_live
        R = geo.so3_exp(torch.tensor([0.0, th, 0.0], dtype=torch.float64)).numpy()
        gt_R.append(R)
        gt_t.append(-R @ np.array([3.0 * np.sin(th), 0.0, 3.0 * np.cos(th)]))

    def rel(i, j):
        R_ij = gt_R[i] @ gt_R[j].T
        return R_ij, gt_t[i] - R_ij @ gt_t[j]

    R0 = np.tile(np.eye(3), (K, 1, 1))
    t0 = np.zeros((K, 3))
    R0[0], t0[0] = gt_R[0], gt_t[0]
    for k in range(1, n_live):
        R_rel, t_rel = rel(k, k - 1)
        dR, dt = geo.se3_exp(torch.from_numpy(rng.normal(0.0, drift, 6)))
        R_rel, t_rel = dR.numpy() @ R_rel, (dR.numpy() @ t_rel + dt.numpy()) * scale_drift ** k
        R0[k], t0[k] = R_rel @ R0[k - 1], R_rel @ t0[k - 1] + t_rel
    cov = [(k, k - d) for d in (2, 3) for k in range(d, n_live)][: 4 * K]
    E = K + 4 * K + 1
    e_i = np.zeros(E, np.int32)
    e_j = np.zeros(E, np.int32)
    e_ok = np.zeros(E, bool)
    # the tree edge of node k sits at index k, as build_pose_graph lays it out
    e_i[:K] = np.arange(K)
    e_j[1:n_live] = np.arange(n_live - 1)
    e_ok[1:n_live] = True
    if cov:
        e_i[K : K + len(cov)], e_j[K : K + len(cov)] = np.array(cov).T
    e_ok[K : K + len(cov)] = True
    e_i[E - 1], e_ok[E - 1] = n_live - 1, True
    m_R = np.tile(np.eye(3), (E, 1, 1))
    m_t = np.zeros((E, 3))
    for e in np.nonzero(e_ok)[0]:
        m_R[e], m_t[e] = rel(int(e_i[e]), int(e_j[e]))
    e_w = np.ones(E, np.float32)
    e_w[E - 1] = 5.0
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)  # noqa: E731
    return PoseGraphProblem(
        s=f32(np.ones(K)), R=f32(R0), t=f32(t0),
        opt=torch.from_numpy((np.arange(K) < n_live) & (np.arange(K) > 0)).to(device),
        e_i=torch.from_numpy(e_i).to(device), e_j=torch.from_numpy(e_j).to(device), m_s=f32(np.ones(E)),
        m_R=f32(m_R), m_t=f32(m_t), e_ok=torch.from_numpy(e_ok).to(device), e_w=f32(e_w),
    )


def build_corridor_map(cfg: EngineConfig = KITTI00, seed: int = 0, n_kf: int = 1100, lm_per_kf: int = 125,
                       n_observers: int = 4, step: float = 0.8, device="cuda") -> MapState:
    """A consistent map at occupancy: keyframe k at z = k * ``step`` looking
    +z (R = I), making ``lm_per_kf`` landmarks 6-14 m ahead and observing the
    landmarks of keyframes k - ``n_observers`` + 1 .. k (banded
    covisibility, as in forward driving), with 0.3 px of pixel noise. The
    reference's ``build_corridor_map`` (``tests/test_kitti_capacity.py``) at
    the default arguments: 1,100 live keyframes, 137,500 landmarks, 4
    observers each. Like it, the keyframes keep no right-x or depth, so a
    global problem of this map has monocular rows only. Built on the host
    with numpy and moved to ``device`` once."""
    rng = np.random.default_rng(seed)
    K, F, L = cfg.max_keyframes, cfg.max_features, cfg.max_landmarks
    n_lm = n_kf * lm_per_kf
    if n_kf > K or n_lm > L or n_observers * lm_per_kf > F:
        raise ValueError(f"{n_kf} keyframes of {n_observers} x {lm_per_kf} observations, {n_lm} landmarks do not "
                         f"fit K={K}, F={F}, L={L}")

    created_by = np.repeat(np.arange(n_kf), lm_per_kf)
    xyz = np.zeros((n_lm, 3), np.float32)
    xyz[:, 0] = rng.uniform(-8, 8, n_lm)
    xyz[:, 1] = rng.uniform(-3, 3, n_lm)
    xyz[:, 2] = created_by * step + rng.uniform(6, 14, n_lm)
    desc = rng.integers(0, 2**32, (n_lm, 8), dtype=np.uint32).view(np.int32)
    t_all = np.zeros((n_kf, 3), np.float32)    # world -> camera: X_c = X_w - C
    t_all[:, 2] = -np.arange(n_kf) * step

    obs_lm = np.full((K, F), -1, np.int32)
    uv = np.zeros((K, F, 2), np.float32)
    kdesc = np.zeros((K, F, 8), np.int32)
    feat_valid = np.zeros((K, F), bool)
    for k in range(n_kf):
        ids = np.arange(max(0, k - (n_observers - 1)) * lm_per_kf, (k + 1) * lm_per_kf)
        Xc = xyz[ids] + t_all[k]
        z = Xc[:, 2]
        u = cfg.fx * Xc[:, 0] / z + cfg.cx + rng.normal(0, 0.3, len(ids))
        v = cfg.fy * Xc[:, 1] / z + cfg.cy + rng.normal(0, 0.3, len(ids))
        ok = (z > 0.5) & (u >= 0) & (u < cfg.width) & (v >= 0) & (v < cfg.height)
        n = len(ids)
        obs_lm[k, :n] = np.where(ok, ids, -1)
        uv[k, :n, 0] = u
        uv[k, :n, 1] = v
        kdesc[k, :n] = desc[ids]
        feat_valid[k, :n] = ok

    covis = np.zeros((K, K), np.int32)
    for dk in range(1, n_observers):
        i = np.arange(n_kf - dk)
        covis[i, i + dk] = covis[i + dk, i] = (n_observers - dk) * lm_per_kf

    m = empty_map(cfg, device="cpu")
    kfs, lms = m.kfs, m.lms
    kf_rows, lm_rows = slice(0, n_kf), slice(0, n_lm)
    t = kfs.t.clone()
    t[kf_rows] = torch.from_numpy(t_all)
    parent, valid, seq, frame_id = kfs.parent.clone(), kfs.valid.clone(), kfs.seq.clone(), kfs.frame_id.clone()
    parent[1:n_kf] = torch.arange(n_kf - 1, dtype=torch.int32)
    valid[kf_rows] = True
    seq[kf_rows] = torch.arange(n_kf, dtype=torch.int32)
    frame_id[kf_rows] = torch.arange(n_kf, dtype=torch.int32)
    kfs = kfs._replace(t=t, uv=torch.from_numpy(uv), desc=torch.from_numpy(kdesc),
                       feat_valid=torch.from_numpy(feat_valid), obs_lm=torch.from_numpy(obs_lm), valid=valid,
                       frame_id=frame_id, parent=parent, seq=seq)

    def rows(x, v):
        x = x.clone()
        x[lm_rows] = v
        return x

    made_by = torch.from_numpy(created_by.astype(np.int32))
    lms = lms._replace(xyz=rows(lms.xyz, torch.from_numpy(xyz)), desc=rows(lms.desc, torch.from_numpy(desc)),
                       normal=rows(lms.normal, torch.tensor([0.0, 0.0, 1.0])), dmin=rows(lms.dmin, 1.0),
                       dmax=rows(lms.dmax, 50.0), ref_kf=rows(lms.ref_kf, made_by),
                       first_seq=rows(lms.first_seq, made_by), n_visible=rows(lms.n_visible, n_observers),
                       n_found=rows(lms.n_found, n_observers), valid=rows(lms.valid, True))
    m = recount_lm_obs(m._replace(kfs=kfs, lms=lms, covis=torch.from_numpy(covis),
                                  num_kfs=torch.tensor(n_kf, dtype=torch.int32),
                                  num_lms=torch.tensor(n_lm, dtype=torch.int32)))
    return type(m)(*[type(x)(*[y.to(device) for y in x]) if hasattr(x, "_fields") else x.to(device) for x in m])


def perturb_block_local(m: MapState, n_kf: int, lm_per_kf: int, blk: int, seed: int = 0, rot: float = 0.01,
                        trans: float = 0.05, lm_sigma: float = 0.1, edge: int = 3) -> MapState:
    """The noise of ``tests/test_block_ba.py::corridor_map(block_local=True)``
    on a ``build_corridor_map`` map (keyframe k in slot k, its landmarks in
    slots k * lm_per_kf ...): keyframes 2 .. n_kf - 1 rotated about their
    centre by N(0, ``rot``) rad and shifted by N(0, ``trans``) per axis,
    landmarks by N(0, ``lm_sigma``), except that, with blocks of ``blk``
    keyframes, the ``edge`` keyframes at each end of a block and the
    landmarks made by the last ``edge`` of a block stay at their truth:
    they are the neighbouring blocks' frozen anchors. The error class block
    BA is built for. Numpy draws from ``seed``, in the test's order."""
    rng = np.random.default_rng(seed)
    dev = m.kfs.R.device
    R, t = m.kfs.R.cpu().numpy().copy(), m.kfs.t.cpu().numpy().copy()
    for k in range(2, n_kf):
        if k % blk >= blk - edge or k % blk < edge:
            continue
        phi = rng.normal(0, rot, 3).astype(np.float32)
        rho = rng.normal(0, trans, 3).astype(np.float32)
        dR = geo.so3_exp(torch.from_numpy(phi)).numpy()
        R[k] = dR @ R[k]
        t[k] = dR @ t[k] + rho
    n_lm = n_kf * lm_per_kf
    noise = rng.normal(0, lm_sigma, (n_lm, 3)).astype(np.float32)
    noise[(np.repeat(np.arange(n_kf), lm_per_kf) % blk) >= blk - edge] = 0.0
    xyz = m.lms.xyz.clone()
    xyz[:n_lm] += torch.from_numpy(noise).to(dev)
    return m._replace(kfs=m.kfs._replace(R=torch.from_numpy(R).to(dev), t=torch.from_numpy(t).to(dev)),
                      lms=m.lms._replace(xyz=xyz))
