"""Where the port's stereo engine first decides otherwise than the JAX engine.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/stereo_parity_trace.py [--frames 48] [--same-frames | --port-frames]
    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/stereo_parity_trace.py --seeds 7,1,2,3,4 --no-replay
    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/stereo_parity_trace.py --reference-out tools/stereo_reference_trace.json

Drives ``dialog_tpu``'s engine and the port's (``device="cpu"``) over the
first N pairs of the stereo path (``profile_main_path.WORKLOADS["stereo"]``:
KITTI00 at 1241x376, 2,048 features, 32,768 landmarks, on
``make_scene(seed, n_points=6000, n_frames=168)``, seed 7 by default), with
``reference_ate.reference_config`` (no vocabulary within the run) and loop
closing off. Each engine runs its own ``track_stereo``; ``--same-frames``
feeds the JAX engine's frame (its frontend and ``stereo_match_frames``) to
both through ``track_features``, ``--port-frames`` the port's.

Per frame it prints each engine's state, ``n_tracked`` and keyframe count,
the distance between the two camera centres and from each to the ground
truth, and the allocated and valid landmark counts, and runs the port's
``fused_track_step`` on the JAX engine's inputs of the frame (associations,
counts and pose against the JAX step's; for an association bound
differently, the final outlier gate's chi2 in float64). After each JAX
local BA it runs the port's on the same map (landmark validity,
observations, keyframe poses within 1e-4, landmark positions, how many of
those that differ lie within 1 m of the camera, R11's points, and how far
each package's float32 poses lie from the same window solved in float64).
At every
keyframe of the JAX engine it also replays the port's
keyframe pipeline one step at a time, each step on the JAX engine's map as it
stood before that step (``interop.map_from_numpy``), and compares the
result with the JAX step's output: ``num_lms``, ``lms.valid``,
``kfs.obs_lm``, ``lms.n_obs`` and ``covis`` equal, ``xyz``, ``normal``,
``dmin``, ``dmax`` on live slots within 1e-4 relative. The steps are those of
``process_new_keyframe`` in both packages (``dialog_tpu/mapping.py:576-650``,
``dialog_tpu_torch/mapping.py``): ``insert_keyframe``,
``spawn_depth_landmarks``, the neighbour choice, ``triangulate_fanout``, each
``fuse_landmarks_into_kf`` pair, ``recount_lm_obs``, ``update_covis_for_kf``,
``refresh_landmark_descriptors``, ``refresh_landmark_geometry``,
``cull_landmarks``, ``cull_keyframes``. The JAX steps run one jitted call
each, as ``process_new_keyframe``'s body calls them.

For a step that differs it prints the features the two packages treat
differently, with the value of every gate each one meets:
``spawn_depth_landmarks``: the depth against ``th_depth x baseline``;
``triangulate_fanout``: the Hamming distance against ``tri_match_max_dist``,
the epipolar distance against 3.84 sigma^2, the depth in each view against
1e-3, the reprojection chi2 in each view against 5.991 sigma^2 and the
parallax cosine against 0.99995, each evaluated in float64 at the point each
package triangulated in float32 (the JAX engine's from its
``triangulate_fanout``, the port's from its ``_tri_candidates``) and at the
point solved in float64, beside the condition number of the 3x3 normal
equations; the fuse steps: the landmark and feature bound differently, with
the Hamming distance against ``th_low``. A candidate is a rounding edge when
the two float32 points differ by more than 1e-4 relative from the same
inputs, or a gate value lies within 1e-5 relative of its threshold.

``--seeds``: each engine's metric ATE over the OK frames, their ratio, the
keyframe counts and the frame of the first differing decision, per seed
(these are CPU readings). ``--bearing-gate``: an experiment on ROADMAP R11
that changes neither package's files: in this process both triangulations
also gate the parallax of the bearing rays before the point counts, as
ORB-SLAM2 does. ``--window``: each engine's last local-BA window solved in
float64 for 0, 8 and 40 LM iterations (how far it sits from its optimum).
``--reference-out``: the JAX engine's per-frame
decisions on the run, as the JSON file ``chip_smoke.py`` prints beside the
card's. The last line of the output is a JSON object.
"""

from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dialog_tpu import containers as jcont, mapping as jmap, tracking as jtrack
from dialog_tpu.optim import local_ba as jlba
from dialog_tpu.system import Engine as JEngine
from dialog_tpu_torch import containers as tcont, interop, mapping as tmap, ops, profile_main_path as pmp
from dialog_tpu_torch import frontend as tfront, stereo as tstereo, tracking as ttrack
from dialog_tpu_torch.optim import local_ba as tlba
from dialog_tpu_torch.eval.ate import ate_rmse
from dialog_tpu_torch.system import Engine as TEngine

from reference_ate import reference_config

REL_TOL = 1e-4      # live landmark geometry, relative
POSE_TOL = 1e-4     # rotation entries and translation (m), absolute
EDGE_REL = 1e-5     # a gate value this close to its threshold is decided by rounding
MAX_LISTED = 12     # candidates listed per differing step
WINDOW_ITERS = (0, 8, 40)
BEARING_COS = 0.9998  # --bearing-gate: ORB-SLAM2's cosParallaxRays bound
NEAR_M = 1.0        # landmarks nearer than this to their camera (the scene lies 4-12 m away) are the R11 points


# ---------------------------------------------------------------------------
# comparing maps
# ---------------------------------------------------------------------------


def to_port(m) -> tcont.MapState:
    return interop.map_from_numpy(jax.device_get(m), device="cpu")


def map_diffs(mj, mt) -> list[str]:
    """What differs between a JAX map and a port map (empty when they agree)."""
    mj = to_port(mj)
    out = []
    if int(mj.num_lms) != int(mt.num_lms):
        out.append(f"num_lms {int(mj.num_lms)} vs {int(mt.num_lms)}")
    for name, a, b in [("lms.valid", mj.lms.valid, mt.lms.valid), ("kfs.obs_lm", mj.kfs.obs_lm, mt.kfs.obs_lm),
                       ("lms.n_obs", mj.lms.n_obs, mt.lms.n_obs), ("covis", mj.covis, mt.covis),
                       ("kfs.valid", mj.kfs.valid, mt.kfs.valid)]:
        if not torch.equal(a, b):
            out.append(f"{name}: {int((a != b).sum())} entries")
    live = mj.lms.valid & mt.lms.valid
    for f in ("xyz", "normal", "dmin", "dmax"):
        a, b = getattr(mj.lms, f)[live].double(), getattr(mt.lms, f)[live].double()
        if a.numel():
            rel = float(((a - b).abs() / a.abs().clamp(min=1e-6)).max())
            if not rel <= REL_TOL:
                out.append(f"lms.{f} rel {rel:.3g}")
    return out


# ---------------------------------------------------------------------------
# gate values of one candidate, float64
# ---------------------------------------------------------------------------


def _popcount(words: np.ndarray) -> int:
    return int(sum(bin(int(w)).count("1") for w in np.asarray(words, np.uint32)))


def _normal_eq(Ra, ta, Rb, tb, xa, xb):
    """The 3x3 normal equations of the two-view linear triangulation (both
    packages' ``geometry.triangulate_linear``), float64."""
    rows, rhs = [], []
    for R, t, x in ((Ra, ta, xa), (Rb, tb, xb)):
        for k in (0, 1):
            rows.append(x[k] * R[2] - R[k])
            rhs.append(-(x[k] * t[2] - t[k]))
    A, b = np.array(rows), np.array(rhs)
    return A.T @ A + 1e-9 * np.eye(3), A.T @ b


def tri_gates(cfg, kfs, a: int, b: int, fa: int, fb: int, points: dict) -> dict:
    """Every gate of ``_tri_candidates`` for feature ``fa`` of keyframe ``a``
    matched to ``fb`` of ``b``, in float64 from the float32 map: the gates that
    do not depend on the point, then those that do at each of ``points``
    (name -> f32 point) and at the point solved in float64."""
    f64 = lambda x: np.asarray(x, np.float64)
    Ra, ta, Rb, tb = f64(kfs.R[a]), f64(kfs.t[a]), f64(kfs.R[b]), f64(kfs.t[b])
    uva, uvb = f64(kfs.uv[a][fa]), f64(kfs.uv[b][fb])
    sf = np.float64(cfg.scale_factor)
    s2a, s2b = sf ** (2.0 * int(kfs.octave[a][fa])), sf ** (2.0 * int(kfs.octave[b][fb]))
    Kinv = np.linalg.inv(np.array([[cfg.fx, 0, cfg.cx], [0, cfg.fy, cfg.cy], [0, 0, 1.0]]))
    R21 = Rb @ Ra.T
    t21 = tb - R21 @ ta
    E = np.array([[0, -t21[2], t21[1]], [t21[2], 0, -t21[0]], [-t21[1], t21[0], 0]]) @ R21
    line = Kinv.T @ E @ Kinv @ np.append(uva, 1.0)
    d_epi = float(np.append(uvb, 1.0) @ line) ** 2 / (line[0] ** 2 + line[1] ** 2 + 1e-12)
    c, f = np.array([cfg.cx, cfg.cy]), np.array([cfg.fx, cfg.fy])
    AtA, Atb = _normal_eq(Ra, ta, Rb, tb, (uva - c) / f, (uvb - c) / f)
    out = {"keyframes": [a, b], "features": [fa, fb],
           "hamming": [_popcount(np.asarray(kfs.desc[a][fa]) ^ np.asarray(kfs.desc[b][fb])), cfg.tri_match_max_dist],
           "epipolar_px2": [d_epi, 3.84 * s2b], "normal_eq_cond": float(np.linalg.cond(AtA))}
    ca, cb = -Ra.T @ ta, -Rb.T @ tb

    def at(X):
        X = f64(X)
        za, zb = (Ra @ X + ta)[2], (Rb @ X + tb)[2]
        pa, pb = Ra @ X + ta, Rb @ X + tb
        ea = float(np.sum((f * pa[:2] / pa[2] + c - uva) ** 2))
        eb = float(np.sum((f * pb[:2] / pb[2] + c - uvb) ** 2))
        r1, r2 = X - ca, X - cb
        cosp = float(r1 @ r2 / (np.linalg.norm(r1) * np.linalg.norm(r2) + 1e-12))
        gates = {"z_a": [float(za), 1e-3], "z_b": [float(zb), 1e-3], "chi2_a": [ea, 5.991 * s2a],
                 "chi2_b": [eb, 5.991 * s2b], "parallax_cos": [cosp, 0.99995]}
        passed = za > 1e-3 and zb > 1e-3 and ea < 5.991 * s2a and eb < 5.991 * s2b and cosp < 0.99995
        return {"X": X.tolist(), "passes": bool(passed), **gates}

    for name, X in points.items():
        if X is not None:
            out[name] = at(X)
    out["float64"] = at(np.linalg.solve(AtA, Atb))
    return out


def is_rounding_edge(c: dict) -> bool:
    """The candidate's verdict rests on float32 rounding: the two packages'
    points differ by more than REL_TOL relative from the same inputs, or some
    gate value lies within EDGE_REL relative of its threshold."""
    pts = [c[k]["X"] for k in ("jax", "port") if k in c]
    if len(pts) == 2:
        a, b = np.array(pts[0]), np.array(pts[1])
        if np.linalg.norm(a - b) > REL_TOL * max(np.linalg.norm(a), 1e-12):
            return True
    for k in ("jax", "port", "float64"):
        for g in ("z_a", "z_b", "chi2_a", "chi2_b", "parallax_cos"):
            if k in c and abs(c[k][g][0] - c[k][g][1]) <= EDGE_REL * abs(c[k][g][1]):
                return True
    for g in ("epipolar_px2",):
        if abs(c[g][0] - c[g][1]) <= EDGE_REL * abs(c[g][1]):
            return True
    return False


# ---------------------------------------------------------------------------
# the candidates a step treats differently
# ---------------------------------------------------------------------------


def spawn_candidates(cfg, m_before, mj, mt, slot: int) -> list[dict]:
    kfs = jax.device_get(m_before).kfs
    free = kfs.obs_lm[slot] < 0
    nj = free & (np.asarray(mj.kfs.obs_lm[slot]) >= 0)
    nt = free & (mt.kfs.obs_lm[slot].numpy() >= 0)
    bound32 = float(np.float32(cfg.th_depth) * np.float32(max(cfg.baseline, 1e-6)))
    out = []
    for f in np.nonzero(nj != nt)[0][:MAX_LISTED]:
        d = float(kfs.depth[slot][f])
        out.append({"feature": int(f), "jax_spawns": bool(nj[f]), "port_spawns": bool(nt[f]),
                    "depth": [d, bound32], "depth_float64": [d, cfg.th_depth * max(cfg.baseline, 1e-6)],
                    "rounding_edge": abs(d - bound32) <= EDGE_REL * bound32})
    return out


def tri_candidates(cfg, jcfg, m_before, mj, mt, slot: int, neighbors: list[int]) -> list[dict]:
    """Features of the new keyframe that gain a landmark in one package and
    not in the other, or in both at points more than REL_TOL apart."""
    mb = jax.device_get(m_before)
    kfs = mb.kfs
    mj = jax.device_get(mj)
    free = kfs.obs_lm[slot] < 0
    ids_j, ids_t = np.asarray(mj.kfs.obs_lm[slot]), mt.kfs.obs_lm[slot].numpy()
    nj, nt = free & (ids_j >= 0), free & (ids_t >= 0)
    xyz_t = mt.lms.xyz.numpy()
    apart = nj & nt & (np.linalg.norm(mj.lms.xyz[np.maximum(ids_j, 0)] - xyz_t[np.maximum(ids_t, 0)], axis=1)
                       > REL_TOL * np.linalg.norm(mj.lms.xyz[np.maximum(ids_j, 0)], axis=1))
    feats = np.nonzero((nj != nt) | apart)[0][:MAX_LISTED]
    if not len(feats):
        return []
    tm = to_port(mb)
    out = []
    for nb in neighbors:
        if nb == slot:
            continue
        args_j = [jnp.asarray(x) for x in (kfs.R[slot], kfs.t[slot], kfs.uv[slot], kfs.desc[slot],
                                           kfs.octave[slot], free, kfs.R[nb], kfs.t[nb], kfs.uv[nb],
                                           kfs.desc[nb], kfs.octave[nb], kfs.feat_valid[nb] & (kfs.obs_lm[nb] < 0))]
        Xj, gj, jbj = jax.device_get(jmap._tri_candidates(*args_j, jcfg))
        k = tm.kfs
        Xt, gt, jbt = [x.numpy() for x in tmap._tri_candidates(
            k.R[slot], k.t[slot], k.uv[slot], k.desc[slot], k.octave[slot], k.feat_valid[slot] & (k.obs_lm[slot] < 0),
            k.R[nb], k.t[nb], k.uv[nb], k.desc[nb], k.octave[nb], k.feat_valid[nb] & (k.obs_lm[nb] < 0), cfg)]
        for f in feats:
            if not (gj[f] or gt[f] or nj[f] or nt[f]):
                continue
            fb = int(jbj[f])
            # the JAX engine's point: the one its triangulate_fanout stored, else its _tri_candidates' own
            xj = mj.lms.xyz[ids_j[f]] if nj[f] else Xj[f]
            c = tri_gates(cfg, kfs, slot, nb, int(f), fb, {"jax": xj, "port": Xt[f]})
            c.update(jax_creates=bool(nj[f]), port_creates=bool(nt[f]), jax_tri_candidates_good=bool(gj[f]),
                     port_tri_candidates_good=bool(gt[f]), jax_match=fb, port_match=int(jbt[f]))
            c["rounding_edge"] = is_rounding_edge(c)
            out.append(c)
    return out


def fuse_candidates(cfg, m_before, mj, mt) -> list[dict]:
    """Observation entries bound differently after a fuse step, with the
    Hamming distance of the landmark each package bound against th_low."""
    mb = jax.device_get(m_before)
    oj, ot = np.asarray(jax.device_get(mj).kfs.obs_lm), mt.kfs.obs_lm.numpy()
    out = []
    for k, f in list(zip(*np.nonzero(oj != ot)))[:MAX_LISTED]:
        entry = {"keyframe": int(k), "feature": int(f), "jax_lm": int(oj[k, f]), "port_lm": int(ot[k, f])}
        for side, lm in (("jax", oj[k, f]), ("port", ot[k, f])):
            if lm >= 0:
                entry[f"{side}_hamming"] = [_popcount(mb.lms.desc[lm] ^ mb.kfs.desc[k][f]), cfg.th_low]
        out.append(entry)
    return out


# ---------------------------------------------------------------------------
# the keyframe pipeline, step by step
# ---------------------------------------------------------------------------


def new_depths(m_before, mj, mt, slot: int) -> dict:
    """Depth in keyframe ``slot``'s camera of every landmark a step created,
    in each package."""
    mb, mj = jax.device_get(m_before), jax.device_get(mj)
    R, t = np.asarray(mb.kfs.R[slot], np.float64), np.asarray(mb.kfs.t[slot], np.float64)
    out = {}
    for side, valid, xyz in (("jax", mj.lms.valid, mj.lms.xyz), ("port", mt.lms.valid.numpy(), mt.lms.xyz.numpy())):
        new = np.asarray(valid) & ~np.asarray(mb.lms.valid)
        out[side] = (np.asarray(xyz, np.float64)[new] @ R.T + t)[:, 2].tolist()
    return out


def replay_keyframe(args: tuple, kwargs: dict, cfg, jcfg) -> list[dict]:
    """Each step of ``process_new_keyframe``, the JAX engine's and the port's on
    the JAX map as it stood before the step; one entry per step."""
    m0, frame, R, t, lm_ids, fid, ts, slot, parent = args[:9]
    s = int(slot)
    steps = []

    def step(name, jfn, tfn, m_before, report=None):
        mj = jfn(m_before)
        mt = tfn(to_port(m_before))
        diffs = map_diffs(mj, mt)
        entry = {"step": name, "diffs": diffs}
        if diffs and report is not None:
            entry["candidates"] = report(m_before, mj, mt)
        if name == "triangulate_fanout":
            entry["new_depths_m"] = new_depths(m_before, mj, mt, s)
        steps.append(entry)
        return mj

    tf = interop.frame_from_numpy(jax.device_get(frame), device="cpu")
    to_t = lambda x: torch.from_numpy(np.array(x))
    m = step("insert_keyframe",
             lambda m: jmap.insert_keyframe(m, frame, R, t, lm_ids, fid, ts, slot, parent, jcfg),
             lambda m: tmap.insert_keyframe(m, tf, to_t(R), to_t(t), to_t(lm_ids), int(fid), float(ts), s,
                                            int(parent), cfg), m0)
    if kwargs.get("spawn_depth"):
        m = step("spawn_depth_landmarks", lambda m: jmap.spawn_depth_landmarks(m, slot, jcfg),
                 lambda m: tmap.spawn_depth_landmarks(m, s, cfg), m,
                 lambda mb, mj, mt: spawn_candidates(cfg, mb, mj, mt, s))
    n_nb = kwargs.get("n_neighbors", 4)
    K = m.kfs.valid.shape[0]
    w = jnp.where(m.kfs.valid, m.covis[slot], 0).at[slot].set(0)
    top_w, nbs = jax.lax.top_k(w, n_nb)
    nbs = jnp.where(top_w > 0, nbs, slot)
    wt = torch.from_numpy(np.array(w))
    tw_t, nb_t = ops.top_k(wt, n_nb)
    nb_t = torch.where(tw_t > 0, nb_t, s)
    neighbors = [int(x) for x in nbs]
    steps.append({"step": "neighbors", "jax": neighbors, "port": nb_t.tolist(),
                  "diffs": [] if nb_t.tolist() == neighbors else ["neighbour slots"]})
    m = step("triangulate_fanout", lambda m: jmap.triangulate_fanout(m, slot, nbs, jcfg),
             lambda m: tmap.triangulate_fanout(m, s, torch.as_tensor(neighbors), cfg), m,
             lambda mb, mj, mt: tri_candidates(cfg, jcfg, mb, mj, mt, s, neighbors))
    targets = list(neighbors)
    if jcfg.kf_fuse_two_hop > 0:
        one_hop = jnp.zeros((K,), bool).at[jnp.where(top_w > 0, nbs, K)].set(True, mode="drop")
        rows = jnp.where((top_w > 0)[:, None], m.covis[nbs], 0)
        w2 = jnp.where(m.kfs.valid & ~one_hop, jnp.max(rows, axis=0), 0).at[slot].set(0)
        top_w2, nb2 = jax.lax.top_k(w2, jcfg.kf_fuse_two_hop)
        targets += [int(x) for x in jnp.where(top_w2 > 0, nb2, slot)]
    for nb in targets:
        if nb == s:
            continue
        for src, dst in ((s, nb), (nb, s)):
            m = step(f"fuse_landmarks_into_kf {src}->{dst}",
                     lambda m: jmap.fuse_landmarks_into_kf(m, jnp.int32(src), jnp.int32(dst), jcfg, recount=False),
                     lambda m: tmap.fuse_landmarks_into_kf(m, src, dst, cfg, recount=False), m,
                     lambda mb, mj, mt: fuse_candidates(cfg, mb, mj, mt))
    for name, jfn, tfn in [
        ("recount_lm_obs", jcont.recount_lm_obs, tcont.recount_lm_obs),
        ("update_covis_for_kf", lambda m: jcont.update_covis_for_kf(m, slot),
         lambda m: tcont.update_covis_for_kf(m, s)),
        ("refresh_landmark_descriptors", lambda m: jmap.refresh_landmark_descriptors(m, slot, jcfg),
         lambda m: tmap.refresh_landmark_descriptors(m, s, cfg)),
        ("refresh_landmark_geometry", lambda m: jmap.refresh_landmark_geometry(m, slot, jcfg),
         lambda m: tmap.refresh_landmark_geometry(m, s, cfg)),
        ("cull_landmarks", lambda m: jmap.cull_landmarks(m, slot, jcfg), lambda m: tmap.cull_landmarks(m, s, cfg)),
        ("cull_keyframes", lambda m: jmap.cull_keyframes(m, slot, jcfg), lambda m: tmap.cull_keyframes(m, s, cfg)),
    ]:
        m = step(name, jfn, tfn, m)
    return steps


def _bound_differently(m, frame, lm_j, lm_t, pj, pt, cfg, use_stereo: bool) -> list[dict]:
    """The features one frame's step binds differently in the two packages:
    the final outlier gate of each package's landmark at its own pose
    (packed rows ``pj``, ``pt``), in float64."""
    mb = jax.device_get(m)
    chi2_th = cfg.chi2_stereo if use_stereo else cfg.chi2_mono
    feats = []
    for f in np.nonzero(lm_j != lm_t)[0][:MAX_LISTED]:
        entry = {"feature": int(f), "jax_lm": int(lm_j[f]), "port_lm": int(lm_t[f])}
        for side, lm, p in (("jax", int(lm_j[f]), pj), ("port", int(lm_t[f]), pt)):
            if lm >= 0:
                R_, t_ = p[:9].reshape(3, 3).astype(np.float64), p[9:12].astype(np.float64)
                Xc = R_ @ np.asarray(mb.lms.xyz[lm], np.float64) + t_
                uv_hat = np.array([cfg.fx * Xc[0] / Xc[2] + cfg.cx, cfg.fy * Xc[1] / Xc[2] + cfg.cy])
                inv_s2 = cfg.scale_factor ** (-2.0 * int(frame.octave[f]))
                entry[f"{side}_chi2"] = [float(np.sum((uv_hat - np.asarray(frame.uv[f], np.float64)) ** 2) * inv_s2),
                                         chi2_th]
                entry[f"{side}_depth_m"] = float(Xc[2])
        feats.append(entry)
    return feats


def _row_diffs(pj: np.ndarray, pt: np.ndarray, prefix: str = "") -> tuple[list[str], float]:
    """n_tracked, the motion-model count and the pose of two packed rows."""
    diffs = []
    if pj[24] != pt[24] or pj[25] != pt[25]:
        diffs.append(f"{prefix}n_tracked/n_motion {pj[24:26].tolist()} vs {pt[24:26].tolist()}")
    gap = float(np.abs(pj[:12] - pt[:12]).max())
    if not gap <= POSE_TOL:
        diffs.append(f"{prefix}pose {gap:.3g}")
    return diffs, gap


def replay_track(args: tuple, kwargs: dict, out: tuple, cfg) -> dict:
    """The port's ``fused_track_step`` on the JAX engine's inputs of a frame,
    against the JAX step's output: landmark associations, n_tracked and the
    motion-model count equal, the pose within POSE_TOL."""
    m, last, frame, R_pred, t_pred, R_last, t_last, ref_kf = args[:8]
    to_t = lambda x: torch.from_numpy(np.array(x))
    use_stereo = kwargs.get("use_stereo", False)
    _, _, lm_t, packed_t, _ = ttrack.fused_track_step(
        to_port(m), to_t(last), interop.frame_from_numpy(frame, device="cpu"), to_t(R_pred), to_t(t_pred),
        to_t(R_last), to_t(t_last), int(ref_kf), cfg, use_stereo=use_stereo)
    lm_j, pj, pt, lm_t = np.asarray(out[2]), np.asarray(out[3]), packed_t.numpy(), lm_t.numpy()
    diffs = [f"lm_ids: {int((lm_j != lm_t).sum())} features"] if not np.array_equal(lm_j, lm_t) else []
    row, pose_gap = _row_diffs(pj, pt)
    return {"diffs": diffs + row, "pose_gap": pose_gap, "n_tracked": [float(pj[24]), float(pt[24])],
            "features": _bound_differently(m, frame, lm_j, lm_t, pj, pt, cfg, use_stereo)}


def replay_track_multi(args: tuple, kwargs: dict, out: tuple, cfg) -> dict:
    """The port's ``fused_track_multi`` on the JAX engine's inputs of a batch,
    against the JAX call's output: per frame n_tracked, the motion-model count
    and the pose (POSE_TOL); the last frame's associations. Returns the port's
    packed rows too, for the batch's resolve (``resolve_decisions``)."""
    m, lm0, frames, R0, t0, Rp0, tp0, hv0, ref_kf = args[:9]
    to_t = lambda x: torch.from_numpy(np.array(x))
    use_stereo = kwargs.get("use_stereo", False)
    ft = interop.frame_from_numpy(frames, device="cpu")
    *_, lm_t, packed_t, _ = ttrack.fused_track_multi(
        to_port(m), to_t(lm0), ft, to_t(R0), to_t(t0), to_t(Rp0), to_t(tp0), to_t(hv0), int(ref_kf), cfg,
        use_stereo=use_stereo)
    lm_j, Pj, Pt, lm_t = np.asarray(out[4]), np.asarray(out[5]), packed_t.numpy(), lm_t.numpy()
    diffs, gaps = [], []
    for b in range(Pj.shape[0]):
        d, g = _row_diffs(Pj[b], Pt[b], prefix=f"frame {b}: ")
        diffs += d
        gaps.append(g)
    if not np.array_equal(lm_j, lm_t):
        diffs.append(f"last frame's lm_ids: {int((lm_j != lm_t).sum())} features")
    last = type(frames)(*[x[-1] for x in frames])
    return {"diffs": diffs, "pose_gap": max(gaps), "n_tracked": [Pj[:, 24].tolist(), Pt[:, 24].tolist()],
            "features": _bound_differently(m, last, lm_j, lm_t, Pj[-1], Pt[-1], cfg, use_stereo), "port_rows": Pt}


def replay_local_ba(args: tuple, out, cfg, near: float = NEAR_M) -> dict:
    """The port's ``local_bundle_adjustment`` on the JAX engine's map after its
    keyframe pipeline, against the JAX pass's output: landmark validity and
    observations equal, the keyframe poses within POSE_TOL, live landmark
    positions within REL_TOL relative."""
    m, slot, iters = args
    m_in = to_port(m)
    mt = tlba.local_bundle_adjustment(m_in, int(slot), cfg, iters=int(iters))
    mj = to_port(out)
    diffs = map_diffs(out, mt)
    kv = mj.kfs.valid
    gap = float(torch.cat([(mj.kfs.R[kv] - mt.kfs.R[kv]).abs().flatten(),
                           (mj.kfs.t[kv] - mt.kfs.t[kv]).abs().flatten()]).max())
    if not gap <= POSE_TOL:
        diffs.append(f"keyframe poses {gap:.3g}")
    # the same window solved in float64: how far each package's float32 poses lie from it
    prob = tlba.build_problem(m_in, int(slot), cfg)
    p64 = type(prob)(*[x.double() if isinstance(x, torch.Tensor) and x.is_floating_point() else x for x in prob])
    R64, t64, _, _ = tlba.solve_ba(p64, cfg, iters=int(iters), chi2_th=cfg.chi2_mono)
    opt = prob.cam_opt
    k = prob.cam_slots[opt].long()
    to64 = [float(torch.cat([(x.kfs.R[k].double() - R64[opt]).abs().flatten(),
                             (x.kfs.t[k].double() - t64[opt]).abs().flatten()]).max()) for x in (mj, mt)]
    # where the landmark differences lie: their depth in the centre keyframe's camera
    live = mj.lms.valid & mt.lms.valid
    a, b = mj.lms.xyz.double(), mt.lms.xyz.double()
    rel = torch.where(live, (a - b).norm(dim=1) / a.norm(dim=1).clamp(min=1e-6), 0.0)
    depth = (a @ mj.kfs.R[int(slot)].double().T + mj.kfs.t[int(slot)].double())[:, 2]
    apart = rel > REL_TOL
    far = live & (depth > near)
    return {"diffs": diffs, "pose_gap": gap, "pose_gap_to_float64": to64, "landmarks_apart": int(apart.sum()),
            "landmarks_apart_within_near_m": int((apart & ~far).sum()),
            "max_rel_beyond_near_m": float(rel[far].max()) if bool(far.any()) else 0.0}


def add_bearing_gate() -> None:
    """An experiment on R11, in this process only: both packages'
    ``_tri_candidates`` also require the bearing rays of a match to part
    before the point counts, 0 < cos < BEARING_COS (ORB-SLAM2's
    ``CreateNewMapPoints`` gate, taken before it triangulates)."""
    j_orig, t_orig = jmap._tri_candidates, tmap._tri_candidates

    def j_gated(Ra, ta, uv_a, desc_a, oct_a, free_a, Rb, tb, uv_b, desc_b, oct_b, free_b, cfg):
        X, good, jb = j_orig(Ra, ta, uv_a, desc_a, oct_a, free_a, Rb, tb, uv_b, desc_b, oct_b, free_b, cfg)
        c, f = jnp.array([cfg.cx, cfg.cy]), jnp.array([cfg.fx, cfg.fy])
        one = jnp.ones((uv_a.shape[0], 1), jnp.float32)
        ra = jnp.concatenate([(uv_a - c) / f, one], -1) @ Ra      # rows R^T x: the rays in the world frame
        rb = jnp.concatenate([(uv_b[jb] - c) / f, one], -1) @ Rb
        cos = jnp.sum(ra * rb, -1) / (jnp.linalg.norm(ra, axis=-1) * jnp.linalg.norm(rb, axis=-1))
        return X, good & (cos > 0) & (cos < BEARING_COS), jb

    def t_gated(Ra, ta, uv_a, desc_a, oct_a, free_a, Rb, tb, uv_b, desc_b, oct_b, free_b, cfg):
        X, good, jb = t_orig(Ra, ta, uv_a, desc_a, oct_a, free_a, Rb, tb, uv_b, desc_b, oct_b, free_b, cfg)
        c = torch.tensor([cfg.cx, cfg.cy], dtype=torch.float32)
        f = torch.tensor([cfg.fx, cfg.fy], dtype=torch.float32)
        one = torch.ones((uv_a.shape[0], 1), dtype=torch.float32)
        ra = torch.cat([(uv_a - c) / f, one], -1) @ Ra
        rb = torch.cat([(uv_b[jb] - c) / f, one], -1) @ Rb
        cos = torch.sum(ra * rb, -1) / (torch.linalg.norm(ra, dim=-1) * torch.linalg.norm(rb, dim=-1))
        return X, good & (cos > 0) & (cos < BEARING_COS), jb

    jmap._tri_candidates, tmap._tri_candidates = j_gated, t_gated


# ---------------------------------------------------------------------------
# both engines over the stereo path
# ---------------------------------------------------------------------------


def window_convergence(m: tcont.MapState, ref_kf: int, cfg, iters=WINDOW_ITERS) -> dict:
    """How far a map's local-BA window around ``ref_kf`` is from its optimum:
    the port's ``build_problem`` of the map, solved in float64 by the plain
    solve for each count of LM iterations; per count the robust cost, the
    largest camera-translation and landmark moves and the landmarks moved by
    more than 0.05. A window at its optimum moves by nothing."""
    prob = tlba.build_problem(m, int(ref_kf), cfg)
    p64 = type(prob)(*[x.double() if isinstance(x, torch.Tensor) and x.is_floating_point() else x for x in prob])
    live = p64.lm_ids < cfg.max_landmarks
    out = {"optimized_cameras": int(p64.cam_opt.sum()), "live_landmarks": int(live.sum()), "solves": []}
    for k in iters:
        _, t, x, cost = tlba.solve_ba(p64, cfg, iters=k, chi2_th=cfg.chi2_mono)
        move = (x - p64.xyz).abs().amax(1)[live]
        out["solves"].append({"iters": k, "cost": float(cost), "max_camera_t_move": float((t - p64.t).abs().max()),
                              "max_landmark_move": float(move.max()), "landmarks_moved": int((move > 0.05).sum())})
    return out


def _centre(rec) -> np.ndarray:
    return -np.asarray(rec.R, np.float64).T @ np.asarray(rec.t, np.float64)


def _metric_ate(eng, scene):
    recs = eng.trajectory
    ok = [i for i, r in enumerate(recs) if r.state == "OK"]
    if len(ok) < 3:
        return None
    pos = np.stack([-R.T @ t for R, t in eng.final_poses()])
    gt = np.stack([-scene.R[recs[i].frame_id].T @ scene.t[recs[i].frame_id] for i in ok])
    return float(ate_rmse(pos[ok], gt, with_scale=False))


def _say(msg: str) -> None:
    print(msg, flush=True)


def drive(seed: int, n_frames: int, frames_from: str, replay: bool, log=_say, window: bool = False) -> dict:
    """Both engines over the first ``n_frames`` pairs of the stereo path on
    ``make_scene(seed)``; replays the tracking step at each frame, and the
    keyframe pipeline and local BA at each of the JAX engine's keyframes,
    when ``replay``; with ``window``, asks how far each engine's last
    local-BA window is from its optimum (``window_convergence``)."""
    from dialog_tpu.frontend import extract_features
    from dialog_tpu.stereo import stereo_match_frames

    tcfg = pmp.kitti_stereo_config().replace(vocab_min_kfs=1000)
    jcfg = reference_config(tcfg)
    scene, pairs = pmp.render_stereo_frames(tcfg, n_frames, seed=seed)
    # ground-truth camera centres in the first camera's frame, where both engines start
    c_gt = np.stack([-scene.R[i].T.astype(np.float64) @ scene.t[i] for i in range(n_frames)])
    gt_c = (c_gt - c_gt[0]) @ scene.R[0].T.astype(np.float64)
    jeng = JEngine(jcfg)
    jeng.loop_closing_enabled = False
    teng = TEngine(tcfg, device="cpu")
    teng.loop_closing_enabled = False
    captured = []
    original = jmap.process_new_keyframe

    def capture(*a, **kw):
        captured.append((jax.device_get(a[:9]), dict(kw)))
        return original(*a, **kw)

    tracked, ba = [], []
    track_orig, ba_orig = jtrack.fused_track_step, jlba.local_bundle_adjustment

    def capture_track(*a, **kw):
        out = track_orig(*a, **kw)
        tracked.append((jax.device_get(a[:8]), dict(kw), jax.device_get(out)))
        return out

    def capture_ba(m, slot, cfg_, iters=10):
        out = ba_orig(m, slot, cfg_, iters=iters)
        ba.append((jax.device_get((m, slot, iters)), jax.device_get(out)))
        return out

    jmap.process_new_keyframe = capture
    if replay:
        jtrack.fused_track_step, jlba.local_bundle_adjustment = capture_track, capture_ba
    frames, keyframes = [], []
    t0 = time.perf_counter()
    try:
        for i, (left, right) in enumerate(pairs):
            ts = float(i) / tcfg.fps
            n_cap = len(captured)
            if frames_from == "jax":
                L, Rr = jnp.asarray(left, jnp.float32), jnp.asarray(right, jnp.float32)
                fr = jeng._undistort(stereo_match_frames(extract_features(L, jcfg), extract_features(Rr, jcfg),
                                                         jcfg, img_left=L, img_right=Rr))
                a = jeng.track_features(fr, ts)
                b = teng.track_features(interop.frame_from_numpy(jax.device_get(fr), device="cpu"), ts)
            elif frames_from == "port":
                L, Rr = torch.from_numpy(left), torch.from_numpy(right)
                fr = teng._undistort(tstereo.stereo_match_frames(tfront.extract_features(L, tcfg),
                                                                 tfront.extract_features(Rr, tcfg), tcfg,
                                                                 img_left=L, img_right=Rr))
                a = jeng.track_features(type(fr)(*[jnp.asarray(interop.tensor_to_numpy(x, f))
                                                   for f, x in zip(fr._fields, fr)]), ts)
                b = teng.track_features(fr, ts)
            else:
                a = jeng.track_stereo(jnp.asarray(left), jnp.asarray(right), ts)
                b = teng.track_stereo(left, right, ts)
            row = {"frame": i, "jax": [a.state, int(a.n_tracked), jeng.kf_count],
                   "port": [b.state, int(b.n_tracked), teng.kf_count],
                   "centre_gap_m": float(np.linalg.norm(_centre(a) - _centre(b))),
                   "gt_err_m": [float(np.linalg.norm(_centre(r) - gt_c[i])) for r in (a, b)],
                   "lms_jax": [int(jeng.m.num_lms), int(jnp.sum(jeng.m.lms.valid))],
                   "lms_port": [int(teng.m.num_lms), int(teng.m.lms.valid.sum())]}
            frames.append(row)
            log(f"frame {i}: jax {a.state} tracked={a.n_tracked} kfs={jeng.kf_count} "
                f"lms={row['lms_jax'][0]}/{row['lms_jax'][1]} | port {b.state} tracked={b.n_tracked} "
                f"kfs={teng.kf_count} lms={row['lms_port'][0]}/{row['lms_port'][1]} | "
                f"centre gap {row['centre_gap_m']:.3g} m, from the truth {row['gt_err_m'][0]:.3g} / "
                f"{row['gt_err_m'][1]:.3g} m  t={time.perf_counter() - t0:.0f}s")
            if replay and tracked:
                tr = replay_track(*tracked[-1], tcfg)
                row["track_replay"] = tr
                log("  tracking step on the JAX engine's inputs: "
                    + ("agrees" if not tr["diffs"] else f"{tr['diffs']} {json.dumps(tr['features'])}"))
            if replay and len(captured) > n_cap:
                jmap.process_new_keyframe = original
                steps = replay_keyframe(*captured[-1], tcfg, jcfg)
                jmap.process_new_keyframe = capture
                split = [s for s in steps if s["diffs"]]
                kf = {"frame": i, "slot": int(captured[-1][0][7]), "first_split_step": split[0]["step"] if split
                      else None, "split_steps": [s["step"] for s in split],
                      "first_split": split[0] if split else None}
                if split and "candidates" in split[0]:
                    kf["all_rounding_edges"] = all(c.get("rounding_edge") for c in split[0]["candidates"])
                keyframes.append(kf)
                log(f"  keyframe at frame {i}: " + (f"first split at {kf['first_split_step']}: "
                                                    f"{split[0]['diffs']}" if split else "every step agrees"))
                for c in (split[0].get("candidates", []) if split else []):
                    log("    " + json.dumps(c))
            if replay and ba:
                lb = replay_local_ba(*ba[-1], tcfg)
                row["local_ba_replay"] = lb
                log(f"  local BA on the JAX engine's map: " + ("agrees" if not lb["diffs"] else str(lb["diffs"]))
                    + f"; landmarks apart {lb['landmarks_apart']} ({lb['landmarks_apart_within_near_m']} within "
                    f"{NEAR_M} m), beyond it at most {lb['max_rel_beyond_near_m']:.3g} relative; poses from the "
                    f"float64 solve: jax {lb['pose_gap_to_float64'][0]:.3g}, port {lb['pose_gap_to_float64'][1]:.3g}")
            captured.clear()
            tracked.clear()
            ba.clear()
    finally:
        jmap.process_new_keyframe = original
        jtrack.fused_track_step, jlba.local_bundle_adjustment = track_orig, ba_orig
    same = [r["jax"] == r["port"] for r in frames]
    ate_j, ate_t = _metric_ate(jeng, scene), _metric_ate(teng, scene)
    kf_frames = lambda side: [r["frame"] for k, r in enumerate(frames)
                              if r[side][2] > (frames[k - 1][side][2] if k else 0)]
    windows = {"jax": window_convergence(to_port(jeng.m), jeng.ref_kf, tcfg),
               "port": window_convergence(teng.m, teng.ref_kf, tcfg)} if window else None
    for side, w in (windows or {}).items():
        log(f"{side} engine's last window: " + json.dumps(w))
    return {"seed": seed, "frames": n_frames, "frames_from": frames_from, "last_windows": windows,
            "first_decision_split": same.index(False) if False in same else None,
            "ate_m": {"jax": ate_j, "port": ate_t},
            "ate_ratio": None if not (ate_j and ate_t) else ate_t / ate_j,
            "kf_count": {"jax": jeng.kf_count, "port": teng.kf_count},
            "keyframe_frames": {"jax": kf_frames("jax"), "port": kf_frames("port")},
            "keyframes": keyframes, "per_frame": frames, "seconds": time.perf_counter() - t0}


def reference_trace(run: dict) -> dict:
    """The JAX engine's per-frame decisions of a run, as ``chip_smoke.py``
    reads them."""
    return {"source": "tools/stereo_parity_trace.py --reference-out (the JAX engine on the CPU)",
            "workload": "stereo", "seed": run["seed"], "frames": run["frames"],
            "states": [r["jax"][0] for r in run["per_frame"]],
            "n_tracked": [r["jax"][1] for r in run["per_frame"]],
            "keyframe_frames": run["keyframe_frames"]["jax"], "ate_m": run["ate_m"]["jax"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=pmp.STEREO_FRAMES, help="pairs of the stereo path (48)")
    ap.add_argument("--seed", type=int, default=7, help="the scene's seed (7: the path's own)")
    ap.add_argument("--seeds", default="", help="comma-separated seeds: ATE table over them")
    ap.add_argument("--same-frames", action="store_true", help="feed the JAX engine's frame to both engines")
    ap.add_argument("--port-frames", action="store_true", help="feed the port's frame to both engines")
    ap.add_argument("--no-replay", action="store_true", help="skip the step-by-step replays")
    ap.add_argument("--window", action="store_true",
                    help="solve each engine's last local-BA window in float64 for 0, 8 and 40 iterations")
    ap.add_argument("--reference-out", default="", help="write the JAX engine's per-frame decisions here")
    ap.add_argument("--bearing-gate", action="store_true",
                    help="experiment on R11: both packages also gate the bearing rays' parallax (add_bearing_gate)")
    ap.add_argument("--threads", type=int, default=4, help="torch CPU threads")
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    frames_from = "jax" if args.same_frames else "port" if args.port_frames else "own"
    if args.bearing_gate:
        add_bearing_gate()
    if args.seeds:
        runs = []
        for s in [int(x) for x in args.seeds.split(",")]:
            run = drive(s, args.frames, frames_from, not args.no_replay)
            first_kf = next((k for k in run["keyframes"] if k["first_split_step"]), None)
            runs.append({k: run[k] for k in ("seed", "ate_m", "ate_ratio", "kf_count", "keyframe_frames",
                                             "first_decision_split", "seconds")}
                        | {"first_keyframe_split": first_kf})
            print(f"seed {s}: ATE jax {run['ate_m']['jax']} port {run['ate_m']['port']} ratio {run['ate_ratio']} "
                  f"kfs {run['kf_count']} first split frame {run['first_decision_split']}", flush=True)
        ratios = [r["ate_ratio"] for r in runs if r["ate_ratio"] is not None]
        out = {"seeds": runs, "median_ratio": float(np.median(ratios)) if ratios else None,
               "port_at_most_jax": sum(1 for r in ratios if r <= 1.0)}
    else:
        run = drive(args.seed, args.frames, frames_from, not args.no_replay, window=args.window)
        if args.reference_out:
            with open(args.reference_out, "w") as f:
                json.dump(reference_trace(run), f)
                f.write("\n")
        first_kf = next((k for k in run["keyframes"] if k["first_split_step"]), None)
        out = {k: v for k, v in run.items() if k != "per_frame"} | {"first_keyframe_split": first_kf}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
