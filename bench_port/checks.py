"""The output check: the window's sampled answers against the plain reference.

Run after the window has closed and the program's state is freed. Each
number is a reading of what the timed path produced at the timed sizes,
against the reference worked out again from the benchmark's inputs (the
rendered images) or from the program's state at the call:

* ``kp_mismatch``: the share of keypoints, program's and reference's
  together, that only one side has (sampled frames; kernel A and the
  selection around it);
* ``desc_bit_err``: the share of descriptor bits that differ, over the
  keypoints both have;
* ``ur_err``: stereo only; the share of keypoints both have whose right-image
  x differs by more than 1e-4 px or exists on one side only;
* ``match_mismatch``: rows of kernel B's gated mutual matches (sampled calls)
  whose answer differs (exact);
* ``pose_px``, ``pose_split``: the tracking step's poses (sampled calls)
  against the reference's from the same inputs, run with the configuration's
  iterations, chi2 bound and stereo rows: the largest pixel distance where the
  answer is determinate, and the share of calls whose inlier sets the two
  classify apart (``pose_readings``). A run in which no sampled call was
  determinate has no ``pose_px``, and a missing number fails the run;
* ``schur_terms_err``: kernel C's reduced camera system S = Hcc - S_pair
  against the reference's, |dS|_F / (|Hcc|_F + |S_pair|_F), the largest over
  the sampled calls; ``schur_step_err``: the local BA step solved from the
  program's system, held to the reference's system by its normwise backward
  error; ``schur_lm_err``: the landmark side of the step (Y, g_l, Hll^-1), each
  against its terms (``reference.schur.measures``);
* ``unanswered``, ``stuck``, ``lost``: frames of the window that got no
  record, tracked frames whose pose repeats the previous tracked frame's bit
  for bit, and frames the engine reports LOST (counts; exact: the cells'
  sweep is a fixed scene that the port tracks whole, so a lost frame is a
  fault of the timed path).

With ``control`` the reference is also run in float32 and in the TF32
control (``reference.precision``) and read against itself in float64, by
the same measures, and the pose step's reference with two planted faults
(``POSE_FAULTS``): those readings are printed, and set the limits' upper
ends; they do not enter ``correct``.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import frontend as ref_frontend
from .reference import matching as ref_matching
from .reference import pose as ref_pose
from .reference import schur as ref_schur

NAMES = ("kp_mismatch", "desc_bit_err", "ur_err", "match_mismatch", "pose_px", "pose_split", "schur_terms_err",
         "schur_step_err", "schur_lm_err", "unanswered", "stuck", "lost")
UR_TOL_PX = 1e-4
_POP = np.array([bin(i).count("1") for i in range(256)], np.int64)


def _keys(xy: np.ndarray, octave: np.ndarray) -> dict:
    return {(int(o), int(x), int(y)): i for i, (o, (x, y)) in enumerate(zip(octave, xy))}


def _program_features(frame, cam: dict):
    """(level xy, octave, descriptor bytes, right-x) of a program FrameArrays' valid keypoints."""
    v = frame.valid.cpu().numpy()
    octave = frame.octave.cpu().numpy().astype(np.int64)[v]
    uv = frame.uv_raw.double().cpu().numpy()[v]
    xy = np.rint(uv / (cam["scale_factor"] ** octave)[:, None]).astype(np.int64)
    desc = np.ascontiguousarray(frame.desc.cpu().numpy()[v]).view(np.uint8).reshape(-1, 32)
    return xy, octave, desc, frame.u_right.double().cpu().numpy()[v]


def _compare(a_keys, a_desc, a_ur, b_keys, b_desc, b_ur, acc: dict) -> None:
    common = [(a_keys[k], b_keys[k]) for k in a_keys.keys() & b_keys.keys()]
    acc["kp_diff"] += len(a_keys.keys() ^ b_keys.keys())
    acc["kp_total"] += len(a_keys) + len(b_keys)
    if common:
        ia, ib = (np.array(x) for x in zip(*common))
        acc["bits"] += int(_POP[a_desc[ia] ^ b_desc[ib]].sum())
        acc["bit_total"] += 256 * len(common)
        if a_ur is not None:
            ua, ub = a_ur[ia], b_ur[ib]
            has_a, has_b = ua >= 0, ub >= 0
            bad = (has_a != has_b) | (has_a & has_b & (np.abs(ua - ub) > UR_TOL_PX))
            acc["ur_diff"] += int(bad.sum())
            acc["ur_total"] += len(common)


def _new_acc():
    return dict(kp_diff=0, kp_total=0, bits=0, bit_total=0, ur_diff=0, ur_total=0)


def _shares(acc: dict, stereo: bool) -> dict:
    out = {"kp_mismatch": acc["kp_diff"] / max(acc["kp_total"], 1), "desc_bit_err": acc["bits"] / max(acc["bit_total"], 1)}
    if stereo:
        out["ur_err"] = acc["ur_diff"] / max(acc["ur_total"], 1)
    return out


def frontend_readings(samples, stream, cam: dict, stereo: bool, modes) -> dict:
    """mode -> readings: "program" against the f64 reference, and each other mode against it."""
    accs = {m: _new_acc() for m in ("program",) + tuple(modes)}
    for ks, batch in samples:
        k = ks[0]
        frame = type(batch)(*[x[0] for x in batch])
        img_l = stream.left[k]
        img_r = stream.right[k] if stereo else None
        ref = {}
        for mode in ("f64",) + tuple(modes):
            left = ref_frontend.extract(img_l, cam, mode)
            ur = None
            if stereo:
                right = ref_frontend.extract(img_r, cam, mode)
                ur = ref_frontend.stereo_right_x(left, right, img_l, img_r, cam, mode)
            ref[mode] = (_keys(left.xy, left.octave), left.desc, ur)
        xy, octave, desc, ur_p = _program_features(frame, cam)
        _compare(_keys(xy, octave), desc, ur_p if stereo else None, *ref["f64"], accs["program"])
        for mode in modes:
            _compare(*ref[mode], *ref["f64"], accs[mode])
    return {m: _shares(a, stereo) for m, a in accs.items()}


def match_readings(samples) -> dict:
    diff = rows = 0
    for args, kwargs, out in samples:
        desc_a, desc_b, valid_a, valid_b = args[:4]
        ref = ref_matching.mutual_match(desc_a, desc_b, valid_a, valid_b, kwargs.get("uv_a"), kwargs.get("uv_b"),
                                        kwargs.get("radius2"), kwargs.get("oct_a"), kwargs.get("oct_b"),
                                        kwargs.get("octave_band", -1), kwargs.get("max_dist", 50),
                                        kwargs.get("ratio", 1.0))
        diff += int((out[0].long() != ref).sum())
        rows += int(valid_a.sum())
    return {"program": {"match_mismatch": diff / max(rows, 1)}}


SETTLED_PX = 1e-3
# faults planted in the float64 reference put in the program's place: half the iterations
# (a less-converged pose), and the chi2 bound lowered by chi2_mono / chi2_stereo (the mono bound on
# stereo rows: a classification fault)
POSE_FAULTS = {"iters_half": lambda kw: dict(kw, iters=kw["iters"] // 2),
               "chi2_low": lambda kw: dict(kw, chi2_th=kw["chi2_th"] * 5.991 / 7.815)}


def pose_readings(samples, cam: dict, modes, engine: dict) -> tuple[dict, int]:
    """(mode -> {``pose_px``, ``pose_split``}, calls judged) over the sampled calls of the pose step.

    The reference runs each call's inputs with the configuration's iterations, chi2 bound
    and stereo rows (the call's own count of rounds). A call whose answer has at least
    ``min_inliers_local`` inliers (a pose the engine keeps) is judged. Where the two classify
    the observations alike, and the reference's answer is determinate (its last round kept its
    own classification, and ten more iterations move it less than ``SETTLED_PX``), the pixel
    distance between the two poses counts toward ``pose_px``; where no judged call of the
    program is, ``pose_px`` is None. ``pose_split`` is the share of judged calls whose inlier
    sets differ: a decision at the chi2 bound that float32 and float64 can take apart, after
    which the two poses optimize different sets."""
    stereo = engine["sensor"] == "STEREO"
    acc = {m: {"pose_px": 0.0, "split": 0, "kept": 0, "judged": 0} for m in ("program",) + tuple(modes)}
    for args, kwargs, res in samples:
        R0, t0, X, uv, inv_s2, valid = args[:6]
        c = dict(cam, bf=engine.get("bf", 0.0))
        kw = dict(chi2_th=engine["chi2_stereo" if stereo else "chi2_mono"], rounds=kwargs.get("rounds", 4),
                  iters=engine["pose_opt_iters"], u_right=kwargs.get("u_right") if stereo else None)
        R, t, inl, base = ref_pose.pose_optimization(R0, t0, X, uv, inv_s2, valid, c, mode="f64", **kw)
        determinate = bool(torch.equal(inl, base)) and ref_pose.settled(
            R, t, X, uv, inv_s2, base, c, kw["chi2_th"], kw["u_right"]) < SETTLED_PX
        answers = {"program": (res.R, res.t, res.inlier)}
        for mode in modes:
            if mode in POSE_FAULTS:
                answers[mode] = ref_pose.pose_optimization(R0, t0, X, uv, inv_s2, valid, c, mode="f64",
                                                           **POSE_FAULTS[mode](kw))[:3]
            else:
                answers[mode] = ref_pose.pose_optimization(R0, t0, X, uv, inv_s2, valid, c, mode=mode, **kw)[:3]
        for m, (Ra, ta, inl_a) in answers.items():
            if int(inl_a.sum()) < int(engine["min_inliers_local"]):
                continue
            a = acc[m]
            a["kept"] += 1
            if not torch.equal(inl_a, inl):
                a["split"] += 1
            elif determinate:
                a["judged"] += 1
                a["pose_px"] = max(a["pose_px"], ref_pose.pose_px(Ra, ta, R, t, X, valid, c))
    out = {m: {"pose_px": a["pose_px"] if a["judged"] else None, "pose_split": a["split"] / max(a["kept"], 1)}
           for m, a in acc.items()}
    return out, acc["program"]["judged"]


_SCHUR_OUT = ("Hll_inv", "g_l", "Y", "Hcc", "g_c", "g_red", "S_pair")
_SCHUR_NAMES = {"s_terms": "schur_terms_err", "step_backward": "schur_step_err", "lm_terms": "schur_lm_err"}


def schur_readings(samples, cam: dict, modes) -> dict:
    """mode -> the compared numbers' largest readings over the sampled calls of kernel C."""
    worst = {}
    for args, kwargs, out in samples:
        if kwargs.get("lm_opt") is not None:
            continue   # the frozen-landmark mode is block BA's, not a cell's
        names = ("R", "t", "cam_opt", "xyz", "obs_cam", "obs_uv", "obs_w", "lam")
        inputs = dict(zip(names, args[:8]))
        inputs.update(delta2=kwargs.get("delta2", 5.991), delta2_stereo=kwargs.get("delta2_stereo", 7.815),
                      obs_ur=kwargs.get("obs_ur"))
        c = dict(cam, bf=kwargs.get("bf", 0.0))
        ref = ref_schur.reduce(inputs, c, "f64")
        lam = float(inputs["lam"])
        got = {"program": ref_schur.measures(dict(zip(_SCHUR_OUT, out)), ref, inputs["cam_opt"], lam)}
        for mode in modes:
            if mode not in POSE_FAULTS:
                got[mode] = ref_schur.measures(ref_schur.reduce(inputs, c, mode), ref, inputs["cam_opt"], lam)
        for m, meas in got.items():
            w = worst.setdefault(m, {})
            for k, v in meas.items():
                w[_SCHUR_NAMES[k]] = max(w.get(_SCHUR_NAMES[k], 0.0), v)
    return worst


def run(runner, window: dict, control: bool) -> tuple[dict, dict]:
    """(compared numbers, other readings) of one run."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from .harness import camera

    cam = camera(runner.conf)
    modes = ("f32", "tf32") + tuple(POSE_FAULTS) if control else ()
    s = runner.probes.samples
    items = lambda k: [x for x in s[k].items if x is not None] if k in s else []  # noqa: E731
    readings = {}

    def merge(r):
        for m, d in r.items():
            readings.setdefault(m, {}).update({k: v for k, v in d.items() if v is not None})

    merge(frontend_readings(items("frames"), runner.stream, cam, runner.stereo,
                            tuple(m for m in modes if m not in POSE_FAULTS)))
    merge(match_readings(items("match")))
    pose, judged = pose_readings(items("pose"), cam, modes, runner.conf["engine"])
    merge(pose)
    merge(schur_readings(items("schur"), cam, modes))
    merge({"program": {k: float(v) for k, v in window["liveness"].items() if k in NAMES}})
    counts = {"frames": len(items("frames")), "match": len(items("match")), "pose": len(items("pose")),
              "pose_judged": judged, "schur": len(items("schur"))}
    return readings["program"], {"control": {m: readings.get(m, {}) for m in modes}, "samples": counts}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, name -> [reading, limit]) over the numbers the configuration compares."""
    table = {}
    ok = True
    for name in NAMES:
        if name not in numbers or name not in limits:
            continue
        v, lim = float(numbers[name]), float(limits[name])
        table[name] = [v, lim]
        ok &= v <= lim and np.isfinite(v)
    return bool(ok), table
