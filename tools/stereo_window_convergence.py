"""How far the stereo engine's last local-BA window is from its optimum.

    PYTHONPATH=. python3 tools/stereo_window_convergence.py [--out PATH]

Drives ``chip_smoke.py``'s stereo path (48 rendered KITTI00-size pairs) on the
card, then takes the engine's local-BA window around its reference keyframe
twice: as the engine left it, and as ``chip_smoke._check_window`` prepares it
for kernel C's direct-output check (landmarks and optimized poses moved by
seeded noise, near-camera observations left out). On each it runs ``solve_ba``
for 0, 1, 2, 3, 5, 8, 12, 20 and 40 LM iterations, in float64 (the plain
version, on the CPU) and in f32 (kernel C, on the card), and reports the robust cost, the
largest landmark and camera-translation moves and how many landmarks moved by
more than 0.05; then, for the 12 landmarks that 5 float64 iterations move the
most, the condition number of the undamped Hll block, the observations, how
many carry a right-x, their depths and the largest residual.

A window at its optimum would move by nothing; one that keeps moving after
the path's own 8 iterations cannot hold two f32 solves within a tolerance set
for rounding. Prints one JSON object as the last line, and writes it to
``--out``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess

import torch

import chip_smoke
from dialog_tpu_torch.kernels.schur import observation_terms, schur_reduce_plain
from dialog_tpu_torch.optim.local_ba import build_problem, solve_ba

ITERS = (0, 1, 2, 3, 5, 8, 12, 20, 40)
MOVED = 0.05


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON result here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _, _, eng, _, launches = chip_smoke.run_path("stereo", dev)
    cfg = eng.cfg
    result = {"card": card, "keyframes": eng.kf_count, "launches": launches, "windows": {}}
    for label, prob in [("as the engine left it", build_problem(eng.m, eng.ref_kf, cfg)),
                        ("prepared for the direct-output check", chip_smoke._check_window(eng, cfg, dev)[0])]:
        # kernel C is f32 only: the float64 problem lies on the CPU, where solve_ba takes the plain version
        p64 = type(prob)(*[chip_smoke._dbl(x).cpu() if isinstance(x, torch.Tensor) else x for x in prob])
        live = p64.lm_ids < cfg.max_landmarks
        out = {"live_landmarks": int(live.sum()), "observations": int(prob.obs_ok.sum()),
               "optimized_cameras": int(prob.cam_opt.sum()), "solves": []}
        for name, p in [("float64", p64), ("f32", prob)]:
            for k in ITERS:
                _, t, x, cost = solve_ba(p, cfg, iters=k, chi2_th=cfg.chi2_mono)
                move = (x - p.xyz).abs().amax(1).cpu()[live]
                out["solves"].append({"dtype": name, "iters": k, "cost": float(cost), "max_landmark_move": float(move.max()),
                                      "landmarks_moved": int((move > MOVED).sum()),
                                      "max_camera_t_move": float((t - p.t).abs().max())})
                chip_smoke.say(f"{label}: {json.dumps(out['solves'][-1])}")
        _, _, x, _ = solve_ba(p64, cfg, iters=5, chi2_th=cfg.chi2_mono)
        move = (x - p64.xyz).abs().amax(1)
        kw = chip_smoke._stereo_kw(p64, cfg)
        zero = torch.zeros((), dtype=torch.float64)
        ev = torch.linalg.eigvalsh(schur_reduce_plain(p64.R, p64.t, p64.cam_opt, p64.xyz, p64.obs_cam, p64.obs_uv,
                                                      p64.obs_w, zero, cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.chi2_mono,
                                                      **kw)[0])
        cond = torch.where(ev[:, 0] > 0, ev[:, 2] / ev[:, 0], float("inf"))
        safe = torch.clamp(p64.obs_cam, 0, p64.R.shape[0] - 1).long()
        depth = (torch.einsum("poij,pj->poi", p64.R[safe], p64.xyz) + p64.t[safe])[..., 2]
        res = observation_terms(p64.R, p64.t, p64.xyz, p64.obs_cam, p64.obs_uv, p64.obs_ok, cfg.fx, cfg.fy, cfg.cx,
                                cfg.cy, obs_ur=p64.obs_ur, bf=cfg.bf)[0]
        out["ill_conditioned"] = int((live & (cond > chip_smoke.COND_MAX)).sum())
        out["moved_though_well_conditioned"] = int((live & (cond <= chip_smoke.COND_MAX) & (move > MOVED)).sum())
        out["most_moved"] = []
        for i in torch.argsort(torch.where(live, move, -1.0), descending=True)[:12].tolist():
            ok = p64.obs_ok[i]
            out["most_moved"].append({
                "landmark": i, "move": float(move[i]), "hll_condition": float(cond[i]), "observations": int(ok.sum()),
                "with_right_x": int((ok & (p64.obs_ur[i] >= 0)).sum()),
                "depths": [round(float(z), 2) for z in depth[i][ok]], "max_residual_px": float(res[i][ok].abs().max())})
            chip_smoke.say(f"{label}: {json.dumps(out['most_moved'][-1])}")
        result["windows"][label] = out
    text = json.dumps(result)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
