"""Distributed-BA scaling harness: one rank against N ranks on one problem.

Builds a large synthetic SfM problem (1k+ cameras, 100k+ landmarks —
BASELINE config[3]) and solves it with the engine's global-BA solve
(``global_ba.solve_global_problem``: the matrix-free PCG above
``DENSE_SCHUR_MAX_CAMS`` cameras, the dense reduction, kernel C on the card,
up to there; ``gba_rank.timed_solve``) in this process and over N ranks
(``gba_rank`` processes on a gloo group, each solving its landmark slice),
and reports the time per LM iteration and the scaling efficiency
t_1 / (N t_N). Rank r runs on card r modulo the cards there are: with more
ranks than cards (two ranks on one card, or on the CPU) the ranks share a
device, which validates the sharded path and measures its collective
overhead, not a speed-up, and the record says ``"virtual": true``.

Prints the record as one JSON line; writes it only to ``--out``.

Run: python -m dialog_tpu_torch.eval.bench_scaling [n_cams] [n_pts] [--ranks N] [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch


def make_sfm_problem(cfg, n_cams: int, n_pts: int, seed: int = 0, device="cuda"):
    """Ring of cameras around a large cloud; every point seen by O nearby cams."""
    from .. import geometry as g
    from ..optim.local_ba import BAProblem

    rng = np.random.default_rng(seed)
    O = cfg.max_obs_per_lm
    ang = rng.uniform(0, 2 * np.pi, n_pts)
    rad = rng.uniform(12, 20, n_pts)
    pts = np.stack(
        [rad * np.sin(ang), rng.uniform(-3, 3, n_pts), rad * np.cos(ang)], -1
    ).astype(np.float32)

    Rs = np.zeros((n_cams, 3, 3), np.float32)
    ts = np.zeros((n_cams, 3), np.float32)
    for k in range(n_cams):
        th = 2 * np.pi * k / n_cams
        fwd = np.array([np.sin(th), 0, np.cos(th)])
        eye = 10.0 * fwd
        right = np.cross(fwd, [0, -1, 0]); right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        Rs[k] = np.stack([right, down, fwd])
        ts[k] = -Rs[k] @ eye

    # each point observed by O cameras nearest in ring angle
    cam_angle = 2 * np.pi * np.arange(n_cams) / n_cams
    base = np.argmin(
        np.abs(((ang[:, None] - cam_angle[None, :]) + np.pi) % (2 * np.pi) - np.pi),
        axis=1,
    )
    obs_cam = ((base[:, None] + np.arange(O)[None, :] - O // 2) % n_cams).astype(np.int32)
    Xc = np.einsum("poij,pj->poi", Rs[obs_cam], pts) + ts[obs_cam]
    z = Xc[..., 2]
    u = cfg.fx * Xc[..., 0] / np.maximum(z, 1e-6) + cfg.cx
    v = cfg.fy * Xc[..., 1] / np.maximum(z, 1e-6) + cfg.cy
    ok = (z > 0.2) & (u > 0) & (u < cfg.width) & (v > 0) & (v < cfg.height)
    uv = np.stack([u, v], -1) + rng.normal(0, 0.5, (n_pts, O, 2))

    # perturb
    pts_n = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)
    cam_opt = np.ones(n_cams, bool); cam_opt[:2] = False
    for k in range(2, n_cams):
        xi = rng.normal(0, 0.01, 6).astype(np.float32)
        R2, t2 = g.se3_retract(torch.from_numpy(Rs[k]), torch.from_numpy(ts[k]), torch.from_numpy(xi))
        Rs[k], ts[k] = R2.numpy(), t2.numpy()

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return BAProblem(
        cam_slots=dev(np.arange(n_cams, dtype=np.int32)), cam_opt=dev(cam_opt), R=dev(Rs), t=dev(ts),
        lm_ids=dev(np.arange(n_pts, dtype=np.int32)), xyz=dev(pts_n),
        obs_cam=dev(np.where(ok, obs_cam, n_cams).astype(np.int32)), obs_uv=dev(uv.astype(np.float32)),
        obs_w=dev(ok.astype(np.float32)), obs_ok=dev(ok), obs_feat=dev(np.zeros((n_pts, O), np.int32)),
    )


def main(argv=None) -> dict:
    from ..config import EngineConfig
    from ..gba_rank import config_to_json, free_address, launch, timed_solve

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_cams", nargs="?", type=int, default=1024)
    ap.add_argument("n_pts", nargs="?", type=int, default=131072)
    ap.add_argument("--ranks", type=int, default=None, help="N (default: the cards there are, at least 2)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="also write the record here")
    args = ap.parse_args(argv)
    cards = torch.cuda.device_count() if args.device == "cuda" else 0
    ranks = args.ranks or max(2, cards)
    cfg = EngineConfig(max_obs_per_lm=8)
    prob = make_sfm_problem(cfg, args.n_cams, args.n_pts, device=args.device)
    ms = {"1": timed_solve(prob, cfg) * 1e3}
    print(f"ranks=1: {ms['1']:.1f} ms / LM iteration", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "problem.npz")
        np.savez(path, **{k: v.cpu().numpy() for k, v in prob._asdict().items() if v is not None})
        spec = {"address": free_address(), "world": ranks, "backend": "gloo", "device": args.device,
                "jobs": [{"kind": "problem", "problem": path, "config": config_to_json(cfg),
                          "out": os.path.join(tmp, "out.npz")}]}
        outs = launch(spec, os.path.join(tmp, "job.json"), timeout=3600)
    ms[str(ranks)] = max(float(o[0]["seconds"]) for o in outs) * 1e3
    print(f"ranks={ranks}: {ms[str(ranks)]:.1f} ms / LM iteration", flush=True)
    record = {
        "metric": "global_ba_scaling_efficiency",
        "value": ms["1"] / (ms[str(ranks)] * ranks),
        "devices": ranks,
        "n_cams": args.n_cams,
        "n_pts": args.n_pts,
        "backend": args.device,
        "card": torch.cuda.get_device_name(0) if cards else None,
        "ms_per_iter": ms,
        "virtual": ranks > cards,
    }
    print(json.dumps(record), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return record


if __name__ == "__main__":
    main()
