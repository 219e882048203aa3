"""Kernel C before and after its redesign, timed in turns on one card.

    git show <commit>:dialog_tpu_torch/csrc/schur.cu > build/schur_old.cu
    PYTHONPATH=. python3 tools/time_schur_old_new.py --old build/schur_old.cu [--out PATH]

``--old`` is the earlier source, whose pass 1 keeps one [6C, 6C] slab of
S_pair partials per block of 16 landmarks in global memory and whose pass 2
sums them (entry point ``schur_reduce_launch`` with one ``part`` buffer of
``schur_num_blocks(P) * (36 C^2 + 48 C)`` floats). It is built beside the
repository's kernel with the same nvcc flags and called here as its wrapper
called it.

The script drives ``chip_smoke.py``'s mono and stereo paths to get the two
engines' local-BA windows (C=32, P=2048, O=8 and C=64, P=8192, O=12, made fit
for a comparison as ``chip_smoke.check_schur`` does), checks that the two
kernels agree on them, and times old, new, new, old on each by the device's
own time per call (``chip_smoke.device_ms``: ``torch.profiler``, the kernels by
name) and by the pace of back-to-back wrapper calls (``chip_smoke.time_ms``).
The engines' windows after 56 and 48 frames hold few keyframes, so a third
shape, ``full``, fills the stereo window's capacities: C=64 with 32 optimized
cameras, P=8192, O=12, every slot live, each landmark seen by 12 distinct
cameras drawn at random, a right-x on half the slots (seeded).

The new kernel is timed as ``solve_ba`` calls it, its camera index built
outside the call; the index's own device time (``cam_index_device_ms``) is
reported per shape, so that one solve of k iterations costs k old calls
against the index plus k new ones. Prints one JSON object as the last line,
and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess

import numpy as np
import torch

import chip_smoke
from dialog_tpu_torch import geometry as geo
from dialog_tpu_torch.kernels import build, common
from dialog_tpu_torch.kernels.schur import camera_index, schur_reduce
from dialog_tpu_torch.optim.local_ba import BAProblem

# every kernel either design launches, by name
SCHUR_KERNELS = ("schur_pass1", "schur_pass2", "schur_obs", "schur_cams")


def build_old(src: pathlib.Path) -> ctypes.CDLL:
    out = build.BUILD_DIR / "libschur_old.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(out))


def full_window(cfg, dev, seed: int = 11) -> BAProblem:
    """The stereo window's capacities filled (module doc)."""
    rng = np.random.default_rng(seed)
    C, P, O = cfg.max_local_kfs + cfg.max_fixed_kfs, cfg.max_local_lms, cfg.max_obs_per_lm
    f32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=dev)  # noqa: E731
    R, t = geo.se3_retract(torch.eye(3).repeat(C, 1, 1), torch.zeros(C, 3),
                           torch.tensor(rng.normal(0, 0.03, (C, 6)), dtype=torch.float32))
    pts = np.stack([rng.uniform(-8, 8, P), rng.uniform(-3, 3, P), rng.uniform(6, 40, P)], -1)
    obs_cam = np.argsort(rng.random((P, C)), axis=1)[:, :O].astype(np.int32)
    Xc = np.einsum("poij,pj->poi", R.numpy()[obs_cam], pts) + t.numpy()[obs_cam]
    uv = np.stack([cfg.fx * Xc[..., 0] / Xc[..., 2] + cfg.cx, cfg.fy * Xc[..., 1] / Xc[..., 2] + cfg.cy], -1)
    uv += rng.normal(0, 0.5, uv.shape)
    ur = np.where(rng.random((P, O)) < 0.5, uv[..., 0] - cfg.bf / Xc[..., 2] + rng.normal(0, 0.5, (P, O)), -1.0)
    cam_opt = np.arange(C) < cfg.max_local_kfs
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)  # noqa: E731
    return BAProblem(cam_slots=i32(np.arange(C)), cam_opt=torch.tensor(cam_opt, device=dev), R=f32(R).contiguous(),
                     t=f32(t).contiguous(), lm_ids=i32(np.arange(P)), xyz=f32(pts), obs_cam=i32(obs_cam),
                     obs_uv=f32(uv), obs_w=torch.ones((P, O), dtype=torch.float32, device=dev),
                     obs_ok=torch.ones((P, O), dtype=torch.bool, device=dev), obs_feat=i32(np.zeros((P, O))),
                     obs_ur=f32(ur))


def old_reduce(lib, prob, cfg, lam, kw):
    """The earlier wrapper's allocations and call."""
    stereo = bool(kw)
    C, (P, O), dev = prob.R.shape[0], prob.obs_cam.shape, prob.xyz.device
    f32 = dict(dtype=torch.float32, device=dev)
    hll_inv, g_l, Y = torch.empty((P, 3, 3), **f32), torch.empty((P, 3), **f32), torch.empty((P, O, 6, 3), **f32)
    n_out = 36 * C * C + 48 * C
    part = torch.empty((max(lib.schur_num_blocks(P), 1) * n_out,), **f32)
    cam_out = torch.empty((n_out,), **f32)
    fn = lib.schur_reduce_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_float] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 6
    err = fn(*[common.ptr(x) for x in (prob.R, prob.t, prob.cam_opt, prob.xyz, prob.obs_cam, prob.obs_uv, prob.obs_w)],
             common.ptr(kw["obs_ur"]) if stereo else None, common.ptr(lam),
             cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.chi2_mono, kw.get("bf", 0.0), kw.get("delta2_stereo", 0.0),
             int(stereo), C, P, O, common.ptr(hll_inv), common.ptr(g_l), common.ptr(Y), common.ptr(part),
             common.ptr(cam_out), common.stream_ptr(dev))
    common.check(err, "old schur_reduce")
    S, H = 36 * C * C, 36 * C * C + 36 * C
    return (hll_inv, g_l, Y, cam_out[S:H].reshape(C, 6, 6), cam_out[H:H + 6 * C].reshape(C, 6),
            cam_out[H + 6 * C:].reshape(C, 6), cam_out[:S].reshape(C, 6, C, 6))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True, type=pathlib.Path, help="the earlier schur.cu (module doc)")
    ap.add_argument("--out", default=None, help="also write the JSON result here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    build.load_all()
    old = build_old(args.old)
    lam = torch.tensor(1e-4, dtype=torch.float32, device=dev)
    result = {"card": card, "shapes": {}}
    cfg = None
    for path in ("mono", "stereo", "full"):
        if path == "full":
            prob = full_window(cfg, dev)
        else:
            _, _, eng, _, _ = chip_smoke.run_path(path, dev)
            cfg = eng.cfg
            prob = chip_smoke._check_window(eng, cfg, dev)[0]
        kw = chip_smoke._stereo_kw(prob, cfg)
        idx = camera_index(prob.obs_cam, prob.obs_w, prob.R.shape[0])
        a = (prob.R, prob.t, prob.cam_opt, prob.xyz, prob.obs_cam, prob.obs_uv, prob.obs_w, lam,
             cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.chi2_mono)

        run = {"old": lambda: old_reduce(old, prob, cfg, lam, kw),
               "new": lambda: schur_reduce(*a, **kw, cam_index=idx)}
        rel = max(chip_smoke._rel_err(g, w, per_block=k == 0) for k, (g, w) in enumerate(zip(run["new"](), run["old"]())))
        C, (P, O) = prob.R.shape[0], prob.obs_cam.shape
        rounds = []
        for which in ("old", "new", "new", "old"):
            t = chip_smoke.device_ms(run[which], SCHUR_KERNELS, reps=10)
            rounds.append({"kernel": which, "device_ms": t["device_ms"], "stages_ms": t["stages_ms"],
                           "other_device_ms": t["other_device_ms"],
                           "wrapper_loop_ms": chip_smoke.time_ms(run[which], reps=10)})
            chip_smoke.say(f"{path} C={C} P={P} O={O} {json.dumps(rounds[-1])}")
        index_ms = chip_smoke.device_ms(lambda: camera_index(prob.obs_cam, prob.obs_w, C), (), reps=10)
        result["shapes"][path] = {"C": C, "P": P, "O": O, "live_observations": int(prob.obs_ok.sum()),
                                  "optimized_cameras": int(prob.cam_opt.sum()), "new_against_old_max_rel_err": rel,
                                  "cam_index_device_ms": index_ms["other_device_ms"], "rounds": rounds}
    text = json.dumps(result)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
