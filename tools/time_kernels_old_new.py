"""Kernels A and B before and after their redesign, timed in turns on one card.

    git show <commit>:dialog_tpu_torch/csrc/fast.cu > build/fast_old.cu
    git show <commit>:dialog_tpu_torch/csrc/hamming.cu > build/hamming_old.cu
    PYTHONPATH=. python3 tools/time_kernels_old_new.py --old-fast build/fast_old.cu \\
        --old-hamming build/hamming_old.cu [--out PATH]

The earlier sources are the one-level FAST kernel (entry point
``fast_nms_rank_launch``: one launch per pyramid level, one 32x8 tile per
block) and the row-wise Hamming kernel (``hamming_best2_launch`` with filled
default gates; a mutual match was two launches, by rows and transposed, and
eight PyTorch kernels for the match test). They are built beside the
repository's kernels with the same nvcc flags and called here as their
wrappers called them.

Timed, old, new, new, old on each shape, by the device's own time per call
(``chip_smoke.device_ms``: ``torch.profiler``, the hand-written kernels by
name plus everything else the call puts on the device) and by the pace of
back-to-back calls (``chip_smoke.time_ms``):

* kernel A on one image's 8 pyramid levels, each rank map in its cell-padded
  buffer as the detector needs it (the old form pads with ``torch.zeros`` and
  a slice copy), at 640x480 (a rendered frame of the mono path) and 1241x376
  (a rendered KITTI-size frame of the stereo path);
* kernel B on one mutual match with the radius and octave gates at
  (N, M) = (2048, 1024) and (8192, 2048).

The old and the new results are compared first (equal, bit for bit). Prints
one JSON object as the last line, and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess

import torch

import chip_smoke
from dialog_tpu_torch import frontend as fe
from dialog_tpu_torch import profile_main_path as pm
from dialog_tpu_torch.kernels import build, common, fast, hamming

FAST_KERNELS = ("fast_nms_rank_kernel", "fast_levels_kernel")
HAMMING_KERNELS = ("hamming_best2_kernel", "hamming_scan_kernel", "hamming_mutual_kernel")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def build_old(src: pathlib.Path, name: str) -> ctypes.CDLL:
    out = build.BUILD_DIR / f"lib{name}_old.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(out))


def old_detect_ranks(lib, levels, min_th, th_fast, border, cell):
    """The earlier detector's kernel A part: one launch per level, then the
    rank map copied into a zeroed cell-aligned buffer."""
    out = []
    for img in levels:
        H, W = img.shape
        s = torch.empty_like(img)
        common.check(lib.fast_nms_rank_launch(common.ptr(img), common.ptr(s), H, W, min_th, th_fast, border,
                                              common.stream_ptr(img.device)), "old fast_nms_rank")
        padded = torch.zeros((-(-H // cell) * cell, -(-W // cell) * cell), dtype=s.dtype, device=s.device)
        padded[:H, :W] = s
        out.append(padded)
    return out


def old_best2(lib, a, b, va, vb, uva, uvb, r2_rows, r2_cols, oa, ob, band):
    """The earlier wrapper's fills and call."""
    N, M, dev = a.shape[0], b.shape[0], a.device
    if r2_rows is None:
        r2_rows = torch.full((N,), -1.0, dtype=torch.float32, device=dev)
    if r2_cols is None:
        r2_cols = torch.full((M,), -1.0, dtype=torch.float32, device=dev)
    idx = torch.empty((N,), dtype=torch.int32, device=dev)
    best, second = torch.empty_like(idx), torch.empty_like(idx)
    common.check(lib.hamming_best2_launch(*[common.ptr(x) for x in (a, b, va, vb, uva, uvb, r2_rows, r2_cols, oa, ob)],
                                          band, N, M, common.ptr(idx), common.ptr(best), common.ptr(second),
                                          common.stream_ptr(dev)), "old hamming_best2")
    return idx, best, second


def old_mutual(lib, x, band, max_dist, ratio):
    """The earlier ``mutual_match_fused``: two launches and the match test in PyTorch."""
    fwd, best, second = old_best2(lib, x["a"], x["b"], x["va"], x["vb"], x["uva"], x["uvb"], x["r2"], None,
                                  x["oa"], x["ob"], band)
    rev, _, _ = old_best2(lib, x["b"], x["a"], x["vb"], x["va"], x["uvb"], x["uva"], None, x["r2"],
                          x["ob"], x["oa"], band)
    N = x["a"].shape[0]
    safe = torch.clamp(fwd, 0, max(x["b"].shape[0] - 1, 0)).long()
    mutual = rev[safe] == torch.arange(N, device=fwd.device)
    ok = (fwd >= 0) & (best <= max_dist) & (best.to(torch.float32) < ratio * second.to(torch.float32)) & mutual
    return torch.where(ok, fwd, -1).to(torch.int32), best


def turns(run: dict, order, own, reps) -> list:
    rounds = []
    for which in order:
        t = chip_smoke.device_ms(run[which], own, reps=reps)
        rounds.append({"kernel": which, "device_ms": t["device_ms"], "stages_ms": t["stages_ms"],
                       "other_device_ms": t["other_device_ms"],
                       "all_device_ms": t["device_ms"] + t["other_device_ms"],
                       "wrapper_loop_ms": chip_smoke.time_ms(run[which], reps=reps)})
        chip_smoke.say(json.dumps(rounds[-1]))
    return rounds


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old-fast", required=True, type=pathlib.Path, help="the earlier fast.cu (module doc)")
    ap.add_argument("--old-hamming", required=True, type=pathlib.Path, help="the earlier hamming.cu")
    ap.add_argument("--out", default=None, help="also write the JSON result here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    build.load_all()
    old_fast = build_old(args.old_fast, "fast")
    old_fast.fast_nms_rank_launch.restype = _I
    old_fast.fast_nms_rank_launch.argtypes = [_P, _P, _I, _I, _F, _F, _I, _P]
    old_ham = build_old(args.old_hamming, "hamming")
    old_ham.hamming_best2_launch.restype = _I
    old_ham.hamming_best2_launch.argtypes = [_P] * 10 + [_I] * 3 + [_P] * 4
    result = {"card": card, "fast": {}, "hamming_mutual": {}}

    for name, make_cfg, make_frames in [("mono 640x480", pm.tum_mono_config, pm.render_frames),
                                        ("kitti 1241x376", pm.kitti_stereo_config, pm.render_stereo_frames)]:
        cfg = make_cfg()
        frame = make_frames(cfg, n=1)[1][0]
        img = torch.from_numpy(frame[0] if isinstance(frame, tuple) else frame).to(dev)
        pyr = fe.build_pyramid(img, cfg)
        th = (float(cfg.min_th_fast), float(cfg.ini_th_fast), fe.BORDER)

        run = {"old": lambda: old_detect_ranks(old_fast, pyr, *th, fe.CELL),
               "new": lambda: fast.fast_nms_rank_levels(pyr, *th, pad_to=fe.CELL)}
        want = run["old"]()
        equal = all(torch.equal(o, n) for o, n in zip(want, run["new"]()))
        chip_smoke.say(f"kernel A {name}: {len(pyr)} levels, {sum(p.numel() for p in pyr)} pixels, "
                       f"old and new equal: {equal}")
        if not equal:
            chip_smoke.fail(f"kernel A: the old and the new kernel differ on {name}")
        result["fast"][name] = {
            "levels": [list(p.shape) for p in pyr], **chip_smoke.fast_bound(pyr, want),
            "rounds": turns(run, ("old", "new", "new", "old"), FAST_KERNELS, reps=30)}

    for n, m in [(2048, 1024), (8192, 2048)]:
        x = chip_smoke._hamming_inputs(n, m, 3, dev)
        kw = dict(uv_a=x["uva"], uv_b=x["uvb"], radius2=x["r2"], oct_a=x["oa"], oct_b=x["ob"], octave_band=1,
                  max_dist=100, ratio=0.9)
        run = {"old": lambda: old_mutual(old_ham, x, 1, 100, 0.9),
               "new": lambda: hamming.mutual_match_fused(x["a"], x["b"], x["va"], x["vb"], **kw)}
        want, got = run["old"](), run["new"]()
        equal = all(torch.equal(o, g) for o, g in zip(want, got))
        chip_smoke.say(f"kernel B mutual match N={n} M={m}: {int((got[0] >= 0).sum())} matches, "
                       f"old and new equal: {equal}")
        if not equal:
            chip_smoke.fail(f"kernel B: the old and the new mutual match differ at N={n} M={m}")
        result["hamming_mutual"][f"N={n} M={m}"] = {
            **chip_smoke.hamming_bound(x, got, 1),
            "rounds": turns(run, ("old", "new", "new", "old"), HAMMING_KERNELS, reps=30)}

    text = json.dumps(result)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
