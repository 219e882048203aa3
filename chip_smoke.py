"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; exits non-zero without them. It

1. prints the card's name and power limit (nvidia-smi);
2. builds kernels A, B and C from dialog_tpu_torch/csrc/ with nvcc for sm_90a,
   one nvcc per source, all started together;
3. drives the mono path, ``Engine(cfg, device="cuda").track_image`` over 56
   rendered frames of the TUM-class 640x480 monocular configuration (kernel A
   once per image, all pyramid levels in one launch; kernel B once per mutual
   match);
4. checks kernel C (BA Schur reduction). Direct outputs against the plain
   version, and bitwise repeatability, on the local-BA problem built from the
   engine's own map, its landmarks and optimized poses moved off the optimum
   by seeded noise and its near-camera observations left out. The solve (the
   path's 5 LM iterations, kernel against plain against float64) on a seeded
   synthetic window of the path's shape (C=32, P=2048, O=8), so that the
   check does not depend on where the run's trajectory ended;
5. drives the stereo path, ``Engine.track_stereo`` over 48 rendered 1241x376
   pairs at the KITTI00 preset (bench.py's capacities), and checks kernel C's
   stereo (uR) variant as in 4: direct outputs on that engine's window, the
   8-iteration solve on a seeded window (C=64, P=8192, O=12, a right-x on
   half the observations);
6. drives the RGB-D path, ``Engine.track_rgbd`` over 24 rendered 640x480
   frames with their depth maps at the TUM1 RGB-D settings;
7. drives the batched paths at bench.py's batch of 8. ``mono_batch``: 8 frames
   one by one, then 12 batches through ``frontend.extract_features_batch``
   (kernel A once for the whole batch) and ``Engine.track_batch`` at keyframe
   interval 10, ``flush`` at the end; the first half of the batch at frame 48
   is blanked, so the run goes LOST mid-batch, re-tracks and relocalizes
   (vocabulary, PnP RANSAC). ``stereo_batch``: 4 pairs one by one, then 5
   batches through ``stereo.extract_and_match_stereo_batch`` (16 images in one
   launch of kernel A). Beside each, a per-frame twin on the same frames, and
   a ``torch.profiler`` window of 16 frames behind both (launches, syncs and
   ``.item()`` reads per frame: printed, not gated). Then a relocalization
   probe on the mono_batch engine (a tracked frame, the engine set LOST,
   ``_try_relocalize``: the pose within 0.03 map units and 1 degree of the
   tracked one), with the seconds of one vocabulary training, one
   ``solve_pnp_ransac`` and one relocalization; and 24 frames through
   ``Engine.track_features_async``;
8. checks kernel A (FAST rank: level by level and all levels of the mono and
   the stereo pyramid in one launch, odd sizes, a 32-level table; over a batch:
   one real batch of each batched path against the plain version and against
   one-image launches, odd sizes) and kernel
   B (gated Hamming best/second, and the one-pass mutual match against its
   two-call plain form, with and without each gate, with ties and empty
   sides) against their plain PyTorch versions on the card, bit for bit;
9. times each kernel at its path's shapes: the device's own time per call
   under ``torch.profiler`` (the kernel's launches by name, kernel C's two
   stages apart), the pace of back-to-back wrapper calls between two CUDA
   events (host work included), the plain version likewise, and the least
   time the card could take for the same inputs (bytes over 3.35 TB/s or
   operations over 67 TFLOP/s f32, whichever is larger).

Each path runs on a fresh engine, with every kernel's launch count reset just
before it and read just after (``hamming_best2``, the standalone form of
kernel B, is on no path since the mutual mode: its own check launches it). It
prints one JSON line with the kernels, the
nvidia-smi line, and as its last line ``{"ok": true, "device": {...}}``. Any
failed check exits non-zero before that line. Nothing here imports JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from dialog_tpu_torch.profile_main_path import (BATCH, FPS_FIRST, MONO_BATCH_FRAMES, N_FRAMES, STEREO_BATCH_FRAMES,
                                                WORKLOADS, extract_batch, profiled, track_batches, track_frames)

# tolerances: A and B are integer/min-max computations and must be bit-exact;
# C sums in another order than the plain version (f32)
REL_TOL_C = 1e-4        # direct outputs: max |kernel - plain| / max |plain| per output
LAM_C = 1e-2            # LM damping of the direct comparison (see check_schur)
SOLVE_TOL_RT = 2e-3     # R, t after a 5-iteration solve (kernels/selfcheck bounds)
SOLVE_TOL_XYZ = 5e-3    # landmark xyz after the same solve
LM_NOISE = 3e-3         # landmark perturbation, map units (N(0, .) per coordinate)
POSE_NOISE = 5e-3       # optimized-pose perturbation, twist (N(0, .) per component)
PERTURB_SEED = 5        # numpy seed of both perturbations
NEAR_DEPTH = 0.05       # observations nearer than this share of the median depth are left out
COND_MAX = 1e4          # stereo solve: landmarks whose undamped Hll is worse conditioned are held in pixels (check_schur_solve)
SOLVE_SEED = 11         # numpy seed of the seeded solve windows
# the seeded windows' live part: (cameras, two of them fixed; landmarks, each seen by min(O, cameras); right-x share)
SEEDED_MONO = (11, 250, 0.0)
SEEDED_STEREO = (6, 486, 0.5)
ATE_GATE = 0.35         # metres, the reference's image-in-the-loop gate (similarity-aligned)
# metres, metric ATE (rigid alignment, no scale) of the stereo path: twice the
# reference engine's own 0.1226 m on the same 48 frames (tools/reference_ate.py, PERF.md)
STEREO_ATE_GATE = 0.25
RGBD_ATE_GATE = 0.05    # metres, metric: the reference's stereo/RGB-D gate (tests/test_stereo_rgbd.py)
# the batched paths: (workload, frames, frames fed one by one first, first frame of the half-blanked batch,
# whether a codebook must exist by then and a relocalization must succeed). The stereo run is too short for a
# codebook (vocab_min_kfs keyframes): its blanked frames are recovered by re-tracking from the last pose.
BATCH_PATHS = {"mono_batch": ("mono", MONO_BATCH_FRAMES, 8, 48, True),
               "stereo_batch": ("stereo", STEREO_BATCH_FRAMES, 4, 28, False)}
KF_INTERVAL = 10        # bench.py's primary workload, tum_mono_kf10
PROFILE_FRAMES = 2 * BATCH   # the profiler's window behind each batched path, and behind its per-frame twin
ASYNC_FRAMES = 24       # the pipelined per-frame probe
BATCH_OK_SHARE = 0.9    # OK share after the first OK frame, outside the blanked frames
# the relocalization probe: a tracked frame relocalized from LOST, against the pose it was tracked at.
# Positions in map units (a monocular map's median depth is 1 at initialization), rotations in degrees.
RELOC_POS_TOL = 0.03
RELOC_ROT_TOL_DEG = 1.0

# published peaks of one H100 SXM at its full 700 W: HBM3, and f32 outside the tensor cores
# (integer and min/max operations are counted at the same rate)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# the hand-written kernels one wrapper call launches, by (a substring of) their names
DEVICE_KERNELS = {
    "fast_nms_rank": ("fast_levels_kernel",),
    "fast_nms_rank_batch": ("fast_levels_kernel",),
    "hamming_best2": ("hamming_scan_kernel",),
    "hamming_mutual": ("hamming_scan_kernel", "hamming_mutual_kernel"),
    "schur_reduce": ("schur_obs", "schur_cams"),
    "schur_reduce_stereo": ("schur_obs", "schur_cams"),
}
HOST_PACED = 1.5        # a wrapper loop this many times slower than the device's own time is paced by the host

KERNELS = {
    "fast_nms_rank": ("dialog_tpu_torch/csrc/fast.cu", "dialog_tpu/kernels/fast.py:118"),
    "fast_nms_rank_batch": ("dialog_tpu_torch/csrc/fast.cu", "dialog_tpu/kernels/fast.py:118"),
    "hamming_best2": ("dialog_tpu_torch/csrc/hamming.cu", "dialog_tpu/kernels/hamming.py:131"),
    "hamming_mutual": ("dialog_tpu_torch/csrc/hamming.cu", "dialog_tpu/kernels/hamming.py:131"),
    "schur_reduce": ("dialog_tpu_torch/csrc/schur.cu", "dialog_tpu/kernels/schur.py:293"),
    "schur_reduce_stereo": ("dialog_tpu_torch/csrc/schur.cu", "dialog_tpu/kernels/schur.py:293"),
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """The pace of ``reps`` back-to-back calls, ms per call, between two CUDA
    events: the device's time where the device is the slower side, the
    host's (wrapper, allocations, ctypes) where it is."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device_ms(fn, own: tuple, reps: int = 20, warm: int = 3) -> dict:
    """The device's own time of one call of ``fn``, from ``torch.profiler``
    over ``reps`` calls: ``stages_ms`` maps each hand-written kernel of
    ``own`` (a substring of its name) to its mean time per launch times its
    launches per call, ``device_ms`` is their sum, ``other_device_ms`` what
    the call's other device work takes (fills, copies, PyTorch's own
    kernels), and ``shortest_launch_ms`` the shortest single kernel seen. The
    profiler may drop a launch's record, so a stage counts the records it
    has. With no name in ``own`` the call is PyTorch's alone and all of its
    device time is ``other_device_ms``."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    seen = {k: [] for k in own}
    other, shortest = 0.0, float("inf")
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = (e.time_range.end - e.time_range.start) * 1e-3
        mine = [k for k in own if k in e.name]
        if mine:
            seen[mine[0]].append(ms)
        else:
            other += ms / reps
        if not e.name.startswith(("Memcpy", "Memset")):
            shortest = min(shortest, ms)
    if own and not any(seen.values()):
        n_dev = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
        fail(f"the profiler saw no launch of {own} in {reps} calls ({n_dev} device records in all): "
             f"no device time to report")
    stages = {k: sum(v) / len(v) * max(1, round(len(v) / reps)) for k, v in seen.items() if v}
    return {"device_ms": sum(stages.values()), "stages_ms": stages, "other_device_ms": other,
            "shortest_launch_ms": shortest}


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: each input byte read once and each
    output byte written once at HBM_BYTES_PER_S, or the operations at
    F32_OPS_PER_S, whichever is larger."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bound_bytes": int(n_bytes), "bound_ops": int(n_ops)}


def nbytes(*tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors)


# ---------------------------------------------------------------------------
# kernel A
# ---------------------------------------------------------------------------


def hold_equal(what: str, got, want) -> float:
    """Fail unless the two lists of tensors agree in length, shapes, types and
    every element; returns the largest absolute difference over them (0 for
    empty tensors)."""
    torch.cuda.synchronize()
    if len(got) != len(want) or any(g.shape != w.shape or g.dtype != w.dtype for g, w in zip(got, want)):
        fail(f"{what}: the kernel's outputs differ from its plain version's in number, shape or type")
    diff = max([float((g.double() - w.double()).abs().max()) for g, w in zip(got, want) if g.numel()], default=0.0)
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    say(f"{what}: equal={same} max_abs_diff={diff}")
    if not same:
        fail(f"{what}: the kernel differs from its plain version")
    return diff


def check_fast(paths, dev) -> float:
    """Kernel A against its plain version, bit for bit: each level of the
    first image of every path in ``paths`` ((name, image, config) triples) on
    its own and all of them in one launch, into plain and into cell-aligned
    zero-padded outputs; two random images at other thresholds; a list of
    odd random sizes; a 32-level table."""
    from dialog_tpu_torch import frontend as fe
    from dialog_tpu_torch.kernels.fast import (MAX_LEVELS, fast_nms_rank, fast_nms_rank_levels,
                                               fast_nms_rank_levels_plain, fast_nms_rank_plain)

    err = 0.0

    def hold(name, got, want):
        nonlocal err
        err = max(err, hold_equal(f"kernel A {name}", got, want))

    rng = np.random.default_rng(1)
    rand = lambda h, w: torch.from_numpy(rng.uniform(0, 255, (h, w)).astype(np.float32)).to(dev)  # noqa: E731
    for pname, image, cfg in paths:
        th = (float(cfg.min_th_fast), float(cfg.ini_th_fast), fe.BORDER)
        pyr = fe.build_pyramid(torch.from_numpy(image).to(dev), cfg)
        for l, img in enumerate(pyr):
            hold(f"fast_nms_rank {pname} level{l} {tuple(img.shape)}", [fast_nms_rank(img, *th)],
                 [fast_nms_rank_plain(img, *th)])
        for pad in (1, fe.CELL):
            hold(f"fast_nms_rank_levels {pname} pyramid, {len(pyr)} levels, pad_to={pad}",
                 fast_nms_rank_levels(pyr, *th, pad_to=pad), fast_nms_rank_levels_plain(pyr, *th, pad_to=pad))
    rnd = rand(123, 210)
    for th in [(7.0, 20.0, 19), (3.0, 10.0, 8), (0.0, 5.0, 0), (-1.0, 4.0, 3)]:
        hold(f"fast_nms_rank random 123x210 {th}", [fast_nms_rank(rnd, *th)], [fast_nms_rank_plain(rnd, *th)])
    odd = [rand(h, w) for h, w in [(61, 63), (62, 14), (15, 125), (1, 1), (7, 300), (129, 65), (40, 39)]]
    for th, pad in [((7.0, 20.0, 19), 1), ((2.0, 9.0, 4), 16), ((5.0, 12.0, 1), 5)]:
        hold(f"fast_nms_rank_levels {len(odd)} odd sizes {th} pad_to={pad}",
             fast_nms_rank_levels(odd, *th, pad_to=pad), fast_nms_rank_levels_plain(odd, *th, pad_to=pad))
    many = [rand(30 + 3 * i, 97 - 2 * i) for i in range(MAX_LEVELS)]
    hold(f"fast_nms_rank_levels {MAX_LEVELS} levels", fast_nms_rank_levels(many, 4.0, 15.0, 6, pad_to=8),
         fast_nms_rank_levels_plain(many, 4.0, 15.0, 6, pad_to=8))
    return err


def check_fast_batch(batches, dev) -> float:
    """Kernel A over a batch of images in one launch against its plain
    version, bit for bit: each real batch of ``batches`` ((name, images
    [B, H, W], config) triples: the pyramid of one batch the batched frontend
    saw), into cell-aligned outputs and plain ones, and image by image
    against the one-image launch; then stacks of odd random sizes."""
    from dialog_tpu_torch import frontend as fe
    from dialog_tpu_torch.kernels.fast import (fast_nms_rank_levels, fast_nms_rank_levels_batch,
                                               fast_nms_rank_levels_batch_plain)

    err = 0.0
    for pname, images, cfg in batches:
        th = (float(cfg.min_th_fast), float(cfg.ini_th_fast), fe.BORDER)
        pyr = fe.build_pyramid(torch.from_numpy(images).to(dev), cfg)
        for pad in (fe.CELL, 1):
            got = fast_nms_rank_levels_batch(pyr, *th, pad_to=pad)
            err = max(err, hold_equal(f"kernel A fast_nms_rank_levels_batch {pname} {tuple(images.shape)}, "
                                      f"{len(pyr)} levels, pad_to={pad}", got,
                                      fast_nms_rank_levels_batch_plain(pyr, *th, pad_to=pad)))
        single = [fast_nms_rank_levels([p[b] for p in pyr], *th, pad_to=1) for b in range(images.shape[0])]
        hold_equal(f"kernel A fast_nms_rank_levels_batch {pname} against {images.shape[0]} one-image launches",
                   got, [torch.stack([s[l] for s in single]) for l in range(len(pyr))])
    rng = np.random.default_rng(2)
    odd = [torch.from_numpy(rng.uniform(0, 255, (3, h, w)).astype(np.float32)).to(dev)
           for h, w in [(61, 63), (62, 14), (15, 125), (1, 1), (7, 300), (129, 65), (40, 39)]]
    for th, pad in [((7.0, 20.0, 19), 1), ((2.0, 9.0, 4), 16), ((5.0, 12.0, 1), 5)]:
        err = max(err, hold_equal(f"kernel A fast_nms_rank_levels_batch 3 x {len(odd)} odd sizes {th} pad_to={pad}",
                                  fast_nms_rank_levels_batch(odd, *th, pad_to=pad),
                                  fast_nms_rank_levels_batch_plain(odd, *th, pad_to=pad)))
    return err


# ---------------------------------------------------------------------------
# kernel B
# ---------------------------------------------------------------------------


def _hamming_inputs(n, m, seed, dev):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return dict(
        a=t(rng.integers(0, 2**32, (n, 8), dtype=np.uint32).view(np.int32)),
        b=t(rng.integers(0, 2**32, (m, 8), dtype=np.uint32).view(np.int32)),
        va=t(rng.random(n) > 0.1), vb=t(rng.random(m) > 0.1),
        uva=t(rng.uniform(0, 640, (n, 2)).astype(np.float32)),
        uvb=t(rng.uniform(0, 640, (m, 2)).astype(np.float32)),
        r2=t((rng.uniform(20, 200, n) ** 2).astype(np.float32)),
        r2c=t((rng.uniform(20, 200, m) ** 2).astype(np.float32)),
        oa=t(rng.integers(0, 8, n).astype(np.int32)), ob=t(rng.integers(0, 8, m).astype(np.int32)),
    )


def _gate_cases(x):
    return [
        ("plain", {}),
        ("spatial", dict(uv_a=x["uva"], uv_b=x["uvb"], radius2=x["r2"])),
        ("oct", dict(oct_a=x["oa"], oct_b=x["ob"], octave_band=1)),
        ("spatial+oct", dict(uv_a=x["uva"], uv_b=x["uvb"], radius2=x["r2"],
                             oct_a=x["oa"], oct_b=x["ob"], octave_band=1)),
    ]


def check_hamming(dev) -> tuple[float, float]:
    """Kernel B against its plain versions, bit for bit: ``hamming_best2``
    with and without each gate and with column radii, its lowest-column tie
    rule, and the mutual mode (``mutual_match_fused`` on the card against the
    two-call plain form) with and without each gate, on few distinct
    descriptors (ties everywhere), on closed gates and on empty sides.
    Returns the largest difference of each."""
    from dialog_tpu_torch.kernels.hamming import (hamming_best2, hamming_best2_filled, mutual_match_fused,
                                                  mutual_match_plain)

    errs = {"hamming_best2": 0.0, "hamming_mutual": 0.0}

    def hold(kernel, name, got, want):
        errs[kernel] = max(errs[kernel], hold_equal(f"kernel B {kernel} {name}", got, want))

    for n, m in [(700, 900), (2048, 1024)]:
        x = _hamming_inputs(n, m, 0, dev)
        for name, kw in _gate_cases(x) + [("col-radius", dict(uv_a=x["uva"], uv_b=x["uvb"], radius2_cols=x["r2c"]))]:
            hold("hamming_best2", f"N={n} M={m} {name}", hamming_best2(x["a"], x["b"], x["va"], x["vb"], **kw),
                 hamming_best2_filled(x["a"], x["b"], x["va"], x["vb"], **kw))
    # ties go to the lowest column
    a = _hamming_inputs(8, 8, 7, dev)["a"]
    b = torch.cat([a, a])
    ones8 = torch.ones(8, dtype=torch.bool, device=dev)
    idx, best, second = hamming_best2(a, b, ones8, torch.ones(16, dtype=torch.bool, device=dev))
    torch.cuda.synchronize()
    tie_ok = torch.equal(idx.cpu(), torch.arange(8, dtype=torch.int32)) and int(best.abs().sum()) == 0 \
        and int(second.abs().sum()) == 0
    say(f"kernel B hamming_best2 tie-break lowest column: ok={tie_ok}")
    if not tie_ok:
        fail("kernel B tie-break is not the lowest column")

    # the mutual mode
    match = dict(max_dist=110, ratio=0.9)
    for n, m in [(700, 900), (2048, 1024), (8192, 2048)]:
        x = _hamming_inputs(n, m, 1, dev)
        for name, kw in _gate_cases(x):
            args = (x["a"], x["b"], x["va"], x["vb"])
            hold("hamming_mutual", f"N={n} M={m} {name}", mutual_match_fused(*args, **kw, **match),
                 mutual_match_plain(*args, **kw, **match))
    x = _hamming_inputs(600, 500, 2, dev)
    few = _hamming_inputs(5, 5, 3, dev)["a"]
    rng = np.random.default_rng(4)
    ta = few[torch.from_numpy(rng.integers(0, 5, 600)).to(dev)]
    tb = few[torch.from_numpy(rng.integers(0, 5, 500)).to(dev)]
    sp = dict(uv_a=x["uva"], uv_b=x["uvb"], radius2=x["r2"])
    none_a, none_b = torch.zeros_like(x["va"]), torch.zeros_like(x["vb"])
    for name, args, kw in [
        ("ties: 5 distinct descriptors", (ta, tb, x["va"], x["vb"]), dict(max_dist=256, ratio=2.0)),
        ("ties under the gates", (ta, tb, x["va"], x["vb"]), dict(**_gate_cases(x)[3][1], max_dist=256, ratio=2.0)),
        ("all ties: one descriptor", (ta[:1].expand(600, 8).contiguous(), ta[:1].expand(500, 8).contiguous(),
                                     x["va"], x["vb"]), dict(max_dist=256, ratio=2.0)),
        ("closed gates", (x["a"], x["b"], x["va"], x["vb"]),
         dict(uv_a=x["uva"], uv_b=x["uvb"] + 5000.0, radius2=x["r2"], **match)),
        ("no valid row", (x["a"], x["b"], none_a, x["vb"]), dict(**sp, **match)),
        ("no valid column", (x["a"], x["b"], x["va"], none_b), dict(**sp, **match)),
        ("N=0", (x["a"][:0], x["b"], x["va"][:0], x["vb"]), match),
        ("M=0", (x["a"], x["b"][:0], x["va"], x["vb"][:0]), match),
    ]:
        hold("hamming_mutual", name, mutual_match_fused(*args, **kw), mutual_match_plain(*args, **kw))
    return errs["hamming_best2"], errs["hamming_mutual"]


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------


def run_path(name, dev):
    """Render the workload ``name`` and track it on a fresh engine, launch
    counts reset just before and read just after; returns (scene, frames,
    engine, frames/s over frames FPS_FIRST.., launches)."""
    from dialog_tpu_torch.kernels import common
    from dialog_tpu_torch.system import Engine

    make_cfg, make_frames, method, fps_in = WORKLOADS[name]
    cfg = make_cfg()
    scene, frames = make_frames(cfg)
    eng = Engine(cfg, device=dev)
    common.reset_launch_counts()
    for first in range(0, FPS_FIRST, 8):
        track_frames(eng, method, frames, first, first + 8, fps_in)
        rec = eng.trajectory[-1]
        say(f"{name} frame {rec.frame_id}: {rec.state} tracked={rec.n_tracked} kfs={eng.kf_count}")
    wall = track_frames(eng, method, frames, FPS_FIRST, len(frames), fps_in)
    launches = dict(common.launches)
    return scene, frames, eng, (len(frames) - FPS_FIRST) / wall, launches


def path_ate(eng, scene, with_scale: bool) -> float:
    """ATE (RMSE, metres) of the engine's OK frames against the scene's ground
    truth: similarity-aligned with ``with_scale``, else rigidly (metric)."""
    from dialog_tpu_torch.eval.ate import ate_rmse
    from dialog_tpu_torch.system import OK

    recs = [r for r in eng.trajectory if r.state == OK]
    est = np.stack([-R.T @ t for (R, t), r in zip(eng.final_poses(), eng.trajectory) if r.state == OK])
    gt = np.stack([-scene.R[r.frame_id].T @ scene.t[r.frame_id] for r in recs])
    return ate_rmse(est, gt, with_scale=with_scale)


def check_path(name, eng, scene, launches, *, with_scale: bool, ate_gate: float, min_kfs: int,
               min_launches: dict, max_launches: dict) -> dict:
    """The path's gates: state OK at the end, OK share > 0.95 after the
    first OK frame, at least ``min_kfs`` keyframes, a finite ATE below
    ``ate_gate`` (similarity-aligned with ``with_scale``, else metric), at
    least ``min_launches[k]`` launches of each kernel k, and at most
    ``max_launches[k]`` (kernel A: one launch per image, so a return to one
    launch per pyramid level shows)."""
    from dialog_tpu_torch.system import OK

    states = [r.state for r in eng.trajectory]
    if OK not in states:
        fail(f"{name}: the engine never initialized")
    first_ok = states.index(OK)
    ok_share = float(np.mean([s == OK for s in states[first_ok:]]))
    ate = path_ate(eng, scene, with_scale)
    n_lms = int(eng.m.lms.valid.sum())
    out = dict(state=eng.state, kf_count=eng.kf_count, n_landmarks=n_lms, first_ok=first_ok,
               ok_share=ok_share, ate_m=ate, ate_scale_aligned=with_scale, launches=launches)
    say(f"{name} path: " + json.dumps(out))
    if eng.state != OK:
        fail(f"{name}: state at the end is {eng.state}")
    if eng.kf_count < min_kfs:
        fail(f"{name}: kf_count {eng.kf_count} < {min_kfs}")
    if not ok_share > 0.95:
        fail(f"{name}: OK share {ok_share} <= 0.95")
    if not (np.isfinite(ate) and ate < ate_gate):
        fail(f"{name}: ATE {ate} m not below {ate_gate} m")
    for k, n in min_launches.items():
        if launches[k] < n:
            fail(f"{name}: kernel {k} launched {launches[k]} < {n} times")
    for k, n in max_launches.items():
        if launches[k] > n:
            fail(f"{name}: kernel {k} launched {launches[k]} > {n} times")
    return out


# ---------------------------------------------------------------------------
# the batched and pipelined paths
# ---------------------------------------------------------------------------


def _counted(eng, method: str, counts: dict, key: str, hit=lambda out: True):
    """Wrap ``eng.<method>`` (on the instance) so that ``counts[key]`` counts
    its calls whose result satisfies ``hit``."""
    inner = getattr(eng, method)

    def wrapper(*args, **kwargs):
        out = inner(*args, **kwargs)
        counts[key] += bool(hit(out))
        return out

    setattr(eng, method, wrapper)


def run_batch_path(name, dev):
    """The batched path ``name`` as bench.py drives its warm-up: the first
    frames one by one through the engine's image entry, then batches of BATCH
    through the batched frontend and ``Engine.track_batch`` (mono: at
    ``kf_interval`` 10, with the first half of the batch that starts at frame
    48 blanked, which sends the run LOST mid-batch), ``flush`` at the end.
    Launch counts are reset just before and read just after. A per-frame twin
    (a fresh engine, the image entry over the same frames, no blanking) gives
    the frames/s to set beside.

    Returns a dict: scene, frames, engine, twin, launches, counts (batches,
    pulls, relocalization calls and successes), frames/s of both.
    """
    from dialog_tpu_torch.kernels import common
    from dialog_tpu_torch.system import Engine

    workload, n_frames, n_single, occlude_at, _ = BATCH_PATHS[name]
    make_cfg, make_frames, method, fps_in = WORKLOADS[workload]
    cfg = make_cfg()
    scene, frames = make_frames(cfg, n_frames + PROFILE_FRAMES)

    def engine():
        eng = Engine(cfg, device=dev)
        if workload == "mono":
            eng.kf_interval = KF_INTERVAL
        return eng

    eng = engine()
    counts = {"batches": 0, "pulls": 0, "reloc_calls": 0, "reloc_recovered": 0, "vocab_at_occlusion": False}
    _counted(eng, "_try_relocalize", counts, "reloc_calls")
    _counted(eng, "_try_relocalize", counts, "reloc_recovered", hit=lambda rec: rec is not None)
    _counted(eng, "_start_pull", counts, "pulls")
    common.reset_launch_counts()
    track_frames(eng, method, frames, 0, n_single, fps_in)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_single, n_frames - BATCH + 1, BATCH):
        if i == occlude_at:
            counts["vocab_at_occlusion"] = eng._vocab is not None and eng.kf_count >= cfg.vocab_min_kfs
        batch = extract_batch(cfg, frames, i, dev, blank=BATCH // 2 if i == occlude_at else 0)
        out = eng.track_batch(batch, [float(i + j) / fps_in for j in range(BATCH)])
        counts["batches"] += 1
        if out:
            say(f"{name} batch at frame {i}: resolved frames {out[0].frame_id}-{out[-1].frame_id} "
                f"{[r.state for r in out].count('OK')}/{len(out)} OK, tracked={out[-1].n_tracked} kfs={eng.kf_count}")
    eng.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(common.launches)
    counts = dict(counts)     # as the path left them: the profiled window behind it goes on counting

    twin = engine()
    track_frames(twin, method, frames, 0, n_single, fps_in)
    twin_wall = track_frames(twin, method, frames, n_single, n_frames, fps_in)
    return dict(scene=scene, frames=frames, eng=eng, twin=twin, launches=launches, counts=counts,
                fps=(n_frames - n_single) / wall, twin_fps=(n_frames - n_single) / twin_wall)


def check_batch_path(name, run, *, with_scale: bool, ate_gate: float) -> dict:
    """The batched path's gates: a record for every frame, in frame order,
    after ``flush``; state OK at the end; OK share above BATCH_OK_SHARE after
    the first OK frame, the blanked frames left out; a finite ATE below
    ``ate_gate``; kernel A launched exactly once per batched frontend call
    and once per image fed one by one; ``hamming_mutual`` at least once per
    tracked frame; kernel C at least once; one pull per batch queued; on the
    blanked frames LOST records and a relocalization attempt each; where the
    path is long enough for one (``BATCH_PATHS``), a codebook by the blanked
    batch and at least one successful relocalization."""
    from dialog_tpu_torch.system import LOST, OK

    workload, n_frames, n_single, occlude_at, needs_reloc = BATCH_PATHS[name]
    eng, launches, counts = run["eng"], run["launches"], run["counts"]
    stereo = workload == "stereo"
    if [r.frame_id for r in eng.trajectory] != list(range(n_frames)):
        fail(f"{name}: {len(eng.trajectory)} records for {n_frames} frames, or out of frame order")
    if eng._pending_b or eng._pending:
        fail(f"{name}: work left in flight after flush")
    states = [r.state for r in eng.trajectory]
    if OK not in states:
        fail(f"{name}: the engine never initialized")
    first_ok = states.index(OK)
    blanked = set(range(occlude_at, occlude_at + BATCH // 2))
    ok_share = float(np.mean([s == OK for i, s in enumerate(states) if i >= first_ok and i not in blanked]))
    ate = path_ate(eng, run["scene"], with_scale)
    twin_ate = path_ate(run["twin"], run["scene"], with_scale)
    out = dict(state=eng.state, kf_count=eng.kf_count, n_landmarks=int(eng.m.lms.valid.sum()), first_ok=first_ok,
               ok_share=ok_share, lost_frames=[i for i, s in enumerate(states) if s == LOST], ate_m=ate,
               ate_scale_aligned=with_scale, launches=launches, **counts,
               per_frame_twin=dict(state=run["twin"].state, kf_count=run["twin"].kf_count, ate_m=twin_ate))
    say(f"{name} path: " + json.dumps(out))
    if eng.state != OK:
        fail(f"{name}: state at the end is {eng.state}")
    if not ok_share > BATCH_OK_SHARE:
        fail(f"{name}: OK share {ok_share} <= {BATCH_OK_SHARE} outside the blanked frames")
    if not (np.isfinite(ate) and ate < ate_gate):
        fail(f"{name}: ATE {ate} m not below {ate_gate} m")
    want = {"fast_nms_rank_batch": counts["batches"], "fast_nms_rank": n_single * (2 if stereo else 1)}
    for k, n in want.items():
        if launches[k] != n:
            fail(f"{name}: kernel A as {k} launched {launches[k]} times, not {n}: one per batched frontend call "
                 f"({counts['batches']}), one per image fed one by one")
    n_tracked = sum(1 for r in eng.trajectory[first_ok + 1:] if r.state == OK)
    if launches["hamming_mutual"] < n_tracked:
        fail(f"{name}: hamming_mutual launched {launches['hamming_mutual']} times for {n_tracked} tracked frames")
    if launches["schur_reduce_stereo" if stereo else "schur_reduce"] < 1:
        fail(f"{name}: kernel C was not launched")
    if counts["pulls"] > counts["batches"] or counts["pulls"] < 1:
        fail(f"{name}: {counts['pulls']} host pulls for {counts['batches']} batches")
    if not blanked <= set(out["lost_frames"]):
        fail(f"{name}: the blanked frames {sorted(blanked)} are not all LOST: {out['lost_frames']}")
    if counts["reloc_calls"] < len(blanked):
        fail(f"{name}: {counts['reloc_calls']} relocalization attempts for {len(blanked)} blanked frames")
    if needs_reloc:
        if not counts["vocab_at_occlusion"]:
            fail(f"{name}: no codebook yet at the blanked batch (frame {occlude_at})")
        if counts["reloc_recovered"] < 1:
            fail(f"{name}: no relocalization succeeded in {counts['reloc_calls']} attempts")
    return out


def profile_batch_path(name, run, smi) -> dict:
    """Launches, stream syncs and ``.item()`` reads per frame from one
    ``torch.profiler`` window of PROFILE_FRAMES frames behind the path: the
    batched engine through its batched entries, its per-frame twin through
    the image entry, on the same frames. Printed, not gated."""
    workload, n_frames = BATCH_PATHS[name][:2]
    _, _, method, fps_in = WORKLOADS[workload]
    last = n_frames + PROFILE_FRAMES
    runs = {
        "batched": profiled(lambda: track_batches(run["eng"], run["frames"], n_frames, last, fps_in)),
        "per_frame": profiled(lambda: track_frames(run["twin"], method, run["frames"], n_frames, last, fps_in)),
    }
    out = {}
    for k, p in runs.items():
        if p["device_kernels"] < 1:
            fail(f"{name}: the profiler recorded no device kernel in the {k} window")
        rows = {r: p["syncs"].get(r, 0) / PROFILE_FRAMES for r in
                ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize", "aten::item")}
        out[k] = dict(device_kernels_per_frame=p["device_kernels"] / PROFILE_FRAMES, **rows, wall_s=p["wall_s"],
                      idle_share=1.0 - p["device_busy_s"] / p["wall_s"])
    c = run["counts"]
    say(f"{name}: {run['fps']:.3f} frames/s batched (B={BATCH}, its blanked batch and relocalization included) "
        f"beside {run['twin_fps']:.3f} frames/s per frame on the same frames; host pulls per batch "
        f"{c['pulls'] / max(c['batches'], 1):.3f}; per frame under the profiler ({PROFILE_FRAMES} frames): "
        + json.dumps(out) + f" on {smi}")
    return out


def async_probe(dev, smi) -> dict:
    """A stretch of the mono workload through the pipelined per-frame entry:
    8 frames one by one, ASYNC_FRAMES through ``extract_features`` +
    ``track_features_async``, ``flush``. Gates: a record per frame, in order;
    never more than ``pipeline_depth`` frames in flight; state OK at the end
    and on every frame after the first OK one."""
    from dialog_tpu_torch.frontend import extract_features
    from dialog_tpu_torch.system import OK, Engine

    make_cfg, make_frames, method, fps_in = WORKLOADS["mono"]
    cfg = make_cfg()
    _, frames = make_frames(cfg, 8 + ASYNC_FRAMES)
    eng = Engine(cfg, device=dev)
    eng.kf_interval = KF_INTERVAL
    track_frames(eng, method, frames, 0, 8, fps_in)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    deepest = 0
    for i in range(8, len(frames)):
        eng.track_features_async(extract_features(torch.from_numpy(frames[i]).to(dev), cfg), float(i) / fps_in)
        deepest = max(deepest, len(eng._pending))
    eng.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    states = [r.state for r in eng.trajectory]
    out = dict(frames=len(states), state=eng.state, kf_count=eng.kf_count, deepest_in_flight=deepest,
               frames_per_s=ASYNC_FRAMES / wall)
    say("async probe: " + json.dumps(out) + f" on {smi}")
    if [r.frame_id for r in eng.trajectory] != list(range(len(frames))):
        fail("async probe: not one record per frame, in order")
    if eng.state != OK or OK not in states or any(s != OK for s in states[states.index(OK):]):
        fail(f"async probe: states {states}")
    if deepest > eng.pipeline_depth or eng._pending:
        fail(f"async probe: {deepest} frames in flight (depth {eng.pipeline_depth}), {len(eng._pending)} left")
    return out


def reloc_probe(run, dev, smi) -> dict:
    """Relocalization on a settled engine: the last frame the batched mono
    engine tracked, the engine set LOST, ``_try_relocalize`` of that frame.
    The recovered pose must lie within RELOC_POS_TOL map units and
    RELOC_ROT_TOL_DEG degrees of the pose the frame was tracked at. Also
    times, on this engine's map: one vocabulary training with its idf and
    BoW rows (``_ensure_vocab`` from no codebook), ``train_vocab`` alone, and
    one ``solve_pnp_ransac`` on the probe's own problem."""
    from dialog_tpu_torch import pnp, tracking, vocab
    from dialog_tpu_torch.containers import FrameArrays
    from dialog_tpu_torch.system import LOST

    eng, frames = run["eng"], run["frames"]
    cfg = eng.cfg
    fid = len(frames) - 1
    rec0 = eng.trajectory[fid]
    if rec0.frame_id != fid or rec0.state != "OK":
        fail(f"relocalization probe: frame {fid} was not tracked ({rec0.state})")
    R0, t0 = eng.final_poses()[fid]
    frame = FrameArrays(*[x[BATCH - 1] for x in extract_batch(cfg, frames, fid - BATCH + 1, dev)])

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    eng.state, eng._vel = LOST, None
    rec, reloc_s = timed(lambda: eng._try_relocalize(frame, rec0.timestamp))
    if rec is None:
        fail("relocalization probe: _try_relocalize did not recover a tracked frame")
    pos = float(np.abs(-rec.R.T @ rec.t - (-R0.T @ t0)).max())
    rot = float(np.degrees(np.arccos(np.clip((np.trace(rec.R @ R0.T) - 1.0) / 2.0, -1.0, 1.0))))
    # the probe's own PnP problem, and the map's vocabulary from nothing
    lm_ids, _ = tracking.match_reference_kf(eng.m, rec.ref_kf, frame, cfg)
    X, uv, _, ok = tracking.gather_track_problem(eng.m, frame, lm_ids, cfg)
    pick = pnp.draw_pnp_sets(ok, cfg.pnp_ransac_iters, eng._gen)
    solve = lambda: pnp.solve_pnp_ransac(X, uv, ok, cfg.fx, cfg.fy, cfg.cx, cfg.cy, pick)  # noqa: E731
    solve()
    res, pnp_s = timed(solve)
    kfs = eng.m.kfs
    desc = kfs.desc.reshape(-1, 8)
    valid = (kfs.feat_valid & kfs.valid[:, None]).reshape(-1)
    _, train_s = timed(lambda: vocab.train_vocab(desc, valid, eng._vocab.words, n_words=cfg.vocab_words, iters=4))
    eng._vocab = None
    _, vocab_s = timed(eng._ensure_vocab)
    out = dict(frame=fid, candidate_kf=rec.ref_kf, n_inliers=rec.n_tracked, pos_err_map_units=pos, rot_err_deg=rot,
               relocalization_s=reloc_s, solve_pnp_ransac_s=pnp_s, pnp_points=int(ok.sum()),
               pnp_inliers=int(res.n_inliers), pnp_iters=cfg.pnp_ransac_iters, train_vocab_s=train_s,
               ensure_vocab_s=vocab_s, vocab_words=cfg.vocab_words, vocab_descriptor_slots=int(desc.shape[0]),
               vocab_valid_descriptors=int(valid.sum()))
    say("relocalization probe: " + json.dumps(out) + f" on {smi}")
    if not (pos < RELOC_POS_TOL and rot < RELOC_ROT_TOL_DEG):
        fail(f"relocalization probe: recovered pose {pos} map units, {rot} degrees from the tracked one "
             f"(bounds {RELOC_POS_TOL}, {RELOC_ROT_TOL_DEG})")
    return out


# ---------------------------------------------------------------------------
# kernel C
# ---------------------------------------------------------------------------


def _rel_err(got, want, per_block: bool) -> float:
    """max |got - want| over max |want|, for the whole output or per leading row."""
    d, w = (got - want).abs(), want.abs()
    if per_block:
        d, w = d.reshape(d.shape[0], -1).amax(1), w.reshape(w.shape[0], -1).amax(1)
    else:
        d, w = d.max(), w.max()
    return float((d / w.clamp(min=1e-30)).max())


def _check_window(eng, cfg, dev):
    """The engine's local-BA problem around its reference keyframe, made fit
    for a comparison in f32:

    * moved off the optimum that the engine's own BA left it at, where g_l,
      g_c and g_red nearly cancel and a wrong gradient would hardly show:
      the live landmarks by N(0, LM_NOISE) per coordinate, the optimized
      poses by a N(0, POSE_NOISE) twist, from PERTURB_SEED;
    * without the observations nearer their camera than NEAR_DEPTH of the
      median depth (the engine's map, like the reference's, holds some at
      1-2 mm against a median of 0.7): there a reprojection moves by 1e5 px
      per map unit, and f32 rounding in either reduction sends the two
      5-iteration LM solves down different paths (kept in, they end 0.13
      apart in xyz on an H100 at 700 W).

    Returns the problem, the number of observations taken out and the
    median depth."""
    from dialog_tpu_torch import geometry as geo
    from dialog_tpu_torch.optim.local_ba import build_problem

    prob = build_problem(eng.m, eng.ref_kf, cfg)
    rng = np.random.default_rng(PERTURB_SEED)
    live = (prob.lm_ids < cfg.max_landmarks)[:, None]
    dx = torch.from_numpy(rng.normal(0.0, LM_NOISE, tuple(prob.xyz.shape)).astype(np.float32)).to(dev)
    xi = torch.from_numpy(rng.normal(0.0, POSE_NOISE, (prob.R.shape[0], 6)).astype(np.float32)).to(dev)
    R, t = geo.se3_retract(prob.R, prob.t, xi * prob.cam_opt[:, None])
    xyz = torch.where(live, prob.xyz + dx, prob.xyz)
    safe = torch.clamp(prob.obs_cam, 0, R.shape[0] - 1).long()
    z = geo.project(R[safe], t[safe], xyz[:, None, :].expand(prob.obs_uv.shape[:2] + (3,)),
                    cfg.fx, cfg.fy, cfg.cx, cfg.cy)[1]
    z_med = float(z[prob.obs_ok & (z > 0)].median())
    near = prob.obs_ok & (z < NEAR_DEPTH * z_med)
    return prob._replace(R=R.contiguous(), t=t.contiguous(), xyz=xyz.contiguous(),
                         obs_w=torch.where(near, 0.0, prob.obs_w), obs_ok=prob.obs_ok & ~near), int(near.sum()), z_med


def _stereo_kw(prob, cfg) -> dict:
    """Kernel C's stereo arguments for a problem that carries a right-x."""
    if prob.obs_ur is None:
        return {}
    return dict(obs_ur=prob.obs_ur, bf=cfg.bf, delta2_stereo=cfg.chi2_stereo)


def seeded_window(cfg, dev):
    """A local-BA window of the path's own shape that no trajectory decides:
    ``optim.synth_problem.make_problem`` from SOLVE_SEED at the engine's
    capacities (C, P, O and intrinsics of ``cfg``), cameras on an arc around
    a box of points 6-10 units out, poses and points moved off the truth.
    Its live part follows the engines' windows after the smoke runs (mono:
    some 2,000 observations under 9 optimized cameras; stereo: some 2,900
    under 4, about half of them with a right-x). Returns (problem, median
    depth)."""
    from dialog_tpu_torch.optim.synth_problem import make_problem

    n_cams, n_pts, frac = SEEDED_STEREO if cfg.bf > 0 else SEEDED_MONO
    prob = make_problem(seed=SOLVE_SEED, n_cams=n_cams, n_pts=n_pts, cfg=cfg, stereo_frac=frac, device=dev)[0]
    return prob, 8.0


def check_schur(eng, cfg, dev):
    """Kernel C on the engine's own local-BA window (see _check_window), its
    stereo variant when the engine's problem carries a right-x: the direct
    outputs. Then a solve on a seeded window of the same shape
    (``check_schur_solve``).

    Direct outputs: each within REL_TOL_C of the plain version, relative to
    that output's largest magnitude; Hll^-1 block by block, since the 3x3
    blocks of unobserved (padding) landmarks hold 1/1e-9. The comparison
    runs at damping LAM_C: the damping bounds the condition number of each
    diagonally scaled Hll block by (3 + lam) / lam, and at the engine's own
    lam = 1e-4 the plain f32 version is itself about 2e-3 off a float64
    evaluation in Hll^-1 and 2e-4 in g_red (on an H100), so 1e-4 would test
    f32 rounding, not the kernel. The call is repeated and must give the
    same bits.

    Returns (max abs R/t/xyz difference after the solve, largest direct
    relative error, the engine's window).
    """
    from dialog_tpu_torch.kernels.schur import schur_reduce, schur_reduce_plain

    prob, n_near, _ = _check_window(eng, cfg, dev)
    C, (P, O) = prob.R.shape[0], prob.obs_cam.shape
    stereo = prob.obs_ur is not None
    kname = "schur_reduce_stereo" if stereo else "schur_reduce"
    lam = torch.tensor(LAM_C, dtype=torch.float32, device=dev)
    args = (prob.R, prob.t, prob.cam_opt, prob.xyz, prob.obs_cam, prob.obs_uv, prob.obs_w, lam,
            cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.chi2_mono)
    kw = _stereo_kw(prob, cfg)
    got = schur_reduce(*args, **kw)
    again = schur_reduce(*args, **kw)
    want = schur_reduce_plain(*args, **kw)
    f64 = schur_reduce_plain(*map(_dbl, args), **{k: _dbl(v) for k, v in kw.items()})
    torch.cuda.synchronize()
    n_ur = int((prob.obs_ok & (prob.obs_ur >= 0)).sum()) if stereo else 0
    say(f"kernel C {kname} problem from the engine map (perturbation seed {PERTURB_SEED}): C={C} P={P} O={O} "
        f"observations={int(prob.obs_ok.sum())} "
        f"with a right-x={n_ur} (left out {n_near} nearer than {NEAR_DEPTH} of the median depth) "
        f"landmarks={int((prob.lm_ids < cfg.max_landmarks).sum())} optimized poses={int(prob.cam_opt.sum())}")
    max_rel = 0.0
    bad = []
    for name, g, w, w64 in zip(["Hll_inv", "g_l", "Y", "Hcc", "g_c", "g_red", "S_pair"], got, want, f64):
        err = _rel_err(g, w, per_block=name == "Hll_inv")
        max_rel = max(max_rel, err)
        say(f"kernel C {kname} {name} lam={LAM_C}: max_abs_diff={float((g - w).abs().max())} "
            f"rel_err={err} ok={err <= REL_TOL_C} "
            f"(plain f32 against float64: {_rel_err(w.double(), w64, per_block=name == 'Hll_inv')})")
        if not err <= REL_TOL_C:
            bad.append(name)
    if bad:
        fail(f"kernel C {kname} outputs {bad} differ from the plain version by more than {REL_TOL_C}")
    repeat = all(torch.equal(a, b) for a, b in zip(got, again))
    say(f"kernel C {kname} bitwise repeatable: {repeat}")
    if not repeat:
        fail(f"kernel C {kname} is not bitwise repeatable")
    seeded, z_med = seeded_window(cfg, dev)
    return check_schur_solve(seeded, cfg, kname, z_med), max_rel, prob


def _dbl(x):
    return x.double() if isinstance(x, torch.Tensor) and x.is_floating_point() else x


def check_schur_solve(prob, cfg, kname: str, z_med: float) -> float:
    """``solve_ba`` over ``prob`` with the path's own number of LM iterations
    from the engine's lam0: on the problem's device (kernel C on the card),
    with the plain version on the CPU, and in float64. R and t within
    SOLVE_TOL_RT of the plain solve, every live landmark within
    SOLVE_TOL_XYZ. On a stereo window that holds for the
    landmarks whose undamped Hll (float64, at the start) has a
    condition number at most COND_MAX: up to there both f32 solves stay
    within half of SOLVE_TOL_XYZ of a float64 solve (PERF.md: the
    measurements COND_MAX follows from). The others (two near-parallel rays
    without a stereo row, or one stereo row at sub-pixel disparity) slide
    along their ray, and f32 rounding alone moves them far there (the plain
    f32 solve against float64, printed beside). They are held where the window
    sees them: each of their observations' predicted image rows (u, v, uR)
    after the two solves, within the pixels that SOLVE_TOL_XYZ makes at the
    window's median depth, fx x SOLVE_TOL_XYZ / median depth. The check
    fails unless the plain solve moves R or t by at least 2 x SOLVE_TOL_RT
    and some landmark held in xyz by at least 2 x SOLVE_TOL_XYZ, so that a
    wrong gradient cannot pass unseen.

    Returns the max abs R/t/xyz difference between the two f32 solves.
    """
    from dialog_tpu_torch.kernels.schur import observation_terms, schur_reduce_plain
    from dialog_tpu_torch.optim.local_ba import solve_ba

    stereo = prob.obs_ur is not None
    iters = cfg.local_ba_iters
    cpu = type(prob)(*[x.cpu() if isinstance(x, torch.Tensor) else x for x in prob])
    p64 = type(cpu)(*map(_dbl, cpu))
    # condition numbers of the undamped landmark blocks (Hll^-1 has Hll's)
    zero = torch.zeros((), dtype=torch.float64)
    ev = torch.linalg.eigvalsh(schur_reduce_plain(
        p64.R, p64.t, p64.cam_opt, p64.xyz, p64.obs_cam, p64.obs_uv, p64.obs_w, zero, cfg.fx, cfg.fy, cfg.cx, cfg.cy,
        cfg.chi2_mono, **_stereo_kw(p64, cfg))[0])
    cond = torch.where(ev[:, 0] > 0, ev[:, 2] / ev[:, 0], float("inf"))
    say(f"kernel C {kname} seeded window (seed {SOLVE_SEED}): C={prob.R.shape[0]} P={prob.obs_cam.shape[0]} "
        f"O={prob.obs_cam.shape[1]} observations={int(prob.obs_ok.sum())} with a right-x="
        f"{int((prob.obs_ok & (prob.obs_ur >= 0)).sum()) if stereo else 0} "
        f"landmarks={int((prob.lm_ids < cfg.max_landmarks).sum())} optimized poses={int(prob.cam_opt.sum())}")

    Rk, tk, xk, ck = solve_ba(prob, cfg, iters=iters, chi2_th=cfg.chi2_mono)
    Rp, tp, xp, cp = solve_ba(cpu, cfg, iters=iters, chi2_th=cfg.chi2_mono)
    R64, t64, x64, _ = solve_ba(p64, cfg, iters=iters, chi2_th=cfg.chi2_mono)
    live = cpu.lm_ids < cfg.max_landmarks
    held = live & (cond <= COND_MAX) if stereo else live
    loose = live & ~held
    dR = float((Rk.cpu() - Rp).abs().max())
    dt = float((tk.cpu() - tp).abs().max())
    dxyz = (xk.cpu() - xp).abs().amax(1)
    own = (xp.double() - x64).abs().amax(1)   # the plain f32 solve against float64
    own_rt = max(float((Rp.double() - R64).abs().max()), float((tp.double() - t64).abs().max()))
    dx = float(dxyz[held].max())
    moved_rt = max(float((Rp - cpu.R).abs().max()), float((tp - cpu.t).abs().max()))
    moved_xyz = float((xp - cpu.xyz)[held].abs().max())
    top = lambda x, m: float(torch.where(m, x, 0.0).max())  # noqa: E731
    say(f"kernel C {kname} solve_ba {iters} iters vs plain: max|dR|={dR} max|dt|={dt} max|dxyz|={dx} over "
        f"{int(held.sum())} of {int(live.sum())} landmarks (plain f32 against float64: R/t {own_rt}, "
        f"xyz {top(own, held)}); cost {float(ck)} vs {float(cp)}")
    px = torch.zeros_like(dxyz)
    px_tol = cfg.fx * SOLVE_TOL_XYZ / z_med
    if stereo:
        def rows(R, t, x):   # each observation's predicted image rows, less what it observed
            r, _, _, ok = observation_terms(R, t, x, cpu.obs_cam, cpu.obs_uv, cpu.obs_ok, cfg.fx, cfg.fy, cfg.cx,
                                            cfg.cy, obs_ur=cpu.obs_ur, bf=cfg.bf)
            return torch.where(ok[..., None], r, 0.0)

        r_p = rows(Rp, tp, xp)
        px = (rows(Rk.cpu(), tk.cpu(), xk.cpu()) - r_p).abs().amax((1, 2))
        px_own = (r_p.double() - rows(R64, t64, x64)).abs().amax((1, 2))
        say(f"kernel C {kname} solve_ba the {int(loose.sum())} landmarks with an Hll condition number above "
            f"{COND_MAX:g}: max|dxyz|={top(dxyz, loose)} (plain f32 against float64: {top(own, loose)}); their "
            f"image rows max|d|={top(px, loose)} px, bound {px_tol} px at the median depth {z_med} "
            f"(plain f32 against float64: {top(px_own, loose)} px; the other landmarks': {top(px, held)} px)")
    say(f"kernel C {kname} solve_ba the plain solve moved: R/t by {moved_rt}, landmarks by {moved_xyz}")
    if not (dR < SOLVE_TOL_RT and dt < SOLVE_TOL_RT and dx < SOLVE_TOL_XYZ and bool((px[loose] < px_tol).all())):
        fail(f"kernel C {kname} solve_ba result differs from the plain solve beyond tolerance")
    if not (moved_rt >= 2 * SOLVE_TOL_RT and moved_xyz >= 2 * SOLVE_TOL_XYZ):
        fail("the seeded window is too close to its optimum for the solve check to show anything")
    return max(dR, dt, dx)


# ---------------------------------------------------------------------------
# timing at the main path's shapes
# ---------------------------------------------------------------------------


def fast_bound(imgs, outs) -> dict:
    """Kernel A: every image read and every rank map written once; per pixel,
    by the cheapest scheme known for it, 16 differences to the centre, the
    best arc of 9 of either sign from prefix and suffix extrema of the
    circle's halves (2 x (28 + 32) min/max), the score (1), the 3x3 maximum
    with its compare (9) and the rank (two compares and a sum, 3)."""
    return bound(nbytes(*imgs, *outs), sum(img.numel() for img in imgs) * (16 + 2 * 60 + 1 + 9 + 3))


def hamming_bound(x, out, band: int) -> dict:
    """Kernel B, one pass over the gated matrix (``hamming_best2``, or a whole
    mutual match): every argument read and the results written once; 9
    gate operations (two differences, two products, a sum, a compare, the
    octave difference, its magnitude and compare) for each pair of a valid
    row and a valid column, and 25 (8 xor, 8 popcounts, 7 sums, 2 compares)
    for each pair whose gates these inputs open."""
    from dialog_tpu_torch.kernels.hamming import gate_d2

    valid = x["va"][:, None] & x["vb"][None, :]
    open_ = valid & (gate_d2(x["uva"], x["uvb"]) <= x["r2"][:, None]) \
        & ((x["oa"][:, None] - x["ob"][None, :]).abs() <= band)
    n_in = nbytes(x["a"], x["b"], x["va"], x["vb"], x["uva"], x["uvb"], x["r2"], x["oa"], x["ob"])
    return bound(n_in + nbytes(*out), 9 * int(valid.sum()) + 25 * int(open_.sum()))


def schur_bound(args, kw, out) -> dict:
    """Kernel C: every argument of the function read and the seven outputs
    written once (the camera index is this design's own structure, not an
    input of the function, and is not counted); operations counted for this
    window's live
    observations (a camera in range, a weight, in front of its camera), not
    for every slot. Per live observation with D = 2 or 3 residual rows:
    the transform, projection, Huber weight and Jacobians (60 + 25 D), its
    share of Hll and g_l (9 + 18 D), and, where its camera is optimized, Y
    (18 + 36 D), Z = Y L^-T and Y Hll^-1 g_l (84), Hcc and g_c (27 + 54 D);
    per landmark the 3x3 Cholesky, its inverse and Hll^-1 g_l (75); per pair
    of observations of one landmark by optimized cameras a 6x6x3 product and
    its sum (216)."""
    from dialog_tpu_torch.kernels.schur import observation_terms

    R, t, cam_opt, xyz, obs_cam, obs_uv, obs_w = args[:7]
    C = R.shape[0]
    valid = (obs_w > 0.0) & (obs_cam >= 0) & (obs_cam < C)
    ok = observation_terms(R, t, xyz, obs_cam, obs_uv, valid, *args[8:12])[3]
    rows = torch.where(kw["obs_ur"] >= 0.0, 3, 2) if kw else torch.full_like(obs_cam, 2)
    opt = ok & cam_opt[torch.clamp(obs_cam, 0, C - 1).long()]
    ops = int((ok * (69 + 43 * rows)).sum()) + int((opt * (129 + 90 * rows)).sum()) + 75 * xyz.shape[0] \
        + 216 * int((opt.sum(1) ** 2).sum())
    ins = list(args[:8]) + ([kw["obs_ur"]] if kw else [])
    return dict(bound(nbytes(*ins, *out), ops), live_observations=int(ok.sum()), optimized_observations=int(opt.sum()))


def kernel_times(images, cfg, prob, stereo_cfg, stereo_prob, dev, mono_stack, stereo_stack) -> dict:
    """For each kernel at its path's shapes: ``ms`` the device's own time per
    call (``device_ms``), ``wrapper_loop_ms`` and ``plain_ms`` the pace of
    back-to-back calls of the wrapper and of the plain version, the bound,
    and whether the host sets the wrapper loop's pace. Kernel A is timed on
    one image's whole pyramid in one launch (``one_level`` holds the same
    readings for level 0 alone); kernel B as ``hamming_best2`` and as one
    whole mutual match (``other_device_ms`` is its clearing of the column
    keys). Kernel C needs its
    camera index once per solve: ``cam_index_device_ms`` is the device time
    of building it (PyTorch's sort and search kernels), ``cam_index_ms`` the
    pace of back-to-back builds, and ``solve_device_ms`` the device cost of
    one ``solve_ba`` of the path, the index plus ``solve_iters`` calls.
    Kernel A over a batch is timed on the pyramids of ``mono_stack`` (BATCH
    640x480 images, the entry's own readings) and of ``stereo_stack``
    (2 x BATCH 1241x376 images, under ``stereo_batch``), each beside the
    same images through one-image launches (``one_image_launches``: the
    device time and the loop's pace of B launches)."""
    from dialog_tpu_torch import frontend as fe
    from dialog_tpu_torch.kernels.fast import (fast_nms_rank, fast_nms_rank_levels, fast_nms_rank_levels_batch,
                                               fast_nms_rank_levels_batch_plain, fast_nms_rank_levels_plain,
                                               fast_nms_rank_plain)
    from dialog_tpu_torch.kernels.hamming import (hamming_best2, hamming_best2_filled, mutual_match_fused,
                                                  mutual_match_plain)
    from dialog_tpu_torch.kernels.schur import camera_index, schur_reduce, schur_reduce_plain

    pyr = fe.build_pyramid(torch.from_numpy(images[0]).to(dev), cfg)
    a_args = (float(cfg.min_th_fast), float(cfg.ini_th_fast), fe.BORDER)
    a_kw = dict(pad_to=fe.CELL)
    x = _hamming_inputs(2048, 1024, 3, dev)
    h_args = (x["a"], x["b"], x["va"], x["vb"])
    h_kw = dict(uv_a=x["uva"], uv_b=x["uvb"], radius2=x["r2"], oct_a=x["oa"], oct_b=x["ob"], octave_band=1)
    m_kw = dict(**h_kw, max_dist=100, ratio=0.9)
    lam = torch.tensor(1e-4, dtype=torch.float32, device=dev)

    def c_args(p, c):
        return (p.R, p.t, p.cam_opt, p.xyz, p.obs_cam, p.obs_uv, p.obs_w, lam, c.fx, c.fy, c.cx, c.cy, c.chi2_mono)

    def entry(name, fn, plain, limit, reps=20, **extra):
        out = device_ms(fn, DEVICE_KERNELS[name], reps=reps)
        out.update(ms=out["device_ms"], wrapper_loop_ms=time_ms(fn, reps=reps), plain_ms=time_ms(plain, reps=reps),
                   library_ms=None, **limit, **extra)
        out["host_paced"] = out["wrapper_loop_ms"] > HOST_PACED * out["device_ms"]
        return out

    times = {
        "fast_nms_rank": entry(
            "fast_nms_rank", lambda: fast_nms_rank_levels(pyr, *a_args, **a_kw),
            lambda: fast_nms_rank_levels_plain(pyr, *a_args, **a_kw),
            fast_bound(pyr, fast_nms_rank_levels(pyr, *a_args, **a_kw)), reps=50, levels=len(pyr),
            one_level=entry("fast_nms_rank", lambda: fast_nms_rank(pyr[0], *a_args),
                            lambda: fast_nms_rank_plain(pyr[0], *a_args),
                            fast_bound(pyr[:1], [fast_nms_rank(pyr[0], *a_args)]), reps=50)),
        "hamming_best2": entry("hamming_best2", lambda: hamming_best2(*h_args, **h_kw),
                               lambda: hamming_best2_filled(*h_args, **h_kw),
                               hamming_bound(x, hamming_best2(*h_args, **h_kw), 1), reps=50),
        "hamming_mutual": entry("hamming_mutual", lambda: mutual_match_fused(*h_args, **m_kw),
                                lambda: mutual_match_plain(*h_args, **m_kw),
                                hamming_bound(x, mutual_match_fused(*h_args, **m_kw), 1), reps=50),
    }

    def batch_entry(stack, c):
        pyr_b = fe.build_pyramid(torch.from_numpy(stack).to(dev), c)
        th = (float(c.min_th_fast), float(c.ini_th_fast), fe.BORDER)
        one_by_one = lambda: [fast_nms_rank_levels([p[b] for p in pyr_b], *th, **a_kw)  # noqa: E731
                              for b in range(stack.shape[0])]
        singles = device_ms(one_by_one, DEVICE_KERNELS["fast_nms_rank"], reps=20)
        return entry("fast_nms_rank_batch", lambda: fast_nms_rank_levels_batch(pyr_b, *th, **a_kw),
                     lambda: fast_nms_rank_levels_batch_plain(pyr_b, *th, **a_kw),
                     fast_bound(pyr_b, fast_nms_rank_levels_batch(pyr_b, *th, **a_kw)), reps=20,
                     images=int(stack.shape[0]), image_shape=list(stack.shape[1:]), levels=len(pyr_b),
                     one_image_launches=dict(device_ms=singles["device_ms"],
                                             wrapper_loop_ms=time_ms(one_by_one, reps=20)))

    times["fast_nms_rank_batch"] = batch_entry(mono_stack, cfg)
    times["fast_nms_rank_batch"]["stereo_batch"] = batch_entry(stereo_stack, stereo_cfg)
    # kernel C as solve_ba calls it: the camera index built once, outside the call
    for name, p, c in [("schur_reduce", prob, cfg), ("schur_reduce_stereo", stereo_prob, stereo_cfg)]:
        args, kw = c_args(p, c), _stereo_kw(p, c)
        build_index = lambda: camera_index(p.obs_cam, p.obs_w, p.R.shape[0])  # noqa: E731
        idx = build_index()
        times[name] = t = entry(name, lambda: schur_reduce(*args, **kw, cam_index=idx),
                                lambda: schur_reduce_plain(*args, **kw),
                                schur_bound(args, kw, schur_reduce(*args, **kw, cam_index=idx)),
                                cam_index_device_ms=device_ms(build_index, ())["other_device_ms"],
                                cam_index_ms=time_ms(build_index), solve_iters=c.local_ba_iters)
        t["solve_device_ms"] = t["cam_index_device_ms"] + t["solve_iters"] * t["device_ms"]
    return times


def main() -> int:
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs only on a GPU")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say(f"card: {smi}")
    say(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    import dialog_tpu_torch  # noqa: F401  (pins exact f32)
    from dialog_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.load_all()
    say(f"build: {time.perf_counter() - t0:.2f} s total, per kernel "
        + json.dumps({k: round(v, 2) for k, v in build.build_seconds.items()}))
    for name, log in build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"ptxas {name}: {line.strip()}")

    # mono path: kernel A once per image (all pyramid levels in one launch),
    # kernel B once per mutual match
    scene, images, eng, fps, launches = run_path("mono", dev)
    cfg = eng.cfg
    say(f"mono path: {fps:.3f} frames/s over frames {FPS_FIRST}-{N_FRAMES - 1} on {smi}")
    check_path("mono", eng, scene, launches, with_scale=True, ate_gate=ATE_GATE, min_kfs=4,
               min_launches={"fast_nms_rank": N_FRAMES, "hamming_mutual": 1, "schur_reduce": 1},
               max_launches={"fast_nms_rank": N_FRAMES})
    err_c, rel_c, prob = check_schur(eng, cfg, dev)

    # stereo path: two extractions per frame; every local BA takes the uR variant
    sscene, simages, seng, sfps, slaunches = run_path("stereo", dev)
    n_st = len(seng.trajectory)
    say(f"stereo path: {sfps:.3f} frames/s over frames {FPS_FIRST}-{n_st - 1} on {smi}")
    check_path("stereo", seng, sscene, slaunches, with_scale=False, ate_gate=STEREO_ATE_GATE, min_kfs=4,
               min_launches={"fast_nms_rank": 2 * n_st, "hamming_mutual": 1, "schur_reduce_stereo": 1},
               max_launches={"fast_nms_rank": 2 * n_st, "schur_reduce": 0})
    err_cs, rel_cs, sprob = check_schur(seng, seng.cfg, dev)

    rscene, _, reng, rfps, rlaunches = run_path("rgbd", dev)
    n_rg = len(reng.trajectory)
    say(f"rgbd path: {rfps:.3f} frames/s over frames {FPS_FIRST}-{n_rg - 1} on {smi}")
    check_path("rgbd", reng, rscene, rlaunches, with_scale=False, ate_gate=RGBD_ATE_GATE, min_kfs=3,
               min_launches={"fast_nms_rank": n_rg, "hamming_mutual": 1, "schur_reduce_stereo": 1},
               max_launches={"fast_nms_rank": n_rg})

    # the batched paths: kernel A once per batch of images, one host pull per batch
    mb = run_batch_path("mono_batch", dev)
    check_batch_path("mono_batch", mb, with_scale=True, ate_gate=ATE_GATE)
    sb = run_batch_path("stereo_batch", dev)
    check_batch_path("stereo_batch", sb, with_scale=False, ate_gate=STEREO_ATE_GATE)
    async_probe(dev, smi)

    # kernels A and B against their plain versions (after the paths: these launches do not count)
    err_a = check_fast([("mono", images[0], cfg), ("stereo", simages[0][0], seng.cfg)], dev)
    mono_stack = np.stack(mb["frames"][8 : 8 + BATCH])
    stereo_stack = np.stack([x[0] for x in sb["frames"][4 : 4 + BATCH]] + [x[1] for x in sb["frames"][4 : 4 + BATCH]])
    err_ab = check_fast_batch([("mono_batch", mono_stack, cfg), ("stereo_batch", stereo_stack, seng.cfg)], dev)
    err_b, err_m = check_hamming(dev)

    times = kernel_times(images, cfg, prob, seng.cfg, sprob, dev, mono_stack, stereo_stack)

    # the batched paths against their per-frame twins under the profiler, and relocalization on the mono_batch
    # engine. These windows (some 100,000 kernels each) come after the kernels' own short profiler
    # sessions: in one run the first short session behind four of them came back without a device record
    profile_batch_path("mono_batch", mb, smi)
    reloc_probe(mb, dev, smi)
    profile_batch_path("stereo_batch", sb, smi)
    errs = {"fast_nms_rank": err_a, "fast_nms_rank_batch": err_ab, "hamming_best2": err_b, "hamming_mutual": err_m,
            "schur_reduce": err_c, "schur_reduce_stereo": err_cs}
    rels = {"schur_reduce": rel_c, "schur_reduce_stereo": rel_cs}
    by_path = {"mono": launches, "stereo": slaunches, "rgbd": rlaunches, "mono_batch": mb["launches"],
               "stereo_batch": sb["launches"]}
    # every launch is above these bounds: the shortest single kernel of the timing runs is the practical floor
    floor_ms = min(t["shortest_launch_ms"] for t in times.values())
    say(f"shortest single kernel launch seen while timing (the practical floor of any bound below it): "
        f"{floor_ms} ms on {smi}")
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        path = {"schur_reduce_stereo": "stereo", "fast_nms_rank_batch": "mono_batch"}.get(name, "mono")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": by_path[path][name], "launches_path": path,
            "launches_by_path": {p: n[name] for p, n in by_path.items()},
            "max_abs_err": errs[name], **times[name], "launch_floor_ms": floor_ms,
        })
        if name in rels:
            kernels[-1]["direct_max_rel_err"] = rels[name]
        t = times[name]
        say(f"kernel {name}: device {t['device_ms']} ms {json.dumps(t['stages_ms'])}, wrapper loop "
            f"{t['wrapper_loop_ms']} ms{' (the host sets the pace)' if t['host_paced'] else ''}, plain "
            f"{t['plain_ms']} ms, bound {t['bound_ms']} ms by {t['bound_by']}"
            + (f"; camera index {t['cam_index_device_ms']} ms on the device, one solve of {t['solve_iters']} "
               f"iterations {t['solve_device_ms']} ms" if "solve_device_ms" in t else ""))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
