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
   pairs at the KITTI00 preset (bench.py's capacities), prints its per-frame
   decisions (keyframe frames, n_tracked at frames 1-12) beside the JAX
   engine's on the same pairs (``tools/stereo_reference_trace.json``, taken
   on the CPU) with the first frame where they differ, not gated, and checks
   kernel C's stereo (uR) variant as in 4: direct outputs on that engine's
   window, the 8-iteration solve on a seeded window (C=64, P=8192, O=12, a
   right-x on half the observations);
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
8. checks loop closing. ``solve_pose_graph`` on the card against the CPU on
   a seeded Sim3 graph at the mono capacities (K = 256); then the reference
   loop test's orbit (``profile_main_path.loop_scene``, 260 synthetic feature
   frames, its own configuration ``loop_config``) through
   ``Engine.track_features`` (``loop``), and on the same orbit at half its
   speed (520 frames: the reference's pipelined and batched engines lose the
   orbit at full speed) through ``Engine.track_features_async``
   (``loop_async``) and as 8 frames one by one and batches of 8 through
   ``Engine.track_batch`` (``loop_batch``), each under the test's gates: a
   loop closed between keyframes more than 20 insertions apart, OK share >
   0.9, ATE < 5% of the span; kernel B inside every guided Sim3 match; one
   host pull per batch. Then the same 260 frames per frame at the TUM-class
   configuration at full width (``loop_tum``: 1000 features, K = 256),
   gated on a closure only (the reference's own closure there raises the ATE
   past the test's gate, ROADMAP D13). Each closure starts a global BA that
   advances one PCG LM iteration per tracked frame or batch (at ``flush`` in
   the pipelined run) and folds into the map: at least one run, none in
   flight after the closing ``flush``, the ATE just after the first one
   folded in, each tick's stall. The first closure of ``loop`` and of
   ``loop_tum`` is then replayed on a copy of its map and each step timed
   (``loop_probe``, with the GBA's start and one tick);
9. checks global BA. ``gba_dense``: ``global_bundle_adjustment`` on the
   ``loop`` run's final map moved off its optimum (K = 96: the dense branch,
   kernel C at C = 96) against ``solve_ba_pcg`` on the same problem and
   against the same call on a CPU copy. ``gba_sharded``: two ranks on the
   card (``python -m dialog_tpu_torch.gba_rank``, a gloo group) solve the
   ``loop`` (dense, kernel C on each rank) and ``loop_tum`` (K = 256, PCG)
   maps, which this process saved, against this process's one-rank solve.
   ``gba_capacity``: ``tests/test_kitti_capacity.py`` at the full KITTI00
   preset (the corridor map of ``synth_problem.build_corridor_map``, a
   keyframe with local BA at occupancy, the global problem through the PCG),
   with the times of building the problem, of one PCG LM iteration and of an
   engine tick, the CG iterations and the peak memory;
10. checks kernel A (FAST rank: level by level and all levels of the mono and
   the stereo pyramid in one launch, odd sizes, a 32-level table; over a batch:
   one real batch of each batched path against the plain version and against
   one-image launches, odd sizes) and kernel
   B (gated Hamming best/second, and the one-pass mutual match against its
   two-call plain form, with and without each gate, with ties and empty
   sides) against their plain PyTorch versions on the card, bit for bit; and
   the pose LM kernel (``pose_optimization`` on CUDA tensors, one launch a
   call) against its plain loop on the card, mono and stereo at N = 1,024,
   2 x 6 and 4 x 10 (a seeded ``synth_problem.make_pose_problem``): the same
   inliers, R and t within 1e-4, two calls bit for bit;
11. times each kernel at its path's shapes: the device's own time per call
   under ``torch.profiler`` (the kernel's launches by name, kernel C's two
   stages apart), the pace of back-to-back wrapper calls between two CUDA
   events (host work included), the plain version likewise, and the least
   time the card could take for the same inputs (bytes over 3.35 TB/s or
   operations over 67 TFLOP/s f32, whichever is larger); and kernel C at
   global BA's camera counts (C = 96, 128 and 192 on seeded problems of
   16,384 landmark slots, O = 12), held against its plain version first;
   the pose LM at 2 x 6 and 4 x 10 also over no observations (``chain_ms``:
   the same launch with nothing but its serial chain of block sums and
   one-thread 6x6 solves, the latency yardstick of its design);
12. checks determinism and the engine's other modes: ``mono`` and ``loop``
   once more on fresh engines from the same seeds, every record and every
   map leaf bit for bit against the first runs (``loop``'s global BA
   included); on the ``loop`` engine the PLY export and the two trajectory
   writers parsed back, a checkpoint saved and resumed on a fresh engine
   (LOST, relocalized, OK after 20 frames), localization mode (no new
   keyframe or landmark over 20 frames) and ``reset``;
13. checks block bundle adjustment. ``block_sharded``: two gloo ranks on the
   card against one on a corridor of ``tests/test_block_ba.py``'s size, bit
   for bit. Kernel C's frozen-landmark mode (``lm_opt``) against its plain
   version on a block problem of the KITTI00 corridor and on the stereo
   window with a seeded half of its landmarks frozen, and timed at the
   block shape (C = 64, P = 16,384, O = 12). ``block_capacity``, the slice's
   full-width path: the KITTI00 corridor of ``gba_capacity`` moved off its
   truth block by block, ``Engine.block_refine`` with 32 blocks, 2 rounds of
   6 iterations: no owned keyframe left out, the camera-centre error down
   2.5-fold, kernel C's frozen mode launched exactly 384 times;
14. runs ``kernels.selfcheck``: kernel B at n = 700, m = 900 in its four gate
   cases and its mutual mode, kernel A on a 123 x 210 image and in its
   batched launch, bit for bit, and kernel C through ``solve_ba`` (mono,
   stereo, half the landmarks frozen) within 2e-3 / 5e-3 of the CPU's solve;
15. the ``cli`` phase: the mono path's first 40 frames (RGB files, equal
   channels) and the RGB-D path's first 20 (16-bit depth, stamps 12 ms late,
   a TUM1 settings file written here) as TUM sequences, the stereo path's
   first 32 pairs as a KITTI sequence with its devkit poses, and 20 EuRoC
   pairs at 752x480 (the stereo sweep scaled into EuRoC's cameras, no
   distortion), written with ``datasets.png.write_png``; then ``cli.main``
   in this process: ``run-tum`` (with ``--render``), ``run-tum --pipelined``,
   ``run-tum --rgbd``, ``run-kitti --gt``, ``run-euroc`` and ``run-synth
   --trajectory loop`` over a 120-frame lap. Each run's engine equals, record by
   record and map leaf by leaf, the engine driven in this process on
   ``png.read_gray`` of the same files (with a RunLogger: a row per frame);
   the files decode to the frames written; the path's gates hold (kernel A
   once per image); the trajectory file parses back and the render is a PNG
   of its canvas. Printed, not gated: the CLI's median track time and
   frames/s, the decode of a 640x480 RGB and a 1241x376 gray file (the whole
   read, and the row unfilter native against plain on the inflated stream,
   as written and Paeth-filtered), and the share of the loop's wall time
   spent waiting for decoded frames.

Right after the build, the ``bench`` phase runs the bench as users run it:
``python3 -m dialog_tpu_torch.cli bench`` in a child process, all three of
bench.py's workloads (``tum_mono_kf10``, ``tum_mono_kf30``, ``kitti_stereo``),
its output streamed into this log and parsed. Gates: the three
``tracking_fps_*`` lines in order, each followed by the primary line, the last
one ``tracking_fps_tum_class_mono`` with all three workloads, bench.py's keys,
every value finite and above 0, ``vs_baseline`` the value over 30 or 15 as
rounded; on each workload's ``#`` line: OK at the end, an OK share above 0.9
outside the blanked frames, at least 4 keyframes, a recovery from the blanked
frames (mono: by relocalization), kernel A once per batched frontend call,
``hamming_mutual`` and the workload's kernel C variant launched,
``project_gate`` and ``invert_matches`` three times a batched frame (less
two batches for each recovery, fed per frame), and an ATE
below twice the JAX engine's on the same frames under the same schedule
(``tools/reference_ate.py bench_*``). A non-zero exit fails the script.
Then ``bench_reloc_margin`` replays ``tum_mono_kf10``'s warm-up in this
process and prints, not gated, the room its relocalization after the blanked
frames has on the card: the frame, the candidate keyframe, the matches, the
PnP inliers with the engine's draw and with 16 further draws of its
generator, and the refined inliers, each beside its gate (ROADMAP D22).

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

from dialog_tpu_torch.profile_main_path import (BATCH, FPS_FIRST, LOOP_BATCH_PERIOD, LOOP_DESC_FLIPS, LOOP_FRAMES,
                                                LOOP_NOISE_PX, LOOP_PERIOD, MONO_BATCH_FRAMES, N_FRAMES,
                                                STEREO_BATCH_FRAMES, WORKLOADS, extract_batch, loop_config, loop_scene,
                                                loop_tum_config, profiled, track_batches, track_frames)

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
# the JAX engine's per-frame decisions on the stereo path's 48 pairs, on the CPU (tools/stereo_parity_trace.py
# --reference-out): printed beside the card's, not gated (ROADMAP D7)
STEREO_REFERENCE_TRACE = "tools/stereo_reference_trace.json"
STEREO_TRACE_FRAMES = 12     # n_tracked printed for frames 1..this
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
# the loop phase: the reference loop test's gates (tests/test_loopclosing.py)
LOOP_MIN_GAP = 20       # the first closure joins keyframes more than this many insertions apart
LOOP_OK_SHARE = 0.9     # over all frames
LOOP_ATE_SPAN = 0.05    # ATE (similarity-aligned) below this share of the trajectory's span
LOOP_REPS = 5           # timed replays of each loop-closing step (median)
LOOP_PROBE_SEED = 3     # the replayed Sim3 RANSAC's draws
LOOP_PATHS = ("loop", "loop_async", "loop_batch", "loop_tum")
# the seeded pose graph at the mono capacities (K keyframe slots); an f32 solve on the CPU ends within 5e-6 of a
# float64 one on it
POSE_GRAPH_K = 256
POSE_GRAPH_ITERS = 25
POSE_GRAPH_TOL = 1e-4
# the reference engine on the loop paths' frames with its global BA on (tools/reference_ate.py loop [--batch 8
# --period 400 | --pipelined --period 400 | --tum], CPU): first closure (insertion numbers, frame), ATE of the
# frames so far just before and after it and after its GBA folded in, final ATE, m
REFERENCE_LOOP = {
    "loop": dict(closure=[35, 0, 198], ate_before_m=0.1675, ate_after_m=0.1106, ate_after_gba_m=0.1287,
                 final_ate_m=0.1236),
    "loop_async": dict(closure=[67, 0, 405], ate_before_m=0.0302, ate_after_m=0.0263, ate_after_gba_m=0.0248,
                       final_ate_m=0.0248),
    "loop_batch": dict(closure=[49, 1, 392], ate_before_m=0.0310, ate_after_m=0.0938, ate_after_gba_m=0.0530,
                       final_ate_m=0.0511),
    "loop_tum": dict(closure=[37, 1, 207], ate_before_m=0.0886, ate_after_m=2.8933, ate_after_gba_m=2.2997,
                     final_ate_m=2.9540),
}
# global BA checks (gba_dense, gba_sharded): the final loop maps with their optimized keyframes and their landmarks
# moved by N(0, GBA_NOISE) from GBA_SEED, GBA_ITERS LM iterations; the CPU tests' bounds
# (tests/test_torch_global_ba.py, tests/test_torch_distributed.py: the reference's for 8 devices against 1)
GBA_SEED = 13
GBA_NOISE = 1e-2
GBA_ITERS = 4
GBA_TOL_POSE = 1e-4
GBA_TOL_XYZ = 1e-3
# gba_capacity: tests/test_kitti_capacity.py's corridor at the KITTI00 preset
CORRIDOR_KFS = 1100
CORRIDOR_STEP = 0.8
CORRIDOR_TOL = 0.5      # metres: median |t_z + k x step| of the corridor's keyframes after the GBA
# kernel C at global BA's camera counts: seeded problems of P slots (LARGE_C_PTS live landmarks, each in O cameras)
# block bundle adjustment at the KITTI00 preset: the corridor of gba_capacity, 32 blocks of 35 keyframes
BLOCK_ARGS = dict(n_blocks=32, rounds=2, iters=6, cams_pb=64, lms_pb=8192)
BLOCK_LMS_PER_KF = 125
BLOCK_SEED = 17
BLOCK_GAIN = 2.5        # the camera-centre error falls at least this many times (tests/test_block_ba.py's gate)
MODES_FRAMES = 20       # frames tracked after a checkpoint resume, and again in localization mode
LARGE_C = (96, 128, 192)
LARGE_C_P, LARGE_C_O, LARGE_C_PTS = 16384, 12, 6000

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
    "schur_reduce_frozen": ("schur_obs", "schur_cams"),
    "pose_lm": ("pose_lm_kernel",),
    "pose_lm_stereo": ("pose_lm_kernel",),
    "project_gate": ("project_gate_kernel",),
    "invert_matches": ("invert_matches_kernel",),
}
HOST_PACED = 1.5        # a wrapper loop this many times slower than the device's own time is paced by the host
# the cli phase: the mono, RGB-D and stereo paths' frames as TUM and KITTI sequences on disk, and a EuRoC one
DEPTH_LAG = 0.012       # s: TUM depth stamps behind their colour frames (inside associate's 20 ms)
# frames of each run, cut from the paths' own (56, 24, 48, 24) to keep the script inside its time limit on slower
# hosts, where it passes 900 s (each run is driven twice, by the CLI and by its in-process twin)
CLI_TUM_FRAMES, CLI_RGBD_FRAMES, CLI_KITTI_FRAMES, CLI_EUROC_FRAMES = 40, 20, 32, 20
EUROC_SCALE = 0.3       # the stereo sweep's depths 4-12 -> 1.2-3.6 m, inside th_depth x EuRoC's 0.10 m baseline
CLI_SYNTH_FRAMES = 120  # run-synth's orbit: a lap in CLI_SYNTH_FRAMES frames, 3 degrees a frame (the engine never
                        # initializes on a lap of 100 frames, or of run-synth's default 60)
CLI_SYNTH_ATE_SPAN = LOOP_ATE_SPAN

# the bench phase: bench.py's workloads -> (their name in launches_by_path, baseline frames/s, kernel C's variant)
BENCH_WORKLOADS = {"tum_mono_kf10": ("bench_kf10", 30.0, "schur_reduce"),
                   "tum_mono_kf30": ("bench_kf30", 30.0, "schur_reduce"),
                   "kitti_stereo": ("bench_stereo", 15.0, "schur_reduce_stereo")}
# the JAX engine on the same frames under the same schedule (tools/reference_ate.py bench_kf10 | bench_kf30 |
# bench_stereo, CPU), m: similarity-aligned for mono, metric for stereo; the port's gate is twice it (PERF.md)
BENCH_REFERENCE_ATE = {"tum_mono_kf10": 0.6588, "tum_mono_kf30": 0.8539, "kitti_stereo": 0.1699}
BENCH_OK_SHARE = 0.9
BENCH_TIMEOUT_S = 600
BENCH_WARM_END = 104    # tum_mono_kf10's warm-up (bench.run_mono's defaults), replayed for its relocalization margin
BENCH_OCCLUDE_AT = 48
RELOC_MIN_MATCHES = 15  # _try_relocalize's descriptor-match gate
PNP_MIN_INLIERS = 15    # solve_pnp_ransac's default
RELOC_REDRAWS = 16      # the same PnP problem solved again with the engine generator's next draws
# the pose LM kernel: observations (the TUM-class max_features), (rounds, iterations) of the tracking step and of
# relocalization, R and t against the plain loop (the CPU pose tests' tolerance against JAX), the problems' seed
POSE_N = 1024
POSE_SHAPES = ((2, 6), (4, 10))
POSE_TOL = 1e-4
POSE_SEED = 21
# the projection glue's kernels: (L, the motion search's N, max_local_lms, F) at TUM1's and KITTI00's capacities,
# uv against the plain version (px, points 1 m or more ahead; tests/test_torch_project_kernel.py holds the rest),
# the problems' seed
PROJECT_SHAPES = {"tum1": (32768, 1024, 8192, 1024), "kitti00": (262144, 2048, 8192, 2048)}
PROJECT_UV_TOL = 1e-3
# project_gate may differ from its plain version only this close to a boundary: a gate's (relative to its size),
# and the octave's unrounded value to an integer (tests/test_torch_project_kernel.py's GATE_NEAR, OCTAVE_NEAR)
PROJECT_GATE_NEAR, PROJECT_OCTAVE_NEAR = 1e-4, 1e-5
PROJECT_SEED = 31

KERNELS = {
    "fast_nms_rank": ("dialog_tpu_torch/csrc/fast.cu", "dialog_tpu/kernels/fast.py:118"),
    "fast_nms_rank_batch": ("dialog_tpu_torch/csrc/fast.cu", "dialog_tpu/kernels/fast.py:118"),
    "hamming_best2": ("dialog_tpu_torch/csrc/hamming.cu", "dialog_tpu/kernels/hamming.py:131"),
    "hamming_mutual": ("dialog_tpu_torch/csrc/hamming.cu", "dialog_tpu/kernels/hamming.py:131"),
    "schur_reduce": ("dialog_tpu_torch/csrc/schur.cu", "dialog_tpu/kernels/schur.py:293"),
    "schur_reduce_stereo": ("dialog_tpu_torch/csrc/schur.cu", "dialog_tpu/kernels/schur.py:293"),
    "schur_reduce_frozen": ("dialog_tpu_torch/csrc/schur.cu", "dialog_tpu/kernels/schur.py:293"),
    "pose_lm": ("dialog_tpu_torch/csrc/pose.cu", "none: XLA's program of dialog_tpu/optim/pose_only.py:78"),
    "pose_lm_stereo": ("dialog_tpu_torch/csrc/pose.cu", "none: XLA's program of dialog_tpu/optim/pose_only.py:78"),
    "project_gate": ("dialog_tpu_torch/csrc/project.cu", "none: XLA's program of dialog_tpu/tracking.py:43 "
                     "_project_landmarks with the local-map mask and match_projected's radius"),
    "invert_matches": ("dialog_tpu_torch/csrc/project.cu", "none: XLA's program of the inversion in "
                       "dialog_tpu/tracking.py:112 and :214 with the merge"),
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
    device time is ``other_device_ms``. A session without a single device
    record fails, with or without names in ``own``."""
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
    records = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not records:
        # a session that came back without any device record (ROADMAP D11) reads as no time: fail, whatever own is
        fail(f"the profiler's session over {reps} calls holds no device record at all: no device time to report")
    for e in records:
        ms = (e.time_range.end - e.time_range.start) * 1e-3
        mine = [k for k in own if k in e.name]
        if mine:
            seen[mine[0]].append(ms)
        else:
            other += ms / reps
        if not e.name.startswith(("Memcpy", "Memset")):
            shortest = min(shortest, ms)
    if own and not any(seen.values()):
        fail(f"the profiler saw no launch of {own} in {reps} calls ({len(records)} device records in all): "
             f"no device time to report")
    stages = {k: sum(v) / len(v) * max(1, round(len(v) / reps)) for k, v in seen.items() if v}
    return {"device_ms": sum(stages.values()), "stages_ms": stages, "other_device_ms": other,
            "shortest_launch_ms": shortest}


def top_device_kernels(fn, n: int = 6) -> list:
    """The ``n`` device kernels that take the most device time over one
    call of ``fn`` (after one warm call), by name: [name, ms, launches]."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, k = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + (e.time_range.end - e.time_range.start) * 1e-3, k + 1)
    return [[name[:80], ms, k] for name, (ms, k) in sorted(by_name.items(), key=lambda x: -x[1][0])[:n]]


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
    n_tracked = sum(1 for s in states[first_ok + 1:] if s == OK)
    if launches["pose_lm"] + launches["pose_lm_stereo"] < 2 * n_tracked:
        fail(f"{name}: the pose LM launched {launches['pose_lm']} + {launches['pose_lm_stereo']} times for "
             f"{n_tracked} tracked frames (two a frame)")
    return out


def keyframe_frames(eng) -> list[int]:
    """The frames at which the engine inserted its keyframes, in insertion order."""
    seq, fid = eng.m.kfs.seq.cpu().numpy(), eng.m.kfs.frame_id.cpu().numpy()
    used = np.nonzero(seq >= 0)[0]
    return [int(fid[k]) for k in used[np.argsort(seq[used])]]


def stereo_decisions(eng) -> dict:
    """The stereo path's per-frame decisions on the card beside the JAX
    engine's on the same pairs (``STEREO_REFERENCE_TRACE``, taken on the CPU):
    the frames where keyframes were taken, n_tracked at frames 1 to
    ``STEREO_TRACE_FRAMES``, and the first frame where state, n_tracked or the
    keyframe decision differ. Printed, not gated: the card sums in another
    order than the CPU, and the engines part at float32 rounding edges of the
    triangulation (ROADMAP D7)."""
    from pathlib import Path

    ref = json.loads((Path(__file__).resolve().parent / STEREO_REFERENCE_TRACE).read_text())
    recs = eng.trajectory
    kf_card = keyframe_frames(eng)
    n = min(len(recs), ref["frames"])
    card = [(recs[i].state, recs[i].n_tracked, i in kf_card) for i in range(n)]
    jax_cpu = [(ref["states"][i], ref["n_tracked"][i], i in ref["keyframe_frames"]) for i in range(n)]
    first = next((i for i in range(n) if card[i] != jax_cpu[i]), None)
    out = {"card": {"keyframe_frames": kf_card,
                    "n_tracked_1_%d" % STEREO_TRACE_FRAMES: [r.n_tracked for r in recs[1:STEREO_TRACE_FRAMES + 1]]},
           "jax_cpu": {"keyframe_frames": ref["keyframe_frames"],
                       "n_tracked_1_%d" % STEREO_TRACE_FRAMES: ref["n_tracked"][1:STEREO_TRACE_FRAMES + 1],
                       "ate_m": ref["ate_m"]},
           "first_difference_frame": first}
    say("stereo decisions: " + json.dumps(out))
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
    from dialog_tpu_torch import tracking
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
    counts = {"batches": 0, "pulls": 0, "reloc_calls": 0, "reloc_recovered": 0, "vocab_at_occlusion": False,
              "multi_frames": 0}
    _counted(eng, "_try_relocalize", counts, "reloc_calls")
    _counted(eng, "_try_relocalize", counts, "reloc_recovered", hit=lambda rec: rec is not None)
    _counted(eng, "_start_pull", counts, "pulls")
    multi = tracking.fused_track_multi

    def counted_multi(m, lm_ids0, batch, *a, **k):
        counts["multi_frames"] += batch.uv.shape[0]
        return multi(m, lm_ids0, batch, *a, **k)

    common.reset_launch_counts()
    track_frames(eng, method, frames, 0, n_single, fps_in)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tracking.fused_track_multi = counted_multi
    try:
        for i in range(n_single, n_frames - BATCH + 1, BATCH):
            if i == occlude_at:
                counts["vocab_at_occlusion"] = eng._vocab is not None and eng.kf_count >= cfg.vocab_min_kfs
            batch = extract_batch(cfg, frames, i, dev, blank=BATCH // 2 if i == occlude_at else 0)
            out = eng.track_batch(batch, [float(i + j) / fps_in for j in range(BATCH)])
            counts["batches"] += 1
            if out:
                say(f"{name} batch at frame {i}: resolved frames {out[0].frame_id}-{out[-1].frame_id} "
                    f"{[r.state for r in out].count('OK')}/{len(out)} OK, tracked={out[-1].n_tracked} "
                    f"kfs={eng.kf_count}")
        eng.flush()
    finally:
        tracking.fused_track_multi = multi
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
    tracked frame; the pose LM twice a tracked frame; ``project_gate`` and
    ``invert_matches`` three times a frame that went through
    ``fused_track_multi``; kernel C at least once; one pull per batch queued; on the
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
    pose = "pose_lm_stereo" if stereo else "pose_lm"
    if launches[pose] < 2 * n_tracked:
        fail(f"{name}: {pose} launched {launches[pose]} times for {n_tracked} tracked frames (two a frame)")
    for k in ("project_gate", "invert_matches"):
        if launches[k] < 3 * counts["multi_frames"]:
            fail(f"{name}: {k} launched {launches[k]} times for {counts['multi_frames']} frames tracked in batches "
                 f"(three searches a frame)")
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
    from dialog_tpu_torch.kernels import common
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
    n_pose = common.launches["pose_lm"]
    rec, reloc_s = timed(lambda: eng._try_relocalize(frame, rec0.timestamp))
    n_pose = common.launches["pose_lm"] - n_pose
    if rec is None:
        fail("relocalization probe: _try_relocalize did not recover a tracked frame")
    if n_pose < 1:
        fail("relocalization probe: the relocalization ran no pose LM launch")
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
               relocalization_s=reloc_s, pose_lm_launches=n_pose, solve_pnp_ransac_s=pnp_s, pnp_points=int(ok.sum()),
               pnp_inliers=int(res.n_inliers), pnp_iters=cfg.pnp_ransac_iters, train_vocab_s=train_s,
               ensure_vocab_s=vocab_s, vocab_words=cfg.vocab_words, vocab_descriptor_slots=int(desc.shape[0]),
               vocab_valid_descriptors=int(valid.sum()))
    say("relocalization probe: " + json.dumps(out) + f" on {smi}")
    if not (pos < RELOC_POS_TOL and rot < RELOC_ROT_TOL_DEG):
        fail(f"relocalization probe: recovered pose {pos} map units, {rot} degrees from the tracked one "
             f"(bounds {RELOC_POS_TOL}, {RELOC_ROT_TOL_DEG})")
    return out


# ---------------------------------------------------------------------------
# loop closing
# ---------------------------------------------------------------------------


def _clone(x):
    """A deep copy of a tensor or a (nested) NamedTuple of tensors."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if hasattr(x, "_fields"):
        return type(x)(*[_clone(y) for y in x])
    return x


def _to(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if hasattr(x, "_fields"):
        return type(x)(*[_to(y, dev) for y in x])
    return x


def _timed(fn):
    """(fn's result, its wall seconds between two device syncs)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def check_pose_graph(dev, smi) -> dict:
    """``solve_pose_graph`` on the card against the CPU on the seeded Sim3
    graph at the mono capacities (``make_pose_graph``, K = POSE_GRAPH_K: a
    1,792 x 1,792 system), POSE_GRAPH_ITERS iterations from the same start:
    s, R and t within POSE_GRAPH_TOL, both costs down by at least 1e6. Also
    warms the card's solvers (the dense solve, the batched 3x3 SVD of the
    Sim3 RANSAC) before any timed loop window, and times one solve at K."""
    from dialog_tpu_torch import sim3
    from dialog_tpu_torch.optim.pose_graph import _system, solve_pose_graph
    from dialog_tpu_torch.optim.synth_problem import make_pose_graph

    gen = torch.Generator(device=dev).manual_seed(0)
    X = torch.rand(200, 3, device=dev, generator=gen)
    ok = torch.ones(200, dtype=torch.bool, device=dev)
    sim3.solve_sim3_ransac(X, 2.0 * X + 1.0, ok, sim3.draw_sim3_sets(ok, 128, gen))
    prob = make_pose_graph(seed=0, K=POSE_GRAPH_K, device=dev)
    cpu = make_pose_graph(seed=0, K=POSE_GRAPH_K, device="cpu")
    cost0 = float(_system(cpu, cpu.s, cpu.R, cpu.t)[0])
    got = solve_pose_graph(prob, iters=POSE_GRAPH_ITERS)
    want, cpu_s = _timed(lambda: solve_pose_graph(cpu, iters=POSE_GRAPH_ITERS))
    _, card_s = _timed(lambda: solve_pose_graph(prob, iters=POSE_GRAPH_ITERS))
    _, card_15_s = _timed(lambda: solve_pose_graph(prob, iters=15))
    diff = {k: float((g.cpu() - w).abs().max()) for k, g, w in zip("sRt", got[:3], want[:3])}
    out = dict(K=POSE_GRAPH_K, iters=POSE_GRAPH_ITERS, max_abs_diff=diff, cost_start=cost0, cost_card=float(got[3]),
               cost_cpu=float(want[3]), solve_card_s=card_s, solve_card_15_iters_s=card_15_s, solve_cpu_s=cpu_s)
    say("pose graph check (seeded, card against CPU): " + json.dumps(out) + f" on {smi}")
    if not all(v < POSE_GRAPH_TOL for v in diff.values()):
        fail(f"solve_pose_graph on the card differs from the CPU by {diff} (bound {POSE_GRAPH_TOL})")
    if not (float(got[3]) < 1e-6 * cost0 and float(want[3]) < 1e-6 * cost0):
        fail(f"solve_pose_graph did not converge: cost {cost0} -> card {float(got[3])}, cpu {float(want[3])}")
    return out


def run_loop_path(name, dev) -> dict:
    """The loop workload: 1.3 laps of the orbit (``profile_main_path.loop_scene``)
    in synthetic feature frames. ``loop``: the reference loop test's 260
    frames (a lap of LOOP_PERIOD) under ``loop_config``, every frame through
    ``Engine.track_features`` (detection at each keyframe, pulled and
    evaluated at the next). ``loop_tum``: the same frames per frame under
    ``loop_tum_config``, the TUM-class configuration at full width (1000
    features, K = 256). ``loop_async`` and ``loop_batch``: a lap of
    LOOP_BATCH_PERIOD (520 frames) under ``loop_config``. ``loop_async``:
    every frame through ``Engine.track_features_async``, ``flush`` (the
    detection runs where the pipeline resolves the keyframe);
    ``loop_batch``: 8 frames one by one, then batches of BATCH through
    ``Engine.track_batch`` (the detection dispatched at the batch's keyframe
    rides the next batch's pull and is evaluated at its resolve), ``flush``. Launch counts are reset just
    before and read just after. Counted on the way: host pulls, batches,
    synchronous detections, evaluations, guided matches and the kernel B
    launches inside them; each frame's (or batch's) wall time between two
    device syncs, less the harness's own work inside it; each
    ``_close_loop_from`` with candidates: its wall time, and at the first
    closure the similarity-aligned ATE of the frames so far just before and
    just after it, and a copy of the map and the detection it started from
    (``loop_probe`` replays it); each tick of the global BA that a closure
    starts (``_gba_tick``, one LM iteration of the PCG): its wall time and
    the frame (or batch, or the final ``flush``) it stalled, and the ATE of
    the frames so far just after the first closure's GBA folded in. Every
    path ends with ``flush``, which drains a GBA still in flight."""
    from dialog_tpu_torch import loopclosing
    from dialog_tpu_torch.containers import FrameArrays
    from dialog_tpu_torch.datasets import synth
    from dialog_tpu_torch.kernels import common
    from dialog_tpu_torch.system import Engine

    cfg = loop_tum_config() if name == "loop_tum" else loop_config()
    period = LOOP_BATCH_PERIOD if name in ("loop_async", "loop_batch") else LOOP_PERIOD
    scene = loop_scene(cfg, period)
    frames = [synth.observe(scene, i, noise_px=LOOP_NOISE_PX, desc_flips=LOOP_DESC_FLIPS, device=dev)[0]
              for i in range(LOOP_FRAMES * period // LOOP_PERIOD)]
    eng = Engine(cfg, device=dev)
    counts = {"pulls": 0, "batches": 0, "detect_calls": 0, "evaluate_calls": 0, "guided_matches": 0,
              "guided_mutual_launches": 0}
    _counted(eng, "_start_pull", counts, "pulls")
    _counted(eng._loop, "detect", counts, "detect_calls")
    _counted(eng._loop, "evaluate", counts, "evaluate_calls")
    closures, first = [], {}
    guided = loopclosing._guided_sim3_matches

    def counted_guided(*args):
        n0 = common.launches["hamming_mutual"]
        out = guided(*args)
        counts["guided_matches"] += 1
        counts["guided_mutual_launches"] += common.launches["hamming_mutual"] - n0
        return out

    close = eng._close_loop_from
    walls = []
    harness_s = [0.0]   # the harness's own seconds inside the current frame's window

    def harness(fn):
        _, sec = _timed(fn)
        harness_s[0] += sec

    def timed_close(det_kf, cands):
        n0 = len(eng._loop.closed_loops)
        if cands and n0 == 0:
            harness(lambda: first.update(
                wall_index=len(walls), det_kf=det_kf, cands=list(cands), det_seq=eng._loop.last_eval_det_seq,
                m=_clone(eng.m), bow_db=_clone(eng._bow_db), vocab=eng._vocab, ref_kf=eng.ref_kf,
                ate_before_m=path_ate(eng, scene, True) if len(eng.trajectory) > 3 else None))
        _, sec = _timed(lambda: close(det_kf, cands))
        if cands:
            done = len(eng._loop.closed_loops) > n0
            closures.append(dict(wall_index=len(walls), records=len(eng.trajectory), candidates=len(cands),
                                 closed=done, seconds=sec))
            if done and n0 == 0:
                harness(lambda: first.update(records=len(eng.trajectory), seconds=sec,
                                             ate_after_m=path_ate(eng, scene, True)))

    ticks = []
    tick, finish = eng._gba_tick, eng._finish_gba

    def timed_tick():
        if eng._gba is None:
            return tick()
        left = eng._gba["left"]
        _, sec = _timed(tick)
        ticks.append(dict(wall_index=len(walls), seconds=sec, left_before=left, folded=eng._gba is None))

    def timed_finish():
        finish()
        if "ate_after_gba_m" not in first and "records" in first:
            harness(lambda: first.update(gba_folded_at_records=len(eng.trajectory),
                                         ate_after_gba_m=path_ate(eng, scene, True)))

    def step(fn):
        harness_s[0] = 0.0
        _, sec = _timed(fn)
        walls.append(sec - harness_s[0])

    eng._close_loop_from = timed_close
    eng._gba_tick, eng._finish_gba = timed_tick, timed_finish
    loopclosing._guided_sim3_matches = counted_guided
    try:
        common.reset_launch_counts()
        n_single = 8 if name == "loop_batch" else len(frames)
        track = eng.track_features_async if name == "loop_async" else eng.track_features
        for i in range(n_single):
            step(lambda: track(frames[i], float(i) / 30.0))
        for i in range(n_single, len(frames) - BATCH + 1, BATCH):
            batch = FrameArrays(*[torch.stack(x) for x in zip(*frames[i : i + BATCH])])
            step(lambda: eng.track_batch(batch, [float(i + j) / 30.0 for j in range(BATCH)]))
            counts["batches"] += 1
        step(eng.flush)
        launches = dict(common.launches)
    finally:
        loopclosing._guided_sim3_matches = guided
        del eng._gba_tick, eng._finish_gba, eng._close_loop_from
    n_frames = n_single + counts["batches"] * BATCH
    return dict(scene=scene, eng=eng, launches=launches, counts=counts, closures=closures, first=first,
                walls=walls, ticks=ticks, n_frames=n_frames, n_single=n_single)


def check_loop_path(name, run, smi) -> dict:
    """The reference loop test's gates (``tests/test_loopclosing.py``) on
    the run: at least one closed loop, the first between keyframes more than
    LOOP_MIN_GAP insertions apart; OK share above LOOP_OK_SHARE over all
    frames; a finite ATE (similarity-aligned, OK frames from the first one)
    below LOOP_ATE_SPAN of the trajectory's span. ``loop_tum`` is held to
    the closure alone (ROADMAP D13), with its ATE finite. Also: a record per
    frame in order, kernel B (``hamming_mutual``) launched inside every
    guided match and at least once per guided match over the path, kernel C
    at least once. Batched: one host pull per batch (the detection rides
    it), no synchronous detection, at least one evaluation. Per frame and
    pipelined: synchronous detections. The global BA: at least one run
    (``stats["gba_runs"]``), none in flight after ``flush``; printed beside:
    the ATE just after the first closure's GBA folded in, the reference
    engine's readings on the same frames with its GBA on (REFERENCE_LOOP),
    the ticks' own wall times, and the worst frame (or batch) that a tick
    stalled against the median of those that no tick touched (the final
    ``flush`` apart: in ``loop_async`` it drains the whole GBA)."""
    from dialog_tpu_torch.system import OK

    eng, counts, launches = run["eng"], run["counts"], run["launches"]
    states = [r.state for r in eng.trajectory]
    if [r.frame_id for r in eng.trajectory] != list(range(run["n_frames"])):
        fail(f"{name}: {len(states)} records for {run['n_frames']} frames, or out of frame order")
    ok_share = float(np.mean([s == OK for s in states]))
    if OK not in states:
        fail(f"{name}: the engine never initialized")
    ate = path_ate(eng, run["scene"], True)
    scene = run["scene"]
    gt = np.stack([-scene.R[r.frame_id].T @ scene.t[r.frame_id] for r in eng.trajectory if r.state == OK])
    span = float(np.linalg.norm(gt.max(0) - gt.min(0)))
    seq = eng.m.kfs.seq.cpu().numpy()
    pairs = [[int(a), int(b), int(seq[a]), int(seq[b])] for a, b in eng._loop.closed_loops]
    first = {k: v for k, v in run["first"].items() if k not in ("m", "bow_db", "vocab")}
    walls = np.array(run["walls"])
    around = None
    if "records" in first:
        # the walls are per frame, and in loop_batch per batch after the first n_single frames
        around = dict(per=f"frame up to {run['n_single']}, then batch of {BATCH}" if name == "loop_batch" else "frame",
                      at_closure_s=float(walls[first["wall_index"]]), at_closure_index=first["wall_index"],
                      median_s=float(np.median(walls)), worst_s=float(walls.max()), worst_index=int(walls.argmax()))
    ticks = run["ticks"]
    flush_at = len(walls) - 1
    ticked = sorted({t["wall_index"] for t in ticks if t["wall_index"] != flush_at})
    quiet = np.delete(walls[:flush_at], ticked)
    gba = dict(runs=eng.stats["gba_runs"], obs_dropped=eng.stats["gba_obs_dropped"], ticks=len(ticks),
               tick_s_median=float(np.median([t["seconds"] for t in ticks])) if ticks else None,
               tick_s_max=max((t["seconds"] for t in ticks), default=None),
               worst_ticked_wall_s=float(walls[ticked].max()) if ticked else None,
               worst_ticked_index=int(ticked[int(np.argmax(walls[ticked]))]) if ticked else None,
               median_quiet_wall_s=float(np.median(quiet)), flush_s=float(walls[flush_at]),
               ticks_in_flush=sum(1 for t in ticks if t["wall_index"] == flush_at),
               flush_tick_s=sum(t["seconds"] for t in ticks if t["wall_index"] == flush_at))
    out = dict(state=eng.state, frames=len(states), kf_count=eng.kf_count, ok_share=ok_share, ate_m=ate, span_m=span,
               ate_gate_m=LOOP_ATE_SPAN * span, reference=REFERENCE_LOOP[name], closed_slots_and_seqs=pairs,
               first_closure=first, closures_tried=run["closures"], wall_at_closure=around, gba=gba,
               launches=launches, **counts)
    say(f"{name} path: " + json.dumps(out) + f" on {smi}")
    if eng.stats["gba_runs"] < 1 or eng._gba is not None:
        fail(f"{name}: {eng.stats['gba_runs']} global BA runs, one still in flight after flush: {eng._gba is not None}")
    if not pairs:
        fail(f"{name}: no loop was closed")
    if not pairs[0][2] - pairs[0][3] > LOOP_MIN_GAP:
        fail(f"{name}: the first closure joins keyframes {pairs[0][2]} and {pairs[0][3]}, not more than "
             f"{LOOP_MIN_GAP} insertions apart")
    if name != "loop_tum" and not ok_share > LOOP_OK_SHARE:
        fail(f"{name}: OK share {ok_share} <= {LOOP_OK_SHARE}")
    if not (np.isfinite(ate) and (name == "loop_tum" or ate < LOOP_ATE_SPAN * span)):
        fail(f"{name}: ATE {ate} m not below {LOOP_ATE_SPAN} x the span {span} m")
    n_guided = counts["guided_matches"]
    if counts["guided_mutual_launches"] < n_guided or launches["hamming_mutual"] < n_guided:
        fail(f"{name}: {counts['guided_matches']} guided matches launched kernel B {counts['guided_mutual_launches']} "
             f"times ({launches['hamming_mutual']} on the path)")
    if counts["guided_matches"] < 1 or launches["schur_reduce"] < 1:
        fail(f"{name}: no guided match ({counts['guided_matches']}) or no kernel C launch ({launches['schur_reduce']})")
    if name == "loop_batch":
        if not 1 <= counts["pulls"] <= counts["batches"]:
            fail(f"{name}: {counts['pulls']} host pulls for {counts['batches']} batches")
        if counts["detect_calls"] or counts["evaluate_calls"] < 1:
            fail(f"{name}: {counts['detect_calls']} synchronous detections, {counts['evaluate_calls']} evaluations")
    elif counts["detect_calls"] < 1:
        fail(f"{name}: no synchronous detection")
    return out


def loop_probe(name, run, dev, smi) -> dict:
    """Replays, on a copy of the map as it stood, the detection and the first
    closure of a loop run, and times each step at its own shapes (device
    synced around each; the median of LOOP_REPS calls after one warm call):
    one detection (``dispatch``, the host copy of its vector and neighbour
    matrix, ``evaluate``), one ``compute_sim3`` and within it one
    ``solve_sim3_ransac``, one ``refine_sim3_reproj`` and one guided match,
    one ``solve_pose_graph`` at the map's K, one ``correct``, one whole
    ``_close_loop_from``; counts the stream syncs of that whole closure and
    of its ``compute_sim3`` (``torch.cuda.set_sync_debug_mode("warn")``, as
    ``tools/sync_probe.py`` counts them); then, on the closed copy, one
    ``_start_gba`` and one ``_gba_tick`` of the global BA the closure starts,
    and the stream syncs of a tick.
    The guided match count must be equal on the card and on a CPU copy of
    the map."""
    import copy
    import warnings

    from dialog_tpu_torch import loopclosing
    from dialog_tpu_torch.loopclosing import LoopCloser
    from dialog_tpu_torch.system import Engine

    eng, first = run["eng"], run["first"]
    cfg = eng.cfg
    m, det_kf = first["m"], first["det_kf"]
    cand = eng._loop.closed_loops[0][1]

    def median_s(fn):
        fn()
        return float(np.median([_timed(fn)[1] for _ in range(LOOP_REPS)]))

    def detection():
        lc = LoopCloser(cfg)
        lc.dispatch(m, first["bow_db"], first["vocab"], det_kf, stamp=10**6)
        kf, vec, neigh, stamp = lc.take_pending()
        return lc.evaluate(kf, vec.cpu().numpy(), neigh.cpu().numpy(), stamp=stamp)

    calls = {}
    names = ("solve_sim3_ransac", "refine_sim3_reproj", "_guided_sim3_matches", "solve_pose_graph")
    inner = {k: getattr(loopclosing, k) for k in names}

    def recorder(k):
        def fn(*args, **kwargs):
            calls[k] = (args, kwargs)
            return inner[k](*args, **kwargs)
        return fn

    gen = torch.Generator(device=dev).manual_seed(LOOP_PROBE_SEED)
    for k in names:
        setattr(loopclosing, k, recorder(k))
    try:
        lc = LoopCloser(cfg)
        found = lc.compute_sim3(m, det_kf, cand, generator=gen)
        if found is None:
            fail(f"{name} probe: compute_sim3 of keyframes {det_kf} and {cand} failed on the replay")
        lc.correct(_clone(m), det_kf, found, cfg)
    finally:
        for k in names:
            setattr(loopclosing, k, inner[k])
    if set(calls) != set(names):
        fail(f"{name} probe: the replay made only the calls {sorted(calls)}")
    out = {"keyframes": [det_kf, cand], "K": cfg.max_keyframes, "sim3_iters": cfg.sim3_ransac_iters,
           "matches": int(calls["solve_sim3_ransac"][0][2].sum()), "n_inliers": found.n_inliers,
           "detection_s": median_s(detection),
           "compute_sim3_s": median_s(lambda: LoopCloser(cfg).compute_sim3(m, det_kf, cand, generator=gen)),
           "correct_s": median_s(lambda: LoopCloser(cfg).correct(_clone(m), det_kf, found, cfg))}
    for k in names:
        args, kwargs = calls[k]
        out[k.strip("_") + "_s"] = median_s(lambda: inner[k](*args, **kwargs))
    args, kwargs = calls["_guided_sim3_matches"]
    n_card = int(inner["_guided_sim3_matches"](*args, **kwargs))
    n_cpu = int(inner["_guided_sim3_matches"](*[_to(a, "cpu") for a in args], **kwargs))
    out.update(guided_count_card=n_card, guided_count_cpu=n_cpu)

    def whole():
        e = copy.copy(eng)
        e.stats = dict(eng.stats)
        e._loop = copy.deepcopy(eng._loop)
        e._loop.last_eval_det_seq = first["det_seq"]
        e.m, e.ref_kf = _clone(m), first["ref_kf"]
        Engine._close_loop_from(e, det_kf, first["cands"])
        return e

    out["close_loop_from_s"] = median_s(whole)

    def stream_syncs(fn):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                res = fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return res, sum(1 for w in caught if "synchroniz" in str(w.message))

    e, out["close_loop_from_stream_syncs"] = stream_syncs(whole)
    # the global BA the closure starts: its start (problem, snapshot, first cost) and one tick
    out["start_gba_s"] = median_s(lambda: e._start_gba(e.gba_iters))
    out["gba_tick_s"] = median_s(e._gba_tick)
    # host reads in one tick: the CG's exit flag once every CG_CHECK_EVERY iterations, nothing per iteration
    _, out["gba_tick_stream_syncs"] = stream_syncs(e._gba_tick)
    out["gba_problem"] = dict(C=int(e._gba["prob"].R.shape[0]), P=int(e._gba["prob"].xyz.shape[0]),
                              observations=int(e._gba["prob"].obs_ok.sum()), cg_iters=e._gba["cg_iters"])
    _, out["compute_sim3_stream_syncs"] = stream_syncs(
        lambda: LoopCloser(cfg).compute_sim3(m, det_kf, cand, generator=gen))
    if len(e._loop.closed_loops) <= len(eng._loop.closed_loops):
        fail(f"{name} probe: the replayed _close_loop_from did not close the loop")
    from dialog_tpu_torch.optim.schur_pcg import CG_CHECK_EVERY

    most = -(-e._gba["cg_iters"] // CG_CHECK_EVERY)
    if out["gba_tick_stream_syncs"] > most:
        fail(f"{name} probe: one GBA tick made {out['gba_tick_stream_syncs']} stream syncs, more than the "
             f"{most} reads of the CG's exit flag ({e._gba['cg_iters']} iterations, one read every {CG_CHECK_EVERY})")
    say(f"{name} probe: " + json.dumps(out) + f" on {smi}")
    if n_card != n_cpu:
        fail(f"{name} probe: the guided match counts {n_card} on the card, {n_cpu} on the CPU")
    return out


# ---------------------------------------------------------------------------
# global bundle adjustment
# ---------------------------------------------------------------------------


def perturbed_map(m, seed: int = GBA_SEED, sigma: float = GBA_NOISE):
    """The map with the translations of the keyframes a global BA optimizes
    (valid, slot >= 2) and its valid landmarks moved by N(0, sigma) (numpy
    draws from ``seed``), so that a solve from it has work to do."""
    rng = np.random.default_rng(seed)
    dev = m.kfs.t.device
    opt = (m.kfs.valid & (torch.arange(m.kfs.valid.shape[0], device=dev) >= 2))[:, None]
    dt = torch.from_numpy(rng.normal(0.0, sigma, tuple(m.kfs.t.shape)).astype(np.float32)).to(dev)
    dx = torch.from_numpy(rng.normal(0.0, sigma, tuple(m.lms.xyz.shape)).astype(np.float32)).to(dev)
    return m._replace(kfs=m.kfs._replace(t=m.kfs.t + dt * opt), lms=m.lms._replace(xyz=m.lms.xyz + dx * m.lms.valid[:, None]))


def map_diff(a, b) -> dict:
    """Largest differences of the valid keyframes' R, t and the valid
    landmarks between two maps (on any devices), and the count of
    observation slots whose outlier decision differs."""
    va, vl = a.kfs.valid.cpu(), a.lms.valid.cpu()
    d = lambda x, y, v: float((x.cpu() - y.cpu())[v].abs().max())  # noqa: E731
    return dict(R=d(a.kfs.R, b.kfs.R, va), t=d(a.kfs.t, b.kfs.t, va), xyz=d(a.lms.xyz, b.lms.xyz, vl),
                obs_lm_slots=int((a.kfs.obs_lm.cpu() != b.kfs.obs_lm.cpu()).sum()))


def within(diff: dict) -> bool:
    return diff["R"] < GBA_TOL_POSE and diff["t"] < GBA_TOL_POSE and diff["xyz"] < GBA_TOL_XYZ


def exact_cg(prob) -> dict:
    """A CG budget that solves the reduced camera system rather than
    approximating it: as many iterations as it has unknowns (6 per optimized
    camera), no early exit. The default budget (48 iterations, exit at a
    relative M-norm residual of 1e-6, the reference's) leaves the step some
    1e-3 off the exact one on the loop maps (PERF.md), and a comparison of
    two sums taken in different orders then compares two truncations."""
    return dict(cg_iters=6 * int(prob.cam_opt.sum()), cg_tol=0.0)


def check_gba_dense(run, dev, smi) -> dict:
    """``global_bundle_adjustment`` on the ``loop`` run's final map (K = 96
    keyframe slots: the dense branch, kernel C at C = 96), moved off its
    optimum (``perturbed_map``), GBA_ITERS iterations, on the card; against
    ``solve_ba_pcg`` on the same problem with an exact CG (``exact_cg``, as
    the CPU test holds the PCG to the dense solve), written back alike, and
    against the same call on a CPU copy of the map (the plain reduction):
    poses within GBA_TOL_POSE, landmarks within GBA_TOL_XYZ. Printed beside:
    the PCG at its default CG budget against the dense solve. Launch counts
    are reset just before the card's call and read just after: kernel C must
    have run once per iteration."""
    from dialog_tpu_torch.kernels import common
    from dialog_tpu_torch.optim.global_ba import DENSE_SCHUR_MAX_CAMS, build_global_problem, global_bundle_adjustment
    from dialog_tpu_torch.optim.local_ba import write_back
    from dialog_tpu_torch.optim.schur_pcg import solve_ba_pcg

    cfg = run["eng"].cfg
    m = perturbed_map(run["eng"].m)
    prob, n_dropped = build_global_problem(m, cfg)
    C = prob.R.shape[0]
    if C > DENSE_SCHUR_MAX_CAMS:
        fail(f"gba_dense: the loop map has {C} keyframe slots, not the dense branch's at most {DENSE_SCHUR_MAX_CAMS}")
    stats = {}
    common.reset_launch_counts()
    card, card_s = _timed(lambda: global_bundle_adjustment(m, cfg, iters=GBA_ITERS, stats=stats))
    launches = dict(common.launches)
    cpu, cpu_s = _timed(lambda: global_bundle_adjustment(_to(m, "cpu"), cfg, iters=GBA_ITERS))

    def pcg(**cg):
        R, t, xyz, _, n_cg = solve_ba_pcg(prob, cfg, iters=GBA_ITERS, chi2_th=cfg.chi2_mono, return_cg_iters=True,
                                          **cg)
        return write_back(m, prob, R, t, xyz, cfg, chi2_th=cfg.chi2_mono), int(n_cg)

    exact = exact_cg(prob)
    (pcg_map, n_cg), pcg_s = _timed(lambda: pcg(**exact))
    (budget_map, n_budget), budget_s = _timed(pcg)
    moved = map_diff(card, m)
    out = dict(C=C, P=int(prob.xyz.shape[0]), O=int(prob.obs_cam.shape[1]), observations=int(prob.obs_ok.sum()),
               keyframes=int(m.kfs.valid.sum()), landmarks=int(m.lms.valid.sum()), obs_dropped=stats["gba_obs_dropped"],
               iters=GBA_ITERS, dense_card_s=card_s, dense_cpu_s=cpu_s, pcg_exact=exact, pcg_card_s=pcg_s,
               pcg_cg_iters=n_cg, card_vs_cpu=map_diff(card, cpu), card_vs_pcg=map_diff(card, pcg_map),
               pcg_default_budget=dict(card_s=budget_s, cg_iters=n_budget, vs_dense=map_diff(card, budget_map)),
               moved=moved, launches=launches)
    say("gba_dense: " + json.dumps(out) + f" on {smi}")
    if launches["schur_reduce"] < GBA_ITERS:
        fail(f"gba_dense: kernel C launched {launches['schur_reduce']} times in {GBA_ITERS} iterations")
    if not (within(out["card_vs_cpu"]) and within(out["card_vs_pcg"])):
        fail(f"gba_dense: the dense solve on the card differs from the CPU's or from the PCG's beyond "
             f"{GBA_TOL_POSE} (poses) / {GBA_TOL_XYZ} (landmarks)")
    if not moved["t"] > 10 * GBA_TOL_POSE:
        fail("gba_dense: the solve did not move the poses: the check would show nothing")
    return out


def check_gba_capacity(dev, smi) -> dict:
    """``tests/test_kitti_capacity.py`` on the card: the corridor map at the
    KITTI00 preset (``synth_problem.build_corridor_map``: 1,100 live
    keyframes of 2,048, 137,500 landmarks of 262,144, 4 observers each),
    ``process_new_keyframe`` and a 3-iteration local BA at that occupancy,
    ``build_global_problem`` (it must select the PCG), one
    ``global_bundle_adjustment(iters=1)``. Gates: the new keyframe valid and
    finite, every valid pose and landmark finite after the GBA, the median
    corridor error below CORRIDOR_TOL. Measured on the problem: the wall and
    device time of ``build_global_problem`` and of one PCG LM iteration (the
    GBA's full CG budget), its CG iterations and the peak memory it takes,
    and the wall time of one engine tick at this size (``cg_iters`` 16,
    ``cg_tol`` 1e-4): the worst stall a tracked frame would meet."""
    from dialog_tpu_torch import mapping
    from dialog_tpu_torch.config import KITTI00
    from dialog_tpu_torch.containers import FrameArrays
    from dialog_tpu_torch.kernels import common
    from dialog_tpu_torch.optim.global_ba import DENSE_SCHUR_MAX_CAMS, build_global_problem, global_bundle_adjustment
    from dialog_tpu_torch.optim.local_ba import local_bundle_adjustment
    from dialog_tpu_torch.optim.schur_pcg import lm_init_pcg, lm_steps_pcg
    from dialog_tpu_torch.optim.synth_problem import build_corridor_map

    cfg = KITTI00
    m, build_map_s = _timed(lambda: build_corridor_map(cfg, n_kf=CORRIDOR_KFS, step=CORRIDOR_STEP, device=dev))
    k = CORRIDOR_KFS - 1
    kfs = m.kfs
    frame = FrameArrays(uv=kfs.uv[k], uv_raw=kfs.uv[k], response=torch.where(kfs.feat_valid[k], 50.0, 0.0),
                        octave=kfs.octave[k], angle=kfs.angle[k], desc=kfs.desc[k], valid=kfs.feat_valid[k],
                        u_right=kfs.u_right[k], depth=kfs.depth[k])
    t_new = torch.tensor([0.0, 0.0, -(CORRIDOR_KFS - 0.5) * CORRIDOR_STEP], device=dev)
    common.reset_launch_counts()

    def keyframe():
        m2 = mapping.process_new_keyframe(m, frame, torch.eye(3, device=dev), t_new, kfs.obs_lm[k], CORRIDOR_KFS,
                                          CORRIDOR_KFS / 10.0, CORRIDOR_KFS, k, cfg, spawn_depth=True,
                                          n_neighbors=cfg.kf_tri_neighbors)
        return local_bundle_adjustment(m2, CORRIDOR_KFS, cfg, iters=3)

    m2, keyframe_s = _timed(keyframe)
    if not (bool(m2.kfs.valid[CORRIDOR_KFS]) and bool(torch.isfinite(m2.kfs.t[CORRIDOR_KFS]).all())):
        fail("gba_capacity: the keyframe inserted at occupancy is not valid and finite")
    (prob, n_dropped), build_s = _timed(lambda: build_global_problem(m2, cfg))
    build_dev = device_ms(lambda: build_global_problem(m2, cfg), (), reps=3, warm=1)["other_device_ms"]
    C, (P, O) = prob.R.shape[0], prob.obs_cam.shape
    if C <= DENSE_SCHUR_MAX_CAMS:
        fail(f"gba_capacity: {C} cameras do not select the PCG")
    carry0 = lm_init_pcg(prob, cfg, chi2_th=cfg.chi2_mono)
    step = lambda **kw: lm_steps_pcg(prob, cfg, carry0, chi2_th=cfg.chi2_mono, **kw)  # noqa: E731
    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    carry1, iter_s = _timed(step)
    peak = torch.cuda.max_memory_allocated()
    iter_dev = device_ms(step, (), reps=2, warm=0)["other_device_ms"]
    _, tick_s = _timed(lambda: step(cg_iters=16, cg_tol=1e-4))
    top_build = top_device_kernels(lambda: build_global_problem(m2, cfg))
    top_iter = top_device_kernels(step)
    stats = {}
    m3, gba_s = _timed(lambda: global_bundle_adjustment(m2, cfg, iters=1, stats=stats))
    launches = dict(common.launches)
    vk, vl = m3.kfs.valid, m3.lms.valid
    finite = bool(torch.isfinite(m3.kfs.R[vk]).all() and torch.isfinite(m3.kfs.t[vk]).all()
                  and torch.isfinite(m3.lms.xyz[vl]).all())
    t_err = (m3.kfs.t[:CORRIDOR_KFS, 2] + torch.arange(CORRIDOR_KFS, device=dev) * CORRIDOR_STEP).abs()
    med = float(t_err.median())
    out = dict(K=cfg.max_keyframes, L=cfg.max_landmarks, F=cfg.max_features, O=O, C=C, P=P,
               keyframes=int(vk.sum()), landmarks=int(vl.sum()), observations=int(prob.obs_ok.sum()),
               obs_dropped=int(n_dropped), build_map_s=build_map_s, keyframe_and_local_ba_s=keyframe_s,
               build_global_problem_s=build_s, build_global_problem_device_ms=build_dev,
               pcg_iteration_s=iter_s, pcg_iteration_device_ms=iter_dev,
               pcg_iteration_cg_iters=int(carry1[5]) - int(carry0[5]), pcg_iteration_accepted=bool(carry1[4] < carry0[4]),
               peak_memory_bytes=int(peak), peak_above_resident_bytes=int(peak - base),
               engine_tick_s=tick_s, gba_iters_1_s=gba_s, median_corridor_error_m=med, finite=finite,
               top_kernels_build_global_problem=top_build, top_kernels_pcg_iteration=top_iter, launches=launches)
    say("gba_capacity: " + json.dumps(out) + f" on {smi}")
    if not finite:
        fail("gba_capacity: non-finite poses or landmarks after the global BA")
    if not med < CORRIDOR_TOL:
        fail(f"gba_capacity: median corridor error {med} m, not below {CORRIDOR_TOL} m")
    return out


def with_kf_slots(m, cfg, K: int):
    """The same map in K keyframe slots: the first ones as they are, the
    others empty as ``empty_map`` makes them (so the global problem has C = K
    cameras, the same live ones)."""
    from dialog_tpu_torch.containers import empty_map

    k0 = m.kfs.valid.shape[0]
    e = empty_map(cfg.replace(max_keyframes=K), device=m.kfs.R.device)

    def grow(new, old):
        new = new.clone()
        new[:k0] = old
        return new

    covis = torch.zeros((K, K), dtype=m.covis.dtype, device=m.covis.device)
    covis[:k0, :k0] = m.covis
    return m._replace(kfs=type(m.kfs)(*[grow(a, b) for a, b in zip(e.kfs, m.kfs)]), covis=covis)


# gba_sharded's solves: (name, the loop run it takes its map from, keyframe slots (None: the run's own), gated)
SHARDED_JOBS = (("loop", "loop", None, True), ("loop_k256", "loop", 256, True), ("loop_tum", "loop_tum", None, False))


def check_gba_sharded(loop_runs, dev, smi) -> dict:
    """Landmark-sharded global BA on the card: two ranks
    (``python -m dialog_tpu_torch.gba_rank``, two processes, a gloo group:
    NCCL refuses two ranks on one device) each load the final map of
    ``loop`` (K = 96: the dense branch, kernel C on each rank's half of the
    landmarks, the camera sums all-reduced), the same map in 256 keyframe
    slots (``loop_k256``: the PCG, with an exact CG, ``exact_cg``: one
    all-reduce per CG iteration) and the final map of ``loop_tum`` (K = 256,
    the PCG likewise), their landmark slots permuted from GBA_SEED (the engine
    fills slots from the bottom: unpermuted, the second rank would hold no
    live landmark) and moved off their optimum as in ``check_gba_dense``,
    which the parent saved with ``save_map``, and run GBA_ITERS iterations.
    The parent holds the two ranks against each other (bit for bit: every
    decision is taken from all-reduced values) and, for ``loop`` and
    ``loop_k256``, each rank's result against its own one-rank solve of the
    same map on the card (GBA_TOL_POSE, GBA_TOL_XYZ). On the ``loop_tum`` map
    (after D13's wrong correction, far from any optimum: the cost falls by a
    third an iteration) the PCG's result moves by some 5e-4 under a mere
    reordering of its sums, as much as between two one-rank solves on the
    card (``index_add_``, D15), so there the difference to one rank and the
    one-rank solve's own spread are printed, not gated. One card: two-card
    scaling is not measured here."""
    from pathlib import Path

    from dialog_tpu_torch.containers import permute_landmarks, save_map
    from dialog_tpu_torch.gba_rank import config_to_json, free_address, launch
    from dialog_tpu_torch.kernels import common
    from dialog_tpu_torch.optim.global_ba import DENSE_SCHUR_MAX_CAMS, build_global_problem, global_bundle_adjustment

    out_dir = Path(__file__).resolve().parent / "build" / "gba_sharded"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs, one, repeat = [], {}, {}
    common.reset_launch_counts()
    for name, source, K, _ in SHARDED_JOBS:
        eng = loop_runs[source]["eng"]
        cfg, m = eng.cfg, eng.m
        if K is not None:
            cfg, m = cfg.replace(max_keyframes=K), with_kf_slots(m, cfg, K)
        perm = torch.from_numpy(np.random.default_rng(GBA_SEED).permutation(cfg.max_landmarks))
        m = perturbed_map(permute_landmarks(m, perm))
        save_map(m, str(out_dir / f"{name}.npz"))
        cg = exact_cg(build_global_problem(m, cfg)[0]) if cfg.max_keyframes > DENSE_SCHUR_MAX_CAMS else {}
        jobs.append({"config": config_to_json(cfg), "map": str(out_dir / f"{name}.npz"), "iters": GBA_ITERS,
                     "out": str(out_dir / f"{name}_out.npz"), "pcg": cg})
        one[name] = _timed(lambda: global_bundle_adjustment(m, cfg, iters=GBA_ITERS, **cg))
        repeat[name] = map_diff(one[name][0], global_bundle_adjustment(m, cfg, iters=GBA_ITERS, **cg))
    launches = dict(common.launches)
    spec = {"address": free_address(), "world": 2, "backend": "gloo", "device": dev.type, "jobs": jobs}
    ranks, wall = _timed(lambda: launch(spec, str(out_dir / "job.json"), timeout=400,
                                        cwd=Path(__file__).resolve().parent))
    out = {"world": 2, "backend": "gloo", "ranks_wall_s": wall, "one_rank_launches": launches}
    ok = True
    for i, (name, _, _, gated) in enumerate(SHARDED_JOBS):
        want, one_s = one[name]
        got = [ranks[r][i] for r in range(2)]
        same = all(np.array_equal(got[0][k], got[1][k]) for k in ("R", "t", "xyz", "obs_lm"))
        vk, vl = want.kfs.valid.cpu().numpy(), want.lms.valid.cpu().numpy()
        diff = dict(R=float(np.abs(got[0]["R"] - want.kfs.R.cpu().numpy())[vk].max()),
                    t=float(np.abs(got[0]["t"] - want.kfs.t.cpu().numpy())[vk].max()),
                    xyz=float(np.abs(got[0]["xyz"] - want.lms.xyz.cpu().numpy())[vl].max()),
                    obs_lm_slots=int((got[0]["obs_lm"] != want.kfs.obs_lm.cpu().numpy()).sum()))
        out[name] = dict(K=int(vk.shape[0]), pcg=jobs[i]["pcg"] or None, gated=gated, one_rank_s=one_s,
                         one_rank_repeat=repeat[name], rank_s=[float(g["seconds"]) for g in got],
                         rank_world=[int(g["world"]) for g in got], rows_held=[int(g["rows_held"]) for g in got],
                         live_landmarks_held=[int(g["live_held"]) for g in got],
                         rank_schur_launches=[int(g["schur_launches"]) for g in got],
                         ranks_bitwise_equal=same, two_ranks_vs_one=diff)
        ok &= same and all(int(g["world"]) == 2 and int(g["live_held"]) > 0 for g in got)
        ok &= within(diff) if gated else bool(np.isfinite(list(diff.values())).all())
    say("gba_sharded: " + json.dumps(out) + f" on {smi} (one card: two-card scaling not measured)")
    if not ok:
        fail("gba_sharded: the two ranks disagree with each other, or with the one-rank solve beyond tolerance")
    if not all(n >= GBA_ITERS for n in out["loop"]["rank_schur_launches"]):
        fail("gba_sharded: kernel C did not run on each rank of the dense branch")
    return out


def check_schur_large_c(dev, smi) -> dict:
    """Kernel C at global BA's camera counts (the dense branch takes C up to
    ``DENSE_SCHUR_MAX_CAMS``): for each C of LARGE_C a seeded problem from
    ``synth_problem.make_problem`` with C cameras, LARGE_C_P landmark slots
    of which LARGE_C_PTS live, each seen by LARGE_C_O cameras. The direct
    outputs against the plain version at LAM_C (REL_TOL_C, as
    ``check_schur``), a repeated call bit for bit, and the readings of
    ``entry`` (device time, wrapper loop, plain version, bound)."""
    from dialog_tpu_torch.config import EngineConfig
    from dialog_tpu_torch.kernels.schur import camera_index, schur_reduce, schur_reduce_plain
    from dialog_tpu_torch.optim.synth_problem import make_problem

    out = {}
    for C in LARGE_C:
        cfg = EngineConfig(max_local_kfs=C - 2, max_fixed_kfs=2, max_local_lms=LARGE_C_P, max_obs_per_lm=LARGE_C_O)
        prob = make_problem(seed=SOLVE_SEED, n_cams=C, n_pts=LARGE_C_PTS, cfg=cfg, device=dev)[0]
        lam = torch.tensor(LAM_C, dtype=torch.float32, device=dev)
        args = (prob.R, prob.t, prob.cam_opt, prob.xyz, prob.obs_cam, prob.obs_uv, prob.obs_w, lam,
                cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.chi2_mono)
        idx = camera_index(prob.obs_cam, prob.obs_w, C)
        got = schur_reduce(*args, cam_index=idx)
        again = schur_reduce(*args, cam_index=idx)
        want = schur_reduce_plain(*args)
        torch.cuda.synchronize()
        errs = {n: _rel_err(g, w, per_block=n == "Hll_inv")
                for n, g, w in zip(["Hll_inv", "g_l", "Y", "Hcc", "g_c", "g_red", "S_pair"], got, want)}
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        t = entry("schur_reduce", lambda: schur_reduce(*args, cam_index=idx), lambda: schur_reduce_plain(*args),
                  schur_bound(args, {}, got), reps=20)
        out[C] = dict(P=LARGE_C_P, O=LARGE_C_O, live_landmarks=LARGE_C_PTS, rel_err=errs, bitwise_repeatable=repeat,
                      max_abs_err=max(float((g - w).abs().max()) for g, w in zip(got, want)), **t)
        say(f"kernel C schur_reduce at C={C} (P={LARGE_C_P}, O={LARGE_C_O}, seeded, lam={LAM_C}): "
            f"{json.dumps(out[C])} on {smi}")
        if not (max(errs.values()) <= REL_TOL_C and repeat):
            fail(f"kernel C at C={C}: outputs {errs} beyond {REL_TOL_C} of the plain version, or not repeatable "
                 f"({repeat})")
    return out


# ---------------------------------------------------------------------------
# block bundle adjustment, determinism and the engine's other modes
# ---------------------------------------------------------------------------


def block_corridor(dev):
    """The KITTI00 corridor of ``gba_capacity`` (``build_corridor_map``:
    CORRIDOR_KFS live keyframes, BLOCK_LMS_PER_KF landmarks each) moved off
    its truth block by block (``synth_problem.perturb_block_local`` from
    BLOCK_SEED, with the blocks ``block_refine`` makes of it at BLOCK_ARGS):
    (map, ground-truth keyframe translations, block size)."""
    from dialog_tpu_torch.config import KITTI00
    from dialog_tpu_torch.optim.synth_problem import build_corridor_map, perturb_block_local

    m = build_corridor_map(KITTI00, n_kf=CORRIDOR_KFS, lm_per_kf=BLOCK_LMS_PER_KF, step=CORRIDOR_STEP, device=dev)
    blk = -(-CORRIDOR_KFS // BLOCK_ARGS["n_blocks"])
    t_gt = m.kfs.t[:CORRIDOR_KFS].clone()
    return perturb_block_local(m, CORRIDOR_KFS, BLOCK_LMS_PER_KF, blk, seed=BLOCK_SEED), t_gt, blk


def centre_error(m, t_gt) -> float:
    """Mean camera-centre error of the corridor's keyframes (its truth: R = I)."""
    n = t_gt.shape[0]
    c = -torch.einsum("kij,ki->kj", m.kfs.R[:n], m.kfs.t[:n])
    return float((c + t_gt).norm(dim=1).mean())


def check_block_capacity(corridor, dev, smi) -> dict:
    """``Engine.block_refine`` at the KITTI00 preset on ``block_corridor``:
    BLOCK_ARGS (32 blocks of 35 owned keyframes and some 3 boundary ones,
    some 4,400 owned landmarks; each block a kernel C call at C = 64, P =
    16,384, O = 12 in its frozen-landmark mode, the stereo variant since
    KITTI00 has bf > 0). Gates: no owned keyframe left out, every valid pose
    and landmark finite, the mean camera-centre error down at least
    BLOCK_GAIN-fold (the reference test's gate), and ``schur_reduce_frozen``
    launched exactly rounds x 2 x n_blocks / 2 x iters times, no other kernel
    C launch. Measured: the refine's wall time and peak memory, then on the
    refined map one round's wall and device time (printed per half-step) with
    its top device kernels, and one block solve's wall time."""
    from dialog_tpu_torch.config import KITTI00
    from dialog_tpu_torch.kernels import common
    from dialog_tpu_torch.optim.block_ba import block_bundle_adjustment, block_problem, build_block_problems
    from dialog_tpu_torch.optim.local_ba import solve_ba
    from dialog_tpu_torch.system import Engine

    cfg = KITTI00
    m, t_gt, blk = corridor
    eng = Engine(cfg, device=dev)
    eng.m, eng.kf_count, eng.ref_kf = m, CORRIDOR_KFS, CORRIDOR_KFS - 1
    err0 = centre_error(m, t_gt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    common.reset_launch_counts()
    _, refine_s = _timed(lambda: eng.block_refine(**BLOCK_ARGS))
    launches = dict(common.launches)
    peak = torch.cuda.max_memory_allocated()
    err1 = centre_error(eng.m, t_gt)
    vk, vl = eng.m.kfs.valid, eng.m.lms.valid
    finite = bool(torch.isfinite(eng.m.kfs.R[vk]).all() and torch.isfinite(eng.m.kfs.t[vk]).all()
                  and torch.isfinite(eng.m.lms.xyz[vl]).all())
    a = BLOCK_ARGS
    want_launches = a["rounds"] * 2 * (a["n_blocks"] // 2) * a["iters"]
    probs, cam_own, _, _ = build_block_problems(eng.m, cfg, a["n_blocks"], a["cams_pb"], a["lms_pb"])

    def one_round():   # two half-steps
        return block_bundle_adjustment(eng.m, cfg, **{**a, "rounds": 1})

    _, round_s = _timed(one_round)
    round_dev = device_ms(one_round, DEVICE_KERNELS["schur_reduce_frozen"], reps=1, warm=0)
    top_round = top_device_kernels(one_round, n=8)
    _, solve_s = _timed(lambda: solve_ba(block_problem(probs, 1), cfg, iters=a["iters"], chi2_th=cfg.chi2_mono))
    live = (probs.lm_ids < cfg.max_landmarks)
    out = dict(K=cfg.max_keyframes, L=cfg.max_landmarks, F=cfg.max_features, keyframes=int(vk.sum()),
               landmarks=int(vl.sum()), block_size=blk, **BLOCK_ARGS, C=int(probs.cam_slots.shape[1]),
               P=int(probs.lm_ids.shape[1]), O=int(probs.obs_cam.shape[2]),
               owned_cameras_per_block=[int(x) for x in cam_own.sum(1)],
               cameras_per_block=[int(x) for x in (probs.cam_slots < cfg.max_keyframes).sum(1)],
               owned_landmarks_per_block=[int(x) for x in (live & probs.lm_opt).sum(1)],
               boundary_landmarks_per_block=[int(x) for x in (live & ~probs.lm_opt).sum(1)],
               observations_per_block=[int(x) for x in probs.obs_ok.sum((1, 2))],
               block_ba_obs_dropped=eng.stats["block_ba_obs_dropped"],
               block_ba_kf_dropped=eng.stats["block_ba_kf_dropped"], centre_error_before_m=err0,
               centre_error_after_m=err1, gain=err0 / max(err1, 1e-12), finite=finite, refine_s=refine_s,
               half_step_s=round_s / 2, half_step_device_ms=(round_dev["device_ms"] + round_dev["other_device_ms"]) / 2,
               half_step_kernel_c_device_ms=round_dev["device_ms"] / 2, top_kernels_round=top_round,
               block_solve_s=solve_s,
               peak_memory_bytes=int(peak), peak_above_resident_bytes=int(peak - base), launches=launches)
    say("block_capacity: " + json.dumps(out) + f" on {smi}")
    if out["block_ba_kf_dropped"] != 0:
        fail(f"block_capacity: {out['block_ba_kf_dropped']} owned keyframes left out of their blocks")
    if not finite:
        fail("block_capacity: non-finite poses or landmarks after the block BA")
    if not err1 < err0 / BLOCK_GAIN:
        fail(f"block_capacity: camera-centre error {err0} -> {err1} m, not down {BLOCK_GAIN}-fold")
    if launches["schur_reduce_frozen"] != want_launches or launches["schur_reduce"] or launches["schur_reduce_stereo"]:
        fail(f"block_capacity: kernel C launched {launches['schur_reduce_frozen']} times in its frozen mode "
             f"(want {want_launches}) and {launches['schur_reduce'] + launches['schur_reduce_stereo']} otherwise")
    return out


def check_schur_frozen(corridor, stereo_prob, stereo_cfg, dev, smi):
    """Kernel C's frozen-landmark mode against its plain version on the card:
    block 1 of ``block_corridor``'s problems (owned landmarks optimized,
    boundary ones frozen; the corridor carries no right-x, so every row is
    mono in the stereo variant the path runs) and the stereo engine's window
    (``check_schur``'s, uR rows) with a seeded half of its landmarks frozen
    (BLOCK_SEED). Each output within REL_TOL_C at LAM_C as ``check_schur``
    holds it, the frozen rows' g_l and Y exactly zero, two calls bitwise
    equal. Returns (max abs error, largest relative error, the ``entry``
    readings on the block problem: the shape ``block_capacity`` gives it)."""
    from dialog_tpu_torch.config import KITTI00
    from dialog_tpu_torch.kernels.schur import camera_index, schur_reduce, schur_reduce_plain
    from dialog_tpu_torch.optim.block_ba import block_problem, build_block_problems

    a = BLOCK_ARGS
    probs = build_block_problems(corridor[0], KITTI00, a["n_blocks"], a["cams_pb"], a["lms_pb"])[0]
    block = block_problem(probs, 1)
    rng = np.random.default_rng(BLOCK_SEED)
    frozen_half = torch.from_numpy(rng.random(stereo_prob.xyz.shape[0]) < 0.5).to(dev)
    cases = [("block", block, KITTI00, block.lm_opt), ("stereo_window", stereo_prob, stereo_cfg, ~frozen_half)]
    lam = torch.tensor(LAM_C, dtype=torch.float32, device=dev)
    max_abs, max_rel, out = 0.0, 0.0, {}
    for name, p, c, lm_opt in cases:
        args = (p.R, p.t, p.cam_opt, p.xyz, p.obs_cam, p.obs_uv, p.obs_w, lam, c.fx, c.fy, c.cx, c.cy, c.chi2_mono)
        kw = dict(_stereo_kw(p, c), lm_opt=lm_opt)
        got = schur_reduce(*args, **kw)
        again = schur_reduce(*args, **kw)
        want = schur_reduce_plain(*args, **kw)
        torch.cuda.synchronize()
        errs = {n: _rel_err(g, w, per_block=n == "Hll_inv")
                for n, g, w in zip(["Hll_inv", "g_l", "Y", "Hcc", "g_c", "g_red", "S_pair"], got, want)}
        zero = int(torch.count_nonzero(got[1][~lm_opt])) + int(torch.count_nonzero(got[2][~lm_opt]))
        repeat = all(torch.equal(x, y) for x, y in zip(got, again))
        live = p.lm_ids < c.max_landmarks
        n_ur = int((p.obs_ok & (p.obs_ur >= 0)).sum()) if p.obs_ur is not None else 0
        out[name] = dict(C=int(p.R.shape[0]), P=int(p.xyz.shape[0]), O=int(p.obs_cam.shape[1]),
                         observations=int(p.obs_ok.sum()), with_a_right_x=n_ur,
                         frozen_live_landmarks=int((live & ~lm_opt).sum()),
                         optimized_live_landmarks=int((live & lm_opt).sum()), rel_err=errs,
                         frozen_rows_nonzero=zero, bitwise_repeatable=repeat)
        # Hll^-1 of a landmark without a live slot, or frozen, is 1 / the damping alone (~1e9): its absolute
        # error says nothing, so the absolute error counts Hll^-1 on the optimized live landmarks only
        held = live & lm_opt
        max_abs = max(max_abs, float((got[0] - want[0])[held].abs().max()),
                      max(float((g - w).abs().max()) for g, w in zip(got[1:], want[1:])))
        max_rel = max(max_rel, max(errs.values()))
        say(f"kernel C schur_reduce_frozen on the {name} (lam={LAM_C}): {json.dumps(out[name])} on {smi}")
        if not (max(errs.values()) <= REL_TOL_C and zero == 0 and repeat):
            fail(f"kernel C frozen mode on the {name}: outputs {errs} beyond {REL_TOL_C}, {zero} non-zero frozen "
                 f"g_l / Y entries, or not repeatable ({repeat})")
    args = (block.R, block.t, block.cam_opt, block.xyz, block.obs_cam, block.obs_uv, block.obs_w,
            torch.tensor(1e-4, dtype=torch.float32, device=dev), KITTI00.fx, KITTI00.fy, KITTI00.cx, KITTI00.cy,
            KITTI00.chi2_mono)
    kw = dict(_stereo_kw(block, KITTI00), lm_opt=block.lm_opt)
    build_index = lambda: camera_index(block.obs_cam, block.obs_w, block.R.shape[0])  # noqa: E731
    idx = build_index()
    t = entry("schur_reduce_frozen", lambda: schur_reduce(*args, **kw, cam_index=idx),
              lambda: schur_reduce_plain(*args, **kw), schur_bound(args, kw, schur_reduce(*args, **kw, cam_index=idx)),
              cam_index_device_ms=device_ms(build_index, ())["other_device_ms"], solve_iters=BLOCK_ARGS["iters"],
              checks=out)
    t["solve_device_ms"] = t["cam_index_device_ms"] + t["solve_iters"] * t["device_ms"]
    return max_abs, max_rel, t


def check_block_sharded(dev, smi) -> dict:
    """Block BA over a process group on the card: two ranks
    (``python -m dialog_tpu_torch.gba_rank``, a block job, gloo) against
    this process's one-rank solve, on a corridor of ``tests/test_block_ba.py``'s
    size (64 keyframes of 40 landmarks, 4 observers, 0.6 m apart, K = 96,
    L = 4,096, F = 192, O = 6; ``build_corridor_map``) moved off its truth
    everywhere (``perturb_block_local`` with no untouched edge), 8 blocks,
    2 rounds of 4 iterations: the blocks are dealt out over the ranks and
    come back by one ``all_reduce`` of zero-filled tensors, so both ranks'
    maps must equal the one-rank map bit for bit."""
    from pathlib import Path

    from dialog_tpu_torch.config import EngineConfig
    from dialog_tpu_torch.containers import save_map
    from dialog_tpu_torch.gba_rank import config_to_json, free_address, launch
    from dialog_tpu_torch.kernels import common
    from dialog_tpu_torch.optim.block_ba import block_bundle_adjustment
    from dialog_tpu_torch.optim.synth_problem import build_corridor_map, perturb_block_local

    cfg = EngineConfig(max_features=192, max_keyframes=96, max_landmarks=4096, max_obs_per_lm=6)
    m = build_corridor_map(cfg, seed=1, n_kf=64, lm_per_kf=40, step=0.6, device=dev)
    m = perturb_block_local(m, 64, 40, 8, seed=1, edge=0)
    kw = dict(n_blocks=8, rounds=2, iters=4, cams_pb=24, lms_pb=512)
    out_dir = Path(__file__).resolve().parent / "build" / "block_sharded"
    out_dir.mkdir(parents=True, exist_ok=True)
    save_map(m, str(out_dir / "map.npz"))
    common.reset_launch_counts()
    one, one_s = _timed(lambda: block_bundle_adjustment(m, cfg, **kw))
    launches = dict(common.launches)
    job = {"kind": "block", "config": config_to_json(cfg), "map": str(out_dir / "map.npz"),
           "out": str(out_dir / "out.npz"), **kw}
    spec = {"address": free_address(), "world": 2, "backend": "gloo", "device": dev.type, "jobs": [job]}
    ranks, wall = _timed(lambda: launch(spec, str(out_dir / "job.json"), timeout=300,
                                        cwd=Path(__file__).resolve().parent))
    got = [r[0] for r in ranks]
    equal = [all(np.array_equal(g[k], x.cpu().numpy()) for k, x in (("R", one.kfs.R), ("t", one.kfs.t),
                                                                     ("xyz", one.lms.xyz)))
             for g in got]
    out = dict(world=2, backend="gloo", **kw, one_rank_s=one_s, ranks_wall_s=wall,
               rank_s=[float(g["seconds"]) for g in got], rank_world=[int(g["world"]) for g in got],
               rank_schur_launches=[int(g["schur_launches"]) for g in got], one_rank_launches=launches,
               ranks_bitwise_equal_to_one=equal)
    say("block_sharded: " + json.dumps(out) + f" on {smi} (one card: two-card scaling not measured)")
    if not (all(equal) and out["rank_world"] == [2, 2]):
        fail("block_sharded: the two ranks' maps differ from the one-rank block BA")
    if not (all(n > 0 for n in out["rank_schur_launches"]) and launches["schur_reduce_frozen"] > 0):
        fail("block_sharded: kernel C's frozen mode did not run on each rank")
    return out


def _first_difference(a, b):
    """Where two runs of one path part: the first record whose state,
    ``n_tracked``, R or t differs, and the map leaves that differ."""
    from dialog_tpu_torch.containers import _named_leaves

    rec = next((i for i, (x, y) in enumerate(zip(a.trajectory, b.trajectory))
                if x.state != y.state or x.n_tracked != y.n_tracked or not np.array_equal(x.R, y.R)
                or not np.array_equal(x.t, y.t)), None)
    if rec is None and len(a.trajectory) != len(b.trajectory):
        rec = min(len(a.trajectory), len(b.trajectory))
    leaves = [name for (x, name), (y, _) in zip(_named_leaves(a.m), _named_leaves(b.m)) if not torch.equal(x, y)]
    return rec, leaves


def check_determinism(first_runs: dict, dev, smi) -> dict:
    """``mono`` and ``loop`` once more, each on a fresh engine from the same
    seed: every record (state, ``n_tracked``, R, t) and every leaf of the map
    must equal the first run's bit for bit (``loop`` includes a loop closure
    and its global BA, whose segment sums are summed in a fixed order:
    ROADMAP D15). Prints where the runs part if they do."""
    out = {}
    for name, first in first_runs.items():
        again = run_path(name, dev)[2] if name == "mono" else run_loop_path(name, dev)["eng"]
        rec, leaves = _first_difference(first, again)
        out[name] = dict(records=len(first.trajectory), first_differing_record=rec, differing_map_leaves=leaves,
                         bitwise_equal=rec is None and not leaves, gba_runs=first.stats["gba_runs"])
    say("determinism: " + json.dumps(out) + f" on {smi}")
    bad = [n for n, r in out.items() if not r["bitwise_equal"]]
    if bad:
        fail(f"determinism: {bad} do not repeat bit for bit: {json.dumps({n: out[n] for n in bad})}")
    return out


def check_modes(run, dev, smi) -> dict:
    """The engine's other modes on the ``loop`` run's engine (its map after
    the closure and the global BA): the PLY export, the KITTI trajectory and
    the keyframe TUM trajectory written and parsed back (one vertex per live
    landmark and keyframe, one 3x4 row per record, one 8-field line per live
    keyframe in insertion order); a checkpoint saved, loaded into a fresh
    engine (LOST at its newest keyframe), MODES_FRAMES frames of the orbit
    tracked on it (it must relocalize and end OK); then localization mode
    on that engine for MODES_FRAMES more (no new keyframe, no new
    landmark); then ``reset`` (NOT_INITIALIZED, an empty map)."""
    from pathlib import Path

    from dialog_tpu_torch.datasets import synth
    from dialog_tpu_torch.system import LOST, NOT_INITIALIZED, OK, Engine

    eng, scene = run["eng"], run["scene"]
    d = Path(__file__).resolve().parent / "build" / "modes"
    d.mkdir(parents=True, exist_ok=True)
    n_lm, n_kf = int(eng.m.lms.valid.sum()), int(eng.m.kfs.valid.sum())
    eng.export_map_ply(str(d / "map.ply"))
    eng.save_trajectory_kitti(str(d / "kitti.txt"))
    eng.save_keyframe_trajectory_tum(str(d / "kf_tum.txt"))
    ply = (d / "map.ply").read_text().splitlines()
    n_vert = int([ln for ln in ply if ln.startswith("element vertex")][0].split()[-1])
    body = [ln.split() for ln in ply[ply.index("end_header") + 1 :]]
    kitti = [np.array(ln.split(), float) for ln in (d / "kitti.txt").read_text().splitlines()]
    kf = [ln.split() for ln in (d / "kf_tum.txt").read_text().splitlines() if ln]
    ts = [float(x[0]) for x in kf]
    writers_ok = (n_vert == n_lm + n_kf == len(body) and all(len(x) == 6 for x in body)
                  and len(kitti) == len(eng.trajectory) and all(r.shape == (12,) for r in kitti)
                  and len(kf) == n_kf and all(len(x) == 8 for x in kf) and all(b > a for a, b in zip(ts, ts[1:])))

    def frames(lo, hi):
        for i in range(lo, hi):
            yield synth.observe(scene, i, noise_px=LOOP_NOISE_PX, desc_flips=LOOP_DESC_FLIPS, device=dev)[0], i

    eng.save_checkpoint(str(d / "map.npz"))
    res = Engine(eng.cfg, device=dev)
    res.load_checkpoint(str(d / "map.npz"))
    # as the reference's, a resume counts the map's high-water keyframe slot (num_kfs), not its insertions
    loaded_lost = res.state == LOST and res.kf_count == int(eng.m.num_kfs)
    lo = LOOP_FRAMES - 2 * MODES_FRAMES
    for fr, i in frames(lo, lo + MODES_FRAMES):
        res.track_features(fr, float(i) / 30.0)
    resumed = [r.state for r in res.trajectory]
    n_kf_res, n_lm_res = res.kf_count, int(res.m.lms.valid.sum())
    res.set_localization_mode(True)
    for fr, i in frames(lo + MODES_FRAMES, lo + 2 * MODES_FRAMES):
        res.track_features(fr, float(i) / 30.0)
    localized = [r.state for r in res.trajectory[MODES_FRAMES:]]
    frozen = res.kf_count == n_kf_res and int(res.m.lms.valid.sum()) == n_lm_res
    res.reset()
    was_reset = res.state == NOT_INITIALIZED and int(res.m.kfs.valid.sum()) == 0 and int(res.m.lms.valid.sum()) == 0
    out = dict(landmarks=n_lm, keyframes=n_kf, ply_vertices=n_vert, kitti_rows=len(kitti), kf_tum_lines=len(kf),
               writers_parse_back=writers_ok, loaded_lost=loaded_lost, resumed_states=resumed,
               resumed_ok_at_end=resumed[-1] == OK, localization_states=localized,
               localization_map_frozen=frozen, reset=was_reset)
    say("modes: " + json.dumps(out) + f" on {smi}")
    if not (writers_ok and loaded_lost and resumed[-1] == OK and frozen and localized[-1] == OK and was_reset):
        fail("modes: a writer did not parse back, the resume did not relocalize, localization mode grew the map, "
             "or reset left a map")
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
# the kernels' self-check and the CLI over sequences on disk
# ---------------------------------------------------------------------------


def check_selfcheck(smi) -> dict:
    """``kernels.selfcheck`` on the card: every case must pass."""
    from dialog_tpu_torch.kernels import selfcheck

    t0 = time.perf_counter()
    res = selfcheck.run()
    out = {name: {"ok": ok, **({"max_diff": d} if d else {})} for name, (ok, d) in res.items()}
    say(f"selfcheck ({time.perf_counter() - t0:.1f} s): " + json.dumps(out) + f" on {smi}")
    bad = [name for name, (ok, _) in res.items() if not ok]
    if bad:
        fail(f"selfcheck: {bad} differ from their plain versions")
    return out


def _u8(img) -> np.ndarray:
    return np.clip(img, 0, 255).astype(np.uint8)


def _rgb(img) -> np.ndarray:
    """An 8-bit frame as an RGB file's pixels, equal channels: its gray reading is the frame."""
    g = _u8(img)
    return np.stack([g, g, g], -1)


def write_tum(root, scene, frames, fps, depths=None) -> dict:
    """A TUM sequence: rgb/ (RGB, equal channels), rgb.txt, groundtruth.txt,
    and with ``depths`` depth/ (16-bit, TUM's units) stamped DEPTH_LAG late
    and depth.txt. Returns the frames as written, by file."""
    from dialog_tpu_torch.datasets.png import write_png

    (root / "rgb").mkdir(parents=True)
    rgb, dep, gt, written = [], [], [], {}
    for i, img in enumerate(frames):
        ts = 1305031102.175304 + i / fps
        write_png(str(root / "rgb" / f"{ts:.6f}.png"), _rgb(img))
        written[str(root / "rgb" / f"{ts:.6f}.png")] = _u8(img)
        rgb.append(f"{ts:.6f} rgb/{ts:.6f}.png")
        if depths is not None:
            (root / "depth").mkdir(exist_ok=True)
            d16 = np.clip(depths[i], 0, 65535).astype(np.uint16)
            write_png(str(root / "depth" / f"{ts + DEPTH_LAG:.6f}.png"), d16)
            written[str(root / "depth" / f"{ts + DEPTH_LAG:.6f}.png")] = d16
            dep.append(f"{ts + DEPTH_LAG:.6f} depth/{ts + DEPTH_LAG:.6f}.png")
        C = -scene.R[i].T @ scene.t[i]
        gt.append(f"{ts:.6f} {C[0]:.6f} {C[1]:.6f} {C[2]:.6f} 0 0 0 1")
    (root / "rgb.txt").write_text("# color images\n# timestamp filename\n" + "\n".join(rgb) + "\n")
    (root / "groundtruth.txt").write_text("# ground truth\n" + "\n".join(gt) + "\n")
    if depths is not None:
        (root / "depth.txt").write_text("# depth images\n" + "\n".join(dep) + "\n")
    return written


def write_kitti(root, scene, pairs, fps) -> dict:
    """A KITTI odometry sequence: image_0/, image_1/, times.txt, and the
    devkit poses (T_wc, 3x4 a line) beside it as ``<root>.txt``."""
    from dialog_tpu_torch.datasets.png import write_png

    written, rows = {}, []
    for cam in ("image_0", "image_1"):
        (root / cam).mkdir(parents=True)
    for i, pair in enumerate(pairs):
        for cam, img in zip(("image_0", "image_1"), pair):
            write_png(str(root / cam / f"{i:06d}.png"), _u8(img))
            written[str(root / cam / f"{i:06d}.png")] = _u8(img)
        P = np.hstack([scene.R[i].T, (-scene.R[i].T @ scene.t[i])[:, None]])
        rows.append(" ".join(f"{x:.9e}" for x in P.reshape(-1)))
    (root / "times.txt").write_text("\n".join(f"{i / fps:.6e}" for i in range(len(pairs))) + "\n")
    root.with_suffix(".txt").write_text("\n".join(rows) + "\n")
    return written


def write_euroc(root, scene, pairs, fps) -> dict:
    """A EuRoC MAV sequence: mav0/cam0 and cam1 (data.csv, data/<ns>.png) and
    mav0/state_groundtruth_estimate0/data.csv."""
    from dialog_tpu_torch.datasets.png import write_png

    written, gt = {}, []
    for c, cam in enumerate(("cam0", "cam1")):
        (root / "mav0" / cam / "data").mkdir(parents=True)
        lines = ["#timestamp [ns],filename"]
        for i, pair in enumerate(pairs):
            ns = 1403636579763555584 + int(i * 1e9 / fps)
            write_png(str(root / "mav0" / cam / "data" / f"{ns}.png"), _u8(pair[c]))
            written[str(root / "mav0" / cam / "data" / f"{ns}.png")] = _u8(pair[c])
            lines.append(f"{ns},{ns}.png")
            if c == 0:
                gt.append(",".join(str(x) for x in (ns, *(-scene.R[i].T @ scene.t[i]))))
        (root / "mav0" / cam / "data.csv").write_text("\n".join(lines) + "\n")
    (root / "mav0" / "state_groundtruth_estimate0").mkdir(parents=True)
    (root / "mav0" / "state_groundtruth_estimate0" / "data.csv").write_text(
        "#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m]\n" + "\n".join(gt) + "\n")
    return written


def _settings_yaml(path, cfg) -> str:
    """A reference-format settings file for ``cfg``'s camera (no distortion)."""
    path.write_text(
        f"Camera.fx: {cfg.fx}\nCamera.fy: {cfg.fy}\nCamera.cx: {cfg.cx}\nCamera.cy: {cfg.cy}\n"
        "Camera.k1: 0.0\nCamera.k2: 0.0\nCamera.p1: 0.0\nCamera.p2: 0.0\n"
        f"Camera.width: {cfg.width}\nCamera.height: {cfg.height}\nCamera.fps: {cfg.fps}\nCamera.bf: {cfg.bf}\n"
        f"ThDepth: {cfg.th_depth}\nDepthMapFactor: {cfg.depth_map_factor}\n"
        f"ORBextractor.nFeatures: {cfg.n_features}\n")
    return str(path)


def euroc_sequence():
    """The stereo sweep (``make_scene(seed=7, n_points=6000)``) scaled by
    EUROC_SCALE into the EuRoC cameras (752x480, their 0.10 m baseline, no
    distortion), and its first CLI_EUROC_FRAMES (left, right) pairs."""
    from dialog_tpu_torch.cli import EUROC_DEFAULT
    from dialog_tpu_torch.config import Sensor
    from dialog_tpu_torch.datasets import synth

    cfg = EUROC_DEFAULT.replace(k1=0.0, k2=0.0, p1=0.0, p2=0.0, sensor=Sensor.STEREO)
    scene = synth.make_scene(seed=7, n_points=6000, n_frames=168, cfg=cfg)
    scene = scene._replace(xyz=scene.xyz * np.float32(EUROC_SCALE), t=scene.t * np.float32(EUROC_SCALE))
    right = scene._replace(t=scene.t - np.array([cfg.baseline, 0.0, 0.0], np.float32))
    return cfg, scene, [(synth.render_image(scene, i), synth.render_image(right, i)) for i in range(CLI_EUROC_FRAMES)]


def paeth_stream(rows, bpp: int):
    """Rows uint8 [H, n] as a PNG image stream [H, 1 + n] whose every row has
    filter type 4 (Paeth), the case that unfilters byte by byte."""
    x = rows.astype(np.int16)
    left, up, ul = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)
    left[:, bpp:], up[1:], ul[1:, bpp:] = x[:, :-bpp], x[:-1], x[:-1, :-bpp]
    p = left + up - ul
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
    pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
    return np.concatenate([np.full((len(x), 1), 4, np.uint8), ((x - pred) & 0xFF).astype(np.uint8)], 1)


def _twin(cfg, dev, log_path, method, items):
    """The engine the CLI builds, driven in this process on ``png`` readings
    of the same files, with a RunLogger attached: ``items`` yields (ts,
    arrays) per frame. Returns the engine and its log's frame rows."""
    from dialog_tpu_torch.frontend import extract_features
    from dialog_tpu_torch.instrument import RunLogger
    from dialog_tpu_torch.system import Engine

    eng = Engine(cfg, device=dev)
    eng.logger = RunLogger(log_path)
    for ts, arrays in items:
        t0 = time.perf_counter()
        if method == "async":
            img = torch.as_tensor(arrays[0], dtype=torch.float32).to(dev)
            eng.track_features_async(eng._undistort(extract_features(img, cfg)), ts)
        else:
            rec = getattr(eng, method)(*arrays, ts)
            eng.logger.log_frame(rec, time.perf_counter() - t0)
    eng.flush()
    if method == "async":   # records resolve a few frames behind: logged once all are in
        for rec in eng.trajectory:
            eng.logger.log_frame(rec, 0.0)
    eng.logger.close()
    rows = [json.loads(line) for line in open(log_path)]
    return eng, [r for r in rows if "frame" in r]


def _run_cli(argv):
    """``cli.main(argv)`` in this process, launch counts reset just before and
    read just after; returns (the engine it built, its output, launches)."""
    import contextlib
    import io

    from dialog_tpu_torch import cli, system
    from dialog_tpu_torch.kernels import common

    made, Engine = [], system.Engine

    class Recorded(Engine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    buf = io.StringIO()
    system.Engine = Recorded
    try:
        torch.cuda.synchronize()
        common.reset_launch_counts()
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
        torch.cuda.synchronize()
        launches = dict(common.launches)
    finally:
        system.Engine = Engine
    text = buf.getvalue()
    for line in text.splitlines():
        say(f"  cli: {line}")
    if len(made) != 1:
        fail(f"cli {argv[0]}: built {len(made)} engines, 1 expected")
    return made[0], text, launches


def _parse_trajectory(path, fmt) -> np.ndarray:
    """Camera centres [N, 3] from a TUM (8 fields) or KITTI (12 fields) file."""
    rows = np.array([[float(x) for x in line.split()] for line in open(path) if line.strip()])
    if rows.shape[1] != {"tum": 8, "kitti": 12}[fmt]:
        fail(f"{path}: {rows.shape[1]} fields a line in a {fmt} trajectory")
    return rows[:, 1:4] if fmt == "tum" else rows[:, [3, 7, 11]]


def cli_phase(seqs: dict, dev, smi) -> dict:
    """The CLI's ``run-*`` subcommands over sequences written to disk, each
    held against the engine driven in this process on the same files.

    ``seqs``: the scenes and frames of the mono, RGB-D and stereo paths (the
    first CLI_TUM_FRAMES, CLI_RGBD_FRAMES and CLI_KITTI_FRAMES of them). For
    each run, gates: (a) the CLI's engine equals its in-process twin (every
    record and every map leaf, bit for bit; the twin's RunLogger JSONL has a
    row per frame); (b) the files decode to the uint8 frames written; (c)
    the path's gates (``check_path``) on the run, with kernel A once per
    image; (d) the trajectory file parses back to the engine's camera
    centres, and the render is a PNG of the renderer's canvas. Prints the
    CLI's own track times, one decode per image size (the whole read, and
    the row unfilter native against plain) and the share of the loop's wall
    time spent waiting for decoded frames."""
    import os
    import tempfile
    from pathlib import Path

    from dialog_tpu_torch.cli import KITTI_DEFAULT, SYNTH_CONFIG, settings
    from dialog_tpu_torch.config import Sensor
    from dialog_tpu_torch.datasets import euroc, kitti, png, synth, tum
    from dialog_tpu_torch.eval.render import SIZE

    out = {}
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent / "build") as tmp:
        root = Path(tmp)
        ecfg, escene, epairs = euroc_sequence()
        written = {}
        mono, rgbd = seqs["mono"][1][:CLI_TUM_FRAMES], seqs["rgbd"][1][:CLI_RGBD_FRAMES]
        stereo = seqs["stereo"][1][:CLI_KITTI_FRAMES]
        written.update(write_tum(root / "tum", seqs["mono"][0], mono, 30.0))
        rcfg = seqs["rgbd"][2]
        written.update(write_tum(root / "tum_rgbd", seqs["rgbd"][0], [x[0] for x in rgbd], 30.0, [x[1] for x in rgbd]))
        written.update(write_kitti(root / "kitti" / "00", seqs["stereo"][0], stereo, 10.0))
        written.update(write_euroc(root / "euroc", escene, epairs, 20.0))
        rgbd_yaml = _settings_yaml(root / "TUM1.yaml", rcfg)
        euroc_yaml = _settings_yaml(root / "EuRoC.yaml", ecfg)
        bad = [p for p, want in written.items() if not np.array_equal(
            png.read_unchanged(p) if want.dtype == np.uint16 else png.read_gray(p), want)]
        say(f"cli: {len(written)} files written; {len(written) - len(bad)} decode to the frames written")
        if bad:
            fail(f"cli: {len(bad)} files decode to other pixels than were written, e.g. {bad[:3]}")

        # decode times (medians): the whole read, and the row unfilter on the inflated stream, native against the
        # plain numpy one, on the file's own stream (filter 0, as write_png writes) and on its rows Paeth-filtered
        def median_ms(fn, reps):
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                ts.append(time.perf_counter() - t0)
            return float(np.median(ts) * 1e3)

        rgb640 = next(p for p in written if "/tum/rgb/" in p)
        gray1241 = next(p for p in written if "/image_0/" in p)
        out["decode_ms"] = {}
        for name, p in (("rgb_640x480", rgb640), ("gray_1241x376", gray1241)):
            raw, bpp = png.inflate(p)[:2]
            paeth = paeth_stream(png.unfilter(raw, bpp), bpp)
            rows = png.unfilter(raw, bpp)
            for got in (png.unfilter(paeth, bpp), png.unfilter_plain(paeth, bpp), png.unfilter_plain(raw, bpp)):
                if not np.array_equal(got, rows):
                    fail(f"cli: the unfilters of {p} disagree")
            out["decode_ms"][name] = {
                "read_gray": median_ms(lambda: png.read_gray(p), 9),
                "unfilter": median_ms(lambda: png.unfilter(raw, bpp), 9),
                "unfilter_plain": median_ms(lambda: png.unfilter_plain(raw, bpp), 3),
                "paeth_unfilter": median_ms(lambda: png.unfilter(paeth, bpp), 9),
                "paeth_unfilter_plain": median_ms(lambda: png.unfilter_plain(paeth, bpp), 1)}
        say(f"cli: decode ms per image {json.dumps(out['decode_ms'])} on {smi}")

        def tum_items(seq, rgbd=False):
            if rgbd:
                return [(ts, (png.read_gray(os.path.join(seq, r)).astype(np.float32),
                              png.read_unchanged(os.path.join(seq, d)).astype(np.float32)))
                        for ts, r, d in tum.associate(tum._read_list(os.path.join(seq, "rgb.txt")),
                                                      tum._read_list(os.path.join(seq, "depth.txt")))]
            return [(ts, (png.read_gray(os.path.join(seq, r)).astype(np.float32),))
                    for ts, r in tum._read_list(os.path.join(seq, "rgb.txt"))]

        kseq, eseq = str(root / "kitti" / "00"), str(root / "euroc")
        kitti_items = [(ts, (png.read_gray(os.path.join(kseq, "image_0", f"{i:06d}.png")).astype(np.float32),
                             png.read_gray(os.path.join(kseq, "image_1", f"{i:06d}.png")).astype(np.float32)))
                       for i, ts in enumerate(kitti.read_times(kseq))]
        e0, e1 = (os.path.join(eseq, "mav0", c) for c in ("cam0", "cam1"))
        euroc_items = [(ts, (png.read_gray(os.path.join(e0, "data", n)).astype(np.float32),
                             png.read_gray(os.path.join(e1, "data", n)).astype(np.float32)))
                       for ts, n in euroc._read_csv(e0)]
        mono_scene, rgbd_scene, stereo_scene = seqs["mono"][0], seqs["rgbd"][0], seqs["stereo"][0]
        n_mono, n_rgbd, n_st, n_eu = len(mono), len(rgbd), len(stereo), len(epairs)
        render = str(root / "map.png")
        traj = str(root / "traj.txt")
        mono_gates = dict(with_scale=True, ate_gate=ATE_GATE, min_kfs=4)
        mono_k = {"fast_nms_rank": n_mono, "hamming_mutual": 1, "schur_reduce": 1}
        # name -> (argv, twin's config, twin's entry, twin's frames, scene, trajectory format, gates, launches)
        runs = {
            "cli_tum": (["run-tum", str(root / "tum"), "--render", render],
                        settings(None, Sensor.MONOCULAR), "track_image", tum_items(str(root / "tum")), mono_scene,
                        "tum", mono_gates, mono_k, {"fast_nms_rank": n_mono}),
            "cli_pipelined": (["run-tum", str(root / "tum"), "--pipelined"], settings(None, Sensor.MONOCULAR),
                              "async", tum_items(str(root / "tum")), mono_scene, "tum", mono_gates, mono_k,
                              {"fast_nms_rank": n_mono}),
            "cli_rgbd": (["run-tum", str(root / "tum_rgbd"), "--rgbd", "--settings", rgbd_yaml],
                         settings(rgbd_yaml, Sensor.RGBD), "track_rgbd", tum_items(str(root / "tum_rgbd"), True),
                         rgbd_scene, "tum", dict(with_scale=False, ate_gate=RGBD_ATE_GATE, min_kfs=3),
                         {"fast_nms_rank": n_rgbd, "hamming_mutual": 1, "schur_reduce_stereo": 1},
                         {"fast_nms_rank": n_rgbd}),
            "cli_kitti": (["run-kitti", kseq, "--gt", str(root / "kitti" / "00.txt")],
                          settings(None, Sensor.STEREO, KITTI_DEFAULT), "track_stereo", kitti_items, stereo_scene,
                          "kitti", dict(with_scale=False, ate_gate=STEREO_ATE_GATE, min_kfs=4),
                          {"fast_nms_rank": 2 * n_st, "hamming_mutual": 1, "schur_reduce_stereo": 1},
                          {"fast_nms_rank": 2 * n_st, "schur_reduce": 0}),
            "cli_euroc": (["run-euroc", eseq, "--settings", euroc_yaml], settings(euroc_yaml, Sensor.STEREO),
                          "track_stereo", euroc_items, escene, "tum",
                          dict(with_scale=False, ate_gate=STEREO_ATE_GATE, min_kfs=3),
                          {"fast_nms_rank": 2 * n_eu, "hamming_mutual": 1, "schur_reduce_stereo": 1},
                          {"fast_nms_rank": 2 * n_eu, "schur_reduce": 0}),
        }
        for name, (argv, cfg, method, items, scene, fmt, gates, min_k, max_k) in runs.items():
            t0 = time.perf_counter()
            eng, text, launches = _run_cli(argv + ["--out", traj, "--device", "cuda"])
            wall = time.perf_counter() - t0
            twin, rows = _twin(cfg, dev, str(root / f"{name}.jsonl"), method, items)
            out[name] = _cli_gates(name, eng, twin, rows, text, launches, wall, traj, fmt, smi)
            out[name]["path"] = check_path(name, twin, scene, launches, min_launches=min_k, max_launches=max_k,
                                           **gates)
            if name == "cli_tum":
                img = png.read_unchanged(render)
                if img.shape != (SIZE[1], SIZE[0], 3) or img.dtype != np.uint8:
                    fail(f"cli_tum: the render is {img.dtype} {img.shape}, not an RGB PNG of {SIZE}")

        # run-synth over the orbit: no files, the twin observes the same scene
        argv = ["run-synth", "--trajectory", "loop", "--frames", str(CLI_SYNTH_FRAMES)]
        t0 = time.perf_counter()
        eng, text, launches = _run_cli(argv + ["--out", traj, "--device", "cuda"])
        wall = time.perf_counter() - t0
        scene = synth.make_scene(seed=0, n_points=1500, n_frames=CLI_SYNTH_FRAMES, trajectory="loop",
                                 cfg=SYNTH_CONFIG)
        items = [(float(i) / 30.0, (synth.observe(scene, i, noise_px=0.5, device=dev)[0],))
                 for i in range(CLI_SYNTH_FRAMES)]
        twin, rows = _twin(SYNTH_CONFIG, dev, str(root / "cli_synth.jsonl"), "track_features", items)
        out["cli_synth"] = _cli_gates("cli_synth", eng, twin, rows, text, launches, wall, traj, "tum", smi)
        out["cli_synth"]["path"] = check_path(
            "cli_synth", twin, scene, launches, with_scale=True, ate_gate=CLI_SYNTH_ATE_SPAN * _span(scene),
            min_kfs=4, min_launches={"hamming_mutual": 1, "schur_reduce": 1}, max_launches={"fast_nms_rank": 0})
    return out


def _span(scene) -> float:
    C = np.stack([-R.T @ t for R, t in zip(scene.R, scene.t)])
    return float(np.linalg.norm(C.max(0) - C.min(0)))


def _cli_gates(name, eng, twin, rows, text, launches, wall, traj, fmt, smi) -> dict:
    """Gates (a) and (d) of ``cli_phase`` on one run, and its printed numbers."""
    import re

    rec, leaves = _first_difference(eng, twin)
    if rec is not None or leaves:
        fail(f"{name}: the CLI's engine parts from its in-process twin at record {rec}, map leaves {leaves}")
    if len(rows) != len(twin.trajectory) or [r["frame"] for r in rows] != [r.frame_id for r in twin.trajectory]:
        fail(f"{name}: the twin's RunLogger holds {len(rows)} frame rows for {len(twin.trajectory)} records")
    centres = _parse_trajectory(traj, fmt)
    if centres.shape != eng.positions.shape or not np.allclose(centres, eng.positions, atol=1e-5, rtol=1e-6):
        fail(f"{name}: the trajectory file does not parse back to the engine's camera centres")
    m = re.search(r"median track time: ([\d.]+) ms \| mean: ([\d.]+) ms \| fps: ([\d.]+)", text)
    w = re.search(r"input wait: ([\d.]+) s of ([\d.]+) s", text)
    res = {"frames": len(eng.trajectory), "ok": sum(r.state == "OK" for r in eng.trajectory),
           "kf_count": eng.kf_count, "median_track_ms": float(m.group(1)), "mean_track_ms": float(m.group(2)),
           "fps": float(m.group(3)), "cli_wall_s": wall, "launches": launches}
    if w:
        res["input_wait_s"], res["loop_wall_s"] = float(w.group(1)), float(w.group(2))
        res["input_wait_share"] = res["input_wait_s"] / max(res["loop_wall_s"], 1e-9)
    say(f"{name}: equal to its in-process twin bit for bit ({len(rows)} logged frames); " + json.dumps(
        {k: v for k, v in res.items() if k != "launches"}) + f" on {smi}")
    return res


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
    its sum (216). With ``lm_opt`` in ``kw``, a frozen landmark's observations
    need none of the point terms: the transform, projection, weight and pose
    Jacobians (60 + 25 D), and Hcc and g_c where the camera is optimized."""
    from dialog_tpu_torch.kernels.schur import observation_terms

    R, t, cam_opt, xyz, obs_cam, obs_uv, obs_w = args[:7]
    C = R.shape[0]
    valid = (obs_w > 0.0) & (obs_cam >= 0) & (obs_cam < C)
    ok = observation_terms(R, t, xyz, obs_cam, obs_uv, valid, *args[8:12])[3]
    rows = torch.where(kw["obs_ur"] >= 0.0, 3, 2) if kw.get("obs_ur") is not None else torch.full_like(obs_cam, 2)
    opt = ok & cam_opt[torch.clamp(obs_cam, 0, C - 1).long()]
    free = kw["lm_opt"][:, None] if kw.get("lm_opt") is not None else torch.ones_like(ok)
    ops = int((ok * (60 + 25 * rows + free * (9 + 18 * rows))).sum()) \
        + int((opt * (27 + 54 * rows + free * (102 + 36 * rows))).sum()) + 75 * xyz.shape[0] \
        + 216 * int(((opt & free).sum(1) ** 2).sum())
    ins = list(args[:8]) + [kw[k] for k in ("obs_ur", "lm_opt") if kw.get(k) is not None]
    return dict(bound(nbytes(*ins, *out), ops), live_observations=int(ok.sum()), optimized_observations=int(opt.sum()))


def bench_phase(smi) -> dict:
    """``python3 -m dialog_tpu_torch.cli bench`` in a child process, as users
    run it: its output streamed into this log, then held to its gates
    (``check_bench``). Returns the three workloads' frames/s, their ``#``
    lines, their launches by path and the child's wall seconds."""
    cmd = [sys.executable, "-m", "dialog_tpu_torch.cli", "bench"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            say(f"  bench: {lines[-1]}")
        rc = proc.wait(timeout=BENCH_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"bench: {' '.join(cmd[1:])} exited with {rc}")
    out = check_bench(lines)
    out["wall_s"] = wall
    say("bench: " + ", ".join(f"{n} {out['fps'][n]} frames/s ({out['vs_baseline'][n]} x the baseline)"
                              for n in BENCH_WORKLOADS) + f"; the child's wall {wall:.1f} s; on {smi}")
    return out


def bench_reloc_margin(dev, smi, seed: int | None = None, warm_end: int = BENCH_WARM_END) -> dict:
    """The room the bench's primary workload has at its relocalization after
    the blanked frames, on the card (ROADMAP D22). ``tum_mono_kf10``'s warm-up
    (``bench.schedule`` to frame BENCH_WARM_END, no timed window) on a fresh
    engine, the bench's scene, images and configuration, with the three steps
    of every relocalization attempt recorded on the port's modules: per
    candidate keyframe the descriptor matches against RELOC_MIN_MATCHES, the
    PnP RANSAC inliers against PNP_MIN_INLIERS with the engine's own draw and
    with the next RELOC_REDRAWS draws of a copy of its generator (the engine's
    own stream is left as it was), and the refined inliers against
    ``reloc_min_inliers``. Printed on one line, not gated. ``seed`` reseeds
    the engine's generator (``tools/reloc_draw_sweep.py``); ``warm_end`` cuts
    the warm-up (the relocalization at frame 52 is the same from 56 on)."""
    from dialog_tpu_torch import bench, pnp, system, tracking
    from dialog_tpu_torch.containers import FrameArrays
    from dialog_tpu_torch.datasets import synth
    from dialog_tpu_torch.frontend import extract_features_batch
    from dialog_tpu_torch.profile_main_path import tum_mono_config

    cfg = tum_mono_config()
    scene = synth.make_scene(seed=3, n_points=2500, n_frames=bench.MONO_FRAMES, cfg=cfg)
    images = [torch.from_numpy(synth.render_image(scene, i)).to(dev) for i in range(warm_end + 2 * BATCH)]
    eng = system.Engine(cfg, device=dev)
    eng.kf_interval = KF_INTERVAL
    if seed is not None:
        eng._gen.manual_seed(seed)
    attempts = []
    orig = (tracking.match_reference_kf, pnp.solve_pnp_ransac, system.pose_optimization)

    def match(m, cand, frame, cfg_):
        out = orig[0](m, cand, frame, cfg_)
        attempts[-1]["candidates"].append({"kf": int(cand), "matches": [int(out[1]), RELOC_MIN_MATCHES]})
        return out

    def solve(*a, **kw):
        out = orig[1](*a, **kw)
        gen = torch.Generator(device=eng._gen.device)
        gen.set_state(eng._gen.get_state())
        others = [int(orig[1](*a[:7], pnp.draw_pnp_sets(a[2], cfg.pnp_ransac_iters, gen), **kw).n_inliers)
                  for _ in range(RELOC_REDRAWS)]
        attempts[-1]["candidates"][-1].update(pnp_inliers=[int(out.n_inliers), PNP_MIN_INLIERS],
                                              pnp_inliers_other_draws=others)
        return out

    def pose(*a, **kw):
        out = orig[2](*a, **kw)
        attempts[-1]["candidates"][-1]["refined_inliers"] = [int(out.n_inliers), cfg.reloc_min_inliers]
        return out

    inner = eng._try_relocalize

    def reloc(frame, ts):
        attempts.append({"frame": round(ts * bench.MONO_FPS), "candidates": []})
        tracking.match_reference_kf, pnp.solve_pnp_ransac, system.pose_optimization = match, solve, pose
        try:
            rec = inner(frame, ts)
        finally:
            tracking.match_reference_kf, pnp.solve_pnp_ransac, system.pose_optimization = orig
        attempts[-1]["relocalized"] = rec is not None
        return rec

    eng._try_relocalize = reloc

    def extract(i, n):
        return extract_features_batch(torch.stack(images[i : i + n]), cfg)

    t0 = time.perf_counter()
    bench.schedule(eng, warm_end, bench.MONO_FPS, lambda i: eng.track_image(images[i], i / bench.MONO_FPS),
                   extract, lambda i: eng.track_features(FrameArrays(*[x[0] for x in extract(i, 1)]),
                                                         i / bench.MONO_FPS),
                   n_single=bench.MONO_SINGLE, warm_end=warm_end, occlude_at=BENCH_OCCLUDE_AT)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    tried = [a for a in attempts if a["candidates"]]
    hit = next((a for a in attempts if a["relocalized"]), tried[-1] if tried else None)
    frames = [(round(r.timestamp * bench.MONO_FPS), r.state) for r in eng.trajectory]
    first_ok = next((f for f, st in frames if st == "OK"), None)
    blanked_end = BENCH_OCCLUDE_AT + BATCH // 2
    recovered = next((f for f, st in frames if f >= blanked_end and st == "OK"), None)
    out = {"workload": "tum_mono_kf10", "seed": cfg.n_features if seed is None else seed, "initialized_at": first_ok,
           "frame": None if hit is None else hit["frame"],
           "relocalized": bool(hit and hit["relocalized"]), "candidates": [] if hit is None else hit["candidates"],
           "attempts": len(attempts), "relocalizations": sum(a["relocalized"] for a in attempts),
           "ok_again_at": recovered, "lost_after_it": sum(1 for f, st in frames if recovered is not None and
                                                          f > recovered and st != "OK"), "state": eng.state,
           "warm_up_s": time.perf_counter() - t0}
    say("bench relocalization margin (tum_mono_kf10, the relocalization after the blanked frames; not a gate): "
        + json.dumps(out) + f" on {smi}")
    return out


def check_bench(lines) -> dict:
    """The bench's output held to bench.py's contract and each workload's
    ``#`` line to the bench gates (module docstring)."""
    from dialog_tpu_torch.bench import B as bench_batch

    metrics = [json.loads(x) for x in lines if x.startswith("{")]
    notes = {}
    for x in lines:
        if x.startswith("# "):
            name, _, body = x[2:].partition(": ")
            notes[name] = json.loads(body)
    names = list(BENCH_WORKLOADS)
    want = [m for n in names for m in (f"tracking_fps_{n}", "tracking_fps_tum_class_mono")]
    if [m.get("metric") for m in metrics] != want:
        fail(f"bench: metric lines {[m.get('metric') for m in metrics]}, not {want}")
    for k, n in enumerate(names):
        line, primary = metrics[2 * k], metrics[2 * k + 1]
        base = BENCH_WORKLOADS[n][1]
        if set(line) != {"metric", "value", "unit", "vs_baseline"} or line["unit"] != "frames/s":
            fail(f"bench: {n}'s line {line} does not have bench.py's keys")
        v = line["value"]
        if not (isinstance(v, float) and np.isfinite(v) and v > 0):
            fail(f"bench: {n} reads {v} frames/s")
        # value and vs_baseline are each rounded from the same frames/s (to 0.01 and 0.001)
        if not abs(line["vs_baseline"] - v / base) <= 0.0005 + 0.005 / base + 1e-9:
            fail(f"bench: {n}'s vs_baseline {line['vs_baseline']} is not {v} / {base} as rounded")
        want_primary = {"metric": "tracking_fps_tum_class_mono", "value": metrics[0]["value"], "unit": "frames/s",
                        "vs_baseline": metrics[0]["vs_baseline"],
                        "workloads": {names[j]: metrics[2 * j]["value"] for j in range(k + 1)}}
        if primary != want_primary:
            fail(f"bench: the primary line after {n} reads {primary}, not {want_primary}")
    for n, (path, base, c_kernel) in BENCH_WORKLOADS.items():
        if n not in notes:
            fail(f"bench: no '#' line for {n}")
        s, launches = notes[n], notes[n]["launches"]
        ref = BENCH_REFERENCE_ATE[n]
        if s["state"] != "OK":
            fail(f"bench {n}: state at the end is {s['state']}")
        if not s["ok_share"] > BENCH_OK_SHARE:
            fail(f"bench {n}: OK share {s['ok_share']} <= {BENCH_OK_SHARE} outside the blanked frames")
        if s["keyframes"] < 4:
            fail(f"bench {n}: {s['keyframes']} keyframes")
        recovered = s["relocalizations"] if c_kernel == "schur_reduce" else s["recovered"]
        if recovered < 1:
            fail(f"bench {n}: no {'relocalization' if c_kernel == 'schur_reduce' else 'recovery'} after the "
                 f"blanked frames {s['blanked']}")
        if launches["fast_nms_rank_batch"] != s["frontend_batches"]:
            fail(f"bench {n}: fast_nms_rank_batch launched {launches['fast_nms_rank_batch']} times for "
                 f"{s['frontend_batches']} batched frontend calls")
        for k in ("hamming_mutual", c_kernel, "pose_lm" if c_kernel == "schur_reduce" else "pose_lm_stereo"):
            if launches[k] < 1:
                fail(f"bench {n}: {k} was not launched")
        # each batch goes through fused_track_multi's three searches a frame, but those fed while the engine
        # is not OK: a loss and its recovery (a relocalization, or one found otherwise) take at most two batches
        batched = bench_batch * (s["frontend_batches"] - 2 * (s["relocalizations"] + s["recovered"]))
        for k in ("project_gate", "invert_matches"):
            if launches[k] < 3 * batched:
                fail(f"bench {n}: {k} launched {launches[k]} times for {s['frontend_batches']} batches with "
                     f"{s['relocalizations'] + s['recovered']} recoveries (three searches a batched frame)")
        if not (isinstance(s["ate_m"], float) and s["ate_m"] < 2 * ref):
            fail(f"bench {n}: ATE {s['ate_m']} m not below twice the JAX engine's {ref} m on the same frames")
    return dict(fps={n: metrics[2 * k]["value"] for k, n in enumerate(names)},
                vs_baseline={n: metrics[2 * k]["vs_baseline"] for k, n in enumerate(names)}, notes=notes,
                launches={BENCH_WORKLOADS[n][0]: notes[n]["launches"] for n in names})


def _pose_call(p, rounds: int, iters: int, plain: bool = False):
    from dialog_tpu_torch.optim import pose_only

    fn = pose_only.pose_optimization_plain if plain else pose_only.pose_optimization
    return fn(**p, chi2_th=7.815 if p["use_stereo"] else 5.991, rounds=rounds, iters=iters)


def check_pose(dev) -> dict:
    """The pose LM kernel against its plain loop on the card, mono and stereo
    at POSE_N observations and each of POSE_SHAPES: the same inlier set and
    count, R and t within POSE_TOL, and a second call equal bit for bit.
    Returns the largest |R, t difference| of each variant."""
    from dialog_tpu_torch.optim.synth_problem import make_pose_problem

    errs = {}
    for name, stereo in (("pose_lm", False), ("pose_lm_stereo", True)):
        p = make_pose_problem(seed=POSE_SEED, n=POSE_N, stereo=stereo, device=dev)
        for rounds, iters in POSE_SHAPES:
            got, again = _pose_call(p, rounds, iters), _pose_call(p, rounds, iters)
            want = _pose_call(p, rounds, iters, plain=True)
            torch.cuda.synchronize()
            err = max(float((got.R - want.R).abs().max()), float((got.t - want.t).abs().max()))
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            inl = torch.equal(got.inlier, want.inlier) and int(got.n_inliers) == int(want.n_inliers)
            say(f"{name} {rounds}x{iters}: max |R, t - plain| {err}, inliers {int(got.n_inliers)} (plain "
                f"{int(want.n_inliers)}), cost {float(got.cost)} (plain {float(want.cost)}), repeat bit for bit {same}")
            if not (inl and err < POSE_TOL and same):
                fail(f"{name} {rounds}x{iters}: the kernel differs from its plain loop (inliers equal {inl}, "
                     f"R/t {err} >= {POSE_TOL}, or a repeat differs: {not same})")
            errs[name] = max(errs.get(name, 0.0), err)
    return errs


def pose_bound(p, rounds: int, iters: int) -> dict:
    """The pose LM's least time: its inputs read once and outputs written once,
    or its float operations, rounds x (iters + 1) passes over the observations
    at ~40 for the projection and residual and 54 (27 multiply-adds) a row
    for H, g and the cost, whichever is larger."""
    ins = [p[k] for k in ("R0", "t0", "X", "uv", "inv_sigma2", "valid")] + ([p["u_right"]] if p["use_stereo"] else [])
    n = p["X"].shape[0]
    out_bytes = 4 * 13 + 8 + n
    ops = rounds * (iters + 1) * n * (40 + 54 * (3 if p["use_stereo"] else 2))
    return bound(nbytes(*ins) + out_bytes, ops)


def pose_entries(dev) -> dict:
    """The pose LM's readings at the main path's shapes: POSE_N observations,
    mono and stereo, 2 x 6 (tracking) with 4 x 10 (relocalization) under
    ``rounds4_iters10``; ``chain_ms`` the device time of the same launch over
    no observations, its serial chain of block sums and one-thread solves."""
    from dialog_tpu_torch.optim.synth_problem import make_pose_problem

    times = {}
    for name, stereo in (("pose_lm", False), ("pose_lm_stereo", True)):
        p = make_pose_problem(seed=POSE_SEED, n=POSE_N, stereo=stereo, device=dev)
        empty = make_pose_problem(seed=POSE_SEED, n=0, stereo=stereo, device=dev)
        shape = {}
        for rounds, iters in POSE_SHAPES:
            chain = device_ms(lambda: _pose_call(empty, rounds, iters), DEVICE_KERNELS[name])["device_ms"]
            shape[(rounds, iters)] = entry(name, lambda: _pose_call(p, rounds, iters),
                                           lambda: _pose_call(p, rounds, iters, plain=True),
                                           pose_bound(p, rounds, iters), observations=POSE_N, rounds=rounds,
                                           iters=iters, chain_ms=chain)
        times[name] = dict(shape[POSE_SHAPES[0]], rounds4_iters10=shape[POSE_SHAPES[1]])
    return times


def _project_problems(dev) -> dict:
    """(shape name, form) -> the arguments of a ``project_gate`` call at
    PROJECT_SHAPES: the motion search's (N rows, no frustum gate) and the
    local-map search's (max_local_lms rows, frustum gate, F features)."""
    from dialog_tpu_torch.config import KITTI00, TUM1
    from dialog_tpu_torch.optim.synth_problem import camera, make_projection_problem

    out = {}
    for name, (L, n_motion, n_local, F) in PROJECT_SHAPES.items():
        cam = camera(TUM1 if name == "tum1" else KITTI00)
        out[(name, "motion")] = make_projection_problem(PROJECT_SEED, L, n_motion, 0, cam, False, 15.0, dev)
        out[(name, "local_map")] = make_projection_problem(PROJECT_SEED, L, n_local, F, cam, True, 6.0, dev)
    return out


def check_project(dev) -> dict:
    """The projection glue's kernels against their plain versions on the
    card: ``project_gate`` at each of PROJECT_SHAPES' forms (descriptors,
    ``free`` and a repeat equal bit for bit, uv within PROJECT_UV_TOL on the
    points 1 m or more ahead; vis, seen and the octave may differ only on
    rows within PROJECT_GATE_NEAR of a gate or PROJECT_OCTAVE_NEAR of an
    octave's boundary, as ``projection_gates`` judges the problem in
    float64, where either answer is rounding's; and each gate alone rejects
    some rows of the problem, so a kernel that drops one fails),
    ``invert_matches`` bit for bit with and without a prior. Returns the
    largest uv difference and 0.0."""
    from dialog_tpu_torch.kernels.project import invert_matches, invert_matches_plain, project_gate, project_gate_plain
    from dialog_tpu_torch.optim.synth_problem import make_match_problem, projection_gates

    err = 0.0
    for (name, form), p in _project_problems(dev).items():
        got, again, want = project_gate(**p), project_gate(**p), project_gate_plain(**p)
        torch.cuda.synchronize()
        g = projection_gates(p)
        front = torch.from_numpy(g["z"] >= 1.0).to(dev)
        e = float((got.uv - want.uv).abs()[front].max())
        near = torch.from_numpy(g["margin"] <= PROJECT_GATE_NEAR).to(dev)
        masks = [("vis", got.vis, want.vis, near),
                 ("octave", got.octave, want.octave, torch.from_numpy(g["octave"] <= PROJECT_OCTAVE_NEAR).to(dev))]
        if got.seen is not None:
            masks.append(("seen", got.seen, want.seen, near))
        flips = {k: int((a != b).sum()) for k, a, b, _ in masks}
        away = {k: int(((a != b) & ~m).sum()) for k, a, b, m in masks}
        same = all(a is None or torch.equal(a, b) for a, b in zip(got, again))
        say(f"project_gate {name} {form} N={p['ids'].shape[0]}: max |uv - plain| {e} px (points 1 m ahead), rows "
            f"that differ {flips}, of them away from any boundary {away}, rows each gate alone rejects "
            f"{g['alone']}, desc equal {torch.equal(got.desc, want.desc)}, repeat bit for bit {same}")
        if not (e < PROJECT_UV_TOL and not any(away.values()) and same and torch.equal(got.desc, want.desc)
                and (got.free is None or torch.equal(got.free, want.free))):
            fail(f"project_gate {name} {form}: the kernel differs from its plain version")
        if not all(n > 0 for n in g["alone"].values()):
            fail(f"project_gate {name} {form}: a gate rejects no row of the problem alone: {g['alone']}")
        err = max(err, e)
    for N, F, L in ((1024, 1024, 32768), (8192, 2048, 262144)):
        for prior in (False, True):
            q = make_match_problem(PROJECT_SEED, N, F, L, prior, dev)
            got, want = invert_matches(**q), invert_matches_plain(**q)
            if not (torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])):
                fail(f"invert_matches N={N} F={F} prior={prior}: the kernel differs from its plain version")
    say("invert_matches: bit for bit against its plain version at N=1024 F=1024 and N=8192 F=2048, with and "
        "without a prior")
    return {"project_gate": err, "invert_matches": 0.0}


def project_bound(p, out) -> dict:
    """``project_gate``'s least time: the ids, each row's gathered store
    entries (xyz, desc, dmax, valid; with the frustum gate normal and dmin),
    the pose, the local-map form's features read once, and the outputs
    written once, at HBM's rate (a few tens of operations a row)."""
    n, F = p["ids"].shape[0], 0 if p.get("lm_of_feat") is None else p["lm_of_feat"].shape[0]
    row = 12 + 32 + 4 + 1 + (16 if p["frustum"] else 0)
    outs = nbytes(*[x for x in out if x is not None])
    return bound(4 * n + row * n + 48 + 5 * F + outs, 60 * n)


def project_entries(dev) -> dict:
    """The glue kernels' readings: ``project_gate`` in the local-map form at
    TUM1's shapes (max_local_lms rows, F 1,024), with ``motion`` (1,024 rows,
    no frustum gate) and ``kitti00`` (8,192 rows, F 2,048, L 262,144) beside
    it; ``invert_matches`` over 8,192 rows into 1,024 features with a prior,
    and ``motion`` (1,024 rows, none)."""
    from dialog_tpu_torch.kernels.project import invert_matches, invert_matches_plain, project_gate, project_gate_plain
    from dialog_tpu_torch.optim.synth_problem import make_match_problem

    probs = _project_problems(dev)

    def gate(key):
        p = probs[key]
        return entry("project_gate", lambda: project_gate(**p), lambda: project_gate_plain(**p),
                     project_bound(p, project_gate(**p)), reps=50, rows=p["ids"].shape[0], landmarks=p["xyz"].shape[0])

    def inv(N, F, L, prior):
        q = make_match_problem(PROJECT_SEED, N, F, L, prior, dev)
        n_bytes = 4 * N * 2 + (4 * F if prior else 0) + 4 * F + 8
        return entry("invert_matches", lambda: invert_matches(**q), lambda: invert_matches_plain(**q),
                     bound(n_bytes, 4 * N + 8 * F), reps=50, rows=N, features=F)

    return {"project_gate": dict(gate(("tum1", "local_map")), motion=gate(("tum1", "motion")),
                                 kitti00=gate(("kitti00", "local_map"))),
            "invert_matches": dict(inv(8192, 1024, 32768, True), motion=inv(1024, 1024, 32768, False))}


def entry(name, fn, plain, limit, reps=20, **extra) -> dict:
    """One kernel's readings at one shape: the device's own time per call
    (``device_ms``), the pace of back-to-back wrapper calls and of the plain
    version, the bound ``limit``, no library call, and whether the host sets
    the wrapper loop's pace."""
    out = device_ms(fn, DEVICE_KERNELS[name], reps=reps)
    out.update(ms=out["device_ms"], wrapper_loop_ms=time_ms(fn, reps=reps), plain_ms=time_ms(plain, reps=reps),
               library_ms=None, **limit, **extra)
    out["host_paced"] = out["wrapper_loop_ms"] > HOST_PACED * out["device_ms"]
    return out


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
    times.update(pose_entries(dev))
    times.update(project_entries(dev))
    return times


def main() -> int:
    t_script = time.perf_counter()
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

    phase_s = {}
    last = [t_script]

    def mark(name):
        """Print and keep the wall seconds since the previous mark (the script's time budget, by phase)."""
        now = time.perf_counter()
        phase_s[name] = round(now - last[0], 1)
        say(f"phase {name}: {phase_s[name]} s, {now - t_script:.1f} s into the script")
        last[0] = now

    t0 = time.perf_counter()
    build.load_all()
    say(f"build: {time.perf_counter() - t0:.2f} s total, per kernel "
        + json.dumps({k: round(v, 2) for k, v in build.build_seconds.items()}))
    for name, log in build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"ptxas {name}: {line.strip()}")
    mark("build")

    # the bench as users run it, in a child process: bench.py's three workloads
    bench = bench_phase(smi)
    mark("bench")
    bench_reloc_margin(dev, smi)
    mark("bench_reloc_margin")

    # mono path: kernel A once per image (all pyramid levels in one launch),
    # kernel B once per mutual match
    scene, images, eng, fps, launches = run_path("mono", dev)
    cfg = eng.cfg
    say(f"mono path: {fps:.3f} frames/s over frames {FPS_FIRST}-{N_FRAMES - 1} on {smi}")
    check_path("mono", eng, scene, launches, with_scale=True, ate_gate=ATE_GATE, min_kfs=4,
               min_launches={"fast_nms_rank": N_FRAMES, "hamming_mutual": 1, "schur_reduce": 1},
               max_launches={"fast_nms_rank": N_FRAMES})
    err_c, rel_c, prob = check_schur(eng, cfg, dev)
    mark("mono")

    # stereo path: two extractions per frame; every local BA takes the uR variant
    sscene, simages, seng, sfps, slaunches = run_path("stereo", dev)
    n_st = len(seng.trajectory)
    say(f"stereo path: {sfps:.3f} frames/s over frames {FPS_FIRST}-{n_st - 1} on {smi}")
    check_path("stereo", seng, sscene, slaunches, with_scale=False, ate_gate=STEREO_ATE_GATE, min_kfs=4,
               min_launches={"fast_nms_rank": 2 * n_st, "hamming_mutual": 1, "schur_reduce_stereo": 1},
               max_launches={"fast_nms_rank": 2 * n_st, "schur_reduce": 0})
    stereo_decisions(seng)
    err_cs, rel_cs, sprob = check_schur(seng, seng.cfg, dev)
    mark("stereo")

    rscene, rframes, reng, rfps, rlaunches = run_path("rgbd", dev)
    n_rg = len(reng.trajectory)
    say(f"rgbd path: {rfps:.3f} frames/s over frames {FPS_FIRST}-{n_rg - 1} on {smi}")
    check_path("rgbd", reng, rscene, rlaunches, with_scale=False, ate_gate=RGBD_ATE_GATE, min_kfs=3,
               min_launches={"fast_nms_rank": n_rg, "hamming_mutual": 1, "schur_reduce_stereo": 1},
               max_launches={"fast_nms_rank": n_rg})
    mark("rgbd")

    # the batched paths: kernel A once per batch of images, one host pull per batch
    mb = run_batch_path("mono_batch", dev)
    check_batch_path("mono_batch", mb, with_scale=True, ate_gate=ATE_GATE)
    sb = run_batch_path("stereo_batch", dev)
    check_batch_path("stereo_batch", sb, with_scale=False, ate_gate=STEREO_ATE_GATE)
    async_probe(dev, smi)
    mark("batched")

    # loop closing: the seeded pose graph on the card against the CPU (it also warms the solvers), then the orbit
    # per frame and batched under the reference loop test's gates, and the first closure replayed step by step
    check_pose_graph(dev, smi)
    loop_runs = {}
    for name in LOOP_PATHS:
        loop_runs[name] = run_loop_path(name, dev)
        check_loop_path(name, loop_runs[name], smi)
    loop_probe("loop", loop_runs["loop"], dev, smi)
    loop_probe("loop_tum", loop_runs["loop_tum"], dev, smi)
    mark("loop")

    # global BA: the dense branch (kernel C at C = 96) against the PCG and the CPU, the landmark-sharded solve
    # over two ranks against one (the KITTI00 capacity case comes after the kernels' timing)
    gba_dense = check_gba_dense(loop_runs["loop"], dev, smi)
    gba_sharded = check_gba_sharded(loop_runs, dev, smi)
    mark("gba")

    # two runs of a path from one seed give the same bits (the loop path's global BA included); then the
    # engine's other modes on the loop engine, and block BA over two ranks against one
    check_determinism({"mono": eng, "loop": loop_runs["loop"]["eng"]}, dev, smi)
    check_modes(loop_runs["loop"], dev, smi)
    block_sharded = check_block_sharded(dev, smi)
    mark("determinism_modes_block_sharded")

    # kernels A and B against their plain versions (after the paths: these launches do not count)
    err_a = check_fast([("mono", images[0], cfg), ("stereo", simages[0][0], seng.cfg)], dev)
    mono_stack = np.stack(mb["frames"][8 : 8 + BATCH])
    stereo_stack = np.stack([x[0] for x in sb["frames"][4 : 4 + BATCH]] + [x[1] for x in sb["frames"][4 : 4 + BATCH]])
    err_ab = check_fast_batch([("mono_batch", mono_stack, cfg), ("stereo_batch", stereo_stack, seng.cfg)], dev)
    err_b, err_m = check_hamming(dev)
    mark("kernels_ab")
    err_pose = check_pose(dev)
    mark("pose")
    err_project = check_project(dev)
    mark("project")

    times = kernel_times(images, cfg, prob, seng.cfg, sprob, dev, mono_stack, stereo_stack)
    times["schur_reduce"]["global_ba_C"] = check_schur_large_c(dev, smi)
    corridor = block_corridor(dev)
    err_cf, rel_cf, times["schur_reduce_frozen"] = check_schur_frozen(corridor, sprob, seng.cfg, dev, smi)
    mark("kernel_times")
    # the KITTI00 capacity cases profile their own work: after the kernels' short sessions (ROADMAP D11: in one
    # run the session after its profiled windows came back without a device record)
    gba_capacity = check_gba_capacity(dev, smi)
    block_capacity = check_block_capacity(corridor, dev, smi)
    del corridor
    mark("capacity")

    # the batched paths against their per-frame twins under the profiler, and relocalization on the mono_batch
    # engine. These windows (some 100,000 kernels each) come after the kernels' own short profiler
    # sessions: in one run the first short session behind four of them came back without a device record
    profile_batch_path("mono_batch", mb, smi)
    reloc_probe(mb, dev, smi)
    profile_batch_path("stereo_batch", sb, smi)
    mark("profiles_reloc")

    # the kernels' self-check at the reference's shapes, then the CLI over the paths' frames written to disk. Last:
    # in one run the first profiler session after the CLI phase came back without a device record (ROADMAP D11)
    check_selfcheck(smi)
    mark("selfcheck")
    cli_runs = cli_phase({"mono": (scene, images), "rgbd": (rscene, rframes, reng.cfg), "stereo": (sscene, simages)},
                         dev, smi)
    mark("cli")
    errs = {"fast_nms_rank": err_a, "fast_nms_rank_batch": err_ab, "hamming_best2": err_b, "hamming_mutual": err_m,
            "schur_reduce": err_c, "schur_reduce_stereo": err_cs, "schur_reduce_frozen": err_cf, **err_pose,
            **err_project}
    rels = {"schur_reduce": rel_c, "schur_reduce_stereo": rel_cs, "schur_reduce_frozen": rel_cf}
    by_path = {"mono": launches, "stereo": slaunches, "rgbd": rlaunches, "mono_batch": mb["launches"],
               "stereo_batch": sb["launches"], **{name: run["launches"] for name, run in loop_runs.items()},
               "gba_dense": gba_dense["launches"], "gba_sharded": gba_sharded["one_rank_launches"],
               "gba_capacity": gba_capacity["launches"], "block_sharded": block_sharded["one_rank_launches"],
               "block_capacity": block_capacity["launches"], **{n: r["launches"] for n, r in cli_runs.items()
                                                                if n.startswith("cli_")}, **bench["launches"]}
    # every launch is above these bounds: the shortest single kernel of the timing runs is the practical floor
    floor_ms = min(t["shortest_launch_ms"] for t in times.values())
    say(f"shortest single kernel launch seen while timing (the practical floor of any bound below it): "
        f"{floor_ms} ms on {smi}")
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        path = {"schur_reduce_stereo": "stereo", "fast_nms_rank_batch": "mono_batch",
                "schur_reduce_frozen": "block_capacity", "pose_lm_stereo": "stereo"}.get(name, "mono")
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
               f"iterations {t['solve_device_ms']} ms" if "solve_device_ms" in t else "")
            + "".join(f"; at C={c}: device {g['device_ms']} ms {json.dumps(g['stages_ms'])}, wrapper loop "
                      f"{g['wrapper_loop_ms']} ms, plain {g['plain_ms']} ms, bound {g['bound_ms']} ms by {g['bound_by']}"
                      for c, g in t.get("global_ba_C", {}).items())
            + "".join(f"; {g['rounds']}x{g['iters']} at N={g['observations']}: device {g['device_ms']} ms, chain "
                      f"{g['chain_ms']} ms, wrapper loop {g['wrapper_loop_ms']} ms, plain {g['plain_ms']} ms"
                      for g in ([t, t["rounds4_iters10"]] if "chain_ms" in t else []))
            + "".join(f"; {k}: device {t[k]['device_ms']} ms, wrapper loop {t[k]['wrapper_loop_ms']} ms, plain "
                      f"{t[k]['plain_ms']} ms, bound {t[k]['bound_ms']} ms" for k in ("motion", "kitti00") if k in t))
    say(f"chip_smoke.py: {time.perf_counter() - t_script:.1f} s in all, the kernels' build included, on {smi}; "
        f"by phase: {json.dumps(phase_s)}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
