"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; exits non-zero without them. It

1. prints the card's name and power limit (nvidia-smi);
2. builds kernels A, B and C from dialog_tpu_torch/csrc/ with nvcc for sm_90a,
   one nvcc per source, all started together;
3. checks kernel A (FAST rank) and kernel B (gated Hamming best/second) against
   their plain PyTorch versions on the card, bit for bit;
4. drives the mono path, ``Engine(cfg, device="cuda").track_image`` over 56
   rendered frames of the TUM-class 640x480 monocular configuration;
5. checks kernel C (BA Schur reduction) on the local-BA problem built from the
   engine's own map, its landmarks and optimized poses moved off the optimum
   by seeded noise and its near-camera observations left out: direct outputs
   against the plain version, bitwise repeatability, and a 5-iteration solve
   against the plain solve;
6. drives the stereo path, ``Engine.track_stereo`` over 48 rendered 1241x376
   pairs at the KITTI00 preset (bench.py's capacities), and checks kernel C's
   stereo (uR) variant as in 5 on that engine's window (C=64, P=8192, O=12);
7. drives the RGB-D path, ``Engine.track_rgbd`` over 24 rendered 640x480
   frames with their depth maps at the TUM1 RGB-D settings;
8. times each kernel and its plain version at its path's shapes.

Each path runs on a fresh engine, with every kernel's launch count reset just
before it and read just after. It prints one JSON line with the kernels, the
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

from dialog_tpu_torch.profile_main_path import FPS_FIRST, N_FRAMES, WORKLOADS, track_frames

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
COND_MAX = 1e4          # stereo solve: landmarks whose undamped Hll is worse conditioned are held in pixels (check_schur)
ATE_GATE = 0.35         # metres, the reference's image-in-the-loop gate (similarity-aligned)
# metres, metric ATE (rigid alignment, no scale) of the stereo path: twice the
# reference engine's own 0.1226 m on the same 48 frames (tools/reference_ate.py, PERF.md)
STEREO_ATE_GATE = 0.25
RGBD_ATE_GATE = 0.05    # metres, metric: the reference's stereo/RGB-D gate (tests/test_stereo_rgbd.py)

KERNELS = {
    "fast_nms_rank": ("dialog_tpu_torch/csrc/fast.cu", "dialog_tpu/kernels/fast.py:118"),
    "hamming_best2": ("dialog_tpu_torch/csrc/hamming.cu", "dialog_tpu/kernels/hamming.py:131"),
    "schur_reduce": ("dialog_tpu_torch/csrc/schur.cu", "dialog_tpu/kernels/schur.py:293"),
    "schur_reduce_stereo": ("dialog_tpu_torch/csrc/schur.cu", "dialog_tpu/kernels/schur.py:293"),
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Mean device time of one call over ``reps`` calls (CUDA events)."""
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


# ---------------------------------------------------------------------------
# kernel A
# ---------------------------------------------------------------------------


def check_fast(images, cfg, dev) -> float:
    from dialog_tpu_torch import frontend as fe
    from dialog_tpu_torch.kernels.fast import fast_nms_rank, fast_nms_rank_plain

    worst = 0.0
    pyr = fe.build_pyramid(torch.from_numpy(images[0]).to(dev), cfg)
    cases = [(f"level{l} {tuple(img.shape)}", img, (float(cfg.min_th_fast), float(cfg.ini_th_fast), fe.BORDER))
             for l, img in enumerate(pyr)]
    rng = np.random.default_rng(1)
    rnd = torch.from_numpy(rng.uniform(0, 255, (123, 210)).astype(np.float32)).to(dev)
    cases += [("random 123x210 (7,20,19)", rnd, (7.0, 20.0, 19)), ("random 123x210 (3,10,8)", rnd, (3.0, 10.0, 8))]
    for name, img, (min_th, th_fast, border) in cases:
        got = fast_nms_rank(img, min_th, th_fast, border)
        want = fast_nms_rank_plain(img, min_th, th_fast, border)
        torch.cuda.synchronize()
        diff = float((got - want).abs().max())
        worst = max(worst, diff)
        say(f"kernel A fast_nms_rank {name}: equal={torch.equal(got, want)} max_abs_diff={diff}")
        if not torch.equal(got, want):
            fail(f"kernel A differs from its plain version on {name}")
    return worst


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


def check_hamming(dev) -> float:
    from dialog_tpu_torch.kernels.hamming import _defaults, hamming_best2, hamming_best2_plain

    worst = 0.0
    for n, m in [(700, 900), (2048, 1024)]:
        x = _hamming_inputs(n, m, 0, dev)
        for name, kw in [
            ("plain", {}),
            ("spatial", dict(uv_a=x["uva"], uv_b=x["uvb"], radius2=x["r2"])),
            ("spatial+oct", dict(uv_a=x["uva"], uv_b=x["uvb"], radius2=x["r2"],
                                 oct_a=x["oa"], oct_b=x["ob"], octave_band=1)),
            ("col-radius", dict(uv_a=x["uva"], uv_b=x["uvb"], radius2_cols=x["r2c"])),
        ]:
            got = hamming_best2(x["a"], x["b"], x["va"], x["vb"], **kw)
            filled = _defaults(x["a"], x["b"], kw.get("uv_a"), kw.get("uv_b"), kw.get("radius2"),
                               kw.get("radius2_cols"), kw.get("oct_a"), kw.get("oct_b"))
            want = hamming_best2_plain(x["a"], x["b"], x["va"], x["vb"], *filled, kw.get("octave_band", -1))
            torch.cuda.synchronize()
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            diff = max(float((g - w).abs().max()) for g, w in zip(got, want))
            worst = max(worst, diff)
            say(f"kernel B hamming_best2 N={n} M={m} {name}: equal={same} max_abs_diff={diff}")
            if not same:
                fail(f"kernel B differs from its plain version on N={n} M={m} {name}")
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
    return worst


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


def check_path(name, eng, scene, launches, *, with_scale: bool, ate_gate: float, min_kfs: int,
               min_launches: dict) -> dict:
    """The path's gates: state OK at the end, OK share > 0.95 after the
    first OK frame, at least ``min_kfs`` keyframes, a finite ATE below
    ``ate_gate`` (similarity-aligned with ``with_scale``, else metric), and at
    least ``min_launches[k]`` launches of each kernel k."""
    from dialog_tpu_torch.eval.ate import ate_rmse
    from dialog_tpu_torch.system import OK

    states = [r.state for r in eng.trajectory]
    if OK not in states:
        fail(f"{name}: the engine never initialized")
    first_ok = states.index(OK)
    ok_share = float(np.mean([s == OK for s in states[first_ok:]]))
    recs = [r for r in eng.trajectory if r.state == OK]
    est = np.stack([-R.T @ t for (R, t), r in zip(eng.final_poses(), eng.trajectory) if r.state == OK])
    gt = np.stack([-scene.R[r.frame_id].T @ scene.t[r.frame_id] for r in recs])
    ate = ate_rmse(est, gt, with_scale=with_scale)
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


def check_schur(eng, cfg, dev):
    """Kernel C on the engine's own local-BA window (see _check_window); its
    stereo variant when the engine's problem carries a right-x.

    Direct outputs: each within REL_TOL_C of the plain version, relative to
    that output's largest magnitude; Hll^-1 block by block, since the 3x3
    blocks of unobserved (padding) landmarks hold 1/1e-9. The comparison
    runs at damping LAM_C: the damping bounds the condition number of each
    diagonally scaled Hll block by (3 + lam) / lam, and at the engine's own
    lam = 1e-4 the plain f32 version is itself about 2e-3 off a float64
    evaluation in Hll^-1 and 2e-4 in g_red (on an H100), so 1e-4 would test
    f32 rounding, not the kernel.

    Solve: 5 LM iterations from the engine's lam0, on the card and with the
    plain version on the CPU: R and t within SOLVE_TOL_RT, every live
    landmark within SOLVE_TOL_XYZ. On a stereo window that holds for the
    landmarks whose undamped Hll (float64, at the perturbed start) has a
    condition number at most COND_MAX: up to there both f32 solves stay
    within half of SOLVE_TOL_XYZ of a float64 solve (PERF.md: the
    measurements COND_MAX follows from). The others (two near-parallel rays
    without a stereo row, or one stereo row at sub-pixel disparity, some
    hundreds of metres out) slide metres along their ray in 5 iterations,
    and f32 rounding alone moves them by up to a metre there (the plain f32
    solve against float64, printed beside). They are held where the window
    sees them: each of their observations' predicted image rows (u, v, uR)
    after the two solves, within the pixels that SOLVE_TOL_XYZ makes at the
    window's median depth, fx x SOLVE_TOL_XYZ / median depth. The check
    fails unless the plain solve moves R or t by at least 2 x SOLVE_TOL_RT
    and some landmark held in xyz by at least 2 x SOLVE_TOL_XYZ, so that a
    wrong gradient cannot pass unseen.

    Returns (max abs R/t/xyz difference after the solve, largest direct
    relative error, the problem).
    """
    from dialog_tpu_torch.kernels.schur import observation_terms, schur_reduce, schur_reduce_plain
    from dialog_tpu_torch.optim.local_ba import solve_ba

    prob, n_near, z_med = _check_window(eng, cfg, dev)
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
    dbl = lambda x: x.double() if isinstance(x, torch.Tensor) and x.is_floating_point() else x  # noqa: E731
    kw64 = {k: dbl(v) for k, v in kw.items()}
    f64 = schur_reduce_plain(*map(dbl, args), **kw64)
    # condition numbers of the undamped landmark blocks (Hll^-1 has Hll's)
    ev = torch.linalg.eigvalsh(schur_reduce_plain(*map(dbl, args[:7]), lam.double() * 0.0, *args[8:], **kw64)[0])
    cond = torch.where(ev[:, 0] > 0, ev[:, 2] / ev[:, 0], float("inf")).cpu()
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

    Rk, tk, xk, ck = solve_ba(prob, cfg, iters=5, chi2_th=cfg.chi2_mono)
    cpu = type(prob)(*[x.cpu() if isinstance(x, torch.Tensor) else x for x in prob])
    Rp, tp, xp, cp = solve_ba(cpu, cfg, iters=5, chi2_th=cfg.chi2_mono)
    R64, t64, x64, _ = solve_ba(type(cpu)(*map(dbl, cpu)), cfg, iters=5, chi2_th=cfg.chi2_mono)
    live = cpu.lm_ids < cfg.max_landmarks
    held = live & (cond <= COND_MAX) if stereo else live
    loose = live & ~held
    dR = float((Rk.cpu() - Rp).abs().max())
    dt = float((tk.cpu() - tp).abs().max())
    dxyz = (xk.cpu() - xp).abs().amax(1)
    own = (xp.double() - x64).abs().amax(1)   # the plain f32 solve against float64
    dx = float(dxyz[held].max())
    moved_rt = max(float((Rp - cpu.R).abs().max()), float((tp - cpu.t).abs().max()))
    moved_xyz = float((xp - cpu.xyz)[held].abs().max())
    top = lambda x, m: float(torch.where(m, x, 0.0).max())  # noqa: E731
    say(f"kernel C {kname} solve_ba 5 iters vs plain: max|dR|={dR} max|dt|={dt} max|dxyz|={dx} over "
        f"{int(held.sum())} of {int(live.sum())} landmarks (plain f32 against float64: {top(own, held)}); "
        f"cost {float(ck)} vs {float(cp)}")
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
        fail("the perturbed window is too close to its optimum for the solve check to show anything")
    return max(dR, dt, dx), max_rel, prob


# ---------------------------------------------------------------------------
# timing at the main path's shapes
# ---------------------------------------------------------------------------


def kernel_times(images, cfg, prob, stereo_cfg, stereo_prob, dev) -> dict:
    from dialog_tpu_torch.kernels.fast import fast_nms_rank, fast_nms_rank_plain
    from dialog_tpu_torch.kernels.hamming import _defaults, hamming_best2, hamming_best2_plain
    from dialog_tpu_torch.kernels.schur import schur_reduce, schur_reduce_plain

    img = torch.from_numpy(images[0]).to(dev)
    a_args = (img, float(cfg.min_th_fast), float(cfg.ini_th_fast), 19)
    x = _hamming_inputs(2048, 1024, 3, dev)
    h_args = (x["a"], x["b"], x["va"], x["vb"], x["uva"], x["uvb"], x["r2"])
    filled = _defaults(x["a"], x["b"], x["uva"], x["uvb"], x["r2"], None, x["oa"], x["ob"])
    lam = torch.tensor(1e-4, dtype=torch.float32, device=dev)

    def c_args(p, c):
        return (p.R, p.t, p.cam_opt, p.xyz, p.obs_cam, p.obs_uv, p.obs_w, lam, c.fx, c.fy, c.cx, c.cy, c.chi2_mono)

    m_args, s_args, s_kw = c_args(prob, cfg), c_args(stereo_prob, stereo_cfg), _stereo_kw(stereo_prob, stereo_cfg)
    return {
        "fast_nms_rank": (time_ms(lambda: fast_nms_rank(*a_args)), time_ms(lambda: fast_nms_rank_plain(*a_args))),
        "hamming_best2": (
            time_ms(lambda: hamming_best2(*h_args, oct_a=x["oa"], oct_b=x["ob"], octave_band=1)),
            time_ms(lambda: hamming_best2_plain(x["a"], x["b"], x["va"], x["vb"], *filled, 1)),
        ),
        "schur_reduce": (time_ms(lambda: schur_reduce(*m_args)), time_ms(lambda: schur_reduce_plain(*m_args))),
        "schur_reduce_stereo": (time_ms(lambda: schur_reduce(*s_args, **s_kw), reps=10),
                                time_ms(lambda: schur_reduce_plain(*s_args, **s_kw), reps=10)),
    }


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

    # mono path (kernels A and B are checked on its first frame's pyramid)
    scene, images, eng, fps, launches = run_path("mono", dev)
    cfg = eng.cfg
    err_a = check_fast(images, cfg, dev)
    err_b = check_hamming(dev)
    say(f"mono path: {fps:.3f} frames/s over frames {FPS_FIRST}-{N_FRAMES - 1} on {smi}")
    check_path("mono", eng, scene, launches, with_scale=True, ate_gate=ATE_GATE, min_kfs=4,
               min_launches={"fast_nms_rank": 8 * N_FRAMES, "hamming_best2": 1, "schur_reduce": 1})
    err_c, rel_c, prob = check_schur(eng, cfg, dev)

    # stereo path: two extractions per frame; every local BA takes the uR variant
    sscene, _, seng, sfps, slaunches = run_path("stereo", dev)
    n_st = len(seng.trajectory)
    say(f"stereo path: {sfps:.3f} frames/s over frames {FPS_FIRST}-{n_st - 1} on {smi}")
    check_path("stereo", seng, sscene, slaunches, with_scale=False, ate_gate=STEREO_ATE_GATE, min_kfs=4,
               min_launches={"fast_nms_rank": 16 * n_st, "hamming_best2": 1, "schur_reduce_stereo": 1})
    if slaunches["schur_reduce"] != 0:
        fail(f"stereo path: the mono variant of kernel C launched {slaunches['schur_reduce']} times")
    err_cs, rel_cs, sprob = check_schur(seng, seng.cfg, dev)

    rscene, _, reng, rfps, rlaunches = run_path("rgbd", dev)
    say(f"rgbd path: {rfps:.3f} frames/s over frames {FPS_FIRST}-{len(reng.trajectory) - 1} on {smi}")
    check_path("rgbd", reng, rscene, rlaunches, with_scale=False, ate_gate=RGBD_ATE_GATE, min_kfs=3,
               min_launches={"schur_reduce_stereo": 1})

    times = kernel_times(images, cfg, prob, seng.cfg, sprob, dev)
    errs = {"fast_nms_rank": err_a, "hamming_best2": err_b, "schur_reduce": err_c, "schur_reduce_stereo": err_cs}
    rels = {"schur_reduce": rel_c, "schur_reduce_stereo": rel_cs}
    by_path = {"mono": launches, "stereo": slaunches, "rgbd": rlaunches}
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        ms, plain_ms = times[name]
        path = "stereo" if name == "schur_reduce_stereo" else "mono"
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": by_path[path][name], "launches_path": path,
            "launches_by_path": {p: n[name] for p, n in by_path.items()},
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
        })
        if name in rels:
            kernels[-1]["direct_max_rel_err"] = rels[name]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
