"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; exits non-zero without them. It

1. prints the card's name and power limit (nvidia-smi);
2. builds kernels A, B and C from dialog_tpu_torch/csrc/ with nvcc for sm_90a;
3. checks kernel A (FAST rank) and kernel B (gated Hamming best/second) against
   their plain PyTorch versions on the card, bit for bit;
4. drives the main path, ``Engine(cfg, device="cuda").track_image`` over 56
   rendered frames of the TUM-class 640x480 monocular configuration, with every
   kernel's launch count reset just before and read just after;
5. checks kernel C (BA Schur reduction) on the local-BA problem built from the
   engine's own map, its landmarks and optimized poses moved off the optimum
   by seeded noise and its near-camera observations left out: direct outputs
   against the plain version, bitwise repeatability, and a 5-iteration solve
   against the plain solve;
6. times each kernel and its plain version at the main path's shapes.

It prints one JSON line with the kernels, the nvidia-smi line, and as its last
line ``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
that line. Nothing here imports JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from dialog_tpu_torch.profile_main_path import FPS_FIRST, N_FRAMES, render_frames, tum_mono_config

# tolerances: A and B are integer/min-max computations and must be bit-exact;
# C sums in another order than the plain version (f32)
REL_TOL_C = 1e-4        # direct outputs: max |kernel - plain| / max |plain| per output
LAM_C = 1e-2            # LM damping of the direct comparison (see check_schur)
SOLVE_TOL_RT = 2e-3     # R, t after a 5-iteration solve (kernels/selfcheck bounds)
SOLVE_TOL_XYZ = 5e-3    # landmark xyz after the same solve
LM_NOISE = 3e-3         # landmark perturbation, map units (N(0, .) per coordinate)
POSE_NOISE = 5e-3       # optimized-pose perturbation, twist (N(0, .) per component)
NEAR_DEPTH = 0.05       # observations nearer than this share of the median depth are left out
ATE_GATE = 0.35         # metres, the reference's image-in-the-loop gate

KERNELS = {
    "fast_nms_rank": ("dialog_tpu_torch/csrc/fast.cu", "dialog_tpu/kernels/fast.py:118"),
    "hamming_best2": ("dialog_tpu_torch/csrc/hamming.cu", "dialog_tpu/kernels/hamming.py:131"),
    "schur_reduce": ("dialog_tpu_torch/csrc/schur.cu", "dialog_tpu/kernels/schur.py:293"),
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


def run_main_path(cfg, images, dev):
    """Track all frames; returns (engine, fps over frames FPS_FIRST.., launches)."""
    from dialog_tpu_torch.kernels import common
    from dialog_tpu_torch.system import Engine

    eng = Engine(cfg, device=dev)
    common.reset_launch_counts()
    t_start = None
    for i, img in enumerate(images):
        if i == FPS_FIRST:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        rec = eng.track_image(img, float(i) / 30.0)
        if i % 8 == 0:
            say(f"frame {i}: {rec.state} tracked={rec.n_tracked} kfs={eng.kf_count}")
    torch.cuda.synchronize()
    fps = (len(images) - FPS_FIRST) / (time.perf_counter() - t_start)
    return eng, fps, dict(common.launches)


def check_main_path(eng, scene, launches) -> dict:
    from dialog_tpu_torch.eval.ate import ate_rmse
    from dialog_tpu_torch.system import OK

    states = [r.state for r in eng.trajectory]
    if OK not in states:
        fail("the engine never initialized")
    first_ok = states.index(OK)
    ok_share = float(np.mean([s == OK for s in states[first_ok:]]))
    recs = [r for r in eng.trajectory if r.state == OK]
    est = np.stack([-R.T @ t for (R, t), r in zip(eng.final_poses(), eng.trajectory) if r.state == OK])
    gt = np.stack([-scene.R[r.frame_id].T @ scene.t[r.frame_id] for r in recs])
    ate = ate_rmse(est, gt, with_scale=True)
    n_lms = int(eng.m.lms.valid.sum())
    out = dict(state=eng.state, kf_count=eng.kf_count, n_landmarks=n_lms, first_ok=first_ok,
               ok_share=ok_share, ate_m=ate, launches=launches)
    say("main path: " + json.dumps(out))
    if eng.state != OK:
        fail(f"state at the end is {eng.state}")
    if eng.kf_count < 4:
        fail(f"kf_count {eng.kf_count} < 4")
    if not ok_share > 0.95:
        fail(f"OK share {ok_share} <= 0.95")
    if not (np.isfinite(ate) and ate < ATE_GATE):
        fail(f"ATE {ate} m not below {ATE_GATE} m")
    if launches["fast_nms_rank"] < 8 * N_FRAMES:
        fail(f"kernel A launched {launches['fast_nms_rank']} < {8 * N_FRAMES} times")
    if launches["hamming_best2"] <= 0 or launches["schur_reduce"] <= 0:
        fail(f"kernel B or C never launched on the main path: {launches}")
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
      poses by a N(0, POSE_NOISE) twist, from a fixed seed;
    * without the observations nearer their camera than NEAR_DEPTH of the
      median depth (the engine's map, like the reference's, holds some at
      1-2 mm against a median of 0.7): there a reprojection moves by 1e5 px
      per map unit, and f32 rounding in either reduction sends the two
      5-iteration LM solves down different paths (kept in, they end 0.13
      apart in xyz on an H100 at 700 W).

    Returns the problem and the number of observations taken out."""
    from dialog_tpu_torch import geometry as geo
    from dialog_tpu_torch.optim.local_ba import build_problem

    prob = build_problem(eng.m, eng.ref_kf, cfg)
    rng = np.random.default_rng(5)
    live = (prob.lm_ids < cfg.max_landmarks)[:, None]
    dx = torch.from_numpy(rng.normal(0.0, LM_NOISE, tuple(prob.xyz.shape)).astype(np.float32)).to(dev)
    xi = torch.from_numpy(rng.normal(0.0, POSE_NOISE, (prob.R.shape[0], 6)).astype(np.float32)).to(dev)
    R, t = geo.se3_retract(prob.R, prob.t, xi * prob.cam_opt[:, None])
    xyz = torch.where(live, prob.xyz + dx, prob.xyz)
    safe = torch.clamp(prob.obs_cam, 0, R.shape[0] - 1).long()
    z = geo.project(R[safe], t[safe], xyz[:, None, :].expand(prob.obs_uv.shape[:2] + (3,)),
                    cfg.fx, cfg.fy, cfg.cx, cfg.cy)[1]
    near = prob.obs_ok & (z < NEAR_DEPTH * z[prob.obs_ok & (z > 0)].median())
    return prob._replace(R=R.contiguous(), t=t.contiguous(), xyz=xyz.contiguous(),
                         obs_w=torch.where(near, 0.0, prob.obs_w), obs_ok=prob.obs_ok & ~near), int(near.sum())


def check_schur(eng, cfg, dev):
    """Kernel C on the engine's own local-BA window (see _check_window).

    Direct outputs: each within REL_TOL_C of the plain version, relative to
    that output's largest magnitude; Hll^-1 block by block, since the 3x3
    blocks of unobserved (padding) landmarks hold 1/1e-9. The comparison
    runs at damping LAM_C: the damping bounds the condition number of each
    diagonally scaled Hll block by (3 + lam) / lam, and at the engine's own
    lam = 1e-4 the plain f32 version is itself about 2e-3 off a float64
    evaluation in Hll^-1 and 2e-4 in g_red (on an H100), so 1e-4 would test
    f32 rounding, not the kernel.

    Solve: 5 LM iterations from the engine's lam0, on the card and with the
    plain version on the CPU: R and t within SOLVE_TOL_RT, landmarks within
    SOLVE_TOL_XYZ. The check fails unless the plain solve moves R or t by at
    least 2 x SOLVE_TOL_RT and some landmark by at least 2 x SOLVE_TOL_XYZ,
    so that a wrong gradient cannot pass unseen.

    Returns (max abs R/t/xyz difference after the solve, largest direct
    relative error, the problem).
    """
    from dialog_tpu_torch.kernels.schur import schur_reduce, schur_reduce_plain
    from dialog_tpu_torch.optim.local_ba import solve_ba

    prob, n_near = _check_window(eng, cfg, dev)
    C, (P, O) = prob.R.shape[0], prob.obs_cam.shape
    lam = torch.tensor(LAM_C, dtype=torch.float32, device=dev)
    args = (prob.R, prob.t, prob.cam_opt, prob.xyz, prob.obs_cam, prob.obs_uv, prob.obs_w, lam,
            cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.chi2_mono)
    got = schur_reduce(*args)
    again = schur_reduce(*args)
    want = schur_reduce_plain(*args)
    f64 = schur_reduce_plain(*[x.double() if isinstance(x, torch.Tensor) and x.is_floating_point() else x
                               for x in args])
    torch.cuda.synchronize()
    say(f"kernel C problem from the engine map: C={C} P={P} O={O} observations={int(prob.obs_ok.sum())} "
        f"(left out {n_near} nearer than {NEAR_DEPTH} of the median depth) "
        f"landmarks={int((prob.lm_ids < cfg.max_landmarks).sum())} optimized poses={int(prob.cam_opt.sum())}")
    max_rel = 0.0
    bad = []
    for name, g, w, w64 in zip(["Hll_inv", "g_l", "Y", "Hcc", "g_c", "g_red", "S_pair"], got, want, f64):
        err = _rel_err(g, w, per_block=name == "Hll_inv")
        max_rel = max(max_rel, err)
        say(f"kernel C schur_reduce {name} lam={LAM_C}: max_abs_diff={float((g - w).abs().max())} "
            f"rel_err={err} ok={err <= REL_TOL_C} "
            f"(plain f32 against float64: {_rel_err(w.double(), w64, per_block=name == 'Hll_inv')})")
        if not err <= REL_TOL_C:
            bad.append(name)
    if bad:
        fail(f"kernel C outputs {bad} differ from the plain version by more than {REL_TOL_C}")
    repeat = all(torch.equal(a, b) for a, b in zip(got, again))
    say(f"kernel C schur_reduce bitwise repeatable: {repeat}")
    if not repeat:
        fail("kernel C is not bitwise repeatable")

    Rk, tk, xk, ck = solve_ba(prob, cfg, iters=5, chi2_th=cfg.chi2_mono)
    cpu = type(prob)(*[x.cpu() if isinstance(x, torch.Tensor) else x for x in prob])
    Rp, tp, xp, cp = solve_ba(cpu, cfg, iters=5, chi2_th=cfg.chi2_mono)
    live = cpu.lm_ids < cfg.max_landmarks
    dR = float((Rk.cpu() - Rp).abs().max())
    dt = float((tk.cpu() - tp).abs().max())
    dx = float((xk.cpu() - xp)[live].abs().max())
    moved_rt = max(float((Rp - cpu.R).abs().max()), float((tp - cpu.t).abs().max()))
    moved_xyz = float((xp - cpu.xyz)[live].abs().max())
    say(f"kernel C solve_ba 5 iters vs plain: max|dR|={dR} max|dt|={dt} max|dxyz|={dx}; "
        f"cost {float(ck)} vs {float(cp)}")
    say(f"kernel C solve_ba the plain solve moved: R/t by {moved_rt}, landmarks by {moved_xyz}")
    if not (dR < SOLVE_TOL_RT and dt < SOLVE_TOL_RT and dx < SOLVE_TOL_XYZ):
        fail("kernel C solve_ba result differs from the plain solve beyond tolerance")
    if not (moved_rt >= 2 * SOLVE_TOL_RT and moved_xyz >= 2 * SOLVE_TOL_XYZ):
        fail("the perturbed window is too close to its optimum for the solve check to show anything")
    return max(dR, dt, dx), max_rel, prob


# ---------------------------------------------------------------------------
# timing at the main path's shapes
# ---------------------------------------------------------------------------


def kernel_times(images, cfg, prob, dev) -> dict:
    from dialog_tpu_torch.kernels.fast import fast_nms_rank, fast_nms_rank_plain
    from dialog_tpu_torch.kernels.hamming import _defaults, hamming_best2, hamming_best2_plain
    from dialog_tpu_torch.kernels.schur import schur_reduce, schur_reduce_plain

    img = torch.from_numpy(images[0]).to(dev)
    a_args = (img, float(cfg.min_th_fast), float(cfg.ini_th_fast), 19)
    x = _hamming_inputs(2048, 1024, 3, dev)
    h_args = (x["a"], x["b"], x["va"], x["vb"], x["uva"], x["uvb"], x["r2"])
    filled = _defaults(x["a"], x["b"], x["uva"], x["uvb"], x["r2"], None, x["oa"], x["ob"])
    lam = torch.tensor(1e-4, dtype=torch.float32, device=dev)
    c_args = (prob.R, prob.t, prob.cam_opt, prob.xyz, prob.obs_cam, prob.obs_uv, prob.obs_w, lam,
              cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.chi2_mono)
    return {
        "fast_nms_rank": (time_ms(lambda: fast_nms_rank(*a_args)), time_ms(lambda: fast_nms_rank_plain(*a_args))),
        "hamming_best2": (
            time_ms(lambda: hamming_best2(*h_args, oct_a=x["oa"], oct_b=x["ob"], octave_band=1)),
            time_ms(lambda: hamming_best2_plain(x["a"], x["b"], x["va"], x["vb"], *filled, 1)),
        ),
        "schur_reduce": (time_ms(lambda: schur_reduce(*c_args)), time_ms(lambda: schur_reduce_plain(*c_args))),
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

    cfg = tum_mono_config()
    scene, images = render_frames(cfg)

    err_a = check_fast(images, cfg, dev)
    err_b = check_hamming(dev)
    eng, fps, launches = run_main_path(cfg, images, dev)
    say(f"main path: {fps:.3f} frames/s over frames {FPS_FIRST}-{N_FRAMES - 1} on {smi}")
    check_main_path(eng, scene, launches)
    err_c, rel_c, prob = check_schur(eng, cfg, dev)
    times = kernel_times(images, cfg, prob, dev)
    errs = {"fast_nms_rank": err_a, "hamming_best2": err_b, "schur_reduce": err_c}
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        ms, plain_ms = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
        })
    kernels[-1]["direct_max_rel_err"] = rel_c
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
