"""Kernels A, B and C on the card against their plain PyTorch versions.

These tests need an NVIDIA GPU and skip without one. They import no JAX, so
they also run where only PyTorch is installed; the repository's conftest
imports JAX, so on such a machine skip it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: A and B are integer and min/max computations, bit-exact. C sums
in another order than the plain version: its direct outputs within 1e-4 of
each output's largest magnitude on a well-conditioned problem, bitwise equal
from run to run, and a 5-iteration ``solve_ba`` within the reference's
``kernels/selfcheck`` bounds (R and t 2e-3, xyz 5e-3); the same for its
stereo variant, with a right-x on half the observations.
"""

import numpy as np
import pytest
import torch

from dialog_tpu_torch import frontend as fe
from dialog_tpu_torch import geometry as geo
from dialog_tpu_torch.config import EngineConfig
from dialog_tpu_torch.datasets import synth
from dialog_tpu_torch.kernels import common
from dialog_tpu_torch.kernels import fast, hamming, schur
from dialog_tpu_torch.optim.local_ba import BAProblem, solve_ba

pytestmark = pytest.mark.cuda
torch.set_num_threads(2)

CFG = EngineConfig(width=640, height=480, n_features=1000, max_features=1024, max_local_kfs=16,
                   max_fixed_kfs=16, max_local_lms=2048, max_obs_per_lm=8)
STEREO_CFG = CFG.replace(bf=CFG.fx * 0.12)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ba_problem(dev, seed=0, n_cams=12, n_pts=1500, stereo_frac=0.0):
    """Cameras on an arc observing a box of points, poses and points perturbed;
    with ``stereo_frac`` that share of the observations carries a right-x."""
    rng = np.random.default_rng(seed)
    C, P, O = CFG.max_local_kfs + CFG.max_fixed_kfs, CFG.max_local_lms, CFG.max_obs_per_lm
    pts = np.stack([rng.uniform(-3, 3, n_pts), rng.uniform(-2, 2, n_pts), rng.uniform(6, 10, n_pts)], -1)
    R = np.tile(np.eye(3), (C, 1, 1))
    t = np.zeros((C, 3))
    for c in range(n_cams):
        eye = np.array([(c / (n_cams - 1) - 0.5) * 4.0, 0.1, 0.0])
        fwd = np.array([0.0, 0.0, 8.0]) - eye
        fwd /= np.linalg.norm(fwd)
        right = np.cross(fwd, [0, -1, 0])
        right /= np.linalg.norm(right)
        R[c] = np.stack([right, np.cross(fwd, right), fwd])
        t[c] = -R[c] @ eye
    obs_cam = np.full((P, O), C, np.int32)
    obs_uv = np.zeros((P, O, 2))
    obs_z = np.ones((P, O))
    for p in range(n_pts):
        for o, c in enumerate(rng.choice(n_cams, O, replace=False)):
            Xc = R[c] @ pts[p] + t[c]
            obs_cam[p, o] = c
            obs_z[p, o] = Xc[2]
            obs_uv[p, o] = [CFG.fx * Xc[0] / Xc[2] + CFG.cx, CFG.fy * Xc[1] / Xc[2] + CFG.cy]
    obs_uv += rng.normal(0, 0.5, obs_uv.shape)
    obs_ur = obs_uv[..., 0] - STEREO_CFG.bf / obs_z + rng.normal(0, 0.5, obs_z.shape)
    obs_ur = np.where(rng.random(obs_z.shape) < stereo_frac, obs_ur, -1.0)
    ok = obs_cam < C
    cam_opt = np.zeros(C, bool)
    cam_opt[2:n_cams] = True
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    Rt, tt = geo.se3_retract(f32(R), f32(t), f32(rng.normal(0, 0.02, (C, 6)) * cam_opt[:, None]))
    xyz = np.zeros((P, 3))
    xyz[:n_pts] = pts + rng.normal(0, 0.05, pts.shape)
    return BAProblem(
        cam_slots=torch.arange(C, dtype=torch.int32, device=dev), cam_opt=torch.tensor(cam_opt, device=dev),
        R=Rt.contiguous(), t=tt.contiguous(), lm_ids=torch.arange(P, dtype=torch.int32, device=dev),
        xyz=f32(xyz), obs_cam=torch.tensor(obs_cam, device=dev), obs_uv=f32(obs_uv), obs_w=f32(ok * 1.0),
        obs_ok=torch.tensor(ok, device=dev), obs_feat=torch.zeros((P, O), dtype=torch.int32, device=dev),
        obs_ur=f32(np.where(ok, obs_ur, -1.0)) if stereo_frac > 0 else None,
    )


def _reduce_args(prob, lam):
    return (prob.R, prob.t, prob.cam_opt, prob.xyz, prob.obs_cam, prob.obs_uv, prob.obs_w, lam,
            CFG.fx, CFG.fy, CFG.cx, CFG.cy, CFG.chi2_mono)


def test_fast_kernel_bit_exact_on_pyramid(cuda):
    scene = synth.make_scene(seed=3, n_points=2500, n_frames=168, cfg=CFG)
    img = torch.from_numpy(synth.render_image(scene, 5)).to(cuda)
    rnd = torch.from_numpy(np.random.default_rng(2).uniform(0, 255, (123, 210)).astype(np.float32)).to(cuda)
    cases = [(lvl, 7.0, 20.0, fe.BORDER) for lvl in fe.build_pyramid(img, CFG)]
    cases += [(rnd, 7.0, 20.0, 19), (rnd, 3.0, 10.0, 8)]
    before = common.launches["fast_nms_rank"]
    for im, min_th, th_fast, border in cases:
        got = fast.fast_nms_rank(im, min_th, th_fast, border)
        want = fast.fast_nms_rank_plain(im, min_th, th_fast, border)
        torch.cuda.synchronize()
        assert torch.equal(got, want), tuple(im.shape)
    assert common.launches["fast_nms_rank"] == before + len(cases)


@pytest.mark.parametrize("case", ["plain", "spatial", "spatial+oct", "col-radius"])
def test_hamming_kernel_bit_exact(cuda, case):
    rng = np.random.default_rng(11)
    n, m = 2048, 1024
    to = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    a = to(rng.integers(0, 2**32, (n, 8), dtype=np.uint32).view(np.int32))
    b = to(rng.integers(0, 2**32, (m, 8), dtype=np.uint32).view(np.int32))
    va, vb = to(rng.random(n) > 0.1), to(rng.random(m) > 0.1)
    uva, uvb = to(rng.uniform(0, 640, (n, 2)).astype(np.float32)), to(rng.uniform(0, 640, (m, 2)).astype(np.float32))
    r2, r2c = to((rng.uniform(20, 200, n) ** 2).astype(np.float32)), to((rng.uniform(20, 200, m) ** 2).astype(np.float32))
    oa, ob = to(rng.integers(0, 8, n).astype(np.int32)), to(rng.integers(0, 8, m).astype(np.int32))
    kw = {"plain": {}, "spatial": dict(uv_a=uva, uv_b=uvb, radius2=r2),
          "spatial+oct": dict(uv_a=uva, uv_b=uvb, radius2=r2, oct_a=oa, oct_b=ob, octave_band=1),
          "col-radius": dict(uv_a=uva, uv_b=uvb, radius2_cols=r2c)}[case]
    got = hamming.hamming_best2(a, b, va, vb, **kw)
    filled = hamming._defaults(a, b, kw.get("uv_a"), kw.get("uv_b"), kw.get("radius2"), kw.get("radius2_cols"),
                               kw.get("oct_a"), kw.get("oct_b"))
    want = hamming.hamming_best2_plain(a, b, va, vb, *filled, kw.get("octave_band", -1))
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_hamming_kernel_ties_go_to_lowest_column(cuda):
    a = torch.from_numpy(np.random.default_rng(7).integers(0, 2**32, (8, 8), dtype=np.uint32).view(np.int32)).to(cuda)
    idx, best, second = hamming.hamming_best2(a, torch.cat([a, a]), torch.ones(8, dtype=torch.bool, device=cuda),
                                              torch.ones(16, dtype=torch.bool, device=cuda))
    assert idx.cpu().tolist() == list(range(8))
    assert int(best.abs().sum()) == 0 and int(second.abs().sum()) == 0


def test_schur_kernel_matches_plain_and_repeats(cuda):
    prob = _ba_problem(cuda)
    lam = torch.tensor(1e-3, device=cuda)
    got = schur.schur_reduce(*_reduce_args(prob, lam))
    again = schur.schur_reduce(*_reduce_args(prob, lam))
    want = schur.schur_reduce_plain(*_reduce_args(prob, lam))
    torch.cuda.synchronize()
    for name, g, w in zip(["Hll_inv", "g_l", "Y", "Hcc", "g_c", "g_red", "S_pair"], got, want):
        assert g.shape == w.shape, name
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max()), name
    assert all(torch.equal(g, h) for g, h in zip(got, again))


def test_schur_kernel_solve_matches_plain_solve(cuda):
    prob = _ba_problem(cuda, seed=1)
    Rk, tk, xk, _ = solve_ba(prob, CFG, iters=5, chi2_th=CFG.chi2_mono)
    prob_cpu = BAProblem(*[x.cpu() if isinstance(x, torch.Tensor) else x for x in prob])
    Rp, tp, xp, _ = solve_ba(prob_cpu, CFG, iters=5, chi2_th=CFG.chi2_mono)
    assert float((Rk.cpu() - Rp).abs().max()) < 2e-3
    assert float((tk.cpu() - tp).abs().max()) < 2e-3
    assert float((xk.cpu() - xp).abs().max()) < 5e-3


def test_schur_kernel_stereo_matches_plain_and_repeats(cuda):
    prob = _ba_problem(cuda, seed=2, stereo_frac=0.5)
    lam = torch.tensor(1e-3, device=cuda)
    st = dict(obs_ur=prob.obs_ur, bf=STEREO_CFG.bf, delta2_stereo=STEREO_CFG.chi2_stereo)
    before = dict(common.launches)
    got = schur.schur_reduce(*_reduce_args(prob, lam), **st)
    again = schur.schur_reduce(*_reduce_args(prob, lam), **st)
    want = schur.schur_reduce_plain(*_reduce_args(prob, lam), **st)
    mono = schur.schur_reduce_plain(*_reduce_args(prob, lam))
    torch.cuda.synchronize()
    assert common.launches["schur_reduce_stereo"] == before["schur_reduce_stereo"] + 2
    assert common.launches["schur_reduce"] == before["schur_reduce"]
    n_pts = 1500
    for k, (name, g, w, m) in enumerate(zip(["Hll_inv", "g_l", "Y", "Hcc", "g_c", "g_red", "S_pair"],
                                            got, want, mono)):
        assert g.shape == w.shape, name
        if k < 3:   # per-landmark outputs: the observed landmarks (padding holds 1/1e-9)
            g, w, m = g[:n_pts], w[:n_pts], m[:n_pts]
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-4 * scale, name
        assert float((m - w).abs().max()) > 1e-2 * scale, name   # the uR rows count
    assert all(torch.equal(g, h) for g, h in zip(got, again))


def test_schur_kernel_stereo_solve_matches_plain_solve(cuda):
    prob = _ba_problem(cuda, seed=3, stereo_frac=0.5)
    Rk, tk, xk, _ = solve_ba(prob, STEREO_CFG, iters=5, chi2_th=CFG.chi2_mono)
    prob_cpu = BAProblem(*[x.cpu() if isinstance(x, torch.Tensor) else x for x in prob])
    Rp, tp, xp, _ = solve_ba(prob_cpu, STEREO_CFG, iters=5, chi2_th=CFG.chi2_mono)
    assert float((Rk.cpu() - Rp).abs().max()) < 2e-3
    assert float((tk.cpu() - tp).abs().max()) < 2e-3
    assert float((xk.cpu() - xp).abs().max()) < 5e-3


def test_schur_kernel_raises_where_it_has_no_path(cuda):
    prob = _ba_problem(cuda, n_pts=50)
    lam = torch.tensor(1e-3, device=cuda)
    with pytest.raises(ValueError):
        schur.schur_reduce(*_reduce_args(prob, lam), lm_opt=torch.ones(prob.xyz.shape[0], dtype=torch.bool,
                                                                        device=cuda))


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    with pytest.raises(ValueError):
        fast.fast_nms_rank(torch.zeros((64, 64), dtype=torch.float64, device=cuda), 7.0, 20.0, 19)
    a = torch.zeros((16, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        hamming.hamming_best2(a, a, torch.ones(16, device=cuda), torch.ones(16, dtype=torch.bool, device=cuda))
