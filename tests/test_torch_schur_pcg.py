"""The port's matrix-free Schur PCG (``dialog_tpu_torch/optim/schur_pcg.py``).

Mirrors ``tests/test_schur_pcg.py`` on the port: one near-undamped step equals
the port's dense ``solve_ba`` within 1e-4, the CG's early exit at least halves
the fixed budget, ground truth is recovered by the reference's bounds, frozen
cameras stay where they are. Against ``dialog_tpu``'s ``solve_ba_pcg`` on the
same problem (the reference's seeded ``make_problem`` carried over through
numpy), over the first three LM iterations, where each accepted step lowers
the cost by far more than the f32 rounding of its sum: R, t and landmarks
within 1e-4, the same CG iteration count within two, the cost within 1e-5
relative. Past convergence the accept rule compares costs that differ by
less than that rounding (about 1e-5 relative over a few hundred
observations), and either package may take or refuse a last step of a few
1e-4 along a flat direction (0.00029 in t on the seed-0 problem after ten
iterations): there the costs agree within 1e-5 and the states within 1e-3.

The device-side exit: reading the exit flag after every iteration or once
in 48 gives the same bits, and ``lm_init_pcg`` + n ``lm_steps_pcg`` is
``solve_ba_pcg(iters=n)`` bit for bit. A forced small slab agrees with the
unchunked solve within 1e-4, the reference parity's own bound: the slabs'
camera sums add in another order (6.9e-5 in t after four iterations).
"""

import jax
import numpy as np
import pytest
import torch

from dialog_tpu.config import EngineConfig as JConfig
from dialog_tpu.optim import synth_problem as jsp
from dialog_tpu.optim.schur_pcg import solve_ba_pcg as jsolve_ba_pcg
from dialog_tpu_torch.config import EngineConfig
from dialog_tpu_torch.interop import problem_from_numpy
from dialog_tpu_torch.optim import schur_pcg
from dialog_tpu_torch.optim.local_ba import solve_ba
from dialog_tpu_torch.optim.schur_pcg import lm_init_pcg, lm_steps_pcg, solve_ba_pcg
from dialog_tpu_torch.optim.synth_problem import FIXTURE_CFG as CFG, make_problem

torch.set_num_threads(2)

STEREO = dict(max_local_kfs=8, max_fixed_kfs=4, max_local_lms=128, max_obs_per_lm=8, bf=40.0)


def test_one_step_matches_dense():
    """One near-undamped LM step: the PCG equals the dense Schur solve (CG
    is exact once its iterations reach the reduced system's dimension)."""
    prob, _, _, _, _, n_pts = make_problem(seed=3, n_cams=4, n_pts=20, noise_px=0.0, perturb=0.01, device="cpu")
    R_d, t_d, xyz_d, _ = solve_ba(prob, CFG, iters=1, lam0=1e-7)
    R_p, t_p, xyz_p, _ = solve_ba_pcg(prob, CFG, iters=1, lam0=1e-7, cg_iters=24, cg_tol=0.0)
    np.testing.assert_allclose(R_p.numpy(), R_d.numpy(), atol=1e-4)
    np.testing.assert_allclose(t_p.numpy(), t_d.numpy(), atol=1e-4)
    np.testing.assert_allclose(xyz_p.numpy()[:n_pts], xyz_d.numpy()[:n_pts], atol=1e-4)


def test_cg_early_exit_at_least_halves_the_budget():
    prob = make_problem(device="cpu")[0]
    *_, n_cg = solve_ba_pcg(prob, CFG, iters=10, cg_iters=48, return_cg_iters=True)
    assert n_cg.dtype == torch.int32
    assert 0 < int(n_cg) < 10 * 48 // 2, int(n_cg)


def test_recovers_ground_truth():
    prob, Rs, ts, pts, n_cams, n_pts = make_problem(device="cpu")
    R, t, xyz, _ = solve_ba_pcg(prob, CFG, iters=15, cg_iters=48)
    R, t, xyz = R.numpy(), t.numpy(), xyz.numpy()
    for c in range(2, n_cams):
        ang = np.degrees(np.arccos(np.clip((np.trace(R[c] @ Rs[c].T) - 1) / 2, -1, 1)))
        assert ang < 0.15, (c, ang)
        assert np.linalg.norm(t[c] - ts[c]) < 0.02, c
    assert np.median(np.linalg.norm(xyz[:n_pts] - pts, axis=1)) < 0.02


def test_fixed_cameras_unchanged():
    prob, Rs, ts, *_ = make_problem(device="cpu")
    R, t, _, _ = solve_ba_pcg(prob, CFG, iters=5)
    np.testing.assert_allclose(R.numpy()[0], Rs[0], atol=1e-6)
    np.testing.assert_allclose(t.numpy()[1], ts[1], atol=1e-6)


CASES = {
    "mono": (dict(seed=0), {}, dict(iters=3)),
    "mono-noisier": (dict(seed=7, noise_px=1.0), {}, dict(iters=3)),
    "mono-more-cameras": (dict(seed=3, n_cams=10, n_pts=90), {}, dict(iters=3, cg_iters=16, cg_tol=1e-4)),
    "stereo": (dict(seed=1, stereo_frac=0.6), STEREO, dict(iters=3)),
    "mono-converged": (dict(seed=0), {}, dict(iters=10)),
    "stereo-converged": (dict(seed=1, stereo_frac=0.6), STEREO, dict(iters=10)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_reference(case):
    kw, cfg_kw, solve_kw = CASES[case]
    converged = case.endswith("converged")
    tol = 1e-3 if converged else 1e-4
    jcfg = JConfig(**cfg_kw) if cfg_kw else jsp.FIXTURE_CFG
    tcfg = EngineConfig(**cfg_kw) if cfg_kw else CFG
    jprob, _, _, _, _, n_pts = jsp.make_problem(cfg=jcfg, **kw)
    prob = problem_from_numpy(jax.device_get(jprob), device="cpu")
    want = jsolve_ba_pcg(jprob, jcfg, chi2_th=jcfg.chi2_mono, return_cg_iters=True, **solve_kw)
    got = solve_ba_pcg(prob, tcfg, chi2_th=tcfg.chi2_mono, return_cg_iters=True, **solve_kw)
    for name, w, g in zip(["R", "t"], want[:2], got[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol, err_msg=name)
    np.testing.assert_allclose(got[2].numpy()[:n_pts], np.asarray(want[2])[:n_pts], atol=tol)
    assert float(got[3]) == pytest.approx(float(want[3]), rel=1e-5)
    if not converged:
        assert abs(int(got[4]) - int(want[4])) <= 2, (int(got[4]), int(want[4]))


def test_device_side_exit_equals_an_exit_at_every_iteration(monkeypatch):
    prob = make_problem(seed=2, device="cpu")[0]
    outs = []
    for every in (1, 48):
        monkeypatch.setattr(schur_pcg, "CG_CHECK_EVERY", every)
        outs.append(solve_ba_pcg(prob, CFG, iters=4, return_cg_iters=True))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_steps_equal_the_one_shot_solve():
    prob = make_problem(seed=4, device="cpu")[0]
    want = solve_ba_pcg(prob, CFG, iters=5, return_cg_iters=True)
    carry = lm_init_pcg(prob, CFG)
    for n in (2, 1, 2):
        carry = lm_steps_pcg(prob, CFG, carry, n_iters=n)
    R, t, xyz, _, cost, cg_total = carry
    from dialog_tpu_torch.geometry import orthogonalize

    for a, b in zip(want, (orthogonalize(R), t, xyz, cost, cg_total)):
        assert torch.equal(a, b)


def test_small_slab_equals_unchunked(monkeypatch):
    prob, *_, n_pts = make_problem(seed=5, device="cpu")
    want = solve_ba_pcg(prob, CFG, iters=4, chunk=False)
    monkeypatch.setattr(schur_pcg, "SLAB_LMS", 24)   # P = 128: six slabs, the last one ragged
    got = solve_ba_pcg(prob, CFG, iters=4)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), atol=1e-4)
    np.testing.assert_allclose(got[2].numpy()[:n_pts], want[2].numpy()[:n_pts], atol=1e-4)
