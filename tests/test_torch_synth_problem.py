"""Parity of the port's synthetic BA problem generator with ``dialog_tpu``'s.

Tolerances: the integer and boolean fields and the observations are equal
(numpy draws in the same order); poses and points within 1e-6 (one f32
retraction, computed by each package's own ``se3_retract``). A solve from the
generated start returns to the ground truth by the reference's own bounds
(``tests/test_local_ba.py``): poses within 2e-2 and the median point error
below 2e-2 after 10 iterations, the noise floor at 0.4 px.
"""

import numpy as np
import pytest
import torch

from dialog_tpu.config import EngineConfig as JConfig
from dialog_tpu.optim import synth_problem as jsp
from dialog_tpu_torch.config import KITTI00, EngineConfig
from dialog_tpu_torch.optim import synth_problem as tsp
from dialog_tpu_torch.optim.local_ba import solve_ba

torch.set_num_threads(2)

STEREO = dict(max_local_kfs=8, max_fixed_kfs=4, max_local_lms=128, max_obs_per_lm=8, bf=40.0)
CASES = {
    "mono": (dict(seed=0), {}),
    "mono-more-cameras": (dict(seed=3, n_cams=10, n_pts=90), {}),
    "stereo": (dict(seed=1, stereo_frac=0.6), STEREO),
    "stereo-all": (dict(seed=2, stereo_frac=1.0, n_cams=5, n_pts=40), STEREO),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_make_problem_matches_reference(case):
    kw, cfg_kw = CASES[case]
    jcfg = JConfig(**cfg_kw) if cfg_kw else jsp.FIXTURE_CFG
    tcfg = EngineConfig(**cfg_kw) if cfg_kw else tsp.FIXTURE_CFG
    want = jsp.make_problem(cfg=jcfg, **kw)
    got = tsp.make_problem(cfg=tcfg, device="cpu", **kw)
    for w, g in zip(want[1:4], got[1:4]):   # ground truth: numpy on both sides
        np.testing.assert_array_equal(w, g)
    assert want[4:] == got[4:]
    for name in tsp.BAProblem._fields:
        w, g = getattr(want[0], name), getattr(got[0], name)
        if w is None or g is None:
            assert w is None and g is None, name
            continue
        w, g = np.asarray(w), g.numpy()
        assert w.shape == g.shape and w.dtype == g.dtype, name
        if name in ("R", "t"):
            np.testing.assert_allclose(w, g, atol=1e-6, rtol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(w, g, err_msg=name)
    if "stereo_frac" in kw:
        ur = got[0].obs_ur[got[0].obs_ok]
        assert 0.3 < float((ur >= 0).float().mean()) <= 1.0


def test_make_problem_defaults_to_the_card():
    assert tsp.make_problem(device="cpu")[0].xyz.device.type == "cpu"
    if torch.cuda.is_available():
        assert tsp.make_problem()[0].xyz.device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):   # PyTorch's own allocation refuses
            tsp.make_problem()


@pytest.mark.parametrize("stereo", [False, True], ids=["mono", "stereo"])
def test_solve_from_the_generated_start_returns_to_the_truth(stereo):
    cfg = EngineConfig(**STEREO) if stereo else tsp.FIXTURE_CFG
    prob, Rs, ts, pts, n_cams, n_pts = tsp.make_problem(seed=4, cfg=cfg, stereo_frac=0.5 if stereo else 0.0,
                                                        device="cpu")
    R, t, xyz, cost = solve_ba(prob, cfg, iters=10)
    start = float((prob.xyz[:n_pts] - torch.from_numpy(pts)).abs().max())
    assert start > 0.1
    assert float((R[:n_cams] - torch.from_numpy(Rs)).abs().max()) < 2e-2
    assert float((t[:n_cams] - torch.from_numpy(ts)).abs().max()) < 2e-2
    assert float((xyz[:n_pts] - torch.from_numpy(pts)).norm(dim=1).median()) < 2e-2
    assert bool(torch.isfinite(cost))


def test_seeded_windows_have_the_paths_shapes():
    """``chip_smoke.py`` takes kernel C's solve windows from the generator at
    the engines' capacities: C=32, P=2048, O=8 (mono), C=64, P=8192, O=12 with
    a right-x on about half the observations (stereo)."""
    import chip_smoke
    from dialog_tpu_torch import profile_main_path as pm

    mono, _ = chip_smoke.seeded_window(pm.tum_mono_config(), "cpu")
    assert (mono.R.shape[0], *mono.obs_cam.shape) == (32, 2048, 8) and mono.obs_ur is None
    assert (int(mono.obs_ok.sum()), int(mono.cam_opt.sum())) == (2000, 9)
    st, _ = chip_smoke.seeded_window(pm.kitti_stereo_config(), "cpu")
    assert pm.kitti_stereo_config().bf == KITTI00.bf
    assert (st.R.shape[0], *st.obs_cam.shape) == (64, 8192, 12)
    assert (int(st.obs_ok.sum()), int(st.cam_opt.sum())) == (2916, 4)
    share = float((st.obs_ur[st.obs_ok] >= 0).float().mean())
    assert 0.45 < share < 0.55
