"""The measuring helpers of ``chip_smoke.py`` and ``profile_main_path``.

Tolerances: exact (interval arithmetic on given numbers, one division).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from dialog_tpu_torch import profile_main_path as pm

torch.set_num_threads(2)


def _event(start_us, end_us, device=True):
    kind = torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU
    return SimpleNamespace(device_type=kind, time_range=SimpleNamespace(start=start_us, end=end_us))


def test_busy_seconds_is_the_union_of_device_intervals():
    events = [_event(0, 10), _event(5, 12), _event(6, 8), _event(20, 25), _event(0, 100, device=False)]
    assert pm._busy_seconds(events) == pytest.approx(17e-6)
    assert pm._busy_seconds([]) == 0.0


def test_idle_gaps_go_to_the_innermost_span_open_at_their_midpoint():
    device = [(0, 10), (30, 40), (45, 50), (90, 95), (200, 210)]
    ranges = {"slam::track_step": [(5, 100)], "slam::pose_opt": [(20, 60)], "slam::keyframe": [(150, 160)]}
    gaps = pm.idle_by_span(device, ranges)
    # 10-30 and 40-45 inside pose_opt (the shorter of the two open), 50-90 at 70 inside track_step
    # alone, 95-200 at 147 inside neither
    assert gaps == pytest.approx({"slam::pose_opt": 25e-9, "slam::track_step": 40e-9, pm.OUTSIDE_SPANS: 105e-9})
    assert pm.idle_by_span([], ranges) == {}


def test_read_profile_holds_the_ports_spans_by_name():
    from torch.profiler import ProfilerActivity, profile

    from dialog_tpu_torch.instrument import span

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with span("slam::outer"), span("slam::inner"):
                torch.ones(4).sum()
    r = pm.read_profile(prof)
    assert r["host"]["slam::outer"][0] == r["host"]["slam::inner"][0] == 3
    assert r["host"]["slam::outer"][1] >= r["host"]["slam::inner"][1] > 0
    assert r["device_kernels"] == 0 and r["idle_by_span"] == {}


def test_rel_err_scales_by_the_largest_magnitude():
    want = torch.tensor([[1.0, 1e-6], [2.0, 4.0]])
    got = want + torch.tensor([[0.0, 1e-5], [0.0, 0.0]])
    # a difference on a near-zero entry counts against the output's largest entry
    assert chip_smoke._rel_err(got, want, per_block=False) == pytest.approx(1e-5 / 4.0)
    # block by block: against the largest entry of its own row
    assert chip_smoke._rel_err(got, want, per_block=True) == pytest.approx(1e-5 / 1.0)
    assert chip_smoke._rel_err(torch.zeros_like(want), want, per_block=False) == 1.0


def test_main_path_workload_is_the_tum_mono_configuration():
    cfg = pm.tum_mono_config()
    assert (cfg.width, cfg.height, cfg.n_features, cfg.max_features, cfg.n_levels) == (640, 480, 1000, 1024, 8)
    assert (cfg.max_local_kfs, cfg.max_fixed_kfs, cfg.max_local_lms, cfg.max_obs_per_lm) == (16, 16, 2048, 8)
    assert (pm.N_FRAMES, pm.FPS_FIRST) == (56, 16)


def test_stereo_and_rgbd_workloads():
    """The stereo path is bench.py's kitti_stereo cell at full width; the RGB-D
    path the TUM-class mono configuration with TUM1.yaml's depth settings."""
    st = pm.kitti_stereo_config()
    assert (st.width, st.height, st.n_features, st.max_features, st.bf) == (1241, 376, 2000, 2048, 386.1448)
    assert (st.max_local_kfs + st.max_fixed_kfs, st.max_local_lms, st.max_obs_per_lm) == (64, 8192, 12)
    assert (st.max_keyframes, st.max_landmarks, st.local_ba_iters, st.sensor.name) == (256, 32768, 8, "STEREO")
    rg = pm.tum_rgbd_config()
    assert (rg.sensor.name, rg.bf, rg.th_depth, rg.depth_map_factor) == ("RGBD", 40.0, 40.0, 5000.0)
    assert (rg.width, rg.height, rg.max_local_lms) == (640, 480, 2048)
    # the scaled sweep lies within th_depth x baseline, so the first frame spawns landmarks
    scene, frames = pm.render_rgbd_frames(rg, n=1)
    Xc = scene.xyz @ scene.R[0].T + scene.t[0]
    assert float(np.mean(Xc[:, 2] < rg.th_depth * rg.baseline)) > 0.7
    img, depth = frames[0]
    assert img.shape == depth.shape == (480, 640) and float(depth.max()) < 3.5 * rg.depth_map_factor
    assert set(pm.WORKLOADS) == {"mono", "stereo", "rgbd"}


def test_stereo_kernel_arguments_follow_the_problem():
    prob = SimpleNamespace(obs_ur=None)
    cfg = SimpleNamespace(bf=386.1448, chi2_stereo=7.815)
    assert chip_smoke._stereo_kw(prob, cfg) == {}
    prob = SimpleNamespace(obs_ur=torch.zeros(2, 3))
    kw = chip_smoke._stereo_kw(prob, cfg)
    assert kw["bf"] == 386.1448 and kw["delta2_stereo"] == 7.815 and kw["obs_ur"] is prob.obs_ur
