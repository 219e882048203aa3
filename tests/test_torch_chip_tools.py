"""The measuring helpers of ``chip_smoke.py`` and ``profile_main_path``.

Tolerances: exact (interval arithmetic on given numbers, one division).
"""

from types import SimpleNamespace

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
