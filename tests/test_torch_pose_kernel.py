"""The pose LM kernel's dispatch, on the CPU (the kernel itself runs only on
the card: ``tests/test_torch_cuda.py``).

* ``kernels/pose.py`` imports with no CUDA, and its wrapper raises, without
  building anything, when given CPU tensors.
* ``pose_optimization`` on CPU tensors takes the plain loop: one
  ``slam::pose_opt`` span, ``rounds x iters`` ``slam::lm_iter`` spans, no
  pose LM launch counted, and ``pose_optimization_plain``'s answer bit for
  bit, mono and stereo, on the problems the card tests use (outliers, points
  behind the camera, no valid observation, none at all).
* ``kernels/common.route`` raises for a device that is neither the CPU nor
  CUDA, and so does ``pose_optimization``.
"""

import importlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dialog_tpu_torch.kernels import common
from dialog_tpu_torch.optim import pose_only
from dialog_tpu_torch.optim.synth_problem import make_pose_problem

torch.set_num_threads(2)


def test_pose_kernel_module_imports_without_cuda():
    mod = importlib.import_module("dialog_tpu_torch.kernels.pose")
    p = make_pose_problem(seed=0, n=16, device="cpu")
    with pytest.raises(ValueError):
        mod.pose_lm(p["R0"], p["t0"], p["X"], p["uv"], p["inv_sigma2"], p["valid"], 500.0, 500.0, 320.0, 240.0,
                    5.991, 2, 6)
    assert common.launches["pose_lm"] == 0


@pytest.mark.parametrize("stereo", [False, True], ids=["mono", "stereo"])
@pytest.mark.parametrize("rounds,iters", [(2, 6), (4, 10)])
@pytest.mark.parametrize("case", ["plain", "outliers", "behind", "none-valid", "no-observation"])
def test_cpu_call_takes_the_plain_loop(stereo, rounds, iters, case):
    kw = {"plain": {}, "outliers": dict(outlier_share=0.3), "behind": dict(n_behind=60),
          "none-valid": dict(valid_share=0.0), "no-observation": dict(n=0)}[case]
    p = make_pose_problem(**{"seed": 3, "n": 200, "stereo": stereo, "device": "cpu", **kw})
    chi2 = 7.815 if stereo else 5.991
    common.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = pose_only.pose_optimization(**p, chi2_th=chi2, rounds=rounds, iters=iters)
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("slam::pose_opt") == 1
    assert names.count("slam::lm_iter") == rounds * iters
    assert sum(common.launches.values()) == 0
    want = pose_only.pose_optimization_plain(**p, chi2_th=chi2, rounds=rounds, iters=iters)
    for a, b in zip(got, want):
        assert a.device.type == "cpu" and torch.equal(a, b)
    if case in ("none-valid", "no-observation"):
        assert int(got.n_inliers) == 0 and float(got.cost) == 0.0 and torch.equal(got.t, p["t0"])
    else:
        assert int(got.n_inliers) > 0.5 * int(p["valid"].sum())


def test_route_raises_for_another_device():
    x = torch.empty(3, device="meta")
    with pytest.raises(ValueError):
        common.route(x)
    p = make_pose_problem(seed=0, n=16, device="meta")
    with pytest.raises(ValueError):
        pose_only.pose_optimization(**p)
    assert sum(common.launches.values()) == 0
