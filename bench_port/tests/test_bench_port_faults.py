"""The output check fails a run whose timed path is broken underneath, and fails the TF32 control.

Each fault is planted in the port's module before the harness wraps it, so the
harness's probes see the broken answer where it is produced. The cells run on
one card and have no exchange between cards, so that fault has no case here.
"""

from __future__ import annotations

import json

import pytest
import torch

from bench_port import checks, run
from bench_port.tests import tiny

torch.set_num_threads(2)
SEED = 2**31 + 99


def tiny_run(workload: str, seconds: float = 6.0, control: bool = False) -> dict:
    cfg, tr = workload.split(".")
    return run.run_cell(tiny.bench(), workload, SEED, seconds, False, "cpu", control=control,
                        conf=tiny.config(cfg), traffic=tiny.traffic(tr), limits=tiny.limits(workload))


def _step_unchanged(monkeypatch):
    from dialog_tpu_torch import tracking
    from dialog_tpu_torch.optim.pose_only import PoseOptResult

    def frozen(R0, t0, X, uv, inv_sigma2, valid, *a, **k):
        return PoseOptResult(R=R0, t=t0, inlier=valid, n_inliers=valid.sum(), cost=torch.zeros(()))

    monkeypatch.setattr(tracking, "pose_optimization", frozen)


def _pose_moved(monkeypatch):
    from dialog_tpu_torch import tracking

    orig = tracking.pose_optimization

    def moved(*a, **k):
        res = orig(*a, **k)
        return res._replace(t=res.t + 0.01)   # 1 cm off: 0.2-0.6 px at 4-12 m

    monkeypatch.setattr(tracking, "pose_optimization", moved)


def _pose_chi2_changed(monkeypatch):
    from dialog_tpu_torch import tracking

    orig = tracking.pose_optimization

    def changed(*a, **k):
        return orig(*a, **dict(k, chi2_th=k["chi2_th"] * 0.5))

    monkeypatch.setattr(tracking, "pose_optimization", changed)


def _descriptor_altered(monkeypatch):
    from dialog_tpu_torch import system

    orig = system.extract_features

    def altered(img, cfg):
        f = orig(img, cfg)
        return f._replace(desc=f.desc ^ 1)

    monkeypatch.setattr(system, "extract_features", altered)


def _schur_altered(monkeypatch):
    from dialog_tpu_torch.kernels import schur

    orig = schur.schur_reduce

    def altered(*a, **k):
        out = list(orig(*a, **k))
        out[6] = out[6] * 1.01   # S_pair
        return tuple(out)

    monkeypatch.setattr(schur, "schur_reduce", altered)


def _schur_landmark_altered(monkeypatch):
    from dialog_tpu_torch.kernels import schur

    orig = schur.schur_reduce

    def altered(*a, **k):
        out = list(orig(*a, **k))
        out[2] = out[2] * 1.01   # Y, which only the landmarks' back-substitution reads
        return tuple(out)

    monkeypatch.setattr(schur, "schur_reduce", altered)


def _match_altered(monkeypatch):
    from dialog_tpu_torch import matching

    orig = matching.mutual_match_fused

    def altered(*a, **k):
        match, best = orig(*a, **k)
        return torch.where(match >= 0, (match + 1) % a[1].shape[0], match).to(match.dtype), best

    monkeypatch.setattr(matching, "mutual_match_fused", altered)


def _half_batch(monkeypatch):
    from dialog_tpu_torch import system

    orig = system.Engine.track_batch

    def half(self, frames, timestamps):
        n = len(timestamps) // 2
        return orig(self, type(frames)(*[x[:n] for x in frames]), list(timestamps)[:n])

    monkeypatch.setattr(system.Engine, "track_batch", half)


def _right_x_altered(monkeypatch):
    from dialog_tpu_torch import stereo

    orig = stereo.stereo_match_frames

    def altered(*a, **k):
        f = orig(*a, **k)
        return f._replace(u_right=torch.where(f.u_right >= 0, f.u_right + 0.05, f.u_right))

    monkeypatch.setattr(stereo, "stereo_match_frames", altered)


FAULTS = {
    "step_returns_its_state": ("tum1_mono.online", _step_unchanged, ("pose_px", "pose_split", "stuck")),
    "descriptor_altered": ("tum1_mono.online", _descriptor_altered, ("desc_bit_err",)),
    "schur_altered": ("tum1_mono.online", _schur_altered, ("schur_terms_err",)),
    "schur_landmark_side_altered": ("tum1_mono.batch8", _schur_landmark_altered, ("schur_lm_err",)),
    "pose_answer_moved": ("tum1_mono.batch8", _pose_moved, ("pose_px",)),
    "pose_chi2_changed.batched": ("tum1_mono.batch8", _pose_chi2_changed, ("pose_split",)),
    "pose_chi2_changed.online": ("tum1_mono.online", _pose_chi2_changed, ("pose_split",)),
    "match_altered": ("tum1_mono.online", _match_altered, ("match_mismatch",)),
    "half_the_batch_left_out": ("kitti00_stereo.batch8", _half_batch, ("unanswered",)),
    "right_x_altered": ("kitti00_stereo.batch8", _right_x_altered, ("ur_err",)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    workload, plant, expected = FAULTS[fault]
    plant(monkeypatch)
    try:
        res = tiny_run(workload)
    except RuntimeError as e:   # a fault that stops the set-up fails the run outright
        assert "set-up" in str(e)
        return
    assert res["correct"] is False
    failing = {k for k, (v, lim) in res["checks"].items() if not v <= lim}
    assert failing & set(expected), res["checks"]


def test_the_tf32_control_fails_the_check(capsys):
    res = tiny_run("tum1_mono.online", control=True)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith('{"readings"')]
    control = lines[-1]["control"]["tf32"]
    ok, table = checks.verdict(control, tiny.limits("tum1_mono.online"))
    assert res["correct"] and not ok, table
