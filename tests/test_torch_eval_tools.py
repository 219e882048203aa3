"""The port's remaining evaluation tools against the reference's.

Tolerances: ``rpe``, ``rpe_rmse`` and ``kitti_odometry_errors`` are numpy
copies and equal the reference's exactly on seeded trajectories;
``make_sfm_problem`` equals the reference's bit for bit in every field but
the perturbed poses, which each package retracts with its own f32
``se3_retract`` (within 1e-6, as ``tests/test_torch_synth_problem.py``);
``vocab_recall`` at a reduced orbit (40-frame lap, two laps) with 256 and
512 words, fed the reference's own initial words (its ``jax.random`` draw,
replayed here), gives the reference's recall numbers. The render (ROADMAP
D19: the reference's content and view, not matplotlib's pixels) writes a PNG
of the reference's canvas and an SVG that parse back, with the trajectory's
colour at its projected pixels; ``bench_scaling`` prints its record and
writes a file only to ``--out``.
"""

import json
import os
import xml.etree.ElementTree as ET

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dialog_tpu.config import EngineConfig as JConfig
from dialog_tpu.eval import bench_scaling as jbench
from dialog_tpu.eval import rpe as jrpe
from dialog_tpu.eval import vocab_recall as jvr
from dialog_tpu_torch.cli import SYNTH_CONFIG
from dialog_tpu_torch.config import EngineConfig
from dialog_tpu_torch.datasets import png, synth
from dialog_tpu_torch.eval import bench_scaling, render, rpe, vocab_recall
from dialog_tpu_torch.eval.ate import align_umeyama
from dialog_tpu_torch.geometry import so3_exp
from dialog_tpu_torch.system import Engine

torch.set_num_threads(2)


def _trajectory(n, seed, step=1.0):
    """World->camera poses along a winding path, ``step`` metres a frame."""
    rng = np.random.default_rng(seed)
    yaw = np.cumsum(rng.normal(0, 0.03, n))
    C = np.cumsum(np.stack([np.sin(yaw), rng.normal(0, 0.01, n), np.cos(yaw)], -1) * step, 0)
    R = np.stack([so3_exp(torch.tensor([0.0, -y, 0.0], dtype=torch.float64)).numpy() for y in yaw])
    t = -np.einsum("nij,nj->ni", R, C)
    return R, t


@pytest.mark.parametrize("delta", [1, 5])
def test_rpe_equals_the_reference(delta):
    gR, gt = _trajectory(300, 0)
    eR, et = _trajectory(300, 0)
    rng = np.random.default_rng(1)
    et = et + np.cumsum(rng.normal(0, 0.02, et.shape), 0)
    eR = np.einsum("nij,njk->nik", np.stack([so3_exp(torch.from_numpy(w)).numpy()
                                             for w in rng.normal(0, 0.002, (300, 3))]), eR)
    for got, want in zip(rpe.rpe(eR, et, gR, gt, delta), jrpe.rpe(eR, et, gR, gt, delta)):
        np.testing.assert_array_equal(got, want)
    assert rpe.rpe_rmse(eR, et, gR, gt, delta) == jrpe.rpe_rmse(eR, et, gR, gt, delta)
    got = rpe.kitti_odometry_errors(eR, et, gR, gt)
    assert got == jrpe.kitti_odometry_errors(eR, et, gR, gt) and got[2] > 0
    assert rpe.kitti_odometry_errors(eR[:20], et[:20], gR[:20], gt[:20]) == (0.0, 0.0, 0)


@pytest.mark.parametrize("n_cams,n_pts", [(24, 700), (200, 300)])
def test_make_sfm_problem_equals_the_reference(n_cams, n_pts):
    want = jbench.make_sfm_problem(JConfig(max_obs_per_lm=8), n_cams, n_pts)
    got = bench_scaling.make_sfm_problem(EngineConfig(max_obs_per_lm=8), n_cams, n_pts, device="cpu")
    for name in got._fields:
        w, g = getattr(want, name), getattr(got, name)
        if w is None or g is None:
            assert w is None and g is None, name
            continue
        w, g = np.asarray(w), g.numpy()
        assert w.dtype == g.dtype and w.shape == g.shape, name
        if name in ("R", "t"):
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0, err_msg=name)
            np.testing.assert_array_equal(g[:2], w[:2])   # the two gauge cameras are not retracted
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_vocab_recall_with_the_reference_draw_gives_its_recall(monkeypatch):
    """The reference at the reduced size: its module constants patched and its
    word counts 2048 / 16384 mapped to 256 / 512 inside ``train_vocab``,
    whose ``jax.random`` draw is replayed and recorded for the port."""
    small = {2048: 256, 16384: 512}
    draws = {}
    train = jvr.V.train_vocab

    def train_small(corpus, ok, key, n_words, iters):
        W = small[n_words]
        p = ok.astype(jnp.float32)
        p = p / jnp.maximum(jnp.sum(p), 1.0)
        init = corpus[jax.random.choice(key, corpus.shape[0], (W,), replace=True, p=p)]
        draws[W] = torch.from_numpy(np.asarray(init).view(np.int32).copy())
        return train(corpus, ok, key, n_words=W, iters=iters, init_words=init)

    monkeypatch.setattr(jvr, "PERIOD", 40)
    monkeypatch.setattr(jvr, "N_FRAMES", 80)
    monkeypatch.setattr(jvr.V, "train_vocab", train_small)
    want = jvr.run()
    got = vocab_recall.run(init_words=draws, words=(256, 512), period=40, n_frames=80, device="cpu")
    assert (got["span"], got["radius"]) == (want["span"], want["radius"])
    assert len(got["results"]) == len(want["results"]) == 3
    for g, w in zip(got["results"], want["results"]):
        assert (g["recall@1"], g["recall@5"], g["n_queries"]) == (w["recall@1"], w["recall@5"], w["n_queries"])
        assert g["n_queries"] > 0
    assert [g["name"] for g in got["results"]] == ["flat-256", "flat-512", "two-level-512(C0=128)"]


@pytest.fixture(scope="module")
def mapped_engine():
    cfg = SYNTH_CONFIG   # run-synth's: the sweep tracks OK from its third frame
    scene = synth.make_scene(seed=3, n_points=1500, n_frames=20, cfg=cfg)
    eng = Engine(cfg, device="cpu")
    for i in range(20):
        fr, _ = synth.observe(scene, i, noise_px=0.5, device="cpu")
        eng.track_features(fr, i / 30.0)
    eng.flush()
    gt = np.stack([-scene.R[i].T @ scene.t[i] for i in range(20)])
    assert eng.kf_count >= 2
    return eng, gt


def test_render_png_has_the_trajectory_at_its_projected_pixels(tmp_path, mapped_engine):
    eng, gt = mapped_engine
    p = str(tmp_path / "map.png")
    px = render.render_map(eng, p, gt_positions=gt)
    img = png.read_unchanged(p)[..., ::-1]   # BGR -> RGB
    assert img.shape == (render.SIZE[1], render.SIZE[0], 3) and img.dtype == np.uint8
    xy = np.round(px).astype(int)
    assert len(xy) == len(eng.trajectory)
    assert (xy >= 0).all() and (xy[:, 0] < render.SIZE[0]).all() and (xy[:, 1] < render.SIZE[1]).all()
    assert (img[xy[:, 1], xy[:, 0]] == render.RED).all()
    colours = {tuple(int(v) for v in c) for c in np.unique(img.reshape(-1, 3), axis=0)}
    assert {render.GREY, render.BLUE} <= colours   # the aligned ground truth lies under the trajectory here


def test_render_svg_parses_back(tmp_path, mapped_engine):
    eng, gt = mapped_engine
    p = str(tmp_path / "map.svg")
    px = render.render_map(eng, p, gt_positions=gt, max_points=50)
    root = ET.parse(p).getroot()
    ns = "{http://www.w3.org/2000/svg}"
    assert (root.get("width"), root.get("height")) == tuple(str(s) for s in render.SIZE)
    by_id = {e.get("id"): e for e in root.iter() if e.get("id")}
    assert int(eng.m.lms.valid.sum()) > 50
    assert len(list(by_id["landmarks"].iter(ns + "circle"))) == 50   # sampled down to max_points
    traj = np.array([[float(v) for v in xy.split(",")] for xy in by_id["trajectory"].get("points").split()])
    np.testing.assert_allclose(traj, px, atol=5e-3)
    assert by_id["ground_truth"].get("stroke-dasharray")
    assert len(list(by_id["keyframes"].iter(ns + "rect"))) == eng.kf_count


def test_render_aligns_the_ground_truth_over_ok_frames_that_have_it(mapped_engine):
    """R8: the render's ground truth is given per trajectory frame; rows
    without one (NaN) and frames not tracked OK are left out of the
    alignment and of the drawn line."""
    eng, gt = mapped_engine
    ok = np.array([r.state == "OK" for r in eng.trajectory])
    g = gt.copy()
    g[-3:] = np.nan
    layers = render._layers(eng, g)
    use = ok & np.isfinite(g).all(1)
    assert 3 <= use.sum() < len(g) and len(layers["ground_truth"]) == use.sum()
    s, R, t = align_umeyama(g[use], eng.positions[use])
    np.testing.assert_allclose(layers["ground_truth"], (s * (R @ g[use].T)).T + t)
    with pytest.raises(ValueError, match="ground truth"):
        render._layers(eng, gt[:-1])


@pytest.mark.parametrize("out", [False, True], ids=["no-out", "out"])
def test_bench_scaling_writes_a_file_only_to_out(tmp_path, monkeypatch, capsys, out):
    work = tmp_path / "cwd"
    work.mkdir()
    monkeypatch.chdir(work)
    target = tmp_path / "scaling.json"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.setenv("PYTHONPATH", repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    argv = ["12", "400", "--device", "cpu", "--ranks", "2"] + (["--out", str(target)] if out else [])
    record = bench_scaling.main(argv)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(record))
    assert record["devices"] == 2 and record["virtual"] and record["backend"] == "cpu"
    assert set(record["ms_per_iter"]) == {"1", "2"} and record["value"] > 0
    assert list(work.iterdir()) == []
    assert target.exists() == out
    if out:
        assert json.loads(target.read_text()) == printed
