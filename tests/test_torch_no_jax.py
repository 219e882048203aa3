"""The port and ``chip_smoke.py`` run where JAX is not installed.

A child interpreter in which ``import jax``, ``import dialog_tpu``,
``import cv2``, ``import PIL`` and ``import matplotlib`` fail imports
``dialog_tpu_torch``, every one of its submodules and ``chip_smoke``, then
extracts features from a 160x120 image with the port's plain frontend (one
image and a batch of two), trains and queries a small vocabulary, solves a
PnP problem, a seeded pose problem (the pose LM's plain loop), a Sim3
RANSAC problem, a seeded Sim3 pose graph and a seeded BA problem by the
Schur PCG, folds the result into a map, runs a block BA on a
small corridor map, decodes a PNG that ``write_png`` wrote, calls the
reference's last public names that the port took over (``empty_frame``,
``inv3x3``, ``gt_relative_pose``, ``best_covisible``,
``triangulate_between``, ``track_motion_model``, ``TrackOut``) and runs
``cli.main(["run-synth", "--frames", "12", "--device", "cpu"])`` and the
CLI's ``bench`` subcommand (its workloads replaced by fixed frames/s). A static
check finds no import of those five and no reference to the JAX package in
the port's sources or in ``chip_smoke.py``.
"""

import pathlib
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent

CHILD = r"""
import importlib, pkgutil, sys
for blocked in ("jax", "dialog_tpu", "cv2", "PIL", "matplotlib"):
    sys.modules[blocked] = None
import numpy as np
import torch
torch.set_num_threads(2)
import dialog_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dialog_tpu_torch.__path__, "dialog_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from dialog_tpu_torch.config import EngineConfig
from dialog_tpu_torch.frontend import extract_features
cfg = EngineConfig(width=160, height=120, fx=130.0, fy=130.0, cx=80.0, cy=60.0,
                   n_features=150, max_features=160, n_levels=3)
img = np.random.default_rng(0).uniform(0, 255, (120, 160)).astype(np.float32)
fr = extract_features(torch.from_numpy(img), cfg)
from dialog_tpu_torch import pnp, vocab
from dialog_tpu_torch.frontend import extract_features_batch
fb = extract_features_batch(torch.from_numpy(np.stack([img, img[::-1].copy()])), cfg)
assert torch.equal(fb.desc[0], fr.desc) and fb.desc.shape == (2, 160, 8)
voc = vocab.train_vocab(fr.desc, fr.valid, fr.desc[:16].clone(), n_words=16, iters=2)
assert int(vocab.quantize(voc, fr.desc, fr.valid).max()) <= 16
assert abs(float(vocab.bow_vector(voc, fr.desc, fr.valid).sum()) - 1.0) < 1e-5
assert {"dialog_tpu_torch.vocab", "dialog_tpu_torch.pnp", "dialog_tpu_torch.kernels.pose"} <= set(names)
from dialog_tpu_torch.optim import pose_only, synth_problem as sp
pp = sp.make_pose_problem(seed=0, n=40, device="cpu")
assert int(pose_only.pose_optimization(**pp, rounds=2, iters=6).n_inliers) > 20
X = torch.rand(40, 3) + torch.tensor([0.0, 0.0, 4.0])
uv = torch.stack([130.0 * X[:, 0] / X[:, 2] + 80.0, 130.0 * X[:, 1] / X[:, 2] + 60.0], -1)
ok = torch.ones(40, dtype=torch.bool)
res = pnp.solve_pnp_ransac(X, uv, ok, 130.0, 130.0, 80.0, 60.0, pnp.draw_pnp_sets(ok, 32, torch.Generator().manual_seed(0)))
assert bool(res.success)
from dialog_tpu_torch import sim3
from dialog_tpu_torch.optim import pose_graph, synth_problem
from dialog_tpu_torch.geometry import so3_exp
R = so3_exp(torch.tensor([0.1, -0.2, 0.3]))
X2 = 1.3 * X @ R.T + torch.tensor([0.5, 0.0, -0.2])
r3 = sim3.solve_sim3_ransac(X, X2, ok, sim3.draw_sim3_sets(ok, 32, torch.Generator().manual_seed(0)))
assert bool(r3.success) and abs(float(r3.s) - 1.3) < 1e-3
pg = synth_problem.make_pose_graph(seed=0, K=12, device="cpu")
cost0 = pose_graph._system(pg, pg.s, pg.R, pg.t)[0]
assert float(pose_graph.solve_pose_graph(pg, iters=5)[3]) < float(cost0)
assert {"dialog_tpu_torch.sim3", "dialog_tpu_torch.loopclosing", "dialog_tpu_torch.optim.pose_graph"} <= set(names)
from dialog_tpu_torch.optim import global_ba, schur_pcg
bp = synth_problem.make_problem(seed=0, device="cpu")[0]
Rb, tb, xb, cb, ncg = schur_pcg.solve_ba_pcg(bp, synth_problem.FIXTURE_CFG, iters=3, return_cg_iters=True)
assert int(ncg) > 0 and bool(torch.isfinite(xb).all())
from dialog_tpu_torch.containers import empty_map
m0 = empty_map(synth_problem.FIXTURE_CFG, device="cpu")
snap = global_ba.GBASnapshot(m0)
m1 = global_ba.fold_gba_result(m0, snap.kf_seq, snap.kf_valid, snap.lm_valid, snap.lm_first_seq, snap.lm_ref,
                               m0.kfs.R, m0.kfs.t + 1.0, m0.lms.xyz)
assert bool((m1.kfs.t == m0.kfs.t).all())   # no valid keyframe: nothing folds in
assert {"dialog_tpu_torch.optim.schur_pcg", "dialog_tpu_torch.optim.global_ba", "dialog_tpu_torch.distributed",
        "dialog_tpu_torch.gba_rank"} <= set(names)
from dialog_tpu_torch.config import KITTI00
from dialog_tpu_torch.optim import block_ba
kc = KITTI00.replace(max_keyframes=16, max_landmarks=256, max_features=64)
cm = synth_problem.build_corridor_map(kc, n_kf=12, lm_per_kf=10, device="cpu")
cm = synth_problem.perturb_block_local(cm, 12, 10, 6)
st = {}
cb = block_ba.block_bundle_adjustment(cm, kc, n_blocks=2, rounds=1, iters=2, cams_pb=12, lms_pb=64, stats=st)
assert bool(torch.isfinite(cb.kfs.t).all()) and st["block_ba_kf_dropped"] == 0
assert "dialog_tpu_torch.optim.block_ba" in names
import os, tempfile
from dialog_tpu_torch.datasets import png
with tempfile.TemporaryDirectory() as tmp:
    a = (img[:37, :53] * 0.9).astype(np.uint8)
    png.write_png(os.path.join(tmp, "x.png"), np.stack([a, a, a], -1))
    assert np.array_equal(png.read_gray(os.path.join(tmp, "x.png")), a)
from dialog_tpu_torch import cli
cli.main(["run-synth", "--frames", "12", "--device", "cpu"])
assert {"dialog_tpu_torch.cli", "dialog_tpu_torch.native", "dialog_tpu_torch.datasets.png",
        "dialog_tpu_torch.eval.render", "dialog_tpu_torch.kernels.selfcheck"} <= set(names)
from dialog_tpu_torch import bench
bench.mono_images = lambda cfg, device: (None, [])
bench.run_mono = lambda kf, *a, **k: {10: 9.0, 30: 12.0}[kf]
bench.run_stereo = lambda *a, **k: 6.0
cli.main(["bench", "--device", "cpu"])
assert "dialog_tpu_torch.bench" in names
from dialog_tpu_torch import containers, mapping, tracking
from dialog_tpu_torch.datasets import synth
from dialog_tpu_torch.optim import lm
F0 = synth_problem.FIXTURE_CFG.max_features
ef = containers.empty_frame(F0, device="cpu")
assert not bool(ef.valid.any()) and ef.desc.dtype == torch.int32 and ef.uv.shape == (F0, 2)
assert torch.allclose(lm.inv3x3(2.0 * torch.eye(3).expand(4, 3, 3)), 0.5 * torch.eye(3).expand(4, 3, 3))
sc = synth.make_scene(seed=0, n_points=20, n_frames=3)
assert synth.gt_relative_pose(sc, 0, 2)[0].dtype == np.float32
assert mapping.best_covisible(m0, 0, 3) == []
assert int(mapping.triangulate_between(m0, 0, 1, synth_problem.FIXTURE_CFG).num_lms) == 0
lmf, nmm = tracking.track_motion_model(m0, torch.full((F0,), -1, dtype=torch.int32), ef, torch.eye(3), torch.zeros(3),
                                       synth_problem.FIXTURE_CFG)
assert int(nmm) == 0 and tracking.TrackOut(torch.eye(3), torch.zeros(3)).R.shape == (3, 3)
loaded = [m for m in sys.modules if sys.modules[m] is not None]
assert not [m for m in loaded if m.split(".")[0] in ("jax", "cv2", "PIL", "matplotlib")]
print(len(names), int(fr.valid.sum()), tuple(fr.desc.shape))
"""


def test_port_imports_and_runs_without_jax():
    out = subprocess.run([sys.executable, "-c", CHILD], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "tracked" in out.stdout   # the CLI ran
    assert '"metric": "tracking_fps_tum_class_mono", "value": 9.0' in out.stdout   # and its bench subcommand
    n_modules, n_valid, desc_shape = out.stdout.splitlines()[-1].split(maxsplit=2)
    assert int(n_modules) >= 25
    assert int(n_valid) > 50
    assert desc_shape.strip() == "(160, 8)"


@pytest.mark.parametrize("pattern", ["import jax", "from jax", "dialog_tpu.", "import cv2", "import PIL", "from PIL",
                                     "import matplotlib", "from matplotlib"])
def test_no_jax_in_port_sources(pattern):
    files = sorted((ROOT / "dialog_tpu_torch").rglob("*.py")) + sorted((ROOT / "dialog_tpu_torch").rglob("*.cu"))
    files += sorted((ROOT / "dialog_tpu_torch").rglob("*.cpp"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    hits = [str(p.relative_to(ROOT)) for p in files if pattern in p.read_text()]
    assert not hits, hits
