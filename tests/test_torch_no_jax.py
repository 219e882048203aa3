"""The port and ``chip_smoke.py`` run where JAX is not installed.

A child interpreter in which ``import jax`` and ``import dialog_tpu`` fail
imports ``dialog_tpu_torch``, every one of its submodules and
``chip_smoke``, then extracts features from a 160x120 image with the port's
plain frontend. A static check finds no JAX import and no reference to the
JAX package in the port's sources or in ``chip_smoke.py``.
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
sys.modules["jax"] = None
sys.modules["dialog_tpu"] = None
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
assert "jax" not in [m for m in sys.modules if sys.modules[m] is not None]
print(len(names), int(fr.valid.sum()), tuple(fr.desc.shape))
"""


def test_port_imports_and_runs_without_jax():
    out = subprocess.run([sys.executable, "-c", CHILD], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, n_valid, desc_shape = out.stdout.split(maxsplit=2)
    assert int(n_modules) >= 20
    assert int(n_valid) > 50
    assert desc_shape.strip() == "(160, 8)"


@pytest.mark.parametrize("pattern", ["import jax", "from jax", "dialog_tpu."])
def test_no_jax_in_port_sources(pattern):
    files = sorted((ROOT / "dialog_tpu_torch").rglob("*.py")) + sorted((ROOT / "dialog_tpu_torch").rglob("*.cu"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    hits = [str(p.relative_to(ROOT)) for p in files if pattern in p.read_text()]
    assert not hits, hits
