"""The output check of the benchmark's stereo cell (``kitti00_stereo.batch8``) on the CPU, at the
size of ``bench_port/tests/tiny.py`` (620x188, 600 features).

* On a rendered pair of the cell's scene, the port's stereo answers (``stereo.stereo_match_frames``
  through ``extract_and_match_stereo_batch``, as the cell drives it) are held to the plain float64
  reference (``bench_port.reference.frontend.extract`` and ``stereo_right_x``): every right-x
  agrees (``ur_err`` 0), and the check calls the pair correct.
* A right-x moved by 0.05 px (the fault of ``bench_port/tests/test_bench_port_faults.py``) is not
  correct, through ``ur_err``.
* The cell's limit file names exactly the numbers ``checks.verdict`` compares for a stereo cell:
  every number of ``checks.NAMES`` but ``pose_px``. A stereo run has a ``pose_px`` only where a
  sampled pose call is determinate, about one in eight there (its last round reclassifies an
  observation at the chi2 bound in the others), so 24 samples leave it out of some runs, and a
  limit on a number a run lacks fails the run; on an H100 the program's float32 also read above the
  TF32 control's smallest. The stereo pose step is held by ``pose_split``.
"""

import json
import pathlib

import pytest
import torch

from bench_port import checks
from bench_port.harness import Stream, camera, engine_config
from bench_port.tests import tiny
from dialog_tpu_torch import stereo

torch.set_num_threads(2)

CELL = "kitti00_stereo.batch8"
LIMITS = pathlib.Path(__file__).resolve().parent.parent / "bench_port" / "limits" / f"{CELL}.json"
FRAME = 40   # a pair in the sweep's first third


@pytest.fixture(scope="module")
def cell():
    conf = tiny.config("kitti00_stereo")
    return conf, Stream(conf, torch.device("cpu")), engine_config(conf)


@pytest.fixture(scope="module")
def limits():
    with open(LIMITS) as f:
        return json.load(f)


def _readings(cell):
    conf, stream, cfg = cell
    k = FRAME
    batch = stereo.extract_and_match_stereo_batch(stream.left[k : k + 1], stream.right[k : k + 1], cfg)
    assert int((batch.u_right >= 0).sum()) > 100
    return checks.frontend_readings([([k], batch)], stream, camera(conf), True, ())["program"]


def test_the_port_s_right_x_is_the_reference_s(cell, limits):
    got = _readings(cell)
    assert got["ur_err"] == 0.0 and got["kp_mismatch"] == 0.0, got
    correct, table = checks.verdict(got, limits)
    assert correct and "ur_err" in table, table


def test_a_right_x_off_by_five_hundredths_of_a_pixel_is_not_correct(cell, limits, monkeypatch):
    orig = stereo.stereo_match_frames

    def altered(*a, **k):
        f = orig(*a, **k)
        return f._replace(u_right=torch.where(f.u_right >= 0, f.u_right + 0.05, f.u_right))

    monkeypatch.setattr(stereo, "stereo_match_frames", altered)
    got = _readings(cell)
    correct, table = checks.verdict(got, limits)
    assert not correct
    assert {k for k, (v, lim) in table.items() if not v <= lim} == {"ur_err"}, table


def test_the_limit_file_names_what_a_stereo_cell_compares(limits):
    assert set(limits) == set(checks.NAMES) - {"pose_px"}
    _, table = checks.verdict({name: 0.0 for name in checks.NAMES}, limits)
    assert set(table) == set(limits)
    assert limits["match_mismatch"] == limits["unanswered"] == limits["stuck"] == limits["lost"] == 0
