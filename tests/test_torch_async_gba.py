"""The port engine's loop-closure global BA (``Engine._start_gba`` / ``_gba_tick``
/ ``_finish_gba``, ``dialog_tpu_torch/system.py``).

On the port's own map after 22 frames of a synthetic sweep (CPU):

* a GBA started on the map advances one LM iteration per ``track_features``
  call and folds in at the end: ``gba_runs`` 1, nothing in flight after, and
  the map is the one a synchronous PCG solve of the same iterations from the
  same start gives, folded into the map as it stood at the fold, bit for bit
  (the same operations on the CPU);
* ``track_batch`` ticks it in state OK, ``flush`` drains it: the same map as
  the synchronous solve folded into the unchanged map, bit for bit;
* a second start abandons the GBA in flight; at a loop closure
  (``_close_loop_from`` with the Sim3 and the correction stubbed) the GBA in
  flight is dropped and a new one starts on the corrected map, or, with
  ``gba_async = False``, ``global_bundle_adjustment`` runs at once with 8
  iterations.

The orbit run with GBA on in both engines is ``tests/test_torch_loop_engine.py``
(marked ``slow``), as ``tests/test_async_gba.py::TestAsyncGBAEngine`` is the
reference's soak twin.
"""

import copy

import pytest
import torch

from dialog_tpu_torch import system
from dialog_tpu_torch.config import EngineConfig
from dialog_tpu_torch.containers import FrameArrays
from dialog_tpu_torch.datasets import synth
from dialog_tpu_torch.geometry import orthogonalize
from dialog_tpu_torch.optim.global_ba import GBASnapshot, build_global_problem, fold_gba_result
from dialog_tpu_torch.optim.schur_pcg import lm_init_pcg, lm_steps_pcg
from dialog_tpu_torch.system import OK, Engine

torch.set_num_threads(2)

CFG = EngineConfig(width=320, height=240, fx=260.0, fy=260.0, cx=160.0, cy=120.0, n_features=256, max_features=256,
                   max_keyframes=32, max_landmarks=2048, max_local_lms=1024, max_local_kfs=8, max_fixed_kfs=4,
                   max_obs_per_lm=8, init_min_features=40, init_min_matches=40, init_min_good=25)
N_RUN, N_MORE = 22, 8


@pytest.fixture(scope="module")
def run():
    """An engine after N_RUN frames (loop closing off), and the next N_MORE frames."""
    scene = synth.make_scene(seed=5, n_points=600, n_frames=N_RUN + N_MORE, cfg=CFG)
    frames = [synth.observe(scene, i, noise_px=0.4, device="cpu")[0] for i in range(N_RUN + N_MORE)]
    eng = Engine(CFG, device="cpu")
    eng.loop_closing_enabled = False
    for i in range(N_RUN):
        eng.track_features(frames[i], i / 30.0)
    assert eng.state == OK and eng.kf_count >= 4
    return eng, frames


def _engine(run):
    """A copy of the fixture's engine to drive on (the map's tensors are never written in place; the BoW rows are)."""
    eng, frames = run
    e = copy.copy(eng)
    e.trajectory, e._recs_by_ref, e.stats = list(eng.trajectory), dict(eng._recs_by_ref), dict(eng.stats)
    e._kf_valid_host, e._recent_kf_allocs = eng._kf_valid_host.copy(), dict(eng._recent_kf_allocs)
    e._bow_db = None if eng._bow_db is None else eng._bow_db.clone()
    e._gen = torch.Generator().manual_seed(1)
    return e, frames


def _solved(m, iters):
    """The engine's GBA solve from map m, synchronously: (R, t, xyz)."""
    prob, _ = build_global_problem(m, CFG)
    carry = lm_init_pcg(prob, CFG, chi2_th=CFG.chi2_mono)
    for _ in range(iters):
        carry = lm_steps_pcg(prob, CFG, carry, chi2_th=CFG.chi2_mono)
    return orthogonalize(carry[0]), carry[1], carry[2]


def _fold(m_live, m_start, R, t, xyz):
    s = GBASnapshot(m_start)
    return fold_gba_result(m_live, s.kf_seq, s.kf_valid, s.lm_valid, s.lm_first_seq, s.lm_ref, R, t, xyz)


def _assert_maps_equal(a, b):
    for name in ("R", "t"):
        assert torch.equal(getattr(a.kfs, name), getattr(b.kfs, name)), name
    assert torch.equal(a.lms.xyz, b.lms.xyz)


def test_ticks_through_track_features_and_fold(run, monkeypatch):
    eng, frames = _engine(run)
    m0 = eng.m
    folds = []
    fold = system.fold_gba_result
    monkeypatch.setattr(system, "fold_gba_result", lambda m, *a: folds.append((m, fold(m, *a))) or folds[-1][1])
    eng._start_gba(3)
    assert eng.stats["gba_runs"] == run[0].stats["gba_runs"] + 1 and eng._gba is not None
    for i in range(N_RUN, N_RUN + 3):
        assert eng._gba is not None and not folds
        eng.track_features(frames[i], i / 30.0)
    # the third frame's tick was the last: the GBA folded into the map the frames before it left
    assert eng._gba is None and len(folds) == 1
    live, out = folds[0]
    _assert_maps_equal(out, _fold(live, m0, *_solved(m0, 3)))
    assert not torch.equal(out.kfs.t, live.kfs.t)


def test_track_batch_ticks_and_flush_drains(run):
    eng, frames = _engine(run)
    m0 = eng.m
    eng._start_gba(5)
    B = 4
    for i in range(N_RUN, N_RUN + 2 * B, B):
        batch = FrameArrays(*[torch.stack(x) for x in zip(*frames[i : i + B])])
        eng.track_batch(batch, [(i + j) / 30.0 for j in range(B)])
    assert eng._gba is not None and eng._gba["left"] == 3   # two batches in state OK: two ticks
    eng2, _ = _engine(run)
    eng2._start_gba(5)
    eng2.flush()
    assert eng2._gba is None and eng2.stats["gba_runs"] == run[0].stats["gba_runs"] + 1
    _assert_maps_equal(eng2.m, _fold(m0, m0, *_solved(m0, 5)))
    eng.flush()
    assert eng._gba is None and not eng._pending_b


def test_gba_moves_the_map(run):
    eng, _ = _engine(run)
    m0 = eng.m
    eng._start_gba(5)
    eng.flush()
    assert float((eng.m.kfs.t - m0.kfs.t).abs().max()) > 0.0
    assert torch.equal(eng.m.kfs.t[:2], m0.kfs.t[:2])     # the two gauge keyframes stay


def test_a_second_start_abandons_the_gba_in_flight(run):
    eng, _ = _engine(run)
    eng._start_gba(8)
    eng._gba_tick()
    first = eng._gba
    assert first["left"] == 7 and int(first["carry"][5]) > 0
    eng._start_gba(8)
    assert eng._gba is not first and eng._gba["left"] == 8 and int(eng._gba["carry"][5]) == 0
    assert eng.stats["gba_runs"] == run[0].stats["gba_runs"] + 2


@pytest.mark.parametrize("gba_async", [True, False])
def test_loop_closure_starts_a_gba(run, monkeypatch, gba_async):
    eng, _ = _engine(run)
    eng.gba_async = gba_async
    eng._start_gba(8)
    in_flight = eng._gba
    seq = eng.m.kfs.seq
    det, cand = int(eng.ref_kf), 0
    eng._loop = copy.copy(eng._loop)
    eng._loop.last_eval_det_seq = int(seq[det])
    corrected = eng.m._replace(kfs=eng.m.kfs._replace(t=eng.m.kfs.t + 0.01))
    monkeypatch.setattr(eng._loop, "compute_sim3", lambda *a, **k: "a Sim3")
    monkeypatch.setattr(eng._loop, "correct", lambda m, d, lc, cfg: corrected)
    calls = []
    gba = system.global_bundle_adjustment
    monkeypatch.setattr(system, "global_bundle_adjustment",
                        lambda m, cfg, iters, group, stats: (calls.append((m, iters, group)), gba(m, cfg, iters,
                                                                                                    group, stats))[1])
    runs = eng.stats["gba_runs"]
    eng._close_loop_from(det, [(cand, int(seq[cand]))])
    if gba_async:
        assert eng._gba is not in_flight and eng._gba["left"] == eng.gba_iters == 8
        assert eng.stats["gba_runs"] == runs + 1 and not calls
        assert torch.equal(eng._gba["prob"].t, corrected.kfs.t)
    else:
        assert eng._gba is None and eng.stats["gba_runs"] == runs
        assert len(calls) == 1 and calls[0][0] is corrected and calls[0][1:] == (8, None)
        assert not torch.equal(eng.m.kfs.t, corrected.kfs.t)
    assert eng._vel is None and eng._dev_state is None
