"""Both engines close the loop of the reference loop test's orbit.

The JAX engine and the port's (on the CPU) track the 260 feature frames of
``tests/test_loopclosing.py``'s orbit under its configuration
(``profile_main_path.loop_config``), loop closing on and the global BA after
each closure on (asynchronous, one LM iteration a frame) in both. The port draws its two-view minimal sets from the reference's key
stream; its Sim3 RANSAC draws its own.

Gates: both close a loop, the first between the same keyframe insertion
numbers, and both run a global BA after it and fold it in; following ROADMAP
D1, the two trajectories (similarity-aligned to the ground truth) differ less
than either differs from it.

Marked ``slow``: the port's engine takes some 10 minutes on two CPU threads
for the 260 frames, and no shorter orbit closes a loop in the reference
(``chip_smoke.py`` holds the port to the same gates on the card).
"""

import numpy as np
import pytest
import torch

from dialog_tpu.config import EngineConfig as JConfig
from dialog_tpu.datasets import synth as jsynth
from dialog_tpu.eval.ate import ate_rmse, align_umeyama
from dialog_tpu.system import Engine as JEngine
from dialog_tpu_torch import init2view as ti
from dialog_tpu_torch.config import EngineConfig as TConfig
from dialog_tpu_torch.datasets import synth as tsynth
from dialog_tpu_torch.profile_main_path import (LOOP_DESC_FLIPS, LOOP_FRAMES, LOOP_NOISE_PX, LOOP_PERIOD,
                                                LOOP_POINTS, LOOP_SEED, loop_config)
from dialog_tpu_torch.system import OK, Engine as TEngine
from test_torch_engine import ReferenceDraws

pytestmark = pytest.mark.slow
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def engines():
    tcfg = loop_config()
    kw = {f: getattr(tcfg, f) for f in tcfg.__dataclass_fields__ if f != "sensor"}
    jcfg = JConfig(**kw)
    js = jsynth.make_scene(seed=LOOP_SEED, n_points=LOOP_POINTS, n_frames=LOOP_FRAMES, trajectory="loop", cfg=jcfg,
                           period=LOOP_PERIOD)
    ts = tsynth.make_scene(seed=LOOP_SEED, n_points=LOOP_POINTS, n_frames=LOOP_FRAMES, trajectory="loop",
                           cfg=TConfig(**kw), period=LOOP_PERIOD)
    jeng = JEngine(jcfg)
    teng = TEngine(TConfig(**kw), device="cpu")
    for i in range(LOOP_FRAMES):
        jeng.track_features(jsynth.observe(js, i, noise_px=LOOP_NOISE_PX, desc_flips=LOOP_DESC_FLIPS)[0], i / 30.0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ti, "draw_minimal_sets", ReferenceDraws(tcfg.n_features))
        for i in range(LOOP_FRAMES):
            teng.track_features(tsynth.observe(ts, i, noise_px=LOOP_NOISE_PX, desc_flips=LOOP_DESC_FLIPS,
                                               device="cpu")[0], i / 30.0)
    jeng.flush()
    teng.flush()
    return js, jeng, teng


def test_both_close_the_loop_at_the_same_keyframes(engines):
    _, jeng, teng = engines
    assert jeng._loop.closed_loops and teng._loop.closed_loops
    jseq, tseq = np.asarray(jeng.m.kfs.seq), teng.m.kfs.seq.numpy()
    (ja, jb), (ta, tb) = jeng._loop.closed_loops[0], teng._loop.closed_loops[0]
    assert (int(jseq[ja]), int(jseq[jb])) == (int(tseq[ta]), int(tseq[tb]))
    assert int(tseq[ta]) - int(tseq[tb]) > 20


def test_both_run_the_global_ba_after_the_closure(engines):
    _, jeng, teng = engines
    assert jeng.stats["gba_runs"] >= 1 and teng.stats["gba_runs"] >= 1
    assert jeng._gba is None and teng._gba is None


def test_trajectories_agree_better_than_with_the_truth(engines):
    scene, jeng, teng = engines
    ok = [i for i in range(LOOP_FRAMES) if jeng.trajectory[i].state == OK and teng.trajectory[i].state == OK]
    assert len(ok) > 0.9 * LOOP_FRAMES
    gt = np.stack([-scene.R[i].T @ scene.t[i] for i in ok])
    aligned = []
    for eng in (jeng, teng):
        s, R, t = align_umeyama(eng.positions[ok], gt, with_scale=True)
        aligned.append(s * eng.positions[ok] @ R.T + t)
    err_j, err_t = ate_rmse(jeng.positions[ok], gt, with_scale=True), ate_rmse(teng.positions[ok], gt, with_scale=True)
    between = float(np.sqrt(np.mean(np.sum((aligned[0] - aligned[1]) ** 2, -1))))
    assert between < max(err_j, err_t), (between, err_j, err_t)
    span = float(np.linalg.norm(gt.max(0) - gt.min(0)))
    assert err_t < 0.05 * span
