"""The pipelined per-frame entry of both engines, and the edges of the
batched one, on the scene of ``tests/test_batch_mode.py``.

The port takes its random draws from the reference's key stream
(``test_torch_batch_engine.ReferenceStream``).

* ``track_features_async`` + ``flush``: a record per frame, in frame order,
  the same states and the same keyframes (their frame ids) as the reference,
  positions within 2e-4 m;
* ``flush`` and ``shutdown`` on an empty pipeline change nothing;
* ``track_batch`` records what ``track_features`` records, frame by frame,
  while the engine is not yet OK.
"""

import numpy as np
import pytest
import torch

from dialog_tpu.config import EngineConfig as JConfig
from dialog_tpu.system import Engine as JEngine
from dialog_tpu_torch.config import EngineConfig as TConfig
from dialog_tpu_torch.containers import FrameArrays
from dialog_tpu_torch.system import OK, Engine as TEngine
from tests.test_torch_batch_engine import B, CFG, N, POS_TOL, ReferenceStream, _kf_frames, _positions
from tests.test_torch_batch_engine import frames  # noqa: F401  (the module's fixture)

torch.set_num_threads(2)


def test_async_gives_a_record_per_frame_and_the_reference_keyframes(frames):
    fj, ft = frames
    jeng = JEngine(JConfig(**CFG))
    jeng.loop_closing_enabled = False
    teng = TEngine(TConfig(**CFG), device="cpu")
    returned = []
    with pytest.MonkeyPatch.context() as mp:
        ReferenceStream().patch(mp)
        for i in range(N):
            jeng.track_features_async(fj[i], i / 30.0)
            returned.append(teng.track_features_async(ft[i], i / 30.0))
            assert len(teng._pending) <= teng.pipeline_depth
        jeng.flush()
        teng.flush()
    assert len(teng.trajectory) == N and [r.frame_id for r in teng.trajectory] == list(range(N))
    assert [r.state for r in teng.trajectory] == [r.state for r in jeng.trajectory]
    assert _kf_frames(teng) == _kf_frames(jeng) and teng.kf_count >= 5
    assert not teng._pending and teng._dev_state is None
    # while the pipeline fills nothing resolves; then each call returns the frame `depth` back
    resolved = [r.frame_id for r in returned if r is not None]
    assert resolved == sorted(resolved) and None in returned
    ok = np.array([r.state == OK for r in teng.trajectory])
    assert float(np.abs(_positions(jeng) - _positions(teng))[ok].max()) < POS_TOL


def test_flush_and_shutdown_on_an_empty_pipeline(frames):
    _, ft = frames
    eng = TEngine(TConfig(**CFG), device="cpu")
    eng.flush()
    eng.shutdown()
    assert eng.trajectory == [] and eng.frame_id == 0 and eng.state != OK
    eng.track_features(ft[0], 0.0)
    before = (len(eng.trajectory), eng.frame_id, eng.state, eng.kf_count)
    eng.flush()
    eng.shutdown()
    assert (len(eng.trajectory), eng.frame_id, eng.state, eng.kf_count) == before


def test_track_batch_before_initialization_goes_frame_by_frame(frames):
    _, ft = frames
    a = TEngine(TConfig(**CFG), device="cpu")
    b = TEngine(TConfig(**CFG), device="cpu")
    out = a.track_batch(FrameArrays(*[torch.stack(x) for x in zip(*ft[:B])]), [j / 30.0 for j in range(B)])
    for j in range(B):
        b.track_features(ft[j], j / 30.0)
    assert len(out) == B and [r.state for r in out] == [r.state for r in b.trajectory]
    assert a.state == b.state == OK and a.kf_count == b.kf_count >= 2
    for ra, rb in zip(a.trajectory, b.trajectory):
        np.testing.assert_array_equal(ra.R, rb.R)
        np.testing.assert_array_equal(ra.t, rb.t)
