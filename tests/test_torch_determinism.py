"""Two runs of the port's engine from the same seed are bit-equal, and its
own checkpoint resumes (``tests/test_determinism.py`` and
``tests/test_system_modes.py``'s round trip, for the port).

Two engines track the same 20 synthetic frames on the CPU: every record
(state, ``n_tracked``, R, t) and every leaf of the map are equal bit for
bit. The first engine's map then goes through ``save_checkpoint`` /
``load_checkpoint`` into a fresh engine: the counters rebuild from the
masks, the map comes back bit for bit, and the resumed engine goes LOST,
relocalizes against it and tracks to the end of the sweep. On the card the
same holds for the paths ``chip_smoke.py`` repeats (its ``determinism``
phase) and for the global BA (``tests/test_torch_cuda.py``).
"""

import numpy as np
import torch

from dialog_tpu_torch.config import EngineConfig
from dialog_tpu_torch.containers import _leaves
from dialog_tpu_torch.datasets import synth
from dialog_tpu_torch.system import LOST, OK, Engine

torch.set_num_threads(2)

CFG = EngineConfig(max_features=512, max_keyframes=32, max_landmarks=4096, max_local_lms=1024,
                   max_frames_between_kf=6, vocab_words=512, vocab_min_kfs=4)
N_RUN, N_ALL = 20, 27


def _scene():
    return synth.make_scene(seed=61, n_points=600, n_frames=N_ALL, cfg=CFG)


def _track(eng, scene, frames):
    for i in frames:
        eng.track_features(synth.observe(scene, i, noise_px=0.4, device="cpu")[0], float(i) / 30.0)
    return eng


def test_bitwise_reproducible_and_checkpoint_round_trip(tmp_path):
    scene = _scene()
    a = _track(Engine(CFG, device="cpu"), scene, range(N_RUN))
    b = _track(Engine(CFG, device="cpu"), scene, range(N_RUN))
    assert a.kf_count >= 4
    for la, lb in zip(_leaves(a.m), _leaves(b.m)):
        assert torch.equal(la, lb)
    assert len(a.trajectory) == len(b.trajectory) == N_RUN
    for ra, rb in zip(a.trajectory, b.trajectory):
        assert ra.state == rb.state and ra.n_tracked == rb.n_tracked
        np.testing.assert_array_equal(ra.R, rb.R)
        np.testing.assert_array_equal(ra.t, rb.t)

    path = str(tmp_path / "map.npz")
    a.save_checkpoint(path)
    c = Engine(CFG, device="cpu")
    c.load_checkpoint(path)
    for la, lc in zip(_leaves(a.m), _leaves(c.m)):
        assert torch.equal(la, lc)
    assert c.kf_count == a.kf_count and c.state == LOST
    np.testing.assert_array_equal(c._kf_valid_host, a.m.kfs.valid.numpy())
    seq = a.m.kfs.seq.numpy()
    assert c._seq_next == int(seq.max()) + 1
    live = np.nonzero(a.m.kfs.valid.numpy())[0]
    assert c.ref_kf == int(live[np.argmax(seq[live])])
    _track(c, scene, range(N_RUN, N_ALL))
    assert c.trajectory[-1].state == OK and c.trajectory[-1].n_tracked > 50
