"""The engine's remaining modes in the port against the JAX engine's
(``tests/test_system_modes.py``): localization only, checkpoint resume,
reset, the PLY export and the trajectory writers.

One JAX engine tracks 25 frames of a synthetic sweep and saves its map; the
port's engine loads that checkpoint, goes LOST, relocalizes against the
loaded map and tracks on (``n_tracked > 50`` at the end, as the reference
test asks of its own resume). From the same map both packages write the
keyframe trajectory and the PLY point cloud byte for byte alike, and the
port's KITTI writer matches the reference's on the same poses. Localization
mode: both engines resume from the checkpoint with the map frozen and add
no keyframe and no landmark while they relocalize and track. A global BA in
flight is abandoned by ``reset`` and by ``load_checkpoint`` (its result
never folds into the new map). The port's own save/load round trip and two
bit-equal port runs are in ``tests/test_torch_determinism.py``.
"""

import jax
import numpy as np
import pytest
import torch

from dialog_tpu.config import EngineConfig as JConfig
from dialog_tpu.datasets import synth as jsynth
from dialog_tpu.eval.trajectory import save_kitti as jsave_kitti
from dialog_tpu.system import Engine as JEngine
from dialog_tpu_torch.config import EngineConfig
from dialog_tpu_torch.datasets import synth
from dialog_tpu_torch.eval.ate import ate_rmse
from dialog_tpu_torch.interop import map_from_numpy
from dialog_tpu_torch.system import LOST, NOT_INITIALIZED, OK, Engine

torch.set_num_threads(2)

CFG_KW = dict(max_features=512, max_keyframes=64, max_landmarks=8192, max_local_lms=2048, max_frames_between_kf=6,
              vocab_words=512, vocab_min_kfs=4)
CFG = EngineConfig(**CFG_KW)
SCENE = dict(seed=32, n_points=700, n_frames=36)
SAVED_AT = 25


def _run(eng, frames, observe, scene):
    for i in frames:
        eng.track_features(observe(scene, i), float(i) / 30.0)


def _port_observe(scene, i):
    return synth.observe(scene, i, noise_px=0.4, device="cpu")[0]


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The JAX engine after SAVED_AT frames: its checkpoint, its map (numpy
    leaves), its keyframe count, and the scene for the port."""
    jcfg = JConfig(**CFG_KW)
    jscene = jsynth.make_scene(cfg=jcfg, **SCENE)
    eng = JEngine(jcfg)
    _run(eng, range(SAVED_AT), lambda s, i: jsynth.observe(s, i, noise_px=0.4)[0], jscene)
    assert eng.kf_count >= 4
    path = str(tmp_path_factory.mktemp("ckpt") / "map.npz")
    eng.save_checkpoint(path)
    return dict(path=path, jeng=eng, jcfg=jcfg, jscene=jscene, m=jax.device_get(eng.m), kf_count=eng.kf_count,
                scene=synth.make_scene(cfg=CFG, **SCENE))


@pytest.fixture(scope="module")
def resumed(saved):
    """The port's engine resumed from the JAX checkpoint and run to the end of the sweep."""
    eng = Engine(CFG, device="cpu")
    eng.load_checkpoint(saved["path"])
    assert eng.state == LOST and eng.kf_count == saved["kf_count"] and eng._vocab is None
    _run(eng, range(SAVED_AT, SCENE["n_frames"]), _port_observe, saved["scene"])
    return eng


def test_resume_from_a_jax_checkpoint_relocalizes(saved, resumed):
    assert resumed.trajectory[-1].state == OK
    assert resumed.trajectory[-1].n_tracked > 50
    assert resumed._vocab is not None          # retrained lazily from the loaded map
    assert resumed.kf_count >= saved["kf_count"]
    # the trajectory follows the sweep (similarity-aligned: a monocular map has its own scale and frame)
    gt = np.stack([-saved["scene"].R[i].T @ saved["scene"].t[i] for i in range(SAVED_AT, SCENE["n_frames"])])
    ok = np.array([r.state == OK for r in resumed.trajectory])
    assert ok[-6:].all()
    assert ate_rmse(resumed.positions[ok], gt[ok], with_scale=True) < 0.05


def test_localization_mode_freezes_the_map_in_both_engines(saved):
    jeng = JEngine(saved["jcfg"])
    jeng.load_checkpoint(saved["path"])
    jeng.set_localization_mode(True)
    _run(jeng, range(SAVED_AT, SCENE["n_frames"]), lambda s, i: jsynth.observe(s, i, noise_px=0.4)[0],
         saved["jscene"])
    eng = Engine(CFG, device="cpu")
    eng.load_checkpoint(saved["path"])
    eng.set_localization_mode(True)
    _run(eng, range(SAVED_AT, SCENE["n_frames"]), _port_observe, saved["scene"])
    n_lms = int(np.asarray(saved["m"].lms.valid).sum())
    for e, valid_kf, valid_lm in ((jeng, np.asarray(jeng.m.kfs.valid), np.asarray(jeng.m.lms.valid)),
                                  (eng, eng.m.kfs.valid.numpy(), eng.m.lms.valid.numpy())):
        assert e.kf_count == saved["kf_count"]
        np.testing.assert_array_equal(valid_kf, np.asarray(saved["m"].kfs.valid))
        assert int(valid_lm.sum()) == n_lms
        assert e.trajectory[-1].state == OK
        assert all(r.state == OK for r in e.trajectory[-6:])
    assert eng.localization_only and not Engine(CFG, device="cpu").localization_only


def test_keyframe_trajectory_and_ply_byte_equal(saved, tmp_path):
    eng = Engine(CFG, device="cpu")
    eng.m = map_from_numpy(saved["m"], device="cpu")
    for name in ("save_keyframe_trajectory_tum", "export_map_ply"):
        getattr(saved["jeng"], name)(str(tmp_path / f"ref_{name}"))
        getattr(eng, name)(str(tmp_path / f"port_{name}"))
        want = (tmp_path / f"ref_{name}").read_bytes()
        assert (tmp_path / f"port_{name}").read_bytes() == want, name
    lines = (tmp_path / "port_export_map_ply").read_text().splitlines()
    n = int([ln for ln in lines if ln.startswith("element vertex")][0].split()[-1])
    assert n > 100 and len(lines) == lines.index("end_header") + 1 + n
    kf = [ln for ln in (tmp_path / "port_save_keyframe_trajectory_tum").read_text().splitlines() if ln]
    assert len(kf) == int(np.asarray(saved["m"].kfs.valid).sum()) and all(len(ln.split()) == 8 for ln in kf)
    ts = [float(ln.split()[0]) for ln in kf]
    assert all(b > a for a, b in zip(ts, ts[1:]))


def test_kitti_trajectory_format(resumed, tmp_path):
    p = tmp_path / "port.txt"
    resumed.save_trajectory_kitti(str(p))
    poses = resumed.final_poses()
    jsave_kitti(str(tmp_path / "ref.txt"), [q[0] for q in poses], [q[1] for q in poses])
    assert p.read_bytes() == (tmp_path / "ref.txt").read_bytes()
    rows = [np.array(ln.split(), float) for ln in p.read_text().splitlines()]
    assert len(rows) == len(resumed.trajectory) and all(r.shape == (12,) for r in rows)
    # camera-to-world: the rotation block is orthonormal and the last column the camera centre
    P = rows[-1].reshape(3, 4)
    np.testing.assert_allclose(P[:, :3] @ P[:, :3].T, np.eye(3), atol=1e-5)
    np.testing.assert_allclose(P[:, 3], resumed.positions[-1], atol=1e-5)


def test_reset_clears_everything(saved):
    eng = Engine(CFG, device="cpu")
    eng.load_checkpoint(saved["path"])
    _run(eng, range(SAVED_AT, SAVED_AT + 3), _port_observe, saved["scene"])
    n_rec = len(eng.trajectory)
    old_loop = eng._loop
    eng.reset()
    assert eng.state == NOT_INITIALIZED and eng.kf_count == 0 and eng.ref_kf == 0
    assert int(eng.m.lms.valid.sum()) == 0 and int(eng.m.kfs.valid.sum()) == 0
    assert eng._vocab is None and eng._bow_db is None and not eng._kf_valid_host.any()
    assert not eng._pending and not eng._pending_b and not eng._recs_by_ref and eng._gba is None
    assert eng._loop is not old_loop and eng._seq_next == 0 and eng._last_lm_ids is None
    # the records stay, baked to absolute poses
    assert len(eng.trajectory) == n_rec and all(r.ref_kf == -1 and r.R_rel is None for r in eng.trajectory)


@pytest.mark.parametrize("how", ["reset", "load_checkpoint"])
def test_gba_in_flight_is_abandoned(saved, how):
    eng = Engine(CFG, device="cpu")
    eng.load_checkpoint(saved["path"])
    before = eng.m
    eng._start_gba(4)
    assert eng._gba is not None
    if how == "reset":
        eng.reset()
        assert int(eng.m.kfs.valid.sum()) == 0
    else:
        eng.load_checkpoint(saved["path"])
        for a, b in zip((eng.m.kfs.R, eng.m.kfs.t, eng.m.lms.xyz), (before.kfs.R, before.kfs.t, before.lms.xyz)):
            assert torch.equal(a, b)
    assert eng._gba is None
    assert eng.stats["gba_runs"] == 1
