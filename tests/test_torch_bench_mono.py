"""The bench's primary workload, ``tum_mono_kf10``, in both engines at its own
width, up to the two-view initialization: where the port's mono map parts from
the JAX engine's (ROADMAP D22).

The bench's scene and images (``make_scene(seed=3, n_points=2500,
n_frames=264)``, each package's own renderer, 640x480, 1,000 features,
``bench.py:260-266``'s capacities, ``kf_interval`` 10), frames 0-9 one by one
through ``track_image``, as the bench's warm-up feeds its first frames.

* With the JAX engine's draws (``ReferenceStream``) the port fails the same
  two-view attempts and initializes at the JAX engine's frame, 9, with the
  same tracked points and a camera centre within POS_TOL of the JAX
  engine's; its landmark count differs by at most one (a triangulation
  rounding edge comes only at the next keyframe).
* With its own draws (the CPU generator seeded with ``n_features``) the port
  initializes at frame 8, where the JAX engine's attempt failed: the draw
  picks the frame, and with it the map every later step stands on (D3).
  ``tools/mono_parity_trace.py`` follows both runs through the warm-up; with
  the JAX engine's draws the port relocalizes at frame 52 as the JAX engine
  does (35 matches, 17 PnP inliers, 27 refined), with its own it does not.
* Frame 8's attempt on the JAX engine's matched pairs: the port's
  ``initialize_two_view`` with the JAX engine's minimal sets fails as the
  JAX one does, with n_good within 2; with other draws of either package's
  RNG the same pairs succeed in some and fail in others. The attempt rests
  on the draw, not on rounding.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dialog_tpu.system as jsystem
from dialog_tpu.datasets import synth as jsynth
from dialog_tpu_torch import init2view as ti
from dialog_tpu_torch.datasets import synth as tsynth
from dialog_tpu_torch.profile_main_path import tum_mono_config
from dialog_tpu_torch.system import OK, Engine as TEngine
from test_torch_batch_engine import ReferenceStream

torch.set_num_threads(2)

N = 10
INIT_JAX, INIT_OWN = 9, 8      # the frames each run initializes at
POS_TOL = 1e-4
REDRAWS = 16


def _jax_config(tcfg):
    from dialog_tpu.config import EngineConfig as JConfig, Sensor as JSensor

    kw = {f: getattr(tcfg, f) for f in tcfg.__dataclass_fields__ if f != "sensor"}
    return JConfig(**kw, sensor=JSensor(tcfg.sensor.value))


@pytest.fixture(scope="module")
def runs():
    tcfg = tum_mono_config()
    jcfg = _jax_config(tcfg)
    jscene = jsynth.make_scene(seed=3, n_points=2500, n_frames=264, cfg=jcfg)
    tscene = tsynth.make_scene(seed=3, n_points=2500, n_frames=264, cfg=tcfg)
    attempts = {}
    init = jsystem.initialize_two_view
    jeng = jsystem.Engine(jcfg)
    jeng.kf_interval = 10

    def recorded(uv1, uv2, ok, fx, fy, cx, cy, key, **kw):
        out = init(uv1, uv2, ok, fx, fy, cx, cy, key, **kw)
        attempts[jeng.frame_id] = (jax.device_get((uv1, uv2, ok, key)), kw, jax.device_get(out))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsystem, "initialize_two_view", recorded)
        for i in range(N):
            jeng.track_image(jnp.asarray(jsynth.render_image(jscene, i)), i / 30.0)
    images = [torch.from_numpy(tsynth.render_image(tscene, i)) for i in range(N)]
    out = {"jax": jeng, "attempts": attempts, "cfg": tcfg}
    for draws in ("reference", "own"):
        teng = TEngine(tcfg, device="cpu")
        teng.kf_interval = 10
        with pytest.MonkeyPatch.context() as mp:
            if draws == "reference":
                ReferenceStream(tcfg.n_features).patch(mp)
            for i in range(N):
                teng.track_image(images[i], i / 30.0)
        out[draws] = teng
    return out


def _first_ok(eng):
    return [r.state for r in eng.trajectory].index(OK)


def _centre(rec):
    return -np.asarray(rec.R, np.float64).T @ np.asarray(rec.t, np.float64)


def test_reference_draws_initialize_with_the_jax_engine(runs):
    jeng, teng = runs["jax"], runs["reference"]
    assert _first_ok(jeng) == _first_ok(teng) == INIT_JAX
    assert [r.state for r in teng.trajectory] == [r.state for r in jeng.trajectory]
    rj, rt = jeng.trajectory[INIT_JAX], teng.trajectory[INIT_JAX]
    assert rt.n_tracked == rj.n_tracked > 100
    assert teng.kf_count == jeng.kf_count == 2
    assert abs(int(teng.m.lms.valid.sum()) - int(jnp.sum(jeng.m.lms.valid))) <= 1
    gap = float(np.abs(_centre(rt) - _centre(rj)).max())
    assert gap < POS_TOL, gap


def test_own_draws_initialize_a_frame_earlier(runs):
    jeng, teng = runs["jax"], runs["own"]
    assert _first_ok(teng) == INIT_OWN and _first_ok(jeng) == INIT_JAX
    # the port's map then stands on another pair of views: another count of points from the start
    assert teng.trajectory[INIT_OWN].n_tracked != jeng.trajectory[INIT_JAX].n_tracked


def test_frame_8_attempt_rests_on_the_draw(runs):
    """The JAX engine's two-view attempt at frame 8, on its matched pairs: the port with the same minimal sets
    decides as the JAX engine does; other draws decide either way in both packages."""
    (uv1, uv2, ok, key), kw, out = runs["attempts"][INIT_OWN]
    assert not bool(out.success) and bool(runs["attempts"][INIT_JAX][2].success)
    cfg = runs["cfg"]
    iters = kw["iters"]
    n_valid = max(int(np.sum(ok)), 1)
    key_f, key_h = jax.random.split(key)
    picks = (torch.from_numpy(np.array(jax.random.randint(key_f, (iters, 8), 0, n_valid))),
             torch.from_numpy(np.array(jax.random.randint(key_h, (iters, 4), 0, n_valid))))
    args = [torch.from_numpy(np.array(x)) for x in (uv1, uv2, ok)]
    res = ti.initialize_two_view(*args, cfg.fx, cfg.fy, cfg.cx, cfg.cy, picks=picks, **kw)
    assert not bool(res.success)
    assert abs(int(res.n_good) - int(out.n_good)) <= 2
    port = [bool(ti.initialize_two_view(*args, cfg.fx, cfg.fy, cfg.cx, cfg.cy,
                                        generator=torch.Generator().manual_seed(s), **kw).success)
            for s in range(REDRAWS)]
    ref = [bool(jsystem.initialize_two_view(uv1, uv2, ok, cfg.fx, cfg.fy, cfg.cx, cfg.cy, jax.random.PRNGKey(s),
                                            **kw).success) for s in range(REDRAWS)]
    assert any(port) and not all(port), port
    assert any(ref) and not all(ref), ref
