"""Parity of the port's frontend (kernel A + ORB extraction) with ``dialog_tpu``.

Tolerances:
* kernel A (FAST rank): bit-exact, against the reference's ``_reference`` and
  its Pallas body run in interpret mode;
* pyramid levels and blurred levels: 1e-4 absolute (f32 contraction order);
* keypoints, octaves and descriptors given the same pyramid: equal (and on
  whole rendered frames too); FAST responses of whole frames: 1e-3;
* orientation: 1e-4 rad (f32 moment sums in another order);
* the render's camera blur, OpenCV's against the port's numpy one: 1e-3 on
  a 0-255 image.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dialog_tpu import frontend as jfe
from dialog_tpu.config import EngineConfig as JConfig
from dialog_tpu.datasets import synth as jsynth
from dialog_tpu.kernels import fast as jfast
from dialog_tpu_torch import frontend as tfe
from dialog_tpu_torch.config import EngineConfig as TConfig
from dialog_tpu_torch.datasets import synth as tsynth
from dialog_tpu_torch.kernels import fast as tfast

torch.set_num_threads(2)

SMALL = dict(width=320, height=240, fx=258.653204, fy=258.2346075, cx=159.32152, cy=127.6569945,
             n_features=300, max_features=320, n_levels=4)
JCFG = JConfig(**SMALL)
TCFG = TConfig(**SMALL)


@pytest.fixture(scope="module")
def scenes():
    return (jsynth.make_scene(seed=3, n_points=2500, n_frames=168, cfg=JCFG),
            tsynth.make_scene(seed=3, n_points=2500, n_frames=168, cfg=TCFG))


def _rand_img(h, w, seed=1):
    return np.random.default_rng(seed).uniform(0, 255, (h, w)).astype(np.float32)


def test_tables_match_reference():
    np.testing.assert_array_equal(jfe._PATTERN, tfe._PATTERN)
    np.testing.assert_array_equal(jfe._desc_compare_matrix(), tfe._desc_compare_matrix())
    np.testing.assert_array_equal(jfe._resize_matrix(480, 400), tfe._resize_matrix(480, 400))
    np.testing.assert_array_equal(jfe._blur_matrix(123), tfe._blur_matrix(123))
    assert jfe.level_shapes(JCFG) == tfe.level_shapes(TCFG)
    assert jfe.features_per_level(JCFG) == tfe.features_per_level(TCFG)


@pytest.mark.parametrize("th", [(7.0, 20.0, 19), (3.0, 10.0, 8)])
def test_fast_rank_bit_exact_vs_reference(th):
    img = _rand_img(123, 210)
    want = np.asarray(jfast._reference(jnp.asarray(img), *th))
    got = tfast.fast_nms_rank(torch.from_numpy(img), *th).numpy()
    np.testing.assert_array_equal(want, got)


def test_fast_rank_bit_exact_vs_pallas_interpret(monkeypatch):
    monkeypatch.setenv("DIALOG_TPU_PALLAS_INTERPRET", "1")
    img = _rand_img(96, 150, seed=4)
    want = np.asarray(jfast.fast_nms_rank(jnp.asarray(img), 7.0, 20.0, 19))
    got = tfast.fast_nms_rank(torch.from_numpy(img), 7.0, 20.0, 19).numpy()
    np.testing.assert_array_equal(want, got)


def test_pyramid_and_blur(scenes):
    img = jsynth.render_image(scenes[0], 0)
    pj = jfe.build_pyramid(jnp.asarray(img), JCFG)
    pt = tfe.build_pyramid(torch.from_numpy(img), TCFG)
    for a, b in zip(pj, pt):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-4, rtol=0)
        np.testing.assert_allclose(np.asarray(jfe.gaussian_blur(a)), tfe.gaussian_blur(b).numpy(), atol=1e-4, rtol=0)


def test_detect_and_describe_given_same_pyramid(scenes):
    img = jsynth.render_image(scenes[0], 3)
    counts = jfe.features_per_level(JCFG)
    for l, lvl in enumerate(jfe.build_pyramid(jnp.asarray(img), JCFG)):
        lvl_np = np.array(lvl)
        uv_j, sc_j, va_j = jfe.detect_level(lvl, counts[l], 20.0, 7.0)
        uv_t, sc_t, va_t = tfe.detect_level(torch.from_numpy(lvl_np), counts[l], 20.0, 7.0)
        np.testing.assert_array_equal(np.asarray(uv_j), uv_t.numpy())
        np.testing.assert_array_equal(np.asarray(sc_j), sc_t.numpy())
        np.testing.assert_array_equal(np.asarray(va_j), va_t.numpy())
        blur = np.array(jfe.gaussian_blur(lvl))
        pr_j, pb_j = jfe._gather_patches2(lvl, jnp.asarray(blur), uv_j)
        pr_t, pb_t = tfe._gather_patches2(torch.from_numpy(lvl_np), torch.from_numpy(blur), uv_t)
        np.testing.assert_array_equal(np.asarray(pr_j), pr_t.numpy())
        np.testing.assert_array_equal(np.asarray(pb_j), pb_t.numpy())
        ang_j = jfe.compute_orientation(pr_j)
        np.testing.assert_allclose(np.asarray(ang_j), tfe.compute_orientation(pr_t).numpy(), atol=1e-4)
        desc_j = np.asarray(jfe.compute_descriptors(pb_j, ang_j)).view(np.int32)
        desc_t = tfe.compute_descriptors(pb_t, torch.from_numpy(np.array(ang_j))).numpy()
        np.testing.assert_array_equal(desc_j, desc_t)


@pytest.mark.parametrize("frame", [0, 9])
def test_extract_features_on_rendered_frames(scenes, frame):
    img = jsynth.render_image(scenes[0], frame)
    ref = jax.device_get(jfe.extract_features(jnp.asarray(img), JCFG))
    got = tfe.extract_features(torch.from_numpy(img), TCFG)
    for name in ("uv", "uv_raw", "octave", "valid", "u_right", "depth"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, name)), getattr(got, name).numpy(), err_msg=name)
    # FAST scores on levels > 0 carry the pyramid's 1e-4 f32 differences
    np.testing.assert_allclose(np.asarray(ref.response), got.response.numpy(), atol=1e-3, rtol=0)
    np.testing.assert_array_equal(np.asarray(ref.desc).view(np.int32), got.desc.numpy())
    np.testing.assert_allclose(np.asarray(ref.angle), got.angle.numpy(), atol=1e-4)


def test_render_image_matches_reference(scenes):
    sj, st = scenes
    np.testing.assert_array_equal(sj.xyz, st.xyz)
    np.testing.assert_array_equal(sj.R, st.R)
    for f in (0, 40):
        np.testing.assert_allclose(jsynth.render_image(sj, f), tsynth.render_image(st, f), atol=1e-3, rtol=0)

