"""The batched frontends of the port: against the port's own per-image
entries, and against ``dialog_tpu``.

* ``extract_features_batch``: every leaf of image b equal, bit for bit, to
  ``_extract_one`` / ``extract_features`` of that image (the batch path keeps
  its float matrix products one image at a time for exactly this); against
  ``dialog_tpu.frontend.extract_features_batch`` the tolerances of
  ``test_torch_frontend.py``: keypoints, octaves, validity and descriptors
  equal, responses 1e-3, angles 1e-4 rad.
* Kernel A's plain version on stacks [B, H_l, W_l]: equal to the per-level
  plain version image by image, to the reference's ``_reference`` and to its
  Pallas body in interpret mode.
* ``extract_and_match_stereo_batch``: equal to the port's per-pair path bit
  for bit; against the reference on two rendered half-size KITTI pairs the
  validity of ``u_right`` equal, ``u_right`` within 1e-3 px and ``depth``
  within 1e-4 relative where valid.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dialog_tpu import frontend as jfe
from dialog_tpu import stereo as jst
from dialog_tpu.config import EngineConfig as JConfig, Sensor as JSensor
from dialog_tpu.kernels import fast as jfast
from dialog_tpu_torch import frontend as tfe
from dialog_tpu_torch import stereo as tst
from dialog_tpu_torch.config import KITTI00, EngineConfig as TConfig, Sensor as TSensor
from dialog_tpu_torch.datasets import synth as tsynth
from dialog_tpu_torch.kernels import fast as tfast
from dialog_tpu_torch.profile_main_path import render_stereo_frames

torch.set_num_threads(2)

SMALL = dict(width=320, height=240, fx=258.653204, fy=258.2346075, cx=159.32152, cy=127.6569945,
             n_features=300, max_features=320, n_levels=4)
HALF_KITTI = dict(width=620, height=188, fx=KITTI00.fx / 2, fy=KITTI00.fy / 2, cx=KITTI00.cx / 2,
                  cy=KITTI00.cy / 2, bf=KITTI00.bf / 2, n_features=600, max_features=640)
B = 3


@pytest.fixture(scope="module")
def images():
    scene = tsynth.make_scene(seed=3, n_points=2500, n_frames=168, cfg=TConfig(**SMALL))
    return np.stack([tsynth.render_image(scene, i) for i in (0, 5, 9)])


def _assert_frames_equal(one, batch, b):
    for name in one._fields:
        assert torch.equal(getattr(one, name), getattr(batch, name)[b]), (b, name)


@pytest.mark.parametrize("max_features", [320, 256], ids=["padded", "cut-to-strongest"])
def test_batch_equals_extract_one_bit_for_bit(images, max_features):
    cfg = TConfig(**{**SMALL, "max_features": max_features})
    batch = tfe.extract_features_batch(torch.from_numpy(images), cfg)
    assert batch.uv.shape == (B, max_features, 2) and batch.desc.shape == (B, max_features, 8)
    assert batch.valid.dtype == torch.bool and batch.octave.dtype == torch.int32
    for b in range(B):
        _assert_frames_equal(tfe._extract_one(torch.from_numpy(images[b]), cfg), batch, b)
        _assert_frames_equal(tfe.extract_features(torch.from_numpy(images[b]), cfg), batch, b)
    assert int(batch.valid.sum()) > 0.8 * min(300, max_features) * B


def test_batch_of_one_and_wrong_shapes(images):
    cfg = TConfig(**SMALL)
    one = tfe.extract_features_batch(torch.from_numpy(images[:1]), cfg)
    _assert_frames_equal(tfe.extract_features(torch.from_numpy(images[0]), cfg), one, 0)
    with pytest.raises(ValueError):
        tfe.extract_features_batch(torch.from_numpy(images[0]), cfg)
    with pytest.raises(ValueError):
        tfe.extract_features_batch(torch.from_numpy(images[:, :200]), cfg)


def test_batch_matches_reference_batch(images):
    ref = jax.device_get(jfe.extract_features_batch(jnp.asarray(images), JConfig(**SMALL)))
    got = tfe.extract_features_batch(torch.from_numpy(images), TConfig(**SMALL))
    for name in ("uv", "uv_raw", "octave", "valid", "u_right", "depth"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, name)), getattr(got, name).numpy(), err_msg=name)
    np.testing.assert_allclose(np.asarray(ref.response), got.response.numpy(), atol=1e-3, rtol=0)
    np.testing.assert_array_equal(np.asarray(ref.desc).view(np.int32), got.desc.numpy())
    np.testing.assert_allclose(np.asarray(ref.angle), got.angle.numpy(), atol=1e-4)


@pytest.mark.parametrize("pad_to", [1, 16])
def test_batched_plain_fast_equals_per_level_plain(images, pad_to):
    cfg = TConfig(**SMALL)
    th = (float(cfg.min_th_fast), float(cfg.ini_th_fast), tfe.BORDER)
    pyr = tfe.build_pyramid(torch.from_numpy(images), cfg)
    assert [tuple(p.shape) for p in pyr] == [(B,) + s for s in tfe.level_shapes(cfg)]
    # the wrapper takes the plain version for CPU stacks
    got = tfast.fast_nms_rank_levels_batch(pyr, *th, pad_to=pad_to)
    for b in range(B):
        want = tfast.fast_nms_rank_levels_plain([p[b] for p in pyr], *th, pad_to=pad_to)
        for g, w in zip(got, want):
            assert g.shape[1:] == w.shape and torch.equal(g[b], w)
    assert int((got[0] > 1000).sum()) > 50
    assert all(g.shape[1] % pad_to == 0 and g.shape[2] % pad_to == 0 for g in got)


def test_batched_fast_wrapper_rejects_mixed_batches(images):
    pyr = tfe.build_pyramid(torch.from_numpy(images), TConfig(**SMALL))
    with pytest.raises(ValueError):
        tfast.fast_nms_rank_levels_batch([pyr[0], pyr[1][:2]], 7.0, 20.0, 19)
    with pytest.raises(ValueError):
        tfast.fast_nms_rank_levels_batch([pyr[0][0]], 7.0, 20.0, 19)
    with pytest.raises(ValueError):
        tfast.fast_nms_rank_levels_batch(pyr, 7.0, 20.0, 19, pad_to=0)
    assert tfast.fast_nms_rank_levels_batch([], 7.0, 20.0, 19) == []


@pytest.mark.parametrize("mode", ["reference-plain", "pallas-interpret"])
def test_batched_plain_fast_bit_exact_vs_reference(mode, monkeypatch):
    rng = np.random.default_rng(8)
    stack = rng.uniform(0, 255, (2, 96, 150)).astype(np.float32)
    got = tfast.fast_nms_rank_levels_batch([torch.from_numpy(stack)], 7.0, 20.0, 19)[0].numpy()
    for b in range(2):
        if mode == "pallas-interpret":
            monkeypatch.setenv("DIALOG_TPU_PALLAS_INTERPRET", "1")
            want = jfast.fast_nms_rank(jnp.asarray(stack[b]), 7.0, 20.0, 19)
        else:
            want = jfast._reference(jnp.asarray(stack[b]), 7.0, 20.0, 19)
        np.testing.assert_array_equal(np.asarray(want), got[b])


@pytest.fixture(scope="module")
def stereo_pairs():
    cfg = TConfig(**HALF_KITTI, sensor=TSensor.STEREO)
    _, pairs = render_stereo_frames(cfg, 2)
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


def test_stereo_batch_equals_per_pair_bit_for_bit(stereo_pairs):
    cfg = TConfig(**HALF_KITTI, sensor=TSensor.STEREO)
    left, right = (torch.from_numpy(x) for x in stereo_pairs)
    batch = tst.extract_and_match_stereo_batch(left, right, cfg)
    for b in range(2):
        one = tst.stereo_match_frames(tfe.extract_features(left[b], cfg), tfe.extract_features(right[b], cfg), cfg,
                                      img_left=left[b], img_right=right[b])
        _assert_frames_equal(one, batch, b)
    assert int((batch.depth > 0).sum()) > 100


def test_stereo_batch_matches_reference(stereo_pairs):
    left, right = stereo_pairs
    ref = jax.device_get(jst.extract_and_match_stereo_batch(jnp.asarray(left), jnp.asarray(right),
                                                            JConfig(**HALF_KITTI, sensor=JSensor.STEREO)))
    got = tst.extract_and_match_stereo_batch(torch.from_numpy(left), torch.from_numpy(right),
                                             TConfig(**HALF_KITTI, sensor=TSensor.STEREO))
    for name in ("uv", "octave", "valid"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, name)), getattr(got, name).numpy(), err_msg=name)
    np.testing.assert_array_equal(np.asarray(ref.desc).view(np.int32), got.desc.numpy())
    ok_j, ok_t = np.asarray(ref.u_right) >= 0, got.u_right.numpy() >= 0
    np.testing.assert_array_equal(ok_j, ok_t)
    assert ok_j.sum() > 100
    np.testing.assert_allclose(np.asarray(ref.u_right)[ok_j], got.u_right.numpy()[ok_j], atol=1e-3, rtol=0)
    np.testing.assert_allclose(np.asarray(ref.depth)[ok_j], got.depth.numpy()[ok_j], rtol=1e-4, atol=0)
    np.testing.assert_array_equal(np.asarray(ref.depth)[~ok_j], got.depth.numpy()[~ok_j])
