"""Parity of the port's config, map containers and interop with the JAX reference.

Same seeded numpy inputs go through ``dialog_tpu`` and ``dialog_tpu_torch``;
integer bookkeeping (covisibility, observation counts, slot ops, meta packing)
must match exactly, and a map saved by either package must load in the other.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dialog_tpu import config as jconfig
from dialog_tpu import containers as jc
from dialog_tpu_torch import config as tconfig
from dialog_tpu_torch import containers as tc
from dialog_tpu_torch import interop

torch.set_num_threads(2)

SMALL = dict(max_features=64, max_keyframes=8, max_landmarks=256)


def _random_map(seed=0):
    """A reference MapState with random live keyframes, features and landmarks."""
    cfg = jconfig.EngineConfig(**SMALL)
    K, F, L = cfg.max_keyframes, cfg.max_features, cfg.max_landmarks
    rng = np.random.default_rng(seed)
    m = jax.device_get(jc.empty_map(cfg))
    kvalid = np.zeros(K, bool)
    kvalid[:6] = True
    obs = rng.integers(-1, 120, (K, F)).astype(np.int32)
    fv = rng.random((K, F)) > 0.2
    lvalid = np.zeros(L, bool)
    lvalid[:120] = rng.random(120) > 0.1
    kfs = m.kfs._replace(
        valid=kvalid, obs_lm=obs, feat_valid=fv,
        desc=rng.integers(0, 2**32, (K, F, 8), dtype=np.uint32),
        seq=np.where(kvalid, np.arange(K), -1).astype(np.int32),
        parent=np.where(kvalid, np.arange(K) - 1, -1).astype(np.int32),
        R=np.broadcast_to(np.eye(3, dtype=np.float32), (K, 3, 3)).copy(),
        t=rng.normal(size=(K, 3)).astype(np.float32),
    )
    lms = m.lms._replace(
        valid=lvalid, xyz=rng.normal(size=(L, 3)).astype(np.float32),
        desc=rng.integers(0, 2**32, (L, 8), dtype=np.uint32),
    )
    m = m._replace(kfs=kfs, lms=lms, lm_dropped=np.int32(3))
    return cfg, jax.tree_util.tree_map(jnp.asarray, m)


def _port_cfg(jcfg):
    return tconfig.EngineConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
                                   if f.name != "sensor"})


class TestConfig:
    def test_fields_and_defaults_match(self):
        jf = [(f.name, f.default) for f in dataclasses.fields(jconfig.EngineConfig)]
        tf = [(f.name, f.default) for f in dataclasses.fields(tconfig.EngineConfig)]
        assert [n for n, _ in jf] == [n for n, _ in tf]
        for (n, a), (_, b) in zip(jf, tf):
            if n == "sensor":
                assert a.name == b.name and a.value == b.value
            else:
                assert a == b, n
        assert tconfig.TUM1.fx == jconfig.TUM1.fx and tconfig.KITTI00.bf == jconfig.KITTI00.bf

    def test_load_yaml_matches(self, tmp_path):
        p = tmp_path / "cam.yaml"
        p.write_text("%YAML:1.0\nCamera.fx: 400.5\nCamera.fy: 401.0\nCamera.width: 320\n"
                     "ORBextractor.nFeatures: 500 # comment\nThDepth: 35.0\n")
        a = jconfig.load_yaml(str(p), n_levels=4)
        b = tconfig.load_yaml(str(p), n_levels=4)
        for f in dataclasses.fields(a):
            if f.name != "sensor":
                assert getattr(a, f.name) == getattr(b, f.name), f.name
        assert b.grid_cols == a.grid_cols and b.baseline == a.baseline


class TestContainers:
    def test_empty_map_layout(self):
        cfg = jconfig.EngineConfig(**SMALL)
        ref = jax.device_get(jc.empty_map(cfg))
        got = interop.map_to_numpy(tc.empty_map(_port_cfg(cfg), device="cpu"))
        for part in ("kfs", "lms"):
            for name in getattr(ref, part)._fields:
                a = np.asarray(getattr(getattr(ref, part), name))
                b = got[part][name]
                assert a.shape == b.shape and a.dtype == b.dtype, (part, name)
                np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("seed", [0, 1])
    def test_covis_and_counts(self, seed):
        cfg, m = _random_map(seed)
        tm = interop.map_from_numpy(jax.device_get(m), device="cpu")
        for k in (0, 3):
            np.testing.assert_array_equal(
                np.asarray(jc.covis_row_for_kf(m, jnp.int32(k))), tc.covis_row_for_kf(tm, k).numpy()
            )
            np.testing.assert_array_equal(
                np.asarray(jc.update_covis_for_kf(m, jnp.int32(k)).covis),
                tc.update_covis_for_kf(tm, k).covis.numpy(),
            )
        np.testing.assert_array_equal(
            np.asarray(jc.recount_lm_obs(m).lms.n_obs), tc.recount_lm_obs(tm).lms.n_obs.numpy()
        )

    def test_slot_ops(self):
        cfg, m = _random_map(2)
        tm = interop.map_from_numpy(jax.device_get(m), device="cpu")
        assert int(jc.first_free_kf_slot(m)) == int(tc.first_free_kf_slot(tm))
        np.testing.assert_array_equal(np.asarray(jc.free_lm_slots(m, 300)), tc.free_lm_slots(tm, 300).numpy())
        assert int(jc.lm_capacity_left(m)) == int(tc.lm_capacity_left(tm))

    def test_map_meta(self):
        cfg, m = _random_map(3)
        tm = interop.map_from_numpy(jax.device_get(m), device="cpu")
        a = np.asarray(jc.pack_map_meta(m))
        b = tc.pack_map_meta(tm).numpy()
        np.testing.assert_array_equal(a, b)
        ma, mb = jc.MapMeta(a, cfg.max_keyframes), tc.MapMeta(tc.pack_map_meta(tm), cfg.max_keyframes)
        for f in jc.MapMeta.__slots__:
            np.testing.assert_array_equal(np.asarray(getattr(ma, f)), np.asarray(getattr(mb, f)))
        for x, y in zip(jc.parse_map_meta(a, cfg.max_keyframes), tc.parse_map_meta(b, cfg.max_keyframes)):
            np.testing.assert_array_equal(x, y)


class TestCheckpointCrossLoad:
    def test_port_loads_reference_map(self, tmp_path):
        cfg, m = _random_map(4)
        p = str(tmp_path / "ref.npz")
        jc.save_map(m, p)
        got = interop.map_to_numpy(tc.load_map(_port_cfg(cfg), p, device="cpu"))
        np.testing.assert_array_equal(got["kfs"]["desc"], np.asarray(m.kfs.desc))
        np.testing.assert_array_equal(got["kfs"]["obs_lm"], np.asarray(m.kfs.obs_lm))
        np.testing.assert_array_equal(got["lms"]["xyz"], np.asarray(m.lms.xyz))
        assert int(got["lm_dropped"]) == 3

    def test_reference_loads_port_map(self, tmp_path):
        cfg, m = _random_map(5)
        p = str(tmp_path / "port.npz")
        tc.save_map(interop.map_from_numpy(jax.device_get(m), device="cpu"), p)
        back = jc.load_map(cfg, p)
        assert back.kfs.desc.dtype == jnp.uint32
        np.testing.assert_array_equal(np.asarray(back.kfs.desc), np.asarray(m.kfs.desc))
        np.testing.assert_array_equal(np.asarray(back.lms.desc), np.asarray(m.lms.desc))
        np.testing.assert_array_equal(np.asarray(back.covis), np.asarray(m.covis))

    def test_capacity_mismatch_raises(self, tmp_path):
        cfg, m = _random_map(6)
        p = str(tmp_path / "ref.npz")
        jc.save_map(m, p)
        with pytest.raises(ValueError, match="capacity"):
            tc.load_map(_port_cfg(cfg).replace(max_landmarks=512), p, device="cpu")

    def test_interop_roundtrip_is_exact(self):
        cfg, m = _random_map(7)
        back = interop.map_to_numpy(interop.map_from_numpy(jax.device_get(m), device="cpu"))
        for part in ("kfs", "lms"):
            for name in getattr(m, part)._fields:
                a = np.asarray(getattr(getattr(m, part), name))
                assert back[part][name].dtype == a.dtype, name
                np.testing.assert_array_equal(back[part][name], a)

    def test_interop_keeps_stereo_fields(self):
        """A stereo keyframe store's u_right/depth and a problem's obs_ur
        cross over exactly; a mono problem's absent obs_ur stays None."""
        cfg, m = _random_map(8)
        rng = np.random.default_rng(8)
        shape = m.kfs.u_right.shape
        u_right = np.where(rng.random(shape) < 0.5, rng.uniform(0, 600, shape), -1.0).astype(np.float32)
        depth = np.where(u_right >= 0, rng.uniform(0.5, 20, shape), -1.0).astype(np.float32)
        m = m._replace(kfs=m.kfs._replace(u_right=jnp.asarray(u_right), depth=jnp.asarray(depth)))
        tm = interop.map_from_numpy(jax.device_get(m), device="cpu")
        np.testing.assert_array_equal(tm.kfs.u_right.numpy(), u_right)
        np.testing.assert_array_equal(tm.kfs.depth.numpy(), depth)
        back = interop.map_to_numpy(tm)
        np.testing.assert_array_equal(back["kfs"]["u_right"], u_right)
        np.testing.assert_array_equal(back["kfs"]["depth"], depth)

        from dialog_tpu.optim.synth_problem import FIXTURE_CFG, make_problem

        for stereo_frac in (0.5, 0.0):
            prob = jax.device_get(make_problem(seed=0, cfg=FIXTURE_CFG.replace(bf=FIXTURE_CFG.fx * 0.12),
                                               stereo_frac=stereo_frac)[0])
            got = interop.problem_from_numpy(prob, device="cpu")
            assert got._fields == prob._fields
            for name in prob._fields:
                a = getattr(prob, name)
                if a is None:
                    assert getattr(got, name) is None, name
                else:
                    np.testing.assert_array_equal(np.asarray(a), getattr(got, name).numpy(), err_msg=name)
            assert (got.obs_ur is not None) == (stereo_frac > 0)
