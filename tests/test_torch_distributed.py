"""Landmark-sharded global BA over ``torch.distributed`` (``dialog_tpu_torch/distributed.py``).

* ``initialize()`` does nothing without ``MASTER_ADDR`` (the one-process case),
  and ``default_group()`` is then None.
* ``landmark_slice`` gives each rank a contiguous share, padded to one count
  on every rank, each landmark once; ``global_ba.shard_problem`` cuts a
  problem so, with padding that has no observation.
* Two gloo ranks on the CPU (``python -m dialog_tpu_torch.gba_rank``, two
  processes) against one: ``global_bundle_adjustment`` on the port engine's
  map after a 22-frame synthetic sweep (its landmark slots permuted, so both
  ranks hold live landmarks; moved off its optimum by seeded noise), through
  the dense branch (32 keyframe slots: each rank reduces its landmarks, the
  camera sums are all-reduced) and through the PCG (200 slots). Poses within 1e-4 and landmarks within 1e-3 of the one-rank solve,
  the reference's own bounds for 8 devices against 1
  (``tests/test_global_ba_sharded.py``); the same outlier observations
  stripped; both ranks hold the same result, bit for bit.
* The engine's asynchronous GBA through its group path over a one-rank gloo
  group gives the bits of the same GBA without one; renumbered landmark slots
  (``containers.permute_landmarks``) renumber the global problem's rows only.
"""

import pathlib

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dialog_tpu_torch import distributed
from dialog_tpu_torch.config import EngineConfig
from dialog_tpu_torch.containers import permute_landmarks, save_map
from dialog_tpu_torch.datasets import synth
from dialog_tpu_torch.gba_rank import config_to_json, free_address, launch
from dialog_tpu_torch.optim import global_ba
from dialog_tpu_torch.optim.synth_problem import make_problem
from dialog_tpu_torch.system import Engine

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
ITERS = 4
BRANCHES = {"dense": 32, "pcg": 200}   # keyframe slots: C = K cameras, above 192 the PCG
CFG = EngineConfig(width=320, height=240, fx=260.0, fy=260.0, cx=160.0, cy=120.0, n_features=256, max_features=256,
                   max_keyframes=32, max_landmarks=2048, max_local_lms=1024, max_local_kfs=8, max_fixed_kfs=4,
                   max_obs_per_lm=8, init_min_features=40, init_min_matches=40, init_min_good=25)


def test_initialize_is_a_noop_without_the_environment(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    distributed.initialize()
    assert not dist.is_initialized()
    assert distributed.default_group() is None
    x = torch.arange(4.0)
    assert distributed.all_sum(x, None) is x
    assert distributed.gather_landmarks(x, 4, None) is x


@pytest.mark.parametrize("n, world", [(10, 2), (11, 2), (5, 4), (3, 4), (262144, 2), (7, 1)])
def test_landmark_slice_covers_each_landmark_once(n, world):
    slices = [distributed.landmark_slice(n, r, world) for r in range(world)]
    per = slices[0][2]
    assert all(s[2] == per for s in slices)
    assert (per - 1) * world < n <= per * world
    rows = [i for lo, hi, _ in slices for i in range(lo, hi)]
    assert rows == list(range(n))
    for r, (lo, hi, _) in enumerate(slices):
        assert lo == min(r * per, n) and 0 <= hi - lo <= per


def test_shard_problem_pads_every_rank(monkeypatch):
    prob = make_problem(seed=1, device="cpu")[0]
    C, (P, O) = prob.R.shape[0], prob.obs_cam.shape
    world = 3
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: world)
    parts = []
    for r in range(world):
        monkeypatch.setattr(dist, "get_rank", lambda group=None, r=r: r)
        parts.append(global_ba.shard_problem(prob, "a group"))
    lo, hi, per = distributed.landmark_slice(P, world - 1, world)
    last = parts[-1]
    assert all(p.xyz.shape == (per, 3) and p.obs_cam.shape == (per, O) for p in parts)
    assert torch.equal(last.obs_cam[: hi - lo], prob.obs_cam[lo:hi])
    pad = slice(hi - lo, per)
    assert bool((last.obs_cam[pad] == C).all()) and not bool(last.obs_ok[pad].any())
    assert bool((last.obs_w[pad] == 0).all()) and bool((last.lm_ids[pad] == P).all())
    for name in ("lm_ids", "xyz", "obs_cam", "obs_uv", "obs_w", "obs_ok", "obs_feat"):
        whole = torch.cat([getattr(p, name) for p in parts])[:P]
        assert torch.equal(whole, getattr(prob, name)), name
    for name in ("cam_slots", "cam_opt", "R", "t"):
        assert all(getattr(p, name) is getattr(prob, name) for p in parts)


def engine_map(K: int):
    """The port engine's map after 22 frames of a synthetic sweep (CPU), in
    K keyframe slots, its landmark slots permuted from a seed (the engine
    fills them from the bottom; spread out, both ranks hold live ones), its
    optimized keyframes and its landmarks moved by N(0, 1e-2)."""
    cfg = CFG.replace(max_keyframes=K)
    scene = synth.make_scene(seed=5, n_points=600, n_frames=22, cfg=cfg)
    eng = Engine(cfg, device="cpu")
    eng.loop_closing_enabled = False
    for i in range(22):
        eng.track_features(synth.observe(scene, i, noise_px=0.4, device="cpu")[0], i / 30.0)
    rng = np.random.default_rng(3)
    L = cfg.max_landmarks
    m = permute_landmarks(eng.m, torch.from_numpy(rng.permutation(L)))
    t = m.kfs.t.clone()
    opt = m.kfs.valid & (torch.arange(K) >= 2)
    t[opt] += torch.from_numpy(rng.normal(0.0, 1e-2, (int(opt.sum()), 3)).astype(np.float32))
    xyz = m.lms.xyz + torch.from_numpy(rng.normal(0.0, 1e-2, (L, 3)).astype(np.float32)) * m.lms.valid[:, None]
    return cfg, m._replace(kfs=m.kfs._replace(t=t), lms=m.lms._replace(xyz=xyz))


def test_permuted_landmarks_give_the_same_global_problem():
    """Renumbering the landmark slots (``containers.permute_landmarks``)
    renumbers the global problem's rows and nothing else."""
    cfg, m = engine_map(32)
    perm = torch.from_numpy(np.random.default_rng(4).permutation(cfg.max_landmarks))
    a, _ = global_ba.build_global_problem(m, cfg)
    b, _ = global_ba.build_global_problem(permute_landmarks(m, perm), cfg)
    for name in ("xyz", "obs_cam", "obs_uv", "obs_w", "obs_ok", "obs_feat"):
        assert torch.equal(getattr(b, name), getattr(a, name)[perm]), name
    assert torch.equal(b.lm_ids < cfg.max_landmarks, (a.lm_ids < cfg.max_landmarks)[perm])


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both branches' maps solved by two gloo ranks, and by one."""
    tmp = tmp_path_factory.mktemp("gba_ranks")
    jobs, one = [], {}
    for name, K in BRANCHES.items():
        cfg, m = engine_map(K)
        save_map(m, str(tmp / f"{name}.npz"))
        jobs.append({"config": config_to_json(cfg), "map": str(tmp / f"{name}.npz"), "iters": ITERS,
                     "out": str(tmp / f"{name}_out.npz")})
        one[name] = (m, global_ba.global_bundle_adjustment(m, cfg, iters=ITERS))
    spec = {"address": free_address(), "world": 2, "backend": "gloo", "device": "cpu", "jobs": jobs}
    ranks = launch(spec, str(tmp / "job.json"), timeout=240, cwd=ROOT)
    return {name: (one[name], [ranks[r][i] for r in range(2)]) for i, name in enumerate(BRANCHES)}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_two_gloo_ranks_match_one(two_ranks, branch):
    (m0, want), got = two_ranks[branch]
    assert [int(g["world"]) for g in got] == [2, 2] and all(int(g["rows_held"]) == 1024 for g in got)
    assert min(int(g["live_held"]) for g in got) > 50 and sum(int(g["live_held"]) for g in got) == int(m0.lms.valid.sum())
    for k in ("R", "t", "xyz", "obs_lm"):
        np.testing.assert_array_equal(got[0][k], got[1][k], err_msg=k)
    valid_kf, valid_lm = want.kfs.valid.numpy(), want.lms.valid.numpy()
    np.testing.assert_allclose(got[0]["R"][valid_kf], want.kfs.R.numpy()[valid_kf], atol=1e-4)
    np.testing.assert_allclose(got[0]["t"][valid_kf], want.kfs.t.numpy()[valid_kf], atol=1e-4)
    np.testing.assert_allclose(got[0]["xyz"][valid_lm], want.lms.xyz.numpy()[valid_lm], atol=1e-3)
    np.testing.assert_array_equal(got[0]["obs_lm"], want.kfs.obs_lm.numpy())
    # the solve moved the poses
    assert float(np.abs(want.kfs.t.numpy() - m0.kfs.t.numpy()).max()) > 1e-2


def test_engine_gba_over_a_one_rank_group_equals_no_group():
    """The engine's asynchronous GBA through its group path (shard, the
    all-reduces, the landmarks gathered at the fold) over a one-rank gloo
    group gives the bits of the same GBA without a group."""
    cfg, m = engine_map(32)
    maps = []
    dist.init_process_group("gloo", init_method=free_address(), world_size=1, rank=0)
    try:
        for group in (None, dist.group.WORLD):
            eng = Engine(cfg, device="cpu")
            eng.m, eng.ref_kf, eng.group = m, int(torch.nonzero(m.kfs.valid)[-1]), group
            eng._start_gba(3)
            eng.flush()
            assert eng._gba is None and eng.stats["gba_runs"] == 1
            maps.append(eng.m)
    finally:
        dist.destroy_process_group()
    assert distributed.default_group() is None
    for a, b in zip((maps[0].kfs.R, maps[0].kfs.t, maps[0].lms.xyz), (maps[1].kfs.R, maps[1].kfs.t, maps[1].lms.xyz)):
        assert torch.equal(a, b)
    assert not torch.equal(maps[0].kfs.t, m.kfs.t)
