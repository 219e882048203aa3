"""Loop closing in the port against the reference, module by module.

The JAX engine tracks the first frames of the synthetic orbit with loop
closing off and trains its vocabulary on the way. Its map, keyframe BoW
database and codebook are carried into the port (``interop``). Then, on the
same state:

* ``_pack_detect``: the covisibility row, validity, insertion numbers, shared
  word counts and neighbour matrix equal; the BoW scores within 1e-6 (an f32
  sum over the words, in another order);
* ``detect`` over every keyframe in turn, and ``evaluate`` over a seeded
  sequence of detection vectors built to pass the consistency gate: the same
  candidates and the same consistency groups;
* ``compute_sim3`` of a late keyframe against earlier ones, the port drawing
  the reference's own minimal sets: the same outcome, the same guided match
  count, and s, R, t within 1e-3 (after RANSAC's refit and the refinement);
* ``build_pose_graph`` on the engine's map: the edge lists equal exactly,
  the measurements within 1e-5; the reference's problem carried over
  (``interop.pose_graph_from_numpy``) solves as the port's own within 1e-5;
* ``correct`` with a loop edge that disagrees with the map (the similarity
  scaled by 1.05 and turned by 0.02 rad): poses and landmarks within 2e-3
  (15 damped Gauss-Newton steps on each side), the same landmarks fused;
* the engines' ``_close_loop_from`` on the same map and candidates, the port
  drawing from ``ReferenceStream`` (the JAX engine's key): the same closure,
  the stream's key equal to the JAX engine's after it, and the next PnP
  draw (a relocalization) the same in both.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dialog_tpu import loopclosing as jlc
from dialog_tpu import pnp as jpnp
from dialog_tpu.config import EngineConfig as JConfig
from dialog_tpu.datasets import synth as jsynth
from dialog_tpu.system import Engine as JEngine
from dialog_tpu_torch import geometry as tg
from dialog_tpu_torch import interop
from dialog_tpu_torch import loopclosing as tlc
from dialog_tpu_torch import pnp as tpnp
from dialog_tpu_torch.config import EngineConfig as TConfig
from dialog_tpu_torch.system import LOST, Engine as TEngine
from test_torch_batch_engine import ReferenceStream

torch.set_num_threads(2)

CFG = dict(max_features=256, max_keyframes=16, max_landmarks=4096, max_local_lms=1024,
           max_local_kfs=6, max_fixed_kfs=4, max_obs_per_lm=6, max_frames_between_kf=4,
           vocab_min_kfs=3, vocab_words=64)
N = 28
SCORE_TOL = 1e-6
SIM3_TOL = 1e-3
CORRECT_TOL = 2e-3


@pytest.fixture(scope="module")
def state():
    scene = jsynth.make_scene(seed=7, n_points=8000, n_frames=200, trajectory="loop", cfg=JConfig(**CFG), period=200)
    jeng = JEngine(JConfig(**CFG))
    jeng.loop_closing_enabled = False
    for i in range(N):
        jeng.track_features(jsynth.observe(scene, i, noise_px=0.5, desc_flips=6)[0], float(i) / 30.0)
    assert jeng._vocab is not None and jeng.kf_count >= 6, jeng.kf_count
    jm = jeng.m
    tm = interop.map_from_numpy(jax.device_get(jm), device="cpu")
    tdb = interop.bow_db_from_numpy(jax.device_get(jeng._bow_db), device="cpu")
    tvoc = interop.vocab_from_numpy(jax.device_get(jeng._vocab), device="cpu")
    live = [int(k) for k in np.argsort(np.asarray(jm.kfs.seq)) if bool(jm.kfs.valid[k])]
    return dict(jeng=jeng, jm=jm, tm=tm, tdb=tdb, tvoc=tvoc, live=live, scene=scene)


def test_pack_detect(state):
    for kf in state["live"]:
        vj, nj = jax.device_get(jlc._pack_detect(state["jm"], state["jeng"]._bow_db, jnp.int32(kf)))
        vt, nt = tlc._pack_detect(state["tm"], state["tdb"], kf)
        K = nj.shape[0]
        np.testing.assert_allclose(vt[:K].numpy(), vj[:K], atol=SCORE_TOL, rtol=0)
        np.testing.assert_array_equal(vt[K:].numpy(), vj[K:])
        assert nt.dtype == torch.uint8
        np.testing.assert_array_equal(nt.numpy(), nj)


def test_detect_over_the_keyframes(state):
    ref, port = jlc.LoopCloser(JConfig(**CFG)), tlc.LoopCloser(TConfig(**CFG))
    for n, kf in enumerate(state["live"]):
        got_j = ref.detect(state["jm"], state["jeng"]._bow_db, state["jeng"]._vocab, kf, stamp=100 + n)
        got_t = port.detect(state["tm"], state["tdb"], state["tvoc"], kf, stamp=100 + n)
        assert got_t == got_j
        assert port._consistent == ref._consistent
        assert port.last_eval_det_seq == ref.last_eval_det_seq
    assert port.take_pending()[0] == ref.take_pending()[0] == state["live"][-1]


def _detection_sequence(seed=3, K=24, n=6):
    """Detection vectors of a map of K keyframes (slot = insertion number) that
    revisits keyframes 0-5 from keyframes 18-23: those score high, their
    covisibility groups overlap from one evaluation to the next, and the
    rest score at random."""
    rng = np.random.default_rng(seed)
    neigh = np.zeros((K, K), np.uint8)
    for k in range(K):
        for d in (1, 2):
            if k + d < K:
                neigh[k, k + d] = neigh[k + d, k] = 1
    out = []
    for step in range(n):
        cur = K - n + step
        scores = rng.uniform(0.0, 0.2, K).astype(np.float32)
        scores[: 6] = rng.uniform(0.5, 0.9, 6)
        covis = np.zeros(K, np.float32)
        covis[max(cur - 2, 0): cur] = 30.0
        common = rng.integers(5, 40, K).astype(np.float32)
        common[: 6] = 60.0
        vec = np.concatenate([scores, covis, np.ones(K, np.float32), np.arange(K, dtype=np.float32), common])
        out.append((cur, vec, neigh))
    return out


def test_evaluate_sequence():
    ref, port = jlc.LoopCloser(JConfig(**CFG)), tlc.LoopCloser(TConfig(**CFG))
    accepted = []
    for stamp, (cur, vec, neigh) in enumerate(_detection_sequence()):
        got_j = ref.evaluate(cur, vec.copy(), neigh, stamp=stamp)
        got_t = port.evaluate(cur, vec.copy(), neigh, stamp=stamp)
        assert got_t == got_j
        assert port._consistent == ref._consistent and port._eval_stamp == ref._eval_stamp
        accepted += got_t
    assert accepted, "the sequence never passed the consistency gate"


def _sim3_both(state, cur, cand):
    """compute_sim3 in both packages, the port drawing the reference's minimal sets."""
    key = jax.random.PRNGKey(cur * 97 + cand)
    cfg = JConfig(**CFG)
    ref = jlc.LoopCloser(cfg).compute_sim3(state["jm"], cur, cand, key)
    n_guided = {}

    def pick(valid, iters, generator=None):
        return torch.from_numpy(np.array(jax.random.randint(key, (iters, 3), 0, max(int(valid.sum()), 1))))

    guided = tlc._guided_sim3_matches

    def count(*args):
        n_guided["port"] = guided(*args)
        return n_guided["port"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tlc, "draw_sim3_sets", pick)
        mp.setattr(tlc, "_guided_sim3_matches", count)
        got = tlc.LoopCloser(TConfig(**CFG)).compute_sim3(state["tm"], cur, cand)
    return ref, got, n_guided.get("port")


def test_compute_sim3_parity(state):
    live = state["live"]
    cur = live[-1]
    closed = 0
    for cand in live[-4:-1] + live[:2]:
        ref, got, n_port = _sim3_both(state, cur, cand)
        assert (ref is None) == (got is None), (cur, cand)
        if ref is None:
            continue
        closed += 1
        assert got.cand_kf == ref.cand_kf == cand
        n_ref = int(jlc._guided_sim3_matches(state["jm"], jnp.int32(cur), jnp.int32(cand), jnp.float32(ref.s),
                                             jnp.asarray(ref.R), jnp.asarray(ref.t), JConfig(**CFG)))
        assert int(n_port) == n_ref
        assert abs(got.s - ref.s) < SIM3_TOL
        np.testing.assert_allclose(got.R, ref.R, atol=SIM3_TOL, rtol=0)
        np.testing.assert_allclose(got.t, ref.t, atol=SIM3_TOL, rtol=0)
        assert abs(got.n_inliers - ref.n_inliers) <= 2
    assert closed >= 1


def test_guided_match_count_under_the_same_similarity(state):
    """The guided pass alone, both packages given one similarity per pair: the counts are equal."""
    live, cfg = state["live"], JConfig(**CFG)
    for cand in live[-4:-1]:
        R_c = np.asarray(state["jm"].kfs.R[cand]) @ np.asarray(state["jm"].kfs.R[live[-1]]).T
        t_c = np.asarray(state["jm"].kfs.t[cand]) - R_c @ np.asarray(state["jm"].kfs.t[live[-1]])
        n_j = int(jlc._guided_sim3_matches(state["jm"], jnp.int32(live[-1]), jnp.int32(cand), jnp.float32(1.0),
                                           jnp.asarray(R_c, jnp.float32), jnp.asarray(t_c, jnp.float32), cfg))
        n_t = int(tlc._guided_sim3_matches(state["tm"], live[-1], cand, torch.tensor(1.0),
                                           torch.from_numpy(R_c.astype(np.float32)),
                                           torch.from_numpy(t_c.astype(np.float32)), TConfig(**CFG)))
        assert n_t == n_j and n_j > 0


def test_correct_parity(state):
    live = state["live"]
    cur, cand = live[-1], live[-3]
    ref, _, _ = _sim3_both(state, cur, cand)
    assert ref is not None
    # a loop edge the map disagrees with, as after drift
    dR = np.asarray(tg.so3_exp(torch.tensor([0.0, 0.02, 0.0])).numpy())
    loop = jlc.LoopCandidate(cand_kf=cand, s=ref.s * 1.05, R=(dR @ ref.R).astype(np.float32),
                             t=(ref.t * 1.05).astype(np.float32), n_inliers=ref.n_inliers)
    jm = jlc.LoopCloser(JConfig(**CFG)).correct(state["jm"], cur, loop, JConfig(**CFG))
    port = tlc.LoopCloser(TConfig(**CFG))
    tm = port.correct(state["tm"], cur, tlc.LoopCandidate(**vars(loop)), TConfig(**CFG))
    assert port.closed_loops == [(cur, cand)]
    jm = jax.device_get(jm)
    moved = np.abs(np.asarray(jm.kfs.t) - np.asarray(state["jm"].kfs.t)).max()
    assert moved > 10 * CORRECT_TOL, moved
    np.testing.assert_allclose(tm.kfs.R.numpy(), jm.kfs.R, atol=CORRECT_TOL, rtol=0)
    np.testing.assert_allclose(tm.kfs.t.numpy(), jm.kfs.t, atol=CORRECT_TOL, rtol=0)
    np.testing.assert_array_equal(tm.lms.valid.numpy(), jm.lms.valid)
    live_lm = np.asarray(jm.lms.valid)
    np.testing.assert_allclose(tm.lms.xyz.numpy()[live_lm], jm.lms.xyz[live_lm], atol=CORRECT_TOL, rtol=0)
    np.testing.assert_array_equal(tm.kfs.obs_lm.numpy(), jm.kfs.obs_lm)
    np.testing.assert_array_equal(tm.covis.numpy(), jm.covis)


@pytest.mark.parametrize("th", [100, 15])
def test_build_pose_graph_on_the_engine_map(state, th):
    """The essential graph of the JAX engine's map: edge lists equal exactly, measurements within 1e-5;
    the reference's problem carried over (``interop.pose_graph_from_numpy``) solves to the port's own."""
    from dialog_tpu.optim import pose_graph as jpg
    from dialog_tpu_torch.optim import pose_graph as tpg

    live = state["live"]
    cur, cand = live[-1], live[0]
    jcfg, tcfg = JConfig(**CFG, essential_covis_th=th), TConfig(**CFG, essential_covis_th=th)
    R, t = np.asarray(state["jm"].kfs.R), np.asarray(state["jm"].kfs.t)
    loop_R = (R[cur] @ R[cand].T).astype(np.float32)
    loop_t = (1.05 * (t[cur] - loop_R @ t[cand])).astype(np.float32)
    ref = jpg.build_pose_graph(state["jm"], jcfg, jnp.int32(cur), jnp.int32(cand), jnp.float32(1.05),
                               jnp.asarray(loop_R), jnp.asarray(loop_t), jnp.int32(cand))
    got = tpg.build_pose_graph(state["tm"], tcfg, cur, cand, 1.05, torch.from_numpy(loop_R),
                               torch.from_numpy(loop_t), cand)
    for name in ("opt", "e_i", "e_j", "e_ok"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, name)), getattr(got, name).numpy(), err_msg=name)
    for name in ("s", "R", "t", "m_s", "m_R", "m_t", "e_w"):
        np.testing.assert_allclose(np.asarray(getattr(ref, name)), getattr(got, name).numpy(), atol=1e-5, rtol=0,
                                   err_msg=name)
    n_cov = int(got.e_ok[len(got.s):-1].sum())
    assert n_cov > 0                                          # the covisibility edges are there
    carried = interop.pose_graph_from_numpy(jax.device_get(ref), device="cpu")
    for a, b in zip(tpg.solve_pose_graph(carried, iters=15)[:3], tpg.solve_pose_graph(got, iters=15)[:3]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)


def _carried_engines(state):
    """A JAX engine and a port engine on the fixture's map, codebook, BoW rows and bookkeeping."""
    import copy

    jeng = copy.copy(state["jeng"])
    jeng._loop = jlc.LoopCloser(jeng.cfg)
    jeng.trajectory = list(jeng.trajectory)
    teng = TEngine(TConfig(**CFG), device="cpu")
    teng.m = interop.map_from_numpy(jax.device_get(jeng.m), device="cpu")
    teng._vocab, teng._bow_db = state["tvoc"], state["tdb"].clone()
    teng._vocab_trained_kfs = jeng._vocab_trained_kfs
    teng.kf_count, teng.ref_kf, teng.frame_id = jeng.kf_count, jeng.ref_kf, jeng.frame_id
    teng._last_R, teng._last_t = np.array(jeng._last_R), np.array(jeng._last_t)
    teng._kf_valid_host = np.array(jeng.m.kfs.valid)
    return jeng, teng


def test_reference_stream_stays_in_step_after_a_closure(state):
    """The JAX engine splits its key once per ``compute_sim3`` call (``dialog_tpu/system.py:1384``), before
    the call, so an attempt that stops at the match count takes a split too. With ``ReferenceStream`` the
    port's closure draws the same Sim3 sets, and after it the stream's key is the JAX engine's: the next PnP
    draw is equal in both."""
    live = state["live"]
    jeng, teng = _carried_engines(state)
    seq = np.asarray(jeng.m.kfs.seq)
    # the first two keyframes, then the third from the end (it closes: test_correct_parity)
    cands = [(c, int(seq[c])) for c in (live[0], live[1], live[-3])]
    stream = ReferenceStream()
    stream.key = jeng._key
    sim3_keys = {"jax": [], "port": []}
    j_sim3, t_pnp, j_pnp = jlc.LoopCloser.compute_sim3, tpnp.solve_pnp_ransac, jpnp.solve_pnp_ransac
    picks = {}

    def j_compute(loop, m, cur, cand, key):
        sim3_keys["jax"].append(np.array(key))
        return j_sim3(loop, m, cur, cand, key)

    def t_solve(X, uv, ok, fx, fy, cx, cy, pick, **kw):
        picks["port"] = pick.numpy().copy()
        return t_pnp(X, uv, ok, fx, fy, cx, cy, pick, **kw)

    def j_solve(X, uv, valid, fx, fy, cx, cy, key, iters=256, **kw):
        n_valid = max(int(np.sum(np.asarray(valid))), 1)
        picks["jax"] = np.array(jax.random.randint(key, (iters, 6), 0, n_valid))
        return j_pnp(X, uv, valid, fx, fy, cx, cy, key, iters=iters, **kw)

    with pytest.MonkeyPatch.context() as mp:
        stream.patch(mp)
        mp.setattr(jlc.LoopCloser, "compute_sim3", j_compute)
        mp.setattr(tpnp, "solve_pnp_ransac", t_solve)
        mp.setattr(jpnp, "solve_pnp_ransac", j_solve)
        sim3_draw = tlc.draw_sim3_sets          # as the stream patched it

        def t_sets(valid, iters, generator=None):
            sim3_keys["port"].append(np.array(getattr(stream, "_sim3_key", None)))
            return sim3_draw(valid, iters, generator)

        mp.setattr(tlc, "draw_sim3_sets", t_sets)
        for eng in (jeng, teng):
            eng._loop.last_eval_det_seq = None
            eng._close_loop_from(live[-1], cands)
        # the same closure, after the same attempts; each Sim3 draw of the port from the key the JAX engine
        # passed to that attempt
        assert teng._loop.closed_loops == jeng._loop.closed_loops and jeng._loop.closed_loops
        assert sim3_keys["port"] and all(any(np.array_equal(k, j) for j in sim3_keys["jax"])
                                         for k in sim3_keys["port"])
        np.testing.assert_array_equal(sim3_keys["port"][-1], sim3_keys["jax"][-1])
        np.testing.assert_array_equal(np.array(stream.key), np.array(jeng._key))
        # then relocalizations, until one reaches PnP: the next PnP draw is the JAX engine's
        for fid in (N - 1, N - 8, N - 16):
            frame_j = jsynth.observe(state["scene"], fid, noise_px=0.5, desc_flips=6, seed=99)[0]
            frame_t = interop.frame_from_numpy(jax.device_get(frame_j), device="cpu")
            for eng, fr in ((jeng, frame_j), (teng, frame_t)):
                eng.state, eng._vel = LOST, None
                eng._try_relocalize(fr, 1.0)
            assert ("jax" in picks) == ("port" in picks)
            if picks:
                break
    assert "jax" in picks and "port" in picks
    np.testing.assert_array_equal(picks["port"], picks["jax"])
    np.testing.assert_array_equal(np.array(stream.key), np.array(jeng._key))
