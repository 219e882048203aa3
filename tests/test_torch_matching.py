"""Parity of the port's matching (kernel B + match policies) with ``dialog_tpu``.

Tolerance: bit-exact throughout -- every output is an integer index or
distance. Kernel B is held against the reference's ``_reference`` on the four
``selfcheck.check_hamming`` cases and against its Pallas body run in
interpret mode (including the lowest-column tie rule). ``match_projected``
always takes the port's fused path (kernel B's mutual mode on the card, its
two-call plain form here); the reference's CPU path
(``match_mutual`` on the dense gated matrix) must give the same matches.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dialog_tpu import matching as jm
from dialog_tpu.kernels import hamming as jh
from dialog_tpu_torch import matching as tm
from dialog_tpu_torch.kernels import hamming as th

torch.set_num_threads(2)


def _inputs(n, m, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        a=rng.integers(0, 2**32, (n, 8), dtype=np.uint32),
        b=rng.integers(0, 2**32, (m, 8), dtype=np.uint32),
        va=rng.random(n) > 0.1, vb=rng.random(m) > 0.1,
        uva=rng.uniform(0, 640, (n, 2)).astype(np.float32),
        uvb=rng.uniform(0, 640, (m, 2)).astype(np.float32),
        r2=(rng.uniform(20, 200, n) ** 2).astype(np.float32),
        r2c=(rng.uniform(20, 200, m) ** 2).astype(np.float32),
        oa=rng.integers(0, 8, n).astype(np.int32), ob=rng.integers(0, 8, m).astype(np.int32),
    )


def _t(x):
    return torch.from_numpy(x.view(np.int32) if x.dtype == np.uint32 else x)


CASES = ["plain", "spatial", "spatial+oct", "col-radius"]


def _case_kwargs(name, x, conv):
    return {
        "plain": {},
        "spatial": dict(uv_a=conv(x["uva"]), uv_b=conv(x["uvb"]), radius2=conv(x["r2"])),
        "spatial+oct": dict(uv_a=conv(x["uva"]), uv_b=conv(x["uvb"]), radius2=conv(x["r2"]),
                            oct_a=conv(x["oa"]), oct_b=conv(x["ob"]), octave_band=1),
        "col-radius": dict(uv_a=conv(x["uva"]), uv_b=conv(x["uvb"]), radius2_cols=conv(x["r2c"])),
    }[name]


@pytest.mark.parametrize("case", CASES)
def test_hamming_best2_bit_exact_vs_reference(case):
    n, m = 300, 400
    x = _inputs(n, m)
    kj = _case_kwargs(case, x, jnp.asarray)
    kt = _case_kwargs(case, x, _t)
    want = jh._reference(
        jnp.asarray(x["a"]), jnp.asarray(x["b"]), jnp.asarray(x["va"]), jnp.asarray(x["vb"]),
        kj.get("uv_a", jnp.zeros((n, 2))), kj.get("uv_b", jnp.zeros((m, 2))),
        kj.get("radius2", jnp.full((n,), -1.0)), kj.get("radius2_cols", jnp.full((m,), -1.0)),
        kj.get("oct_a", jnp.zeros((n,), jnp.int32)), kj.get("oct_b", jnp.zeros((m,), jnp.int32)),
        kj.get("octave_band", -1),
    )
    got = th.hamming_best2(_t(x["a"]), _t(x["b"]), _t(x["va"]), _t(x["vb"]), **kt)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def test_hamming_best2_bit_exact_vs_pallas_interpret(monkeypatch):
    monkeypatch.setenv("DIALOG_TPU_PALLAS_INTERPRET", "1")
    x = _inputs(200, 300, seed=5)
    kj = _case_kwargs("spatial+oct", x, jnp.asarray)
    want = jh.hamming_best2(jnp.asarray(x["a"]), jnp.asarray(x["b"]), jnp.asarray(x["va"]),
                            jnp.asarray(x["vb"]), **kj)
    got = th.hamming_best2(_t(x["a"]), _t(x["b"]), _t(x["va"]), _t(x["vb"]),
                           **_case_kwargs("spatial+oct", x, _t))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def test_hamming_tie_goes_to_lowest_column(monkeypatch):
    monkeypatch.setenv("DIALOG_TPU_PALLAS_INTERPRET", "1")
    a = _inputs(8, 8, seed=7)["a"]
    b = np.concatenate([a, a])
    want = jh.hamming_best2(jnp.asarray(a), jnp.asarray(b), jnp.ones(8, bool), jnp.ones(16, bool))
    got = th.hamming_best2(_t(a), _t(b), torch.ones(8, dtype=torch.bool), torch.ones(16, dtype=torch.bool))
    np.testing.assert_array_equal(got[0].numpy(), np.arange(8))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def test_mutual_match_fused_matches_reference():
    x = _inputs(250, 320, seed=2)
    args_j = (jnp.asarray(x["a"]), jnp.asarray(x["b"]), jnp.asarray(x["va"]), jnp.asarray(x["vb"]))
    kw_j = dict(uv_a=jnp.asarray(x["uva"]), uv_b=jnp.asarray(x["uvb"]), radius2=jnp.asarray(x["r2"]),
                oct_a=jnp.asarray(x["oa"]), oct_b=jnp.asarray(x["ob"]), octave_band=1, max_dist=110, ratio=0.9)
    want = jh.mutual_match_fused(*args_j, **kw_j)
    got = th.mutual_match_fused(_t(x["a"]), _t(x["b"]), _t(x["va"]), _t(x["vb"]), uv_a=_t(x["uva"]),
                                uv_b=_t(x["uvb"]), radius2=_t(x["r2"]), oct_a=_t(x["oa"]), oct_b=_t(x["ob"]),
                                octave_band=1, max_dist=110, ratio=0.9)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def _correlated(n, m, seed):
    """B = noisy copies of A's descriptors at nearby positions, plus clutter."""
    rng = np.random.default_rng(seed)
    x = _inputs(n, m, seed)
    k = min(n, m) // 2
    b = x["b"].copy()
    b[:k] = x["a"][:k] ^ rng.integers(0, 2, (k, 8), dtype=np.uint32) << rng.integers(0, 32, (k, 8), dtype=np.uint32)
    uvb = x["uvb"].copy()
    uvb[:k] = x["uva"][:k] + rng.normal(0, 3, (k, 2)).astype(np.float32)
    x.update(b=b, uvb=uvb)
    return x


@pytest.mark.parametrize("band", [1, 2])
def test_match_projected_fused_equals_reference_dense(band):
    x = _correlated(300, 280, seed=3)
    want = jm.match_projected(
        jnp.asarray(x["a"]), jnp.asarray(x["uva"]), jnp.asarray(x["va"]), jnp.asarray(x["oa"] % 3),
        jnp.asarray(x["b"]), jnp.asarray(x["uvb"]), jnp.asarray(x["vb"]), jnp.asarray(x["ob"] % 3),
        radius=8.0, scale_factor=1.2, max_dist=100, ratio=0.9, octave_band=band,
    )
    got = tm.match_projected(
        _t(x["a"]), _t(x["uva"]), _t(x["va"]), _t(x["oa"] % 3), _t(x["b"]), _t(x["uvb"]), _t(x["vb"]),
        _t(x["ob"] % 3), radius=8.0, scale_factor=1.2, max_dist=100, ratio=0.9, octave_band=band,
    )
    assert int((np.asarray(want[0]) >= 0).sum()) > 50
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("shape", [(1, 1), (200, 220), (3, 40, 50)], ids=["one", "flat", "leading-dims"])
def test_hamming_distance_matrix_equals_reference(shape):
    """The one distance matrix (a product of unpacked bits) against the
    reference's popcount of the XOR, leading dimensions included, with the
    all-ones and all-zeros descriptors (distance 256) in every case."""
    rng = np.random.default_rng(11)
    *lead, n, m = shape
    a = rng.integers(0, 2**32, (*lead, n, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (*lead, m, 8), dtype=np.uint32)
    a[..., 0, :], b[..., 0, :] = 0xFFFFFFFF, 0
    ref = jax.vmap(jm.hamming_distance_matrix) if lead else jm.hamming_distance_matrix
    want = ref(jnp.asarray(a), jnp.asarray(b))
    got = tm.hamming_distance_matrix(_t(a), _t(b))
    assert got.dtype == torch.int32 and int(got[..., 0, 0].min()) == 256
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_dense_policies():
    x = _correlated(200, 220, seed=4)
    dj = jm.hamming_distance_matrix(jnp.asarray(x["a"]), jnp.asarray(x["b"]))
    dt = tm.hamming_distance_matrix(_t(x["a"]), _t(x["b"]))
    np.testing.assert_array_equal(np.asarray(dj), dt.numpy())
    for w, g in zip(jm.match_mutual(dj, jnp.asarray(x["va"]), jnp.asarray(x["vb"]), 80, 0.9),
                    tm.match_mutual(dt, _t(x["va"]), _t(x["vb"]), 80, 0.9)):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    rng = np.random.default_rng(9)
    ang_a = rng.uniform(-np.pi, np.pi, 200).astype(np.float32)
    ang_b = rng.uniform(-np.pi, np.pi, 220).astype(np.float32)
    ang_b[:100] = ang_a[:100] + 0.3
    want = jm.match_window(jnp.asarray(x["a"]), jnp.asarray(x["uva"]), jnp.asarray(x["va"]),
                           jnp.asarray(x["b"]), jnp.asarray(x["uvb"]), jnp.asarray(x["vb"]),
                           radius=10.0, max_dist=90, ratio=0.9,
                           angle_a=jnp.asarray(ang_a), angle_b=jnp.asarray(ang_b))
    got = tm.match_window(_t(x["a"]), _t(x["uva"]), _t(x["va"]), _t(x["b"]), _t(x["uvb"]), _t(x["vb"]),
                          radius=10.0, max_dist=90, ratio=0.9,
                          angle_a=torch.from_numpy(ang_a), angle_b=torch.from_numpy(ang_b))
    assert int((np.asarray(want[0]) >= 0).sum()) > 30
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())

