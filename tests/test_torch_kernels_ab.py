"""Kernels A and B after their redesign, on the CPU: the all-levels entry of
kernel A and the one-pass mutual mode of kernel B against ``dialog_tpu`` and
against the port's own earlier forms.

Tolerance: bit-exact throughout (ranks are sums of exact differences, matches
are integers). The CUDA kernels themselves run only on a card
(``tests/test_torch_cuda.py``); here their plain versions are held against the
reference, and the two arguments the kernels rest on are replayed in numpy:

* kernel A computes no score for a pixel more than one step outside the
  border frame, and takes each arc's minimum from suffix and prefix minima of
  the circle's halves;
* kernel B's mutual mode finds each column's best row as the minimum of the
  packed keys ``(distance << 23) | row`` over the column's open pairs, in
  place of a second, transposed pass.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from dialog_tpu.kernels import fast as jfast
from dialog_tpu.kernels import hamming as jh
from dialog_tpu_torch import frontend as tfe
from dialog_tpu_torch.config import EngineConfig
from dialog_tpu_torch.kernels import fast as tfast
from dialog_tpu_torch.kernels import hamming as th

torch.set_num_threads(2)

CFG = EngineConfig(width=160, height=120, n_features=200, max_features=256, n_levels=3)


def _pyramid(seed=0):
    img = np.random.default_rng(seed).uniform(0, 255, (CFG.height, CFG.width)).astype(np.float32)
    return tfe.build_pyramid(torch.from_numpy(img), CFG)


# ---------------------------------------------------------------------------
# kernel A
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("th_", [(7.0, 20.0, 19), (3.0, 10.0, 8)])
def test_fast_levels_plain_matches_pallas_body_per_level(monkeypatch, th_):
    monkeypatch.setenv("DIALOG_TPU_PALLAS_INTERPRET", "1")
    pyr = _pyramid()
    assert [tuple(p.shape) for p in pyr] == [(120, 160), (100, 133), (83, 111)]
    got = tfast.fast_nms_rank_levels(pyr, *th_)
    assert len(got) == 3
    for lvl, g in zip(pyr, got):
        want = np.asarray(jfast.fast_nms_rank(jnp.asarray(lvl.numpy()), *th_))
        np.testing.assert_array_equal(want, g.numpy())


@pytest.mark.parametrize("pad_to", [1, 5, 16])
def test_fast_levels_padded_output_equals_pad_after(pad_to):
    pyr = _pyramid(seed=1)
    got = tfast.fast_nms_rank_levels(pyr, 7.0, 20.0, 19, pad_to=pad_to)
    for lvl, g in zip(pyr, got):
        H, W = lvl.shape
        s = tfast.fast_nms_rank(lvl, 7.0, 20.0, 19)
        padded = torch.zeros((-(-H // pad_to) * pad_to, -(-W // pad_to) * pad_to))
        padded[:H, :W] = s
        assert g.shape == padded.shape and torch.equal(g, padded)
    assert tfast.fast_nms_rank_levels([], 7.0, 20.0, 19) == []
    with pytest.raises(ValueError, match="pad_to"):
        tfast.fast_nms_rank_levels(pyr, 7.0, 20.0, 19, pad_to=0)


def test_detect_level_equals_selection_on_the_padded_rank_map():
    """``detect_level`` is the all-levels entry for one level followed by
    ``select_keypoints``, and equals the selection on a rank map padded by
    hand (the detector's earlier form)."""
    pyr = _pyramid(seed=2)
    ranks = tfast.fast_nms_rank_levels(pyr, 7.0, 20.0, tfe.BORDER, pad_to=tfe.CELL)
    for lvl, r in zip(pyr, ranks):
        H, W = lvl.shape
        by_hand = torch.zeros((-(-H // 16) * 16, -(-W // 16) * 16))
        by_hand[:H, :W] = tfast.fast_nms_rank_plain(lvl, 7.0, 20.0, tfe.BORDER)
        for a, b, c in zip(tfe.detect_level(lvl, 60, 20.0, 7.0), tfe.select_keypoints(r, 60),
                           tfe.select_keypoints(by_hand, 60)):
            assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("th_", [(7.0, 20.0, 19), (0.0, 5.0, 0), (2.0, 9.0, 3)])
def test_scores_outside_the_border_frame_do_not_matter(th_):
    """Kernel A's shortcut: with the score of every pixel more than one step
    outside the border frame replaced (by -inf, as the kernel does, or by a
    huge value), the rank map is unchanged."""
    min_th, th_fast, border = th_
    img = torch.from_numpy(np.random.default_rng(3).uniform(0, 255, (90, 131)).astype(np.float32))
    H, W = img.shape
    ys, xs = torch.arange(H)[:, None], torch.arange(W)[None, :]
    needed = (ys >= border - 1) & (ys <= H - border) & (xs >= border - 1) & (xs <= W - border)
    inb = (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)
    want = tfast.fast_nms_rank_plain(img, *th_)
    for other in (float("-inf"), 1e9):
        s = tfast.nms3(torch.where(needed, tfast.fast_score(img), other))
        s = torch.where(inb, s, 0.0)
        got = torch.where(s > min_th, s + torch.where(s > th_fast, 1000.0, 0.0), 0.0)
        assert torch.equal(got, want)


def test_arc_minima_from_suffix_and_prefix_minima():
    """The kernel's arc scheme in numpy: arc i = [i, i + 8] of the circle is
    the rest of i's half from i on and the other half up to i + 8; its
    minimum is min(suffix[i], prefix[i + 8])."""
    d = np.random.default_rng(4).normal(0, 30, (500, 16)).astype(np.float32)
    suf, pre = d.copy(), d.copy()
    for h in (0, 8):
        for i in range(1, 8):
            suf[:, h + 7 - i] = np.minimum(d[:, h + 7 - i], suf[:, h + 8 - i])
            pre[:, h + i] = np.minimum(d[:, h + i], pre[:, h + i - 1])
    got = np.max([np.minimum(suf[:, i], pre[:, (i + 8) % 16]) for i in range(16)], axis=0)
    want = np.max([np.min(np.take(d, np.arange(i, i + 9) % 16, axis=1), axis=1) for i in range(16)], axis=0)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# kernel B
# ---------------------------------------------------------------------------


def _inputs(n, m, seed, distinct=None):
    """Random match inputs; half of the shorter side has a near copy on the
    other. With ``distinct`` only that many different descriptors (ties)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (m, 8), dtype=np.uint32)
    uva = rng.uniform(0, 320, (n, 2)).astype(np.float32)
    uvb = rng.uniform(0, 320, (m, 2)).astype(np.float32)
    oa, ob = rng.integers(0, 8, n).astype(np.int32), rng.integers(0, 8, m).astype(np.int32)
    k = min(n, m) // 2
    b[:k] = a[:k] ^ (rng.integers(0, 2, (k, 8), dtype=np.uint32) << rng.integers(0, 32, (k, 8), dtype=np.uint32))
    uvb[:k] = uva[:k] + rng.normal(0, 3, (k, 2)).astype(np.float32)
    ob[:k] = oa[:k]
    if distinct:
        pool = rng.integers(0, 2**32, (distinct, 8), dtype=np.uint32)
        a, b = pool[rng.integers(0, distinct, n)], pool[rng.integers(0, distinct, m)]
    return dict(a=a.view(np.int32), b=b.view(np.int32), va=rng.random(n) > 0.1, vb=rng.random(m) > 0.1,
                uva=uva, uvb=uvb, r2=(rng.uniform(10, 120, n) ** 2).astype(np.float32), oa=oa, ob=ob)


GATES = {
    "plain": lambda x: {},
    "spatial": lambda x: dict(uv_a=x["uva"], uv_b=x["uvb"], radius2=x["r2"]),
    "oct": lambda x: dict(oct_a=x["oa"], oct_b=x["ob"], octave_band=1),
    "spatial+oct": lambda x: dict(uv_a=x["uva"], uv_b=x["uvb"], radius2=x["r2"], oct_a=x["oa"], oct_b=x["ob"],
                                  octave_band=1),
}


def replay_mutual(a, b, va, vb, uv_a=None, uv_b=None, radius2=None, oct_a=None, oct_b=None, octave_band=-1,
                  max_dist=50, ratio=1.0):
    """The CUDA mutual mode's data flow in numpy: one pass over the gated
    pairs gives each row's (best, lowest best column, second) and lowers each
    column's packed key; the match test then reads the key of the row's best
    column."""
    N, M = a.shape[0], b.shape[0]
    x = a.view(np.uint32)[:, None, :] ^ b.view(np.uint32)[None, :, :]
    d = np.unpackbits(x.view(np.uint8), axis=-1).sum(-1).astype(np.int64)
    open_ = va[:, None] & vb[None, :]
    if uv_a is not None:
        dx, dy = uv_a[:, None, 0] - uv_b[None, :, 0], uv_a[:, None, 1] - uv_b[None, :, 1]
        r2 = (radius2 if radius2 is not None else np.full(N, -1.0, np.float32))[:, None]
        open_ &= (r2 < 0) | (dx * dx + dy * dy <= r2)
    if octave_band >= 0 and oct_a is not None:
        open_ &= np.abs(oct_a[:, None] - oct_b[None, :]) <= octave_band
    d = np.where(open_, d, th.MAX_DIST)
    col_key = np.full(M, 0xFFFFFFFF, np.uint32)
    rows, cols = np.nonzero(open_)
    np.minimum.at(col_key, cols, ((d[rows, cols] << th.ROW_BITS) | rows).astype(np.uint32))
    match = np.full(N, -1, np.int32)
    best = np.full(N, th.MAX_DIST, np.int32)
    for i in range(N):
        if M == 0:
            break
        order = np.lexsort((np.arange(M), d[i]))   # by distance, then by column
        best[i] = d[i, order[0]]
        second = d[i, order[1]] if M > 1 else th.MAX_DIST
        f = int(order[0]) if best[i] < th.MAX_DIST else -1
        ok = f >= 0 and best[i] <= max_dist and np.float32(best[i]) < np.float32(ratio) * np.float32(second)
        if ok and col_key[f] != 0xFFFFFFFF and int(col_key[f] & ((1 << th.ROW_BITS) - 1)) == i:
            match[i] = f
    return match, best


def _torch_kw(kw):
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("gate", sorted(GATES))
def test_packed_key_column_minimum_equals_the_transposed_pass(gate, seed):
    x = _inputs(130, 150, seed)
    kw = dict(GATES[gate](x), max_dist=100, ratio=0.9)
    want = th.mutual_match_fused(*map(torch.from_numpy, (x["a"], x["b"], x["va"], x["vb"])), **_torch_kw(kw))
    got = replay_mutual(x["a"], x["b"], x["va"], x["vb"], **kw)
    assert int((want[0] >= 0).sum()) > 20
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w.numpy(), g)


@pytest.mark.parametrize("case", ["ties", "ties-gated", "all-equal", "closed-gates", "N=0", "M=0", "N=1", "M=1"])
def test_packed_key_column_minimum_on_ties_and_empty_sides(case):
    x = _inputs(90, 70, 5, distinct=4 if case.startswith("ties") else 1 if case == "all-equal" else None)
    kw = dict(max_dist=256, ratio=2.0) if case in ("ties", "ties-gated", "all-equal") else dict(max_dist=100, ratio=0.9)
    if case == "ties-gated":
        kw.update(GATES["spatial+oct"](x))
    if case == "closed-gates":
        kw.update(uv_a=x["uva"], uv_b=x["uvb"] + np.float32(5000.0), radius2=x["r2"])
    if case.startswith("N="):
        n = int(case[-1])
        x.update(a=x["a"][:n], va=np.ones(n, bool))
    if case.startswith("M="):
        m = int(case[-1])
        x.update(b=x["b"][:m], vb=np.ones(m, bool))
    want = th.mutual_match_fused(*map(torch.from_numpy, (x["a"], x["b"], x["va"], x["vb"])), **_torch_kw(kw))
    got = replay_mutual(x["a"], x["b"], x["va"], x["vb"], **kw)
    assert want[0].dtype == want[1].dtype == torch.int32
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w.numpy(), g)
    if case == "closed-gates":
        assert int((want[0] >= 0).sum()) == 0 and int((want[1] != th.MAX_DIST).sum()) == 0


@pytest.mark.parametrize("gate", ["plain", "spatial+oct"])
def test_mutual_match_matches_reference_and_replay(monkeypatch, gate):
    """The reference's ``mutual_match_fused`` (its Pallas body in interpret
    mode), the port's two-call plain form and the packed-key replay agree."""
    monkeypatch.setenv("DIALOG_TPU_PALLAS_INTERPRET", "1")
    x = _inputs(140, 120, 7)
    kw = dict(GATES[gate](x), max_dist=110, ratio=0.9)
    want = jh.mutual_match_fused(jnp.asarray(x["a"].view(np.uint32)), jnp.asarray(x["b"].view(np.uint32)),
                                 jnp.asarray(x["va"]), jnp.asarray(x["vb"]),
                                 **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
    plain = th.mutual_match_plain(*map(torch.from_numpy, (x["a"], x["b"], x["va"], x["vb"])), **_torch_kw(kw))
    replay = replay_mutual(x["a"], x["b"], x["va"], x["vb"], **kw)
    assert int((np.asarray(want[0]) >= 0).sum()) > 20
    for w, p, r in zip(want, plain, replay):
        np.testing.assert_array_equal(np.asarray(w), p.numpy())
        np.testing.assert_array_equal(np.asarray(w), r)


def test_best2_plain_with_no_column():
    x = _inputs(6, 4, 8)
    idx, best, second = th.hamming_best2(torch.from_numpy(x["a"]), torch.from_numpy(x["b"][:0]),
                                         torch.from_numpy(x["va"]), torch.from_numpy(x["vb"][:0]))
    assert idx.tolist() == [-1] * 6 and best.tolist() == second.tolist() == [th.MAX_DIST] * 6
