"""``dialog_tpu_torch.vocab`` against ``dialog_tpu.vocab`` on the same inputs.

Descriptors, validity and initial words are made from a numpy seed and go
through both packages. Hamming distances are exact integers in both (0/1
operands, sums below 2^24), and both argmins keep the lowest index on a tie,
so trained words, flat and two-level word ids must agree bit for bit. The
float outputs (BoW vectors and rows, l1 scores, idf) differ only in the order
of a few f32 sums: 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dialog_tpu import vocab as jv
from dialog_tpu_torch import interop
from dialog_tpu_torch import vocab as tv

torch.set_num_threads(2)

TOL = 1e-6


def _descs(n_clusters=24, per=30, flips=5, seed=0):
    """Clustered descriptors u32[n_clusters * per, 8], shuffled."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(0, 2**32, (n_clusters, 8), dtype=np.uint32)
    d = np.repeat(centers, per, axis=0)
    for row in d:
        for _ in range(flips):
            row[rng.integers(0, 8)] ^= np.uint32(1 << rng.integers(0, 32))
    return d[rng.permutation(len(d))]


def _t(a):
    return interop.numpy_to_tensor(a, device="cpu")


def _words_u32(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


@pytest.fixture(scope="module")
def trained():
    """The same descriptors, validity and initial words through both trainers."""
    desc = _descs()
    rng = np.random.default_rng(1)
    valid = rng.random(len(desc)) > 0.15
    init = desc[rng.choice(np.nonzero(valid)[0], 48, replace=True)]
    ref = jv.train_vocab(jnp.asarray(desc), jnp.asarray(valid), jax.random.PRNGKey(0), n_words=48, iters=5,
                         chunk=256, init_words=jnp.asarray(init))
    port = tv.train_vocab(_t(desc), _t(valid), _t(init), n_words=48, iters=5, chunk=256)
    return desc, valid, ref, port


def test_pack_unpack_round_trip():
    desc = _descs(seed=2)
    bits = tv._unpack_bits(_t(desc))
    assert bits.shape == (len(desc), 256) and bits.dtype == torch.float32
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jv._unpack_bits(jnp.asarray(desc))))
    np.testing.assert_array_equal(_words_u32(tv._pack_bits(bits)), desc)
    np.testing.assert_array_equal(_words_u32(tv._pack_bits(bits > 0)), desc)


def test_train_vocab_gives_the_reference_words(trained):
    _, _, ref, port = trained
    np.testing.assert_array_equal(_words_u32(port.words), np.asarray(ref.words))
    np.testing.assert_array_equal(port.idf.numpy(), np.asarray(ref.idf))


def test_train_vocab_is_chunk_independent_and_keeps_empty_clusters():
    desc = _descs(seed=3)
    valid = np.ones(len(desc), bool)
    # words 0 and 1 start equal: every tie goes to word 0, so word 1's cluster stays empty
    init = np.concatenate([desc[:1], desc[:15]])
    a = tv.train_vocab(_t(desc), _t(valid), _t(init), n_words=16, iters=3, chunk=100)
    b = tv.train_vocab(_t(desc), _t(valid), _t(init), n_words=16, iters=3, chunk=8192)
    assert torch.equal(a.words, b.words)
    ref = jv.train_vocab(jnp.asarray(desc), jnp.asarray(valid), jax.random.PRNGKey(0), n_words=16, iters=3,
                         chunk=128, init_words=jnp.asarray(init))
    np.testing.assert_array_equal(_words_u32(a.words), np.asarray(ref.words))
    np.testing.assert_array_equal(_words_u32(a.words)[1], init[1])
    with pytest.raises(ValueError):
        tv.train_vocab(_t(desc), _t(valid), _t(init[:8]), n_words=16)


def test_flat_quantize_gives_the_reference_ids(trained):
    desc, valid, ref, port = trained
    want = np.asarray(jv.quantize(ref, jnp.asarray(desc), jnp.asarray(valid), chunk=200))
    got = tv.quantize(port, _t(desc), _t(valid), chunk=200).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[~valid] == 48).all() and got[valid].max() < 48
    # a tie goes to the lowest word: every word twice, queries are the words
    twice = port._replace(words=torch.cat([port.words, port.words]), idf=torch.ones(96))
    ids = tv.quantize(twice, port.words, torch.ones(48, dtype=torch.bool)).numpy()
    first = np.array([int(np.nonzero((_words_u32(port.words) == w).all(1))[0][0]) for w in _words_u32(port.words)])
    np.testing.assert_array_equal(ids, first)


def test_two_level_quantize_gives_the_reference_ids(trained):
    desc, valid, ref, port = trained
    ref2 = jv.build_two_level(ref, n_coarse=6)
    port2 = tv.build_two_level(port, n_coarse=6)
    for name in ("coarse", "cell_words"):
        np.testing.assert_array_equal(_words_u32(getattr(port2, name)), np.asarray(getattr(ref2, name)), err_msg=name)
    np.testing.assert_array_equal(port2.cell_ids.numpy(), np.asarray(ref2.cell_ids))
    want = np.asarray(jv.quantize(ref2, jnp.asarray(desc), jnp.asarray(valid)))
    got = tv.quantize(port2, _t(desc), _t(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    # the tables carried across give the same ids as the tables built here
    carried = interop.vocab_from_numpy(jax.device_get(ref2), device="cpu")
    assert carried.words.dtype == torch.int32 and carried.cell_ids.dtype == torch.int32
    np.testing.assert_array_equal(tv.quantize(carried, _t(desc), _t(valid)).numpy(), want)
    # mostly the flat ids (top-2 coarse routing is an approximation of the flat argmin)
    flat = tv.quantize(port, _t(desc), _t(valid)).numpy()
    assert (got == flat).mean() > 0.8


def test_vocab_from_numpy_keeps_a_flat_codebook_flat(trained):
    _, _, ref, port = trained
    carried = interop.vocab_from_numpy(jax.device_get(ref), device="cpu")
    assert carried.coarse is None and carried.cell_words is None and carried.cell_ids is None
    assert torch.equal(carried.words, port.words) and torch.equal(carried.idf, port.idf)


def test_compute_idf_and_bow_outputs_match(trained):
    desc, valid, ref, port = trained
    K, F = 6, len(desc) // 6
    d3, v3 = desc[: K * F].reshape(K, F, 8), valid[: K * F].reshape(K, F)
    v3[4] = False                                  # an empty document
    wid_j = jv.quantize(ref, jnp.asarray(d3.reshape(-1, 8)), jnp.asarray(v3.reshape(-1)))
    wid_t = tv.quantize(port, _t(d3.reshape(-1, 8)), _t(v3.reshape(-1)))
    doc = np.repeat(np.arange(K, dtype=np.int32), F)
    ref_i = jv.compute_idf(ref, wid_j, jnp.asarray(doc), K, n_live=jnp.asarray(5))
    # the live count as a tensor and as a Python int
    for n_live in (torch.tensor(5), 5):
        port_i = tv.compute_idf(port, wid_t, _t(doc), K, n_live=n_live)
        np.testing.assert_allclose(port_i.idf.numpy(), np.asarray(ref_i.idf), atol=TOL, rtol=0)
    np.testing.assert_allclose(tv.compute_idf(port, wid_t, _t(doc), K).idf.numpy(),
                               np.asarray(jv.compute_idf(ref, wid_j, jnp.asarray(doc), K).idf), atol=TOL, rtol=0)
    assert float(port_i.idf.min()) >= 0.0 and float(port_i.idf.max()) > 0.0

    rows_j = np.asarray(jv.bow_db_rows(ref_i, jnp.asarray(d3), jnp.asarray(v3)))
    rows_t = tv.bow_db_rows(port_i, _t(d3), _t(v3))
    np.testing.assert_allclose(rows_t.numpy(), rows_j, atol=TOL, rtol=0)
    assert float(rows_t[4].abs().sum()) == 0.0
    q_j = jv.bow_vector(ref_i, jnp.asarray(d3[1]), jnp.asarray(v3[1]))
    q_t = tv.bow_vector(port_i, _t(d3[1]), _t(v3[1]))
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), atol=TOL, rtol=0)
    np.testing.assert_allclose(q_t.numpy(), rows_t[1].numpy(), atol=TOL, rtol=0)
    s_t = tv.bow_l1_scores(q_t, rows_t).numpy()
    np.testing.assert_allclose(s_t, np.asarray(jv.bow_l1_scores(q_j, jnp.asarray(rows_j))), atol=TOL, rtol=0)
    assert int(np.argmax(s_t)) == 1 and abs(s_t[1] - 1.0) < 1e-5


def _write_voc(path, k=3, seed=0):
    """A small vocabulary in the DBoW2 text format: k inner nodes, k*k leaves."""
    rng = np.random.default_rng(seed)
    lines = [f"{k} 2 0 0"]
    for _ in range(k):
        lines.append("0 0 " + " ".join(map(str, rng.integers(0, 256, 32))) + " 0")
    for i in range(k * k):
        lines.append(f"{1 + i // k} 1 " + " ".join(map(str, rng.integers(0, 256, 32))) + f" {rng.uniform(0.1, 2.0):.6f}")
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("max_words", [None, 4])
def test_load_dbow2_text_matches_the_reference(tmp_path, max_words):
    p = tmp_path / "voc.txt"
    _write_voc(p, seed=5)
    ref = jv.load_dbow2_text(str(p), max_words=max_words)
    port = tv.load_dbow2_text(str(p), max_words=max_words, device="cpu")
    assert port.words.shape == (9 if max_words is None else 4, 8)
    np.testing.assert_array_equal(_words_u32(port.words), np.asarray(ref.words))
    np.testing.assert_allclose(port.idf.numpy(), np.asarray(ref.idf), rtol=1e-6)
    desc = _descs(seed=6)[:50]
    ones = np.ones(50, bool)
    np.testing.assert_array_equal(tv.quantize(port, _t(desc), _t(ones)).numpy(),
                                  np.asarray(jv.quantize(ref, jnp.asarray(desc), jnp.asarray(ones))))


def test_load_dbow2_text_rejects_garbage(tmp_path):
    p = tmp_path / "bad.txt"
    p.write_text("this is not a vocabulary\n")
    with pytest.raises(ValueError):
        tv.load_dbow2_text(str(p), device="cpu")
