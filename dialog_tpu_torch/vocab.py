"""Visual vocabulary and bag-of-words place recognition (port of ``dialog_tpu/vocab.py``).

A flat table of binary centroids quantized by one batched Hamming argmin,
and BoW scoring as a dense product against every keyframe's BoW vector at
once; no tree, no inverted index. The vocabulary is trained by binary
k-medians (per-bit majority centroids) on descriptors harvested from the
running map.

Hamming distances come from the contraction |a| + |w| - 2 a.w over unpacked
0/1 bits. Every operand is 0 or 1 and every sum an integer below 2^24, so
the f32 products are exact on any device and in any matmul mode (TF32 keeps
0/1 exactly and accumulates in f32): word assignments are integer argmins
with ties to the lowest word, as in the reference. These are large plain
products outside any kernel and go to ``torch.matmul``.

Descriptors are ``int32`` bit-casts of the reference's ``uint32`` words.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import ops
from .kernels.hamming import popcount32


class Vocabulary(NamedTuple):
    """Flat codebook, optionally with a coarse level for two-level lookup
    (``build_two_level``); ``quantize`` takes the two-level path when the
    coarse level is present."""

    words: torch.Tensor                      # i32[W, 8] binary centroids
    idf: torch.Tensor                        # f32[W] inverse document frequency weights
    coarse: torch.Tensor | None = None       # i32[C0, 8] coarse centroids
    cell_words: torch.Tensor | None = None   # i32[C0, Fo, 8] per-cell words (padded)
    cell_ids: torch.Tensor | None = None     # i32[C0, Fo] padded slot -> word id


def _unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """i32[N, 8] -> f32[N, 256] bit matrix (bit s of word k at column 32 k + s)."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc[..., None] >> shifts) & 1
    return bits.reshape(desc.shape[0], 256).to(torch.float32)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """f32/bool[N, 256] -> i32[N, 8]."""
    from .frontend import pack_bits

    return pack_bits(bits.reshape(bits.shape[0], 256) > 0)


def _distances(b: torch.Tensor, wbits_t: torch.Tensor, wsum: torch.Tensor) -> torch.Tensor:
    """Hamming distances f32[C, W] of unpacked descriptors b [C, 256] to the
    words whose unpacked bits are wbits_t [256, W] (exact integers)."""
    return b.sum(-1)[:, None] + wsum[None, :] - 2.0 * (b @ wbits_t)


def draw_init_words(desc: torch.Tensor, valid: torch.Tensor, n_words: int,
                    generator: torch.Generator) -> torch.Tensor:
    """A fresh codebook's starting words i32[n_words, 8]: a random sample,
    with replacement, of the valid descriptors, drawn on the generator's device."""
    p = valid.to(device=generator.device, dtype=torch.float32)
    idx = torch.multinomial(p / torch.clamp(p.sum(), min=1.0), n_words, replacement=True, generator=generator)
    return desc[idx.to(desc.device)]


def train_vocab(desc: torch.Tensor, valid: torch.Tensor, init_words: torch.Tensor, n_words: int = 4096,
                iters: int = 8, chunk: int = 8192) -> Vocabulary:
    """Binary k-medians: assign by Hamming argmin, centroid = per-bit majority.

    desc i32[N, 8], valid bool[N]. ``init_words`` i32[n_words, 8] seeds the
    solve: an existing codebook for a retrain, or the caller's random sample
    of valid descriptors for a fresh train (the draw belongs to the caller's
    generator). Chunked over N; a cluster that ends an iteration empty keeps
    its old centroid."""
    if tuple(init_words.shape) != (n_words, 8):
        raise ValueError(f"train_vocab: init_words must be i32[{n_words}, 8], got {tuple(init_words.shape)}")
    N = desc.shape[0]
    words = init_words
    for _ in range(iters):
        wbits = _unpack_bits(words)
        wbits_t, wsum = wbits.T.contiguous(), wbits.sum(-1)
        ssum = torch.zeros((n_words, 256), dtype=torch.float32, device=desc.device)
        cnt = torch.zeros((n_words,), dtype=torch.float32, device=desc.device)
        for s in range(0, N, chunk):
            b = _unpack_bits(desc[s : s + chunk])
            v = valid[s : s + chunk].to(torch.float32)
            assign = torch.argmin(_distances(b, wbits_t, wsum), dim=1)
            # per-cluster bit sums and counts: 0/1 addends, exact in any order
            ssum.index_add_(0, assign, b * v[:, None])
            cnt.index_add_(0, assign, v)
        maj = ssum > 0.5 * torch.clamp(cnt, min=1.0)[:, None]
        words = torch.where((cnt > 0)[:, None], _pack_bits(maj), words)
    return Vocabulary(words=words, idf=torch.ones((n_words,), dtype=torch.float32, device=desc.device))


def build_two_level(vocab: Vocabulary, n_coarse: int = 64, fill: float = 1.3, seed: int = 0) -> Vocabulary:
    """Attach a coarse level: k-medians over the word table, balanced cells.

    On the host, once (numpy, ``default_rng(seed)``): cluster the W words
    into ``n_coarse`` cells, cap each cell at Fo = ceil(fill * W / n_coarse)
    words (overflow words spill to their next-nearest cell with room), pad
    short cells by repeating their first word. Padded slots map back to a
    real word id through ``cell_ids``, so two-level quantization returns ids
    in the flat word space."""
    dev = vocab.words.device
    words = np.ascontiguousarray(vocab.words.detach().cpu().numpy()).view(np.uint32)
    W = words.shape[0]
    C0 = min(n_coarse, W)
    Fo = int(np.ceil(fill * W / C0))
    rng = np.random.default_rng(seed)

    bits = np.unpackbits(words.view(np.uint8), axis=1, bitorder="little").astype(np.float32)   # [W, 256]
    cent = bits[rng.choice(W, C0, replace=False)]
    for _ in range(8):
        d = bits.sum(1)[:, None] + cent.sum(1)[None, :] - 2.0 * bits @ cent.T
        assign = np.argmin(d, axis=1)
        for c in range(C0):
            sel = assign == c
            if sel.any():
                cent[c] = (bits[sel].mean(0) > 0.5).astype(np.float32)
    d = bits.sum(1)[:, None] + cent.sum(1)[None, :] - 2.0 * bits @ cent.T
    order = np.argsort(d, axis=1)                          # word -> cell preferences

    members: list[list[int]] = [[] for _ in range(C0)]
    for w in np.argsort(d[np.arange(W), order[:, 0]]):     # confident words first
        for c in order[w]:
            if len(members[c]) < Fo:
                members[c].append(int(w))
                break
    for c in range(C0):                                    # an empty cell adopts its nearest word
        if not members[c]:
            members[c].append(int(np.argmin(d[:, c])))

    cell_ids = np.zeros((C0, Fo), np.int32)
    for c in range(C0):
        mem = members[c]
        cell_ids[c, : len(mem)] = mem
        cell_ids[c, len(mem):] = mem[0]
    cell_words = words[cell_ids]                           # [C0, Fo, 8]
    coarse = np.packbits(cent.astype(np.uint8), axis=1, bitorder="little").view(np.uint32)
    as_i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)  # noqa: E731
    return vocab._replace(coarse=as_i32(coarse), cell_words=as_i32(cell_words),
                          cell_ids=torch.from_numpy(cell_ids).to(dev))


def _quantize_two_level(vocab: Vocabulary, desc, valid, chunk: int = 2048) -> torch.Tensor:
    """Coarse argmin over the C0 cells, then the fine argmin within the two
    nearest cells (a descriptor whose word sits in the runner-up cell is the
    top-1 scheme's main error)."""
    N = desc.shape[0]
    W = vocab.words.shape[0]
    cbits = _unpack_bits(vocab.coarse)
    cbits_t, csum = cbits.T.contiguous(), cbits.sum(-1)
    Fo = vocab.cell_words.shape[1]
    out = []
    for s in range(0, N, max(1, min(chunk, N))):
        dc = desc[s : s + chunk]
        dcoarse = _distances(_unpack_bits(dc), cbits_t, csum)
        cells = ops.top_k(-dcoarse, 2)[1]                                     # [n, 2]
        cw = vocab.cell_words[cells].reshape(dc.shape[0], 2 * Fo, 8)
        dfine = popcount32(dc[:, None, :] ^ cw).sum(-1)                       # [n, 2 Fo]
        slot = torch.argmin(dfine, dim=1)
        ids2 = vocab.cell_ids[cells].reshape(dc.shape[0], 2 * Fo)
        out.append(torch.gather(ids2, 1, slot[:, None])[:, 0])
    wid = torch.cat(out).to(torch.int32) if out else desc.new_zeros((0,), dtype=torch.int32)
    return torch.where(valid, wid, W)


def _quantize_flat(vocab: Vocabulary, desc, valid, chunk: int = 8192) -> torch.Tensor:
    """One batched flat argmin over the whole word table, chunked over N."""
    N = desc.shape[0]
    W = vocab.words.shape[0]
    wbits = _unpack_bits(vocab.words)
    wbits_t, wsum = wbits.T.contiguous(), wbits.sum(-1)
    out = [torch.argmin(_distances(_unpack_bits(desc[s : s + chunk]), wbits_t, wsum), dim=1)
           for s in range(0, N, max(1, min(chunk, N)))]
    wid = torch.cat(out).to(torch.int32) if out else desc.new_zeros((0,), dtype=torch.int32)
    return torch.where(valid, wid, W)


def quantize(vocab: Vocabulary, desc: torch.Tensor, valid: torch.Tensor, chunk: int = 8192) -> torch.Tensor:
    """Descriptors i32[N, 8] -> word ids i32[N] (W = invalid sentinel); the
    two-level path when the vocabulary carries a coarse level."""
    if vocab.coarse is not None:
        return _quantize_two_level(vocab, desc, valid)
    return _quantize_flat(vocab, desc, valid, chunk)


def _histogram(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32[n] counts of the int64 indices (unit addends: exact, and no host read)."""
    return torch.zeros((n,), dtype=torch.float32, device=idx.device).index_add_(
        0, idx, torch.ones(idx.shape, dtype=torch.float32, device=idx.device))


def bow_db_rows(vocab: Vocabulary, desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """BoW rows of every keyframe in one pass: desc i32[K, F, 8], valid
    bool[K, F] -> f32[K, W] l1-normalized tf-idf."""
    K, F, _ = desc.shape
    W = vocab.words.shape[0]
    wid = quantize(vocab, desc.reshape(K * F, 8), valid.reshape(K * F)).long()
    doc = torch.arange(K, device=desc.device).repeat_interleave(F)
    tf = _histogram(doc * (W + 1) + wid, K * (W + 1)).reshape(K, W + 1)[:, :W]
    v = tf * vocab.idf[None, :]
    return v / torch.clamp(v.abs().sum(dim=1, keepdim=True), min=1e-9)


def bow_vector(vocab: Vocabulary, desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """l1-normalized tf-idf BoW vector f32[W]."""
    W = vocab.words.shape[0]
    tf = _histogram(quantize(vocab, desc, valid).long(), W + 1)[:W]
    v = tf * vocab.idf
    return v / torch.clamp(v.abs().sum(), min=1e-9)


def bow_l1_scores(q: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """DBoW2 l1 score of query q [W] against db rows [K, W], in [0, 1]:
    s(v, w) = 1 - 0.5 sum |v_i - w_i| for l1-normalized vectors."""
    return 1.0 - 0.5 * (q[None, :] - db).abs().sum(dim=-1)


def parse_dbow2_text(buf: bytes):
    """The nodes of a DBoW2 text vocabulary (ORBvoc.txt format) through the
    native parser (``native/voc_parser.cpp``): (is_leaf u8[n], desc
    u8[n, 32], weight f64[n])."""
    import ctypes

    from . import native

    lib = native.load("voc_parser")
    hdr = native.VocHeader()
    rc = lib.voc_scan(buf, len(buf), ctypes.byref(hdr))
    if rc != 0:
        raise ValueError(f"not a DBoW2 text vocabulary (rc={rc})")
    n = hdr.n_nodes
    parent = np.empty(n, np.int32)
    is_leaf = np.empty(n, np.uint8)
    desc = np.empty((n, 32), np.uint8)
    weight = np.empty(n, np.float64)
    if lib.voc_parse(buf, len(buf), n, parent.ctypes.data, is_leaf.ctypes.data, desc.ctypes.data,
                     weight.ctypes.data) != 0:
        raise ValueError("DBoW2 vocabulary parse failed")
    return is_leaf, desc, weight


def parse_dbow2_text_plain(buf: bytes):
    """``parse_dbow2_text`` in numpy (the reference's pure-Python parse),
    kept as the tests' reference."""
    vals = buf.split()
    n = (len(vals) - 4) // 35
    if n <= 0:
        raise ValueError("not a DBoW2 text vocabulary")
    rows = np.array(vals[4 : 4 + n * 35], dtype=object).reshape(n, 35)
    return rows[:, 1].astype(np.uint8), rows[:, 2:34].astype(np.uint8), rows[:, 34].astype(np.float64)


def load_dbow2_text(path: str, max_words: int | None = None, device="cuda") -> Vocabulary:
    """A DBoW2 text vocabulary (ORBvoc.txt format) as a flat codebook: leaf
    descriptors become the centroid table, leaf weights the idf.
    ``max_words`` keeps the highest-weight leaves. Parsed by the native
    parser (the reference's own load of the 145 MB file takes ~10 s)."""
    with open(path, "rb") as f:
        is_leaf, desc, weight = parse_dbow2_text(f.read())
    leaves = is_leaf > 0
    d = desc[leaves]
    w = weight[leaves].astype(np.float32)
    if max_words is not None and len(d) > max_words:
        keep = np.argsort(-w)[:max_words]
        d, w = d[keep], w[keep]
    words = np.ascontiguousarray(d).reshape(len(d), 8, 4).view(np.int32).reshape(len(d), 8)
    return Vocabulary(words=torch.from_numpy(words.copy()).to(device),
                      idf=torch.from_numpy(np.maximum(w, 1e-6)).to(device))


def compute_idf(vocab: Vocabulary, word_ids: torch.Tensor, doc_ids: torch.Tensor, n_docs: int,
                n_live=None) -> Vocabulary:
    """Refresh idf from a corpus: idf_w = log(n_live / (1 + df_w)), floored
    at 0. ``n_docs`` is the document-slot capacity, ``n_live`` (a tensor or a
    Python number; ``n_docs`` when None) the live document count."""
    W = vocab.words.shape[0]
    dev = vocab.words.device
    pair = doc_ids.long() * (W + 1) + word_ids.long()
    uniq = torch.zeros((n_docs * (W + 1) + W + 1,), dtype=torch.bool, device=dev)
    uniq[pair] = True
    df = uniq.reshape(-1, W + 1).sum(dim=0)[:W].to(torch.float32)
    n = torch.as_tensor(n_docs if n_live is None else n_live, device=dev).to(torch.float32)
    idf = torch.log(torch.clamp(n, min=1.0) / (1.0 + df))
    return vocab._replace(idf=torch.clamp(idf, min=0.0))
