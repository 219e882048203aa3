"""Torch forms of the JAX primitives whose exact semantics the port relies on.

Each helper reproduces what the reference gets from one JAX primitive, with
the tie and duplicate rules spelled out, and none of them syncs the host on
a CUDA tensor:

* ``top_k``         -- ``jax.lax.top_k``: descending, ties keep the lower index;
* ``nonzero_fixed`` -- ``jnp.nonzero(x, size=n, fill_value=f)``;
* ``scatter_set``   -- ``x.at[idx].set(v, mode="drop")``: out-of-range indices
  are dropped and, for a duplicated index, the LAST write wins (the order of
  XLA's CPU scatter). A plain ``index_put_`` with duplicates is
  nondeterministic on CUDA, so duplicates are resolved before the write;
* ``scatter_add``   -- ``x.at[idx].add(v, mode="drop")`` for integer tensors
  (integer atomics are order-free, hence deterministic);
* ``scatter_min``   -- ``x.at[idx].min(v)``;
* ``scalar``        -- a Python number as a 0-d device tensor, without a host copy;
* ``drop_targets``  -- scatter targets that drop the out-of-range entries: each
  goes to a scratch slot of its own past the output, cut off at the end (one
  shared slot would take every dropped write, and on CUDA those serialize);
* ``segment_order`` / ``segment_sum`` -- a float segment sum, ``x.at[idx].add(v)``
  into zeros, in a fixed order: a float ``index_add_`` on CUDA adds in whatever
  order its atomics land, so its bits change from run to run. The order is
  built once for an index vector (two host reads) and reused for every sum
  over it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


def scalar(value, dtype, device) -> torch.Tensor:
    """A Python number as a 0-d tensor on ``device``, written by a fill kernel.
    ``torch.tensor(value, device="cuda")`` copies it from pageable host memory
    instead, and that copy makes the host wait until the stream has drained:
    one stall for every constant a step uploads."""
    return torch.full((), value, dtype=dtype, device=device)


def _as_values(val, dst: torch.Tensor) -> torch.Tensor:
    """``val`` (a tensor or a Python number) in ``dst``'s type, on its device."""
    if isinstance(val, torch.Tensor):
        return val.to(device=dst.device, dtype=dst.dtype)
    return scalar(val, dst.dtype, dst.device)


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last axis."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def drop_targets(ok: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """``idx`` where ``ok``, else a scratch slot of the entry's own past ``n``
    (n + its position): the targets of a scatter into ``n + len(idx)`` rows."""
    return torch.where(ok, idx, n + torch.arange(idx.shape[0], dtype=idx.dtype, device=idx.device))


def nonzero_fixed(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """First ``size`` indices where the 1-D ``mask`` holds, padded with ``fill``."""
    n = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    tgt = drop_targets(mask & (pos < size), pos, size)
    out = torch.full((size + n,), fill, dtype=torch.int64, device=mask.device)
    out.scatter_(0, tgt, torch.arange(n, dtype=torch.int64, device=mask.device))
    return out[:size]


def _last_writer(idx: torch.Tensor, n: int):
    """(ok, target) for a flat index vector: ok marks in-range entries that
    are the last occurrence of their index; target is ``n`` elsewhere."""
    m = idx.shape[0]
    ok = (idx >= 0) & (idx < n)
    tgt = drop_targets(ok, idx, n)
    pos = torch.arange(m, dtype=torch.int64, device=idx.device)
    last = torch.full((n + m,), -1, dtype=torch.int64, device=idx.device)
    last.scatter_reduce_(0, tgt, pos, reduce="amax")
    keep = ok & (last[tgt] == pos)
    return keep, drop_targets(keep, tgt, n)


def scatter_set(dst: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """Out-of-place ``dst.at[idx].set(val, mode="drop")`` along axis 0."""
    n = dst.shape[0]
    idx = idx.reshape(-1).to(torch.int64)
    keep, tgt = _last_writer(idx, n)
    val = _as_values(val, dst)
    val = val.expand((idx.shape[0],) + dst.shape[1:])
    # rows past n: write-only scratch rows, one per dropped entry
    out = torch.cat([dst, dst[:1].expand((idx.shape[0],) + dst.shape[1:])], 0)
    out.index_put_((tgt,), val)
    return out[:n]


def scatter_set2(dst: torch.Tensor, i0: torch.Tensor, i1: torch.Tensor, val) -> torch.Tensor:
    """Out-of-place ``dst.at[i0, i1].set(val, mode="drop")`` over two axes."""
    A, B = dst.shape[0], dst.shape[1]
    i0 = i0.reshape(-1).to(torch.int64)
    i1 = i1.reshape(-1).to(torch.int64)
    inb = (i0 >= 0) & (i0 < A) & (i1 >= 0) & (i1 < B)
    flat = torch.where(inb, i0 * B + i1, torch.full_like(i0, A * B))
    out = scatter_set(dst.reshape((A * B,) + dst.shape[2:]), flat, val)
    return out.reshape(dst.shape)


def scatter_add(dst: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """Out-of-place ``dst.at[idx].add(val, mode="drop")`` along axis 0."""
    n = dst.shape[0]
    idx = idx.reshape(-1).to(torch.int64)
    tgt = drop_targets((idx >= 0) & (idx < n), idx, n)
    val = _as_values(val, dst)
    val = val.expand((idx.shape[0],) + dst.shape[1:])
    out = torch.cat([dst, torch.zeros_like(dst[:1]).expand((idx.shape[0],) + dst.shape[1:])], 0)
    out.index_add_(0, tgt, val)
    return out[:n]


def scatter_min(dst: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """Out-of-place ``dst.at[idx].min(val, mode="drop")`` along axis 0 (1-D)."""
    n = dst.shape[0]
    idx = idx.reshape(-1).to(torch.int64)
    tgt = drop_targets((idx >= 0) & (idx < n), idx, n)
    out = torch.cat([dst, dst[:1].expand(idx.shape[0])], 0)
    out.scatter_reduce_(0, tgt, val.reshape(-1).to(dst.dtype), reduce="amin")
    return out[:n]


class SegmentOrder(NamedTuple):
    """The fixed summation order of ``segment_sum`` over one index vector."""

    rows: torch.Tensor     # i64[S]: the rows that receive entries, increasing
    gather: torch.Tensor   # i64[S, W]: each row's entry positions, increasing, padded with 0
    live: torch.Tensor     # bool[S, W]: which of ``gather`` are entries, not padding
    n_rows: int
    n: int                 # length of the index vector


def segment_order(idx: torch.Tensor, n_rows: int) -> SegmentOrder:
    """The order of a segment sum of ``idx.numel()`` entries into ``n_rows``
    rows: entry i goes to row ``idx[i]``, and out-of-range indices are
    dropped. A stable sort groups the entries by row, so each row sums its
    entries in increasing position. Two host reads (the rows hit, the widest
    row): build it once per index vector, not once per sum."""
    idx = idx.reshape(-1).long()
    n, dev = idx.shape[0], idx.device
    key = torch.where((idx >= 0) & (idx < n_rows), idx, n_rows)
    key, order = torch.sort(key, stable=True)
    bounds = torch.searchsorted(key, torch.arange(n_rows + 1, dtype=key.dtype, device=dev))
    counts = bounds[1:] - bounds[:-1]
    rows = torch.nonzero(counts).reshape(-1)
    width = int(counts.max()) if n_rows > 0 and rows.numel() else 0
    j = torch.arange(width, dtype=torch.int64, device=dev)
    live = j[None, :] < counts[rows, None]
    pos = torch.clamp(bounds[rows, None] + j[None, :], max=max(n - 1, 0))
    gather = torch.where(live, order[pos], 0) if n else torch.zeros_like(pos)
    return SegmentOrder(rows=rows, gather=gather, live=live, n_rows=n_rows, n=n)


def segment_sum(vals: torch.Tensor, order: SegmentOrder) -> torch.Tensor:
    """``zeros([n_rows, ...]).at[idx].add(vals)`` for the ``idx`` of
    ``order``; ``vals`` [n, ...]. Each row's entries are gathered into a
    padded [S, W] block and reduced along W, a reduction of fixed shape: the
    same inputs give the same bits on every run."""
    tail = vals.shape[1:]
    flat = vals.reshape(order.n, math.prod(tail))
    g = torch.where(order.live[..., None], flat[order.gather], 0.0)
    out = torch.zeros((order.n_rows, flat.shape[1]), dtype=vals.dtype, device=vals.device)
    out[order.rows] = g.sum(1)
    return out.reshape((order.n_rows,) + tuple(tail))
