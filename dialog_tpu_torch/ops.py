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
* ``scatter_min``   -- ``x.at[idx].min(v)``.
"""

from __future__ import annotations

import torch


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last axis."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def nonzero_fixed(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """First ``size`` indices where the 1-D ``mask`` holds, padded with ``fill``."""
    n = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    tgt = torch.where(mask & (pos < size), pos, torch.full_like(pos, size))
    out = torch.full((size + 1,), fill, dtype=torch.int64, device=mask.device)
    # row `size` collects every dropped entry and is cut off below
    out.scatter_(0, tgt, torch.arange(n, dtype=torch.int64, device=mask.device))
    return out[:size]


def _last_writer(idx: torch.Tensor, n: int):
    """(ok, target) for a flat index vector: ok marks in-range entries that
    are the last occurrence of their index; target is ``n`` elsewhere."""
    m = idx.shape[0]
    ok = (idx >= 0) & (idx < n)
    tgt = torch.where(ok, idx, torch.full_like(idx, n))
    pos = torch.arange(m, dtype=torch.int64, device=idx.device)
    last = torch.full((n + 1,), -1, dtype=torch.int64, device=idx.device)
    last.scatter_reduce_(0, tgt, pos, reduce="amax")
    keep = ok & (last[tgt] == pos)
    return keep, torch.where(keep, tgt, torch.full_like(tgt, n))


def scatter_set(dst: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """Out-of-place ``dst.at[idx].set(val, mode="drop")`` along axis 0."""
    n = dst.shape[0]
    idx = idx.reshape(-1).to(torch.int64)
    keep, tgt = _last_writer(idx, n)
    val = torch.as_tensor(val, dtype=dst.dtype, device=dst.device)
    val = val.expand((idx.shape[0],) + dst.shape[1:])
    out = torch.cat([dst, dst[:1]], 0)
    # row n is a write-only scratch row for every dropped entry
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
    ok = (idx >= 0) & (idx < n)
    tgt = torch.where(ok, idx, torch.full_like(idx, n))
    val = torch.as_tensor(val, dtype=dst.dtype, device=dst.device)
    val = val.expand((idx.shape[0],) + dst.shape[1:])
    out = torch.cat([dst, torch.zeros_like(dst[:1])], 0)
    out.index_add_(0, tgt, val)
    return out[:n]


def scatter_min(dst: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """Out-of-place ``dst.at[idx].min(val, mode="drop")`` along axis 0 (1-D)."""
    n = dst.shape[0]
    idx = idx.reshape(-1).to(torch.int64)
    ok = (idx >= 0) & (idx < n)
    tgt = torch.where(ok, idx, torch.full_like(idx, n))
    out = torch.cat([dst, dst[:1]], 0)
    out.scatter_reduce_(0, tgt, val.reshape(-1).to(dst.dtype), reduce="amin")
    return out[:n]
