"""Process groups for global BA over several ranks (port of ``dialog_tpu/distributed.py``).

The reference brings up ``jax.distributed`` and a ('hosts', 'chips') mesh,
and lets XLA insert the cross-device sums when global BA's landmark axis is
sharded over it. Here one process is one rank with one device, the ranks
form a ``torch.distributed`` process group, and the solvers call
``all_reduce`` themselves where the reference's XLA reduces: each rank holds
a contiguous slice of the landmarks (``landmark_slice``, padded so that every
rank holds the same count) and every camera. This module is the one place
that knows about processes.

Start each rank with the usual variables (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, as ``torchrun`` sets them) and call
``initialize()``; an ``Engine`` made afterwards takes the default group.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def initialize(address: str | None = None, world_size: int | None = None, rank: int | None = None,
               backend: str | None = None) -> None:
    """Join the process group (one process per rank).

    A no-op when no address is given and ``MASTER_ADDR`` is not set (the
    single-process case), or when the group already exists. ``address`` is
    an ``init_method`` URL (``tcp://host:port``); without it the group reads
    ``MASTER_ADDR`` / ``MASTER_PORT``. ``world_size`` and ``rank`` fall back
    to ``WORLD_SIZE`` and ``RANK``. The backend is NCCL where CUDA is
    available, gloo elsewhere, unless ``backend`` names one (gloo also
    carries CUDA tensors, which lets several ranks share one card).
    """
    if address is None and "MASTER_ADDR" not in os.environ:
        return
    if dist.is_initialized():
        return
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:   # not `or`: rank 0 is falsy
        rank = int(os.environ["RANK"])
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=address or "env://", world_size=world_size, rank=rank)


def default_group():
    """The world group when a process group with more than one rank
    exists, else None (the engine then solves on its own)."""
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return dist.group.WORLD
    return None


def landmark_slice(n: int, rank: int, world: int) -> tuple[int, int, int]:
    """Rank ``rank``'s contiguous share of ``n`` landmarks among ``world``
    ranks: ``(lo, hi, per_rank)``. Every rank holds ``per_rank`` =
    ceil(n / world) rows, its landmarks ``lo:hi`` first and padding after
    them (the last ranks may hold padding only)."""
    per = -(-n // world)
    lo = min(rank * per, n)
    return lo, min(lo + per, n), per


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (in place); ``x`` itself
    when there is no group."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


def gather_landmarks(x: torch.Tensor, n: int, group) -> torch.Tensor:
    """The whole landmark axis [n, ...] from each rank's padded slice ``x``
    [per_rank, ...] (``landmark_slice``): every rank writes its slice into
    zeros and one ``all_reduce`` sums them, so the rows come back exact."""
    if group is None:
        return x
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    per = x.shape[0]
    full = torch.zeros((world * per,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    full[rank * per : (rank + 1) * per] = x
    dist.all_reduce(full, group=group)
    return full[:n]
