"""The fixed-order segment sum (``ops.segment_order`` / ``ops.segment_sum``)
that the Schur PCG and the pose graph sum with (ROADMAP D15: a float
``index_add_`` on CUDA adds in whatever order its atomics land).

On the CPU: equal to ``index_add_`` into zeros, and to a float64 sum, within
1e-6 of each row's sum of absolute entries (the two f32 sums add in
different orders) over vectors, 6-vectors and 6x6 blocks, with indices out
of range dropped, rows without entries left zero, an empty index vector,
and one order reused for several value tensors. The PCG and pose-graph
tests (``tests/test_torch_schur_pcg.py``, ``tests/test_torch_pose_graph.py``)
run unchanged through it. On the card it repeats bit for bit
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from dialog_tpu_torch import ops

torch.set_num_threads(2)


def _index_add(idx, vals, n_rows):
    ok = (idx >= 0) & (idx < n_rows)
    out = torch.zeros((n_rows + 1,) + vals.shape[1:], dtype=vals.dtype)
    return out.index_add_(0, torch.where(ok, idx, n_rows), vals)[:n_rows]


# (n entries, n rows, value shape, share of entries out of range)
CASES = [(1000, 40, (), 0.1), (5000, 97, (6,), 0.3), (3000, 13, (6, 6), 0.0), (200, 500, (7,), 0.5), (0, 8, (6,), 0.0)]


@pytest.mark.parametrize("n,n_rows,shape,drop", CASES, ids=[f"{c[0]}x{c[1]}" for c in CASES])
def test_segment_sum_equals_index_add(n, n_rows, shape, drop):
    rng = np.random.default_rng(n + n_rows)
    idx = rng.integers(0, n_rows, n)
    bad = rng.random(n) < drop
    idx[bad] = rng.choice([-1, -7, n_rows, n_rows + 3], int(bad.sum()))
    idx = torch.from_numpy(idx)
    order = ops.segment_order(idx, n_rows)
    for k in range(3):   # one order, several value tensors
        vals = torch.from_numpy(rng.normal(0, 1, (n,) + shape).astype(np.float32))
        got = ops.segment_sum(vals, order)
        want = _index_add(idx, vals, n_rows)
        assert got.shape == want.shape
        # both are f32 sums in different orders: each row within 1e-6 of its entries' absolute sum
        scale = _index_add(idx, vals.abs().double(), n_rows)
        exact = _index_add(idx, vals.double(), n_rows)
        assert bool(((got.double() - want.double()).abs() <= 1e-6 * scale).all())
        assert bool(((got.double() - exact).abs() <= 1e-6 * scale).all())
        assert torch.equal(got, ops.segment_sum(vals, order))
    hit = torch.zeros(n_rows, dtype=torch.bool)
    hit[idx[(idx >= 0) & (idx < n_rows)]] = True
    assert torch.equal(order.rows, torch.nonzero(hit).reshape(-1))


def test_segment_order_sums_each_row_in_entry_order():
    idx = torch.tensor([2, 0, 2, 5, 2, 0, -1])
    order = ops.segment_order(idx, 4)
    assert order.rows.tolist() == [0, 2]
    assert order.gather[order.live].tolist() == [1, 5, 0, 2, 4]
    assert order.gather.shape == (2, 3)


@pytest.mark.parametrize("seed", [0, 1])
def test_scatters_drop_out_of_range_entries(seed):
    """The drop-mode scatters of ``ops`` (every dropped entry in a scratch slot
    of its own) against a plain numpy loop: the last write wins in
    ``scatter_set``, ``scatter_add`` and ``scatter_min`` accumulate, and
    ``nonzero_fixed`` keeps the first ``size`` hits."""
    rng = np.random.default_rng(seed)
    n, m = 50, 400
    idx = rng.integers(-5, n + 5, m)
    vals = rng.integers(-100, 100, m).astype(np.int32)
    dst = rng.integers(-100, 100, n).astype(np.int32)
    want_set, want_add, want_min = dst.copy(), dst.copy(), dst.copy()
    for i, v in zip(idx, vals):
        if 0 <= i < n:
            want_set[i] = v
            want_add[i] += v
            want_min[i] = min(want_min[i], v)
    t_idx, t_vals, t_dst = torch.from_numpy(idx), torch.from_numpy(vals), torch.from_numpy(dst)
    np.testing.assert_array_equal(ops.scatter_set(t_dst, t_idx, t_vals).numpy(), want_set)
    np.testing.assert_array_equal(ops.scatter_add(t_dst, t_idx, t_vals).numpy(), want_add)
    np.testing.assert_array_equal(ops.scatter_min(t_dst, t_idx, t_vals).numpy(), want_min)
    mask = rng.random(m) < 0.3
    for size in (5, int(mask.sum()), m):
        hits = np.nonzero(mask)[0][:size]
        want = np.full(size, -9)
        want[: len(hits)] = hits
        np.testing.assert_array_equal(ops.nonzero_fixed(torch.from_numpy(mask), size, -9).numpy(), want)
