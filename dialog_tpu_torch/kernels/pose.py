"""The pose LM in one launch (CUDA: ``csrc/pose.cu``).

``pose_lm`` runs every round and iteration of motion-only bundle adjustment
(``optim/pose_only.pose_optimization``) in one block on the card: the
damped LM on the Huber-weighted reprojection rows, the accept or reject
with its damping schedule, and the chi2 re-gate between rounds. Its plain
version is ``optim/pose_only.pose_optimization_plain``, the same loop
written in PyTorch; ``pose_optimization`` takes this kernel for CUDA
tensors and the plain version for CPU tensors. It replaces no Pallas
kernel: the JAX package leaves the function to XLA as one program, and the
kernel exists because the plain loop is about 2,100 launches a call.

The per-observation terms are float32, as the plain version computes them;
the sums of the normal equations, the 6x6 solve, the retraction and the
orthogonalization are float64, the pose rounded to float32 after each. The
stereo form (``stereo``: a uR row where ``u_right >= 0``) counts its
launches as ``pose_lm_stereo``. A block strides over the observations, so
N has no limit of the kernel's own.
"""

from __future__ import annotations

import torch

from . import common


def pose_lm(R0, t0, X, uv, inv_sigma2, valid, fx, fy, cx, cy, chi2_th: float, rounds: int, iters: int,
            u_right=None, bf: float = 0.0, stereo: bool = False):
    """(R f32[3,3], t f32[3], inlier bool[N], n_inliers i64, cost f32) of
    ``pose_optimization`` on CUDA tensors, in fresh tensors on every call.
    ``u_right`` f32[N] is read with ``stereo``. Launches on the current
    stream and reads nothing back."""
    from .build import load

    dev = X.device
    if common.route(X) != "cuda":
        raise ValueError(f"pose_lm: the kernel takes CUDA tensors, got {dev}")
    N = X.shape[0]
    args = [("R0", R0, torch.float32, (3, 3)), ("t0", t0, torch.float32, (3,)), ("X", X, torch.float32, (N, 3)),
            ("uv", uv, torch.float32, (N, 2)), ("inv_sigma2", inv_sigma2, torch.float32, (N,)),
            ("valid", valid, torch.bool, (N,))]
    if stereo:
        if u_right is None:
            raise ValueError("pose_lm: the stereo form needs u_right")
        args.append(("u_right", u_right, torch.float32, (N,)))
    for name, x, dt, shape in args:
        common.require(x, name, dt, shape, dev)
    if rounds < 0 or iters < 0:
        raise ValueError(f"pose_lm: rounds and iters are counts, got {rounds} and {iters}")
    R = torch.empty((3, 3), dtype=torch.float32, device=dev)
    t = torch.empty((3,), dtype=torch.float32, device=dev)
    inlier = torch.empty((N,), dtype=torch.bool, device=dev)
    n_inliers = torch.empty((), dtype=torch.int64, device=dev)
    cost = torch.empty((), dtype=torch.float32, device=dev)
    err = load("pose").pose_lm_launch(
        common.ptr(R0), common.ptr(t0), common.ptr(X), common.ptr(uv), common.ptr(inv_sigma2), common.ptr(valid),
        common.ptr(u_right) if stereo else None, N, float(fx), float(fy), float(cx), float(cy), float(bf),
        float(chi2_th), int(rounds), int(iters), int(stereo),
        common.ptr(R), common.ptr(t), common.ptr(inlier), common.ptr(n_inliers), common.ptr(cost),
        common.stream_ptr(dev))
    name = "pose_lm_stereo" if stereo else "pose_lm"
    common.launches[name] += 1
    common.check(err, name)
    return R, t, inlier, n_inliers, cost
