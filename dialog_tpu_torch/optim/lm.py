"""Shared Levenberg-Marquardt machinery (port of ``dialog_tpu/optim/lm.py``)."""

from __future__ import annotations

import torch


def chol3x3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form lower Cholesky factor of batched SPD 3x3 matrices."""
    a11 = torch.sqrt(torch.clamp(A[..., 0, 0], min=1e-18))
    l21 = A[..., 1, 0] / a11
    l31 = A[..., 2, 0] / a11
    l22 = torch.sqrt(torch.clamp(A[..., 1, 1] - l21 * l21, min=1e-18))
    l32 = (A[..., 2, 1] - l31 * l21) / l22
    l33 = torch.sqrt(torch.clamp(A[..., 2, 2] - l31 * l31 - l32 * l32, min=1e-18))
    z = torch.zeros_like(a11)
    return torch.stack(
        [
            torch.stack([a11, z, z], -1),
            torch.stack([l21, l22, z], -1),
            torch.stack([l31, l32, l33], -1),
        ],
        -2,
    )


def tri_inv3x3_lower(L: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of batched lower-triangular 3x3 matrices."""
    l11, l22, l33 = L[..., 0, 0], L[..., 1, 1], L[..., 2, 2]
    i11 = 1.0 / l11
    i22 = 1.0 / l22
    i33 = 1.0 / l33
    i21 = -L[..., 1, 0] * i11 * i22
    i31 = (L[..., 1, 0] * L[..., 2, 1] - L[..., 1, 1] * L[..., 2, 0]) * (i11 * i22 * i33)
    i32 = -L[..., 2, 1] * i22 * i33
    z = torch.zeros_like(l11)
    return torch.stack(
        [
            torch.stack([i11, z, z], -1),
            torch.stack([i21, i22, z], -1),
            torch.stack([i31, i32, i33], -1),
        ],
        -2,
    )


def all_finite(*tensors) -> torch.Tensor:
    """0-d bool: every floating tensor given is finite everywhere."""
    ok = torch.ones((), dtype=torch.bool, device=tensors[0].device)
    for x in tensors:
        if x.is_floating_point():
            ok = ok & torch.isfinite(x).all()
    return ok


def jacobian_at_zero(f, n: int, batch: tuple, like: torch.Tensor):
    """Values and forward-mode Jacobians of ``f`` at xi = 0.

    ``f`` maps xi [n, *batch, n] to a tuple of float outputs [n, *batch, ...]:
    n copies of the zero point, the k-th carrying the tangent e_k, so one
    evaluation over the leading axis gives every column. Returns per output
    (its value [*batch, ...], its Jacobian [*batch, ..., n]). This is what
    ``torch.func.vmap(jacfwd(f))`` computes; ``jacfwd`` itself is not used
    because it gives 0-d intermediates combined with a Python number float64
    tangents (torch 2.13), and the pose graph's per-edge scales are 0-d."""
    import torch.autograd.forward_ad as fwAD

    shape = (n,) + tuple(batch) + (n,)
    eye = torch.eye(n, dtype=like.dtype, device=like.device)
    tangent = eye.reshape((n,) + (1,) * len(batch) + (n,)).expand(shape).contiguous()
    with fwAD.dual_level():
        outs = f(fwAD.make_dual(torch.zeros(shape, dtype=like.dtype, device=like.device), tangent))
        res = []
        for o in outs:
            value, tan = fwAD.unpack_dual(o)
            tan = torch.zeros_like(value) if tan is None else tan
            res.append((value[0], tan.movedim(0, -1)))
    return res


def huber_weight(chi2: torch.Tensor, delta2) -> torch.Tensor:
    """IRLS weight of the Huber loss: 1 inside delta^2, delta/sqrt(chi2) outside."""
    safe = torch.clamp(chi2, min=1e-12)
    return torch.where(chi2 <= delta2, torch.ones_like(chi2), torch.sqrt(delta2 / safe))


def solve_damped(H: torch.Tensor, g: torch.Tensor, lam) -> torch.Tensor:
    """Solve (H + lam * diag(H)) dx = -g (LM with multiplicative damping).

    ``solve_ex`` is ``torch.linalg.solve`` without its check of the
    factorization's status, which reads a flag back to the host and stalls
    it once per LM iteration: a singular system gives a non-finite step here,
    which ``lm_loop`` rejects on the device."""
    d = torch.diagonal(H, dim1=-2, dim2=-1)
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    Hd = H + lam * eye * torch.clamp(d, min=1e-9)
    return -torch.linalg.solve_ex(Hd, g.unsqueeze(-1), check_errors=False)[0].squeeze(-1)


def lm_loop(cost_and_system, retract, x0, iters: int, lam0: float = 1e-3):
    """Damped LM: accept/reject with lam *0.5 on accept, *4 on reject.

    cost_and_system(x) -> (cost, H, g); retract(x, dx) -> x'. ``x`` is a
    tuple of tensors. Decisions stay on the device (no host sync).
    """
    cost, H, g = cost_and_system(x0)
    x = x0
    dev = H.device
    lam = torch.full((), lam0, dtype=torch.float32, device=dev)   # no host copy (ops.scalar)
    for _ in range(iters):
        dx = solve_damped(H, g, lam)
        x_new = retract(x, dx)
        new_cost, H_new, g_new = cost_and_system(x_new)
        accept = (new_cost < cost) & all_finite(*x_new)
        x = tuple(torch.where(accept, a, b) for a, b in zip(x_new, x))
        H = torch.where(accept, H_new, H)
        g = torch.where(accept, g_new, g)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6)
        cost = torch.where(accept, new_cost, cost)
    return x, cost
