"""Precision modes of the reference: f64, f32, and the TF32 control."""

from __future__ import annotations

import torch

MODES = ("f64", "f32", "tf32")


def dtype(mode: str) -> torch.dtype:
    if mode not in MODES:
        raise ValueError(f"precision must be one of {MODES}, got {mode!r}")
    return torch.float64 if mode == "f64" else torch.float32


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (8-bit exponent, 10-bit mantissa), to nearest, ties away."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + (1 << 12)) & ~((1 << 13) - 1)
    return bits.view(torch.float32)


def operand(x: torch.Tensor, mode: str) -> torch.Tensor:
    """``x`` as an operand of a matrix product in ``mode``."""
    x = x.to(dtype(mode))
    return to_tf32(x) if mode == "tf32" else x


def mm(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """a @ b with both operands rounded as the mode's matrix unit rounds them."""
    return operand(a, mode) @ operand(b, mode)


def einsum(eq: str, *xs: torch.Tensor, mode: str) -> torch.Tensor:
    return torch.einsum(eq, *[operand(x, mode) for x in xs])
