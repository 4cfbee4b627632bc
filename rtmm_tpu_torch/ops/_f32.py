"""Float32 arithmetic helpers that round the same on every device.

PyTorch's CUDA backend divides a tensor by a Python scalar as a multiply
by the scalar's reciprocal (one extra rounding), and `scalar / tensor`
goes through `reciprocal() * scalar` on every device. The JAX reference
and the port's CUDA kernel both divide correctly rounded, so the port
divides by tensors only: a 0-dim tensor made on the operand's own device
(a fill there, no host copy).
"""
from __future__ import annotations

import torch


def const(x: float, like: torch.Tensor) -> torch.Tensor:
    """0-dim float32 tensor holding x on like's device."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def div(a: torch.Tensor, b) -> torch.Tensor:
    """a / b, correctly rounded, for a tensor or Python-scalar b."""
    if not isinstance(b, torch.Tensor):
        b = const(b, a)
    return torch.div(a, b)


def rdiv(a: float, b: torch.Tensor) -> torch.Tensor:
    """Python scalar a divided by tensor b, correctly rounded."""
    return torch.div(const(a, b), b)
