"""Threefry-2x32 and the path tracer's draw, frozen (jax.random's threefry:
key(seed) = [seed >> 32, seed & 0xFFFFFFFF], fold_in(k, x) =
threefry2x32(k, [0, x]), uniform(k, (2,)) from the counters 0 and 1).

A lane g = sample * total + pixel of bounce b draws
uniform(fold_in(fold_in(fold_in(key(seed), b), g // total), g % total),
(2,)). Words are 32-bit values in int64 tensors.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & MASK


def block(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on broadcastable int64 words."""
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def fold_in(k, data):
    k0, k1 = k
    data = torch.as_tensor(data, device=k0.device).to(torch.int64) & MASK
    return block(k0, k1, torch.zeros_like(data), data)


def uniform2(k) -> torch.Tensor:
    """(..., 2) float32 uniforms in [0, 1) of per-lane keys."""
    k0, k1 = k
    words = []
    for i in range(2):
        b0, b1 = block(k0, k1, torch.zeros_like(k0), torch.full_like(k0, i))
        words.append(b0 ^ b1)
    bits = torch.stack(words, dim=-1)
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32) - 1.0


def draw(seed: int, bounce: int, lanes: torch.Tensor,
         total: int) -> torch.Tensor:
    """(n, 2) uniforms of `bounce` for global lanes g."""
    seed = int(seed)
    dev = lanes.device
    key = (torch.tensor((seed >> 32) & MASK, device=dev),
           torch.tensor(seed & MASK, device=dev))
    kb = fold_in(key, bounce)
    g = lanes.to(torch.int64)
    return uniform2(fold_in(fold_in(kb, g // total), g % total))
