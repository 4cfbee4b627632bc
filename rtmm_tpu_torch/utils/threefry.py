"""Threefry-2x32 random numbers in integer torch ops, vectorised over lanes.

The path tracer draws its randoms as a stateless hash of (seed, bounce,
sample, pixel) (render/pathtrace.py, rand2): the same numbers for a ray
whatever order the rays are sorted in. This module reproduces the JAX
package's draw bit for bit, following jax.random's threefry
implementation (jax/_src/prng.py, the partitionable bit path that is
jax's default):

  key(seed)        [seed >> 32, seed & 0xFFFFFFFF]
  fold_in(k, x)    threefry2x32(k, [0, x])
  uniform(k, (2,)) for counter i in (0, 1): bits = out0 ^ out1 of
                   threefry2x32(k, (0, i)); u = bitcast((bits >> 9) |
                   0x3F800000) - 1.0

Words are unsigned 32-bit values held in int64 tensors and masked to 32
bits after every add and shift (torch's uint32 support is thin). A key is
a pair (k0, k1) of int64 tensors of one shape: one key per lane.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block function (20 rounds) of key (k0, k1) on the
    counter words (x0, x1); all broadcastable int64 tensors of 32-bit
    values. Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def key(seed: int, device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """jax.random.key(seed)'s two words, as 0-dim int64 tensors."""
    seed = int(seed)
    return (torch.tensor((seed >> 32) & MASK, dtype=torch.int64,
                         device=device),
            torch.tensor(seed & MASK, dtype=torch.int64, device=device))


def fold_in(k, data) -> tuple[torch.Tensor, torch.Tensor]:
    """jax.random.fold_in(k, data) for every lane: data is an integer
    tensor (or int) of 32-bit values, broadcast against the key words."""
    k0, k1 = k
    data = torch.as_tensor(data, device=k0.device).to(torch.int64) & MASK
    return threefry2x32(k0, k1, torch.zeros_like(data), data)


def uniform2(k) -> torch.Tensor:
    """jax.random.uniform(k, (2,)) per lane: (..., 2) float32 in [0, 1)."""
    k0, k1 = k
    words = []
    for i in range(2):
        counter = torch.full_like(k0, i)
        b0, b1 = threefry2x32(k0, k1, torch.zeros_like(k0), counter)
        words.append(b0 ^ b1)
    bits = torch.stack(words, dim=-1)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0
