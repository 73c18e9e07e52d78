"""A frozen copy of the counter-based draws that the renderer's samples are
keyed by: Threefry-2x32 with 20 rounds (Salmon et al., "Parallel random
numbers: as easy as 1, 2, 3", SC 2011), as ``jax.random`` applies it with
partitionable keys: a key is two 32-bit words, ``fold_in(key, n)`` hashes
the counter pair (0, n), and ``uniform`` fills the mantissa of a float32
in [1, 2) with the top 23 bits of ``x1 ^ x2`` at counter (0, i) and
subtracts 1.

Words are int64 tensors masked to 32 bits (torch has no uint32
arithmetic).  Written for the benchmark's reference alone: it imports
nothing of the program.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def hash2x32(k0, k1, c0, c1):
    """Threefry-2x32 (20 rounds) of counter words (c0, c1) under key words
    (k0, k1); every argument an int or an int64 tensor, broadcast."""
    k2 = k0 ^ k1 ^ PARITY
    ks = (k0, k1, k2)
    x0 = (c0 + k0) & MASK
    x1 = (c1 + k1) & MASK
    for block in range(5):
        for r in ROTATIONS[block % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & MASK
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & MASK
    return x0, x1


def key(seed: int, device) -> torch.Tensor:
    """The key of a seed: words (0, seed mod 2^32), as [2] int64."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64, device=device)


def fold(k: torch.Tensor, n) -> torch.Tensor:
    """fold_in: keys [..., 2] and data n (an int or an int tensor that
    broadcasts against k[..., 0]) -> keys [..., 2]."""
    n = (n.to(torch.int64) if isinstance(n, torch.Tensor) else int(n)) & MASK
    x0, x1 = hash2x32(k[..., 0], k[..., 1], 0, n)
    return torch.stack([x0, x1], dim=-1)


def _unit(bits):
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def uniform_at(k: torch.Tensor, counters: torch.Tensor) -> torch.Tensor:
    """float32 draws in [0, 1) of key k (words [2], or per lane [..., 2]
    broadcast against `counters`) at flat positions `counters` (int64)."""
    x0, x1 = hash2x32(k[..., 0], k[..., 1], torch.zeros_like(counters), counters)
    return _unit(x0 ^ x1)
