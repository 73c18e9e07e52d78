"""Counter-based random draws, bit-equal to ``jax.random`` (threefry2x32,
``jax_threefry_partitionable=True``) for the calls the renderer makes:
``PRNGKey``, ``fold_in`` and f32 ``uniform``, and their per-lane forms
``fold_in_lanes`` / ``uniform_lanes`` (the JAX package's
``vmap(fold_in)`` then ``vmap(uniform)``, shade.py ``_uniform``).

Keys are int64 tensors of shape [2] (per lane: [R, 2]) holding two 32-bit
words.  All words travel as int64 masked to 32 bits, since torch has no
uint32 arithmetic.  The hash is elementwise, so it runs on CPU and CUDA
tensors alike.
"""

from __future__ import annotations

import torch

_M = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 hash of counter words (x1, x2) under key (k1, k2).

    k1, k2, x1, x2: Python ints, or int64 tensors of 32-bit words that
    broadcast against each other."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M
    x2 = (x2 + ks[1]) & _M
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _M
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M
    return x1, x2


def PRNGKey(seed: int) -> torch.Tensor:
    """jax.random.PRNGKey for a 32-bit seed: words (0, seed mod 2^32)."""
    return torch.tensor([0, int(seed) & _M], dtype=torch.int64)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """jax.random.fold_in: hash of the counter pair (0, data) under key,
    on Python ints (a render folds keys per tile, chunk and round)."""
    k1, k2 = (int(v) for v in key.tolist())
    return torch.tensor(threefry2x32(k1, k2, 0, int(data) & _M), dtype=torch.int64)


def uniform(key: torch.Tensor, shape, device, start: int = 0) -> torch.Tensor:
    """jax.random.uniform(key, shape, float32) in [0, 1), drawn on device.
    With `start`, the draws of a larger array from flat position `start`
    on (rows [lo, lo + shape[0]) of a [R, k] draw: start = lo * k)."""
    k1, k2 = (int(v) for v in key.tolist())
    n = 1
    for s in shape:
        n *= int(s)
    lo = torch.arange(start, start + n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return _bits_to_unit(b1 ^ b2).reshape(tuple(shape))


def _bits_to_unit(bits):
    """32 random bits -> f32 in [1, 2) by mantissa fill, minus 1."""
    mant = (bits >> 9) | 0x3F800000
    return mant.to(torch.int32).view(torch.float32) - 1.0


def fold_in_lanes(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """vmap(fold_in, in_axes=(None, 0))(key, data): [R, 2] per-lane keys
    for int data [R], on data's device."""
    k1, k2 = (int(v) for v in key.tolist())
    x2 = data.to(torch.int64) & _M
    x1, x2 = threefry2x32(k1, k2, torch.zeros_like(x2), x2)
    return torch.stack([x1, x2], dim=-1)


def uniform_lanes(keys: torch.Tensor, n: int) -> torch.Tensor:
    """vmap(lambda k: uniform(k, (n,), float32))(keys): [R, n] draws for
    per-lane keys [R, 2]."""
    lo = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    b1, b2 = threefry2x32(keys[:, 0:1], keys[:, 1:2], torch.zeros_like(lo), lo)
    return _bits_to_unit(b1 ^ b2)
