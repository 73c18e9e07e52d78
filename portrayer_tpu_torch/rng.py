"""Counter-based random draws, bit-equal to ``jax.random`` (threefry2x32,
``jax_threefry_partitionable=True``) for the calls the renderer makes:
``PRNGKey``, ``fold_in`` (of one key, or batched: per lane, the JAX
package's ``vmap(fold_in)``) and f32 ``uniform``, ``uniform_lanes``
(``vmap(uniform)``) and ``draw_lanes`` (shade.py ``_uniform``'s per-lane
draws: ``uniform_lanes(fold_in(fold_in(key, site), sid), n)``).

Keys are int64 tensors of shape [2] (per lane: [R, 2]) holding two 32-bit
words.  ``fold_in``, ``uniform`` and ``draw_lanes`` go by the device of
their tensors: on CUDA tensors each is one launch of ``csrc/threefry.cu``
(built at first use); on CPU tensors each runs its plain version
(``fold_in_plain``, ``uniform_plain``, ``draw_lanes_plain``), the hash in
PyTorch int64 ops masked to 32 bits, since torch has no uint32
arithmetic.  Both give the same bits and never read a key on the host: a
key and the data folded into it may live on the card, as the render's
per-chunk keys do inside a captured CUDA graph, which then reads the key
its buffer holds at each replay.  A key [2] on the host travels to the
kernel by value.

``counts()`` gives the kernel's launches per entry point, counted on the
device where they run (a captured launch at each replay), and the calls
of the plain versions on CUDA tensors (``plain_on_cuda``), which the
render's main path never makes.
"""

from __future__ import annotations

import ctypes
import operator

import torch

from . import _build, counters

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


# ---------------------------------------------------------------------------
# Counts
# ---------------------------------------------------------------------------

# The kernel's entry points, in the order of csrc/threefry.cu's counters.
KERNELS = ("fold_in", "uniform", "draw_lanes")
_COUNTERS = counters.Group(KERNELS, host_only=("plain_on_cuda",))
COUNTS = _COUNTERS.host
device_counts = _COUNTERS.on
reset_counts = _COUNTERS.reset
counts = _COUNTERS.read


def _plain_call(*xs):
    """Count a plain version's call when one of xs is on the card."""
    if _cuda_device(*xs) is not None:
        COUNTS["plain_on_cuda"] += 1


# ---------------------------------------------------------------------------
# Plain versions (PyTorch int64 ops, on any device)
# ---------------------------------------------------------------------------

def _data_word(data):
    """The counter word of fold_in's data: an int, or an int tensor."""
    if isinstance(data, torch.Tensor):
        return data.to(torch.int64) & _M
    return int(data) & _M


def fold_in_plain(key: torch.Tensor, data) -> torch.Tensor:
    """fold_in in PyTorch ops."""
    _plain_call(key, data)
    x1, x2 = threefry2x32(key[..., 0], key[..., 1], 0, _data_word(data))
    return torch.stack([x1, x2], dim=-1)


def uniform_plain(key: torch.Tensor, shape, device, start: int = 0) -> torch.Tensor:
    """uniform in PyTorch ops."""
    _plain_call(key, torch.device(device))
    k1, k2 = key[0], key[1]
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


def uniform_lanes(keys: torch.Tensor, n: int) -> torch.Tensor:
    """vmap(lambda k: uniform(k, (n,), float32))(keys): [R, n] draws for
    per-lane keys [R, 2], in PyTorch ops."""
    _plain_call(keys)
    lo = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    b1, b2 = threefry2x32(keys[:, 0:1], keys[:, 1:2], torch.zeros_like(lo), lo)
    return _bits_to_unit(b1 ^ b2)


def draw_lanes_plain(key: torch.Tensor, site: int, sid: torch.Tensor, n: int) -> torch.Tensor:
    """draw_lanes in PyTorch ops."""
    return uniform_lanes(fold_in_plain(fold_in_plain(key, site), sid), n)


# ---------------------------------------------------------------------------
# The draws: one kernel launch each on CUDA tensors
# ---------------------------------------------------------------------------

def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """jax.random.fold_in: hash of the counter pair (0, data) under key.
    `key` is [..., 2] and `data` an int or an int tensor that broadcasts
    against key[..., 0]: the keys [..., 2] of every pair, on the key's or
    the data's device.  A key [2] and an int or 0-d tensor fold one key (a
    render folds keys per tile, chunk and round); per-lane data [R] gives
    vmap(fold_in)'s [R, 2]."""
    dev = _cuda_device(key, data)
    if dev is None:
        return fold_in_plain(key, data)
    return _fold_in_kernel(key, data, dev)


def uniform(key: torch.Tensor, shape, device, start: int = 0) -> torch.Tensor:
    """jax.random.uniform(key, shape, float32) in [0, 1), drawn on device.
    With `start`, the draws of a larger array from flat position `start`
    on (rows [lo, lo + shape[0]) of a [R, k] draw: start = lo * k)."""
    dev = _cuda_device(torch.device(device))
    if dev is None:
        return uniform_plain(key, shape, device, start)
    return _uniform_kernel(key, shape, dev, start)


def draw_lanes(key: torch.Tensor, site: int, sid: torch.Tensor, n: int) -> torch.Tensor:
    """[R, n] f32 uniforms, per lane keyed fold_in(fold_in(key, site),
    sid[lane]): uniform_lanes(fold_in(fold_in(key, site), sid), n) for one
    key [2], an int site and sample ids sid [R]."""
    dev = _cuda_device(key, sid)
    if dev is None:
        return draw_lanes_plain(key, site, sid, n)
    return _draw_lanes_kernel(key, site, sid, n, dev)


def _cuda_device(*xs):
    """The CUDA device of the first of xs (tensors or devices) on the card,
    its index filled in, or None when none is."""
    for x in xs:
        d = x.device if isinstance(x, torch.Tensor) else x
        if isinstance(d, torch.device) and d.type == "cuda":
            return d if d.index is not None else torch.device("cuda", torch.cuda.current_device())
    return None


def _key_args(key: torch.Tensor, dev, batched: bool = False):
    """(pointer, word stride, k1, k2, key) of `key` for a launch on `dev`:
    a key on the card is read there through its pointer; a key [2] on the
    host travels by value (null pointer), a batched one is copied over."""
    if key.dtype != torch.int64 or key.dim() < 1 or key.shape[-1] != 2:
        raise ValueError(f"threefry kernel: a key is int64 [..., 2], got {key.dtype} "
                         f"{tuple(key.shape)}")
    if not batched and key.dim() != 1:
        raise ValueError(f"threefry kernel: expected one key [2], got {tuple(key.shape)}")
    if key.device.type == "cpu" and key.dim() == 1:
        k1, k2 = (w & _M for w in key.tolist())
        return None, 0, k1, k2, key
    if key.device != dev:
        key = key.to(dev)
    return key.data_ptr(), key.stride(-1), 0, 0, key


def _int_tensor(name, x: torch.Tensor, dev) -> torch.Tensor:
    if x.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"threefry kernel: {name} must be int32 or int64, got {x.dtype}")
    return x if x.device == dev else x.to(dev)


def _launch(dev):
    """The kernel library, the counters of `dev` and its current stream."""
    return (_build.load(), device_counts(dev).data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)


def _done(entry: str, rc: int):
    if rc != 0:
        raise RuntimeError(f"threefry kernel ({entry}) launch failed: CUDA error {rc}")


# The kernel takes broadcast shapes of up to this many dimensions.
MAX_DIMS = 4


def _broadcast_shape(a, b) -> tuple:
    """The shape that a and b broadcast to (expand raises where they do
    not).  torch.broadcast_shapes would import sympy at its first call,
    seconds of a process's set-up."""
    n = max(len(a), len(b))
    a, b = (1,) * (n - len(a)) + tuple(a), (1,) * (n - len(b)) + tuple(b)
    return tuple(x if y == 1 else y for x, y in zip(a, b))


def _fold_in_kernel(key, data, dev) -> torch.Tensor:
    ptr, word, k1, k2, key = _key_args(key, dev, batched=True)
    lead = key.shape[:-1]
    d_ptr, d64, d_val = None, 0, 0
    if isinstance(data, torch.Tensor) and data.device.type == "cpu" and data.dim() == 0:
        data = int(data)  # a host scalar travels by value
    if isinstance(data, torch.Tensor):
        data = _int_tensor("data", data, dev)
        shape = _broadcast_shape(lead, data.shape)
        dx = data.expand(shape)
        d_ptr, d64, d_strides = dx.data_ptr(), int(data.dtype == torch.int64), dx.stride()
    else:
        shape, d_val, d_strides = lead, operator.index(data) & _M, (0,) * len(lead)
    if len(shape) > MAX_DIMS:
        raise ValueError(f"threefry kernel: fold_in over {len(shape)} dimensions; it takes "
                         f"{MAX_DIMS}")
    kx = key.expand(tuple(shape) + (2,))
    out = torch.empty(tuple(shape) + (2,), dtype=torch.int64, device=dev)
    arr = lambda v: (ctypes.c_longlong * MAX_DIMS)(*v)
    lib, counts_ptr, stream = _launch(dev)
    _done("fold_in", lib.threefry_fold_in(
        ptr, word, k1, k2, d_ptr, d64, d_val,
        len(shape), arr(shape), arr(kx.stride()[:-1]), arr(d_strides), out.numel() // 2,
        out.data_ptr(), counts_ptr, stream))
    return out


def _uniform_kernel(key, shape, dev, start: int) -> torch.Tensor:
    ptr, word, k1, k2, _ = _key_args(key, dev)
    out = torch.empty(tuple(int(s) for s in shape), dtype=torch.float32, device=dev)
    lib, counts_ptr, stream = _launch(dev)
    _done("uniform", lib.threefry_uniform(ptr, word, k1, k2, int(start), out.numel(),
                                          out.data_ptr(), counts_ptr, stream))
    return out


def _draw_lanes_kernel(key, site: int, sid, n: int, dev) -> torch.Tensor:
    ptr, word, k1, k2, _ = _key_args(key, dev)
    sid = _int_tensor("sid", sid, dev)
    if sid.dim() != 1:
        raise ValueError(f"threefry kernel: sid is [R], got {tuple(sid.shape)}")
    out = torch.empty((sid.shape[0], n), dtype=torch.float32, device=dev)
    lib, counts_ptr, stream = _launch(dev)
    _done("draw_lanes", lib.threefry_draw_lanes(
        ptr, word, k1, k2, operator.index(site) & _M, sid.data_ptr(),
        int(sid.dtype == torch.int64), sid.stride(0), sid.shape[0], n, out.data_ptr(),
        counts_ptr, stream))
    return out
