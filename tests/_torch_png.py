"""A PNG writer for tests: any bit depth and colour type, Adam7 interlace,
each row under a seeded filter type, the image data split over two IDAT
chunks.  PIL writes none of the sub-byte grey depths nor interlaced
files, and the port's reader is held against PIL's decode of the same
bytes, so the files are written here."""

import struct
import zlib

import numpy as np

# Adam7's passes: (x0, y0, dx, dy).
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# The bit depths the standard allows for each colour type.
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _pack_rows(sub: np.ndarray, depth: int) -> np.ndarray:
    """[h, w, c] samples -> [h, row bytes] uint8, MSB first."""
    h = sub.shape[0]
    flat = sub.reshape(h, -1).astype(np.int64)
    if depth == 16:
        return np.stack([flat >> 8, flat & 255], axis=-1).reshape(h, -1).astype(np.uint8)
    if depth == 8:
        return flat.astype(np.uint8)
    bits = ((flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1).reshape(h, -1)
    return np.packbits(bits.astype(np.uint8), axis=1)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filtered(row, prev, ftype: int, bpp: int) -> bytes:
    x, up = row.astype(np.int64), prev.astype(np.int64)
    left = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
    pred = {0: 0, 1: left, 2: up, 3: (left + up) // 2, 4: _paeth(left, up, upleft)}[ftype]
    return bytes([ftype]) + ((x - pred) & 255).astype(np.uint8).tobytes()


def png_bytes(samples: np.ndarray, depth: int, ctype: int, interlace: int = 0, palette=None,
              trns: bytes = None, seed: int = 0) -> bytes:
    """PNG bytes of `samples` [h, w, channels] (ints below 2**depth): the
    rows' filter types drawn from a generator seeded `seed`."""
    h, w, c = samples.shape
    assert c == CHANNELS[ctype] and depth in DEPTHS[ctype]
    bpp = max(1, c * depth // 8)
    rng = np.random.default_rng(seed)
    raw = bytearray()
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = _pack_rows(sub, depth)
        prev = np.zeros(rows.shape[1], np.uint8)
        for row in rows:
            raw += _filtered(row, prev, int(rng.integers(0, 5)), bpp)
            prev = row
    z = zlib.compress(bytes(raw), 6)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                                                  0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    half = len(z) // 2
    return out + _chunk(b"IDAT", z[:half]) + _chunk(b"IDAT", z[half:]) + _chunk(b"IEND", b"")


def random_samples(ctype: int, depth: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    """Seeded samples of every value a depth holds, both extremes included."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 1 << depth, (h, w, CHANNELS[ctype]), dtype=np.int64)
    s.reshape(-1)[:2] = (0, (1 << depth) - 1)[:s.size]
    return s
