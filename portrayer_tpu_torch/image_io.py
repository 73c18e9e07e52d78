"""8-bit RGB PNG writer and reader on the standard library's zlib.

The writer stores every row with filter type 0.  The reader accepts
non-interlaced 8-bit greyscale, greyscale with alpha, RGB, RGBA and
palette PNGs, undoes all five filter types (None, Sub, Up, Average,
Paeth), which other encoders choose per row, and returns RGB as PIL's
``convert("RGB")`` does: grey replicated, the palette expanded, alpha
dropped.  Other bit depths and interlaced files raise ``ValueError``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray) -> bytes:
    """[H,W,3] uint8 -> PNG bytes."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected [H,W,3] uint8, got {rgb.shape}")
    h, w = rgb.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path, rgb: np.ndarray):
    with open(path, "wb") as f:
        f.write(encode_png(rgb))
    return path


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


# Channels per pixel of each 8-bit colour type: grey, RGB, palette,
# grey + alpha, RGBA.
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes (8-bit, not interlaced) -> [H,W,3] uint8 RGB."""
    if data[:8] != _SIG:
        raise ValueError("not a PNG file")
    pos, idat, hdr, plte = 8, [], None, None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or interlace != 0 or ctype not in _CHANNELS:
        raise ValueError(f"only 8-bit non-interlaced PNGs are read, got {hdr}")
    if ctype == 3 and plte is None:
        raise ValueError("palette PNG without PLTE")
    bpp = _CHANNELS[ctype]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:    # Sub: running sum along each channel
            cur = np.cumsum(line.reshape(w, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:    # Up
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):   # Average / Paeth: sequential over pixels
            cur = np.zeros(stride, np.int32)
            left = np.zeros(bpp, np.int32)
            upleft = np.zeros(bpp, np.int32)
            for x in range(w):
                s = slice(x * bpp, (x + 1) * bpp)
                up = prev[s]
                pred = (left + up) // 2 if ftype == 3 else _paeth(left, up, upleft)
                cur[s] = (line[s] + pred) & 0xFF
                left, upleft = cur[s], up
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    px = out.astype(np.uint8).reshape(h, w, bpp)
    if ctype == 3:
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(plte)] = plte[:256]
        return pal[px[..., 0]]
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def read_png(path) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())
