"""8-bit RGB PNG writer and a PNG reader on the standard library's zlib,
and a JPEG reader in numpy.

The writer stores every row with filter type 0.  The reader accepts every
colour type (greyscale, greyscale with alpha, RGB, RGBA, palette) at every
bit depth the standard allows (1, 2, 4, 8, 16), interlaced (Adam7) or
not, undoes all five filter types (None, Sub, Up, Average, Paeth), which
other encoders choose per row, and returns RGB as PIL's ``convert("RGB")``
does: grey replicated, the palette expanded, alpha dropped.
``decode_jpeg`` (below) gives the texels PIL gives a JPEG file;
``read_image`` reads either kind, told apart by the file's first bytes.
"""

from __future__ import annotations

import os
import re
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


# Channels per pixel of each colour type: grey, RGB, palette, grey +
# alpha, RGBA; and the bit depths the standard allows for each.
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7's passes: (x0, y0, dx, dy).
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """[h, stride] uint8: the rows of one (sub-)image, each a filter-type
    byte and `stride` filtered bytes, unfiltered; bpp is the bytes of a
    whole pixel (at least 1), the distance to the byte on the left."""
    raw = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:    # Sub: running sum along each byte of a pixel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:    # Up
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):   # Average / Paeth: sequential over pixels
            cur = np.zeros(stride, np.int32)
            left = np.zeros(bpp, np.int32)
            upleft = np.zeros(bpp, np.int32)
            for x in range(stride // bpp):
                sl = slice(x * bpp, (x + 1) * bpp)
                up = prev[sl]
                pred = (left + up) // 2 if ftype == 3 else _paeth(left, up, upleft)
                cur[sl] = (line[sl] + pred) & 0xFF
                left, upleft = cur[sl], up
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out.astype(np.uint8)


def _samples(rows: np.ndarray, w: int, c: int, depth: int) -> np.ndarray:
    """[h, w, c] int32 samples of unfiltered rows, MSB first."""
    h = rows.shape[0]
    n = w * c
    if depth == 8:
        return rows[:, :n].astype(np.int32).reshape(h, w, c)
    if depth == 16:
        x = rows[:, :2 * n].astype(np.int32)
        return ((x[:, 0::2] << 8) | x[:, 1::2]).reshape(h, w, c)
    bits = np.unpackbits(rows, axis=1)[:, :n * depth].reshape(h, n, depth).astype(np.int32)
    return (bits << np.arange(depth - 1, -1, -1, dtype=np.int32)).sum(axis=-1).reshape(h, w, c)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> [H,W,3] uint8 RGB, as PIL's convert("RGB") gives them:
    every colour type at every bit depth the standard allows, interlaced
    (Adam7) or not.  Grey of 1, 2 and 4 bits is scaled to 0..255 (x255,
    x85, x17), 16-bit grey clipped at 255 (PIL's I;16), the other 16-bit
    kinds keep their high byte; the palette is expanded; alpha is
    dropped."""
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
    if ctype not in _DEPTHS or depth not in _DEPTHS[ctype] or interlace not in (0, 1):
        raise ValueError(f"not a valid PNG kind (bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace})")
    if ctype == 3 and plte is None:
        raise ValueError("palette PNG without PLTE")
    c = _CHANNELS[ctype]
    bpp = max(1, c * depth // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = np.zeros((h, w, c), np.int32)
    at = 0
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        stride = -(-pw * c * depth // 8)
        rows = _unfilter(raw[at:at + ph * (stride + 1)], ph, stride, bpp)
        at += ph * (stride + 1)
        px[y0::dy, x0::dx] = _samples(rows, pw, c, depth)
    if ctype == 3:
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(plte)] = plte[:256]
        return pal[px[..., 0]]
    if depth == 16:
        px = np.minimum(px, 255) if ctype == 0 else px >> 8
    elif depth < 8:
        px = px * (255 // ((1 << depth) - 1))
    px = px.astype(np.uint8)
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def read_png(path) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


# ---------------------------------------------------------------------------
# JPEG: baseline, extended-sequential and progressive Huffman files, 8-bit,
# 1, 3 or 4 components, sampling factors up to 4 in either direction,
# restart markers.  The texels equal what PIL (libjpeg-turbo) gives for
# convert("RGB"): the integer "islow" IDCT (jidctint.c), fancy (triangle)
# chroma upsampling where libjpeg has it and box replication elsewhere
# (jdsample.c), libjpeg's fixed-point YCbCr -> RGB (jdcolor.c), and for
# four components libjpeg's CMYK or YCCK -> CMYK, then PIL's: Adobe's
# inverted samples (its "CMYK;I") and its CMYK -> RGB.  Only the Huffman
# walk runs per symbol; the rest is vectorised.
# ---------------------------------------------------------------------------

# _ZIGZAG[k]: the natural (row-major) index of the k-th coefficient of a
# block in zigzag order.
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

_SOF_KINDS = {
    0xC0: "baseline", 0xC1: "extended sequential", 0xC2: "progressive", 0xC3: "lossless",
    0xC5: "differential sequential", 0xC6: "differential progressive",
    0xC7: "differential lossless", 0xC9: "arithmetic-coded sequential",
    0xCA: "arithmetic-coded progressive", 0xCB: "arithmetic-coded lossless",
    0xCD: "arithmetic-coded differential sequential",
    0xCE: "arithmetic-coded differential progressive",
    0xCF: "arithmetic-coded differential lossless"}

# A marker that ends a scan's entropy-coded bytes (not a stuffed 0xFF00,
# not a restart marker RSTn), and a restart marker.
_MARKER = re.compile(rb"\xff[^\x00\xd0-\xd7]")
_RESTART = re.compile(rb"\xff[\xd0-\xd7]")

# jidctint.c's post-IDCT range limit: a descaled value v becomes
# _IDCT_LIMIT[v & 1023] (v + 128 clamped to 0..255 for |v| < 512).
_IDCT_LIMIT = np.concatenate([np.arange(128, 256), np.full(384, 255), np.zeros(384),
                              np.arange(0, 128)]).astype(np.uint8)


def _huffman_lut(bits, values) -> list:
    """A 65536-entry table over the next 16 bits of the stream: (code
    length << 8) | symbol, 0 for no code."""
    lut = np.zeros(1 << 16, np.int32)
    code, i = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            lo = code << (16 - length)
            lut[lo:lo + (1 << (16 - length))] = (length << 8) | values[i]
            code += 1
            i += 1
        code <<= 1
    return lut.tolist()


def _bit_windows(segment: bytes) -> list:
    """For each byte of an unstuffed entropy-coded segment, the 32 bits
    starting there (zeros past its end, as libjpeg pads)."""
    b = np.frombuffer(segment + bytes(8), np.uint8).astype(np.int64)
    return ((b[:-7] << 24) | (b[1:-6] << 16) | (b[2:-5] << 8) | b[3:-4]).tolist()


def _decode_segment(win, bases, slots, pred, n_mcus, idx, val, name):
    """Huffman-decode n_mcus MCUs of one restart interval.  bases[m]: the
    coefficient offset of each block of MCU m; slots: (component, DC table,
    AC table) of each block; pred: DC predictions per component.  Appends
    (offset + zigzag position, value) of every nonzero coefficient to idx,
    val."""
    p = 0
    push_i, push_v = idx.append, val.append
    for m in range(n_mcus):
        for base, (ci, dc, ac) in zip(bases[m], slots):
            e = dc[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
            if not e:
                raise ValueError(f"{name}: corrupt JPEG data (bad Huffman code)")
            p += e >> 8
            s = e & 255
            if s:
                v = (win[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
                p += s
                if v < 1 << (s - 1):
                    v -= (1 << s) - 1
                pred[ci] += v
            if pred[ci]:
                push_i(base)
                push_v(pred[ci])
            k = 1
            while k < 64:
                e = ac[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                if not e:
                    raise ValueError(f"{name}: corrupt JPEG data (bad Huffman code)")
                p += e >> 8
                s = e & 15
                if s:
                    k += (e >> 4) & 15
                    if k > 63:
                        raise ValueError(f"{name}: corrupt JPEG data (coefficient past 63)")
                    v = (win[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
                    p += s
                    if v < 1 << (s - 1):
                        v -= (1 << s) - 1
                    push_i(base + k)
                    push_v(v)
                    k += 1
                elif e & 0xF0 == 0xF0:
                    k += 16
                else:
                    break


def _receive(win, p, s):
    """The s-bit value at bit p of a segment, sign-extended as JPEG codes
    it (HUFF_EXTEND)."""
    v = (win[p >> 3] >> (32 - (p & 7) - s)) & ((1 << s) - 1)
    return v - (1 << s) + 1 if v < 1 << (s - 1) else v


def _decode_progressive(win, bases, slots, pred, n_mcus, coef, ss, se, ah, al, name):
    """Decode n_mcus MCUs of one restart interval of a progressive scan
    (jdphuff.c): the DC first and refining scans, the AC first scans with
    their EOB runs, and the AC refining scans, which correct the
    coefficients already nonzero and place new ones of magnitude 1 << al.
    coef: a list of every block's coefficients in zigzag order; bases,
    slots and pred as in _decode_segment."""
    p = 0
    bad = f"{name}: corrupt JPEG data (bad Huffman code)"
    if ss == 0:
        for m in range(n_mcus):
            for base, (ci, dc, _) in zip(bases[m], slots):
                if ah:      # refining: one bit of every DC coefficient
                    if (win[p >> 3] >> (31 - (p & 7))) & 1:
                        coef[base] |= 1 << al
                    p += 1
                    continue
                e = dc[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                if not e:
                    raise ValueError(bad)
                p += e >> 8
                s = e & 255
                if s:
                    pred[ci] += _receive(win, p, s)
                    p += s
                coef[base] = pred[ci] << al
        return
    ac = slots[0][2]
    if ac is None:
        raise ValueError(f"{name}: AC scan without its Huffman table")
    eobrun = 0
    if not ah:
        for m in range(n_mcus):
            if eobrun:
                eobrun -= 1
                continue
            base, k = bases[m][0], ss
            while k <= se:
                e = ac[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                if not e:
                    raise ValueError(bad)
                p += e >> 8
                r, s = (e >> 4) & 15, e & 15
                if s:
                    k += r
                    if k > 63:
                        raise ValueError(f"{name}: corrupt JPEG data (coefficient past 63)")
                    coef[base + k] = _receive(win, p, s) << al
                    p += s
                    k += 1
                elif r == 15:
                    k += 16
                else:
                    eobrun = 1 << r
                    if r:
                        eobrun += (win[p >> 3] >> (32 - (p & 7) - r)) & ((1 << r) - 1)
                        p += r
                    eobrun -= 1
                    break
        return
    p1, m1 = 1 << al, -1 << al
    for m in range(n_mcus):
        base, k = bases[m][0], ss
        if not eobrun:
            while k <= se:
                e = ac[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                if not e:
                    raise ValueError(bad)
                p += e >> 8
                r, s = (e >> 4) & 15, e & 15
                if s:   # a new coefficient of magnitude p1, its sign a bit
                    s = p1 if (win[p >> 3] >> (31 - (p & 7))) & 1 else m1
                    p += 1
                elif r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += (win[p >> 3] >> (32 - (p & 7) - r)) & ((1 << r) - 1)
                        p += r
                    break
                # Correct the nonzero coefficients on the way to the r-th
                # zero one (ZRL: 16 zeros), where s goes.
                while k <= se:
                    c = coef[base + k]
                    if c:
                        if (win[p >> 3] >> (31 - (p & 7))) & 1 and not c & p1:
                            coef[base + k] = c + (p1 if c >= 0 else m1)
                        p += 1
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                if s and k <= 63:
                    coef[base + k] = s
                k += 1
        if eobrun:
            while k <= se:
                c = coef[base + k]
                if c:
                    if (win[p >> 3] >> (31 - (p & 7))) & 1 and not c & p1:
                        coef[base + k] = c + (p1 if c >= 0 else m1)
                    p += 1
                k += 1
            eobrun -= 1


def _idct_1d(x, shift):
    """jidctint.c's 8-point islow pass on x[0..7] (arrays, int64),
    descaled by `shift` bits."""
    z1 = (x[2] + x[6]) * 4433
    tmp2 = z1 - x[6] * 15137
    tmp3 = z1 + x[2] * 6270
    tmp0 = (x[0] + x[4]) << 13
    tmp1 = (x[0] - x[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * 9633
    z1, z2 = z1 * -7373, z2 * -20995
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
    t0 = t0 * 2446 + z1 + z3
    t1 = t1 * 16819 + z2 + z4
    t2 = t2 * 25172 + z2 + z3
    t3 = t3 * 12299 + z1 + z4
    r = 1 << (shift - 1)
    return [(tmp10 + t3 + r) >> shift, (tmp11 + t2 + r) >> shift,
            (tmp12 + t1 + r) >> shift, (tmp13 + t0 + r) >> shift,
            (tmp13 - t0 + r) >> shift, (tmp12 - t1 + r) >> shift,
            (tmp11 - t2 + r) >> shift, (tmp10 - t3 + r) >> shift]


def _idct_islow(coef: np.ndarray) -> np.ndarray:
    """[N, 8, 8] dequantised coefficients (rows: vertical frequency) ->
    [N, 8, 8] uint8 samples, jidctint.c's jpeg_idct_islow: columns first
    (descale by CONST_BITS - PASS1_BITS), then rows (CONST_BITS +
    PASS1_BITS + 3), then the range limit."""
    c = coef.astype(np.int64)
    ws = np.stack(_idct_1d([c[:, k, :] for k in range(8)], 11), axis=1)
    out = np.stack(_idct_1d([ws[:, :, k] for k in range(8)], 18), axis=2)
    return _IDCT_LIMIT[out & 1023]


def _upsample(plane: np.ndarray, hr: int, vr: int) -> np.ndarray:
    """jdsample.c: a component's [h, w] samples to hr x vr times the size.
    Fancy (triangle) upsampling for 2x1 and 2x2 (components wider than 2
    samples) and 1x2; box replication otherwise.  Edges are replicated,
    as libjpeg's context rows are."""
    x = plane.astype(np.int32)
    h, w = x.shape
    if (hr, vr) == (1, 1):
        return plane
    fancy_h = hr == 2 and w > 2
    if (hr, vr) == (1, 2) or (fancy_h and vr in (1, 2)):
        if vr == 2:
            up = np.concatenate([x[:1], x[:-1]])
            down = np.concatenate([x[1:], x[-1:]])
            if hr == 1:   # h1v2: (3 * near + far + 1 or 2) >> 2
                out = np.empty((2 * h, w), np.int32)
                out[0::2] = (3 * x + up + 1) >> 2
                out[1::2] = (3 * x + down + 2) >> 2
                return out.astype(np.uint8)
            rows = [3 * x + up, 3 * x + down]   # column sums of h2v2
            biases = (8, 7)
            out = np.empty((2 * h, 2 * w), np.int32)
            for v, cs in enumerate(rows):
                left = np.concatenate([cs[:, :1], cs[:, :-1]], axis=1)
                right = np.concatenate([cs[:, 1:], cs[:, -1:]], axis=1)
                out[v::2, 0::2] = (3 * cs + left + biases[0]) >> 4
                out[v::2, 1::2] = (3 * cs + right + biases[1]) >> 4
            return out.astype(np.uint8)
        left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
        right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
        out = np.empty((h, 2 * w), np.int32)
        out[:, 0::2] = (3 * x + left + 1) >> 2
        out[:, 1::2] = (3 * x + right + 2) >> 2
        return out.astype(np.uint8)
    return np.repeat(np.repeat(plane, vr, axis=0), hr, axis=1)


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert: 16-bit fixed point, rounded tables."""
    y = y.astype(np.int64)
    cb = cb.astype(np.int64) - 128
    cr = cr.astype(np.int64) - 128
    r = y + ((91881 * cr + 32768) >> 16)
    g = y + ((-22554 * cb + 32768 - 46802 * cr) >> 16)
    b = y + ((116130 * cb + 32768) >> 16)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def _cmyk_to_rgb(c, m, y, k) -> np.ndarray:
    """PIL's convert("RGB") of CMYK samples (its cmyk2rgb):
    (255 - k) - c (255 - k) / 255 per channel, rounded as its MULDIV255."""
    nk = 255 - k.astype(np.int64)

    def one(x):
        t = x.astype(np.int64) * nk + 128
        return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255)

    return np.stack([one(c), one(m), one(y)], axis=-1).astype(np.uint8)


def decode_jpeg(data: bytes, name: str = "JPEG data") -> np.ndarray:
    """JPEG bytes -> [H,W,3] uint8 RGB, as PIL's convert("RGB") decodes
    them.  Lossless, hierarchical, arithmetic-coded and 12-bit files
    raise ValueError naming `name` and the SOF marker."""
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: not a JPEG file")
    qt, dht, comps = {}, {}, None
    restart, adobe, jfif = 0, None, False
    coef, progressive = None, False
    pos = 2
    while True:
        while pos < len(data) and data[pos] != 0xFF:
            pos += 1
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            raise ValueError(f"{name}: JPEG ends before its EOI marker")
        marker = data[pos]
        pos += 1
        if marker == 0xD9:   # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        (n,) = struct.unpack(">H", data[pos:pos + 2])
        seg = data[pos + 2:pos + n]
        pos += n
        if marker in _SOF_KINDS:
            if marker not in (0xC0, 0xC1, 0xC2):
                raise ValueError(f"{name}: SOF{marker - 0xC0} ({_SOF_KINDS[marker]}) JPEGs "
                                 "are not read; only baseline, extended-sequential and "
                                 "progressive Huffman files are")
            progressive = marker == 0xC2
            prec, height, width, nc = struct.unpack(">BHHB", seg[:6])
            if prec != 8:
                raise ValueError(f"{name}: SOF{marker - 0xC0} with {prec}-bit samples; "
                                 "only 8-bit JPEGs are read")
            if nc not in (1, 3, 4):
                raise ValueError(f"{name}: {nc} components; only 1, 3 and 4 are read")
            comps = []
            for i in range(nc):
                cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
                hs, vs = hv >> 4, hv & 15
                if not (1 <= hs <= 4 and 1 <= vs <= 4):
                    raise ValueError(f"{name}: sampling factors {hs}x{vs}; up to 4x4 are read")
                comps.append({"id": cid, "h": hs, "v": vs, "tq": tq, "q": None})
            hmax = max(c["h"] for c in comps)
            vmax = max(c["v"] for c in comps)
            if any(hmax % c["h"] or vmax % c["v"] for c in comps):
                raise ValueError(f"{name}: fractional sampling ratios "
                                 f"{[(c['h'], c['v']) for c in comps]} (libjpeg refuses them)")
            mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
            off = 0
            for c in comps:
                c["bw"], c["bh"] = mcux * c["h"], mcuy * c["v"]
                c["off"] = off
                off += c["bw"] * c["bh"]
            coef = [0] * (off * 64) if progressive else np.zeros(off * 64, np.int32)
        elif marker == 0xC4:   # DHT
            i = 0
            while i < len(seg):
                tc_th = seg[i]
                bits = list(seg[i + 1:i + 17])
                values = list(seg[i + 17:i + 17 + sum(bits)])
                dht[(tc_th >> 4, tc_th & 15)] = _huffman_lut(bits, values)
                i += 17 + sum(bits)
        elif marker == 0xDB:   # DQT
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                if pq:
                    vals = np.frombuffer(seg[i + 1:i + 129], ">u2").astype(np.int64)
                    i += 129
                else:
                    vals = np.frombuffer(seg[i + 1:i + 65], np.uint8).astype(np.int64)
                    i += 65
                table = np.zeros(64, np.int64)
                table[_ZIGZAG] = vals
                qt[tq] = table
        elif marker == 0xDD:   # DRI
            (restart,) = struct.unpack(">H", seg[:2])
        elif marker == 0xE0 and seg[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]
        elif marker == 0xDA:   # SOS
            if comps is None:
                raise ValueError(f"{name}: scan before the frame header")
            ns = seg[0]
            scan = []
            for i in range(ns):
                cid, tables = seg[1 + 2 * i], seg[2 + 2 * i]
                c = next(c for c in comps if c["id"] == cid)
                if c["q"] is None:
                    c["q"] = qt[c["tq"]]
                scan.append((comps.index(c), dht.get((0, tables >> 4)),
                             dht.get((1, tables & 15))))
            ss, se, ahal = seg[1 + 2 * ns:4 + 2 * ns]
            end = _MARKER.search(data, pos)
            end = end.start() if end else len(data)
            _decode_scan(data[pos:end], scan, comps, width, height, restart, coef, name,
                         (ss, se, ahal >> 4, ahal & 15) if progressive else None)
            pos = end
    if coef is None:
        raise ValueError(f"{name}: JPEG without a frame header")
    return _reconstruct(np.asarray(coef, np.int32), comps, width, height, adobe, jfif)


def _decode_scan(entropy, scan, comps, width, height, restart, coef, name, spectral=None):
    """Huffman-decode one scan's entropy-coded bytes into `coef` (zigzag
    order per block, all components one after the other); a progressive
    scan's (Ss, Se, Ah, Al) in `spectral`, its coef a list."""
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    if len(scan) == 1:   # non-interleaved: one block an MCU, the component's own grid
        ci = scan[0][0]
        c = comps[ci]
        bw = -(-(-(-width * c["h"] // hmax)) // 8)
        bh = -(-(-(-height * c["v"] // vmax)) // 8)
        by, bx = np.mgrid[0:bh, 0:bw]
        blocks = (c["off"] + by * c["bw"] + bx).reshape(-1, 1)
    else:
        mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
        my, mx = np.mgrid[0:mcuy, 0:mcux]
        my, mx = my.reshape(-1, 1), mx.reshape(-1, 1)
        cols = []
        for ci, _, _ in scan:
            c = comps[ci]
            for v in range(c["v"]):
                for h in range(c["h"]):
                    cols.append(c["off"] + (my * c["v"] + v) * c["bw"] + mx * c["h"] + h)
        blocks = np.concatenate(cols, axis=1)
    bases = (blocks * 64).tolist()
    slots = [s for s in scan for _ in range(comps[s[0]]["h"] * comps[s[0]]["v"])] \
        if len(scan) > 1 else list(scan)
    n_mcus = len(bases)
    per = restart or n_mcus
    segments = _RESTART.split(entropy)
    idx, val = [], []
    for i, start in enumerate(range(0, n_mcus, per)):
        if i >= len(segments):
            raise ValueError(f"{name}: JPEG scan ends before its last restart interval")
        pred = [0] * len(comps)
        win = _bit_windows(segments[i].replace(b"\xff\x00", b"\xff"))
        if spectral is not None:
            _decode_progressive(win, bases[start:start + per], slots, pred,
                                min(per, n_mcus - start), coef, *spectral, name)
        else:
            _decode_segment(win, bases[start:start + per], slots, pred,
                            min(per, n_mcus - start), idx, val, name)
    if spectral is None:
        coef[np.asarray(idx, np.int64)] = np.asarray(val, np.int32)


def _reconstruct(coef, comps, width, height, adobe, jfif):
    """Dequantise, IDCT, upsample and convert the decoded coefficients."""
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    planes = []
    for c in comps:
        n = c["bw"] * c["bh"]
        zz = coef[c["off"] * 64:(c["off"] + n) * 64].reshape(n, 64).astype(np.int64)
        nat = np.empty_like(zz)
        nat[:, _ZIGZAG] = zz * c["q"][_ZIGZAG]
        px = _idct_islow(nat.reshape(n, 8, 8))
        plane = px.reshape(c["bh"], c["bw"], 8, 8).transpose(0, 2, 1, 3).reshape(
            c["bh"] * 8, c["bw"] * 8)
        dh, dw = -(-height * c["v"] // vmax), -(-width * c["h"] // hmax)
        up = _upsample(plane[:dh, :dw], hmax // c["h"], vmax // c["v"])
        planes.append(up[:height, :width])
    if len(planes) == 1:
        return np.repeat(planes[0][..., None], 3, axis=-1)
    if len(planes) == 4:
        # libjpeg: an Adobe marker's transform 0 is CMYK, any other YCCK
        # (whose YCC part it turns to 255 - RGB); no marker, CMYK.  PIL
        # reads the CMYK inverted, as Adobe writes it.
        if adobe is not None and adobe != 0:
            cmy = 255 - _ycc_to_rgb(*planes[:3]).astype(np.int64)
        else:
            cmy = np.stack(planes[:3], axis=-1).astype(np.int64)
        return _cmyk_to_rgb(*(255 - cmy[..., i] for i in range(3)),
                            255 - planes[3].astype(np.int64))
    # libjpeg's guess of the colour space (jdapimin.c default_decompress_parms).
    ids = tuple(c["id"] for c in comps)
    rgb = (not jfif and adobe == 0) or (not jfif and adobe is None and ids == (82, 71, 66))
    if rgb:
        return np.stack(planes, axis=-1)
    return _ycc_to_rgb(*planes)


def read_jpeg(path) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), os.fspath(path))


def read_image(path) -> np.ndarray:
    """[H,W,3] uint8 RGB of a PNG or JPEG file, told apart by its first
    bytes (as PIL does), not by its name."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == _SIG:
        return decode_png(data)
    if data[:2] == b"\xff\xd8":
        return decode_jpeg(data, os.fspath(path))
    raise ValueError(f"{path}: neither a PNG nor a JPEG file")
