"""8-bit RGB PNG writer and reader on the standard library's zlib, and a
baseline JPEG reader in numpy.

The writer stores every row with filter type 0.  The reader accepts
non-interlaced 8-bit greyscale, greyscale with alpha, RGB, RGBA and
palette PNGs, undoes all five filter types (None, Sub, Up, Average,
Paeth), which other encoders choose per row, and returns RGB as PIL's
``convert("RGB")`` does: grey replicated, the palette expanded, alpha
dropped.  Other bit depths and interlaced files raise ``ValueError``.
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


# ---------------------------------------------------------------------------
# JPEG: baseline and extended-sequential Huffman files, 8-bit, 1 or 3
# components, sampling factors up to 2x2, restart markers.  The texels equal
# what PIL (libjpeg-turbo) gives for convert("RGB"): the integer "islow"
# IDCT (jidctint.c), fancy (triangle) chroma upsampling (jdsample.c) and
# libjpeg's fixed-point YCbCr -> RGB (jdcolor.c).  Only the Huffman walk
# runs per symbol; the rest is vectorised.
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


def decode_jpeg(data: bytes, name: str = "JPEG data") -> np.ndarray:
    """JPEG bytes -> [H,W,3] uint8 RGB, as PIL's convert("RGB") decodes
    them.  Progressive, lossless, hierarchical, arithmetic-coded and
    12-bit files raise ValueError naming `name` and the SOF marker."""
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: not a JPEG file")
    qt, dht, comps = {}, {}, None
    restart, adobe, jfif = 0, None, False
    coef = None
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
            if marker not in (0xC0, 0xC1):
                raise ValueError(f"{name}: SOF{marker - 0xC0} ({_SOF_KINDS[marker]}) JPEGs "
                                 "are not read; only baseline and extended-sequential "
                                 "Huffman files are")
            prec, height, width, nc = struct.unpack(">BHHB", seg[:6])
            if prec != 8:
                raise ValueError(f"{name}: SOF{marker - 0xC0} with {prec}-bit samples; "
                                 "only 8-bit JPEGs are read")
            if nc not in (1, 3):
                raise ValueError(f"{name}: {nc} components; only 1 and 3 are read")
            comps = []
            for i in range(nc):
                cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
                hs, vs = hv >> 4, hv & 15
                if not (1 <= hs <= 2 and 1 <= vs <= 2):
                    raise ValueError(f"{name}: sampling factors {hs}x{vs}; up to 2x2 are read")
                comps.append({"id": cid, "h": hs, "v": vs, "tq": tq, "q": None})
            hmax = max(c["h"] for c in comps)
            vmax = max(c["v"] for c in comps)
            mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
            off = 0
            for c in comps:
                c["bw"], c["bh"] = mcux * c["h"], mcuy * c["v"]
                c["off"] = off
                off += c["bw"] * c["bh"]
            coef = np.zeros(off * 64, np.int32)
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
                scan.append((comps.index(c), dht[(0, tables >> 4)], dht[(1, tables & 15)]))
            end = _MARKER.search(data, pos)
            end = end.start() if end else len(data)
            _decode_scan(data[pos:end], scan, comps, width, height, restart, coef, name)
            pos = end
    if coef is None:
        raise ValueError(f"{name}: JPEG without a frame header")
    return _reconstruct(coef, comps, width, height, adobe, jfif)


def _decode_scan(entropy, scan, comps, width, height, restart, coef, name):
    """Huffman-decode one scan's entropy-coded bytes into `coef` (zigzag
    order per block, all components one after the other)."""
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
        _decode_segment(win, bases[start:start + per], slots, pred,
                        min(per, n_mcus - start), idx, val, name)
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
