"""The port's PNG reader (``image_io.decode_png``) against PIL's
``convert("RGB")`` of the same bytes, on every colour type at every bit
depth the standard allows, interlaced (Adam7) and not: files written by
tests/_torch_png.py (PIL writes neither sub-byte grey nor interlaced
files), each row under a seeded filter type, at sizes where Adam7's
passes are empty or one pixel wide.

Tolerance: equal bit for bit (integer work).  PIL's conversions, quirks
included: grey of 1, 2 and 4 bits scaled to 0..255; 16-bit grey read as
I;16 and clipped at 255 by convert("RGB"); the other 16-bit kinds keep
their high byte; alpha and tRNS dropped.
"""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image as PILImage

from portrayer_tpu_torch import image_io

from _torch_png import DEPTHS, png_bytes, random_samples

KINDS = [(ctype, depth, interlace) for ctype, depths in DEPTHS.items() for depth in depths
         for interlace in (0, 1)]
SIZES = ((9, 13), (1, 1), (1, 7), (6, 1), (17, 3), (33, 40))


def _palette(depth, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (1 << min(depth, 8), 3))


def _pil(data):
    return np.asarray(PILImage.open(io.BytesIO(data)).convert("RGB"))


@pytest.mark.parametrize("ctype,depth,interlace", KINDS,
                         ids=[f"type{c}-{d}bit-{'adam7' if i else 'flat'}" for c, d, i in KINDS])
def test_png_kind_equals_pil(ctype, depth, interlace):
    for h, w in SIZES:
        s = random_samples(ctype, depth, h, w, seed=depth + h)
        data = png_bytes(s, depth, ctype, interlace, seed=h * w,
                         palette=_palette(depth) if ctype == 3 else None)
        got, ref = image_io.decode_png(data), _pil(data)
        assert got.dtype == np.uint8 and got.shape == (h, w, 3), (h, w)
        np.testing.assert_array_equal(got, ref, err_msg=f"{h}x{w}")


@pytest.mark.parametrize("ctype,depth,trns", [(3, 4, bytes([0, 128, 255])),
                                              (0, 8, struct.pack(">H", 7)),
                                              (0, 16, struct.pack(">H", 300)),
                                              (2, 16, struct.pack(">HHH", 1, 2, 3))])
def test_png_transparency_is_dropped(ctype, depth, trns):
    s = random_samples(ctype, depth, 12, 10, seed=3)
    data = png_bytes(s, depth, ctype, 1, palette=_palette(depth) if ctype == 3 else None,
                     trns=trns)
    np.testing.assert_array_equal(image_io.decode_png(data), _pil(data))


def test_png_read_image_by_content(tmp_path):
    """read_image takes an interlaced 16-bit RGBA file by its bytes."""
    s = random_samples(6, 16, 21, 19, seed=5)
    path = tmp_path / "texture.bin"
    path.write_bytes(png_bytes(s, 16, 6, 1))
    np.testing.assert_array_equal(image_io.read_image(path), (s[..., :3] >> 8).astype(np.uint8))


def _with_ihdr(data, **fields):
    """`data` with IHDR fields (depth, ctype, interlace) replaced."""
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB", data[16:29])
    vals = dict(dict(depth=depth, ctype=ctype, interlace=interlace), **fields)
    body = struct.pack(">IIBBBBB", w, h, vals["depth"], vals["ctype"], comp, filt,
                       vals["interlace"])
    crc = struct.pack(">I", zlib.crc32(b"IHDR" + body) & 0xFFFFFFFF)
    return data[:16] + body + crc + data[33:]


@pytest.mark.parametrize("fields", [dict(depth=16, ctype=3), dict(depth=4, ctype=2),
                                    dict(ctype=5), dict(interlace=2)])
def test_png_invalid_kinds_raise(fields):
    """Kinds the standard does not define raise, naming the kind (PIL
    refuses them too)."""
    data = _with_ihdr(image_io.encode_png(np.zeros((4, 4, 3), np.uint8)), **fields)
    with pytest.raises(ValueError, match="not a valid PNG kind"):
        image_io.decode_png(data)
    with pytest.raises(Exception):
        _pil(data)
