"""The port's JPEG reader (portrayer_tpu_torch.image_io.decode_jpeg /
read_jpeg / read_image) against PIL's decode, which the JAX package's
textures read through (portrayer_tpu/scene/texture.py).

Tolerance: none.  Every case decodes to PIL's convert("RGB") bit for bit:
the reader reproduces libjpeg's integer IDCT, fancy upsampling and
fixed-point colour conversion.
"""

import io
import os
import struct
import time

import numpy as np
import pytest
from PIL import Image as PILImage

from portrayer_tpu_torch import image_io

from _torch_assets import JPEG_FIXTURES

# Sizes not multiples of 16; at 4:2:0 and 4:2:2 the chroma of the last
# two is 2 and 5 samples wide (box and fancy upsampling), of (1, 1) 1.
SIZES = [(37, 23), (70, 45), (1, 1), (4, 3), (9, 2)]
SUBSAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2, "grey": None}


def _image(w, h, seed, grey=False):
    """A seeded image with smooth gradients and noise: many nonzero AC
    coefficients at every quality."""
    g = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(xx / 7.0 + c) * np.cos(yy / 5.0 - c) for c in range(3)],
                    axis=-1)
    img = PILImage.fromarray(np.clip(base + g.normal(0.0, 30.0, (h, w, 3)), 0, 255)
                             .astype(np.uint8))
    return img.convert("L") if grey else img


def _encode(img, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(PILImage.open(io.BytesIO(data)).convert("RGB"))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sub", list(SUBSAMPLING))
@pytest.mark.parametrize("quality", [30, 75, 95])
def test_decode_equals_pil(quality, sub, size):
    w, h = size
    grey = sub == "grey"
    kw = dict(quality=quality) if grey else dict(quality=quality, subsampling=SUBSAMPLING[sub])
    data = _encode(_image(w, h, seed=w * h + quality, grey=grey), **kw)
    got = image_io.decode_jpeg(data)
    assert got.dtype == np.uint8 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, _pil(data))


@pytest.mark.parametrize("kw", [dict(subsampling=2, restart_marker_blocks=3),
                                dict(subsampling=1, restart_marker_rows=1),
                                dict(subsampling=0, optimize=True)],
                         ids=["restart-blocks", "restart-rows", "optimized-huffman"])
def test_restart_markers_and_optimized_tables(kw):
    data = _encode(_image(100, 70, seed=1), quality=80, **kw)
    if "optimize" not in kw:
        assert b"\xff\xdd" in data and b"\xff\xd0" in data   # DRI and RST0 present
    np.testing.assert_array_equal(image_io.decode_jpeg(data), _pil(data))


def _as_sampling_1x2(data: bytes, width: int, height: int) -> bytes:
    """A 4:2:2 file (luma sampled 2x1) made 4:4:0 (luma 1x2), which PIL
    does not write: its MCUs hold the same blocks, so with a frame of
    `width` x `height` that has as many MCUs it is a valid file (of
    another picture), which libjpeg upsamples with its 1x2 rule."""
    i = data.index(b"\xff\xc0")
    sof = bytearray(data[i:i + 19])
    assert sof[11] == 0x21, sof.hex()
    struct.pack_into(">HH", sof, 5, height, width)
    sof[11] = 0x12
    return data[:i] + bytes(sof) + data[i + 19:]


@pytest.mark.parametrize("quality", [30, 95])
@pytest.mark.parametrize("size, size_1x2", [((40, 20), (21, 37)), ((48, 24), (17, 33)),
                                            ((16, 8), (1, 9))],
                         ids=["21x37", "17x33", "1x9"])
def test_1x2_sampling_equals_pil(quality, size, size_1x2):
    data = _as_sampling_1x2(_encode(_image(*size, seed=size[0] + quality), quality=quality,
                                    subsampling=1), *size_1x2)
    got = image_io.decode_jpeg(data)
    assert got.shape == (size_1x2[1], size_1x2[0], 3)
    np.testing.assert_array_equal(got, _pil(data))


def test_extended_sequential_and_wider_sampling():
    """A baseline file marked SOF1 (extended sequential, which it also
    is) reads as PIL reads it; so does 4:1:1 (luma sampled 4x1: the 4:2:0
    file's MCUs hold the same six blocks, and at 37x23 there are as many
    of them), whose chroma libjpeg replicates 4x (its generic int_upsample)."""
    base = _encode(_image(37, 23, seed=6), quality=75, subsampling=2)
    sof1 = _with_sof(base, 0xC1)
    np.testing.assert_array_equal(image_io.decode_jpeg(sof1), _pil(sof1))
    i = base.index(b"\xff\xc0") + 11   # luma's sampling factors, 2x2 here
    assert base[i] == 0x22
    wide = base[:i] + b"\x41" + base[i + 1:]
    got = image_io.decode_jpeg(wide)
    assert got.shape == (23, 37, 3)
    np.testing.assert_array_equal(got, _pil(wide))


@pytest.mark.parametrize("quality", [30, 95])
@pytest.mark.parametrize("hv, size", [(0x14, (16, 70)), (0x41, (64, 10)), (0x14, (9, 90))],
                         ids=["1x4-16x70", "4x1-64x10", "1x4-9x90"])
def test_sampling_up_to_4_equals_pil(quality, hv, size):
    """A 4:2:0 file's luma made 1x4 or 4x1 (six blocks an MCU either way),
    with a frame of as many MCUs: the chroma replicated 4x in one
    direction, as libjpeg does for every integral ratio but 2."""
    w, h = size
    data = _encode(_image(37, 23, seed=quality), quality=quality, subsampling=2)
    i = data.index(b"\xff\xc0")
    sof = bytearray(data[i:i + 19])
    struct.pack_into(">HH", sof, 5, h, w)
    sof[11] = hv
    data = data[:i] + bytes(sof) + data[i + 19:]
    got = image_io.decode_jpeg(data)
    assert got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, _pil(data))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sub", list(SUBSAMPLING))
@pytest.mark.parametrize("quality", [30, 75, 95])
def test_progressive_equals_pil(quality, sub, size):
    """Progressive files (SOF2) as PIL writes them: libjpeg's default
    script of spectral selection and successive approximation, DC and AC,
    first and refining scans, EOB runs."""
    w, h = size
    grey = sub == "grey"
    kw = dict(quality=quality, progressive=True)
    if not grey:
        kw["subsampling"] = SUBSAMPLING[sub]
    data = _encode(_image(w, h, seed=w * h + quality, grey=grey), **kw)
    assert b"\xff\xc2" in data
    got = image_io.decode_jpeg(data)
    assert got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, _pil(data))


@pytest.mark.parametrize("kw", [dict(subsampling=2, restart_marker_blocks=3),
                                dict(subsampling=1, restart_marker_rows=1),
                                dict(subsampling=0, restart_marker_blocks=1),
                                dict(subsampling=2, optimize=True)],
                         ids=["420-restart-blocks", "422-restart-rows", "444-restart-every-block",
                              "optimized-huffman"])
def test_progressive_restart_markers(kw):
    data = _encode(_image(100, 70, seed=1), quality=80, progressive=True, **kw)
    if "optimize" not in kw:
        assert b"\xff\xdd" in data and b"\xff\xd0" in data
    np.testing.assert_array_equal(image_io.decode_jpeg(data), _pil(data))


def _cmyk_image(w, h, seed):
    g = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(xx / 7.0 + c) * np.cos(yy / 5.0 - c) for c in range(4)],
                    axis=-1)
    return PILImage.fromarray(np.clip(base + g.normal(0.0, 30.0, (h, w, 4)), 0, 255)
                              .astype(np.uint8), "CMYK")


def _adobe_transform(data: bytes, transform) -> bytes:
    """`data` with its Adobe (APP14) marker's colour transform set, or the
    marker removed (transform None)."""
    i = data.index(b"\xff\xee")
    assert data[i + 4:i + 9] == b"Adobe"
    if transform is None:
        (n,) = struct.unpack(">H", data[i + 2:i + 4])
        return data[:i] + data[i + 2 + n:]
    return data[:i + 15] + bytes([transform]) + data[i + 16:]


@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
@pytest.mark.parametrize("transform", [0, 2, 1, None], ids=["cmyk", "ycck", "transform1",
                                                           "no-adobe"])
@pytest.mark.parametrize("quality", [50, 95])
def test_four_components_equal_pil(quality, transform, progressive):
    """Four-component files: PIL writes CMYK with an Adobe marker of
    transform 0, its samples inverted as Photoshop writes them; with the
    transform set to 2 (or any but 0) libjpeg reads the same bytes as
    YCCK, without the marker as CMYK.  PIL reads them inverted and
    converts them with its own CMYK -> RGB."""
    data = _encode(_cmyk_image(37, 23, seed=quality), quality=quality, progressive=progressive)
    if transform != 0:
        data = _adobe_transform(data, transform)
    np.testing.assert_array_equal(image_io.decode_jpeg(data), _pil(data))


@pytest.mark.parametrize("name", ["colour_420.jpg", "normal_444.jpg", "grey.jpg"])
def test_fixtures_read_as_pil_reads_them(name):
    path = os.path.join(JPEG_FIXTURES, name)
    np.testing.assert_array_equal(image_io.read_jpeg(path), np.asarray(
        PILImage.open(path).convert("RGB")))


def _with_sof(data: bytes, marker: int, precision: int = 8) -> bytes:
    i = data.index(b"\xff\xc0")
    return data[:i + 1] + bytes([marker]) + data[i + 2:i + 4] + bytes([precision]) + data[i + 5:]


@pytest.mark.parametrize("marker, kind", [(0xC2, "SOF2 \\(progressive\\)"),
                                          (0xC3, "SOF3 \\(lossless\\)"),
                                          (0xC9, "SOF9 \\(arithmetic-coded sequential\\)"),
                                          (0xCA, "SOF10 \\(arithmetic-coded progressive\\)")])
def test_other_kinds_raise_naming_the_file_and_marker(tmp_path, marker, kind):
    """Lossless and arithmetic-coded files raise, naming the file and the
    marker (PIL writes neither kind, so no such file is held against its
    decode); a progressive file (SOF2), once refused, reads as PIL reads
    it.  12-bit samples, which PIL refuses, raise."""
    base = _encode(_image(16, 16, seed=2), quality=75)
    data = (_encode(_image(16, 16, seed=2), quality=75, progressive=True) if marker == 0xC2
            else _with_sof(base, marker))
    path = tmp_path / "odd.jpg"
    path.write_bytes(data)
    if marker == 0xC2:
        np.testing.assert_array_equal(image_io.read_jpeg(path), _pil(data))
        np.testing.assert_array_equal(image_io.read_image(path), _pil(data))
    else:
        with pytest.raises(ValueError, match=f"odd.jpg: {kind}"):
            image_io.read_jpeg(path)
        with pytest.raises(ValueError, match=f"odd.jpg: {kind}"):
            image_io.read_image(path)
    path.write_bytes(_with_sof(base, 0xC1, precision=12))
    with pytest.raises(ValueError, match="odd.jpg: SOF1 with 12-bit samples"):
        image_io.read_image(path)


def test_a_cut_file_raises_as_pil_does():
    """PIL refuses a file cut before its EOI marker (a truncated image);
    so does the reader."""
    data = _encode(_image(37, 23, seed=7), quality=75, subsampling=2)
    assert data.endswith(b"\xff\xd9")
    for cut in (data[:-2], data[:data.index(b"\xff\xda")]):
        with pytest.raises(OSError):
            _pil(cut)
        with pytest.raises(ValueError, match="ends before its EOI marker"):
            image_io.decode_jpeg(cut)


def test_read_image_goes_by_content_not_name(tmp_path):
    rgb = np.random.default_rng(3).integers(0, 256, (5, 7, 3), dtype=np.uint8)
    (tmp_path / "png.jpg").write_bytes(image_io.encode_png(rgb))
    np.testing.assert_array_equal(image_io.read_image(tmp_path / "png.jpg"), rgb)
    data = _encode(_image(20, 12, seed=4), quality=90)
    (tmp_path / "jpeg.png").write_bytes(data)
    np.testing.assert_array_equal(image_io.read_image(tmp_path / "jpeg.png"), _pil(data))
    with pytest.raises(ValueError, match="not a PNG"):
        image_io.read_png(tmp_path / "jpeg.png")


def _timed_megapixel(capsys, **kw):
    data = _encode(_image(1024, 1024, seed=5), quality=75, subsampling=2, **kw)
    t0 = time.perf_counter()
    got = image_io.decode_jpeg(data)
    secs = time.perf_counter() - t0
    np.testing.assert_array_equal(got, _pil(data))
    kind = "progressive" if kw.get("progressive") else "baseline"
    with capsys.disabled():
        print(f"\ndecode_jpeg, 1024x1024 4:2:0 quality 75 {kind} ({len(data)} bytes): "
              f"{secs:.3f} s")


def test_decode_time_of_a_megapixel_420_file(capsys):
    """1024x1024 4:2:0 at quality 75, equal to PIL; the seconds are
    printed (the Huffman walk runs per symbol in Python)."""
    _timed_megapixel(capsys)


def test_decode_time_of_a_megapixel_progressive_420_file(capsys):
    """The same picture as a progressive file, equal to PIL; the seconds
    are printed (its refining scans read a bit per nonzero coefficient)."""
    _timed_megapixel(capsys, progressive=True)
