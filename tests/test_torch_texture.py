"""Textures, normal maps and area lights in the port against the JAX
package, on the CPU: the PNG reader's colour types and the writer's
suffix check, atlas sampling, the normal-map decode, the uv transform,
the shading of the procedural-texture and area-light cases of
tests/test_shading.py, and shade_pre on normal-mapping-numpy, a stand-in
scene of tests/_torch_jax.py (tests/test_torch_stand_ins.py traces it and
soft-shadows-icosphere through the bounce loop).

Tolerances, with their reasons:
- PNG decoding, texel indices, the normal-map decode and the uv transform:
  exact (integer work, or single-rounded f32 ops in the same order; JAX
  runs op by op).
- sRGB texels, x ** 2.2 of u8/255: 1 ulp: XLA's pow and torch's round
  apart on some of the 256 values.
- The procedural-texture case: exact; the area-light case's sum of 256
  samples: rtol 1e-5 / atol 1e-6 (both packages draw the same points;
  each op rounds once in both).
- shade_pre: rtol 1e-4 / atol 1e-5 (the specular x^100 term rtol 1e-3),
  as in test_torch_shade.py.
"""

import importlib
import io
import struct
import zlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from PIL import Image as PILImage

import portrayer_tpu as P
from portrayer_tpu.camera import Camera as JaxCamera
from portrayer_tpu.ops import intersect as jx
from portrayer_tpu.ops import shade as jshade
from portrayer_tpu.scene import texture as jtexture
import portrayer_tpu_torch as T
from portrayer_tpu_torch import image_io, rng
from portrayer_tpu_torch.ops import intersect as tx, shade as tshade, trace as ttrace
from portrayer_tpu_torch.scene import texture as ttexture

from _torch_jax import INLINE, checker, colour_image, jax_arrays
from _torch_png import png_bytes, random_samples

# The module (portrayer_tpu.ops re-exports its function `trace`).
jtrace = importlib.import_module("portrayer_tpu.ops.trace")
T_CPU = T.RenderConfig(device="cpu")
J_FLAT = P.RenderConfig(accel="flat")


# ---------------------------------------------------------------------------
# PNG: every 8-bit colour type to RGB; the rest refused; PNG-only writes.
# ---------------------------------------------------------------------------

def _pil_png(mode, seed=0, size=(37, 21)):
    """PNG bytes of a random PIL image of `mode` (optimised: PIL picks the
    filter of each row) and its convert("RGB")."""
    g = np.random.default_rng(seed)
    w, h = size
    if mode == "P":  # more than 16 colours: PIL writes 8-bit indices
        img = PILImage.fromarray(g.integers(0, 40, (h, w), dtype=np.uint8), "P")
        img.putpalette(g.integers(0, 256, 40 * 3).tolist())
    else:
        ch = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
        arr = g.integers(0, 256, (h, w, ch), dtype=np.uint8)
        arr[:, : w // 2] = (np.arange(w // 2) * 5)[None, :, None]  # smooth: Sub/Up/Paeth rows
        img = PILImage.fromarray(arr[..., 0] if ch == 1 else arr, mode)
    buf = io.BytesIO()
    img.save(buf, format="PNG", optimize=True)
    return buf.getvalue(), np.asarray(PILImage.open(io.BytesIO(buf.getvalue())).convert("RGB"))


@pytest.mark.parametrize("mode", ["L", "LA", "P", "RGB", "RGBA"])
def test_png_colour_types_decode_as_pil_converts(mode):
    data, ref = _pil_png(mode)
    got = image_io.decode_png(data)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def _png_16bit():
    buf = io.BytesIO()
    PILImage.fromarray(np.arange(12, dtype=np.uint16).reshape(3, 4) * 5000).save(
        buf, format="PNG")
    return buf.getvalue()


def _png_1bit():
    buf = io.BytesIO()
    PILImage.fromarray(np.eye(8, dtype=bool)).save(buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("kind", ["16-bit", "1-bit", "interlaced"])
def test_png_other_kinds_raise(kind):
    """The kinds the reader refused before it read every kind are read as
    PIL reads them: PIL's own 16-bit grey file (I;16, which convert("RGB")
    clips at 255) and 1-bit file, and an Adam7-interlaced RGB file
    (tests/_torch_png.py); the other kinds: tests/test_torch_png_kinds.py."""
    if kind == "16-bit":
        data = _png_16bit()
        assert struct.unpack(">B", data[24:25])[0] == 16
    elif kind == "1-bit":
        data = _png_1bit()
        assert struct.unpack(">B", data[24:25])[0] == 1
    else:
        data = png_bytes(random_samples(2, 8, 11, 13), 8, 2, interlace=1)
        assert data[28] == 1
    ref = np.asarray(PILImage.open(io.BytesIO(data)).convert("RGB"))
    got = image_io.decode_png(data)
    assert got.dtype == np.uint8 and ref.max() > 0
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name, writes", [("out.png", True), ("out.PNG", True),
                                          ("out.jpg", False), ("out.JPEG", False),
                                          ("out", False)])
def test_save_as_writes_png_only(tmp_path, name, writes):
    img = T.Image(None, 5, 3)
    img.buffer[:] = np.random.default_rng(0).integers(0, 256, (3, 5, 3), dtype=np.uint8)
    path = tmp_path / name
    if writes:
        img.save_as(str(path))
        np.testing.assert_array_equal(
            np.asarray(PILImage.open(path).convert("RGB")), img.buffer)
    else:
        with pytest.raises(ValueError, match="only PNG"):
            img.save_as(str(path))
        assert not path.exists()


# ---------------------------------------------------------------------------
# Texture classes
# ---------------------------------------------------------------------------

def test_textures_from_png_paths_and_arrays(tmp_path):
    """A PNG path reads what PIL reads (an RGBA file here), and so does a
    JPEG path; a missing file raises naming it, a file of another kind
    names its path; float data goes through the JAX package's _as_u8;
    identity hashing, as the JAX package's."""
    data, ref = _pil_png("RGBA", seed=4)
    path = tmp_path / "tex.png"
    path.write_bytes(data)
    jpg = tmp_path / "tex.jpg"
    PILImage.fromarray(colour_image(4, 21, 37)).save(jpg, quality=80)
    jref = np.asarray(PILImage.open(jpg).convert("RGB"))
    (tmp_path / "tex.gif").write_bytes(b"GIF89a" + bytes(32))
    for cls in (ttexture.ImageTexture, ttexture.NormalMap):
        np.testing.assert_array_equal(cls(str(path)).raw, ref)
        np.testing.assert_array_equal(cls(str(jpg)).raw, jref)
        with pytest.raises(FileNotFoundError, match="missing.jpg"):
            cls(str(tmp_path / "missing.jpg"))
        with pytest.raises(ValueError, match="tex.gif: neither a PNG nor a JPEG"):
            cls(str(tmp_path / "tex.gif"))
    np.testing.assert_array_equal(T.Texture.open(str(jpg)).image.raw, jref)
    f = np.random.default_rng(2).uniform(-0.1, 1.1, (4, 6, 3))
    np.testing.assert_array_equal(T.ImageTexture(data=f).raw, jtexture._as_u8(f))
    a, b = T.ImageTexture(data=ref), T.ImageTexture(data=ref)
    assert a != b and a == a and hash(a) == id(a)
    tex = T.Texture(a)
    assert T.Texture(tex).image is a and tex.is_image
    assert T.Texture(checker(T)).fn is checker(T)
    with pytest.raises(TypeError):
        tex.fn  # noqa: B018


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

def _atlas():
    """Two images back to back (7x5 and 4x9): (data [P,3] u8, meta [2,3])."""
    imgs = [colour_image(8, 5, 7), colour_image(9, 9, 4)]
    data = np.concatenate([i.reshape(-1, 3) for i in imgs])
    meta = np.array([[0, 7, 5], [35, 4, 9]], np.int32)
    return data, meta


def _uvs():
    """uv that wrap (beyond 1), are negative, fall exactly on integers and
    on the texel grid, and random ones; with image ids (-1 clamps to 0)."""
    g = np.random.default_rng(5)
    special = np.array([0.0, 1.0, 2.0, -1.0, -2.0, 3.0, 0.5, -0.5, 1.5, -1.5, 1.0 / 6.0,
                        5.0 / 6.0, 0.25, -0.25, 7.0, -7.0], np.float32)
    u, v = np.meshgrid(special, special, indexing="ij")
    uv = np.concatenate([np.stack([u.ravel(), v.ravel()], -1),
                         g.uniform(-4.0, 4.0, (512, 2)).astype(np.float32)])
    ix = g.integers(-1, 2, uv.shape[0]).astype(np.int32)
    return uv.astype(np.float32), ix


@pytest.mark.parametrize("srgb", [False, True])
def test_sample_atlas_matches_jax(srgb):
    data, meta = _atlas()
    uv, ix = _uvs()
    with jax.disable_jit():
        ref = np.asarray(jshade.sample_atlas(jnp.asarray(data), jnp.asarray(meta),
                                             jnp.asarray(ix), jnp.asarray(uv), srgb=srgb))
    got = tshade.sample_atlas(torch.from_numpy(data), torch.from_numpy(meta),
                              torch.from_numpy(ix), torch.from_numpy(uv), srgb=srgb).numpy()
    if srgb:
        np.testing.assert_array_max_ulp(got, ref, maxulp=1)
    else:
        np.testing.assert_array_equal(got, ref)
    # The texel rule by hand: x = trunc(u (w - 1)) rem_euclid w.
    m = meta[np.maximum(ix, 0)]
    x = np.trunc(uv[:, 0] * (m[:, 1] - 1).astype(np.float32)).astype(np.int64) % m[:, 1]
    y = np.trunc(uv[:, 1] * (m[:, 2] - 1).astype(np.float32)).astype(np.int64) % m[:, 2]
    texel = data[m[:, 0] + y * m[:, 1] + x].astype(np.float32) * np.float32(1.0 / 255.0)
    np.testing.assert_array_max_ulp(got, texel ** np.float32(2.2) if srgb else texel, maxulp=1)
    assert ((uv < 0) & (got[:, :1] > 0)).any()  # negative uv wrap to texels too


def test_normal_map_decode_and_uv_trans_match_jax():
    g = np.random.default_rng(6)
    texel = g.uniform(0.0, 1.0, (300, 3)).astype(np.float32)
    uvt6 = g.uniform(-3.0, 3.0, (300, 6)).astype(np.float32)
    uv = g.uniform(-2.0, 2.0, (300, 2)).astype(np.float32)
    with jax.disable_jit():
        ref_n = np.asarray(jshade._decode_normal_map(jnp.asarray(texel)))
        ref_uv = np.asarray(jshade._apply_uv_trans(jnp.asarray(uvt6), jnp.asarray(uv)))
    np.testing.assert_array_equal(tshade._decode_normal_map(torch.from_numpy(texel)).numpy(),
                                  ref_n)
    np.testing.assert_array_equal(
        tshade._apply_uv_trans(torch.from_numpy(uvt6), torch.from_numpy(uv)).numpy(), ref_uv)
    # A flat normal-map texel, (0.5, 0.5, 1), decodes to the tangent frame's +y.
    flat = tshade._decode_normal_map(torch.tensor([[0.5, 0.5, 1.0]]))
    np.testing.assert_array_equal(flat.numpy(), [[0.0, 1.0, 0.0]])


# ---------------------------------------------------------------------------
# The procedural-texture and area-light cases of tests/test_shading.py
# ---------------------------------------------------------------------------

def _trace_both(scene_of, o, d, spp=1):
    """Both packages trace rays o, d [R,3] (one pixel) through `scene_of(pkg)`
    (flat sweep; JAX op by op); returns (port acc [3], JAX acc [3])."""
    R = o.shape[0]
    pix = np.zeros(R, np.int32)
    bg = np.zeros((1, 3), np.float32)
    with jax.disable_jit():
        ref = jtrace.trace(jax.random.PRNGKey(0), jnp.asarray(o), jnp.asarray(d),
                           jnp.asarray(pix), jnp.asarray(bg), 1,
                           P.flatten_scene(scene_of(P), dtype=jnp.float32),
                           P.RenderConfig(accel="flat", node_chunk=8))
    got = ttrace.trace(rng.PRNGKey(0), torch.from_numpy(o), torch.from_numpy(d),
                       torch.from_numpy(pix), torch.from_numpy(bg), 1,
                       T.flatten_scene(scene_of(T), "cpu"), T_CPU)
    return got.numpy()[0], np.asarray(ref)[0]


def _square(pkg):
    return pkg.Scene(pkg.SceneNode(pkg.Geometry(pkg.Plane(), pkg.Material(
        diffuse=(1.0, 0.0, 0.0), texture=pkg.Texture(checker(pkg)),
        uv_trans=np.diag([2.0, 2.0, 1.0])))), [], (1.0, 1.0, 1.0))


def test_procedural_texture_overrides_diffuse():
    """tests/test_shading.py:174: a checker on a unit plane under white
    ambient light; the diffuse colour is the checker's at the hit's uv
    (times the uv_trans), never the material's red."""
    o = np.array([[-0.3, 1.0, -0.3], [0.3, 1.0, -0.3]], np.float32)
    d = np.tile(np.array([[0.0, -1.0, 0.0]], np.float32), (2, 1))
    for i, cell in enumerate((0.0, 1.0)):  # uv (0.2, 0.2) -> cell 0; (0.8, 0.2) -> 1
        got, ref = _trace_both(_square, o[i:i + 1], d[i:i + 1])
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_allclose(got, [0.25 + 0.5 * cell, 0.3 + 0.4 * cell,
                                         0.35 + 0.3 * cell], atol=1e-6)


def _penumbra(pkg):
    return pkg.Scene(pkg.SceneNode([
        pkg.SceneNode(pkg.Geometry(pkg.Plane(), pkg.Material(diffuse=(1.0, 1.0, 1.0))))
        .scaled(20.0),
        pkg.SceneNode(pkg.Geometry(pkg.Sphere(), pkg.Material(diffuse=(1.0, 0.0, 0.0))))
        .translated((0.0, 3.0, 0.0)),
    ]), [pkg.Light(position=(0.0, 6.0, 0.0), color=(1.0, 1.0, 1.0),
                   area=pkg.Parallelogram(a=(2.0, 0.0, 0.0), b=(0.0, 0.0, 2.0)))],
        (0.0, 0.0, 0.0))


def test_area_light_soft_shadow():
    """tests/test_shading.py:191: 256 samples of one penumbra point,
    lit by their own points of the parallelogram (draw site 1000): the same
    fraction of them is shadowed in both packages, neither none nor all."""
    R = 256
    o = np.tile(np.array([[1.6, 1.0, 0.0]], np.float32), (R, 1))
    d = np.tile(np.array([[0.0, -1.0, 0.0]], np.float32), (R, 1))
    got, ref = _trace_both(_penumbra, o, d)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    assert 0.05 < got[0] / R < 0.95


# ---------------------------------------------------------------------------
# A stand-in scene's shading
# ---------------------------------------------------------------------------

# The frame of normal-mapping-numpy's camera rays.
FRAME = (182, 102)


def _tables(name):
    js = P.flatten_scene(INLINE[name](P)[0], dtype=jnp.float32)
    return js, T.tables_from_numpy(*jax_arrays(js), "cpu")


def test_shade_pre_matches_jax_on_stand_ins(name="normal-mapping-numpy"):
    """Both packages shade the JAX flat sweep's hits of 512 camera rays of
    normal-mapping-numpy: image, procedural and normal-mapped materials.
    (tests/test_torch_stand_ins.py traces both stand-ins.)"""
    js, ts = _tables(name)
    scene, camera, _ = INLINE[name](P)
    w, h = FRAME
    g = np.random.default_rng(3)
    px = jnp.asarray(g.uniform(0, w, 512), jnp.float32)
    py = jnp.asarray(g.uniform(0, h, 512), jnp.float32)
    o, d = (np.array(a) for a in JaxCamera(camera, (w, h)).rays_at(px, py))
    with jax.disable_jit():
        hit = jx.intersect_scene(o, d, 1e-5, jnp.inf, js, J_FLAT)
        det = jx.hit_detail(o, d, hit, js, J_FLAT, 1e-5)
        pre, jch = jshade.shade_pre(d, hit, det, js, J_FLAT, jax.random.PRNGKey(0), hit.hit)
    thit = tx.Hit(*(torch.from_numpy(np.array(x)) for x in hit))
    tdet = tx.hit_detail(torch.from_numpy(o), torch.from_numpy(d), thit, ts, T_CPU, 1e-5)
    tpre, _ = tshade.shade_pre(torch.from_numpy(d), thit, tdet, ts, T_CPU, rng.PRNGKey(0),
                               thit.hit)
    m = np.asarray(hit.hit)
    assert 0.5 < m.mean()

    def close(got, ref, rtol):
        got, ref = got.numpy(), np.asarray(ref)
        sel = (slice(None), m) if got.ndim == 3 else m
        np.testing.assert_allclose(got[sel], ref[sel], rtol=rtol, atol=1e-5)

    close(tpre.base, pre.base, 1e-4)
    close(tpre.shadow_dir, pre.shadow_dir, 1e-4)
    close(tpre.light_contrib, pre.light_contrib, 1e-3)
    np.testing.assert_array_equal(tpre.shadow_need.numpy(), np.asarray(pre.shadow_need))
    mats = np.asarray(js.material_id)[np.asarray(hit.node)[m]]  # every kind was shaded
    assert (np.asarray(js.mat_tex_id)[mats] >= 0).any()
    assert (np.asarray(js.mat_tex_id)[mats] == -2).any()
    assert (np.asarray(js.mat_normal_map_id)[mats] >= 0).any()
    assert ts.any_image_tex and ts.any_normal_map and len(ts.fn_textures) == 1


def test_port_tables_render_with_png_textures(tmp_path):
    """Textures given as PNG files (RGB, palette, RGBA, grey) render as the
    same texels given as arrays do."""
    def scene(pkg_tex):
        mats = [T.Material(diffuse=(0.5, 0.5, 0.5), texture=pkg_tex[0]),
                T.Material(diffuse=(0.5, 0.5, 0.5), texture=pkg_tex[1], normals=pkg_tex[2])]
        return T.Scene(T.SceneNode([
            T.SceneNode(T.Geometry(T.Sphere(), mats[0])).translated((-1.2, 0.0, -4.0)),
            T.SceneNode(T.Geometry(T.Cube(), mats[1])).translated((1.2, 0.0, -4.0)),
        ]), [T.Light(position=(0.0, 4.0, 2.0), color=(0.8, 0.8, 0.8))], (0.2, 0.2, 0.2))

    paths, arrays = [], []
    for i, mode in enumerate(("P", "RGBA", "L")):
        data, rgb = _pil_png(mode, seed=10 + i, size=(24, 18))
        path = tmp_path / f"t{i}.png"
        path.write_bytes(data)
        paths.append(str(path))
        arrays.append(rgb)
    from_png = scene([T.Texture.open(paths[0]), T.Texture.open(paths[1]), T.NormalMap(paths[2])])
    from_arr = scene([T.Texture(T.ImageTexture(data=arrays[0])),
                      T.Texture(T.ImageTexture(data=arrays[1])), T.NormalMap(data=arrays[2])])
    cam = T.CameraSettings(eye=(0.0, 0.0, 0.0), center=(0.0, 0.0, -1.0), fovy=0.8)
    cfg = T.RenderConfig(device="cpu", samples=1, tile=(16, 16))
    a = T.render_u8(from_png, cam, (32, 16), cfg=cfg)
    b = T.render_u8(from_arr, cam, (32, 16), cfg=cfg)
    np.testing.assert_array_equal(a, b)
    assert len(np.unique(a.reshape(-1, 3), axis=0)) > 20
