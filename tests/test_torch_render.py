"""The port's render loop against the JAX package's (accel="flat") and
the committed self-goldens, on the CPU, where the sweep runs its plain
PyTorch version; PNG I/O, region re-render, SAMPLES, config checks and the
no-JAX import rule.

Tolerances, with their reasons:
- render_linear against JAX's jitted render, an image-level check on top
  of the atol-1e-4 one in test_torch_shade.py (a tile traced by both
  packages from the same rays, JAX unfused): both draw the same jitter
  (bit-equal threefry), but fused, XLA on the CPU contracts mul+add into
  FMA, so camera rays and hit points differ by ulps.  Where a shadow or
  silhouette is grazed that flips a sample, so at most 1% of pixels may
  differ by more than 1e-4 and none by more than 2e-2 (measured:
  big-scene 0.42% of pixels, max 9.6e-3).
- u8 images: the self-golden rule of tests/test_golden.py, fewer than 0.1%
  of pixels off by more than 2/255.
- The float64 check mode against the JAX package's under x64: atol 1e-9
  (measured 7e-13: both round every op in float64); against the port's
  float32 render, the JAX package's own gate (tests/test_render.py:141-144,
  mean < 2e-3 and max < 0.05).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import scenes
import portrayer_tpu as P
import portrayer_tpu_torch as T
from portrayer_tpu_torch import image_io, scenes as tscenes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "self_golden")
# The self-goldens' sizes (tools/gen_self_goldens.py).
SIZES = {"simple": (64, 64), "big-scene": (160, 82), "four-shapes": (256, 68)}
_cache = {}


def _render(which, name, size=None, as_u8=False, **kw):
    """Cached render of `name` by the JAX package ("jax") or the port."""
    size = size or SIZES[name]
    kw = dict(dict(samples=4, tile=(64, 64), seed=0), **kw)
    key = (which, name, size, as_u8, tuple(sorted(kw.items())))
    if key not in _cache:
        if which == "jax":
            spec = scenes.load(name)
            fn = P.render_u8 if as_u8 else P.render_linear
            cfg = P.RenderConfig(accel="flat", **kw)
        else:
            spec = tscenes.load(name)
            fn = T.render_u8 if as_u8 else T.render_linear
            cfg = T.RenderConfig(device="cpu", **kw)
        _cache[key] = fn(spec.scene, spec.camera, size, spec.background, cfg)
    return _cache[key]


def assert_images_close(ours, ref):
    assert ours.shape == ref.shape
    assert np.isfinite(ours).all()
    diff = np.abs(ours - ref).max(axis=-1)
    assert (diff > 1e-4).mean() < 0.01, f"{(diff > 1e-4).mean():.3%} pixels off"
    assert diff.max() < 2e-2, diff.max()


def assert_self_golden_rule(ours, ref):
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    diff = np.abs(ours.astype(np.int16) - ref.astype(np.int16))
    frac = (diff > 2).any(axis=-1).mean()
    assert frac < 1e-3, f"{frac:.2%} pixels differ (max {diff.max()})"


# big-scene's two cases, the longest, are in files of their own
# (tests/test_torch_render_big_scene_*.py), so that the test run spreads
# them over its workers.
@pytest.mark.parametrize("name", ["simple"])
def test_render_linear_matches_jax(name):
    assert_images_close(_render("port", name), _render("jax", name))


@pytest.mark.parametrize("name", ["simple", "four-shapes"])
def test_render_u8_matches_self_golden_and_jax(name):
    ours = _render("port", name, as_u8=True)
    assert ours.dtype == np.uint8
    assert_self_golden_rule(ours, image_io.read_png(os.path.join(GOLDEN, f"{name}.png")))
    assert_self_golden_rule(ours, _render("jax", name, as_u8=True))


def test_region_rerender_keeps_the_rest(tmp_path):
    spec = tscenes.load("simple")
    cfg = T.RenderConfig(device="cpu", samples=2, tile=(32, 32), seed=0)
    full = T.render_u8(spec.scene, spec.camera, (64, 64), spec.background, cfg)
    path = str(tmp_path / "prev.png")
    prev = np.full((64, 64, 3), 7, np.uint8)
    image_io.write_png(path, prev)
    img = T.Image(path, 64, 64)
    np.testing.assert_array_equal(img.buffer, prev)
    region = ((10, 5), (40, 30))
    img.slice_render(region[0], region[1], spec.scene, spec.camera, spec.background, cfg)
    inside = (slice(5, 31), slice(10, 41))
    np.testing.assert_array_equal(img.buffer[inside], full[inside])
    outside = np.ones((64, 64), bool)
    outside[inside] = False
    assert (img.buffer[outside] == 7).all()
    img.save()
    np.testing.assert_array_equal(image_io.read_png(path), img.buffer)


def test_samples_env(monkeypatch):
    monkeypatch.setenv("SAMPLES", "3")
    assert T.RenderConfig(device="cpu").resolved_samples() == 3
    assert T.RenderConfig(device="cpu", samples=5).resolved_samples() == 5
    for bad in ("0", "-2", "x"):
        monkeypatch.setenv("SAMPLES", bad)
        assert T.RenderConfig(device="cpu").resolved_samples() == 100
    monkeypatch.setenv("SAMPLES", "2")
    spec = tscenes.load("simple")
    env = T.render_linear(spec.scene, spec.camera, (24, 24), spec.background,
                          T.RenderConfig(device="cpu", tile=(16, 16)))
    explicit = T.render_linear(spec.scene, spec.camera, (24, 24), spec.background,
                               T.RenderConfig(device="cpu", tile=(16, 16), samples=2))
    np.testing.assert_array_equal(env, explicit)


def test_odd_frame_70x33():
    """A frame that no tile divides: same image as the JAX package, and the
    flat oracle and the sweep give the same render."""
    kw = dict(size=(70, 33), samples=2, tile=(32, 32))
    ours = _render("port", "simple", **kw)
    assert ours.shape == (33, 70, 3)
    assert_images_close(ours, _render("jax", "simple", **kw))
    flat = _render("port", "simple", accel="flat", **kw)
    np.testing.assert_allclose(ours, flat, atol=1e-6)


def test_config_needs_a_device_and_a_known_accel():
    """A render without a config runs on the card: with no card it raises
    rather than fall back to the CPU."""
    with pytest.raises(ValueError):
        T.RenderConfig(device="cpu", accel="pallas")
    if not torch.cuda.is_available():
        spec = tscenes.load("simple")
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            T.render_u8(spec.scene, spec.camera, (8, 8), spec.background)


@pytest.mark.parametrize("name, size", [("simple", (48, 36)), ("glossy-reflection", (32, 24)),
                                        ("four-shapes", (32, 24))])
def test_float64_check_mode_matches_jax_x64_and_float32(name, size):
    """dtype=float64 threads through the camera, the tables, the sweep,
    shading and the render; its jitter and glossy draws are the float32
    ones, cast."""
    import jax
    import jax.numpy as jnp

    spec = tscenes.load(name)
    kw = dict(device="cpu", samples=2, tile=(48, 48), accel="flat")
    args = (spec.scene, spec.camera, size, spec.background)
    img64 = T.render_linear(*args, T.RenderConfig(dtype=torch.float64, **kw))
    img32 = T.render_linear(*args, T.RenderConfig(**kw))
    jspec = scenes.load(name)
    with jax.enable_x64(True):
        ref = P.render_linear(jspec.scene, jspec.camera, size, jspec.background,
                              P.RenderConfig(samples=2, tile=(48, 48), accel="flat",
                                             dtype=jnp.float64))
    assert img64.dtype == np.float64
    np.testing.assert_allclose(img64, ref, rtol=0, atol=1e-9)
    diff = np.abs(img64 - img32)
    assert diff.mean() < 2e-3 and diff.max() < 0.05, (diff.mean(), diff.max())
    assert diff.max() > 0  # the two precisions really differ


def test_float64_refuses_the_kernel():
    """The sweep kernel is float32 only: float64 with accel="cuda" (the
    default) raises at construction, naming accel="flat"; no hidden
    fallback."""
    with pytest.raises(ValueError, match="accel='flat'"):
        T.RenderConfig(dtype=torch.float64)
    with pytest.raises(ValueError, match="accel='flat'"):
        T.RenderConfig(device="cpu", dtype=torch.float64, accel="cuda")
    with pytest.raises(ValueError, match="dtype"):
        T.RenderConfig(device="cpu", dtype=torch.float16, accel="flat")
    assert T.RenderConfig(device="cpu", dtype=torch.float64, accel="beam").dtype == torch.float64
    assert T.RenderConfig().dtype == torch.float32


def test_config_defaults_to_the_card():
    """RenderConfig() names cuda; a caller asks for the CPU by name."""
    assert T.RenderConfig().device.type == "cuda"
    assert T.RenderConfig(device="cpu").device == torch.device("cpu")
    assert T.RenderConfig(samples=3).device.type == "cuda"


def test_png_io_against_pil():
    from PIL import Image as PILImage

    for name in ("simple", "big-scene"):
        path = os.path.join(GOLDEN, f"{name}.png")
        np.testing.assert_array_equal(image_io.read_png(path),
                                      np.asarray(PILImage.open(path).convert("RGB")))
    rgb = np.random.default_rng(0).integers(0, 256, (5, 7, 3), dtype=np.uint8)
    import io

    np.testing.assert_array_equal(
        np.asarray(PILImage.open(io.BytesIO(image_io.encode_png(rgb)))), rgb)
    np.testing.assert_array_equal(image_io.decode_png(image_io.encode_png(rgb)), rgb)
    # Every filter type, as PIL's encoder may pick them per row.
    buf = io.BytesIO()
    big = np.random.default_rng(1).integers(0, 256, (40, 33, 3), dtype=np.uint8)
    big[:, :16] = np.arange(16)[None, :, None] * 9
    PILImage.fromarray(big).save(buf, format="PNG", optimize=True)
    np.testing.assert_array_equal(image_io.decode_png(buf.getvalue()), big)


def test_port_imports_no_jax():
    """`import portrayer_tpu_torch`, each of its 29 scene programs built
    and lowered (on the stand-in assets of tests/_torch_assets.py, JPEG
    textures among them) and two rendered through its run-all-examples
    runner, CPU renders of the textured and area-lit stand-ins of
    tests/_torch_jax.py (both helper modules chip_smoke.py imports on the
    card), a gradient through trace, and the parallel, debug, reporter and
    beam modules (a one-rank train_step through the beam sweep, a checked
    trace), Morton packing, shade_hits, the quadratic solver and an
    interlaced 16-bit PNG (written by tests/_torch_png.py) leave JAX, flax,
    PIL and the JAX package out of sys.modules."""
    code = (
        "import os, sys, tempfile\n"
        "sys.path.insert(0, 'tests')\n"
        "from _torch_assets import write_standins\n"
        "tmp = tempfile.mkdtemp()\n"
        "write_standins(tmp, seed=0)\n"
        "os.environ['PORTRAYER_ASSETS'] = tmp\n"
        "import portrayer_tpu_torch as T\n"
        "from portrayer_tpu_torch import scenes, run_all_examples\n"
        "assert len(scenes.names()) == 29, scenes.names()\n"
        "for name in scenes.names():\n"
        "    T.flatten_scene(scenes.load(name).scene, 'cpu')\n"
        "run_all_examples.render_all(['simple', 'water-glass'], os.path.join(tmp, 'out'),\n"
        "                            samples=1, scale=0.01, device='cpu')\n"
        "from _torch_jax import INLINE\n"
        "for name in ('normal-mapping-numpy', 'soft-shadows-icosphere'):\n"
        "    scene, cam, _ = INLINE[name](T)\n"
        "    T.render_u8(scene, cam, (12, 8), cfg=T.RenderConfig(device='cpu', samples=1))\n"
        "import torch\n"
        "from portrayer_tpu_torch import rng, parallel, debug, reporter\n"
        "from portrayer_tpu_torch.ops import beam\n"
        "from portrayer_tpu_torch.ops.trace import trace\n"
        "st = T.flatten_scene(scenes.load('simple').scene, 'cpu')\n"
        "x = st.mat_diffuse.clone().requires_grad_()\n"
        "o = torch.zeros(4, 3); d = torch.tensor([[0.0, 0.0, -1.0]]).repeat(4, 1)\n"
        "pix = torch.arange(4, dtype=torch.int32)\n"
        "acc = trace(rng.PRNGKey(0), o, d, pix, torch.zeros(4, 3), 4, st.replace(mat_diffuse=x),\n"
        "            T.RenderConfig(device='cpu', soft_visibility=0.05))\n"
        "acc.sum().backward()\n"
        "assert x.grad.abs().sum() > 0\n"
        "parallel.initialize(num_processes=1, device='cpu')\n"
        "mesh = parallel.make_mesh(device='cpu')\n"
        "cfg = T.RenderConfig(device='cpu', accel='beam', beam_min_prims=1)\n"
        "loss, g = parallel.train_step(mesh, rng.PRNGKey(0), o, d, pix, torch.zeros(4, 3), 4, 1,\n"
        "                              torch.zeros(4, 3), st, cfg)\n"
        "err, _ = debug.checked_trace(rng.PRNGKey(0), o, d, pix, torch.zeros(4, 3), 4, st, cfg)\n"
        "err.throw()\n"
        "from portrayer_tpu_torch import fit, image_io, math3d\n"
        "from portrayer_tpu_torch.ops import shade_hits, hit_detail, intersect_scene\n"
        "T.flatten_scene(scenes.load('big-scene').scene, 'cpu', packing='morton')\n"
        "c = T.RenderConfig(device='cpu')\n"
        "h = intersect_scene(o, d, 1e-5, float('inf'), st, c)\n"
        "shade_hits(d, h, hit_detail(o, d, h, st, c, 1e-5), st, c, rng.PRNGKey(0), h.hit)\n"
        "math3d.quadratic_roots(o[:, 0] + 1, o[:, 1], o[:, 2] - 1)\n"
        "from _torch_png import png_bytes, random_samples\n"
        "image_io.decode_png(png_bytes(random_samples(6, 16, 9, 7), 16, 6, interlace=1))\n"
        "bad = [m for m in ('jax', 'flax', 'PIL', 'portrayer_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
