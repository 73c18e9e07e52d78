"""The port's numerical checks (portrayer_tpu_torch.debug) and progress
reporting (portrayer_tpu_torch.reporter) against the JAX package's, on the
CPU.

Tolerances, with their reasons:
- checked_trace's framebuffer against JAX's checked_trace on the same
  rays: the atol 1e-4 of tests/test_torch_shade.py (the JAX trace runs
  jitted under checkify; XLA contracts mul+add into FMA).
- queue_overflow_fraction against JAX's: rtol 1e-5, the f32 rounding of
  the dropped-throughput sums (the same lanes are dropped).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import scenes
import portrayer_tpu as P
from portrayer_tpu import debug as jdebug
from portrayer_tpu import reporter as jreporter
import portrayer_tpu_torch as T
from portrayer_tpu_torch import debug, reporter, rng, scenes as tscenes
from portrayer_tpu_torch.camera import Camera
from portrayer_tpu_torch.ops.intersect import _vec

from _torch_jax import glass_sphere, jax_arrays

TILE = 16


def _simple_rays():
    """tests/test_render.py::test_checked_trace_reports_clean's rays:
    simple, 16x16 pixel centres."""
    ys, xs = np.mgrid[0:TILE, 0:TILE]
    px = torch.tensor(xs.reshape(-1), dtype=torch.float32) + 0.5
    py = torch.tensor(ys.reshape(-1), dtype=torch.float32) + 0.5
    o, d = Camera(tscenes.load("simple").camera, (TILE, TILE), "cpu").rays_at(px, py)
    n = TILE * TILE
    return o, d, torch.arange(n, dtype=torch.int32), torch.zeros((n, 3)), n


def test_checked_trace_clean_on_simple_and_matches_jax():
    spec = scenes.load("simple")
    jcfg = P.RenderConfig(samples=1, accel="flat", node_chunk=16)
    jst = P.flatten_scene(spec.scene, dtype=jcfg.dtype)
    o, d, pix, bg, n = _simple_rays()
    jerr, jacc = jdebug.checked_trace(jax.random.PRNGKey(0), jnp.asarray(o.numpy()),
                                      jnp.asarray(d.numpy()), jnp.asarray(pix.numpy()),
                                      jnp.asarray(bg.numpy()), n, jst, jcfg)
    jerr.throw()
    st = T.tables_from_numpy(*jax_arrays(jst), "cpu")
    # accel="cuda" is asked for: checked_trace runs the flat sweep.
    err, acc = debug.checked_trace(rng.PRNGKey(0), o, d, pix, bg, n, st,
                                   T.RenderConfig(device="cpu", samples=1))
    assert err.get() is None
    err.throw()
    debug.assert_image_finite(acc)
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), rtol=0, atol=1e-4)


def _checked_scene_tile(name):
    """checked_trace (flat sweep) on a 16x16 grid of camera rays spread
    over the frame of the port's scene `name`: (FloatCheck, acc)."""
    spec = tscenes.load(name)
    ys, xs = np.mgrid[0:TILE, 0:TILE]
    o, d = Camera(spec.camera, (TILE, TILE), "cpu").rays_at(
        torch.tensor(xs.reshape(-1) * spec.size[0] / TILE, dtype=torch.float32) + 0.5,
        torch.tensor(ys.reshape(-1) * spec.size[1] / TILE, dtype=torch.float32) + 0.5)
    n = TILE * TILE
    return debug.checked_trace(rng.PRNGKey(1), o, d, torch.arange(n, dtype=torch.int32),
                               torch.zeros((n, 3)), n, T.flatten_scene(spec.scene, "cpu"),
                               T.RenderConfig(device="cpu", accel="flat"))


@pytest.mark.parametrize("name", ["big-scene", "torus-showcase", "glossy-reflection",
                                  "four-shapes"])
def test_checked_trace_clean_on_the_port_scenes(name):
    """No op of the port's trace makes a NaN on these scenes either."""
    err, acc = _checked_scene_tile(name)
    assert err.get() is None, err.get()
    assert torch.isfinite(acc).all()


class _NanAllocations(TorchDispatchMode):
    """Hands out every uninitialised allocation filled with NaN, as an
    allocator may when its free memory last held NaNs."""

    def __init__(self):
        super().__init__()
        self.poisoned = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in (torch.ops.aten.empty, torch.ops.aten.empty_strided,
                                   torch.ops.aten.empty_like, torch.ops.aten.new_empty):
            if out.is_floating_point():
                out.fill_(float("nan"))
                self.poisoned += 1
        return out


def _free_nans():
    """Leave NaNs in the allocator's free memory."""
    junk = [torch.full((1024,), float("nan")) for _ in range(256)]
    junk += [torch.full((3,), float("nan")) for _ in range(64)]
    del junk


def test_checked_trace_ignores_nans_left_in_freed_memory():
    """What an allocation holds before anything writes it is no NaN that a
    computation made: neither _vec's constants after NaN tensors were freed
    nor a trace whose allocations all come back full of NaN report one."""
    like = torch.zeros(1)
    reports = 0
    for _ in range(200):
        _free_nans()
        check = debug.FloatCheck()
        with debug._NanMode(check):
            v = _vec((0.2, 0.4, 0.6), like)
        reports += check.op is not None
        assert torch.equal(v, torch.tensor([0.2, 0.4, 0.6]))
    assert reports == 0
    # The mode below the check hands the check NaN-filled memory.
    with _NanAllocations() as poison:
        check = debug.FloatCheck()
        with debug._NanMode(check):
            assert torch.isnan(torch.empty(3)).all()
            v = _vec((0.2, 0.4, 0.6), like)
        assert check.get() is None, check.get()
        assert torch.equal(v, torch.tensor([0.2, 0.4, 0.6]))
        _free_nans()
        err, acc = _checked_scene_tile("glossy-reflection")
    assert poison.poisoned >= 1
    assert err.get() is None, err.get()
    assert torch.isfinite(acc).all()


def test_nan_mode_judges_an_in_place_op_by_what_it_read():
    """An op that overwrites all of self (fill_, zero_, copy_) met no NaN
    that was only in the memory it overwrote; any other in-place op is
    judged by self as it was before the op."""
    nan = float("nan")
    for op in (lambda x: x.fill_(nan), lambda x: x.copy_(torch.tensor([0.0, nan]))):
        check = debug.FloatCheck()
        x = torch.full((2,), nan)
        with debug._NanMode(check):
            op(x)
        assert check.made_here == (check.op == "aten.fill_.Scalar"), check.get()
    mode = debug._NanMode(check := debug.FloatCheck())
    x, y = torch.tensor([float("inf")]), torch.full((1,), nan)
    with mode:
        x.add_(float("-inf"))
        y.add_(1.0)
    assert check.made_here and check.op == "aten.add_.Tensor", check.get()
    mode = debug._NanMode(check := debug.FloatCheck())
    with mode:
        y.mul_(2.0)
    assert check.op is None and mode.met[0] == "aten.mul_.Tensor"


def test_checked_trace_reports_a_nan_in_a_table_with_its_op():
    st = T.flatten_scene(tscenes.load("simple").scene, "cpu")
    o, d, pix, bg, n = _simple_rays()
    cfg = T.RenderConfig(device="cpu", accel="flat")
    diffuse = st.mat_diffuse.clone()
    diffuse[0, 0] = float("nan")
    err, acc = debug.checked_trace(rng.PRNGKey(0), o, d, pix, bg, n,
                                   st.replace(mat_diffuse=diffuse), cfg)
    assert not err.made_here and err.op.startswith("aten.")
    assert "portrayer_tpu_torch/ops/" in err.frame, err.frame
    with pytest.raises(FloatingPointError, match=r"nan: aten\.\S+ met a NaN"):
        err.throw()
    with pytest.raises(FloatingPointError, match="non-finite"):
        debug.assert_image_finite(acc)
    # An inf in a transform makes a NaN (inf * 0) where the rays meet it.
    inv = st.inv.clone()
    inv[1, 0, 0] = float("inf")
    err, _ = debug.checked_trace(rng.PRNGKey(0), o, d, pix, bg, n, st.replace(inv=inv), cfg)
    assert err.made_here and err.op == "aten.mul.Tensor", err.get()
    with pytest.raises(FloatingPointError, match="made a NaN, at portrayer_tpu_torch/ops/"):
        err.throw()


def test_assert_image_finite_matches_jax():
    img = np.zeros((4, 5, 3))
    img[2, 3, 1] = np.inf
    img[3, 0, 0] = np.nan
    for fn in (debug.assert_image_finite, jdebug.assert_image_finite):
        with pytest.raises(FloatingPointError) as e:
            fn(img, "frame")
        assert str(e.value) == "frame: 2 non-finite values; first at index (2, 3, 1)"
    with pytest.raises(FloatingPointError, match=r"index \(0, 1\)"):
        debug.assert_image_finite(torch.tensor([[0.0, float("nan")]]))
    ok = np.ones((2, 2, 3))
    assert debug.assert_image_finite(ok) is ok


@pytest.mark.parametrize("caps", [(0.05,), (0.2, 0.05)])
def test_queue_overflow_fraction_matches_jax(caps):
    """The refractive inline scene with bounce queues cut far below their
    need: the same throughput is dropped in both packages."""
    js, jcam, _ = glass_sphere(P)
    ts, tcam, _ = glass_sphere(T)
    ref = jdebug.queue_overflow_fraction(
        js, jcam, (64, 64), lambda uv: jnp.full(uv.shape[:-1] + (3,), 0.3),
        P.RenderConfig(accel="flat", queue_caps=caps, max_depth=3))
    got = debug.queue_overflow_fraction(
        ts, tcam, (64, 64), lambda uv: torch.full(uv.shape[:-1] + (3,), 0.3),
        T.RenderConfig(device="cpu", queue_caps=caps, max_depth=3))
    assert ref > 0.01
    assert got == pytest.approx(ref, rel=1e-5)


def _ticks(pkg, monkeypatch, capsys, ci):
    """(stdout, stderr) of a RenderProgress over 3 tiles, the clock stepped
    1 s a call."""
    clock = iter(range(100, 200))
    monkeypatch.setattr(pkg.time, "time", lambda: float(next(clock)))
    if ci:
        monkeypatch.setenv("CI", "true")
    else:
        monkeypatch.delenv("CI", raising=False)
    rep = pkg.RenderProgress()
    rep.start(3)
    for _ in range(3):
        rep.tick()
    rep.finish()
    return capsys.readouterr()


@pytest.mark.parametrize("ci", [False, True])
def test_render_progress_matches_jax(monkeypatch, capsys, ci):
    ours = _ticks(reporter, monkeypatch, capsys, ci)
    ref = _ticks(jreporter, monkeypatch, capsys, ci)
    assert ours == ref
    if ci:  # the first tick and the last print; "Done!" at the end
        assert ours.out == "33%\n100%\nDone!\n" and ours.err == ""
    else:
        assert ours.out == "" and "3/3 tiles (100.0%)" in ours.err


class _Count(reporter.Reporter):
    def __init__(self):
        super().__init__()
        self.calls = []

    def start(self, total):
        self.calls.append(("start", total))

    def tick(self, n=1):
        self.calls.append(("tick", n))

    def finish(self):
        self.calls.append(("finish",))


def test_reporter_ticks_once_per_tile():
    spec = tscenes.load("simple")
    cfg = T.RenderConfig(device="cpu", samples=2, tile=(16, 16))
    rep = _Count()
    img = T.render_linear(spec.scene, spec.camera, (40, 20), spec.background, cfg,
                          reporter=rep)
    # 3 x 2 tiles; the image equals one rendered without a reporter.
    assert rep.calls == [("start", 6)] + [("tick", 1)] * 6 + [("finish",)]
    np.testing.assert_array_equal(
        img, T.render_linear(spec.scene, spec.camera, (40, 20), spec.background, cfg))
    rep = _Count()
    T.Image(None, 40, 20).slice_render((0, 0), (10, 10), spec.scene, spec.camera,
                                       spec.background, cfg, reporter=rep)
    assert rep.calls == [("start", 1), ("tick", 1), ("finish",)]
    rep = _Count()
    T.render_u8(spec.scene, spec.camera, (40, 20), spec.background, cfg, reporter=rep)
    assert rep.calls.count(("tick", 1)) == 6
