"""The port's scene programs (portrayer_tpu_torch.scenes) against the JAX
package's (scenes/), on seeded stand-in assets (tests/_torch_assets.py)
written under the exact names the programs load; and the port's
run-all-examples entry point.  Renders of the programs against the JAX
package's: tests/test_torch_scenes_render.py.

Tolerances, with their reasons:
- lowered tables: equal array for array (tests/_torch_jax.py
  assert_tables_equal), as for the asset-free scenes in
  tests/test_torch_tables.py.
- the self-goldens of the asset scenes: tests/test_golden.py's rule, fewer
  than 0.1% of pixels off by more than 2/255.
"""

import json
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import scenes
import scenes.common
import portrayer_tpu as P
import portrayer_tpu_torch as T
from portrayer_tpu_torch import image_io, run_all_examples, scenes as tscenes

from _torch_assets import all_asset_names, asset_names, write_standins
from _torch_jax import assert_tables_equal
from test_torch_render import GOLDEN, assert_self_golden_rule

NEW = [n for n in scenes.names() if n not in tscenes.ASSET_FREE]
# The JAX package's asset folder, before any test points it elsewhere.
JAX_ASSETS = scenes.common.ASSETS
# The JAX programs' mesh caches, keyed by file name: cleared whenever the
# asset folder changes.
_JAX_CACHES = ("graphics_castle._cache", "graphics_temple._cache", "robot_alarm_clock._cache",
               "smooth_shading._cache", "monkeys_making_monkeys._mesh_cache")


def _clear_jax_caches():
    import importlib

    for path in _JAX_CACHES:
        mod, attr = path.split(".")
        getattr(importlib.import_module(f"scenes.{mod}"), attr).clear()


def _point_at(mp, directory):
    """Both packages read their assets from `directory`."""
    mp.setattr(scenes.common, "ASSETS", str(directory))
    mp.setenv("PORTRAYER_ASSETS", str(directory))
    _clear_jax_caches()


@pytest.fixture(scope="module")
def standins(tmp_path_factory):
    directory = tmp_path_factory.mktemp("assets")
    write_standins(directory, seed=0)
    with pytest.MonkeyPatch.context() as mp:
        _point_at(mp, directory)
        yield directory
    _clear_jax_caches()


def test_registry_order():
    assert tscenes.names() == scenes.names()
    assert len(NEW) == 22 and set(tscenes.ASSET_FREE) | set(NEW) == set(scenes.names())


def test_standins_cover_every_asset(standins):
    """The names read from the port's programs are those read from the JAX
    package's, and every one was written: no program loads a file that has
    no stand-in (each of the 22 builds, test_tables_equal_on_standins)."""
    assert asset_names() == asset_names(scenes.__path__[0])
    names = all_asset_names()
    assert {n.rsplit(".", 1)[1] for n in names} == {"obj", "png", "jpg"}
    assert "robot-alarm-clock/wallpaper.jpg" in names
    for n in names:
        assert os.path.getsize(standins / n) > 0, n


@pytest.mark.parametrize("name", NEW)
def test_tables_equal_on_standins(standins, name):
    js = P.flatten_scene(scenes.load(name).scene, dtype=jnp.float32)
    ts = T.flatten_scene(tscenes.load(name).scene, "cpu")
    assert_tables_equal(js, ts)


def _uv_grid():
    v, u = np.mgrid[0:7, 0:5] / np.array([6.0, 4.0])[:, None, None]
    return np.stack([u, v], axis=-1).astype(np.float32)


@pytest.mark.parametrize("name", scenes.names())
def test_spec_fields_and_background(standins, name):
    """Camera, size, name, golden and queue caps equal; the background
    equal on a uv grid (the port's on torch tensors)."""
    js, ts = scenes.load(name), tscenes.load(name)
    assert (ts.size, ts.name, ts.golden, ts.queue_caps) == (
        js.size, js.name, js.golden, js.queue_caps)
    for f in ("eye", "center", "up", "fovy"):
        np.testing.assert_array_equal(np.asarray(getattr(ts.camera, f), np.float64),
                                      np.asarray(getattr(js.camera, f), np.float64), err_msg=f)
    uv = _uv_grid()
    np.testing.assert_array_equal(ts.background(torch.from_numpy(uv)).numpy(),
                                  np.asarray(js.background(jnp.asarray(uv))))


@pytest.mark.parametrize("name, missing", [("texture-mapping", "earth_cube.png"),
                                           ("cube-mapping", "earth_cube.png"),
                                           ("graphics-castle", "shrub.png"),
                                           ("monkeys-making-monkeys", "cpu_cubemap.png")])
def test_fallback_for_a_missing_optional_file(tmp_path, monkeypatch, name, missing):
    """The programs' own stand-ins for an absent optional image (the
    earth cube map tiled from earth.jpg, the procedural shrub and computer
    case) are the JAX package's, texels included."""
    write_standins(tmp_path, seed=1)
    os.remove(tmp_path / missing)
    _point_at(monkeypatch, tmp_path)
    js = P.flatten_scene(scenes.load(name).scene, dtype=jnp.float32)
    ts = T.flatten_scene(tscenes.load(name).scene, "cpu")
    assert_tables_equal(js, ts)
    try:
        write_standins(tmp_path, seed=1)   # with the file: another atlas
        with_file = T.flatten_scene(tscenes.load(name).scene, "cpu")
        assert not torch.equal(with_file.tex_data, ts.tex_data)
    finally:
        _clear_jax_caches()


def test_a_missing_asset_raises_naming_it(tmp_path, monkeypatch):
    write_standins(tmp_path, seed=0)
    os.remove(tmp_path / "robot-alarm-clock" / "robot_torso.obj")
    os.remove(tmp_path / "Rock_033_normal_2.jpg")
    _point_at(monkeypatch, tmp_path)
    for pkg in (scenes, tscenes):
        with pytest.raises(FileNotFoundError, match="robot_torso.obj"):
            pkg.load("robot-alarm-clock")
        with pytest.raises(FileNotFoundError, match="Rock_033_normal_2.jpg"):
            pkg.load("normal-mapping")
    _clear_jax_caches()


SELF_GOLDEN_ASSET_SCENES = ["fish", "hier", "instance", "macho-cows", "monkeys-making-monkeys",
                            "nonhier", "nonhier2", "simple-cows", "graphics-poster",
                            "graphics-temple", "graphics-castle"]


@pytest.mark.golden
@pytest.mark.parametrize("name", SELF_GOLDEN_ASSET_SCENES)
def test_self_golden_asset_scenes(monkeypatch, name):
    """The port against the JAX package's self-goldens of the scenes that
    load assets, rendered as tools/gen_self_goldens.py renders them, from
    the JAX package's asset folder: skipped, naming the file, while the
    assets are absent."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from tools import gen_self_goldens as gen

    assert set(SELF_GOLDEN_ASSET_SCENES) <= set(gen.SCENES)
    monkeypatch.setenv("PORTRAYER_ASSETS", JAX_ASSETS)
    try:
        spec = tscenes.load(name)
    except FileNotFoundError as e:
        pytest.skip(f"{name}: missing asset {e.filename}")
    w = min(max(32, int(spec.size[0] * gen.SCALE)), gen.WIDTH_CAPS.get(name, gen.MAX_W))
    h = max(32, int(spec.size[1] * w / spec.size[0]))
    cfg = T.RenderConfig(device="cpu", samples=gen.SAMPLES_OVERRIDE.get(name, gen.SAMPLES),
                         tile=(64, 64), accel="beam", seed=0, queue_caps=spec.queue_caps)
    ours = T.render_u8(spec.scene, spec.camera, (w, h), spec.background, cfg)
    gold = image_io.read_png(os.path.join(GOLDEN, f"{name}.png"))
    assert_self_golden_rule(ours, gold)


def test_run_all_examples_on_the_cpu(standins, tmp_path, capsys):
    """The runner's entry point on two scenes: one PNG each at the scaled
    size (at least 16 pixels a side), timings.json with every scene."""
    out = tmp_path / "out"
    results = run_all_examples.main(["--only", "simple,fish", "--scale", "0.05", "--samples",
                                     "1", "--device", "cpu", "--out", str(out)])
    assert list(results) == ["simple", "fish"]
    assert json.loads((out / "timings.json").read_text()) == results
    for name, size in (("simple", (16, 16)), ("fish", (45, 25))):
        img = image_io.read_png(out / f"{name}.png")
        assert img.shape == (size[1], size[0], 3) and img.max() > 0
        assert results[name]["size"] == list(size)
        assert results[name]["graphs"] == 0 and results[name]["dropped_w"] == 0.0
    assert "fish" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        run_all_examples.main(["--accel", "pallas"])
