"""``packing="morton"``: the port's packed table sorted by the Morton codes
of its boxes' centres, against the JAX package's
``flatten_scene(..., packing="morton")``, and a render on such tables
against the same render on the default SAH tables.

Tolerances, with their reasons:
- the order and the tables: equal array for array (tests/_torch_jax.py
  assert_tables_equal, the table test's rule): the packing is numpy in
  float64 on both sides.  The JAX package takes its native helper's
  Morton order when ``native/libportrayer_native.so`` loads, a bit-exact
  mirror of its numpy path (native/portrayer_native.cpp:205-244); both
  are held here.
- a render through the plain version of the sweep kernel on Morton tables
  against the same render on SAH tables: test_torch_render.py's gate
  (at most 1% of pixels off by more than 1e-4, none by 2e-2).  The tables
  hold the same primitives in another order; only ties between equal t
  could pick another winner.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import scenes
import portrayer_tpu as P
import portrayer_tpu.scene.flatten as jflatten
import portrayer_tpu_torch as T
from portrayer_tpu_torch import scenes as tscenes
from portrayer_tpu_torch.ops import cuda_intersect
from portrayer_tpu_torch.scene import flatten as tflatten

from _torch_assets import write_standins
from _torch_jax import INLINE, assert_tables_equal
from test_torch_render import assert_images_close
from test_torch_scenes import _clear_jax_caches, _point_at


def _registered(pkg, name):
    spec = (scenes if pkg is P else tscenes).load(name)
    return spec.scene, spec.camera


SCENES = {
    "big-scene": lambda pkg: _registered(pkg, "big-scene"),
    "procedural-meshes": lambda pkg: INLINE["procedural-meshes"](pkg)[:2],
    "instance": lambda pkg: _registered(pkg, "instance"),
}


@pytest.fixture(scope="module")
def standins(tmp_path_factory):
    """Both packages read the stand-in assets (for the instanced program)."""
    directory = tmp_path_factory.mktemp("assets")
    write_standins(directory, seed=0)
    with pytest.MonkeyPatch.context() as mp:
        _point_at(mp, directory)
        yield directory
    _clear_jax_caches()


@pytest.mark.parametrize("name", list(SCENES))
def test_morton_tables_equal_jax(standins, name):
    """The port's Morton tables equal the JAX package's, and differ from
    the SAH tables in their order (the packing is really applied)."""
    js = P.flatten_scene(SCENES[name](P)[0], dtype=jnp.float32, packing="morton")
    ts = T.flatten_scene(SCENES[name](T)[0], "cpu", packing="morton")
    assert_tables_equal(js, ts)
    sah = T.flatten_scene(SCENES[name](T)[0], "cpu")
    assert sah.packed.n_chunks == ts.packed.n_chunks
    assert sah.packed.kind_ranges == ts.packed.kind_ranges
    assert not torch.equal(sah.packed.ids, ts.packed.ids)


@pytest.mark.parametrize("n", [0, 1, 2, 7, 1000])
def test_morton_order_equals_jax_numpy_and_native(monkeypatch, n):
    """_morton_order on seeded boxes (ties in the quantised codes among
    them) equals the JAX package's, through its native helper and through
    its numpy path."""
    rng = np.random.default_rng(n)
    lo = np.round(rng.normal(size=(n, 3)) * 4.0, 1)
    hi = lo + rng.uniform(0.0, 0.5, size=(n, 3))
    got = tflatten._morton_order(lo, hi)
    np.testing.assert_array_equal(got, jflatten._morton_order(lo, hi))
    monkeypatch.setattr(P.native, "morton_order", lambda amin, amax: None)
    np.testing.assert_array_equal(got, jflatten._morton_order(lo, hi))
    assert sorted(got.tolist()) == list(range(n))


def test_unknown_packing_raises():
    with pytest.raises(ValueError, match="packing='hilbert'"):
        T.flatten_scene(tscenes.load("simple").scene, "cpu", packing="hilbert")


@pytest.mark.parametrize("name,size", [("big-scene", (48, 24)), ("procedural-meshes", (32, 32))])
def test_morton_render_matches_sah(name, size):
    """A 2-spp frame through the plain version of the sweep kernel
    (accel="cuda" on the CPU) on Morton tables against SAH tables: the
    render gate.  The kernel's two-level cull reads PackedPrims.groups,
    built from the chunk boxes of either order: every group box holds its
    chunks' boxes."""
    scene, cam = SCENES[name](T)
    cfg = T.RenderConfig(device="cpu", accel="cuda", samples=2, tile=(32, 32), seed=0)
    imgs = {}
    for packing in ("sah", "morton"):
        st = T.flatten_scene(scene, "cpu", packing=packing)
        gmin, gmax, _ = cuda_intersect.chunk_groups(st.packed)
        n = st.packed.n_chunks
        for g in range(gmin.shape[0]):
            cmin = st.packed.chunk_min[32 * g:min(32 * g + 32, n)]
            cmax = st.packed.chunk_max[32 * g:min(32 * g + 32, n)]
            real = cmin[:, 0] <= cmax[:, 0]
            assert (gmin[g] <= cmin[real]).all() and (gmax[g] >= cmax[real]).all()
        imgs[packing] = T.render_linear(st, cam, size, cfg=cfg)
    assert np.isfinite(imgs["morton"]).all() and imgs["sah"].max() > 0
    assert_images_close(imgs["morton"], imgs["sah"])
