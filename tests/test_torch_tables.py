"""The port's scene lowering produces the JAX package's tables array for
array, texture atlases included; tables_from_numpy carries the JAX tables
across unchanged."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import scenes
import portrayer_tpu as P
from portrayer_tpu.scene.flatten import node_record as jax_node_record
import portrayer_tpu_torch as T
from portrayer_tpu_torch import scenes as tscenes
from portrayer_tpu_torch.scene.flatten import (
    TABLE_FIELDS, PACKED_FIELDS, PACKED_KIND_NAMES, tables_from_numpy,
)

from _torch_jax import INLINE, checker, jax_arrays


def _assert_tables_equal(js, ts):
    for f in TABLE_FIELDS:
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in PACKED_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(js.packed, f)),
                                      getattr(ts.packed, f).numpy(), err_msg=f)
    assert ts.groups == js.groups
    assert ts.packed.kind_ranges == js.packed.kind_ranges
    assert ts.packed.n_chunks == js.packed.n_chunks
    for f in ("n_lights", "area_flags", "any_reflective", "any_refractive", "any_glossy",
              "any_image_tex", "any_normal_map"):
        assert getattr(ts, f) == getattr(js, f), f
    assert len(ts.fn_textures) == len(js.fn_textures)
    np.testing.assert_array_equal(np.asarray(jax_node_record(js)), ts.rec.numpy())


NAMES = ["simple", "big-scene", "torus-showcase", "glossy-reflection", "primitives-simple",
         "single-triangle", "four-shapes"]


@pytest.mark.parametrize("name", NAMES)
def test_lowering_equals_flatten_scene(name):
    js = P.flatten_scene(scenes.load(name).scene, dtype=jnp.float32)
    ts = T.flatten_scene(tscenes.load(name).scene, "cpu")
    _assert_tables_equal(js, ts)


def test_big_scene_kind_runs():
    """big-scene drives four sweep branches: sphere_w, cube_g, cone_g,
    cylinder_g, in 9 chunks."""
    ts = T.flatten_scene(tscenes.load("big-scene").scene, "cpu")
    assert ts.packed.kind_ranges == ((7, 0, 2), (2, 2, 3), (3, 5, 2), (4, 7, 2))
    assert ts.n_lights == 3 and not ts.any_reflective


@pytest.mark.parametrize("name", NAMES)
def test_tables_from_numpy_round_trip(name):
    js = P.flatten_scene(scenes.load(name).scene, dtype=jnp.float32)
    arrays, meta = jax_arrays(js)
    ts = tables_from_numpy(arrays, meta, "cpu")
    _assert_tables_equal(js, ts)
    assert ts.device == torch.device("cpu")


def _one(prim, rotate=True, scale=(1.0, 2.0, 3.0)):
    """(port scene, JAX scene) of one primitive `prim` ("Sphere", ...,
    "Torus") under the same transform."""
    out = []
    for pkg in (T, P):
        p = getattr(pkg, prim)(1.0, 0.25) if prim == "Torus" else getattr(pkg, prim)()
        node = pkg.SceneNode(pkg.Geometry(p, pkg.Material(diffuse=(1.0, 1.0, 1.0)))).scaled(scale)
        if rotate:
            node.rotated_x(0.3)
        out.append(pkg.Scene(pkg.SceneNode([node]), [pkg.Light()], (0.1, 0.1, 0.1)))
    return out


@pytest.mark.parametrize("scene, kind", [
    (_one("Sphere"), "sphere_g"),
    (_one("Plane"), "plane_g"),
    (_one("Torus"), "torus_g"),
    (_one("Cube", rotate=False, scale=2.0), "aabox"),
])
def test_unported_kinds_raise(scene, kind):
    """Each of these packed kinds was refused before its sweep branch was
    ported; now it lowers, to the JAX package's tables, in a chunk of its
    kind."""
    tscene, jscene = scene
    ts = T.flatten_scene(tscene, "cpu")
    _assert_tables_equal(P.flatten_scene(jscene, dtype=jnp.float32), ts)
    kinds = [PACKED_KIND_NAMES[k] for k, _, _ in ts.packed.kind_ranges]
    assert kinds == [kind]


def test_unported_tri_w_raises_through_bridge():
    """A tri_w table was refused before its sweep branch was ported; now
    single-triangle's JAX tables cross the bridge unchanged, triangle soup,
    pair lists and the tri_w chunk included."""
    js = P.flatten_scene(scenes.load("single-triangle").scene, dtype=jnp.float32)
    ts = tables_from_numpy(*jax_arrays(js), "cpu")
    _assert_tables_equal(js, ts)
    assert [PACKED_KIND_NAMES[k] for k, _, _ in ts.packed.kind_ranges] == ["tri_w"]
    assert ts.n_pairs == 1 and ts.mesh_range.tolist() == [[0, 1]]


def test_textures_lower_as_jax():
    """Textures and normal maps were refused; now a scene with both lowers
    to the JAX package's tables: image and procedural texture codes (-(i+2)
    for the i-th procedural), normal-map codes, each image and map once in
    its atlas however many materials share it, and the uv transform."""
    ts = T.flatten_scene(INLINE["normal-mapping-numpy"](T)[0], "cpu")
    js = P.flatten_scene(INLINE["normal-mapping-numpy"](P)[0], dtype=jnp.float32)
    _assert_tables_equal(js, ts)
    assert ts.mat_tex_id.tolist() == js.mat_tex_id.tolist()
    assert sorted(ts.mat_tex_id.tolist()) == [-2, 0, 0, 1, 1, 2, 2]
    assert sorted(ts.mat_normal_map_id.tolist()) == [-1, -1, -1, -1, 0, 1, 2]
    # 64x64 plane and sphere images, a 64x48 cube map.
    assert ts.tex_meta.tolist() == ts.nm_meta.tolist() == [[0, 64, 64], [4096, 64, 64],
                                                            [8192, 64, 48]]
    assert ts.tex_data.dtype == torch.uint8 and ts.tex_data.shape == (11264, 3)
    assert ts.fn_textures == (checker(T),)
    assert 20.0 in ts.mat_uv_trans.numpy()


def test_tables_without_textures_carry_empty_atlases():
    """One zero texel and one zero meta row, as the JAX package's."""
    ts = T.flatten_scene(tscenes.load("simple").scene, "cpu")
    assert ts.tex_data.tolist() == ts.nm_data.tolist() == [[0, 0, 0]]
    assert ts.tex_meta.tolist() == ts.nm_meta.tolist() == [[0, 0, 0]]
    assert not ts.any_image_tex and not ts.any_normal_map and ts.fn_textures == ()
