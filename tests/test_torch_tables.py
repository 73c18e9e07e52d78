"""The port's scene lowering produces the JAX package's tables array for
array, texture atlases included, in float32 and in the float64 check mode;
tables_from_numpy carries the JAX tables across unchanged; the
bounding-volume debug lowering makes the JAX package's scene."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import scenes
import portrayer_tpu as P
import portrayer_tpu_torch as T
from portrayer_tpu_torch import scenes as tscenes
from portrayer_tpu_torch.scene.flatten import (
    TABLE_FIELDS, PACKED_KIND_NAMES, MESH, CUBE, tables_from_numpy,
)

from _torch_jax import INLINE, assert_tables_equal, checker, jax_arrays


NAMES = ["simple", "big-scene", "torus-showcase", "glossy-reflection", "primitives-simple",
         "single-triangle", "four-shapes"]


@pytest.mark.parametrize("name", NAMES)
def test_lowering_equals_flatten_scene(name):
    js = P.flatten_scene(scenes.load(name).scene, dtype=jnp.float32)
    ts = T.flatten_scene(tscenes.load(name).scene, "cpu")
    assert_tables_equal(js, ts)


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
    assert_tables_equal(js, ts)
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
    assert_tables_equal(P.flatten_scene(jscene, dtype=jnp.float32), ts)
    kinds = [PACKED_KIND_NAMES[k] for k, _, _ in ts.packed.kind_ranges]
    assert kinds == [kind]


def test_unported_tri_w_raises_through_bridge():
    """A tri_w table was refused before its sweep branch was ported; now
    single-triangle's JAX tables cross the bridge unchanged, triangle soup,
    pair lists and the tri_w chunk included."""
    js = P.flatten_scene(scenes.load("single-triangle").scene, dtype=jnp.float32)
    ts = tables_from_numpy(*jax_arrays(js), "cpu")
    assert_tables_equal(js, ts)
    assert [PACKED_KIND_NAMES[k] for k, _, _ in ts.packed.kind_ranges] == ["tri_w"]
    assert ts.n_pairs == 1 and ts.mesh_range.tolist() == [[0, 1]]


def test_textures_lower_as_jax():
    """Textures and normal maps were refused; now a scene with both lowers
    to the JAX package's tables: image and procedural texture codes (-(i+2)
    for the i-th procedural), normal-map codes, each image and map once in
    its atlas however many materials share it, and the uv transform."""
    ts = T.flatten_scene(INLINE["normal-mapping-numpy"](T)[0], "cpu")
    js = P.flatten_scene(INLINE["normal-mapping-numpy"](P)[0], dtype=jnp.float32)
    assert_tables_equal(js, ts)
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


def test_float64_lowering_equals_jax_x64():
    """RenderConfig(dtype=float64)'s tables: every float table in float64,
    equal to the JAX package's under x64; the packed table, which only the
    float32 sweep kernel reads, stays float32."""
    import jax

    with jax.enable_x64(True):
        js = P.flatten_scene(scenes.load("four-shapes").scene, dtype=jnp.float64)
        ts = T.flatten_scene(tscenes.load("four-shapes").scene, "cpu", dtype=torch.float64)
        for f in TABLE_FIELDS:
            a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        np.testing.assert_array_equal(np.asarray(js.packed.f32, np.float32),
                                      ts.packed.f32.numpy())
    assert ts.inv.dtype == ts.rec.dtype == ts.trec.dtype == torch.float64
    assert ts.packed.f32.dtype == ts.packed.chunk_min.dtype == torch.float32


def _bv_scene(pkg):
    """procedural-meshes at its test size (two nodes sharing an icosphere's
    MeshData, a height field, a standalone triangle) and a flat quad mesh
    instanced twice through one shared subtree."""
    scene, cam, _ = INLINE["procedural-meshes"](pkg)
    quad = pkg.MeshData([(0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (1.0, 0.0, 1.0), (0.0, 0.0, 1.0)],
                        [(0, 1, 2), (0, 2, 3)])
    shared = pkg.SceneNode(pkg.Geometry(pkg.Mesh(quad), pkg.Material(diffuse=(0.5, 0.5, 0.5))))
    scene.root.children += [pkg.SceneNode(shared).translated((x, 1.0, -1.0))
                            for x in (-2.0, 1.0)]
    return scene, cam


def test_bounding_volume_scene_lowers_as_jax():
    """Each mesh becomes its local AABB as a cube of its material (the flat
    quad's with the EPSILON floor), instancing stays shared, and the input
    scene is unchanged: the same tables as the JAX package's lowering."""
    from portrayer_tpu.scene.node import bounding_volume_scene as jax_bv
    from portrayer_tpu_torch.scene.node import bounding_volume_scene

    scene, _ = _bv_scene(T)
    before = T.flatten_scene(scene, "cpu")
    boxed = bounding_volume_scene(scene)
    ts = T.flatten_scene(boxed, "cpu")
    assert_tables_equal(P.flatten_scene(jax_bv(_bv_scene(P)[0]), dtype=jnp.float32), ts)
    # Left as a triangle: the standalone one, a pair of its own.
    counts = dict((k, n) for k, _, n in ts.groups)
    assert ts.n_pairs == 1 and counts[MESH] == 1 and counts[CUBE] == 5
    a, b = boxed.root.children[-2:]
    assert a.children[0] is b.children[0]
    flat_box = a.children[0].children[0].trans
    assert flat_box[1, 1] == T.EPSILON
    assert_tables_equal(P.flatten_scene(_bv_scene(P)[0], dtype=jnp.float32), before)
    assert_tables_equal(P.flatten_scene(_bv_scene(P)[0], dtype=jnp.float32),
                         T.flatten_scene(scene, "cpu"))


def test_render_bounding_volumes_flag():
    """RenderConfig(render_bounding_volumes=True) renders the boxed scene
    when given a Scene (the same image, bit for bit), and tables as they
    are."""
    from portrayer_tpu_torch.scene.node import bounding_volume_scene

    scene, cam = _bv_scene(T)
    cfg = dict(device="cpu", samples=1, tile=(32, 32))
    flag = T.render_linear(scene, cam, (48, 32),
                           cfg=T.RenderConfig(render_bounding_volumes=True, **cfg))
    np.testing.assert_array_equal(
        flag, T.render_linear(bounding_volume_scene(scene), cam, (48, 32),
                              cfg=T.RenderConfig(**cfg)))
    plain = T.render_linear(scene, cam, (48, 32), cfg=T.RenderConfig(**cfg))
    assert np.abs(flag - plain).max() > 0.01
    np.testing.assert_array_equal(
        plain, T.render_linear(T.flatten_scene(scene, "cpu"), cam, (48, 32),
                               cfg=T.RenderConfig(render_bounding_volumes=True, **cfg)))
