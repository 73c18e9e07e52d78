"""Helpers shared by the tests that hold the PyTorch port against the JAX
package: carrying JAX tables across, and the JAX package's kernel gates."""

import numpy as np

from portrayer_tpu_torch.scene.flatten import TABLE_FIELDS, PACKED_FIELDS, META_FIELDS, TORUS


def jax_arrays(st):
    """({field: numpy array}, meta) of a JAX SceneTables, the input of
    portrayer_tpu_torch.tables_from_numpy."""
    arrays = {f: np.asarray(getattr(st, f)) for f in TABLE_FIELDS}
    arrays.update({f"packed.{f}": np.asarray(getattr(st.packed, f)) for f in PACKED_FIELDS})
    meta = {f: getattr(st, f) for f in META_FIELDS if hasattr(st, f)}
    meta.update(kind_ranges=st.packed.kind_ranges, n_chunks=st.packed.n_chunks)
    return arrays, meta


# A ray that re-hits the node it left does so near-tangentially, just past
# the self-eps raise: the root is ill-conditioned there, and the JAX
# package's own flat sweep and Pallas kernel differ by up to 2e-3 relative
# t on such rays (big-scene shadow rays).  Everywhere else the kernel
# gate's rtol 1e-4 holds.
SELF_HIT_RTOL = 5e-3

# Torus roots come out of an f32 quartic solve (Ferrari, cube roots, an
# arccos, Newton polish) whose rounding differs between the packages: the
# JAX package's own gate for them (tests/test_torus.py) is rtol 1e-3 /
# atol 1e-3 on t.
TORUS_TOL = 1e-3


def torus_nodes(st):
    """Node ids of the torus group of SceneTables `st` (JAX or port)."""
    return [i for kind, start, count in st.groups if kind == TORUS
            for i in range(start, start + count)]


def assert_gates(ref, got, src_node=None, torus=()):
    """The kernel gates of tests/test_pallas.py: .hit equal; node
    mismatches on at most 0.2% of hits and only within 2*2^-16 relative t;
    elsewhere tri equal and t within rtol 1e-4 / atol 1e-5 (SELF_HIT_RTOL
    on re-hits of the ray's own src_node, TORUS_TOL on hits of the node
    ids in `torus`)."""
    rh, gh = np.asarray(ref.hit), np.asarray(got.hit)
    np.testing.assert_array_equal(rh, gh)
    rn, gn = np.asarray(ref.node)[rh], np.asarray(got.node)[rh]
    rt, gt = np.asarray(ref.t)[rh], np.asarray(got.t)[rh]
    mism = rn != gn
    assert mism.sum() <= 0.002 * max(mism.size, 1), f"{mism.sum()} node mismatches"
    np.testing.assert_array_equal(np.asarray(ref.tri)[rh][~mism],
                                  np.asarray(got.tri)[rh][~mism])
    self_hit = np.zeros_like(mism)
    if src_node is not None:
        self_hit = rn == np.asarray(src_node)[rh]
    on_torus = np.isin(rn, np.asarray(torus, dtype=np.int64))
    plain = ~mism & ~self_hit & ~on_torus
    np.testing.assert_allclose(gt[plain], rt[plain], rtol=1e-4, atol=1e-5)
    sh = self_hit & ~mism & ~on_torus
    np.testing.assert_allclose(gt[sh], rt[sh], rtol=SELF_HIT_RTOL, atol=1e-5)
    tor = on_torus & ~mism
    np.testing.assert_allclose(gt[tor], rt[tor], rtol=TORUS_TOL, atol=TORUS_TOL)
    if mism.any():
        quantum = 2.0 ** -16 * np.maximum(np.abs(rt[mism]), np.abs(gt[mism]))
        quantum = np.where(on_torus[mism], TORUS_TOL * np.abs(rt[mism]), quantum)
        assert (np.abs(gt[mism] - rt[mism]) <= 2.0 * quantum + 1e-5).all(), (
            "node-mismatched rays outside the tie quantum")


# ---------------------------------------------------------------------------
# Inline scenes, built with either package's classes (`pkg` is
# portrayer_tpu or portrayer_tpu_torch): (scene, camera settings, size).
# ---------------------------------------------------------------------------

def ellipsoids(pkg):
    """Non-uniformly scaled, rotated spheres (packed as sphere_g), one of
    them a mirror, over a floor plane."""
    mat = pkg.Material(diffuse=(0.5, 0.5, 0.5), specular=(0.3, 0.3, 0.3), shininess=20.0)
    mirror = pkg.Material(diffuse=(0.2, 0.3, 0.5), specular=(0.5, 0.5, 0.5), shininess=30.0,
                          reflectivity=0.5)
    nodes = [
        pkg.SceneNode(pkg.Geometry(pkg.Sphere(), mirror if i == 2 else mat))
        .scaled((1.0 + 0.5 * (i % 3), 2.0 - 0.25 * i, 0.8 + 0.3 * i))
        .rotated_y(0.4 * i).translated((3.0 * i - 6.0, 0.0, -2.0 * i))
        for i in range(5)
    ]
    nodes.append(pkg.SceneNode(pkg.Geometry(pkg.Plane(), mat)).scaled(40.0)
                 .translated((0.0, -2.0, 0.0)))
    scene = pkg.Scene(pkg.SceneNode(nodes),
                      [pkg.Light(position=(0.0, 10.0, 10.0), color=(1.0, 1.0, 1.0))],
                      (0.2, 0.2, 0.2))
    cam = pkg.CameraSettings(eye=(0.0, 3.0, 14.0), center=(0.0, 0.0, -4.0), fovy=0.8)
    return scene, cam, (256, 256)


def glass_sphere(pkg):
    """A refractive sphere (index 1.5) before a red sphere on a floor
    plane: reflect and refract children, total internal reflection."""
    glass = pkg.Material(diffuse=(0.05, 0.05, 0.05), specular=(0.9, 0.9, 0.9), shininess=80.0,
                         reflectivity=0.9, refraction_index=1.5)
    red = pkg.Material(diffuse=(0.8, 0.1, 0.1), specular=(0.3, 0.3, 0.3), shininess=25.0)
    floor = pkg.Material(diffuse=(0.4, 0.4, 0.45), specular=(0.2, 0.2, 0.2), shininess=10.0)
    scene = pkg.Scene(pkg.SceneNode([
        pkg.SceneNode(pkg.Geometry(pkg.Sphere(), glass)).scaled(1.2).translated((0.0, 1.2, 0.0)),
        pkg.SceneNode(pkg.Geometry(pkg.Sphere(), red)).translated((1.0, 1.0, -3.0)),
        pkg.SceneNode(pkg.Geometry(pkg.Plane(), floor)).scaled(30.0),
    ]), [pkg.Light(position=(-4.0, 8.0, 6.0), color=(0.9, 0.9, 0.9))], (0.3, 0.3, 0.3))
    cam = pkg.CameraSettings(eye=(0.0, 2.5, 7.0), center=(0.0, 1.0, 0.0), fovy=0.9)
    return scene, cam, (64, 64)


INLINE = {"ellipsoids": ellipsoids, "glass-sphere": glass_sphere}
