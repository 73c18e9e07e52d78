"""The sweep kernel's two-level cull, on the CPU: ``PackedPrims.groups``
(``chunk_groups``: the boxes of groups of 32 consecutive chunks and each
chunk's real lanes), derived from the packed table alone, on tables the
port lowers and on tables carried across from the JAX package by
``tables_from_numpy``.

The kernel sweeps a chunk only inside a group whose box its ray crosses,
so it agrees with the plain version (and the one-level cull of the TPU
kernel's prologue) only if the group test passes whenever a member's test
passes.  That is checked here on seeded random rays, rays parallel to an
axis, origins on box faces and finite t_max cuts, in exact f32 ops: no
tolerance.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import scenes
import portrayer_tpu as P
import portrayer_tpu_torch as T
from portrayer_tpu_torch import scenes as tscenes
from portrayer_tpu_torch.ops import cuda_intersect as ci
from portrayer_tpu_torch.scene.flatten import PACK_CHUNK

from _torch_jax import jax_arrays, INLINE

# (name, source): "port" lowers the scene with the port, "jax" carries the
# JAX package's tables across.
TABLES = [("big-scene", "port"), ("torus-showcase", "port"), ("procedural-meshes", "port"),
          ("procedural-meshes-groups", "port"), ("big-scene", "jax"),
          ("procedural-meshes-groups", "jax")]
_cache = {}


def tables(name, source):
    if (name, source) not in _cache:
        pkg, registry = (T, tscenes) if source == "port" else (P, scenes)
        scene = INLINE[name](pkg)[0] if name in INLINE else registry.load(name).scene
        if source == "port":
            st = T.flatten_scene(scene, "cpu")
        else:
            st = T.tables_from_numpy(*jax_arrays(P.flatten_scene(scene, dtype=jnp.float32)),
                                     "cpu")
        _cache[name, source] = st
    return _cache[name, source]


def _ids(params):
    return [f"{n}-{s}" for n, s in params]


@pytest.mark.parametrize("name,source", TABLES, ids=_ids(TABLES))
def test_group_boxes_hold_their_members_exactly(name, source):
    pk = tables(name, source).packed
    g = pk.groups
    assert g.n_groups == -(-pk.n_chunks // ci.GROUP)
    assert g.box_min.dtype == g.box_max.dtype == torch.float32
    for gi in range(g.n_groups):
        members = slice(gi * ci.GROUP, min((gi + 1) * ci.GROUP, pk.n_chunks))
        cmin, cmax = pk.chunk_min[members], pk.chunk_max[members]
        assert (g.box_min[gi] <= cmin).all() and (g.box_max[gi] >= cmax).all()
        # Exact: each coordinate is one of its members' own, no arithmetic.
        assert ((cmin == g.box_min[gi]).any(dim=0)).all()
        assert ((cmax == g.box_max[gi]).any(dim=0)).all()


@pytest.mark.parametrize("name,source", TABLES, ids=_ids(TABLES))
def test_real_lanes_are_a_counted_prefix(name, source):
    pk = tables(name, source).packed
    real = pk.groups.real_lanes
    assert real.dtype == torch.int32 and real.shape == (pk.n_chunks,)
    node = pk.ids[0].reshape(pk.n_chunks, PACK_CHUNK)
    assert torch.equal(real, (node >= 0).sum(dim=1).to(torch.int32))
    lane = torch.arange(PACK_CHUNK)[None, :]
    assert torch.equal(node >= 0, lane < real[:, None])
    assert (real > 0).all()


def _rays(pk, seed):
    """(o, d, t_min, t_max) [R]: random rays around the table's boxes,
    rays parallel to an axis (exactly, and with components under the 1e-30
    reciprocal guard), origins on chunk and group box faces, and finite
    t_max cuts around the boxes' entry distances."""
    g = np.random.default_rng(seed)
    groups = pk.groups
    bmin = torch.cat([pk.chunk_min, groups.box_min]).numpy().astype(np.float64)
    bmax = torch.cat([pk.chunk_max, groups.box_max]).numpy().astype(np.float64)
    lo, hi = bmin.min(axis=0), bmax.max(axis=0)
    span = hi - lo
    n = 1024
    o = [g.uniform(lo - 0.5 * span, hi + 0.5 * span, (n, 3))]
    d = [g.standard_normal((n, 3))]
    # Parallel to an axis: the other components exactly 0, or below 1e-30.
    axis_d = np.zeros((n, 3))
    axis_d[np.arange(n), g.integers(0, 3, n)] = g.choice([-1.0, 1.0], n)
    axis_d += np.where(axis_d == 0.0, g.choice([0.0, 1e-31, -1e-31, 1e-38], (n, 3)), 0.0)
    o.append(g.uniform(lo - 0.5 * span, hi + 0.5 * span, (n, 3)))
    d.append(axis_d)
    # Origins on a face of a chunk or group box, aimed across it or along it.
    box = g.integers(0, bmin.shape[0], n)
    face_o = g.uniform(bmin[box], bmax[box])
    ax = g.integers(0, 3, n)
    side = g.integers(0, 2, n)
    face_o[np.arange(n), ax] = np.where(side == 0, bmin[box, ax], bmax[box, ax])
    face_d = g.standard_normal((n, 3))
    along = g.random(n) < 0.3
    face_d[np.arange(n)[along], ax[along]] = 0.0
    o.append(face_o)
    d.append(face_d)
    o = np.concatenate(o).astype(np.float32)
    d = np.concatenate(d)
    d = (d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-38)).astype(np.float32)
    R = o.shape[0]
    t_min = np.where(g.random(R) < 0.8, 1e-5, g.uniform(0.0, span.max(), R)).astype(np.float32)
    # Finite cuts on half the rays, from short of the nearest box to beyond.
    t_max = np.where(g.random(R) < 0.5, np.inf,
                     t_min + g.exponential(0.3 * span.max(), R)).astype(np.float32)
    return tuple(torch.from_numpy(x) for x in (o, d, t_min, t_max))


@pytest.mark.parametrize("name,source", TABLES, ids=_ids(TABLES))
def test_group_passes_whenever_a_member_passes(name, source):
    pk = tables(name, source).packed
    groups = pk.groups
    o, d, t_min, t_max = _rays(pk, seed=TABLES.index((name, source)))
    rcp = ci._safe_rcp(d)
    active = torch.ones(o.shape[0], dtype=torch.bool)
    chunk = ci._cull(o, rcp, t_min, t_max, active, pk.chunk_min, pk.chunk_max)
    group = ci._cull(o, rcp, t_min, t_max, active, groups.box_min, groups.box_max)
    member_of = torch.arange(pk.n_chunks) // ci.GROUP
    assert not (chunk & ~group[:, member_of]).any()
    assert chunk.any() and (~chunk).any()
    if groups.n_groups > 1:  # the group level culls some chunk tests
        assert (~group).any()


def test_chunk_groups_are_derived_once_per_table():
    st = tables("procedural-meshes-groups", "port")
    first = st.packed.groups
    assert st.packed.groups is first
    other = T.flatten_scene(INLINE["procedural-meshes-groups"](T)[0], "cpu")
    again = other.packed.groups
    assert again is not first
    for derived in (again, ci.chunk_groups(st.packed)):
        assert all(torch.equal(a, b) for a, b in zip(derived, first))
