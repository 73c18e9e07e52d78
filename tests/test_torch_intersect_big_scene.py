"""test_torch_intersect.py's big-scene cases, the longest, in a file of
their own so that the test run spreads them over its workers: the flat
sweep, the sweep's plain version against the Pallas kernel and against
the flat sweep, the beam sweep, and sweeps_apart with its float64
witness.  Tolerances as in test_torch_intersect.py."""

import numpy as np
import pytest
import torch

import portrayer_tpu_torch as T
from portrayer_tpu_torch import scenes as tscenes
from portrayer_tpu_torch.ops import intersect as tx
from portrayer_tpu_torch.ops.cuda_intersect import intersect_scene_sweep_ref

import test_torch_intersect as base
from _torch_jax import float64_tables, sweeps_apart

INF, T_FLAT, T_SWEEP = base.INF, base.T_FLAT, base.T_SWEEP


@pytest.mark.parametrize("name", ["big-scene"])
def test_flat_sweep_and_occluded_match_jax(name):
    """As in test_torch_intersect.py."""
    base.test_flat_sweep_and_occluded_match_jax(name)


@pytest.mark.parametrize("name", ["big-scene"])
def test_sweep_plain_version_matches_pallas_kernel(name):
    """As in test_torch_intersect.py."""
    base.test_sweep_plain_version_matches_pallas_kernel(name)


@pytest.mark.parametrize("name", ["big-scene"])
def test_sweep_plain_version_matches_port_flat(name):
    """As in test_torch_intersect.py."""
    base.test_sweep_plain_version_matches_port_flat(name)


@pytest.mark.parametrize("name, scattered", [("big-scene", False), ("big-scene", True)])
def test_beam_matches_jax_beam_and_port_flat(name, scattered):
    """As in test_torch_intersect.py."""
    base.test_beam_matches_jax_beam_and_port_flat(name, scattered)


def test_sweeps_apart_sorts_partings_and_its_float64_witness_holds_on_big_scene():
    """sweeps_apart (tests/_torch_jax.py), with which the card holds the
    kernel against the beam sweep.  Its witness's premise: in float64, on
    unit directions, the kernel's formulas (the plain version over the
    float64 packed table) and the flat sweep's give the same hits, t
    within rtol 1e-6 / atol 1e-9, on big-scene's camera rays and their
    shadow rays (with sources).  Partings made by hand land in their
    categories, one each."""
    from portrayer_tpu_torch.camera import Camera

    spec = tscenes.load("big-scene")
    st = T.flatten_scene(spec.scene, "cpu")
    st64 = float64_tables(spec.scene, "cpu")
    w, h = spec.size
    gen = np.random.default_rng(3)
    o, d = Camera(spec.camera, spec.size, "cpu").rays_at(
        torch.tensor(gen.uniform(0, w, 1024), dtype=torch.float32),
        torch.tensor(gen.uniform(0, h, 1024), dtype=torch.float32))
    flat = tx.intersect_scene(o, d, 1e-5, INF, st, T_FLAT)
    p = o + torch.where(flat.hit, flat.t, 0.0)[:, None] * d
    sd = st.light_pos[torch.arange(1024) % st.n_lights] - p
    sd = sd / torch.linalg.vector_norm(sd, dim=1, keepdim=True)
    skw = dict(active=flat.hit, src_node=flat.node, src_tri=flat.tri)
    f64 = T.RenderConfig(device="cpu", accel="flat", dtype=torch.float64)
    for ro, rd, t_min, kw in ((o, d, 1e-5, {}), (p, sd, 1e-3, skw)):
        o64, d64 = ro.double(), rd.double()
        d64 = d64 / torch.linalg.vector_norm(d64, dim=1, keepdim=True)
        kp = intersect_scene_sweep_ref(o64, d64, t_min, INF, st64, T_SWEEP, **kw)
        fl = tx.intersect_scene(o64, d64, t_min, INF, st64, f64, **kw)
        assert kp.t.dtype == torch.float64 and fl.hit.float().mean() > 0.2
        assert torch.equal(kp.hit, fl.hit)
        torch.testing.assert_close(kp.t[fl.hit], fl.t[fl.hit], rtol=1e-6, atol=1e-9)

    kern = intersect_scene_sweep_ref(o, d, 1e-5, INF, st, T_SWEEP)
    assert sweeps_apart(kern, flat, o, d, 1e-5, {}, st64, T_SWEEP)["uncleared"] == 0
    hits = torch.nonzero(kern.hit).squeeze(1)[:4].tolist()
    t, node, hit = kern.t.clone(), kern.node.clone(), kern.hit.clone()
    hit[hits[0]] = False
    node[hits[1]] = node[hits[1]] + 1
    t[hits[1]] *= 1.01
    t[hits[2]] *= 1.001
    node[hits[3]] = node[hits[3]] + 1
    got = kern._replace(t=t, node=node, hit=hit)
    out = sweeps_apart(kern, got, o, d, 1e-5, {}, st64, T_SWEEP)
    assert {k: out[k] for k in ("hit", "node", "t", "self_t", "tie")} == dict(
        hit=1, node=1, t=1, self_t=0, tie=1)
    assert out["uncleared"] == 0 and sum(map(len, out["rays"].values())) == 3
    assert sum(sum(b.values()) for b in out["branches"].values()) == 3
