"""The port's captured programs loop over the tail, on the CPU: the
bounce rounds of the tail of equal capacity (the last round aside) run as
one loop over a round index held on the device (graphs.loop, a CUDA graph
WHILE node on the card).  They are held against the JAX package's trace
with both its unroll_tail settings (False shares one lax.scan body over
the same tail, True unrolls it; the port has no such option), and against
the port's op-by-op programs, whose rounds are a Python loop.

The captured chunk program (render.py) and fit program (fit.py) are
driven through tests/_torch_jax.py's StandInGraph, whose loop reads its
condition on the host with the read excused (on the card the step kernel
evaluates it) and whose switch does the same for sel; everything else a
replay runs under HostReads.  One torch thread (tests/_torch_jax.py).

Scenes: glossy-reflection (ten bounce rounds of one capacity) on
test_torch_chunk_program.py's 48x32 frame in tiles of 16x16 and chunks of
4 spp; the inline glass sphere (tests/_torch_jax.py) on 32x32 rays, one
through each pixel centre, with queue_caps (1.0, 0.75, 0.125): rounds 1-2
unrolled, 3-9 the loop, 10 the last, and queues that overflow.

Tolerances, with their reasons:
- against the JAX package's jitted render_linear (accel="flat"):
  test_torch_render.py's image rule (at most 1% of pixels off by more than
  1e-4, none by more than 2e-2), for XLA's FMA contraction;
- against the JAX package's trace and jax.grad (accel="flat"):
  test_torch_fit.py's rtol 1e-3 / atol 1e-4 of the largest entry on the
  colours and gradients; live rays per round and dropped_w within rtol
  1e-4 (a ray whose hit moves with rounding moves a count);
- the captured programs against the op-by-op ones: equal bit for bit
  (the same ops on the same inputs, in one thread).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenes
import portrayer_tpu as P
from portrayer_tpu.camera import Camera as JaxCamera
from portrayer_tpu.ops.trace import trace as jax_trace
import portrayer_tpu_torch as T
from portrayer_tpu_torch import rng, scenes as tscenes
from portrayer_tpu_torch.ops import trace as tr
from portrayer_tpu_torch.parallel import DIFF_FIELDS

from _torch_jax import (glass_sphere, jax_arrays, recorded_bodies, recorded_loops,
                        stand_in_graphs)
from test_torch_render import assert_images_close

SIZE = (48, 32)
CFG = dict(samples=6, tile=(16, 16), max_rays_per_launch=1024, seed=0)
GLASS_CAPS = (1.0, 0.75, 0.25)
# Queues of 1,024, 768 and then 128 lanes for the glass sphere's 32x32
# rays: its 204 rays alive after round 1 overflow the tail's.
FIT_CAPS = (1.0, 0.75, 0.125)
GLASS_PX = 32
KEY = 0
BG = 0.3


@pytest.fixture
def stand_in(monkeypatch):
    return stand_in_graphs(monkeypatch)


# ---------------------------------------------------------------------------
# The tail's start
# ---------------------------------------------------------------------------

def _glass(px=GLASS_PX):
    """(JAX tables, numpy o, d [px*px, 3]) of the glass sphere, one ray
    through each pixel centre of a px x px frame."""
    scene, cam, (w, h) = glass_sphere(P)
    ys, xs = np.mgrid[0:px, 0:px]
    sx, sy = w / px, h / px
    o, d = JaxCamera(cam, (w, h)).rays_at(
        jnp.asarray((xs.reshape(-1) + 0.5) * sx, jnp.float32),
        jnp.asarray((ys.reshape(-1) + 0.5) * sy, jnp.float32))
    return P.flatten_scene(scene, dtype=jnp.float32), np.array(o), np.array(d)


def _scan_lengths(jaxpr):
    """The lengths of the scans at the top level of a jaxpr (those inside
    a round, the sweeps', are nested in its switch)."""
    return [e.params["length"] for e in jaxpr.eqns if e.primitive.name == "scan"]


@pytest.mark.parametrize("caps", [None, (1.0, 0.8, 0.6), (2.0,), GLASS_CAPS])
def test_tail_start_follows_the_jax_rule(caps):
    """ops.trace.tail_start against the JAX package's: the length of the
    lax.scan in its trace's program (the tail runs from tail_start to the
    last round).  The port loops over the tail but its last round, so a
    captured program unrolls rounds 1 .. tail_start - 1 and the last, and
    loops over the rest; op by op it unrolls them all."""
    js, o, d = _glass(8)
    n = o.shape[0]
    jcfg = P.RenderConfig(accel="flat", queue_caps=caps)
    jaxpr = jax.make_jaxpr(lambda o, d: jax_trace(
        jax.random.PRNGKey(KEY), o, d, jnp.arange(n, dtype=jnp.int32),
        jnp.full((n, 3), BG, jnp.float32), n, js, jcfg))(jnp.asarray(o), jnp.asarray(d))
    (length,) = _scan_lengths(jaxpr.jaxpr)
    ts = T.flatten_scene(glass_sphere(T)[0], "cpu")
    pl = tr.plan(n, ts, T.RenderConfig(device="cpu", queue_caps=caps))
    D = pl.max_depth
    assert tr.tail_start(pl) == D + 1 - length
    rounds = list(tr.rounds(pl, (16, 4, 1), loop=True))
    assert [rd.r for rd in rounds if rd.looped] == list(range(D + 1 - length, D))
    assert not any(rd.looped for rd in tr.rounds(pl, (16, 4, 1)))
    assert [rd.last for rd in rounds] == [False] * (D - 1) + [True]


# ---------------------------------------------------------------------------
# The chunk program
# ---------------------------------------------------------------------------

def _render(cfg, name="glossy-reflection", region=None, st=None):
    """(linear image, TraceStats of each chunk, the program) of `name`
    through render_linear."""
    spec = tscenes.load(name)
    st = st if st is not None else T.flatten_scene(spec.scene, "cpu")
    stats = []
    img = T.render_linear(st, spec.camera, SIZE, spec.background, cfg, region=region,
                          stats=stats)
    progs = list(st.chunk_programs.values())
    return img, stats, progs[-1] if progs else None


@pytest.fixture(scope="module")
def chunk_runs():
    """glossy-reflection's (image, stats, the program, host reads) through
    the captured chunk program (stand-in graphs) under "captured", and the
    op-by-op render's (image, stats) under "eager"."""
    with pytest.MonkeyPatch.context() as mp:
        reads = stand_in_graphs(mp)
        img, stats, prog = _render(T.RenderConfig(device="cpu", **CFG))
        out = {"captured": (img, stats, prog, list(reads.seen))}
        img, stats, _ = _render(T.RenderConfig(device="cpu", cuda_graphs=False, **CFG))
        out["eager"] = (img, stats)
    return out


@pytest.mark.parametrize("unroll", [False, True])
def test_chunk_program_matches_jax(chunk_runs, unroll):
    """The captured chunk program (the tail one loop: one body per slice
    of the loop's round and of the last round, 2 on glossy's ten rounds
    of one capacity of 1,024 lanes, one slice each, against 10 unrolled):
    the JAX package's render_linear with unroll_tail `unroll`; no host
    read."""
    img, stats, prog, seen = chunk_runs["captured"]
    spec = scenes.load("glossy-reflection")
    jcfg = P.RenderConfig(accel="flat", unroll_tail=unroll, **CFG)
    ref = np.asarray(P.render_linear(spec.scene, spec.camera, SIZE, spec.background, jcfg))
    assert_images_close(img, ref)
    assert seen == [] and all(s.syncs == 0 for s in stats)
    assert any(s.live[3] > 0 for s in stats)  # chunks that run the loop
    g = prog.graphs["chunk"]
    divs = prog.cfg.queue_slice_divs
    assert g.bodies == recorded_bodies(prog.pl, divs) == 2 and g.loops == 1
    assert [rd.r for rd in prog.rounds if rd.looped] == list(range(1, 10))


def test_chunk_program_settings_agree_bit_for_bit(chunk_runs):
    """The captured chunk program (its tail one loop) against the same
    program op by op (cuda_graphs=False, every round unrolled and each
    pick read on the host): the same image, live rays per round and
    dropped_w, bit for bit."""
    (img, stats, *_), (eimg, estats) = chunk_runs["captured"], chunk_runs["eager"]
    np.testing.assert_array_equal(img, eimg)
    assert [(s.live.tolist(), s.dropped_w) for s in stats] == \
        [(s.live.tolist(), s.dropped_w) for s in estats]
    assert all(s.syncs > 0 for s in estats)


# ---------------------------------------------------------------------------
# The fit program
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def glass():
    """(JAX tables, port tables carried across, o, d) of the glass sphere."""
    js, o, d = _glass()
    return js, T.tables_from_numpy(*jax_arrays(js), "cpu"), o, d


def _port_fit(st, o, d, cfg):
    """(acc, {field: gradient of sum(acc^2)}, TraceStats) through trace."""
    leaves = {f: getattr(st, f).clone().requires_grad_() for f in DIFF_FIELDS}
    n = o.shape[0]
    acc, stats = tr.trace(rng.PRNGKey(KEY), torch.as_tensor(o), torch.as_tensor(d),
                          torch.arange(n, dtype=torch.int32), torch.full((n, 3), BG), n,
                          st.replace(**leaves), cfg, with_stats=True)
    torch.sum(acc ** 2).backward()
    return acc.detach(), {f: x.grad for f, x in leaves.items()}, stats


# ---------------------------------------------------------------------------
# Edges: a loop that runs no iteration, a tail of one round
# ---------------------------------------------------------------------------

def test_a_loop_that_runs_no_iteration(stand_in):
    """glossy-reflection's top left tile with queue_caps (1.0, 0.75, 0.25)
    (the tail from round 3): its rays bounce once and are all dead before
    the tail, so the chunk's loop runs no iteration (and is recorded all
    the same), the last round takes its dead branch, and the image and
    stats equal the op-by-op render's bit for bit.  The fit program on
    rays that all miss gives the op-by-op trace's colours and gradients
    bit for bit."""
    region = ((0, 0), (15, 15))
    spec = tscenes.load("glossy-reflection")
    st = T.flatten_scene(spec.scene, "cpu")
    cfg = T.RenderConfig(device="cpu", queue_caps=GLASS_CAPS, **CFG)
    img, stats, prog = _render(cfg, region=region, st=st)
    ref, ref_stats, _ = _render(dataclasses.replace(cfg, cuda_graphs=False), region=region)
    assert all(s.live[1] > 0 and s.live[2:].sum() == 0 for s in stats)
    assert [rd.r for rd in prog.rounds if rd.looped] == list(range(3, 10))
    assert stand_in.seen == []
    np.testing.assert_array_equal(img, ref)
    assert [s.live.tolist() for s in stats] == [s.live.tolist() for s in ref_stats]
    g = prog.graphs["chunk"]
    assert g.loops == recorded_loops(prog.pl) == 1
    assert g.bodies == recorded_bodies(prog.pl, cfg.queue_slice_divs)

    _, ts, o, d = _glass_sky()
    fcfg = T.RenderConfig(device="cpu", accel="flat", queue_caps=GLASS_CAPS)
    acc, grads, fstats = _port_fit(ts, o, d, fcfg)
    eacc, egrads, estats = _port_fit(ts, o, d, dataclasses.replace(fcfg, cuda_graphs=False))
    assert int(fstats.live[1:].sum()) == 0 and fstats.live.tolist() == estats.live.tolist()
    assert torch.equal(acc, eacc) and all(torch.equal(grads[f], egrads[f]) for f in DIFF_FIELDS)
    assert stand_in.seen == []


def _glass_sky():
    """The glass sphere's tables, and 64 rays from its camera that miss."""
    js, o, d = _glass(8)
    d = np.array(d)
    d[:, 1] = np.abs(d[:, 1]) + 2.0  # straight up, over the scene
    return js, T.tables_from_numpy(*jax_arrays(js), "cpu"), np.array(o), d


def test_a_tail_of_one_round(stand_in, glass):
    """max_depth 4 with queue_caps (1.0, 0.75, 0.25): rounds 1-2 unrolled,
    round 3 the loop's only round, round 4 the last.  The chunk program on
    glossy-reflection and the fit program on the glass sphere give the
    op-by-op runs' images, colours, gradients and stats bit for bit, one
    loop each with one round."""
    cfg = T.RenderConfig(device="cpu", max_depth=4, queue_caps=GLASS_CAPS, **CFG)
    img, stats, prog = _render(cfg)
    ref, ref_stats, _ = _render(dataclasses.replace(cfg, cuda_graphs=False))
    np.testing.assert_array_equal(img, ref)
    assert [(s.live.tolist(), s.dropped_w) for s in stats] == \
        [(s.live.tolist(), s.dropped_w) for s in ref_stats]
    assert [rd.r for rd in prog.rounds if rd.looped] == [3]
    assert any(s.live[3] > 0 for s in stats) and prog.graphs["chunk"].loops == 1

    _, st, o, d = glass
    fcfg = T.RenderConfig(device="cpu", accel="flat", max_depth=4, queue_caps=GLASS_CAPS)
    acc, grads, fstats = _port_fit(st, o, d, fcfg)
    eacc, egrads, estats = _port_fit(st, o, d, dataclasses.replace(fcfg, cuda_graphs=False))
    assert int(fstats.live[3]) > 0 and fstats.live.tolist() == estats.live.tolist()
    assert torch.equal(acc, eacc) and all(torch.equal(grads[f], egrads[f]) for f in DIFF_FIELDS)
    (fprog,) = [p for p in st.packed.fit_programs.values() if p.cfg == fcfg]
    assert [rd.r for rd in fprog.rounds if rd.looped] == [3]
    assert [g.loops for g in fprog.graphs.values()] == [1, 1] and stand_in.seen == []
