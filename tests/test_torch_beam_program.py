"""The beam sweep's ordered walk as a loop on the device (ops/beam.py:
``graphs.loop``, a CUDA graph WHILE node on the card, the JAX package's
``lax.while_loop``), and the captured chunk and fit programs through it,
on the CPU.

The captured programs run through tests/_torch_jax.py's StandInGraph,
whose loop reads its condition on the host with the read excused (on the
card the step kernel evaluates it) and whose switch does the same for
sel; everything else a replay runs under HostReads.  With
``beam_min_prims=0`` every round's sweeps take the beam, so its loops
nest in the bounce rounds' slice bodies, and in the body of the loop
over the tail of equal capacity in turn: a WHILE in an IF in a WHILE, as
the JAX package's while_loop sits in its round's lax.switch inside its
lax.scan.  One torch thread (tests/_torch_jax.py).

Scenes: glossy-reflection at 32x18 x 1 spp in tiles of 16x16 (four
chunks; ten bounce rounds of one capacity, rounds 1-9 the loop);
procedural-meshes (tests/_torch_jax.py, 769 mesh pairs and the analytic
nodes) on tests/test_beam.py's rays; the inline glass sphere on 32x32
rays with queue_caps (1.0, 0.75, 0.125) (test_torch_unroll_tail.py's fit:
rounds 1-2 unrolled, 3-9 the loop, 10 the last, queues that overflow).
``beam_min_prims``, ``warp_size`` and ``beam_chunk`` take the same values
on both sides.

Tolerances, with their reasons:
- the loop through the stand-in, and the captured programs, against the
  op-by-op ones: equal bit for bit (the same ops on the same inputs, in
  one thread);
- against the JAX package's intersect_scene_beam: tests/test_beam.py's
  gates (hit equal, t within rtol 1e-4 / atol 1e-5, a node apart only on
  a tie), for XLA's FMA contraction;
- against the JAX package's jitted render_linear: test_torch_render.py's
  image rule (at most 1% of pixels off by more than 1e-4, none by more
  than 2e-2);
- against the JAX package's trace and jax.grad: test_torch_fit.py's rtol
  1e-3 / atol 1e-4 of the largest entry on the colours and gradients.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scenes
import portrayer_tpu as P
from portrayer_tpu.ops.beam import intersect_scene_beam as jax_beam
from portrayer_tpu.ops.trace import trace as jax_trace
import portrayer_tpu_torch as T
from portrayer_tpu_torch import parallel, rng, scenes as tscenes
from portrayer_tpu_torch.ops import cuda_intersect
from portrayer_tpu_torch.ops.beam import intersect_scene_beam
from portrayer_tpu_torch.parallel import DIFF_FIELDS
from portrayer_tpu_torch.scene.flatten import MESH

from _torch_jax import (StandInGraph, beam_loops, jax_arrays, recorded_bodies,
                        recorded_loops, stand_in_graphs)
from test_torch_intersect import J_BEAM, T_BEAM, _beam_gates, _beam_rays, _t
from test_torch_render import assert_images_close
from test_torch_unroll_tail import BG, FIT_CAPS, KEY, _port_fit, glass  # noqa: F401

SIZE = (32, 18)
CFG = dict(samples=1, tile=(16, 16), max_rays_per_launch=1024, seed=0, accel="beam",
           beam_min_prims=0)
INF = float("inf")


@pytest.fixture
def stand_in(monkeypatch):
    return stand_in_graphs(monkeypatch)


def _outputs(hit, stats):
    return [x.clone() for x in hit] + [stats["trips"].clone()]


def _through_stand_in(fn):
    """fn() replayed once by a StandInGraph (its loops the stand-in WHILE
    node): (fn's result, the graph)."""
    box = {}
    g = StandInGraph(lambda: box.update(out=fn()), None)
    g.replay()
    return box["out"], g


# ---------------------------------------------------------------------------
# The sweep's loop
# ---------------------------------------------------------------------------

def _case(name):
    """(JAX tables or None, port tables, o, d, keyword arguments) of a
    case: tests/test_beam.py's camera rays of procedural-meshes
    (coherent) and from its surfaces (scattered), and glossy-reflection's
    camera rays with no active lane (a loop of no step)."""
    if name.startswith("procedural-meshes"):
        js, o, d = _beam_rays("procedural-meshes", 512, 0, name.endswith("scattered"))
        return js, T.tables_from_numpy(*jax_arrays(js), "cpu"), _t(o), _t(d), {}
    js, o, d = _beam_rays("glossy-reflection", 512, 1, False)
    kw = dict(active=torch.zeros(o.shape[0], dtype=torch.bool))
    return None, T.tables_from_numpy(*jax_arrays(js), "cpu"), _t(o), _t(d), kw


@pytest.mark.parametrize("name", ["procedural-meshes", "procedural-meshes scattered",
                                  "no active lane"])
def test_beam_loop_through_the_stand_in_equals_the_host_loop(stand_in, name):
    """intersect_scene_beam with its ordered loops recorded (the stand-in
    WHILE node, under HostReads) against the same call op by op (the host
    loop, one read a step): hits, nodes, triangles and the steps counted
    on the device equal bit for bit, no host read, one loop per analytic
    group with nodes and one over the mesh pairs.  With no active lane
    every loop does no step: the stand-in counts their bodies without
    running them, and nothing is hit.  Against the JAX package's
    intersect_scene_beam under tests/test_beam.py's gates."""
    js, ts, o, d, kw = _case(name)
    cuda_intersect.reset_counts()
    stats = {}
    ref = _outputs(intersect_scene_beam(o, d, 1e-5, INF, ts, T_BEAM, stats=stats, **kw), stats)
    host_steps = cuda_intersect.counts()["beam_step"]
    cuda_intersect.reset_counts()
    cap_stats = {}
    hit, g = _through_stand_in(lambda: intersect_scene_beam(o, d, 1e-5, INF, ts, T_BEAM,
                                                            stats=cap_stats, **kw))
    got = _outputs(hit, cap_stats)
    assert stand_in.seen == []
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    # The call takes the beam whatever the scene's size.
    assert g.loops == beam_loops(ts, dataclasses.replace(T_BEAM, beam_min_prims=0)) > 0
    assert g.bodies == 0
    assert cuda_intersect.counts()["beam_step"] == host_steps == int(ref[-1])
    if js is None:
        assert int(ref[-1]) == 0 and not bool(ref[3].any())
        return
    assert int(ref[-1]) > 0 and bool(ref[3].any())
    assert any(kind == MESH for kind, _, _ in ts.groups) and ts.n_pairs > 0
    _beam_gates(jax.jit(lambda o, d: jax_beam(o, d, 1e-5, jnp.inf, js, J_BEAM))(
        jnp.asarray(o.numpy()), jnp.asarray(d.numpy())), hit)


# ---------------------------------------------------------------------------
# The chunk program
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def chunk_runs():
    """glossy-reflection's (image, stats, the program, host reads, sweep
    counts) through the captured chunk program (stand-in graphs) under
    "captured" and again with the program cached under "cached", and the
    op-by-op render's (image, stats, counts) under "eager"."""
    spec = tscenes.load("glossy-reflection")
    st = T.flatten_scene(spec.scene, "cpu")
    args = (st, spec.camera, SIZE, spec.background)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        reads = stand_in_graphs(mp)
        for label in ("captured", "cached"):
            stats = []
            cuda_intersect.reset_counts()
            img = T.render_linear(*args, T.RenderConfig(device="cpu", **CFG), stats=stats)
            out[label] = (img, stats, next(iter(st.chunk_programs.values())), list(reads.seen),
                          cuda_intersect.counts())
    stats = []
    cuda_intersect.reset_counts()
    img = T.render_linear(*args, T.RenderConfig(device="cpu", cuda_graphs=False, **CFG),
                          stats=stats)
    out["eager"] = (img, stats, cuda_intersect.counts())
    return out


def test_captured_beam_chunk_equals_op_by_op(chunk_runs):
    """The captured chunk (the beam's loops in round 0, in each slice of
    the last round and in each slice of the tail loop's round) against the
    op-by-op loop: the same image, live rays per round and dropped_w bit
    for bit, 0 host reads and host syncs a chunk; one graph, one replay a
    chunk; its bodies from the plan and its loops from the plan and the
    scene's groups; the beam's steps, counted on the device, those of the
    op-by-op loop (the first render's with its warm-up's)."""
    img, stats, prog, seen, counts = chunk_runs["captured"]
    cimg, cstats, _, cseen, cached = chunk_runs["cached"]
    eimg, estats, eager = chunk_runs["eager"]
    np.testing.assert_array_equal(img, eimg)
    np.testing.assert_array_equal(cimg, eimg)
    for s in (stats, cstats):
        assert [(x.live.tolist(), x.dropped_w) for x in s] == \
            [(x.live.tolist(), x.dropped_w) for x in estats]
        assert all(x.syncs == 0 for x in s)
    assert seen == [] and cseen == []
    assert any(s.syncs > 0 for s in estats)
    g = prog.graphs["chunk"]
    assert list(prog.graphs) == ["chunk"] and g.replays == 2 * len(stats) == 8
    divs = prog.cfg.queue_slice_divs
    per_round = beam_loops(prog.st, prog.cfg) * 2  # nearest and shadow rays
    assert per_round == 4 and any(rd.looped for rd in prog.rounds)
    assert g.bodies == recorded_bodies(prog.pl, divs)
    assert g.loops == recorded_loops(prog.pl, divs, per_round)
    assert eager["beam_step"] > 0 and eager["nearest"] == eager["any_hit"] == 0
    assert cached["beam_step"] == eager["beam_step"]
    assert counts["beam_step"] == eager["beam_step"] + prog.warm_launches["beam_step"]
    assert cached["beam_sweep"] == eager["beam_sweep"]
    assert int((estats[0].live[1:] > 0).sum()) >= 2  # a chunk that bounces twice


def test_captured_beam_chunk_matches_jax(chunk_runs):
    """The captured render against the JAX package's jitted render_linear
    with accel="beam" and the same beam settings."""
    jspec = scenes.load("glossy-reflection")
    jcfg = P.RenderConfig(**CFG)
    ref = np.asarray(P.render_linear(jspec.scene, jspec.camera, SIZE, jspec.background, jcfg))
    assert_images_close(chunk_runs["captured"][0], ref)


# ---------------------------------------------------------------------------
# The fit program
# ---------------------------------------------------------------------------

BEAM_FIT = dict(device="cpu", accel="beam", beam_min_prims=0, queue_caps=FIT_CAPS)


@pytest.fixture(scope="module")
def fit_runs(glass):
    """(acc, gradients, stats, the program, host reads) of the glass
    sphere's fit through the captured fit program (stand-in graphs) under
    "captured", and the op-by-op trace's (acc, gradients, stats) under
    "eager"."""
    _, st, o, d = glass
    cfg = T.RenderConfig(**BEAM_FIT)
    with pytest.MonkeyPatch.context() as mp:
        reads = stand_in_graphs(mp)
        acc, g, stats = _port_fit(st, o, d, cfg)
        (prog,) = st.packed.fit_programs.values()
        out = {"captured": (acc, g, stats, prog, list(reads.seen))}
    st.packed.fit_programs.clear()
    out["eager"] = _port_fit(st, o, d, dataclasses.replace(cfg, cuda_graphs=False))
    return out


def test_captured_beam_fit_equals_op_by_op(fit_runs):
    """The captured fit (the beam's loops in the forward's rounds, in the
    slices of the unrolled rounds and of the tail loop's round) against
    the op-by-op trace: the same colours, gradients, live rays per round
    and dropped_w bit for bit, no host read; the forward's loops from the
    plan and the scene's groups, the backward's the tail's alone (it
    launches no sweep)."""
    (acc, g, stats, prog, seen), (eacc, eg, estats) = fit_runs["captured"], fit_runs["eager"]
    assert torch.equal(acc, eacc)
    for f in DIFF_FIELDS:
        assert torch.equal(g[f], eg[f]), f
    assert stats.live.tolist() == estats.live.tolist() and stats.dropped_w == estats.dropped_w
    assert seen == [] and stats.syncs == 0 and estats.syncs > 0
    divs = prog.cfg.queue_slice_divs
    bodies = recorded_bodies(prog.pl, divs)
    per_round = beam_loops(prog.st, prog.cfg) * (1 + (prog.L > 0))
    assert per_round > 0
    assert [(x.bodies, x.loops) for x in prog.graphs.values()] == [
        (bodies, recorded_loops(prog.pl, divs, per_round)), (bodies, recorded_loops(prog.pl))]
    assert [rd.r for rd in prog.rounds if rd.looped] == list(range(3, 10))


def test_captured_beam_fit_matches_jax(glass, fit_runs):
    """The captured fit: the JAX package's trace and jax.grad of sum(acc^2)
    for DIFF_FIELDS with accel="beam" and the same beam settings, its live
    rays per round and dropped_w."""
    js, _, o, d = glass
    acc, g, stats, _, _ = fit_runs["captured"]
    n = o.shape[0]
    jcfg = P.RenderConfig(accel="beam", beam_min_prims=0, queue_caps=FIT_CAPS)

    def loss(vals):
        acc, st = jax_trace(jax.random.PRNGKey(KEY), jnp.asarray(o), jnp.asarray(d),
                            jnp.arange(n, dtype=jnp.int32), jnp.full((n, 3), BG, jnp.float32),
                            n, js.replace(**vals), jcfg, with_stats=True)
        return jnp.sum(acc ** 2), (acc, st)

    (_, (jacc, jst)), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        {f: getattr(js, f) for f in DIFF_FIELDS})
    jacc = np.asarray(jacc)
    np.testing.assert_allclose(acc.numpy(), jacc, rtol=1e-3, atol=1e-4 * np.abs(jacc).max())
    for f in DIFF_FIELDS:
        ref = np.asarray(jg[f])
        np.testing.assert_allclose(g[f].numpy(), ref, rtol=1e-3, atol=1e-4 * np.abs(ref).max(),
                                   err_msg=f)
    np.testing.assert_allclose(stats.live.numpy(), np.asarray(jst.live), rtol=1e-4)
    np.testing.assert_allclose(stats.dropped_w, float(jst.dropped_w), rtol=1e-4)


def test_train_step_takes_the_captured_beam_fit(glass, stand_in, monkeypatch):
    """parallel.train_step at world size 1 with accel="beam": its trace
    goes through the captured fit program (no host read in its replays),
    and its loss and gradients equal the op-by-op step's bit for bit."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    _, st, o, d = glass
    n = o.shape[0]
    args = (rng.PRNGKey(KEY), torch.as_tensor(o), torch.as_tensor(d),
            torch.arange(n, dtype=torch.int32), torch.full((n, 3), BG), n, 1,
            torch.full((n, 3), 0.25))
    cfg = T.RenderConfig(**BEAM_FIT)
    parallel.initialize(num_processes=1, device="cpu")
    try:
        mesh = parallel.make_mesh(1, device="cpu")
        loss, grads = parallel.train_step(mesh, *args, st, cfg)
        (prog,) = st.packed.fit_programs.values()
        assert prog.graphs["forward"].replays == 1 and stand_in.seen == []
        st.packed.fit_programs.clear()
        eloss, egrads = parallel.train_step(mesh, *args, st,
                                            dataclasses.replace(cfg, cuda_graphs=False))
    finally:
        torch.distributed.destroy_process_group()
    assert not st.packed.fit_programs
    assert torch.equal(loss, eloss)
    for f in DIFF_FIELDS:
        assert torch.equal(grads[f], egrads[f]), f
