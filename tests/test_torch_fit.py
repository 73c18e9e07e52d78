"""The port's fit through the bounce rounds, on the CPU: per-round
checkpointing in ``ops/trace.py`` (``RenderConfig.remat_min_lanes``) and
the fit program of ``portrayer_tpu_torch/fit.py`` whose steps the card
captures as CUDA graphs.

Scenes: the inline glass sphere (``tests/_torch_jax.py``; reflect and
refract children, total internal reflection, 4x queues) at 64x64, one ray
through each pixel centre, and tests/test_grad.py's scene (a 0.3
reflective sphere over a plane) on its fan of 64 rays.

Tolerances, with their reasons:
- against the JAX package's jax.grad of its checkpointed trace (jitted,
  accel="flat"): test_torch_grad.py's rtol 1e-3 / atol 1e-4 of the
  largest entry (XLA contracts mul+add into FMA).
- checkpointed against uncheckpointed, and the fit program against trace
  + backward(): equal bit for bit, in one CPU thread.  With several
  threads the CPU backward of a gather (index_put_ with accumulate) adds
  its rows in the order the threads reach them, and two runs of the same
  uncheckpointed trace part by a few ulps.
- the fit program's forward and backward replayed through
  tests/_torch_jax.py's StandInGraph (the stand-in for graphs.Graph and
  its conditional bodies) against the op-by-op trace: equal bit for bit
  (the same ops on the same inputs).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint

import portrayer_tpu as P
from portrayer_tpu.camera import Camera as JaxCamera
from portrayer_tpu.ops.trace import trace as jax_trace
import portrayer_tpu_torch as T
from portrayer_tpu_torch import fit, render, rng, scenes as tscenes
from portrayer_tpu_torch.camera import Camera
from portrayer_tpu_torch.ops import cuda_intersect, intersect as tx, trace as tr
from portrayer_tpu_torch.parallel import DIFF_FIELDS

from _torch_jax import (glass_sphere, jax_arrays, recorded_bodies, recorded_loops,
                        stand_in_graphs)
import test_torch_grad

SCENES = ("glass-sphere", "grad-scene")
KEY = 0
BG = 0.3


def _rays(name):
    """(JAX tables, numpy o, d [R,3]) of a scene of SCENES."""
    if name == "grad-scene":
        o, d = test_torch_grad._rays()
        return P.flatten_scene(test_torch_grad._scene(P), dtype=jnp.float32), o, d
    scene, cam, (w, h) = glass_sphere(P)
    ys, xs = np.mgrid[0:h, 0:w]
    o, d = JaxCamera(cam, (w, h)).rays_at(jnp.asarray(xs.reshape(-1) + 0.5, jnp.float32),
                                          jnp.asarray(ys.reshape(-1) + 0.5, jnp.float32))
    return P.flatten_scene(scene, dtype=jnp.float32), np.array(o), np.array(d)


@pytest.fixture(scope="module", params=SCENES)
def case(request):
    """(name, port tables carried across from the JAX package's, o, d,
    the JAX package's acc and gradients of sum(acc^2) for DIFF_FIELDS)."""
    js, o, d = _rays(request.param)
    n = o.shape[0]
    pix = jnp.arange(n, dtype=jnp.int32)
    bg = jnp.full((n, 3), BG, jnp.float32)
    jcfg = P.RenderConfig(accel="flat")

    def loss(vals):
        acc = jax_trace(jax.random.PRNGKey(KEY), jnp.asarray(o), jnp.asarray(d), pix, bg, n,
                        js.replace(**vals), jcfg)
        return jnp.sum(acc ** 2), acc

    (_, jacc), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        {f: getattr(js, f) for f in DIFF_FIELDS})
    ts = T.tables_from_numpy(*jax_arrays(js), "cpu")
    return (request.param, ts, o, d, np.asarray(jacc),
            {f: np.asarray(v) for f, v in jg.items()})


def _trace(st, o, d, cfg, fields=DIFF_FIELDS, run=tr.trace):
    """(acc, {field: gradient}) of sum(acc^2) through `run` (trace, or a
    fit program's trace_captured)."""
    leaves = {f: getattr(st, f).clone().requires_grad_() for f in fields}
    n = o.shape[0]
    acc = run(rng.PRNGKey(KEY), torch.as_tensor(o), torch.as_tensor(d),
              torch.arange(n, dtype=torch.int32), torch.full((n, 3), BG), n,
              st.replace(**leaves), cfg)
    torch.sum(acc ** 2).backward()
    return acc.detach(), {f: x.grad for f, x in leaves.items()}


@pytest.fixture(scope="module")
def port(case):
    """The port's checkpointed acc and gradients on `case`."""
    _, ts, o, d, _, _ = case
    return _trace(ts, o, d, T.RenderConfig(device="cpu", accel="flat"))


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("field", DIFF_FIELDS)
def test_checkpointed_grads_match_jax(case, port, field):
    """Every round checkpointed (remat_min_lanes=0, the default), against
    the JAX package's jax.grad, whose rounds run under jax.checkpoint."""
    name, _, _, _, jacc, jg = case
    acc, g = port
    np.testing.assert_allclose(acc.numpy(), jacc, rtol=1e-3, atol=1e-4 * np.abs(jacc).max())
    got, ref = g[field].numpy(), jg[field]
    assert np.isfinite(got).all() and np.abs(ref).max() > 0, (name, field)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4 * np.abs(ref).max(),
                               err_msg=f"{name} {field}")


@pytest.mark.parametrize("name", SCENES)
def test_checkpointed_grads_equal_uncheckpointed(name, one_thread):
    """remat_min_lanes=0 against bounce-round checkpointing off (above
    every round's lanes; round 0 is checkpointed always, as in the JAX
    package), and against no checkpoint at all: the same colours and
    gradients, bit for bit."""
    js, o, d = _rays(name)
    st = T.tables_from_numpy(*jax_arrays(js), "cpu")
    cfg = T.RenderConfig(device="cpu", accel="flat")
    acc, g = _trace(st, o, d, cfg)
    runs = {"bounce rounds off": _trace(st, o, d,
                                        dataclasses.replace(cfg, remat_min_lanes=1 << 30))}
    real = tr._checkpointed
    tr._checkpointed = lambda body, remat: tr._Sweeps().run(body)
    try:
        runs["none"] = _trace(st, o, d, cfg)
    finally:
        tr._checkpointed = real
    for label, (acc2, g2) in runs.items():
        assert torch.equal(acc, acc2), label
        for f in DIFF_FIELDS:
            assert torch.equal(g[f], g2[f]), (label, f)


@pytest.mark.parametrize("accel", ["flat", "cuda"])
def test_backward_launches_no_sweep(monkeypatch, accel):
    """A fit's backward replays each round's shading from its kept sweep
    results: the flat sweep (accel="flat") or the kernel's plain version
    (accel="cuda" on the CPU) runs in the forward only."""
    calls = {"n": 0}

    def counted(fn):
        def run(*args, **kwargs):
            calls["n"] += 1
            return fn(*args, **kwargs)
        return run

    monkeypatch.setattr(tx, "_flat_intersect", counted(tx._flat_intersect))
    monkeypatch.setattr(cuda_intersect, "intersect_scene_sweep_ref",
                        counted(cuda_intersect.intersect_scene_sweep_ref))
    js, o, d = _rays("glass-sphere")
    st = T.tables_from_numpy(*jax_arrays(js), "cpu")
    leaves = {f: getattr(st, f).clone().requires_grad_() for f in DIFF_FIELDS}
    n = o.shape[0]
    acc, stat = tr.trace(rng.PRNGKey(KEY), torch.as_tensor(o), torch.as_tensor(d),
                         torch.arange(n, dtype=torch.int32), torch.full((n, 3), BG), n,
                         st.replace(**leaves), T.RenderConfig(device="cpu", accel=accel),
                         with_stats=True)
    forward = calls["n"]
    rounds = int((stat.live > 0).sum())
    assert rounds == 11 and forward == 2 * rounds  # a nearest and an any-hit sweep a round
    torch.sum(acc ** 2).backward()
    assert calls["n"] == forward
    assert all(x.grad.abs().max() > 0 for x in leaves.values())


def _kept_bytes(monkeypatch, st, o, d, cfg):
    """Bytes of the distinct storages a checkpointed trace holds for its
    backward, the tables aside: those that autograd saves
    (saved_tensors_hooks, which a checkpoint shadows inside it) and those
    that each checkpoint keeps for its replay (its sweep results, and the
    queue and framebuffer its round runs on)."""
    held = {}
    own = {x.untyped_storage().data_ptr() for x in vars(st).values()
           if isinstance(x, torch.Tensor)}

    def add(x):
        s = x.untyped_storage()
        if s.data_ptr() not in own:
            held[s.data_ptr()] = s.nbytes()

    def tensors(x):
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (tuple, list)):
            for y in x:
                yield from tensors(y)

    real = torch.utils.checkpoint.checkpoint

    def checkpoint(run, body, **kw):
        out = real(run, body, **kw)
        for cell in body.__closure__:
            for x in tensors(cell.cell_contents):
                add(x)
        for x in tensors(run.__self__.kept):
            add(x)
        return out

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", checkpoint)

    def pack(x):
        add(x)
        return x

    leaves = {f: getattr(st, f).clone().requires_grad_() for f in DIFF_FIELDS}
    n = o.shape[0]
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        acc = tr.trace(rng.PRNGKey(KEY), torch.as_tensor(o), torch.as_tensor(d),
                       torch.arange(n, dtype=torch.int32), torch.full((n, 3), BG), n,
                       st.replace(**leaves), cfg)
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", real)
    torch.sum(acc ** 2).backward()
    return sum(held.values())


def test_checkpointing_holds_fewer_bytes(monkeypatch, capsys):
    """On the glass sphere (4x queues of 16,384 lanes, 11 rounds), the
    storages held for the backward with every round checkpointed against
    bounce-round checkpointing off: the checkpointed trace keeps each
    round's queue, framebuffer and sweep results, not its shading
    temporaries."""
    js, o, d = _rays("glass-sphere")
    st = T.tables_from_numpy(*jax_arrays(js), "cpu")
    cfg = T.RenderConfig(device="cpu", accel="flat")
    ck = _kept_bytes(monkeypatch, st, o, d, cfg)
    off = _kept_bytes(monkeypatch, st, o, d, dataclasses.replace(cfg, remat_min_lanes=1 << 30))
    with capsys.disabled():
        print(f"\nglass-sphere 64x64, bytes held for the backward: every round checkpointed "
              f"{ck:,}; bounce-round checkpointing off {off:,}")
    assert 0 < ck < off / 4


def test_remat_min_lanes_exempts_small_rounds(monkeypatch, one_thread):
    """Round 0 always runs checkpointed; a bounce round on k lanes when k
    >= remat_min_lanes (k: the head slice it runs on, from its live
    count).  On the glass sphere with a 4x queue into round 1 and 1x
    after, every round on its whole queue, round 1 runs on 16,384 lanes
    and rounds 2-10 on 4,096.  At each m the captured fit (stand-in graphs,
    its slices of k < m lanes exempt from the replay) gives the op-by-op
    trace's colours and gradients bit for bit."""
    js, o, d = _rays("glass-sphere")
    st = T.tables_from_numpy(*jax_arrays(js), "cpu")
    cfg = T.RenderConfig(device="cpu", accel="flat", queue_caps=(4.0, 1.0),
                         queue_slice_divs=(1,))
    n = o.shape[0]
    with torch.no_grad():
        _, stats = tr.trace(rng.PRNGKey(KEY), torch.as_tensor(o), torch.as_tensor(d),
                            torch.arange(n, dtype=torch.int32), torch.full((n, 3), BG), n, st,
                            cfg, with_stats=True)
    pl = tr.plan(n, st, cfg)
    ks = [tr.pick_slice(tr.slice_sizes(pl.cap[r], cfg.queue_slice_divs), int(stats.live[r]))
          for r in range(1, pl.max_depth + 1)]
    assert ks == [16384] + [4096] * 9 and stats.dropped_w == 0.0
    real = torch.utils.checkpoint.checkpoint
    eager = {}
    for m in sorted(set(ks)) + [0, max(ks) + 1]:
        seen = []
        monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                            lambda *a, **k: seen.append(1) or real(*a, **k))
        eager[m] = _trace(st, o, d, dataclasses.replace(cfg, remat_min_lanes=m),
                          fields=("mat_diffuse",))
        assert len(seen) == 1 + sum(k >= m for k in ks if k), (m, ks, len(seen))
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", real)
    reads = stand_in_graphs(monkeypatch)
    for m, (acc, g) in eager.items():
        acc2, g2 = _trace(st, o, d, dataclasses.replace(cfg, remat_min_lanes=m),
                          fields=("mat_diffuse",), run=fit.trace_captured)
        assert torch.equal(acc, acc2) and torch.equal(g["mat_diffuse"], g2["mat_diffuse"]), m
        (prog,) = [p for p in st.packed.fit_programs.values() if p.cfg.remat_min_lanes == m]
        assert prog.warm and len(prog.exempt) == len({prog._body(rd, k) for rd in prog.rounds
                                                      for k in rd.sizes if k < m}), m
    assert reads.seen == []


# ---------------------------------------------------------------------------
# The fit program (fit.py)
# ---------------------------------------------------------------------------

@pytest.fixture
def stand_in(monkeypatch, one_thread):
    """Differentiable traces with cuda_graphs on the CPU go through the
    capturing fit program, with StandInGraph for the graphs; returns the
    HostReads."""
    return stand_in_graphs(monkeypatch)


def _glass_tile(spp=2, name="glass-sphere"):
    """The glass sphere's middle 16x16 tile (or a 16x16 tile of
    glossy-reflection whose rays bounce twice off its spheres) at `spp`, as
    the render builds its rays: (tables, o, d, pix, bg, w0)."""
    if name == "glass-sphere":
        scene, cam, (w, h) = glass_sphere(T)
        x0 = y0 = 24
    else:
        spec = tscenes.load(name)
        scene, cam, (w, h) = spec.scene, spec.camera, spec.size
        x0, y0 = 384, 192
    st = T.flatten_scene(scene, "cpu")
    cfg = T.RenderConfig(device="cpu")
    rays = render._tile_rays(rng.PRNGKey(4), Camera(cam, (w, h), "cpu"), x0, y0, 0,
                             cfg=cfg, background=render.default_background, tile_h=16,
                             tile_w=16, spp=spp, samples=spp)
    return (st,) + rays


def _tile_grads(st, o, d, pix, bg, w0, cfg, scale=1.0, spp=2):
    leaves = {f: (getattr(st, f) * scale).detach().requires_grad_() for f in DIFF_FIELDS}
    acc, stats = tr.trace(rng.PRNGKey(5), o, d, pix, bg, 256, st.replace(**leaves), cfg, w0=w0,
                          spp_contiguous=spp, with_stats=True)
    torch.sum(acc ** 2).backward()
    return acc.detach(), {f: x.grad for f, x in leaves.items()}, stats


def _assert_equal(a, b):
    (acc, g, stats), (acc2, g2, stats2) = a, b
    assert torch.equal(acc, acc2)
    assert stats.live.tolist() == stats2.live.tolist() and stats.dropped_w == stats2.dropped_w
    assert stats.lanes.tolist() == stats2.lanes.tolist()
    for f in DIFF_FIELDS:
        assert torch.equal(g[f], g2[f]), f


def test_fit_program_equals_trace_and_backward(stand_in):
    """The fit program (its first call op by op, the warm-up, then its
    forward and backward through the stand-in graphs) against trace +
    backward() on the glass sphere's tile: the same colours, TraceStats and
    gradients, bit for bit, on the first call and again on a second."""
    st, *rays = _glass_tile()
    ref = _tile_grads(st, *rays, T.RenderConfig(device="cpu", cuda_graphs=False))
    cfg = T.RenderConfig(device="cpu")
    _assert_equal(_tile_grads(st, *rays, cfg), ref)
    (prog,) = st.packed.fit_programs.values()
    assert prog.warm and prog.graphs["forward"].replays == 1
    _assert_equal(_tile_grads(st, *rays, cfg), ref)
    assert prog.graphs["forward"].replays == 2 and stand_in.seen == []


@pytest.mark.parametrize("name", ["glass-sphere", "glossy-reflection"])
def test_captured_fit_steps_read_nothing_on_the_host(stand_in, name):
    """The capturing fit program's forward and backward, each one graph,
    replayed under HostReads: no host read, no copy from host data, each
    bounce round's slice picked by the stand-in conditional (a conditional
    body per slice of each unrolled round and of the tail's loop, forward
    and backward); TraceStats.syncs
    is 0; the replays give the op-by-op trace's colours, live rays per
    round and gradients bit for bit; a second step on replaced tables (new
    parameter values) replays the same two graphs, and equals trace on
    those tables."""
    st, *rays = _glass_tile(name=name)
    cfg = T.RenderConfig(device="cpu")
    eager = dataclasses.replace(cfg, cuda_graphs=False)
    got = _tile_grads(st, *rays, cfg)
    assert stand_in.seen == [] and got[2].syncs == 0
    ref = _tile_grads(st, *rays, eager)
    _assert_equal(got, ref)
    assert int((ref[2].live[1:] > 0).sum()) >= 2 and ref[2].syncs > 0
    (prog,) = st.packed.fit_programs.values()
    assert prog.warm and sorted(prog.graphs) == ["backward", "forward"]
    bodies = recorded_bodies(prog.pl, cfg.queue_slice_divs)
    loops = recorded_loops(prog.pl)
    assert all(g.bodies == bodies and g.loops == loops and g.replays == 1
               for g in prog.graphs.values())
    steps = dict(prog.graphs)
    again = _tile_grads(st, *rays, cfg, scale=0.9)
    assert stand_in.seen == [] and prog.graphs == steps
    assert all(g.replays == 2 for g in prog.graphs.values())
    _assert_equal(again, _tile_grads(st, *rays, eager, scale=0.9))
    assert list(st.packed.fit_programs.values()) == [prog]


def test_captured_fit_of_two_traces_in_one_loss(stand_in):
    """Two traces over one fit program before one backward (as a
    multi-shard oracle sums its shards): each call keeps its own state and
    reloads its inputs in backward, so the gradients equal the op-by-op
    traces' within 1e-6 of their largest entry (the program hands autograd
    each trace's gradient summed over its rounds; op by op the engine
    adds the two traces' rounds into one sum)."""
    st, o, d, pix, bg, w0 = _glass_tile()
    keys = (rng.PRNGKey(5), rng.PRNGKey(6))

    def grads(cfg):
        leaves = {f: getattr(st, f).clone().requires_grad_() for f in DIFF_FIELDS}
        tables = st.replace(**leaves)
        accs = [tr.trace(k, o * s, d, pix, bg, 256, tables, cfg, w0=w0, spp_contiguous=2)
                for k, s in zip(keys, (1.0, 1.01))]
        torch.sum((accs[0] - accs[1]) ** 2 + accs[0]).backward()
        return {f: x.grad for f, x in leaves.items()}

    g = grads(T.RenderConfig(device="cpu"))
    ref = grads(T.RenderConfig(device="cpu", cuda_graphs=False))
    assert stand_in.seen == [] and len(st.packed.fit_programs) == 1
    for f in DIFF_FIELDS:
        torch.testing.assert_close(g[f], ref[f], rtol=0, atol=1e-6 * float(ref[f].abs().max()),
                                   msg=f)


def test_captured_fit_takes_ray_gradients(stand_in):
    """Rays and background that require grad: the captured program gives
    their gradients (and the tables') as the op-by-op trace does, bit for
    bit."""
    st, o, d, pix, bg, w0 = _glass_tile()

    def grads(cfg):
        leaves = {f: getattr(st, f).clone().requires_grad_() for f in ("mat_diffuse", "inv")}
        rays = {n: x.clone().requires_grad_() for n, x in (("o", o), ("d", d), ("bg", bg),
                                                             ("w0", w0))}
        acc = tr.trace(rng.PRNGKey(5), rays["o"], rays["d"], pix, rays["bg"], 256,
                       st.replace(**leaves), cfg, w0=rays["w0"], spp_contiguous=2)
        torch.sum(acc ** 2).backward()
        return {n: x.grad for n, x in {**leaves, **rays}.items()}

    g = grads(T.RenderConfig(device="cpu"))
    ref = grads(T.RenderConfig(device="cpu", cuda_graphs=False))
    (prog,) = st.packed.fit_programs.values()
    assert stand_in.seen == [] and prog.ray_grads == ("o0", "d0", "w0", "bg")
    for n in g:
        assert g[n].abs().max() > 0 and torch.equal(g[n], ref[n]), n


def test_a_backward_that_reads_on_the_host_is_seen(stand_in, monkeypatch):
    """The check has teeth in backward too: a round whose backward reads
    a value on the host is recorded."""

    class _Reads(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            return g * float(g.abs().max() >= 0.0)

    add = tr._acc_add
    monkeypatch.setattr(tr, "_acc_add", lambda acc, pix, x, spp_c: add(acc, pix, _Reads.apply(x),
                                                                       spp_c))
    st, *rays = _glass_tile()
    _tile_grads(st, *rays, T.RenderConfig(device="cpu"))
    assert stand_in.seen and all("_local_scalar_dense" in s for s in stand_in.seen)
