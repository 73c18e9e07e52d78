"""The captured fit with ``RenderConfig.remat_min_lanes`` > 0, on the CPU:
the slices of a bounce round on fewer lanes keep their autograd
temporaries (in residual slots of the fit program's state slab) and their
backward replays no forward op, the JAX package's ``_run`` against
``_run_ckpt`` (portrayer_tpu/ops/trace.py:404-410).  The program runs its
steps through tests/_torch_jax.py's StandInGraph, as on the card it
captures them; a graph an exempt body records in its first replay is the
one every later backward differentiates, as on the card.

Tolerances, with their reasons:
- against the JAX package's jax.grad of its trace at the same
  remat_min_lanes (jitted, accel="flat"): test_torch_fit.py's rtol 1e-3 /
  atol 1e-4 of the largest entry (XLA contracts mul+add into FMA).
- against the port's op-by-op trace at the same remat_min_lanes: equal bit
  for bit in one CPU thread (the same ops on the same inputs; several
  threads add a gather's backward rows in any order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import portrayer_tpu as P
from portrayer_tpu.ops.trace import trace as jax_trace
import portrayer_tpu_torch as T
from portrayer_tpu_torch import fit, rng
from portrayer_tpu_torch.ops import trace as tr
from portrayer_tpu_torch.parallel import DIFF_FIELDS

from _torch_jax import jax_arrays, stand_in_graphs
from test_torch_fit import BG, KEY, _assert_equal, _glass_tile, _rays, _tile_grads

# The glass sphere at 64x64 (4,096 rays, 16,384 lanes in round 1): its
# bounce rounds run on slices of 2,048 to 16,384 lanes; below 8,192 the
# smaller ones keep their temporaries.
M = 8192


@pytest.fixture
def stand_in(monkeypatch):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield stand_in_graphs(monkeypatch)
    torch.set_num_threads(n)


def _slices(pl, divs, m):
    """{(exempt?): number of bounce-round slice bodies} of a plan."""
    sizes = [k for r in range(1, pl.max_depth + 1) for k in tr.slice_sizes(pl.cap[r], divs)]
    return sum(k < m for k in sizes), sum(k >= m for k in sizes)


def test_exempt_fit_matches_jax_grad(stand_in):
    """sum(acc^2) and its gradients in DIFF_FIELDS through the captured
    program with remat_min_lanes=M, against the JAX package's jax.grad at
    the same remat_min_lanes."""
    js, o, d = _rays("glass-sphere")
    n = o.shape[0]
    pix = jnp.arange(n, dtype=jnp.int32)
    jcfg = P.RenderConfig(accel="flat", remat_min_lanes=M)

    def loss(vals):
        acc = jax_trace(jax.random.PRNGKey(KEY), jnp.asarray(o), jnp.asarray(d), pix,
                        jnp.full((n, 3), BG, jnp.float32), n, js.replace(**vals), jcfg)
        return jnp.sum(acc ** 2), acc

    (_, jacc), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        {f: getattr(js, f) for f in DIFF_FIELDS})
    st = T.tables_from_numpy(*jax_arrays(js), "cpu")
    cfg = T.RenderConfig(device="cpu", accel="flat", remat_min_lanes=M)
    leaves = {f: getattr(st, f).clone().requires_grad_() for f in DIFF_FIELDS}
    acc, stats = tr.trace(rng.PRNGKey(KEY), torch.as_tensor(o), torch.as_tensor(d),
                          torch.arange(n, dtype=torch.int32), torch.full((n, 3), BG), n,
                          st.replace(**leaves), cfg, with_stats=True)
    torch.sum(acc ** 2).backward()
    (prog,) = st.packed.fit_programs.values()
    exempt, kept = _slices(prog.pl, cfg.queue_slice_divs, M)
    assert exempt > 0 and kept > 0 and prog.exempt and stand_in.seen == []
    assert stats.syncs == 0 and int((stats.live[1:] > 0).sum()) == 10
    jacc = np.asarray(jacc)
    np.testing.assert_allclose(acc.detach().numpy(), jacc, rtol=1e-3,
                               atol=1e-4 * np.abs(jacc).max())
    for f in DIFF_FIELDS:
        got, ref = leaves[f].grad.numpy(), np.asarray(jg[f])
        assert np.isfinite(got).all() and np.abs(ref).max() > 0, f
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4 * np.abs(ref).max(),
                                   err_msg=f)


@pytest.mark.parametrize("case", ["flat", "beam", "float64", "glossy-reflection"])
def test_exempt_fit_equals_op_by_op(stand_in, case):
    """The captured program with every bounce-round slice exempt, and with
    none, against the op-by-op trace at the same remat_min_lanes, on two
    steps (the second on new parameter values): the same colours, live
    rays and gradients, bit for bit.  On the glass sphere's tile with the
    flat sweep, the beam sweep (its ordered walk a loop inside the
    exempt body, in the loop over the tail) and the float64 check mode,
    and on glossy-reflection's tile."""
    name = "glossy-reflection" if case == "glossy-reflection" else "glass-sphere"
    st, *rays = _glass_tile(name=name)
    kw = {"beam": dict(accel="beam", beam_min_prims=0),
          "float64": dict(accel="flat", dtype=torch.float64)}.get(case, {})
    if case == "float64":
        st = T.flatten_scene(_glass_scene(), "cpu", dtype=torch.float64)
        rays = [x.double() if x is not None and x.is_floating_point() else x for x in rays]
    for m in (1 << 30, 1):
        cfg = T.RenderConfig(device="cpu", remat_min_lanes=m, **kw)
        eager = dataclasses.replace(cfg, cuda_graphs=False)
        for scale in (1.0, 0.9):
            _assert_equal(_tile_grads(st, *rays, cfg, scale=scale),
                          _tile_grads(st, *rays, eager, scale=scale))
        (prog,) = [p for p in st.packed.fit_programs.values() if p.cfg.remat_min_lanes == m]
        assert prog.graphs["forward"].replays == 2 and stand_in.seen == []
        exempt, kept = _slices(prog.pl, cfg.queue_slice_divs, m)
        assert (exempt, kept) == ((exempt + kept, 0) if m > 1 else (0, exempt + kept))
        assert bool(prog.exempt) == (m > 1)


def _glass_scene():
    from _torch_jax import glass_sphere

    return glass_sphere(T)[0]


class _GradOps(TorchDispatchMode):
    """Counts the ops dispatched, and those dispatched with autograd
    recording (a forward op run under enable_grad, as a replay runs)."""

    def __init__(self):
        super().__init__()
        self.ops = self.recorded = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        self.recorded += torch.is_grad_enabled()
        return func(*args, **(kwargs or {}))


def test_exempt_backward_replays_no_forward_op(stand_in, monkeypatch):
    """The backward of an exempt body runs the graph its forward recorded:
    no op of it runs with autograd recording (a replay runs the round's
    forward under enable_grad), it never enters the round's Python code,
    and it dispatches fewer ops than the same body's backward with the
    replay.  Glass sphere's tile, its bodies exempt (m = 1 << 30) against
    checkpointed (m = 1)."""
    st, *rays = _glass_tile()
    counts = {}
    rounds = {"n": 0}
    real_round = tr._round

    def counted_round(*a, **k):
        rounds["n"] += 1
        return real_round(*a, **k)

    monkeypatch.setattr(tr, "_round", counted_round)
    for name in ("exempt_grad", "bounce_grad"):
        real = getattr(fit._FitProgram, name)

        def run(self, *a, _real=real, _name=name, **k):
            mode, before = _GradOps(), rounds["n"]
            with mode:
                _real(self, *a, **k)
            counts.setdefault(_name, []).append((mode.ops, mode.recorded,
                                                 rounds["n"] - before))
            return None

        monkeypatch.setattr(fit._FitProgram, name, run)
    for m in (1 << 30, 1):
        _tile_grads(st, *rays, T.RenderConfig(device="cpu", remat_min_lanes=m))
    ex, ck = counts["exempt_grad"], counts["bounce_grad"]
    assert ex and ck
    assert all(rec == 0 and entered == 0 for _, rec, entered in ex), ex
    assert all(rec > 0 and entered == 1 for _, rec, entered in ck), ck
    assert max(ops for ops, _, _ in ex) < min(ops for ops, _, _ in ck)


def test_exempt_slots_are_sized_in_the_warm_up(stand_in):
    """Every tensor an exempt body saves has a slot (or is a constant off
    the device), measured before the capture: the slab grows by the
    residuals, once.  Each kept graph differentiates into leaves of its
    own, made in its body (aliases of the static parameters): on the card
    a leaf made before the capture would carry the warm-up's stream into
    the captured backward."""
    st, *rays = _glass_tile()
    _tile_grads(st, *rays, T.RenderConfig(device="cpu", remat_min_lanes=1 << 30))
    (prog,) = st.packed.fit_programs.values()
    assert prog.res.shapes and prog.res.state is prog.state
    for shape, saves in prog.res.shapes.items():
        assert saves and all(not const for _, _, const in saves)
    names = {n[1] for n, *_ in prog.state.spans if n[0] == fit._RES}
    assert names == set(prog.exempt)
    leaves = [wrt[f] for _, wrt in prog.exempt.values() for f in prog.fields]
    assert len({id(x) for x in leaves}) == len(leaves)
    assert all(x.is_leaf and x.untyped_storage().data_ptr()
               == prog.params[f].untyped_storage().data_ptr()
               for (_, wrt) in prog.exempt.values() for f, x in wrt.items() if f in prog.fields)
