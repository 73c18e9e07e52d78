"""test_torch_unroll_tail.py's fit program against the JAX package's
trace and jax.grad, in a file of its own: the JAX package's compiles of
its differentiated trace, scanned and unrolled, make it the longest part,
and the test run spreads files over its workers.  Scenes and tolerances:
test_torch_unroll_tail.py's docstring."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import portrayer_tpu as P
from portrayer_tpu.ops.trace import trace as jax_trace
import portrayer_tpu_torch as T
from portrayer_tpu_torch.parallel import DIFF_FIELDS

from _torch_jax import recorded_bodies, recorded_loops, stand_in_graphs
from test_torch_unroll_tail import BG, FIT_CAPS, KEY, _port_fit, glass  # noqa: F401


@pytest.fixture(scope="module")
def fit_runs(glass):
    """(acc, gradients, stats, the program, host reads) through the
    captured fit program (stand-in graphs) under "captured", and the
    op-by-op trace's (acc, gradients, stats) under "eager"."""
    _, st, o, d = glass
    cfg = T.RenderConfig(device="cpu", accel="flat", queue_caps=FIT_CAPS)
    with pytest.MonkeyPatch.context() as mp:
        reads = stand_in_graphs(mp)
        acc, g, stats = _port_fit(st, o, d, cfg)
        (prog,) = st.packed.fit_programs.values()
        out = {"captured": (acc, g, stats, prog, list(reads.seen))}
        out["eager"] = _port_fit(st, o, d, dataclasses.replace(cfg, cuda_graphs=False))
    return out


@pytest.mark.parametrize("unroll", [False, True])
def test_fit_program_matches_jax(glass, fit_runs, unroll):
    """The captured fit program (rounds 3-9 one loop, forward and
    backward): the JAX package's trace and jax.grad of sum(acc^2) for
    DIFF_FIELDS with unroll_tail `unroll`, its live rays per round and
    dropped_w (the queues overflow); no host read."""
    js, _, o, d = glass
    acc, g, stats, prog, seen = fit_runs["captured"]
    n = o.shape[0]
    jcfg = P.RenderConfig(accel="flat", queue_caps=FIT_CAPS, unroll_tail=unroll)

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
    assert stats.dropped_w > 0.0 and int(stats.live[4]) > 0
    assert seen == [] and stats.syncs == 0
    bodies = recorded_bodies(prog.pl, prog.cfg.queue_slice_divs)
    assert [(x.bodies, x.loops) for x in prog.graphs.values()] == [(bodies, 1)] * 2
    assert recorded_loops(prog.pl) == 1
    assert [rd.r for rd in prog.rounds if rd.looped] == list(range(3, 10))


def test_fit_program_settings_agree_bit_for_bit(fit_runs):
    """The captured fit program (its tail one loop) against the op-by-op
    trace (every round unrolled, each pick read on the host): the same
    colours, gradients, live rays per round and dropped_w, bit for bit."""
    (acc, g, stats, *_), (eacc, eg, estats) = fit_runs["captured"], fit_runs["eager"]
    assert torch.equal(acc, eacc)
    for f in DIFF_FIELDS:
        assert torch.equal(g[f], eg[f]), f
    assert stats.live.tolist() == estats.live.tolist() and stats.dropped_w == estats.dropped_w
    assert estats.syncs > 0
