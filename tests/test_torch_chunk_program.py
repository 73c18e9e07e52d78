"""The render's chunk program (render.py ``_ChunkProgram``) on the CPU:
the chunk that the card captures as one CUDA graph reads nothing on the
host, bounce rounds and all, replaying it gives the image of the op-by-op
chunk loop, and the render through the per-chunk row table equals the JAX
package's render_linear.

On the CPU a render runs its program op by op.  Here
tests/_torch_jax.py's StandInGraph takes the capture's place: it records
the chunk and runs it at each replay under HostReads, which sees every op
that on the card would read a value on the host or copy host data to the
card (a capture refuses both).  Its switch, the stand-in conditional,
picks each round's slice with its read of sel excused, since on the card
the graph evaluates it; the sweep's plain version, which stands in for
the kernel, is excused too.

Tolerances, with their reasons:
- stand-in capture against the op-by-op loop: equal bit for bit (the same
  ops on the same inputs, on the CPU).  On the card the captured render
  differs by index_add's atomics only (tests/test_torch_cuda.py, 1e-6).
- against the JAX package's jitted render_linear: test_torch_render.py's
  image rule (at most 1% of pixels off by more than 1e-4, none by more
  than 2e-2), for XLA's FMA contraction.
"""

import dataclasses

import numpy as np
import pytest

import scenes
import portrayer_tpu as P
import portrayer_tpu_torch as T
from portrayer_tpu_torch import render, scenes as tscenes

from _torch_jax import INLINE, recorded_bodies, recorded_loops, stand_in_graphs
from test_torch_render import assert_images_close

# Small frames in tiles of 16x16 and chunks of 4 spp: 6 spp is two chunks,
# the second padded with dead samples.
SIZE = (48, 32)
CFG = dict(device="cpu", samples=6, tile=(16, 16), max_rays_per_launch=1024, seed=0)


@pytest.fixture
def stand_in(monkeypatch):
    """Renders with cuda_graphs on the CPU go through the capturing
    program, with StandInGraph for the graph; returns the HostReads."""
    return stand_in_graphs(monkeypatch)


def _spec(name):
    if name in INLINE:
        scene, camera, _ = INLINE[name](T)
        return tscenes.SceneSpec(scene=scene, camera=camera, size=SIZE,
                                 background=tscenes.sky_background, name=name)
    return tscenes.load(name)


def check_captured_chunk(stand_in, name):
    """The body of test_captured_steps_read_nothing_on_the_host."""
    spec = _spec(name)
    st = T.flatten_scene(spec.scene, "cpu")
    cfg = T.RenderConfig(**CFG, queue_caps=spec.queue_caps)
    args = (st, spec.camera, SIZE, spec.background)
    stats, eager_stats = [], []
    got = T.render_linear(*args, cfg, stats=stats)
    assert stand_in.seen == []
    ref = T.render_linear(*args, dataclasses.replace(cfg, cuda_graphs=False), stats=eager_stats)
    np.testing.assert_array_equal(got, ref)
    assert [(s.live.tolist(), s.dropped_w) for s in stats] == \
        [(s.live.tolist(), s.dropped_w) for s in eager_stats]
    assert all(s.syncs == 0 for s in stats)
    (prog,) = st.chunk_programs.values()
    chunks = len(stats)
    assert chunks == 6 * 2 and list(prog.graphs) == ["chunk"]
    assert prog.graphs["chunk"].replays == chunks
    D = prog.pl.max_depth
    assert prog.graphs["chunk"].bodies == recorded_bodies(prog.pl, cfg.queue_slice_divs)
    assert prog.graphs["chunk"].loops == recorded_loops(prog.pl)
    # Op by op, a chunk reads each round's pick up to its first dead round.
    assert [s.syncs for s in eager_stats] == [min(D, int((s.live[1:] > 0).sum()) + 1) if D
                                              else 0 for s in eager_stats]
    if st.any_reflective:
        assert any(s.live[2] > 0 for s in stats)  # a chunk that bounces twice


# four-shapes has big-scene's four kinds (sphere, cube, cylinder, cone)
# in four nodes; the others add mirrors, glossy draws, refraction and
# total internal reflection (the glass sphere), textures and an area light.
# torus-showcase is in tests/test_torch_chunk_program_torus.py.
@pytest.mark.parametrize("name", ["four-shapes", "glossy-reflection", "glass-sphere",
                                  "normal-mapping-numpy", "soft-shadows-icosphere"])
def test_captured_steps_read_nothing_on_the_host(stand_in, name):
    """The captured chunk replayed under HostReads reads nothing on the
    host, each bounce round's slice picked by the stand-in conditional:
    every chunk's TraceStats.syncs is 0, and the replays give the op-by-op
    loop's image, live rays per round and dropped_w bit for bit.  A chunk
    is one graph with a conditional body per slice of each unrolled bounce
    round and of the loop over the tail of equal capacity;
    op by op a chunk reads each round's pick on the host."""
    check_captured_chunk(stand_in, name)


def test_a_step_that_reads_on_the_host_is_seen(stand_in):
    """The check has teeth: a background that reads a value on the host
    is recorded."""
    spec = tscenes.load("simple")

    def background(uv):
        return tscenes.sky_background(uv) * float(uv.max() >= 0.0)

    T.render_linear(spec.scene, spec.camera, SIZE, background, T.RenderConfig(**CFG))
    assert stand_in.seen and all("_local_scalar_dense" in s for s in stand_in.seen)


def test_program_cache_replays_across_renders(stand_in):
    """A second render of the same tables and settings replays the cached
    program (no warm-up, no new step); other settings get their own
    program, and the tables keep at most render._MAX_PROGRAMS."""
    spec = tscenes.load("simple")
    st = T.flatten_scene(spec.scene, "cpu")
    cfg = T.RenderConfig(**CFG)
    args = (st, spec.camera, SIZE, spec.background)
    first = T.render_u8(*args, cfg)
    (prog,) = st.chunk_programs.values()
    head = prog.graphs["chunk"]
    np.testing.assert_array_equal(T.render_u8(*args, cfg), first)
    assert st.chunk_programs == {next(iter(st.chunk_programs)): prog}
    assert prog.graphs == {"chunk": head} and head.replays == 2 * 12
    region = ((16, 0), (31, 15))
    part = T.render_linear(*args, cfg, region=region)
    assert head.replays == 2 * 12 + 2  # the one tile's two chunks
    np.testing.assert_array_equal(part[:16, 16:32],
                                  T.render_linear(*args, cfg)[:16, 16:32])
    for seed in (1, 2, 3):
        T.render_u8(*args, dataclasses.replace(cfg, seed=seed))
    assert len(st.chunk_programs) == render._MAX_PROGRAMS
    assert stand_in.seen == []


@pytest.mark.parametrize("name", ["simple", "glossy-reflection"])
def test_render_through_the_row_table_matches_jax(name):
    """Six tiles of two sample chunks each, their origins, sample offsets
    and chunk indices read from the program's row table: the JAX package's
    render_linear (jitted, accel="flat") at the same settings."""
    spec, jspec = tscenes.load(name), scenes.load(name)
    ours = T.render_linear(spec.scene, spec.camera, SIZE, spec.background,
                           T.RenderConfig(**CFG))
    jcfg = P.RenderConfig(accel="flat", **{k: v for k, v in CFG.items() if k != "device"})
    ref = np.asarray(P.render_linear(jspec.scene, jspec.camera, SIZE, jspec.background, jcfg))
    assert_images_close(ours, ref)
