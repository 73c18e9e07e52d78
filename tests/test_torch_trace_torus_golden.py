"""torus-showcase's u8 render through the port's render loop against the
JAX package's and the self-golden, in a file of its own (the longest
check of tests/test_torch_trace.py's bounce loop; the test run spreads
files over its workers).

Tolerance: the rule of tests/test_golden.py (fewer than 0.1% of pixels
off by more than 2/255) against the JAX package's render without jit,
and against the self-golden on every pixel but those where that JAX
render itself is off from the golden (see the test).
"""

import os

import numpy as np
import jax

import chip_smoke
import scenes
import portrayer_tpu as P
import portrayer_tpu_torch as T
from portrayer_tpu_torch import image_io, scenes as tscenes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_render_u8_torus_showcase_matches_self_golden():
    """torus-showcase at the self-golden's 64x64, 4 spp, seed 0, tile 64
    (tools/gen_self_goldens.py), through the port's render loop.  Against
    the JAX package's render run op by op (no jit): the self-golden rule.
    The golden was rendered jitted, where XLA contracts the torus quartic's
    mul+adds into FMAs; the f32 roots move within the torus gate and x^160
    highlights carry that into the colour, so the JAX package's own op-by-op
    render is off from its golden on a few torus pixels.  Those pixels are
    chip_smoke.TORUS_JIT_PIXELS (chip_smoke.py's golden phase has no JAX to
    find them); on every other pixel the port keeps the self-golden rule."""
    spec = tscenes.load("torus-showcase")
    cfg = T.RenderConfig(device="cpu", samples=4, tile=(64, 64), seed=0)
    ours = T.render_u8(spec.scene, spec.camera, (64, 64), spec.background, cfg)
    jspec = scenes.load("torus-showcase")
    with jax.disable_jit():
        ref = np.asarray(P.render_u8(jspec.scene, jspec.camera, (64, 64), jspec.background,
                                     P.RenderConfig(samples=4, tile=(64, 64), seed=0,
                                                    accel="flat", node_chunk=128)))
    gold = image_io.read_png(os.path.join(ROOT, "tests", "self_golden", "torus-showcase.png"))
    assert ours.shape == gold.shape == ref.shape

    def off(a, b):
        return (np.abs(a.astype(np.int16) - b.astype(np.int16)) > 2).any(axis=-1).reshape(-1)

    assert off(ours, ref).mean() < 1e-3, f"{off(ours, ref).mean():.2%} pixels differ from JAX"
    jit_pixels = np.nonzero(off(ref, gold))[0]
    assert jit_pixels.tolist() == list(chip_smoke.TORUS_JIT_PIXELS)
    rest = off(ours, gold)
    rest[jit_pixels] = False
    assert rest.mean() < 1e-3, f"{rest.mean():.2%} pixels differ from the golden"
