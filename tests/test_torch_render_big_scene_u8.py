"""big-scene's render_u8 against its self-golden and the JAX package's,
at the self-golden's 160x82 (test_torch_render.py's check, in a file of
its own: it is among the longest cases, and the test run spreads files
over its workers)."""

import pytest

import test_torch_render as base


@pytest.mark.parametrize("name", ["big-scene"])
def test_render_u8_matches_self_golden_and_jax(name):
    """As in test_torch_render.py."""
    base.test_render_u8_matches_self_golden_and_jax(name)
