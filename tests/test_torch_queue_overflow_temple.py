"""test_torch_queue_overflow.py's check on graphics-temple's stand-in
assets, in a file of its own: the JAX package's interpret-mode kernel
makes each case 20-55 s, and the test run spreads files over its
workers."""

import pytest

from test_torch_queue_overflow import check_overflow, standins  # noqa: F401


@pytest.mark.parametrize("unroll", [False, True])
def test_temple_overflow_matches_jax(standins, unroll):  # noqa: F811
    """graphics-temple (queue_caps (1.0, 0.75, 0.25)): the same live rays
    per round and dropped_w as the JAX package's trace, scanned or
    unrolled; its queues overflow on this grid."""
    assert check_overflow("graphics-temple", unroll).dropped_w > 0.0
