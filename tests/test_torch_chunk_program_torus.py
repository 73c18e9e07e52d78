"""test_torch_chunk_program.py's captured-chunk check on torus-showcase (a
mirror torus over ten bounce rounds), in a file of its own: the plain
sweep's torus branch makes it the longest case, and the test run spreads
files over its workers."""

import pytest

from test_torch_chunk_program import check_captured_chunk, stand_in  # noqa: F401


@pytest.mark.parametrize("name", ["torus-showcase"])
def test_captured_steps_read_nothing_on_the_host(stand_in, name):  # noqa: F811
    """As in test_torch_chunk_program.py."""
    check_captured_chunk(stand_in, name)
