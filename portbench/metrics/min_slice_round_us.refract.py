"""Median device microseconds of a bounce round on its smallest head slice (program spans)."""

from harness.span_readings import min_slice_round_us as read  # noqa: F401
