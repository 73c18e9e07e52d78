"""Chunk device microseconds of the steady stamped frame a thousand rays (program spans)."""

from harness.span_readings import device_us_per_kray as read  # noqa: F401
