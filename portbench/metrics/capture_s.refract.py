"""Seconds to capture the stamped chunk program (program spans)."""

from harness.span_readings import capture_s as read  # noqa: F401
