"""Seconds of the stamped chunk program's warm-up (program spans)."""

from harness.span_readings import warm_up_s as read  # noqa: F401
