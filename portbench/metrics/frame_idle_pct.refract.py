"""Idle share of the steady stamped frame's wall (program spans)."""

from harness.span_readings import frame_idle_pct as read  # noqa: F401
