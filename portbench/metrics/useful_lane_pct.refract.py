"""Live rays over launched lanes of the bounce rounds, steady frame (program counters)."""

from harness.span_readings import useful_lane_pct as read  # noqa: F401
