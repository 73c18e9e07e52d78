"""Device microseconds after round 0 a thousand rays, steady stamped frame (program spans)."""

from harness.span_readings import bounce_us_per_kray as read  # noqa: F401
