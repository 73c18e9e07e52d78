"""Live rays of the bounce rounds per primary ray, counted frame (TraceStats.live)."""

from harness.stats_readings import bounce_rays_per_primary as read  # noqa: F401
