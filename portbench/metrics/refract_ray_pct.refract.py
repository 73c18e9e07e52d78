"""Refracted children over the live rays of the bounce rounds, counted frame (TraceStats.refr)."""

from harness.stats_readings import refract_ray_pct as read  # noqa: F401
