"""Idle share of the traced sample's wall (device trace)."""

from harness.readings import device_idle_pct as read  # noqa: F401
