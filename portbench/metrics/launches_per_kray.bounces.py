"""Kernel launches a thousand primary rays (device trace)."""

from harness.readings import launches_per_kray as read  # noqa: F401
