"""Device us of the sweep kernels a thousand rays (device trace)."""

from harness.readings import sweep_us_per_kray as read  # noqa: F401
