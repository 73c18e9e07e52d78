"""Device us of every kernel but the sweep's a thousand rays (device trace)."""

from harness.readings import other_us_per_kray as read  # noqa: F401
