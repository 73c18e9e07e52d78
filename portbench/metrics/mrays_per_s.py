"""Primary-ray rate of a cell without bounce rounds (host clock)."""

from harness.readings import mrays_per_s as read  # noqa: F401
