"""Reserved peak over the window (the allocator's counter)."""

from harness.readings import peak_reserved_gib as read  # noqa: F401
