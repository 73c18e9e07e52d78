"""Primary rays a chunk replay (TraceStats through stats=)."""

from harness.readings import rays_per_chunk as read  # noqa: F401
