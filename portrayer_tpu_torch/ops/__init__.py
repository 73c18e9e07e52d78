"""Intersection, sweep kernel, shading and the trace loop."""
