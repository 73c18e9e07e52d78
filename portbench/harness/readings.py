"""The arithmetic of the metrics that a run's record holds, shared by the
readers in ``portbench/metrics/`` (one file a metric, each naming its
formula here).  Each returns None where the record has nothing to read."""

from __future__ import annotations


def mrays_per_s(run):
    """Every primary ray of the window's whole frames over its wall, in
    millions a second."""
    w = run.get("window")
    if not w or "rays" not in w:
        return None
    return w["rays"] / w["seconds"] / 1e6


def _sample(run):
    s = run.get("sample")
    return s if s and s.get("launches") else None


def rays_per_chunk(run):
    """The traced sample's primary rays over its chunk replays."""
    s = _sample(run)
    return s["rays"] / s["chunks"] if s and s.get("chunks") else None


def launches_per_kray(run):
    """Kernel launches of the traced sample a thousand primary rays."""
    s = _sample(run)
    return s["launches"] / (s["rays"] / 1e3) if s else None


def other_us_per_kray(run):
    """Device microseconds of every kernel but the sweep's a thousand rays."""
    s = _sample(run)
    return (s["kernel_us"] - s["sweep_us"]) / (s["rays"] / 1e3) if s else None


def sweep_us_per_kray(run):
    """Device microseconds of the sweep kernels a thousand rays; nothing
    where the trace holds none."""
    s = _sample(run)
    return s["sweep_us"] / (s["rays"] / 1e3) if s and s["sweep_us"] else None


def device_idle_pct(run):
    """100 less the device's busy share of the traced sample's wall."""
    s = _sample(run)
    return 100.0 * (1.0 - s["busy_us"] / 1e6 / s["wall_s"]) if s and s.get("wall_s") else None


def peak_reserved_gib(run):
    """The reserved peak over the window, reset at its start, in GiB."""
    b = run.get("peak_reserved_bytes")
    return None if not b else b / 2**30
