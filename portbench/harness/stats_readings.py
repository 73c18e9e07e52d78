"""The arithmetic of the metrics read from the ``TraceStats`` of the frame
that a run counts after its window (``record["stats"]``, one a chunk;
present where the configuration's scene family compares numbers besides
the frame, ``harness/family.py``).  Each returns None where the record has
nothing to read: no counted frame, or a program whose ``TraceStats`` has
no ``refr`` (refracted children among the live rays entering each
round)."""

from __future__ import annotations


def _stats(run):
    stats = run.get("stats")
    if not stats or any(getattr(s, "refr", None) is None for s in stats):
        return None
    return stats


def _bounce_rays(stats) -> int:
    """The live rays entering rounds 1 and later, summed over the frame."""
    return sum(int(v) for s in stats for v in s.live[1:])


def refract_ray_pct(run):
    """100 times the refracted children over all live rays entering rounds 1
    and later, whole frame."""
    stats = _stats(run)
    if stats is None:
        return None
    live = _bounce_rays(stats)
    return 100.0 * sum(int(v) for s in stats for v in s.refr[1:]) / live if live else None


def bounce_rays_per_primary(run):
    """The live rays entering rounds 1 and later per primary ray (the live
    rays entering round 0), whole frame."""
    stats = _stats(run)
    if stats is None:
        return None
    primary = sum(int(s.live[0]) for s in stats)
    return _bounce_rays(stats) / primary if primary else None
