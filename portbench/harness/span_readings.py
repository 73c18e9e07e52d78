"""The arithmetic of the metrics read from the program's own spans: the
raw span records of a traced run's spans sample (``span_sample.py``: two
whole frames rendered with ``spans=``, the first of which warms up and
captures the stamped chunk program, the second the steady frame), as
Chrome trace events under ``record["spans"]``, and the steady frame's live
rays and launched lanes per chunk (``TraceStats``) under
``record["span_stats"]``.  The program reduces nothing that these readings
rely on.  Each returns None where the record has nothing to read (a
program without spans)."""

from __future__ import annotations

import statistics

from . import span_sample
from .trace import union_us


def _frame(run, which: str):
    """(the frame's event, the events of its frame): `which` "first" or
    "steady" (the last frame of the sample)."""
    events = [e for e in span_sample.of(run).get("spans") or [] if e.get("ph") == "X"]
    frames = [e for e in events if e["name"] == "frame"]
    if not frames:
        return None, []
    f = frames[0] if which == "first" else frames[-1]
    n = f["args"]["frame"]
    return f, [e for e in events if e["args"]["frame"] == n]


def _chunks(run):
    frame, events = _frame(run, "steady")
    return frame, [e for e in events if e["name"] == "chunk"], events


def _kray(frame) -> float:
    return frame["args"]["rays"] / 1e3


def frame_idle_pct(run):
    """100 less the share of the steady frame's span W that the union of
    its chunks' device spans (first to last stamp, on the host clock),
    clipped to W, covers."""
    frame, chunks, _ = _chunks(run)
    if not chunks:
        return None
    w0, w1 = frame["ts"], frame["ts"] + frame["dur"]
    clipped = [(max(c["ts"], w0), min(c["ts"] + c["dur"], w1)) for c in chunks]
    busy = union_us((a, b) for a, b in clipped if b > a)
    return 100.0 * (1.0 - busy / frame["dur"])


def device_us_per_kray(run):
    """The steady frame's chunks' device microseconds (end less start
    stamp, summed) a thousand primary rays."""
    frame, chunks, _ = _chunks(run)
    if not chunks:
        return None
    return sum(c["dur"] for c in chunks) / _kray(frame)


def bounce_us_per_kray(run):
    """The device microseconds of the steady frame's chunks after their
    round 0 (chunk end less round-0 end, summed) a thousand primary
    rays."""
    frame, chunks, events = _chunks(run)
    if not chunks:
        return None
    round0 = {e["args"]["parent"]: e for e in events if e["name"] == "round 0"}
    total = 0.0
    for c in chunks:
        r0 = round0[c["args"]["id"]]
        total += (c["ts"] + c["dur"]) - (r0["ts"] + r0["dur"])
    return total / _kray(frame)


def min_slice_round_us(run):
    """The median device microseconds of the steady frame's bounce rounds
    that ran on the smallest head slice of their queue (k == k_min): the
    fixed cost of a round."""
    _, _, events = _chunks(run)
    durs = [e["dur"] for e in events if e["name"].startswith("round ")
            and e["args"]["r"] >= 1 and e["args"]["k"] == e["args"]["k_min"]]
    return statistics.median(durs) if durs else None


def useful_lane_pct(run):
    """100 times the live rays entering the steady frame's bounce rounds
    over the lanes those rounds ran on (TraceStats.live and .lanes,
    rounds 1 on; a round that did not run has neither)."""
    stats = span_sample.of(run).get("span_stats")
    if not stats:
        return None
    live = sum(v for s in stats for v, k in zip(s["live"][1:], s["lanes"][1:]) if k)
    lanes = sum(k for s in stats for k in s["lanes"][1:])
    return 100.0 * live / lanes if lanes else None


def _first_frame_s(run, name: str):
    _, events = _frame(run, "first")
    found = [e["dur"] for e in events if e["name"] == name]
    return found[0] / 1e6 if found else None


def capture_s(run):
    """Seconds of the first frame's capture span: the stamped chunk
    program captured as one CUDA graph."""
    return _first_frame_s(run, "capture")


def warm_up_s(run):
    """Seconds of the first frame's warm_up span: the stamped chunk
    program's op-by-op chunk and each bounce round at each slice shape."""
    return _first_frame_s(run, "warm_up")
