"""Spans of a render: where a frame's time goes, on the host and on the
device, on one clock.

A caller passes a ``Spans`` as ``spans=`` to ``Image.render``,
``render_u8`` or ``render_linear``, as it passes a list as ``stats=``.
The render then keeps one record a span in it, in memory:

- host spans, timed with ``time.perf_counter_ns``: ``frame`` (all of the
  render) and its phases ``tables`` (``flatten_scene``, when a Scene is
  passed), ``program`` (the chunk program's lookup or construction),
  ``start`` (rows and keys; on a program's first frame its ``warm_up``),
  ``issue`` (one ``tile`` a tile; ``capture`` where the chunk graph is
  captured), ``readback`` (the wait for the device) and ``assemble`` (the host
  copy of the tiles into the frame); the frame's counters and device
  spans are read after the ``frame`` span has closed, so that it holds
  none of the tracing's own work;
- device spans, from stamps that the chunk program writes on the device
  (``graphs.stamp``; inside the captured chunk graph on the card): one
  ``chunk`` a (tile x sample-chunk), and in it ``round 0`` and each
  bounce round ``round r`` that ran, with the lanes it ran on (``k``, the
  smallest of its head slices ``k_min``), the live rays entering it
  (``live``) and the refracted children among them (``refr``, 0 in a
  scene without a refractive material).  They are mapped onto the host
  clock by a stamp taken once a frame, after the frame, while the device
  is idle: the offset is the stamp less the midpoint of the host times
  around it, and half their distance is its uncertainty (the ``frame``
  span's ``clock_unc_ns``).

With ``spans=None`` the chunk program holds no stamp.  Under an active
``torch.profiler`` each host span site also opens
``record_function("portrayer.<name>")``, with or without a Spans, so that
a profiler trace names the program's phases around the device's work.

``Spans.events()`` returns the records as Chrome trace events, which
Perfetto (ui.perfetto.dev) or chrome://tracing open once dumped with
``json.dump({"traceEvents": spans.events()}, f)``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

# Chrome trace threads of the host spans and of the device spans.
HOST_TID, DEVICE_TID = 1, 2


@dataclasses.dataclass
class Span:
    """One span: its name, id, the id of the span that holds it (None for
    a frame), the index of its frame within its Spans, start and end (ns
    on time.perf_counter_ns's clock) and a few attributes."""
    name: str
    id: int
    parent: Optional[int]
    frame: int
    t0_ns: int
    t1_ns: int
    attrs: dict

    @property
    def device(self) -> bool:
        return self.name == "chunk" or self.name.startswith("round ")


class Spans:
    """The spans of the renders it was passed to, in memory (`records`,
    in the order they opened; device spans after their frame's host
    spans).  `frames` counts the frames begun."""

    def __init__(self):
        self.records = []
        self.frames = 0
        self._open = []  # the open host spans, outermost first

    def add(self, name: str, t0_ns: int, t1_ns: int, parent: Optional[int], **attrs) -> Span:
        """A span of the current frame, timed by the caller."""
        rec = Span(name, len(self.records), parent, self.frames - 1, int(t0_ns), int(t1_ns),
                   attrs)
        self.records.append(rec)
        return rec

    def _enter(self, name: str, t0_ns: int, attrs: dict) -> Span:
        if name == "frame":
            self.frames += 1
        rec = self.add(name, t0_ns, t0_ns, self._open[-1].id if self._open else None, **attrs)
        self._open.append(rec)
        return rec

    def _exit(self, rec: Span, t1_ns: int):
        rec.t1_ns = t1_ns
        self._open.remove(rec)

    def events(self) -> list:
        """The spans as Chrome trace events ("X", microseconds): the host
        spans on one thread, the device spans on another; each event's
        args hold its id, parent, frame and attributes."""
        out = [{"ph": "M", "name": "thread_name", "pid": 1, "tid": tid, "args": {"name": name}}
               for tid, name in ((HOST_TID, "host"), (DEVICE_TID, "device"))]
        for s in self.records:
            out.append({"ph": "X", "name": s.name, "cat": "portrayer", "pid": 1,
                        "tid": DEVICE_TID if s.device else HOST_TID, "ts": s.t0_ns / 1e3,
                        "dur": (s.t1_ns - s.t0_ns) / 1e3,
                        "args": dict(s.attrs, id=s.id, parent=s.parent, frame=s.frame)})
        return out


class _Site:
    """An open span site: its Span in `spans` (if any) and its profiler
    range (if a profiler is on); `seconds` once it has closed."""

    __slots__ = ("spans", "name", "attrs", "rec", "range", "t0", "t1")

    def __init__(self, spans: Optional[Spans], name: str, attrs: dict):
        self.spans, self.name, self.attrs = spans, name, attrs
        self.rec = self.range = None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self.range = torch.autograd.profiler.record_function("portrayer." + self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        if self.spans is not None:
            self.rec = self.spans._enter(self.name, self.t0, self.attrs)
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.rec is not None:
            self.spans._exit(self.rec, self.t1)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False

    def set(self, **attrs):
        if self.rec is not None:
            self.rec.attrs.update(attrs)

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9


class _Off:
    """A span site with nothing to record."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_OFF = _Off()


def span(spans: Optional[Spans], name: str, clock: bool = False, **attrs):
    """A context manager around one span site: it records the span `name`
    in `spans`, opens a profiler range where a profiler is on, and with
    `clock` times itself either way (its `seconds`).  Otherwise it does
    nothing."""
    if spans is None and not clock and not torch.autograd._profiler_enabled():
        return _OFF
    return _Site(spans, name, attrs)
