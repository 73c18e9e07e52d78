"""Captured CUDA graphs that branch and loop on the device: the
counterparts of the JAX package's ``lax.switch``, ``lax.scan`` and
``lax.while_loop`` inside one compiled program (its trace.py ``round_r``,
the scan over the tail of equal capacity, and the beam sweep's ordered
walk in its beam.py).

``Graph(fn, pool)`` captures ``fn`` (a step that reads and writes only
buffers allocated outside it) as one CUDA graph, replayed by ``replay``.
Inside such a step, ``switch(sel, branches)`` runs ``branches[sel]``, sel
a 0-d int64 tensor on the device: while a graph captures, each branch that
is not None is recorded as the body of a conditional (IF) node that runs
only when sel equals its index, so each replay takes its branch on the
device and reads nothing on the host.  ``loop(index, end, live, body)``
runs body while live > 0 and index < end, adding one to index after each
run: while a graph captures, body is recorded once as the body of a WHILE
node, and may itself call switch, whose branches may call loop.  Off
capture (the CPU, or a program run op by op) switch reads sel on the
host once and calls that branch, and loop reads its condition on the
host once an iteration.

The nodes come from the CUDA runtime through ``csrc/conditional.cu``
(PyTorch 2.11 has no Python call for them): a one-thread kernel sets an IF
node's handle from sel where the graph reaches it, so a body may change
what sel was computed from but not sel; a one-thread step kernel sets a
WHILE node's handle before the node and at the end of each iteration.  A
body is recorded on a body stream (made once a device, outside PyTorch's
pool of streams, which hands its streams out in turn and would in time
hand out the stream a graph is captured on), its allocations in a memory
pool of the graph's own for that stream, which lives as long as the
graph: a body's temporaries are freed at its end and their memory is
reused by the next body on its stream and by the next run, which is
sound because those run one after another.  The allocator reuses a
block only on the stream it was made on, so every IF body, in a loop or
not, shares one stream: then a loop's slices reuse the memory of the
unrolled rounds' slices.  An IF body may not nest in another IF body.  A
WHILE body is recorded on the stream of its depth among the open WHILE
bodies: the first for a loop that no loop holds, the second for a loop
inside a loop's body (the beam sweep's loop inside a bounce round's
slice inside the loop over the tail).  A body may hold kernels and
device copies, and no event, side stream or copy to or from the host;
nothing it makes lives past its end except in buffers allocated outside
the graph.
Launches of the sweep kernel, the conditional kernel and the step kernel
in a body count on the device when the body runs
(``cuda_intersect.counts``).

``stamp(table, row, col)`` writes the time now into a table on the
device where the stream, or a replay, reaches it: the spans of a render
(``spans.py``) are read from such stamps inside the captured chunk.
"""

from __future__ import annotations

import ctypes
import gc
import time

import torch

from . import _build, counters
from .ops import cuda_intersect

# The Graph being captured, whose switch and loop record bodies.
_capturing = None
# The body streams: every IF body's, then the WHILE bodies' by depth.
_SLOTS = ("if", "while", "inner while")
# {device index: {slot: its body stream}}.
_STREAMS = {}


def _check(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"graphs: {what} failed (CUDA error {rc})")


def _body_streams(lib, device) -> dict:
    """The body stream of each slot on `device`, made at first call
    (outside every capture)."""
    if device.index not in _STREAMS:
        streams = {}
        for slot in _SLOTS:
            handle = ctypes.c_void_p()
            with torch.cuda.device(device):
                _check(lib.cond_stream_create(ctypes.addressof(handle)), "stream create")
            streams[slot] = torch.cuda.ExternalStream(handle.value, device=device)
        _STREAMS[device.index] = streams
    return _STREAMS[device.index]


def _check_scalar(name, x):
    if x.dtype != torch.int64 or x.numel() != 1 or not x.is_cuda:
        raise ValueError(f"{name} must be one int64 on the card, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


class Graph:
    """`fn` captured as one CUDA graph in memory pool `pool`; `bodies`
    counts the conditional (IF) bodies it recorded, `loops` its WHILE
    nodes (nested ones too), `stamps` its stamp nodes (in bodies too),
    `replays` its replays."""

    def __init__(self, fn, pool):
        global _capturing
        self.lib = _build.load()
        self.device = torch.device("cuda", torch.cuda.current_device())
        self.graph = torch.cuda.CUDAGraph()
        self.bodies = 0
        self.loops = 0
        self.stamps = 0
        self.replays = 0
        self.open = []  # the slots of the bodies being recorded, outermost first
        self.streams = _body_streams(self.lib, self.device)
        self.pools = {slot: torch.cuda.graph_pool_handle() for slot in _SLOTS}
        # Every kernel module's counters, made before the capture that adds
        # to them.
        counters.make_all(self.device)
        counts = cuda_intersect.device_counts(self.device)
        self.if_count = counts[cuda_intersect._MODES.index("graph_if"):]
        self.while_count = counts[cuda_intersect._MODES.index("graph_while"):]
        for slot in _SLOTS:
            with torch.cuda.stream(self.streams[slot]):
                torch._C._cuda_beginAllocateCurrentStreamToPool(self.device.index,
                                                                self.pools[slot])
        _capturing = self
        # No garbage collection while capturing: a dead program's graph,
        # kept by a reference cycle, freed then would reset its CUDA graph,
        # a call that ends this capture.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, pool=pool):
                fn()
        finally:
            if collecting:
                gc.enable()
            _capturing = None
            for body_pool in self.pools.values():
                torch._C._cuda_endAllocateToPool(self.device.index, body_pool)

    def _slot(self, kind) -> str:
        """The slot that records a body of `kind` ("if" or "while") here:
        not one whose capture is open."""
        if kind == "if":
            if "if" in self.open:
                raise RuntimeError("graphs: IF bodies do not nest")
            return "if"
        depth = sum(slot != "if" for slot in self.open)
        if depth >= len(_SLOTS) - 1:
            raise RuntimeError(f"graphs: WHILE bodies nest at most {len(_SLOTS) - 1} deep")
        return _SLOTS[1 + depth]

    def _body(self, slot, fn):
        """Record fn on the body stream of `slot`, whose capture the caller
        has begun."""
        self.open.append(slot)
        try:
            with torch.cuda.stream(self.streams[slot]):
                fn()
        finally:
            self.open.pop()

    def switch(self, sel, branches):
        _check_scalar("switch: sel", sel)
        stream = torch.cuda.current_stream().cuda_stream
        slot = self._slot("if")
        body = self.streams[slot].cuda_stream
        for i, fn in enumerate(branches):
            if fn is None:
                continue
            _check(self.lib.cond_if_begin(stream, sel.data_ptr(), i, self.if_count.data_ptr(),
                                          body), "conditional begin")
            try:
                self._body(slot, fn)
            finally:
                _check(self.lib.cond_if_end(body), "conditional end")
            self.bodies += 1

    def loop(self, index, end: int, live, body):
        _check_scalar("loop: index", index)
        _check_scalar("loop: live", live)
        stream = torch.cuda.current_stream().cuda_stream
        slot = self._slot("while")
        body_stream = self.streams[slot].cuda_stream
        handle = ctypes.c_ulonglong()
        args = (index.data_ptr(), end, live.data_ptr(), self.while_count.data_ptr())
        _check(self.lib.cond_while_begin(stream, *args, body_stream, ctypes.addressof(handle)),
               "while begin")
        try:
            self._body(slot, body)
        finally:
            _check(self.lib.cond_while_end(body_stream, handle.value, *args), "while end")
        self.loops += 1

    def replay(self):
        self.graph.replay()
        self.replays += 1

    def __del__(self):
        # The bodies' pools outlive them only as long as the graph.
        for body_pool in getattr(self, "pools", {}).values():
            try:
                torch._C._cuda_releasePool(self.device.index, body_pool)
            except Exception:
                pass


def switch(sel: torch.Tensor, branches) -> int | None:
    """Run branches[sel] (None: nothing).  Under a Graph's capture, records
    every branch as a conditional body and returns None; otherwise reads
    sel on the host and returns it."""
    if _capturing is not None:
        _capturing.switch(sel, branches)
        return None
    i = int(sel)
    if branches[i] is not None:
        branches[i]()
    return i


def loop(index: torch.Tensor, end: int, live: torch.Tensor, body) -> int | None:
    """While live > 0 and index < end: body(), then index += 1 (index and
    live 0-d int64 tensors on the device; body may change live, and reads
    index).  The counterpart of lax.scan over the rounds [index, end) with
    the dead branch as an early exit, and of lax.while_loop.  Under a Graph's capture, records
    body once as a WHILE node's body and returns None; otherwise reads the
    condition on the host before each iteration and once at the exit, and
    returns the number of those reads."""
    if _capturing is not None:
        _capturing.loop(index, end, live, body)
        return None
    reads = 0
    while True:
        reads += 1
        if not bool((live > 0) & (index < end)):
            return reads
        body()
        index.add_(1)


def stamp(table: torch.Tensor, row: torch.Tensor, col, shift: int = 0):
    """table[row, col + shift] = the time now, in ns (table [rows, cols]
    int64, row a 0-d int64 tensor on its device, col an int or such a
    tensor: both read where the stamp runs).  On the card a one-thread
    kernel reads %globaltimer where the stream reaches it, and under a
    Graph's capture it is a node of the graph, run at every replay; on the
    CPU it writes time.perf_counter_ns() with one index_fill_.  Nothing is
    read on the host."""
    n_cols = table.shape[1]
    if isinstance(col, int) and not 0 <= col + shift < n_cols:
        raise ValueError(f"stamp: column {col + shift} outside [0, {n_cols})")
    if not table.is_cuda:
        index = row * n_cols + col + shift
        table.view(-1).index_fill_(0, index.reshape(1), time.perf_counter_ns())
        return
    if table.dtype != torch.int64 or not table.is_contiguous():
        raise ValueError(f"stamp: table must be contiguous int64, got {table.dtype}")
    _check_scalar("stamp: row", row)
    if isinstance(col, torch.Tensor):
        _check_scalar("stamp: col", col)
        col, col_at = shift, col.data_ptr()
    else:
        col, col_at = col + shift, None
    lib = _build.load()
    _check(lib.stamp_time(torch.cuda.current_stream().cuda_stream, table.data_ptr(),
                          row.data_ptr(), n_cols, col, col_at), "stamp")
    if _capturing is not None:
        _capturing.stamps += 1
