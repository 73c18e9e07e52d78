"""Captured CUDA graphs whose branches are picked on the device: the
counterpart of the JAX package's ``lax.switch`` inside one compiled
program (its trace.py ``round_r``).

``Graph(fn, pool)`` captures ``fn`` (a step that reads and writes only
buffers allocated outside it) as one CUDA graph, replayed by ``replay``.
Inside such a step, ``switch(sel, branches)`` runs ``branches[sel]``, sel
a 0-d int64 tensor on the device: while a graph captures, each branch that
is not None is recorded as the body of a conditional (IF) node that runs
only when sel equals its index, so each replay takes its branch on the
device and reads nothing on the host.  Off capture (the CPU, or a program
run op by op) switch reads sel on the host once and calls that branch.

The nodes come from the CUDA runtime through ``csrc/conditional.cu``
(PyTorch 2.11 has no Python call for them): a one-thread kernel sets the
node's handle from sel where the graph reaches it, so a body may change
what sel was computed from but not sel.  A body is recorded on a stream
of the graph's own, its allocations in a memory pool of its own that
lives as long as the graph; it may hold kernels and device copies, and no
event, side stream or copy to or from the host.  Launches of the sweep
kernel and of the conditional kernel in a body count on the device when
the body runs (``cuda_intersect.counts``).
"""

from __future__ import annotations

import torch

from . import _build
from .ops import cuda_intersect

# The Graph being captured, whose switch records conditional bodies.
_capturing = None


def _check(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"CUDA graph conditional node: {what} failed (CUDA error {rc})")


class Graph:
    """`fn` captured as one CUDA graph in memory pool `pool`; `bodies`
    counts the conditional bodies it recorded, `replays` its replays."""

    def __init__(self, fn, pool):
        global _capturing
        self.lib = _build.load()
        self.device = torch.device("cuda", torch.cuda.current_device())
        self.graph = torch.cuda.CUDAGraph()
        self.bodies = 0
        self.replays = 0
        self.body_stream = torch.cuda.Stream(self.device)
        self.body_pool = torch.cuda.graph_pool_handle()
        # Made before the capture that adds to them.
        self.if_count = cuda_intersect.device_counts(self.device)[
            cuda_intersect._MODES.index("graph_if"):]
        with torch.cuda.stream(self.body_stream):
            torch._C._cuda_beginAllocateCurrentStreamToPool(self.device.index, self.body_pool)
        _capturing = self
        try:
            with torch.cuda.graph(self.graph, pool=pool):
                fn()
        finally:
            _capturing = None
            torch._C._cuda_endAllocateToPool(self.device.index, self.body_pool)

    def switch(self, sel, branches):
        if sel.dtype != torch.int64 or sel.numel() != 1 or not sel.is_cuda:
            raise ValueError(f"switch: sel must be one int64 on the card, got {sel.dtype} "
                             f"{tuple(sel.shape)} on {sel.device}")
        stream = torch.cuda.current_stream().cuda_stream
        body = self.body_stream.cuda_stream
        for i, fn in enumerate(branches):
            if fn is None:
                continue
            _check(self.lib.cond_if_begin(stream, sel.data_ptr(), i, self.if_count.data_ptr(),
                                          body), "begin")
            try:
                with torch.cuda.stream(self.body_stream):
                    fn()
            finally:
                _check(self.lib.cond_if_end(body), "end")
            self.bodies += 1

    def replay(self):
        self.graph.replay()
        self.replays += 1

    def __del__(self):
        # The bodies' pool outlives them only as long as the graph.
        try:
            torch._C._cuda_releasePool(self.device.index, self.body_pool)
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
