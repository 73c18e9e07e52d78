"""Device time from a ``torch.profiler`` trace: a frozen copy of the
program's ``profile_render.py`` helpers (``_union_us``, ``summarize_trace``,
``after``, ``_traced``), kept here so that the yardstick does not move
with the program.  The trace file goes under TMPDIR and is deleted once
read."""

from __future__ import annotations

import collections
import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SWEEP_KERNEL = "sweep_kernel"


def union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def device_events(trace: dict) -> list:
    return [e for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def summarize(trace: dict, top: int = 10) -> dict:
    """Device-side summary of a Chrome-format trace: busy microseconds
    (the union of kernel, memcpy and memset intervals), kernel launches,
    kernel and sweep-kernel microseconds, the kernels that took most time
    ([name, seconds]) and the longest idle gaps between device intervals
    ([what the host was doing then, seconds])."""
    dev = device_events(trace)
    kernels = [e for e in dev if e["cat"] == "kernel"]
    by_name = collections.defaultdict(float)
    for e in kernels:
        by_name[e["name"]] += e["dur"]
    sweep_us = sum(v for k, v in by_name.items() if SWEEP_KERNEL in k)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "busy_us": union_us((e["ts"], e["ts"] + e["dur"]) for e in dev),
        "launches": len(kernels),
        "kernel_us": sum(e["dur"] for e in kernels),
        "sweep_us": sweep_us,
        "device_ops": [[name, us / 1e6] for name, us in ranked],
        "idle_gaps": idle_gaps(trace, dev, top),
    }


def idle_gaps(trace: dict, dev: list, top: int) -> list:
    """The `top` longest gaps between device intervals, each named by the
    host event (a CPU op or runtime call) that covers most of it."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in dev)
    gaps, end = [], None
    for s, e in spans:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    host = [e for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and e.get("cat") in ("cpu_op", "cuda_runtime", "user_annotation",
                                                         "python_function")]
    out = []
    for g0, g1 in gaps:
        best, name = 0.0, "host: no event"
        for e in host:
            cover = min(g1, e["ts"] + e["dur"]) - max(g0, e["ts"])
            if cover > best:
                best, name = cover, f"{e['cat']}: {e['name']}"
        out.append([name[:120], (g1 - g0) / 1e6])
    return out


def traced(fn, device):
    """(traced wall seconds, the Chrome trace as a dict) of fn() under
    ``torch.profiler``, synchronised at both ends (on a CUDA `device`)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return wall, json.load(f)
    finally:
        os.remove(path)
