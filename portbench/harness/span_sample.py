"""The spans sample of a traced render run: two whole frames rendered with
the program's own spans (``spans=T.Spans()``) and no profiler.  The first
builds, warms up and captures the stamped chunk program; the second, with
``stats=``, is the steady frame.

The sample is taken the first time a reader of ``span_readings`` asks for
it, that is after the run's window, traced sample and comparison, on a
render cell built anew (by the configuration's scene family, with its
RenderConfig overrides): nothing measured before it moves.  Its cell and
seed are the run's own, read from the command line (``--workload``,
``--seed``).  A program without ``Spans`` gives no sample, and the readers
then read nothing."""

from __future__ import annotations

import argparse
import sys

import torch

from . import bench
from . import mode_render


def take(T, data: dict, traffic: dict, seed: int, device) -> dict | None:
    """{"spans": the two frames' spans as Chrome trace events, "span_stats":
    the steady frame's live rays and launched lanes a chunk}; None where
    the program has no spans."""
    if not hasattr(T, "Spans"):
        return None
    cell = mode_render.RenderCell(T, data, traffic, seed, device)
    spans, stats = T.Spans(), []
    cell.image.render(cell.tables, cell.camera, cell.background, cell.cfg, spans=spans)
    cell.image.render(cell.tables, cell.camera, cell.background, cell.cfg, spans=spans,
                      stats=stats)
    mode_render.sync(cell.cfg.device)
    return {"spans": spans.events(),
            "span_stats": [{"live": s.live.tolist(), "lanes": s.lanes.tolist()}
                           for s in stats]}


def command_line_cell():
    """(T, data, traffic, seed, device) of the render cell this process
    runs, from its command line and ``BENCHMARK.json``; None where the
    process runs no render cell of the benchmark."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    args, _ = ap.parse_known_args(sys.argv[1:])
    T = sys.modules.get("portrayer_tpu_torch")
    if args.workload is None or args.seed is None or T is None:
        return None
    spec = bench.Spec()
    cell = spec.cell(args.workload)
    traffic = spec.traffic(cell["traffic"])
    if traffic.get("mode") != "render":
        return None
    return T, spec.config(cell["config"]), traffic, args.seed, torch.device("cuda", 0)


def of(run: dict) -> dict:
    """`run`, holding its spans sample under "spans" and "span_stats" (None
    where there is none).  A record that holds neither yet and is a run's
    (it has a window) gets them now, once."""
    if "spans" not in run and "span_stats" not in run:
        cell = command_line_cell() if run.get("window") else None
        run.update((take(*cell) if cell else None) or {"spans": None, "span_stats": None})
    return run
