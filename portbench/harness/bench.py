"""One run of one cell: find the cell, its configuration, its traffic mix,
its limits and its metrics' readers by name, run the program, judge what
it produced against the plain reference, and print the result.

Everything a cell, a configuration, a traffic mix or a metric brings is a
file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``BENCHMARK.json``'s ``configs[].file``: the configuration's data;
- ``portbench/traffic/<traffic>.json``: the mix (its ``mode`` names the
  runner, ``portbench/harness/mode_<mode>.py``; the rest are its
  parameters);
- ``portbench/limits/<cell>.json``: the limit of each number compared;
- ``portbench/metrics/<metric>.py``: ``read(run) -> float | None``;
- where the configuration names a scene family (``"scene": "<family>"``,
  ``harness/family.py``), ``portbench/harness/scene_<family>.py``, which
  builds its scene in the program, and ``portbench/reference/
  render_<family>.py``, which renders it plainly (without ``"scene"``:
  ``harness/scene.py`` and ``reference/render.py``).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
# Top-level modules that must not be loaded in the process that prints a
# result: JAX, its libraries and the JAX package the program was ported from.
FORBIDDEN = ("jax", "jaxlib", "flax", "portrayer_tpu")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


class Spec:
    """BENCHMARK.json and the files it names, under the checkout `root`."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.dir = os.path.join(root, os.path.basename(BENCH_DIR))
        self.bench = load_json(root, "BENCHMARK.json")

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        (c,) = [c for c in self.bench["configs"] if c["name"] == name]
        return load_json(self.root, c["file"])

    def traffic(self, name: str) -> dict:
        return load_json(self.dir, "traffic", f"{name}.json")

    def limits(self, cell: str) -> dict:
        return load_json(self.dir, "limits", f"{cell}.json")

    def metrics(self, cell: str, traced: bool) -> list:
        """The cell's end-to-end metrics (traced: its per-layer metrics)."""
        group = self.bench["per_layer" if traced else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def reader(self, name: str):
        return reader(name, self.dir)


def reader(name: str, bench_dir: str = BENCH_DIR):
    """The `read` function of <bench_dir>/metrics/<name>.py."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit, and none missing."""
    checks = {k: {"value": numbers.get(k), "limit": lim} for k, lim in limits.items()}
    ok = all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def run_cell(T, data: dict, traffic: dict, limits: dict, seed: int, seconds: float,
             traced: bool, device, t_start: float) -> dict:
    """Run a cell once; returns the run's record: what the metrics read,
    the device readings, and the judgement."""
    import torch

    cuda = torch.device(device).type == "cuda"
    mode = importlib.import_module(f"{__package__}.mode_{traffic['mode']}")
    record = mode.run(T, data, traffic, seed, seconds, traced, device, t_start)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers = record.pop("compare")()
    record["reference_s"] = time.perf_counter() - t0
    record["correct"], record["checks"] = judge(numbers, limits)
    return record


def result_line(spec: Spec, cell: str, record: dict, device_info: dict, traced: bool) -> dict:
    metrics = {}
    for m in spec.metrics(cell, traced):
        v = spec.reader(m["name"])(record)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": record["correct"], "attempted": record["attempted"],
           "failed": 0 if record["correct"] else 1, "metrics": metrics, "device": device_info}
    if traced:
        s = record["sample"]
        out["device"] = dict(device_info, busy_s=s["busy_us"] / 1e6, window_s=s["wall_s"])
        out["breakdown"] = {"device_ops": s["device_ops"], "idle_gaps": s["idle_gaps"]}
    out["checks"] = record["checks"]
    return out


def main(argv=None, t_start=None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = Spec()
    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import portrayer_tpu_torch as T

    dev = torch.device("cuda", 0)
    record = run_cell(T, spec.config(cell["config"]), spec.traffic(cell["traffic"]),
                      spec.limits(args.workload), args.seed, args.seconds, bool(args.trace),
                      dev, t_start)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": cell["chips"],
            "memory_peak_bytes": record["memory_peak_bytes"]}
    line = result_line(spec, args.workload, record, info, bool(args.trace))
    print(f"window {json.dumps(record['window'])}; the reference took "
          f"{record['reference_s']:.3f} s", file=sys.stderr)
    for k, c in record["checks"].items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
