"""The water-glass cell (configuration ``water-glass``, scene family
``water_glass``): a run at its own size on the card is correct; at the CPU
test size, loaded as a run loads it (a fresh process) and traced,
every per-layer metric of the cell reads a number; the stand-in texel
generator gives the same arrays on every call; every new metric reads
None on an empty record and on a counted frame without ``refr``."""

import copy
import os
import subprocess
import sys
import types

import numpy as np
import pytest

import portrayer_tpu_torch as T
from portrayer_tpu_torch import graphs
from harness import bench, span_sample
from harness import stats_readings as ST
from reference import texels

from _small import small_cell

CELL = "water-glass.spp100"
SEED = 2**31 + 77
SPEC = bench.Spec()
NEW = [m["name"] for m in SPEC.bench["per_layer"] if m.get("workloads") == [CELL]]


@pytest.mark.cuda
def test_the_cell_runs_on_the_card(card):
    """A short run of the cell at its own size on the card: correct, no
    child dropped."""
    cell = SPEC.cell(CELL)
    rec = bench.run_cell(T, SPEC.config(cell["config"]), SPEC.traffic(cell["traffic"]),
                         SPEC.limits(CELL), SEED, 0.0, False, card, 0.0)
    assert rec["correct"], rec["checks"]
    assert rec["checks"]["dropped_w"]["value"] == 0.0


def test_a_fresh_process_runs_the_cell():
    """The family's files loaded as a run loads them (nothing imported
    before), at the CPU test size: correct, and no forbidden module."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from _small import small_cell\n"
        "from harness import bench\n"
        "import portrayer_tpu_torch as T\n"
        "spec, data, traffic, limits = small_cell(%r, (32, 18))\n"
        "rec = bench.run_cell(T, data, traffic, limits, 3, 0.0, False, 'cpu', 0.0)\n"
        "print(rec['correct'], rec['checks']['dropped_w']['value'], bench.forbidden_modules())\n"
    ) % (os.path.dirname(os.path.abspath(__file__)), bench.BENCH_DIR, CELL)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=bench.ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[-2] == "True 0.0 []"


class _Replay:
    """graphs.Graph on the CPU: the step, run at each replay."""

    def __init__(self, fn, pool):
        self.fn, self.bodies, self.loops, self.stamps, self.replays = fn, 0, 0, 0, 0

    def replay(self):
        self.fn()
        self.replays += 1


def test_a_traced_run_reads_every_metric_of_the_cell(monkeypatch):
    """A traced run at the CPU test size, its chunk graph stood in for by a
    replay of its step: the result line holds every per-layer metric of
    the cell but the allocator's peak, which only a card has, the two
    counter readings within their ranges."""
    monkeypatch.setattr(graphs, "Graph", _Replay)
    monkeypatch.setattr(T.RenderConfig, "captures", property(lambda cfg: cfg.cuda_graphs))
    monkeypatch.setattr("torch.cuda.graph_pool_handle", lambda: None)
    spec, data, traffic, limits = small_cell(CELL)
    monkeypatch.setattr(span_sample, "command_line_cell",
                        lambda: (T, data, traffic, SEED, "cpu"))
    record = bench.run_cell(T, data, traffic, limits, SEED, 0.0, True, "cpu", 0.0)
    assert record["correct"], record["checks"]
    line = bench.result_line(spec, CELL, record, {}, True)
    assert sorted(line["metrics"]) == sorted(set(NEW) - {"peak_reserved_gib.refract"})
    assert 0.0 < line["metrics"]["refract_ray_pct.refract"]["value"] < 100.0
    assert line["metrics"]["bounce_rays_per_primary.refract"]["value"] > 0.0


@pytest.mark.parametrize("name", NEW)
def test_every_new_metric_reads_none_on_an_empty_record(name):
    assert SPEC.reader(name)({}) is None


def test_the_counter_readings_read_none_without_refr():
    """A counted frame whose TraceStats has no refr (a program without the
    counter) reads nothing; hand-made counts read their arithmetic."""
    old = [types.SimpleNamespace(live=[4, 3, 1], lanes=[4, 4, 2], dropped_w=0.0)]
    assert ST.refract_ray_pct({"stats": old}) is None
    assert ST.bounce_rays_per_primary({"stats": old}) is None
    stats = [types.SimpleNamespace(live=[4, 3, 1], refr=[0, 1, 1]),
             types.SimpleNamespace(live=[4, 0, 0], refr=[0, 0, 0])]
    assert ST.refract_ray_pct({"stats": stats}) == pytest.approx(50.0)
    assert ST.bounce_rays_per_primary({"stats": stats}) == pytest.approx(0.5)


def test_the_stand_in_texels_are_the_same_on_every_call():
    spec = SPEC.config("water-glass")["texels"]
    a, b = texels.make(spec), texels.make(copy.deepcopy(spec))
    assert sorted(a) == sorted(spec["maps"])
    for name in a:
        assert a[name].dtype == np.uint8 and a[name].shape == (1024, 1024, 3)
        assert np.array_equal(a[name], b[name])
    assert not np.array_equal(a["brick_normals"], a["wood_normals"])
