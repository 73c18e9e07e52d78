"""Cells, configurations, traffic mixes, limits, metrics and scene
families are found by name as files of their own; a cell added by new
files and a new BENCHMARK.json entry alone loads, and one of a new scene
family runs."""

import json
import os
import shutil

import pytest

import portrayer_tpu_torch as T
from harness import bench, family, mode_render
from harness import scene as first_builder
from reference import render as first_reference

from _small import small_cell

SPEC = bench.Spec()
CELLS = [w["name"] for w in SPEC.bench["workloads"]]
METRICS = [m["name"] for m in SPEC.bench["end_to_end"] + SPEC.bench["per_layer"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files(name):
    cell = SPEC.cell(name)
    data = SPEC.config(cell["config"])
    assert data["name"] == cell["config"] and len(data["size"]) == 2
    assert os.path.exists(os.path.join(bench.BENCH_DIR, "harness",
                                       f"mode_{SPEC.traffic(cell['traffic'])['mode']}.py"))
    fam = family.lookup(data)
    assert callable(fam.builder.build) and callable(fam.reference.reference_frame)
    assert {"off_share", "mean_abs"} <= set(SPEC.limits(name))
    e2e = {m["name"] for m in SPEC.metrics(name, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert SPEC.metrics(name, True)


@pytest.mark.parametrize("name", CELLS)
def test_a_configuration_without_a_family_is_of_the_first(name):
    """The two cells' configurations name no family: they get today's
    builder and reference, no numbers besides the frame's, and the
    RenderConfig they had (queue_caps None, the default)."""
    data = SPEC.config(SPEC.cell(name)["config"])
    fam = family.lookup(data)
    assert "scene" not in data and data["queue_caps"] is None
    assert fam.builder is first_builder and fam.reference is first_reference
    assert fam.numbers is None
    _, cam, _, overrides = fam.build(T, data)
    assert overrides == {"queue_caps": None} and cam == first_builder.build(T, data)[1]


@pytest.mark.parametrize("name", METRICS)
def test_every_metric_has_a_reader(name):
    read = SPEC.reader(name)
    assert read({}) is None


# A new scene family, by files alone: a builder that wraps the first
# family's and fixes the queue caps, and a reference that wraps the first
# family's and compares the program's dropped throughput besides.
WRAPPED_BUILDER = """
from . import scene


def build(T, data):
    return (*scene.build(T, data), {"queue_caps": (2.0,)})
"""
WRAPPED_REFERENCE = """
from . import render


def reference_frame(data, traffic, seed, device, dtype):
    return render.reference_frame(data, traffic, seed, device, dtype)


def numbers(record):
    return {"dropped_w": max(s.dropped_w for s in record["stats"])}
"""
# The same, with a builder that disagrees with its reference: the table's
# diffuse colour changed.
DISAGREEING_BUILDER = """
import copy

from . import scene


def build(T, data):
    data = copy.deepcopy(data)
    data["materials"][3]["diffuse"] = [0.2, 0.6, 1.0]
    return (*scene.build(T, data), {"queue_caps": (2.0,)})
"""
FAMILIES = {"wrapped": WRAPPED_BUILDER, "disagreeing": DISAGREEING_BUILDER}


@pytest.fixture
def checkout(tmp_path):
    """A copy of the benchmark to which a later change has added, by files
    and BENCHMARK.json entries alone: a traffic mix, a limits file, a
    metric and its cell; and two configurations of new scene families,
    each with its cell."""
    root = tmp_path / "checkout"
    bench_dir = root / "portbench"
    shutil.copytree(bench.BENCH_DIR, bench_dir, ignore=shutil.ignore_patterns("__pycache__"))
    spec = bench.load_json(bench.ROOT, "BENCHMARK.json")
    spec["workloads"].append({"name": "big-scene.spp100", "config": "big-scene",
                              "traffic": "spp100-new", "chips": 1, "why": "test"})
    (bench_dir / "traffic" / "spp100-new.json").write_text(json.dumps(
        {"mode": "render", "spp": 100, "tile": 128, "launch_rays": 131072, "trace_tiles": 1}))
    (bench_dir / "limits" / "big-scene.spp100.json").write_text(
        json.dumps({"off_share": 0.01, "mean_abs": 0.1}))
    (bench_dir / "metrics" / "frames.py").write_text(
        "def read(run):\n    return run.get('window', {}).get('frames')\n")
    spec["per_layer"].append({"name": "frames", "unit": "frames", "better": "higher",
                              "source": "program_counter", "layer": "driver",
                              "moves": "mrays_per_s", "workloads": ["big-scene.spp100"]})
    glossy = SPEC.config("glossy-reflection")
    for name, builder in FAMILIES.items():
        config = f"glossy-{name}"
        (bench_dir / "configs" / f"{config}.json").write_text(
            json.dumps(dict(glossy, name=config, scene=name)))
        (bench_dir / "harness" / f"scene_{name}.py").write_text(builder)
        (bench_dir / "reference" / f"render_{name}.py").write_text(WRAPPED_REFERENCE)
        (bench_dir / "limits" / f"{config}.spp100.json").write_text(
            json.dumps(dict(SPEC.limits("glossy-reflection.spp100"), dropped_w=0.0)))
        spec["configs"].append({"name": config, "source": "test",
                                "file": f"portbench/configs/{config}.json", "reduced": [],
                                "why": "test"})
        spec["workloads"].append({"name": f"{config}.spp100", "config": config,
                                  "traffic": "spp100", "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def test_a_cell_added_by_files_alone_loads(checkout, monkeypatch):
    """A later change adds a traffic mix, a limits file, a workload entry and
    a configuration of a new scene family: the harness finds all of them
    without an edit to a file it has."""
    s = bench.Spec(str(checkout))
    cell = s.cell("big-scene.spp100")
    assert s.traffic(cell["traffic"])["spp"] == 100
    assert s.config(cell["config"])["name"] == "big-scene"
    assert s.limits("big-scene.spp100")["off_share"] == 0.01
    assert [m["name"] for m in s.metrics("big-scene.spp100", True)] == ["frames"]
    assert s.reader("frames")({"window": {"frames": 3}}) == 3
    monkeypatch.setattr(bench, "BENCH_DIR", s.dir)
    fam = family.lookup(s.config(s.cell("glossy-wrapped.spp100")["config"]))
    assert fam.builder.__file__ == str(checkout / "portbench" / "harness" / "scene_wrapped.py")
    assert fam.numbers is not None
    assert set(s.limits("glossy-wrapped.spp100")) == {"off_share", "mean_abs", "dropped_w"}


@pytest.mark.parametrize("name,correct", [("wrapped", True), ("disagreeing", False)])
def test_a_cell_of_a_new_family_runs(checkout, monkeypatch, name, correct):
    """The cell of a family added by files alone runs at the CPU test size:
    its overrides reach RenderConfig, its extra number is compared with its
    limit, and a builder that disagrees with its reference reads false."""
    monkeypatch.setattr(bench, "BENCH_DIR", str(checkout / "portbench"))
    cfgs = []
    init = mode_render.RenderCell.__init__

    def spy(self, *a, **k):
        init(self, *a, **k)
        cfgs.append(self.cfg)

    monkeypatch.setattr(mode_render.RenderCell, "__init__", spy)
    _, data, traffic, limits = small_cell(f"glossy-{name}.spp100", root=str(checkout))
    rec = bench.run_cell(T, data, traffic, limits, 2**31 + 13, 0.0, False, "cpu", 0.0)
    assert rec["correct"] is correct, rec["checks"]
    assert rec["checks"]["dropped_w"] == {"value": 0.0, "limit": 0.0}
    assert [c.queue_caps for c in cfgs] == [(2.0,)]
    assert len(rec["stats"]) > 0
