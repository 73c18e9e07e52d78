"""Cells, configurations, traffic mixes, limits and metrics are found by
name as files of their own; a cell added by new files and a new
BENCHMARK.json entry alone loads."""

import json
import os
import shutil

import pytest

from harness import bench

SPEC = bench.Spec()
CELLS = [w["name"] for w in SPEC.bench["workloads"]]
METRICS = [m["name"] for m in SPEC.bench["end_to_end"] + SPEC.bench["per_layer"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files(name):
    cell = SPEC.cell(name)
    data = SPEC.config(cell["config"])
    assert data["name"] == cell["config"] and len(data["size"]) == 2
    assert SPEC.traffic(cell["traffic"])["mode"] == "render"
    assert set(SPEC.limits(name)) == {"off_share", "mean_abs"}
    assert os.path.exists(os.path.join(bench.BENCH_DIR, "harness",
                                       f"mode_{SPEC.traffic(cell['traffic'])['mode']}.py"))
    e2e = {m["name"] for m in SPEC.metrics(name, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert SPEC.metrics(name, True)


@pytest.mark.parametrize("name", METRICS)
def test_every_metric_has_a_reader(name):
    read = SPEC.reader(name)
    assert read({}) is None


def test_a_cell_added_by_files_alone_loads(tmp_path):
    """A later change adds a traffic mix, a limits file and a workload entry:
    the harness finds all of them without an edit to a file it has."""
    root = tmp_path / "checkout"
    shutil.copytree(bench.BENCH_DIR, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = bench.load_json(bench.ROOT, "BENCHMARK.json")
    spec["workloads"].append({"name": "big-scene.spp100", "config": "big-scene",
                              "traffic": "spp100-new", "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    (root / "portbench" / "traffic" / "spp100-new.json").write_text(json.dumps(
        {"mode": "render", "spp": 100, "tile": 128, "launch_rays": 131072, "trace_tiles": 1}))
    (root / "portbench" / "limits" / "big-scene.spp100.json").write_text(
        json.dumps({"off_share": 0.01, "mean_abs": 0.1}))
    (root / "portbench" / "metrics" / "frames.py").write_text(
        "def read(run):\n    return run.get('window', {}).get('frames')\n")
    spec["per_layer"].append({"name": "frames", "unit": "frames", "better": "higher",
                              "source": "program_counter", "layer": "driver",
                              "moves": "mrays_per_s", "workloads": ["big-scene.spp100"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    s = bench.Spec(str(root))
    cell = s.cell("big-scene.spp100")
    assert s.traffic(cell["traffic"])["spp"] == 100
    assert s.config(cell["config"])["name"] == "big-scene"
    assert s.limits("big-scene.spp100")["off_share"] == 0.01
    assert [m["name"] for m in s.metrics("big-scene.spp100", True)] == ["frames"]
    assert s.reader("frames")({"window": {"frames": 3}}) == 3
