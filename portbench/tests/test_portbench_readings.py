"""The arithmetic of the readings on hand-made traces and windows: the
union of device intervals, the trace's summary, the window's rate and
the metrics read from a run's record."""

import pytest

from harness import bench
from harness import trace as TR

SPEC = bench.Spec()


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


TRACE = {"traceEvents": [
    ev("kernel", "sweep_kernel<nearest>", 0.0, 10.0),
    ev("kernel", "add", 5.0, 10.0),          # overlaps the sweep: union 0-15
    ev("gpu_memcpy", "Memcpy DtoH", 20.0, 5.0),
    ev("kernel", "mul", 40.0, 10.0),          # gap 25-40 under the host's sync
    ev("cuda_runtime", "cudaStreamSynchronize", 24.0, 17.0),
    ev("cpu_op", "aten::index_add", 14.0, 6.0),
    {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1.0},
]}


@pytest.mark.parametrize("intervals,total", [
    ([], 0.0),
    ([(0, 1)], 1.0),
    ([(0, 2), (1, 3)], 3.0),
    ([(5, 6), (0, 1), (0.5, 0.7)], 2.0),
    ([(0, 10), (2, 3), (4, 12)], 12.0),
])
def test_union_of_intervals(intervals, total):
    assert TR.union_us(intervals) == pytest.approx(total)


def test_summary_of_a_hand_made_trace():
    s = TR.summarize(TRACE)
    assert s["busy_us"] == pytest.approx(15.0 + 5.0 + 10.0)
    assert s["launches"] == 3
    assert s["kernel_us"] == pytest.approx(30.0)
    assert s["sweep_us"] == pytest.approx(10.0)
    assert s["device_ops"][0][1] == pytest.approx(10e-6)
    (name, gap), (name2, gap2) = s["idle_gaps"]
    assert gap == pytest.approx(15e-6) and "cudaStreamSynchronize" in name
    assert gap2 == pytest.approx(5e-6) and "index_add" in name2


@pytest.mark.parametrize("sfx", ["render", "bounces"])
def test_metrics_of_a_hand_made_record(sfx):
    sample = dict(TR.summarize(TRACE), wall_s=60e-6, chunks=4, rays=2000)
    record = {"setup_s": 12.5, "peak_reserved_bytes": 3 * 2**29,
              "window": {"seconds": 20.0, "frames": 4, "rays": 4 * 10**6}, "sample": sample}
    read = lambda name: SPEC.reader(name)(record)
    assert read("setup_s") == 12.5
    assert read("mrays_per_s") == read("mrays_per_s.bounces") == pytest.approx(0.2)
    assert read(f"rays_per_chunk.{sfx}") == pytest.approx(500.0)
    assert read(f"launches_per_kray.{sfx}") == pytest.approx(1.5)
    assert read(f"sweep_us_per_kray.{sfx}") == pytest.approx(5.0)
    assert read(f"other_us_per_kray.{sfx}") == pytest.approx(10.0)
    assert read(f"device_idle_pct.{sfx}") == pytest.approx(50.0)
    assert read(f"peak_reserved_gib.{sfx}") == pytest.approx(1.5)


@pytest.mark.parametrize("sfx", ["render", "bounces"])
def test_a_trace_without_sweep_kernels_reads_no_sweep(sfx):
    sample = dict(TR.summarize({"traceEvents": [ev("kernel", "add", 0.0, 1.0)]}),
                  wall_s=1e-6, chunks=1, rays=10)
    assert SPEC.reader(f"sweep_us_per_kray.{sfx}")({"sample": sample}) is None


@pytest.mark.parametrize("numbers,ok", [
    ({"off_share": 0.0, "mean_abs": 0.0}, True),
    ({"off_share": 1.0, "mean_abs": 0.0}, False),
    ({"off_share": 0.0, "mean_abs": None}, False),
    ({"off_share": 0.0}, False),
])
def test_judge(numbers, ok):
    correct, checks = bench.judge(numbers, {"off_share": 0.1, "mean_abs": 0.1})
    assert correct is ok and set(checks) == {"off_share", "mean_abs"}
