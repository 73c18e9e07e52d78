"""The readings of the program's own spans (``harness/span_readings.py``):
their arithmetic on hand-made span events with known answers, and a
traced run's spans sample (``harness/span_sample.py``) at the CPU test
size, which every new reader turns into a number.  On the CPU the chunk
graph is stood in for by a replay of its step, so the sample's first
frame warms up and captures as on the card."""

import types

import pytest

import portrayer_tpu_torch as T
from portrayer_tpu_torch import graphs
from harness import bench
from harness import span_sample
from harness import span_readings as SR

from _small import small_cell

SPEC = bench.Spec()
NEW = {"big-scene.spp1": ["frame_idle_pct.render", "device_us_per_kray.render",
                          "capture_s.render", "warm_up_s.render"],
       "glossy-reflection.spp100": ["frame_idle_pct.bounces", "device_us_per_kray.bounces",
                                    "bounce_us_per_kray.bounces", "min_slice_round_us.bounces",
                                    "useful_lane_pct.bounces", "capture_s.bounces",
                                    "warm_up_s.bounces"]}


def ev(name, ts, dur, frame, id, parent=None, **args):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur,
            "args": dict(args, id=id, parent=parent, frame=frame)}


# Frame 0: warm-up and capture.  Frame 1, the steady frame, 0-100 us of
# 2,000 primary rays: chunks at 5-35 and 30-60 (overlapping: union 5-60)
# and one at 95-110, clipped to 95-100; busy 60 us, idle 40%.
EVENTS = [
    {"ph": "M", "name": "thread_name", "args": {"name": "host"}},
    ev("frame", -500.0, 400.0, 0, 0, rays=2000),
    ev("warm_up", -480.0, 250_000.0, 0, 1, 0),
    ev("capture", -200.0, 125_000.0, 0, 2, 0),
    ev("frame", 0.0, 100.0, 1, 10, rays=2000),
    ev("issue", 1.0, 90.0, 1, 11, 10),
    ev("chunk", 5.0, 30.0, 1, 12, 10),
    ev("round 0", 5.0, 10.0, 1, 13, 12, r=0, k=4096, k_min=4096, live=4096),
    ev("round 1", 15.0, 12.0, 1, 14, 12, r=1, k=2048, k_min=2048, live=300),
    ev("round 2", 27.0, 8.0, 1, 15, 12, r=2, k=2048, k_min=2048, live=20),
    ev("chunk", 30.0, 30.0, 1, 16, 10),
    ev("round 0", 30.0, 20.0, 1, 17, 16, r=0, k=4096, k_min=4096, live=4096),
    ev("round 1", 50.0, 10.0, 1, 18, 16, r=1, k=4096, k_min=2048, live=3000),
    ev("chunk", 95.0, 15.0, 1, 19, 10),
    ev("round 0", 95.0, 15.0, 1, 20, 19, r=0, k=4096, k_min=4096, live=4096),
]
STATS = [{"live": [4096, 300, 20, 0], "lanes": [4096, 2048, 2048, 0]},
         {"live": [4096, 3000, 0, 0], "lanes": [4096, 4096, 0, 0]},
         {"live": [4096, 0, 0, 0], "lanes": [4096, 0, 0, 0]}]
RUN = {"spans": EVENTS, "span_stats": STATS}


def test_readings_of_hand_made_spans():
    assert SR.frame_idle_pct(RUN) == pytest.approx(40.0)
    assert SR.device_us_per_kray(RUN) == pytest.approx((30 + 30 + 15) / 2.0)
    # After round 0: 35 - 15, 60 - 50 and 110 - 110.
    assert SR.bounce_us_per_kray(RUN) == pytest.approx((20 + 10 + 0) / 2.0)
    # The rounds on their smallest slice: 12 and 8 us (not the 10 us one
    # on 4,096 of its 2,048 and 4,096 lanes, nor any round 0).
    assert SR.min_slice_round_us(RUN) == pytest.approx(10.0)
    assert SR.useful_lane_pct(RUN) == pytest.approx(100.0 * 3320 / 8192)
    assert SR.capture_s(RUN) == pytest.approx(0.125)
    assert SR.warm_up_s(RUN) == pytest.approx(0.25)


def test_a_frame_without_capture_reads_none():
    steady = {"spans": [e for e in EVENTS if e.get("args", {}).get("frame") == 1]}
    assert SR.capture_s(steady) is None and SR.warm_up_s(steady) is None
    assert SR.frame_idle_pct(steady) == pytest.approx(40.0)
    assert SR.useful_lane_pct({"span_stats": [STATS[2]]}) is None


@pytest.mark.parametrize("name", [m for names in NEW.values() for m in names])
def test_each_new_metric_reads_the_hand_made_run(name):
    assert isinstance(SPEC.reader(name)(RUN), float)


class _Replay:
    """graphs.Graph on the CPU: the step, run at each replay (its
    switches and loops read on the host)."""

    def __init__(self, fn, pool):
        self.fn, self.bodies, self.loops, self.stamps, self.replays = fn, 0, 0, 0, 0

    def replay(self):
        self.fn()
        self.replays += 1


@pytest.fixture
def replayed(monkeypatch):
    monkeypatch.setattr(graphs, "Graph", _Replay)
    monkeypatch.setattr(T.RenderConfig, "captures", property(lambda cfg: cfg.cuda_graphs))
    monkeypatch.setattr("torch.cuda.graph_pool_handle", lambda: None)


@pytest.mark.parametrize("workload", list(NEW))
def test_the_spans_sample_reads_every_new_metric(workload, replayed, monkeypatch):
    """A traced run at the CPU test size: the first reader of its spans
    takes the sample, two frames (the first warms up and captures), once,
    and the result line holds every per-layer metric this cell reads from
    them."""
    spec, data, traffic, limits = small_cell(workload)
    seed = 2**31 + 7
    taken = []

    def cell():
        taken.append(workload)
        return T, data, traffic, seed, "cpu"

    monkeypatch.setattr(span_sample, "command_line_cell", cell)
    record = bench.run_cell(T, data, traffic, limits, seed, 0.0, True, "cpu", 0.0)
    assert record["correct"], record["checks"]
    assert "spans" not in record
    line = bench.result_line(spec, workload, record, {}, True)
    assert taken == [workload]
    frames = [e for e in record["spans"] if e["name"] == "frame"]
    assert [f["args"]["frame"] for f in frames] == [0, 1]
    for name in NEW[workload]:
        assert isinstance(line["metrics"][name]["value"], float), name
    assert 0.0 <= line["metrics"][NEW[workload][0]]["value"] < 100.0


def test_the_command_line_names_the_sampled_cell(monkeypatch):
    """The sample renders the cell and seed of the run's own command line;
    a process that runs no cell of the benchmark samples nothing."""
    monkeypatch.setattr("sys.argv", ["run.py", "--workload", "big-scene.spp1", "--seed",
                                     str(2**31 + 5), "--seconds", "30", "--trace", "1"])
    got, data, traffic, seed, device = span_sample.command_line_cell()
    assert got is T and seed == 2**31 + 5 and device.type == "cuda"
    assert data == SPEC.config("big-scene") and traffic == SPEC.traffic("spp1")
    monkeypatch.setattr("sys.argv", ["pytest"])
    assert span_sample.command_line_cell() is None
    assert span_sample.of({"window": {}, "sample": None}) == {
        "window": {}, "sample": None, "spans": None, "span_stats": None}


def test_a_program_without_spans_gives_no_sample():
    """Laid over a program that has no spans, the sample is None and the
    readers read nothing."""
    _, data, traffic, _ = small_cell("big-scene.spp1", (32, 16))
    assert span_sample.take(types.SimpleNamespace(), data, traffic, 3, "cpu") is None
    for names in NEW.values():
        for name in names:
            assert SPEC.reader(name)({"sample": None}) is None
