"""The render's spans (``portrayer_tpu_torch/spans.py``) on the CPU: a
``Spans`` passed as ``spans=`` leaves the image as it was and receives the
frame's host phases, in their tree, and each chunk's and bounce round's
span from the stamps the chunk program writes (on the CPU
``graphs.stamp`` writes ``time.perf_counter_ns``).  The captured chunk
goes through tests/_torch_jax.py's StandInGraph under HostReads, so the
stamps are seen to read nothing on the host.  ``TraceStats.lanes`` holds
the lanes each round ran on, from every producer.  Under a CPU
``torch.profiler`` each host span site opens a ``portrayer.<name>``
range, with or without a Spans.

No tolerance: the stamped and unstamped renders run the same ops on the
same inputs on the CPU, so their images are equal bit for bit.
"""

import json
import time

import numpy as np
import pytest
import torch

import portrayer_tpu_torch as T
from portrayer_tpu_torch import render, rng, scenes as tscenes
from portrayer_tpu_torch.camera import Camera
from portrayer_tpu_torch.ops import trace as tr

from _torch_jax import stand_in_graphs

SIZE = (48, 32)
CFG = dict(device="cpu", samples=6, tile=(16, 16), max_rays_per_launch=1024, seed=0)
HOST = ("frame", "tables", "program", "start", "warm_up", "issue", "tile", "capture",
        "readback", "assemble")


@pytest.fixture
def stand_in(monkeypatch):
    return stand_in_graphs(monkeypatch)


def _glossy():
    spec = tscenes.load("glossy-reflection")
    return T.flatten_scene(spec.scene, "cpu"), spec


def _by_id(spans):
    return {s.id: s for s in spans.records}


def _children(spans, parent):
    return [s for s in spans.records if s.parent == parent.id]


def _inside(child, parent):
    return parent.t0_ns <= child.t0_ns <= child.t1_ns <= parent.t1_ns


@pytest.mark.parametrize("captured", [False, True], ids=["op_by_op", "stand_in_capture"])
def test_spans_leave_the_image_as_it_was(monkeypatch, captured):
    """render_u8 with spans=Spans() gives the image of render_u8 without,
    op by op and through the stand-in capture (which sees no host read in
    the stamped chunk)."""
    reads = stand_in_graphs(monkeypatch) if captured else None
    st, spec = _glossy()
    cfg = T.RenderConfig(**CFG, cuda_graphs=captured)
    args = (st, spec.camera, SIZE, spec.background, cfg)
    plain = T.render_u8(*args)
    spans = T.Spans()
    np.testing.assert_array_equal(T.render_u8(*args, spans=spans), plain)
    assert spans.frames == 1 and any(s.name == "chunk" for s in spans.records)
    if captured:
        assert reads.seen == []


def test_host_spans_form_the_frame_tree(stand_in):
    """frame -> tables, program, start (-> warm_up), issue (-> tile a tile,
    capture once, in the first tile), readback, assemble, in that order,
    each inside its parent, all of one frame; the frame's attributes count
    its tiles, chunks and primary rays."""
    st, spec = _glossy()
    spans = T.Spans()
    Wd, H = SIZE
    T.render_u8(spec.scene, spec.camera, SIZE, spec.background, T.RenderConfig(**CFG),
                spans=spans)
    ids = _by_id(spans)
    host = [s for s in spans.records if not s.device]
    assert {s.name for s in host} == set(HOST)
    (frame,) = [s for s in host if s.name == "frame"]
    assert frame.parent is None and all(s.frame == frame.frame == 0 for s in spans.records)
    assert [s.name for s in _children(spans, frame) if not s.device] == [
        "tables", "program", "start", "issue", "readback", "assemble"]
    for s in host:
        if s.parent is not None:
            assert _inside(s, ids[s.parent]), s
    (start,) = [s for s in host if s.name == "start"]
    assert [s.name for s in _children(spans, start)] == ["warm_up"]
    (issue,) = [s for s in host if s.name == "issue"]
    tiles = _children(spans, issue)
    assert [s.name for s in tiles] == ["tile"] * 6
    assert [s.attrs["origin"] for s in tiles] == [[x, y] for y in (0, 16) for x in (0, 16, 32)]
    (capture,) = [s for s in host if s.name == "capture"]
    assert capture.parent == tiles[0].id
    assert frame.attrs["tiles"] == 6 and frame.attrs["chunks"] == 12
    assert frame.attrs["rays"] == Wd * H * 6 and frame.attrs["spp"] == 6
    assert frame.attrs["clock_unc_ns"] >= 0


def test_chunk_spans_hold_their_rounds(stand_in):
    """Each chunk's span lies in its frame and holds round 0 and the bounce
    rounds that ran (those with a live ray entering), in order, one after
    another, each with the lanes it ran on and the live rays entering it,
    as the frame's TraceStats give them."""
    st, spec = _glossy()
    spans, stats = T.Spans(), []
    T.render_u8(st, spec.camera, SIZE, spec.background, T.RenderConfig(**CFG), spans=spans,
                stats=stats)
    ids = _by_id(spans)
    chunks = [s for s in spans.records if s.name == "chunk"]
    assert len(chunks) == len(stats) == 12
    assert [c.attrs["row"] for c in chunks] == list(range(12))
    assert [(c.attrs["tile"], c.attrs["chunk"]) for c in chunks] == [
        ([x, y], ci) for y in (0, 16) for x in (0, 16, 32) for ci in (0, 1)]
    assert any(s.lanes[2] > 0 for s in stats)  # a chunk that bounces twice
    for c, s in zip(chunks, stats):
        assert ids[c.parent].name == "frame" and _inside(c, ids[c.parent])
        rounds = _children(spans, c)
        ran = [r for r in range(len(s.lanes)) if s.lanes[r] > 0]
        assert [x.name for x in rounds] == [f"round {r}" for r in ran]
        assert [x.attrs["k"] for x in rounds] == [int(s.lanes[r]) for r in ran]
        assert [x.attrs["live"] for x in rounds] == [int(s.live[r]) for r in ran]
        assert all(_inside(x, c) for x in rounds)
        assert all(a.t1_ns == b.t0_ns for a, b in zip(rounds, rounds[1:]))
        assert rounds[0].t0_ns == c.t0_ns


def test_a_second_frame_has_no_warm_up_or_capture(stand_in):
    """A second frame on the cached stamped program replays it: no warm_up
    and no capture span, its spans under frame index 1."""
    st, spec = _glossy()
    spans = T.Spans()
    for _ in range(2):
        T.render_u8(st, spec.camera, SIZE, spec.background, T.RenderConfig(**CFG),
                    spans=spans)
    second = [s for s in spans.records if s.frame == 1]
    assert spans.frames == 2 and second[0].name == "frame"
    names = {s.name for s in second}
    assert "warm_up" not in names and "capture" not in names and "tables" not in names
    assert sum(s.name == "chunk" for s in second) == 12


def test_the_frame_holds_none_of_the_tracing(stand_in, monkeypatch):
    """The frame's counters, stamps and clock calibration are read after
    its span has closed, so that its idle share counts none of that work;
    the device spans still hang under it."""
    st, spec = _glossy()
    read_at = []
    read_counts = render._read_counts

    def timed(*args):
        read_at.append(time.perf_counter_ns())
        return read_counts(*args)

    monkeypatch.setattr(render, "_read_counts", timed)
    spans, stats = T.Spans(), []
    T.render_u8(st, spec.camera, SIZE, spec.background, T.RenderConfig(**CFG), spans=spans,
                stats=stats)
    (frame,) = [s for s in spans.records if s.name == "frame"]
    assert len(read_at) == 1 and frame.t1_ns <= read_at[0]
    assert len(stats) == 12 and "clock_unc_ns" in frame.attrs
    assert sum(s.name == "chunk" and s.parent == frame.id for s in spans.records) == 12


def test_events_are_chrome_trace_events(stand_in):
    """Spans.events(): one "X" event a span in microseconds, host and
    device spans on threads of their own, named by metadata events, each
    with its id, parent and frame; json-serialisable."""
    st, spec = _glossy()
    spans = T.Spans()
    T.render_u8(st, spec.camera, SIZE, spec.background, T.RenderConfig(**CFG), spans=spans)
    events = json.loads(json.dumps(spans.events()))
    xs = [e for e in events if e["ph"] == "X"]
    assert len(xs) == len(spans.records)
    assert {e["args"]["name"] for e in events if e["ph"] == "M"} == {"host", "device"}
    for e, s in zip(xs, spans.records):
        assert e["name"] == s.name and e["args"]["id"] == s.id and e["args"]["frame"] == 0
        assert e["ts"] == pytest.approx(s.t0_ns / 1e3)
        assert e["dur"] == pytest.approx((s.t1_ns - s.t0_ns) / 1e3)
    assert len({e["tid"] for e in xs if e["name"] == "chunk"} |
               {e["tid"] for e in xs if e["name"] == "frame"}) == 2


def _lanes_of_each_round(monkeypatch, module):
    """The k of every bounce_round `module` calls, in order."""
    seen = []
    orig = module.bounce_round

    def bounce_round(rkey, q, acc, bg, st, cfg, k, *a, **kw):
        seen.append(k)
        return orig(rkey, q, acc, bg, st, cfg, k, *a, **kw)

    monkeypatch.setattr(module, "bounce_round", bounce_round)
    return seen


def _check_lanes(stats, seen, pl, cfg):
    rounds = list(tr.rounds(pl, cfg.queue_slice_divs))
    assert [int(x) for s in stats for x in s.lanes[1:] if x] == seen
    for s in stats:
        assert int(s.lanes[0]) == pl.cap[0]
        assert [int(x) for x in s.lanes[1:]] == [tr.pick_slice(rd.sizes, int(s.live[rd.r]))
                                                 for rd in rounds]


def test_lanes_are_the_slices_the_rounds_ran_on(monkeypatch):
    """TraceStats.lanes of a render run op by op (tiles of 4,096 lanes,
    whose queues have head slices of 2,048 and 4,096) and of trace(...,
    with_stats=True): round 0 on every primary lane, each bounce round on
    the k it ran on, 0 where it did not run; pick_slice over live."""
    st, spec = _glossy()
    cfg = T.RenderConfig(device="cpu", samples=4, tile=(32, 32), max_rays_per_launch=4096)
    seen = _lanes_of_each_round(monkeypatch, render)
    stats = []
    T.render_linear(st, spec.camera, (64, 64), spec.background, cfg, stats=stats)
    pl = tr.plan(4096, st, cfg)
    assert tr.slice_sizes(pl.cap[1], cfg.queue_slice_divs) == (2048, 4096)
    assert {k for k in seen} == {2048, 4096}
    _check_lanes(stats, seen, pl, cfg)

    seen = _lanes_of_each_round(monkeypatch, tr)
    o, d, pix, bg, w0 = render._tile_rays(
        rng.PRNGKey(4), Camera(spec.camera, spec.size, "cpu"), 384, 192, 0, cfg=cfg,
        background=render.default_background, tile_h=32, tile_w=32, spp=4, samples=4)
    _, s = tr.trace(rng.PRNGKey(5), o, d, pix, bg, 1024, st, cfg, w0=w0, spp_contiguous=4,
                    with_stats=True)
    assert len(seen) > 1
    _check_lanes([s], seen, pl, cfg)


def test_the_profiler_names_the_phases():
    """Under a CPU torch.profiler, with spans=None, the exported trace
    holds portrayer.frame and portrayer.issue as user annotations, the
    issue inside the frame."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    st, spec = _glossy()
    cfg = T.RenderConfig(**dict(CFG, samples=1))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        T.render_u8(st, spec.camera, SIZE, spec.background, cfg)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    ann = {e["name"]: e for e in events
           if e.get("cat") == "user_annotation" and e["name"].startswith("portrayer.")}
    assert {"portrayer.frame", "portrayer.issue", "portrayer.tile", "portrayer.readback"} \
        <= set(ann)
    frame, issue = ann["portrayer.frame"], ann["portrayer.issue"]
    assert frame["ts"] <= issue["ts"] and \
        issue["ts"] + issue["dur"] <= frame["ts"] + frame["dur"]


def test_no_stamps_without_spans(stand_in):
    """A render without spans builds a program with no stamp table, and
    one with spans its own program beside it: the tables keep both."""
    st, spec = _glossy()
    args = (st, spec.camera, SIZE, spec.background, T.RenderConfig(**CFG))
    T.render_u8(*args)
    (prog,) = st.chunk_programs.values()
    assert prog.stamps is None
    T.render_u8(*args, spans=T.Spans())
    assert len(st.chunk_programs) == 2
    assert [p.stamps is None for p in st.chunk_programs.values()] == [True, False]
    stamped = list(st.chunk_programs.values())[1]
    D = stamped.pl.max_depth
    assert stamped.stamps.shape == (stamped.rows.shape[0], D + 3)


def test_stamp_on_the_cpu():
    """graphs.stamp on the CPU writes time.perf_counter_ns at [row, col +
    shift], col an int or a 0-d tensor, in the order of the calls, and
    refuses a column outside the table."""
    import time

    from portrayer_tpu_torch import graphs

    table = torch.zeros((3, 4), dtype=torch.int64)
    row, col = torch.tensor(2), torch.tensor(1)
    t0 = time.perf_counter_ns()
    graphs.stamp(table, row, 0)
    graphs.stamp(table, row, col, 1)
    graphs.stamp(table, row, 3)
    t1 = time.perf_counter_ns()
    assert table[:2].eq(0).all() and table[2, 1] == 0
    assert t0 <= table[2, 0] <= table[2, 2] <= table[2, 3] <= t1
    with pytest.raises(ValueError, match="column 4"):
        graphs.stamp(table, row, 3, 1)
