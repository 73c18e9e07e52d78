"""The device-side summary of a render trace (profile_render), on a
synthetic Chrome-format trace: busy time is the union of device intervals,
host events are ignored, sweep launches are counted apart."""

import pytest

from portrayer_tpu_torch.profile_render import after, summarize_trace


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_summary_counts_device_intervals_once():
    trace = {"traceEvents": [
        _ev("cpu_op", "aten::mul", 0, 500),
        _ev("cuda_runtime", "cudaLaunchKernel", 0, 5),
        _ev("kernel", "void (anonymous namespace)::sweep_kernel<false>(float const*)", 10, 100),
        _ev("kernel", "void at::native::elementwise_kernel<128, 2>()", 200, 50),
        _ev("kernel", "void at::native::elementwise_kernel<128, 2>()", 220, 50),
        _ev("gpu_memcpy", "Memcpy DtoH", 400, 20),
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 0},
    ]}
    s = summarize_trace(trace, wall_ms=1.0, n_chunks=2)
    assert s["device_ms"] == pytest.approx((100 + 70 + 20) / 1e3)
    assert s["device_busy_share"] == pytest.approx(0.19)
    assert s["kernel_launches"] == 3 and s["kernel_launches_per_chunk"] == 1.5
    assert s["kernel_ms"] == pytest.approx(0.2)
    assert s["sweep_launches"] == 1 and s["sweep_ms"] == pytest.approx(0.1)
    assert s["top_kernels"][0]["name"].startswith("void (anonymous namespace)::sweep")
    assert s["top_kernels"][1]["launches"] == 2


def test_the_backward_of_a_fit_trace_is_summarized_apart():
    """profile_fit's backward: the device events from the start of the
    host range "fit_backward" on."""
    trace = {"traceEvents": [
        _ev("kernel", "void (anonymous namespace)::sweep_kernel<false>(float const*)", 10, 100),
        _ev("user_annotation", "fit_backward", 300, 400),
        _ev("kernel", "void at::native::indexing_backward_kernel()", 320, 60),
        _ev("kernel", "void at::native::elementwise_kernel<128, 2>()", 390, 10),
    ]}
    b = summarize_trace(after(trace, "fit_backward"), wall_ms=1.0, n_chunks=1)
    assert b["kernel_launches"] == 2 and b["sweep_launches"] == 0
    assert b["device_ms"] == pytest.approx(0.07)
    assert summarize_trace(trace, wall_ms=1.0, n_chunks=1)["kernel_launches"] == 3
