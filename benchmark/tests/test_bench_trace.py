"""The trace reader on a small canned Chrome trace: buckets, the union of
device intervals, the idle share, the sparse-gradient work, idle gaps."""

from __future__ import annotations

import json

import pytest


def _event(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid}


@pytest.fixture
def trace(tmp_path):
    from harness import trace as trace_lib
    events = [
        _event("sm80_xmma_gemm_f32f32_nn", "kernel", 100, 300),
        _event("void at::native::vectorized_elementwise_kernel<4>", "kernel",
               350, 100),                      # overlaps the GEMM by 50
        _event("range_chunk_kernel(int)", "kernel", 600, 40),
        _event("void at::native::indexFuncLargeIndex<index_add>", "kernel",
               700, 20),
        _event("Memset (Device)", "gpu_memset", 720, 10),
        _event("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 800, 100),
        _event("void at::native::index_select_kernel", "kernel", 950, 50),
        _event("void at::native::_scatter_gather_elementwise_kernel<"
               "TensorAssign>", "kernel", 960, 20),
        _event("cudaLaunchKernel", "cuda_runtime", 470, 120),
        _event("aten::mul", "cpu_op", 460, 200),
        _event("cudaStreamSynchronize", "cuda_runtime", 905, 40),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))

    class Cap:
        pass
    cap = Cap()
    cap.path = str(path)
    cap.window_s = 1000e-6
    return trace_lib.Trace(cap, steps=2)


def test_buckets(trace):
    b = trace.bucket_ms_per_step()
    assert b["matmul"] == pytest.approx(0.300 / 2)
    assert b["elementwise"] == pytest.approx(0.100 / 2)
    assert b["kernel"] == pytest.approx(0.040 / 2)
    assert b["index"] == pytest.approx((0.020 + 0.050 + 0.020) / 2)
    assert b["memset"] == pytest.approx(0.010 / 2)
    assert b["copy"] == pytest.approx(0.100 / 2)


def test_busy_union_and_idle(trace):
    # [100, 450] + [600, 640] + [700, 730] + [800, 900] + [950, 1000]
    assert trace.busy_s == pytest.approx(570e-6)
    assert trace.window_s == pytest.approx(1000e-6)
    from harness import spec
    run = type("R", (), {"trace": trace})()
    idle = spec.metric_reader("device_idle_pct.train")(run)
    assert idle == pytest.approx(43.0)


def test_grad_work(trace):
    # K1, the library's index-add and the memset; not the gathers
    assert trace.grad_work_s() == pytest.approx(70e-6)
    assert set(trace.grad_work_by_name()) == {
        "range_chunk_kernel(int)",
        "void at::native::indexFuncLargeIndex<index_add>",
        "Memset (Device)"}


def test_idle_gaps_by_host_activity(trace):
    gaps = dict(trace.idle_gaps())
    # [450, 600] at 525: innermost of aten::mul and cudaLaunchKernel
    assert gaps["cudaLaunchKernel"] == pytest.approx(150e-6)
    # [900, 950] at 925: the stream synchronisation
    assert gaps["cudaStreamSynchronize"] == pytest.approx(50e-6)
    assert gaps["host: no traced call"] == pytest.approx(130e-6)
    bd = trace.breakdown()
    assert bd["device_ops"][0][0] == "sm80_xmma_gemm_f32f32_nn"
    assert len(bd["idle_gaps"]) <= 10


def test_readers_leave_out_what_they_cannot_read():
    from harness import spec
    from harness.record import Recorder, read_metrics
    rec = Recorder()
    entries = [{"name": n, "unit": "%"} for n in (
        "kernels_roofline", "device_ms.matmul", "step_mfu",
        "train_dispatch_ms")]
    assert read_metrics(entries, rec, None) == {}
    assert spec.metric_reader("device_idle_pct.train")(rec) is None
