"""The card's perf gate (wide_deep_tpu_torch/tools/perf_regression.py +
tools/parse_trace.py): bucket classification, the ms-a-step profile, the
budget comparison and its floor, the Chrome-trace walker and the CLI, on
synthetic torch.profiler traces (tests/test_perf_regression.py's cases);
and the committed perf_budget_torch.json, captured on the card.  The check
against that budget on the card is opt-in (tests/test_torch_chip_gates.py).
"""

import json
import os

import pytest

pytest.importorskip("torch")

from paths import REPO  # noqa: E402

BUDGET = os.path.join(REPO, "perf_budget_torch.json")

# event names as torch.profiler writes them on an H100
NAMES = {
    "void (anonymous namespace)::range_chunk_kernel<__nv_bfloat16, "
    "__nv_bfloat16>(int const*, int const*, __nv_bfloat16 const*, int, "
    "int, int, __nv_bfloat16*, float*, int2*)": "kernel",
    "void (anonymous namespace)::range_carry_kernel<float>(float const*, "
    "int2 const*, int, int, float*)": "kernel",
    "void (anonymous namespace)::window_scatter_kernel<float>(...)":
        "kernel",
    "void (anonymous namespace)::rowdma_kernel(float const*, ...)":
        "kernel",
    "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<"
    "4096ul>)": "collective",
    "Memset (Device)": "memset",
    "Memcpy HtoD (Pinned -> Device)": "copy",
    "void at::native::vectorized_elementwise_kernel<4, "
    "at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)::"
    "{lambda()#3}::operator()() const::{lambda()#7}::operator()() const::"
    "{lambda(float)#1}, std::array<char*, 2ul> >(int, ...)": "copy",
    "void at::native::(anonymous namespace)::CatArrayBatchedCopy<...>":
        "copy",
    "sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nhwc": "conv",
    "void cudnn::bn_fw_tr_1C11_kernel_NCHW<float, float>(...)": "conv",
    "sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x32": "matmul",
    "void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nn_align1>":
        "matmul",
    "void at::native::index_elementwise_kernel<128, 4, ...>": "index",
    "void at::native::(anonymous namespace)::indexSelectLargeIndex<float, "
    "long, unsigned int, 2, 2, -2, true>(...)": "index",
    "void at::native::_scatter_gather_elementwise_kernel<128, 4, ...>":
        "index",
    "void cub::CUB_200500_900_NS::DeviceRadixSortOnesweepKernel<...>":
        "index",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
    "at::native::func_wrapper_t<float, at::native::sum_functor<float, "
    "float, float>::operator()>, unsigned int, float, 4> >(...)": "reduce",
    "void at::native::vectorized_elementwise_kernel<4, "
    "at::native::CUDAFunctor_add<float>, std::array<char*, 3ul> >(...)":
        "elementwise",
    "void at::native::unrolled_elementwise_kernel<...>": "elementwise",
    "void at::native::vectorized_elementwise_kernel<4, "
    "at::native::FillFunctor<float>, std::array<char*, 1ul> >(...)":
        "elementwise",
    "void at::native::(anonymous namespace)::distribution_"
    "elementwise_grid_stride_kernel<float, 4, ... normal ...>":
        "elementwise",
    "void some_unknown_thing<8>()": "other",
}


def _trace(path, events):
    """A Chrome trace as torch.profiler exports it: host ops and runtime
    calls, a device annotation, and the device events ``events`` [(cat,
    name, us)]."""
    evs = [{"ph": "X", "cat": "cpu_op", "name": "aten::index_select",
            "ts": 0, "dur": 900.0, "pid": 1, "tid": 1},
           {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": 1, "dur": 5.0, "pid": 1, "tid": 1},
           {"ph": "X", "cat": "gpu_user_annotation", "name": "step",
            "ts": 2, "dur": 5000.0, "pid": 0, "tid": 7},
           {"ph": "s", "cat": "ac2g", "name": "ac2g", "ts": 3, "pid": 1,
            "tid": 1, "id": 1}]
    for i, (cat, name, us) in enumerate(events):
        evs.append({"ph": "X", "cat": cat, "name": name, "ts": 10 + i,
                    "dur": us, "pid": 0, "tid": 7, "args": {"stream": 7}})
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"schemaVersion": 1, "traceEvents": evs}, f)
    return path


K1 = next(n for n in NAMES if "range_chunk" in n)
GEMM = next(n for n in NAMES if "tilesize128" in n)


def test_classification():
    from wide_deep_tpu_torch.tools.perf_regression import (bucket_of,
                                                           port_kernel_of)
    for name, want in NAMES.items():
        assert bucket_of(name) == want, name
    assert port_kernel_of(K1) == "range_chunk_kernel"
    # a symbol inside a longer identifier is not the port's kernel
    assert port_kernel_of("void my_rowdma_kernel_v2()") is None
    assert bucket_of("void at::native::convert_kernel<float>()") != "conv"


def test_profile_buckets_per_step():
    from wide_deep_tpu_torch.tools.perf_regression import profile_buckets
    # durations are microseconds (Chrome trace convention)
    totals = {K1: 600.0, GEMM: 6000.0, "Memset (Device)": 300.0,
              "sm90_xmma_gemm_other": 3000.0}
    prof = profile_buckets(totals, steps=3)
    assert prof == {"kernel": 0.2, "matmul": 3.0, "memset": 0.1,
                    "total": 3.3}


def test_regression_and_improvement():
    from wide_deep_tpu_torch.tools.perf_regression import compare
    budget = {"elementwise": 10.0, "matmul": 5.0, "kernel": 1.0,
              "total": 16.0}
    current = {"elementwise": 12.0, "matmul": 4.0, "kernel": 1.05,
               "total": 17.05}
    ok, findings = compare(budget, current, tolerance=0.15)
    assert not ok
    kinds = {f["bucket"]: f["kind"] for f in findings}
    assert kinds["elementwise"] == "regression"   # +20% and +2 ms
    assert kinds["matmul"] == "improvement"       # -20% and -1 ms
    assert "kernel" not in kinds                  # +5% within tolerance


def test_absolute_floor_suppresses_jitter():
    from wide_deep_tpu_torch.tools.perf_regression import compare
    # +100% relative but only +0.1 ms: under the 0.2 ms floor
    ok, findings = compare({"other": 0.1}, {"other": 0.2}, 0.15)
    assert ok and not findings


def test_new_bucket_is_regression():
    from wide_deep_tpu_torch.tools.perf_regression import compare
    ok, findings = compare({"total": 1.0}, {"total": 1.0,
                                            "collective": 3.0}, 0.15)
    assert not ok
    assert findings[0]["bucket"] == "collective"


def test_budget_file_schema():
    """The committed perf_budget_torch.json stays loadable by ``check``:
    known buckets, a positive total, the port's kernels by symbol, the
    card it was captured on; a check against itself passes."""
    from wide_deep_tpu_torch.tools import perf_regression as pr
    with open(BUDGET) as f:
        meta = json.load(f)
    assert meta["steps"] == 3
    buckets = meta["buckets_ms_per_step"]
    assert buckets["total"] > 0
    assert set(buckets) <= set(pr.BUCKETS) | {"total"}, set(buckets)
    assert buckets["kernel"] > 0 and buckets["matmul"] > 0
    assert {"range_chunk_kernel", "rowdma_kernel"} <= set(meta["kernels"])
    assert "H100" in meta["card"] and meta["card"].endswith(" W")
    ok, findings = pr.compare(buckets, buckets, tolerance=0.08)
    assert ok and not findings


def test_trace_walker_sums_device_events(tmp_path):
    from wide_deep_tpu_torch.tools.parse_trace import device_events, main
    root = tmp_path / "prof"
    _trace(str(root / "trace.json"), [
        ("kernel", K1, 20.0), ("kernel", K1, 10.0),
        ("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 800.0),
        ("gpu_memset", "Memset (Device)", 4.0)])
    # a second trace under the directory adds up
    _trace(str(root / "sub" / "other.json"), [("kernel", GEMM, 50.0)])
    ev = device_events(str(root))
    assert ev == {K1: (30.0, 2),
                  "Memcpy HtoD (Pinned -> Device)": (800.0, 1),
                  "Memset (Device)": (4.0, 1), GEMM: (50.0, 1)}
    assert device_events(str(root / "trace.json"))[K1] == (30.0, 2)
    assert main([str(root)]) == 0
    assert device_events(str(tmp_path / "none")) == {}
    assert main([str(tmp_path / "none")]) == 1


def test_cli_capture_then_check(tmp_path, capsys):
    """capture writes a budget (buckets, the port's kernels a step); the
    same trace checks ok; a slower one fails with a regression; a trace
    without device events is an error."""
    from wide_deep_tpu_torch.tools.perf_regression import main
    fast = _trace(str(tmp_path / "fast" / "trace.json"), [
        ("kernel", K1, 300.0), ("kernel", K1, 300.0),
        ("kernel", GEMM, 3000.0)])
    budget = str(tmp_path / "budget.json")
    assert main(["capture", "--profile_dir", fast, "--steps", "2",
                 "--out", budget]) == 0
    with open(budget) as f:
        meta = json.load(f)
    assert meta["buckets_ms_per_step"] == {"kernel": 0.3, "matmul": 1.5,
                                           "total": 1.8}
    assert meta["kernels"] == {"range_chunk_kernel": {"ms": 0.3,
                                                      "launches": 1.0}}
    assert meta["card"]
    assert main(["check", "--profile_dir", fast, "--steps", "2",
                 "--budget", budget]) == 0
    verdict = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert verdict["ok"] and not verdict["findings"]
    slow = _trace(str(tmp_path / "slow" / "trace.json"), [
        ("kernel", K1, 300.0), ("kernel", GEMM, 4000.0)])
    assert main(["check", "--profile_dir", slow, "--steps", "2",
                 "--budget", budget]) == 1
    verdict = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [f["bucket"] for f in verdict["findings"]
            if f["kind"] == "regression"] == ["matmul", "total"]
    empty = _trace(str(tmp_path / "empty" / "trace.json"), [])
    assert main(["check", "--profile_dir", empty, "--budget", budget]) == 2
