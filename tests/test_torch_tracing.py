"""The program's spans and counters (wide_deep_tpu_torch/tracing.py): off,
a train step records nothing and opens no ``record_function``; under a
profiler, or after ``enable()``, the train path's spans nest as the step
runs, their self times add up, and the profiler's trace holds them on its
own clock.  The ``cuda`` cases time the spans' streams on the card:

    python -m pytest tests/test_torch_tracing.py -q -m cuda
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from paths import REPO, TRAIN1  # noqa: E402
from wide_deep_tpu_torch import tracing  # noqa: E402

STEP_PHASES = ("train.forward", "train.backward", "train.update")
DEVICE_SPANS = STEP_PHASES + ("train.update.dense", "train.update.sparse",
                              "input.h2d.copy")


@pytest.fixture(autouse=True)
def clean():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _trainer(tmp_path, device="cpu"):
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.testing import write_small_conf
    from wide_deep_tpu_torch.training.loop import Trainer
    conf = write_small_conf(str(tmp_path / "conf"))
    return Trainer(Config(conf), model_type="wide_deep",
                   model_dir=str(tmp_path / "m"), device=device,
                   overrides=dict(train_data=TRAIN1, batch_size=16))


def _program_counters(snap):
    return {k: v for k, v in snap["counters"].items()
            if not k.startswith("kernels.")}


def test_off_records_nothing(tmp_path, monkeypatch):
    """A step through both prefetch iterators and ``train_batch`` records
    no span and no count, and opens no ``record_function``."""
    tr = _trainer(tmp_path)
    tr.ensure_initialized()

    def opened(name):
        raise AssertionError(f"record_function({name!r}) with tracing off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", opened)
    tr.train_file(TRAIN1, max_steps=2)
    assert tr.global_step == 2
    snap = tracing.snapshot()
    assert snap["spans"] == {} and _program_counters(snap) == {}
    assert "kernels.rowdma.rowdma_launches" in snap["counters"]
    assert "kernels.scatter.range_carry_launches" in snap["counters"]
    assert "kernels.optim_sweep.ftrl_launches" in snap["counters"]
    assert "kernels.optim_sweep.adagrad_launches" in snap["counters"]


def test_step_spans_under_the_profiler(tmp_path):
    """Under ``torch.profiler`` with host activity alone: each step's
    ``train.step`` holds the three phases, the update its two parts; the
    step's thread waits in ``input.wait.device``, the copy thread in
    ``input.wait.parsed``; self time is the duration less the children's;
    the exported trace holds the spans as ``user_annotation`` events, each
    phase inside its step."""
    from torch.profiler import ProfilerActivity, profile
    tr = _trainer(tmp_path)
    tr.ensure_initialized()
    steps = 3
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.train_file(TRAIN1, max_steps=steps)
    snap = tracing.snapshot()
    spans = snap["spans"]
    assert len(spans["train.step"]) == steps
    assert {o["parent"] for o in spans["train.step"]} == {None}
    step_ids = {o["step"] for o in spans["train.step"]}
    for name in STEP_PHASES:
        occ = spans[name]
        assert len(occ) == steps, name
        assert {o["parent"] for o in occ} == {"train.step"}, name
        assert {o["step"] for o in occ} == step_ids, name
        assert all(o["device_s"] is None for o in occ)     # the CPU
    for name in ("train.update.dense", "train.update.sparse"):
        assert {o["parent"] for o in spans[name]} == {"train.update"}
    wait = spans["input.wait.device"]
    assert len(wait) >= steps
    assert {o["thread"] for o in wait} == {"MainThread"}
    assert {o["parent"] for o in wait} == {None}
    assert "MainThread" not in {o["thread"]
                                for o in spans["input.wait.parsed"]}
    # self time: the duration less what the direct children cover
    for step in spans["train.step"]:
        children = sum(o["host_s"] for name in STEP_PHASES
                       for o in spans[name] if o["step"] == step["step"])
        assert step["self_s"] == pytest.approx(step["host_s"] - children,
                                               abs=1e-8)
        assert 0 <= step["self_s"] < step["host_s"]
    for upd in spans["train.update"]:
        parts = sum(o["host_s"] for name in ("train.update.dense",
                                             "train.update.sparse")
                    for o in spans[name] if o["step"] == upd["step"])
        assert upd["self_s"] == pytest.approx(upd["host_s"] - parts,
                                              abs=1e-8)
    assert len(tracing.per_step(snap, "train.update")) == steps

    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "user_annotation"]
    by_name = {}
    for e in events:
        by_name.setdefault(e["name"], []).append(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    assert len(by_name["train.step"]) == steps
    assert by_name.get("input.wait.device")
    for name in STEP_PHASES + ("train.update.dense", "train.update.sparse"):
        assert len(by_name[name]) == steps, name
        for s, t in by_name[name]:
            assert any(a <= s and t <= b for a, b in by_name["train.step"])


def test_enable_reset_and_the_bound():
    """``enable()`` records without a profiler; a phase run twice in one
    step sums in ``per_step``; ``reset`` clears records and counts; the
    buffer keeps the newest ``MAX_RECORDS`` spans."""
    with tracing.span("outer"):
        pass
    tracing.count("c", 3)
    assert tracing.snapshot()["spans"] == {}
    tracing.enable()
    assert not torch.autograd.profiler._is_profiler_enabled
    for _ in range(2):
        with tracing.span("outer"):
            for _ in range(2):
                with tracing.span("inner"):
                    pass
    tracing.count("c", 3)
    tracing.count("c", 4)
    snap = tracing.snapshot()
    inner = snap["spans"]["inner"]
    assert len(inner) == 4 and {o["parent"] for o in inner} == {"outer"}
    per_step = tracing.per_step(snap, "inner")
    assert len(per_step) == 2
    assert sum(per_step) == pytest.approx(sum(o["host_s"] for o in inner))
    assert snap["counters"]["c"] == 7
    tracing.reset()
    snap = tracing.snapshot()
    assert snap["spans"] == {} and _program_counters(snap) == {}
    for i in range(tracing.MAX_RECORDS + 3):
        with tracing.span(f"s{i}"):
            pass
    spans = tracing.snapshot()["spans"]
    assert len(spans) == tracing.MAX_RECORDS
    assert "s2" not in spans and f"s{tracing.MAX_RECORDS + 2}" in spans
    tracing.disable()
    tracing.reset()
    with tracing.span("outer"):
        pass
    assert tracing.snapshot()["spans"] == {}


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (device spans time card streams)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_device_spans_on_the_card(cuda_device, tmp_path):
    """Every span given the device records the stream's seconds between
    its markers at each occurrence; the wait spans record none."""
    tr = _trainer(tmp_path, "cuda")
    tr.ensure_initialized()
    tracing.enable()
    tr.train_file(TRAIN1, max_steps=3)
    spans = tracing.snapshot()["spans"]
    for name in DEVICE_SPANS:
        occ = spans[name]
        assert len(occ) >= 3, name
        assert all(o["device_s"] > 0 for o in occ), name
    assert all(o["device_s"] is None for o in spans["input.wait.device"])
    assert {o["parent"] for o in spans["input.h2d.copy"]} == {"input.h2d"}


@pytest.mark.cuda
def test_h2d_bytes_count_the_packed_buffer(cuda_device, tmp_path):
    """``input.h2d_bytes`` counts the one packed buffer a batch is sent
    in: ``pack_layout``'s size."""
    from wide_deep_tpu_torch.training.loop import pack_layout, to_device
    tr = _trainer(tmp_path, "cuda")
    batch = next(iter(tr._dataset(TRAIN1, "train")))
    tracing.enable()
    to_device(batch, cuda_device, torch.cuda.Stream(cuda_device))
    snap = tracing.snapshot()
    assert snap["counters"]["input.h2d_bytes"] == pack_layout(batch)[1]
    (copy,) = snap["spans"]["input.h2d.copy"]
    assert copy["device_s"] > 0


def test_the_loader_does_not_load_torch():
    """The loader's spans cost it no torch: a process that only parses
    (``features/pipeline``, as the input server's) imports no torch."""
    code = ("import sys, wide_deep_tpu_torch.features.pipeline; "
            "assert 'torch' not in sys.modules, 'torch loaded'")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=dict(os.environ, PYTHONPATH=REPO))
