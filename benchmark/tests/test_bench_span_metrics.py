"""The readers of the program's own spans (``metrics/`` files that read
``wide_deep_tpu_torch.tracing`` through ``harness/spans.py``): None where
the run has no trace, where nothing was recorded and where the program has
no spans, else the median a step, in ms, over the steps of the traced
stretch's card-only capture."""

from __future__ import annotations

import sys
import types

import pytest

from harness import spec

READERS = {
    "train_step_host_ms": ("train.step", "host_s"),
    "train_input_wait_ms": ("input.wait.device", "host_s"),
    "h2d_ms": ("input.h2d.copy", "device_s"),
    "stream_ms.forward": ("train.forward", "device_s"),
    "stream_ms.backward": ("train.backward", "device_s"),
    "stream_ms.update": ("train.update", "device_s"),
}


def _occ(step, field, value):
    occ = {"start_s": 0.0, "host_s": 0.5, "self_s": 0.5, "device_s": None,
           "parent": None, "thread": "MainThread", "step": step}
    occ[field] = value
    return occ


def _run(steps=10):
    """A run whose trace's card-only capture held ``steps`` steps."""
    return types.SimpleNamespace(trace=types.SimpleNamespace(steps=steps))


@pytest.fixture
def tracing():
    pytest.importorskip("torch")
    from wide_deep_tpu_torch import tracing
    return tracing


@pytest.mark.parametrize("name", sorted(READERS))
def test_nothing_recorded(tracing, monkeypatch, name):
    monkeypatch.setattr(tracing, "snapshot",
                        lambda: {"spans": {}, "counters": {}})
    assert spec.metric_reader(name)(_run()) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_run_without_a_trace(tracing, monkeypatch, name):
    """An untraced run reads nothing, even where spans were recorded."""
    span, field = READERS[name]
    monkeypatch.setattr(tracing, "snapshot", lambda: {
        "spans": {span: [_occ(1, field, 0.010)]}, "counters": {}})
    untraced = types.SimpleNamespace(trace=None)
    assert spec.metric_reader(name)(untraced) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_program_without_spans(tracing, monkeypatch, name):
    """The parent of the change that added the spans: the import fails,
    the reader gives None and does not raise."""
    import wide_deep_tpu_torch
    monkeypatch.delattr(wide_deep_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "wide_deep_tpu_torch.tracing", None)
    assert spec.metric_reader(name)(_run()) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_median_a_step(tracing, monkeypatch, name):
    """Steps of 10, 4 + 4 (one span twice in a step) and 30 ms, one
    occurrence without the field and another span's records: 10 ms.  Two
    slow host-traced steps after a capture of 3 are left out."""
    span, field = READERS[name]
    other = "train.other"
    snap = {"spans": {
        span: [_occ(1, field, 0.010), _occ(2, field, 0.004),
               _occ(2, field, 0.004), _occ(3, field, 0.030),
               _occ(4, field, None), _occ(5, field, 0.090),
               _occ(6, field, 0.090)],
        other: [_occ(7, field, 9.0)]}, "counters": {}}
    monkeypatch.setattr(tracing, "snapshot", lambda: snap)
    assert spec.metric_reader(name)(_run(3)) == pytest.approx(10.0)
