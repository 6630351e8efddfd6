"""The program's spans and counters: what each layer of the train path
took, kept in memory, on the profiler's clock.

    with tracing.span("train.forward", device):
        ...
    tracing.count("input.h2d_bytes", n)
    tracing.snapshot()      # -> {"spans": {name: [...]}, "counters": {...}}

Off, which is the default, ``span`` returns one shared no-op object and
``count`` returns at once: a boolean read, a ``sys.modules`` lookup and a
second boolean read, with no allocation, no ``record_function`` and no CUDA
event.  Tracing is on while ``enable()`` holds or while a ``torch.profiler``
runs in the process (``torch.autograd.profiler._is_profiler_enabled``, a
module flag that every thread sees; the C++ ``_profiler_enabled()``
answers for its own thread alone).  The module imports torch only once a
span opens, so a process that only parses (the loader, the input server)
does not load it: where ``torch.autograd.profiler`` is not yet imported,
no profiler can be running.

On, a span
* opens ``record_function(name)``, so a profiler's trace holds it as a
  ``user_annotation`` on the trace's own clock, where the device's idle
  gaps can be named by it;
* records its host start and duration (``perf_counter_ns``), its thread,
  its parent (the innermost span open in that thread) and its step (the
  outermost one), and so its self time: its duration less its children's;
* given a CUDA ``device``, records a pair of timing events on that
  device's current stream around its body: the stream's time between the
  markers.  They are resolved by ``snapshot``, never on the hot path.
Records go into a deque of at most ``MAX_RECORDS``; the oldest drop out.

The train path's spans (the benchmark's ``metrics/`` read them by name):

  input.wait.<stage>    PrefetchIterator.__next__'s wait for its queue, in
                        the consumer: ``parsed`` batches (the copy thread
                        under DevicePrefetchIterator), ``device`` ones (the
                        step's thread)
  input.h2d             training/loop.to_device: pack and enqueued copy,
                        in the copy thread; counter ``input.h2d_bytes``
  input.h2d.copy        its copy alone, timed on the copy stream
  train.step            Trainer.train_batch, the whole call
  train.forward         the model's loss                      (device)
  train.backward        autograd, and on a mesh the replicated
                        gradients' all-reduce                 (device)
  train.update          the optimizers' phase                 (device)
  train.update.dense    the dense per-arm update              (device)
  train.update.sparse   the touched-rows tables' updates      (device)

``snapshot`` also reads the kernels' launch counters of ``ops/scatter.py``,
``ops/rowdma.py`` and ``ops/optim_sweep.py`` (one launch a dense FTRL or
Adagrad leaf a step) where they are kept, as ``kernels.<module>.<name>``:
launches since the process started, not since ``reset``.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import sys
import threading
import time
from typing import TYPE_CHECKING, Any, Dict, List, Optional

if TYPE_CHECKING:
    import torch

MAX_RECORDS = 4096

_on = False
_records: "collections.deque" = collections.deque(maxlen=MAX_RECORDS)
_counters: Dict[str, float] = {}
_counters_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count()


def enable() -> None:
    """Record spans and counts whether or not a profiler runs."""
    global _on
    _on = True


def disable() -> None:
    """Record only while a profiler runs (the default)."""
    global _on
    _on = False


def reset() -> None:
    """Drop every record and count."""
    _records.clear()
    with _counters_lock:
        _counters.clear()


_OFF = contextlib.nullcontext()     # the span of tracing off
_PROFILER = "torch.autograd.profiler"


def _profiling() -> bool:
    prof = sys.modules.get(_PROFILER)
    return prof is not None and prof._is_profiler_enabled


def span(name: str, device: Optional["torch.device"] = None):
    """A context manager timing its body as span ``name``; with a CUDA
    ``device``, also the work the body enqueues on that device's current
    stream."""
    if not (_on or _profiling()):
        return _OFF
    return _Span(name, device)


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to counter ``name`` while tracing is on."""
    if not (_on or _profiling()):
        return
    with _counters_lock:
        _counters[name] = _counters.get(name, 0) + n


def _stack() -> List["_Span"]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "device", "id", "parent", "step", "child_ns", "t0",
                 "rf", "stream", "ev0")

    def __init__(self, name: str, device: Optional["torch.device"]):
        self.name = name
        self.device = (device if device is not None
                       and device.type == "cuda" else None)

    def __enter__(self):
        import torch
        from torch.autograd import profiler
        stack = _stack()
        self.id = next(_ids)
        self.parent = stack[-1] if stack else None
        self.step = stack[0].id if stack else self.id
        self.child_ns = 0
        stack.append(self)
        self.rf = profiler.record_function(self.name)
        self.rf.__enter__()
        self.ev0 = None
        if self.device is not None:
            self.stream = torch.cuda.current_stream(self.device)
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record(self.stream)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self.t0
        ev1 = None
        if self.ev0 is not None:
            import torch
            ev1 = torch.cuda.Event(enable_timing=True)
            ev1.record(self.stream)
        self.rf.__exit__(*exc)
        _stack().pop()
        parent = self.parent
        if parent is not None:
            parent.child_ns += dur
        _records.append((self.name, parent.name if parent else None,
                         threading.current_thread().name, self.step,
                         self.t0, dur, self.child_ns, self.ev0, ev1,
                         self.device))
        return False


def _kernel_counters() -> Dict[str, int]:
    from wide_deep_tpu_torch.ops import optim_sweep, rowdma, scatter
    out = {f"kernels.scatter.{k}": getattr(scatter, k)
           for k in ("range_launches", "range_carry_launches",
                     "window_launches", "window_ok0_launches")}
    out.update({f"kernels.scatter.range_launches.d{d}": n
                for d, n in scatter.range_launches_by_width().items()})
    out.update({f"kernels.rowdma.{k}": getattr(rowdma, k)
                for k in ("rowdma_launches", "bulk_scatter_launches")})
    out.update({f"kernels.rowdma.rowdma_launches.w{w}": n
                for w, n in rowdma.rowdma_launches_by_width.items()})
    out.update({f"kernels.optim_sweep.{k}": getattr(optim_sweep, k)
                for k in ("ftrl_launches", "adagrad_launches")})
    return out


def snapshot() -> Dict[str, Any]:
    """-> ``{"spans": {name: [occurrence]}, "counters": {name: n}}``, an
    occurrence ``{"start_s", "host_s", "self_s", "device_s", "parent",
    "thread", "step"}`` (seconds; ``device_s`` None where the span timed no
    stream).  Synchronises each device that holds events once."""
    records = _records.copy()
    for dev in {r[9] for r in records if r[9] is not None}:
        import torch
        torch.cuda.synchronize(dev)
    spans: Dict[str, List[Dict[str, Any]]] = {}
    for name, parent, thread, step, t0, dur, child, ev0, ev1, _ in records:
        spans.setdefault(name, []).append({
            "start_s": t0 / 1e9, "host_s": dur / 1e9,
            "self_s": (dur - child) / 1e9,
            "device_s": (ev0.elapsed_time(ev1) / 1e3 if ev0 is not None
                         else None),
            "parent": parent, "thread": thread, "step": step})
    with _counters_lock:
        counters: Dict[str, float] = dict(_counters)
    counters.update(_kernel_counters())
    return {"spans": spans, "counters": counters}


def per_step(snap: Dict[str, Any], name: str,
             field: str = "host_s") -> List[float]:
    """Each step's sum of ``field`` over the occurrences of span ``name``
    in ``snap`` (a step: the outermost span open in the thread, so that a
    phase run twice in one step, as ``train.update`` is under
    ``defer_sparse``, counts once), leaving out occurrences without it."""
    sums: Dict[int, float] = {}
    for occ in snap["spans"].get(name, ()):
        if occ[field] is not None:
            sums[occ["step"]] = sums.get(occ["step"], 0.0) + occ[field]
    return list(sums.values())
