"""Spans and counters the benchmark records around its calls into the
program, and the per-layer metrics read from them and from the trace."""

from __future__ import annotations

import sys
from typing import Any, Dict, List, Optional

from .spec import metric_reader


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Recorder:
    """Spans (seconds, by name, in memory) and counters of one run."""

    def __init__(self):
        self.spans: Dict[str, List[float]] = {}
        self.counters: Dict[str, float] = {}
        self.trace = None

    def add(self, name: str, seconds: float) -> None:
        self.spans.setdefault(name, []).append(seconds)

    def count(self, name: str, value: float) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value


def read_metrics(entries: List[Dict[str, Any]], rec: Recorder,
                 trace=None) -> Dict[str, Dict[str, Any]]:
    """{name: {"value", "unit"}} of each per-layer metric whose reader
    finds something to read; the others are left out."""
    rec.trace = trace
    out: Dict[str, Dict[str, Any]] = {}
    for m in entries:
        value: Optional[float] = metric_reader(m["name"])(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
