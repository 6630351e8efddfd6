"""torch.profiler captures of stretches after the window, and what the
metric readers take from them.

The bucket rules and the port's kernel symbols are frozen copies of
wide_deep_tpu_torch/tools/perf_regression.py, and the device events those
of wide_deep_tpu_torch/tools/parse_trace.py (complete events of the
categories kernel, gpu_memcpy and gpu_memset), at commit
5396835d8e2c28384b317c5c7862110fa5df19db.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import time
from typing import Dict, List, Optional, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime",
                   "cuda_driver")

PORT_KERNELS = {
    "range_chunk_kernel": "K1", "range_carry_kernel": "K1",
    "window_scatter_kernel": "K2", "rowdma_kernel": "K3",
    "gather_kernel": "P1", "bulk_row_scatter_kernel": "P2"}
_PORT_RE = re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(PORT_KERNELS)
                      + r")(?![A-Za-z0-9_])")
BUCKET_RULES = [
    ("collective", ("nccl",)),
    ("memset", ("memset",)),
    ("copy", ("memcpy", "direct_copy", "catarraybatchedcopy")),
    ("conv", ("convolve", "conv2d", "conv_", "fprop", "dgrad", "wgrad",
              "cudnn", "winograd", "implicit_gemm")),
    ("matmul", ("gemm", "gemv", "cutlass", "cublas", "matmul")),
    ("index", ("index", "gather", "scatter", "embedding", "radixsort",
               "sort")),
    ("reduce", ("reduce", "reduction", "batch_norm", "layer_norm",
                "softmax", "scan")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "pointwise",
                     "fill")),
]

# the sparse-gradient work (kernels_roofline): the port's scatter and
# write-back kernels (K1, K2, K3), the library's index-add, index-put,
# scatter-add (ReduceAdd) and radix-sort kernels, and the memsets that
# clear their outputs.  Gathers and assigning scatters (one_hot, gather)
# are forward work; the forward's small indicator scatter-add is counted.
GRAD_WORK_NEEDLES = ("index_add", "indexadd", "index_put", "indexput",
                     "reduceadd", "radixsort")


def port_kernel_of(name: str) -> Optional[str]:
    m = _PORT_RE.search(name)
    return m.group(1) if m else None


def bucket_of(name: str) -> str:
    if port_kernel_of(name):
        return "kernel"
    low = name.lower()
    for bucket, needles in BUCKET_RULES:
        if any(n in low for n in needles):
            return bucket
    return "other"


def is_grad_work(name: str, cat: str) -> bool:
    if cat == "gpu_memset":
        return True
    sym = port_kernel_of(name)
    if sym:
        return PORT_KERNELS[sym] in ("K1", "K2", "K3")
    low = name.lower()
    return any(n in low for n in GRAD_WORK_NEEDLES)


class Capture:
    """A profiled stretch: ``with Capture(path, host) as cap:`` around the
    work.  ``host`` False records the card's activity alone (kernels,
    copies, memsets, the CUDA runtime's calls), which leaves the host's
    pace as it is; True also records every host op, which slows a host
    that dispatches many ops, so its window is for naming what the host
    did in the idle gaps.  The window is the host clock's time between two
    synchronisations around the body; every device event of the capture
    lies inside it."""

    def __init__(self, path: str, host: bool = False):
        self.path = path
        self.host = host
        self.window_s = 0.0

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CUDA] + (
            [ProfilerActivity.CPU] if self.host else [])
        torch.cuda.synchronize()
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._prof.export_chrome_trace(self.path)
        return False


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class Trace:
    """The device events of a capture inside its window (microseconds on
    the trace's clock), their union, and the host events around them."""

    def __init__(self, capture: Capture, steps: int):
        with open(capture.path) as f:
            doc = json.load(f)
        events = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
        self.steps = max(int(steps), 1)
        self._window_s = capture.window_s
        self.device: List[Tuple[str, str, float, float]] = []
        self.host: List[Tuple[str, float, float]] = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat")
            s = float(e.get("ts", 0.0))
            t = s + float(e.get("dur", 0.0))
            if cat in DEVICE_CATEGORIES:
                self.device.append((e.get("name", ""), cat, s, t))
            elif cat in HOST_CATEGORIES:
                self.host.append((e.get("name", ""), s, t))
        self.busy_intervals = _merge([(s, t) for _, _, s, t in self.device])

    @property
    def window_s(self) -> float:
        return self._window_s

    @property
    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy_intervals) / 1e6

    def device_s_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, _, s, t in self.device:
            out[name] = out.get(name, 0.0) + (t - s) / 1e6
        return out

    def bucket_ms_per_step(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, _, s, t in self.device:
            b = bucket_of(name)
            out[b] = out.get(b, 0.0) + (t - s) / 1e3 / self.steps
        return out

    def grad_work_s(self) -> float:
        return sum(t - s for name, cat, s, t in self.device
                   if is_grad_work(name, cat)) / 1e6

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """Idle seconds between the device's busy intervals by what the
        host was doing: the innermost host event (a host op where the
        capture recorded them, else a CUDA runtime call) at each gap's
        middle, most first."""
        gaps = [(a[1], b[0]) for a, b in zip(self.busy_intervals,
                                              self.busy_intervals[1:])]
        host = sorted((hs, he, name) for name, hs, he in self.host)
        out: Dict[str, float] = {}
        active: List[Tuple[float, float, str]] = []
        i = 0
        for s, t in gaps:                      # gaps come in time order
            mid = (s + t) / 2
            while i < len(host) and host[i][0] <= mid:
                active.append(host[i])
                i += 1
            active = [h for h in active if h[1] >= mid]
            label = (min(active, key=lambda h: h[1] - h[0])[2] if active
                     else "host: no traced call")
            out[label] = out.get(label, 0.0) + (t - s) / 1e6
        return sorted(out.items(), key=lambda kv: -kv[1])

    def grad_work_by_name(self) -> Dict[str, float]:
        """Device ms a step of each kernel the classifier counts as
        sparse-gradient work."""
        out: Dict[str, float] = {}
        for name, cat, s, t in self.device:
            if is_grad_work(name, cat):
                out[name] = out.get(name, 0.0) + (t - s) / 1e3 / self.steps
        return out

    def breakdown(self, gaps: "Trace" = None, n: int = 10
                  ) -> Dict[str, List[List[object]]]:
        """The device ops that took most time, and the idle gaps by host
        activity (from ``gaps``, a capture with host ops, where given)."""
        ops = sorted(self.device_s_by_name().items(), key=lambda kv: -kv[1])
        return {"device_ops": [[k, v] for k, v in ops[:n]],
                "idle_gaps": [[k, v] for k, v in
                              (gaps or self).idle_gaps()[:n]]}


def remove(path: str) -> None:
    with contextlib.suppress(OSError):
        os.remove(path)
