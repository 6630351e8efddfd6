"""Per-bucket device-time regression tracking over profiler traces (the
port's copy of tools/perf_regression.py, with the card's buckets).

A torch.profiler trace of the bench tool's device stage becomes a stable
ms-a-step profile by bucket, which is compared against a committed budget:

    # 1. a 3-step trace of the bench tool's device stage (on the card)
    BENCH_PROFILE=build/prof BENCH_E2E=0 \\
        python -m wide_deep_tpu_torch.tools.bench
    # 2. record the budget (first time / after an accepted change)
    python -m wide_deep_tpu_torch.tools.perf_regression capture \\
        --profile_dir build/prof --steps 3 --out perf_budget_torch.json
    # 3. before shipping a change that touches the step
    python -m wide_deep_tpu_torch.tools.perf_regression check \\
        --profile_dir build/prof --steps 3 --budget perf_budget_torch.json

``check`` exits 1 when a bucket (or the total) exceeds its budget by more
than the tolerance (8%) and an absolute floor of 0.2 ms a step, or a new
bucket appears above the floor; it prints one JSON verdict line.  Buckets,
not kernel names: cuBLAS and cuDNN pick kernels by shape and version, and
their names churn; the buckets still localize a regression.  ``capture``
also records the port's kernels by symbol and, where ``nvidia-smi`` runs,
the card's name and power limit (a card set below its maximum runs slower
under load, so a budget holds only for its card and limit).
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from typing import Dict, Optional, Sequence, Tuple

from wide_deep_tpu_torch.tools.parse_trace import device_events

# the port's hand-written kernels (wide_deep_tpu_torch/csrc/*.cu) by their
# __global__ symbol; the optimizer sweeps (csrc/optim_sweep.cu,
# optim_elementwise_*_kernel) stay in the elementwise bucket, where the
# eager chains they replace were
PORT_KERNELS = {
    "range_chunk_kernel": "K1", "range_carry_kernel": "K1",
    "window_scatter_kernel": "K2", "rowdma_kernel": "K3",
    "gather_kernel": "P1", "bulk_row_scatter_kernel": "P2"}
_PORT_RE = re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(PORT_KERNELS)
                      + r")(?![A-Za-z0-9_])")

# (bucket, substring triggers) — first match wins; matched against the
# lowercased event name.  The port's kernels come first (by symbol), then
# the most specific; "conv" alone would catch the "convert" of casts.
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
BUCKETS = ("kernel",) + tuple(b for b, _ in BUCKET_RULES) + ("other",)
FLOOR_MS = 0.2


def port_kernel_of(name: str) -> Optional[str]:
    """The port kernel's symbol in a device event's name, or None."""
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


def profile_buckets(totals_us: Dict[str, float], steps: int
                    ) -> Dict[str, float]:
    """{event name: total us} -> {bucket: ms a step} (+ "total").  Events
    on several streams may overlap (the batch copy on its side stream), so
    the total may pass the step's wall time: what is tracked is one
    capture against another."""
    out: Dict[str, float] = {}
    for name, us in totals_us.items():
        b = bucket_of(name)
        out[b] = out.get(b, 0.0) + us / 1e3 / max(steps, 1)
    out["total"] = sum(out.values())
    return {k: round(v, 3) for k, v in out.items()}


def port_kernels(events: Dict[str, Tuple[float, int]], steps: int
                 ) -> Dict[str, Dict[str, float]]:
    """{symbol: {"ms": ms a step, "launches": events a step}} of the port's
    kernels in a trace."""
    out: Dict[str, Dict[str, float]] = {}
    for name, (us, n) in events.items():
        sym = port_kernel_of(name)
        if sym:
            e = out.setdefault(sym, {"ms": 0.0, "launches": 0.0})
            e["ms"] += us / 1e3 / max(steps, 1)
            e["launches"] += n / max(steps, 1)
    return {k: {"ms": round(v["ms"], 4), "launches": round(v["launches"], 3)}
            for k, v in sorted(out.items())}


def compare(budget: Dict[str, float], current: Dict[str, float],
            tolerance: float):
    """-> (ok, findings).  A bucket regresses when it exceeds its budget by
    more than ``tolerance`` (relative) AND by the absolute floor of 0.2 ms
    a step (tiny buckets jitter).  A new bucket above the floor regresses
    against an implicit 0; buckets that shrank or vanished are reported as
    improvements (informational)."""
    findings = []
    ok = True
    for name in sorted(set(budget) | set(current)):
        b = float(budget.get(name, 0.0))
        c = float(current.get(name, 0.0))
        delta = c - b
        if delta > max(tolerance * b, FLOOR_MS):
            findings.append({"bucket": name, "budget_ms": b,
                             "current_ms": c, "delta_ms": round(delta, 3),
                             "kind": "regression"})
            ok = False
        elif delta < -max(tolerance * b, FLOOR_MS):
            findings.append({"bucket": name, "budget_ms": b,
                             "current_ms": c, "delta_ms": round(delta, 3),
                             "kind": "improvement"})
    return ok, findings


def card() -> Optional[str]:
    """``nvidia-smi``'s "name, power limit" of the first card, or None."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    r = subprocess.run([exe, "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    lines = r.stdout.strip().splitlines()
    return lines[0].strip() if r.returncode == 0 and lines else None


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="per-bucket device-time regression tracking")
    p.add_argument("mode", choices=["capture", "check"])
    p.add_argument("--profile_dir", required=True,
                   help="a torch.profiler Chrome trace, or a dir holding "
                        "one (BENCH_PROFILE=dir ... tools.bench)")
    p.add_argument("--steps", type=int, default=3,
                   help="steps the trace covered (the bench tool's 3)")
    p.add_argument("--out", default="perf_budget_torch.json",
                   help="capture: budget file to write")
    p.add_argument("--budget", default="perf_budget_torch.json",
                   help="check: committed budget to compare against")
    p.add_argument("--tolerance", type=float, default=0.08,
                   help="relative regression tolerance per bucket")
    args = p.parse_args(argv)

    events = device_events(args.profile_dir)
    if not events:
        print(json.dumps({"error": f"no device events in a trace under "
                                   f"{args.profile_dir}"}))
        return 2
    current = profile_buckets({k: us for k, (us, _) in events.items()},
                              args.steps)
    if args.mode == "capture":
        meta = {"steps": args.steps, "buckets_ms_per_step": current,
                "kernels": port_kernels(events, args.steps),
                "card": card() or "not measured"}
        with open(args.out, "w") as f:
            json.dump(meta, f, indent=2, sort_keys=True)
            f.write("\n")
        print(json.dumps({"written": args.out, **current}))
        return 0
    with open(args.budget) as f:
        budget = json.load(f)["buckets_ms_per_step"]
    ok, findings = compare(budget, current, args.tolerance)
    print(json.dumps({"ok": ok, "tolerance": args.tolerance,
                      "total_ms": current.get("total"),
                      "budget_total_ms": budget.get("total"),
                      "findings": findings}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
