"""Serving SLO capture and regression gate (the port's counterpart of
tools/serving_slo.py).

    python -m wide_deep_tpu_torch.tools.serving_slo capture   # writes the budget
    python -m wide_deep_tpu_torch.tools.serving_slo check     # fails on regression
        [--device cpu] [--bundle_dir E/1] [--budget serving_slo_torch.json]
        [--tolerance 0.3] [--num_requests 200]

Measures p50 / p99 latency and rows/s at 1 and 64 rows a request, at one
concurrency level, over both transports where the ``grpc`` package imports
(the gRPC-framed ``PredictorClient`` and the framed-TCP
``TcpPredictorClient``, the C++ client's protocol) and over TCP alone
otherwise; every line names its transport, and the capture lists the ones
measured.  The bundle is the production config's, exported from a freshly
initialized Trainer (random weights: serving cost does not depend on them)
unless ``--bundle_dir`` names one; it is served on the card unless
``--device cpu``.

The budget is the card's own, ``serving_slo_torch.json`` (its ``device``:
the card's name and power limit as nvidia-smi gives them);
serving_slo.json is the JAX package's, taken on a TPU.  ``check``
re-measures (as many requests a cell as the budget took, unless
``--num_requests`` says otherwise) and fails where a p99 exceeds the
budget's by more than
``--tolerance`` (default 30%: network and micro-batching jitter) plus 1 ms,
or rows/s fall below (1 - tolerance) x the budget's.  A cell of the budget
that this run cannot measure (gRPC without its package) is reported, not
failed.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import torch

from wide_deep_tpu_torch.features.native import REPO_ROOT
from wide_deep_tpu_torch.models.joint import resolve_device
from wide_deep_tpu_torch.tools.bench import device_name

BUDGET = os.path.join(REPO_ROOT, "serving_slo_torch.json")
ROWS_PER_REQUEST = (1, 64)
CONCURRENCY = 8


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def transports() -> List[str]:
    """The transports this host can drive: gRPC where its package imports,
    TCP always."""
    try:
        import grpc  # noqa: F401
    except ImportError:
        return ["tcp"]
    return ["grpc", "tcp"]


def measure(bundle_dir: Optional[str] = None, num_requests: int = 200,
            concurrency: int = CONCURRENCY, device=None,
            data_file: Optional[str] = None) -> List[Dict]:
    """One entry per (transport, rows a request): p50 / p99 ms, rows/s,
    requests/s, errors (each must be 0)."""
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.serving.client import (PredictorClient,
                                                    TcpPredictorClient,
                                                    do_inference)
    from wide_deep_tpu_torch.serving.server import (PredictorServer,
                                                    ServingModel)
    from wide_deep_tpu_torch.tools.bench_serving import fresh_bundle

    device = resolve_device(device)
    if not bundle_dir:
        work = tempfile.mkdtemp(prefix="wdt_serving_slo_")
        log(f"initializing production model -> checkpoint -> bundle "
            f"({work})")
        bundle_dir = fresh_bundle(Config(), work, device)
    model = ServingModel(bundle_dir, max_batch_size=1024,
                         batch_timeout_micros=2000, device=device)
    t0 = time.time()
    model.warmup()
    log(f"serving warmup {time.time() - t0:.1f}s")
    kinds = transports()
    server = PredictorServer(model, port=0 if "grpc" in kinds else None,
                             tcp_port=0)
    server.start()
    data = data_file or os.path.join(REPO_ROOT, "data", "pred", "pred1")
    with open(data, encoding="utf-8") as f:
        rows = [line.rstrip("\n") for line in f if line.strip()][:2048]
    results = []
    try:
        for transport in kinds:
            client = (PredictorClient(port=server.port) if transport == "grpc"
                      else TcpPredictorClient(port=server.tcp_port))
            try:
                client.predict(rows[:1])          # connection warm
                for rpr in ROWS_PER_REQUEST:
                    stats = do_inference(client, rows, num_requests,
                                         concurrency, rows_per_request=rpr)
                    entry = {"transport": transport, "rows_per_request": rpr,
                             "concurrency": concurrency,
                             "requests_per_s": stats["rows_per_s"] / rpr,
                             "rows_per_s": stats["rows_per_s"],
                             "p50_ms": stats["p50_ms"],
                             "p99_ms": stats["p99_ms"],
                             "errors": stats["errors"]}
                    if entry["errors"]:
                        raise RuntimeError(f"serving errors: {entry}")
                    log(f"{transport} rows/req={rpr}: "
                        f"{entry['rows_per_s']:,.0f} rows/s "
                        f"p50={entry['p50_ms']:.2f}ms "
                        f"p99={entry['p99_ms']:.2f}ms")
                    results.append(entry)
            finally:
                client.close()
    finally:
        server.stop()
        model.close()
        del model
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return results


def check(results: Sequence[Dict], budget: Dict,
          tolerance: float = 0.30) -> Dict[str, List[str]]:
    """``results`` against ``budget`` -> {"failures": [...], "unmeasured":
    [...]}: a p99 above the budget's x (1 + tolerance) + 1 ms, or rows/s
    below the budget's x (1 - tolerance), fails its cell; a budget cell
    with no result is unmeasured."""
    got = {(r["transport"], r["rows_per_request"]): r for r in results}
    failures, unmeasured = [], []
    for b in budget["results"]:
        key = (b["transport"], b["rows_per_request"])
        name = f"{key[0]}/rows{key[1]}"
        r = got.get(key)
        if r is None:
            unmeasured.append(name)
            continue
        if r["p99_ms"] > b["p99_ms"] * (1 + tolerance) + 1.0:
            failures.append(f"{name}: p99 {r['p99_ms']:.2f}ms > budget "
                            f"{b['p99_ms']:.2f}ms (+{tolerance:.0%})")
        if r["rows_per_s"] < b["rows_per_s"] * (1 - tolerance):
            failures.append(f"{name}: {r['rows_per_s']:,.0f} rows/s < "
                            f"budget {b['rows_per_s']:,.0f} "
                            f"(-{tolerance:.0%})")
    return {"failures": failures, "unmeasured": unmeasured}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """-> the capture written, or the check's verdict; a failed check
    exits 1."""
    p = argparse.ArgumentParser(description="serving SLO capture / gate")
    p.add_argument("mode", choices=["capture", "check"])
    p.add_argument("--budget", default=BUDGET)
    p.add_argument("--tolerance", type=float, default=0.30)
    p.add_argument("--bundle_dir", default=None,
                   help="an existing bundle version dir (default: export "
                        "one from a fresh production Trainer)")
    p.add_argument("--num_requests", type=int, default=None,
                   help="requests a cell (default: capture 200, check the "
                        "budget's own count)")
    p.add_argument("--device", default=None,
                   help="'cpu' serves from the host; default: the card")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    n = args.num_requests or 200
    if args.mode == "check":
        with open(args.budget) as f:
            budget = json.load(f)
        n = args.num_requests or budget.get("num_requests", n)
    results = measure(args.bundle_dir, n, CONCURRENCY, device)
    here = {"device": device_name(device), "num_requests": n,
            "concurrency": CONCURRENCY,
            "transports": sorted({r["transport"] for r in results}),
            "results": results}
    if args.mode == "capture":
        with open(args.budget, "w") as f:
            json.dump(here, f, indent=1)
            f.write("\n")
        print(json.dumps(dict(here, captured=args.budget)), flush=True)
        return here
    verdict = check(results, budget, args.tolerance)
    line = dict(here, budget_device=budget.get("device"),
                tolerance=args.tolerance, **verdict)
    print(json.dumps(line), flush=True)
    if verdict["failures"]:
        print("SERVING SLO REGRESSION:\n  "
              + "\n  ".join(verdict["failures"]), file=sys.stderr)
        sys.exit(1)
    return line


if __name__ == "__main__":
    main()
