"""Serving throughput benchmark on the production config (the port's
counterpart of tools/bench_serving.py).

    python -m wide_deep_tpu_torch.tools.bench_serving [--device cpu] \
        [--bundle_dir E/1] [--rows_per_request 64] [--concurrency 1,8,64] \
        [--transport grpc|tcp]

Exports a bundle from a freshly initialized production Trainer's checkpoint
(random weights: serving cost does not depend on them) unless
``--bundle_dir`` names one, loads it into a ServingModel on the card,
starts an in-process PredictorServer and drives the concurrency load
harness (serving/client.py, the reference's client.py:40-137 analog) at
each concurrency level, over gRPC or the raw-TCP transport.  The server
micro-batches concurrent requests into one device call (MicroBatcher;
tensorflow_model_server --enable_batching parity).

Prints one JSON line per concurrency level: {"concurrency", "requests",
"rows_per_request", "rows_per_s", "p50_ms", "p99_ms", "errors",
"device_calls" (the level's own), "transport", "device" (the card's
name and power limit as nvidia-smi gives them)}; or, with
``--open_loop_rate``, one line per offered rate of the multi-process
open-loop harness.  Progress goes to stderr.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
import time
from typing import List, Optional, Sequence

import torch

from wide_deep_tpu_torch.features.native import REPO_ROOT
from wide_deep_tpu_torch.models.joint import resolve_device
from wide_deep_tpu_torch.tools.bench import device_name


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def fresh_bundle(config, work: str, device: torch.device) -> str:
    """A production Trainer's freshly initialized params, checkpointed and
    exported -> the bundle's version dir; the Trainer is freed first (its
    fused d32 table alone is 5 GB on the card)."""
    from wide_deep_tpu_torch.serving.export import export_savedmodel
    from wide_deep_tpu_torch.training.loop import Trainer
    model_dir = os.path.join(work, "model")
    tr = Trainer(config, model_type="wide_deep", model_dir=model_dir,
                 device=device)
    tr.ensure_initialized(restore=False)
    tr.save()
    del tr
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.time()
    version_dir = export_savedmodel(config, os.path.join(work, "export"),
                                    model_type="wide_deep",
                                    model_dir=model_dir, model_version=1)
    log(f"exported bundle in {time.time() - t0:.1f}s: {version_dir}")
    return version_dir


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    """-> the printed lines, as dicts."""
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.serving.client import (PredictorClient,
                                                    TcpPredictorClient,
                                                    do_inference,
                                                    open_loop_inference)
    from wide_deep_tpu_torch.serving.server import (PredictorServer,
                                                    ServingModel)

    p = argparse.ArgumentParser(description="serving throughput benchmark")
    p.add_argument("--bundle_dir", default=None,
                   help="reuse an existing bundle version dir")
    p.add_argument("--data_file",
                   default=os.path.join(REPO_ROOT, "data", "pred", "pred1"))
    p.add_argument("--num_requests", type=int, default=400)
    p.add_argument("--rows_per_request", type=int, default=1)
    p.add_argument("--max_batch_size", type=int, default=1024)
    p.add_argument("--batch_timeout_micros", type=int, default=2000)
    p.add_argument("--concurrency", default="1,8,64")
    p.add_argument("--open_loop_rate", default=None,
                   help="comma list of offered requests/s; runs the "
                        "multi-process open-loop harness instead of the "
                        "closed-loop threads (GIL-free, fixed offered load)")
    p.add_argument("--duration_s", type=float, default=10.0)
    p.add_argument("--processes", type=int, default=4)
    p.add_argument("--port", type=int, default=18600,
                   help="gRPC port; TCP at port + 1 (0: free ports)")
    p.add_argument("--transport", choices=["grpc", "tcp"], default="grpc",
                   help="what the clients speak; tcp starts no gRPC "
                        "endpoint")
    p.add_argument("--device", default=None,
                   help="'cpu' serves from the host; default: the card")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    config = Config()
    if args.bundle_dir:
        version_dir = args.bundle_dir
    else:
        work = tempfile.mkdtemp(prefix="wdt_bench_serving_")
        log(f"initializing production model -> checkpoint -> bundle "
            f"({work})")
        version_dir = fresh_bundle(config, work, device)

    model = ServingModel(version_dir, args.max_batch_size,
                         batch_timeout_micros=args.batch_timeout_micros,
                         device=device)
    t0 = time.time()
    model.warmup()
    log(f"warmup ({len(model.batch_buckets)} buckets) "
        f"{time.time() - t0:.1f}s")
    tcp = args.transport == "tcp"
    server = PredictorServer(model, port=None if tcp else args.port,
                             tcp_port=args.port + 1 if args.port else 0)
    server.start()
    out: List[dict] = []
    client = None
    try:
        with open(args.data_file, encoding="utf-8") as f:
            rows = [line.rstrip("\n") for line in f if line.strip()][:2048]
        if tcp:
            client = TcpPredictorClient(port=server.tcp_port)
        else:
            client = PredictorClient(port=server.port)
        client.predict(rows[:1])  # connection warm
        common = {"transport": args.transport, "device": device_name(device)}
        if args.open_loop_rate:
            for rate in [float(r) for r in args.open_loop_rate.split(",")]:
                calls0 = model.batcher.device_calls
                stats = open_loop_inference(
                    rows, rate, args.duration_s,
                    rows_per_request=args.rows_per_request,
                    processes=args.processes,
                    port=server.tcp_port if tcp else server.port,
                    kind=args.transport)
                stats["rows_per_request"] = args.rows_per_request
                stats["device_calls"] = model.batcher.device_calls - calls0
                stats.update(common)
                print(json.dumps(stats), flush=True)
                out.append(stats)
        else:
            for conc in [int(c) for c in args.concurrency.split(",")]:
                calls0 = model.batcher.device_calls
                stats = do_inference(client, rows, args.num_requests, conc,
                                     rows_per_request=args.rows_per_request)
                line = {"concurrency": conc,
                        "requests": stats["requests"],
                        "rows_per_request": args.rows_per_request,
                        "rows_per_s": stats["rows_per_s"],
                        "p50_ms": stats["p50_ms"],
                        "p99_ms": stats["p99_ms"],
                        "errors": stats["errors"],
                        "device_calls": (model.batcher.device_calls
                                         - calls0)}
                line.update(common)
                print(json.dumps(line), flush=True)
                out.append(line)
    finally:
        if client is not None:
            client.close()
        server.stop()
        model.close()
    return out


if __name__ == "__main__":
    main()
