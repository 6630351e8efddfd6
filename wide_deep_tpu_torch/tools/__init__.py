"""The port's tools, run as ``python -m wide_deep_tpu_torch.tools.<name>``:

* ``train``, ``eval``, ``pred``: the training, evaluation and prediction
  CLIs (counterparts of tools/{train,eval,pred}.py; shared plumbing in
  ``common``), ``inspect_checkpoint``: a checkpoint's leaves;
* ``microbench_vmem_gather``: P1, the row gather from a resident pool
  (counterpart of tools/microbench_vmem_gather.py);
* ``microbench_rowdma_scatter``: P2, the bulk row scatter (counterpart of
  tools/microbench_rowdma_scatter.py);
* ``bench``: training throughput, the device step and the loader-to-card
  path (counterpart of bench.py);
* ``export``, ``serve``, ``client``: a serving bundle from a checkpoint, the
  scoring server and its client (counterparts of tools/{export,serve,
  client}.py); ``bench_serving`` and ``microbench_serving_latency``:
  serving throughput by concurrency and one scoring call's latency by
  batch bucket;
* ``microbench_cudnn_determinism``: the CNN arm's forward + backward with
  and without cuDNN's deterministic algorithms.

Each runs on the card unless it is given ``--device cpu``, where the kernel
wrappers take their plain versions.  Shared here by the microbenchmarks and
the bench: the argument parser, the devices line and the timer.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from wide_deep_tpu_torch.models.joint import resolve_device


def parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default=None,
                   help="'cpu' runs the plain versions; default: the card")
    return p


def parse(p: argparse.ArgumentParser, argv: Optional[Sequence[str]]):
    """-> (args, device); raises naming CUDA when no card is present and
    the CPU was not asked for."""
    args = p.parse_args(argv)
    return args, resolve_device(args.device)


def devices_line(device: torch.device) -> str:
    if device.type == "cuda":
        names = [torch.cuda.get_device_name(i)
                 for i in range(torch.cuda.device_count())]
        return f"devices: {names} (running on {device})"
    return f"devices: [{device}] (plain versions, host clock)"


def median_ms(fn: Callable[[], object], iters: int, device: torch.device,
              warmup: int = 3) -> float:
    """Median time of one ``fn()`` over ``iters`` runs after ``warmup``:
    CUDA events around each run on the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))
