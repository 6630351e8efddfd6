"""Step-time experiment: the fused d32 sparse update applied in its own
step (immediate) against one step later (``train_step(defer_sparse=True)``).

    python -m wide_deep_tpu_torch.tools.experiment_defer_sparse [--device cpu]

The port's counterpart of tools/experiment_defer_sparse.py.  Deferred, a
step starts with the previous step's fused update (K1 over its compact
gradient, the row gather and formula, K3's write-back), where it depends
only on the d32 table, before the forward; immediate, it runs after the
backward.  Both variants run the bench tool's program (``bench.
make_program``: the production conf/, batch 25600, one synthetic batch on
the card), each from a fresh initialisation: 3 warm-up steps, then the
median of 20 steps, each timed by CUDA events (the tools' ``median_ms``).
The deferred side starts with its tables' counts at -1 and a pending
update of the batch's plan with zero gradients
(``training.step.seed_pending``), so the seed apply leaves the weights as
they are and step k's gradients apply at count k, as immediately.  Prints each median step
time, the difference and the card's name and power limit; the last line is
one JSON object.  Claims no gain.
"""

from __future__ import annotations

import gc
import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from wide_deep_tpu_torch.tools import median_ms, parse, parser

WARMUP = 3
MEASURE = 20
ORDER = ("immediate", "deferred")


def run_variant(config, batch_size: int, device, defer: bool
                ) -> Dict[str, float]:
    """A fresh program -> the median step time of one variant and the loss
    of one more step."""
    from wide_deep_tpu_torch.tools import bench
    from wide_deep_tpu_torch.training.step import seed_pending, train_step
    prog = bench.make_program(config, batch_size, device)
    tr = prog.trainer
    dbatch = tr._device_batch(prog.batch)
    if defer:
        seed_pending(tr.sparse_tables, tr.opt_state, dbatch)

    def step():
        tr.mstate, loss = train_step(tr.model, tr.tx, tr.params, tr.mstate,
                                     tr.opt_state, dbatch, tr.sparse_tables,
                                     rng=tr._gen, defer_sparse=defer)
        return loss
    ms = median_ms(step, MEASURE, device, warmup=WARMUP)
    loss = float(step())
    if not np.isfinite(loss):
        raise SystemExit(f"non-finite loss {loss}")
    return {"median_ms": ms, "loss": loss}


def main(argv: Optional[Sequence[str]] = None):
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.tools.bench import (BATCH_SIZE, REPO_ROOT,
                                                 device_name)
    _, device = parse(parser(__doc__.splitlines()[0]), argv)
    batch = int(os.environ.get("BENCH_BATCH_SIZE", BATCH_SIZE))
    config = Config(os.path.join(REPO_ROOT, "conf"))
    results = {}
    for tag in ORDER:
        results[tag] = run_variant(config, batch, device, tag == "deferred")
        print(f"{tag}: median {results[tag]['median_ms']:.4f} ms/step over "
              f"{MEASURE} steps, then loss {results[tag]['loss']}",
              flush=True)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    out = {"immediate_ms": results["immediate"]["median_ms"],
           "deferred_ms": results["deferred"]["median_ms"],
           "delta_ms": (results["immediate"]["median_ms"]
                        - results["deferred"]["median_ms"]),
           "batch_size": batch, "steps": MEASURE,
           "device": device_name(device)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
