"""The readings that the limits of ``correct`` are set from, on the card at
the cell's own size: for each seed, the program's sound run against the
reference (the lower reading), the control against the reference, and the
planted faults against the reference (the upper readings).

    python3 benchmark/tools/calibrate.py --workload <name> --seeds 1,2,3 \
        [--seconds 10] --out <file.jsonl>

The program's first three steps as a run takes them (a short window after
them), then the reference, the reference in fp8 where the configuration
says bfloat16 (the control), and the reference with half of each batch
left out and the mean taken over the rest (a planted fault); a step that
leaves its state unchanged (params or slots) reads 1 by the change's
measure and needs no run.  One JSON line per seed.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (os.path.dirname(HERE), HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness import env, judge, spec, train  # noqa: E402
from harness.weights import Weights  # noqa: E402


def _numbers(d):
    return {k: v[0] for k, v in d.items()}


def training(cell, seed: int, seconds: float, device):
    setup = train.Setup(cell, seed)
    weights = Weights(setup.ref_model.leaf_specs(), setup.seed, device)
    prog = train.run_program(setup, device, seconds, False, weights,
                             time.time())
    readings = prog["readings"]
    del prog
    gc.collect()
    batches = train.parse_batches(setup, train.probed_lines(setup))
    ref = train.reference_readings(setup, weights, batches, device)
    lowp = train.reference_readings(setup, weights, batches, device,
                                    lowp=True)
    half = train.reference_readings(setup, weights, batches, device,
                                    half_batch=True)
    unchanged = dict(readings,
                     change_norms={k: 0.0 for k in readings["change_norms"]},
                     slot_norms={k: 0.0 for k in readings["slot_norms"]})
    out = {"sound": _numbers(judge.training_numbers(readings, ref)),
           "control": _numbers(judge.training_numbers(lowp, ref)),
           "half_batch": _numbers(judge.training_numbers(half, ref)),
           "unchanged_state": _numbers(judge.training_numbers(unchanged,
                                                              ref))}
    setup.cleanup()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    env.set_cache_dirs()
    cell = spec.Cell(args.workload)
    if args.device == "cuda":
        env.require_cards(int(cell.workload["chips"]))
    import torch
    device = torch.device(args.device)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = training(cell, seed, args.seconds, device)
        line = {"workload": args.workload, "seed": seed, **out,
                "seconds": time.perf_counter() - t}
        print(json.dumps(line), flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
