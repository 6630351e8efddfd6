"""The readings that the limits of a DLRM-DCNv2 cell's ``correct`` are set
from, on the card at the cell's own size: for each seed, the program's
sound run against the reference (the lower reading), the control (the
reference with fp8 where the configuration says bfloat16) against the
reference, and a state left unchanged (the upper readings).

    python3 benchmark/tools/calibrate_dcn.py --workload dcnv2_train_packed \
        --seeds 1,2,3 [--seconds 2] --out <file.jsonl>

The program's first three steps as a run takes them (a short window after
them), then the reference and the control on the same rows from the same
weights.  One JSON line per seed.
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

from harness import dcn, env, judge, spec  # noqa: E402
from harness.weights import Weights  # noqa: E402


def _numbers(d):
    return {k: v[0] for k, v in d.items()}


def readings(cell, seed: int, seconds: float, device):
    setup = dcn.Setup(cell, seed)
    weights = Weights(setup.spec.leaf_specs(), setup.seed, device)
    prog = dcn.run_program(setup, device, seconds, False, weights,
                           time.time())
    program = prog["readings"]
    del prog
    gc.collect()
    import torch
    torch.cuda.empty_cache()
    batches = dcn.probed_batches(setup)
    ref = dcn.reference_readings(setup, weights, batches, device)
    lowp = dcn.reference_readings(setup, weights, batches, device, lowp=True)
    unchanged = dict(program,
                     change_norms={k: 0.0 for k in program["change_norms"]},
                     slot_norms={k: 0.0 for k in program["slot_norms"]})
    out = {"sound": _numbers(judge.training_numbers(program, ref)),
           "control": _numbers(judge.training_numbers(lowp, ref)),
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
    args = p.parse_args(argv)
    env.set_cache_dirs()
    cell = spec.Cell(args.workload)
    env.require_cards(int(cell.workload["chips"]))
    import torch
    device = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        line = {"workload": args.workload, "seed": seed,
                **readings(cell, seed, args.seconds, device),
                "seconds": time.perf_counter() - t}
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
        print(json.dumps(line), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
