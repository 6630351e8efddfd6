"""Run one cell of BENCHMARK.json once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1> [--readings <file>]

Set-up (rows and weights from the seed, the program built and warmed up),
a window of ``--seconds``, then the check of what the window's program
produced against the plain reference.  The last line on stdout is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``
(with ``--trace 1`` also ``busy_s`` and ``window_s``), ``breakdown`` with
``--trace 1``, and last ``compared``: each number that decides
``correct`` with its limit, also the last lines on stderr.  ``--readings``
appends the compared numbers and both sides' raw readings to a file as a
JSON line.

No CUDA card, or fewer than the cell asks for: exit 1 and no result.  JAX
or the JAX package in ``sys.modules`` once the window has closed: exit 1
and no result.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# the harness's own packages, and the checkout's root, where the program
# under test (wide_deep_tpu_torch) lies
for _p in (os.path.dirname(HERE), HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness import env, spec  # noqa: E402


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--readings", default=None)
    return p.parse_args(argv)


def finite(obj):
    """``obj`` with every float that is not finite replaced by +-1e300, so
    that the line stays JSON (an infinite gap: a side that gave NaN)."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return -1e300 if obj < 0 else 1e300
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite(v) for v in obj]
    return obj


def main(argv=None) -> int:
    start = env.process_start_time()
    args = parse_args(argv)
    env.set_cache_dirs()
    cell = spec.Cell(args.workload)
    # the traffic mix's kind names the module that runs it, harness/<kind>.py
    kind = importlib.import_module(f"harness.{cell.traffic['kind']}")
    result = kind.run(cell, args, start)
    readings = result.pop("_readings", None)
    bad = env.forbidden_loaded()
    if bad:
        print(f"the measured process loaded {bad}: the benchmark runs the "
              f"port alone", file=sys.stderr)
        return 1
    if args.readings:
        with open(args.readings, "a") as f:
            f.write(json.dumps(finite({
                "workload": args.workload, "seed": args.seed,
                "trace": args.trace, "readings": readings,
                "compared": result["compared"]})) + "\n")
    result = finite(result)
    for k, v in result["compared"].items():
        print(f"{k} {v['value']!r} limit {v['limit']!r} ({v['at']})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
