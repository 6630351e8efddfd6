"""The sharded step's collective budget: capture + check (the port's
counterpart of tools/collective_budget.py).

Predicts, from shapes alone (parallel/collective_stats.step_collectives:
no process group, nothing allocated), the bytes and calls one rank's
collectives carry in one production train step (conf/ as shipped, batch
25600) on the JAX tool's mesh ``{data: 4, model: 2}``, fed with the
global batch, for ``sharded_lookup: explicit`` and ``dedup``; writes them
to ``collective_budget_torch.json`` or holds them to it.

    python -m wide_deep_tpu_torch.tools.collective_budget capture
    python -m wide_deep_tpu_torch.tools.collective_budget check

``check`` exits 1 when a tag's bytes exceed its budget by more than the
tolerance (15%), a tag's calls exceed twice its budget, a tag appears that
the budget lacks, or a budgeted tag vanishes (a counter that no longer
counts would make the gate vacuous).  The CPU suite runs it
(tests/test_torch_collective_budget.py), and chip_smoke.py holds the
counted bytes of the card's sharded runs to the same prediction.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUDGET_PATH = os.path.join(REPO, "collective_budget_torch.json")

MESH = {"data": 4, "model": 2}
BATCH_SIZE = 25600
LOOKUPS = ("explicit", "dedup")
TOLERANCE = 1.15


def predict(mesh: Dict[str, int] = MESH, batch_size: int = BATCH_SIZE,
            conf_dir: Optional[str] = None) -> Dict[str, Dict[str, Any]]:
    """{lookup: step_collectives(...)} for the production configuration."""
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.parallel.collective_stats import step_collectives
    config = Config(conf_dir or os.path.join(REPO, "conf"))
    train_conf = dict(config.train, batch_size=batch_size, pack_budget=None)
    out = {}
    for lookup in LOOKUPS:
        s = step_collectives(config, train_conf, mesh["data"], mesh["model"],
                             global_batch_input=True, lookup=lookup)
        by_tag = {}
        for key, e in s["ops"].items():
            tag = key.split("/")[0]
            t = by_tag.setdefault(tag, {"bytes": 0, "calls": 0})
            t["bytes"] += e["bytes"]
            t["calls"] += e["calls"]
        out[lookup] = {"per_tag": by_tag, "ops": s["ops"],
                       "total_bytes": s["total_bytes"], "plan": s["plan"]}
    return out


def capture(path: str = BUDGET_PATH) -> Dict[str, Any]:
    budget = {
        "mesh": dict(MESH),
        "batch_size": BATCH_SIZE,
        "lookups": predict(),
        "tolerance": TOLERANCE,
        "assumptions": {
            "counter": "bytes a rank puts into each collective "
                       "(parallel/mesh.collective_bytes): an all-gather's "
                       "input, an all-reduce's and a reduce-scatter's whole "
                       "buffer; a group of one rank counts nothing",
            "input": "every rank's plan is built from the global batch "
                     "(the JAX tool's single-process mesh; in the port the "
                     "input service, or a 'data' axis of 1)",
            "time_model": "none: no link between two cards has been "
                          "measured for the port (one card), so the JAX "
                          "tool's v5e ring time is left out",
        },
    }
    with open(path, "w") as f:
        json.dump(budget, f, indent=2, sort_keys=True)
        f.write("\n")
    return budget


def compare(budget: Dict[str, Any], got: Dict[str, Dict[str, Any]]
            ) -> List[str]:
    """-> violations of ``got`` (``predict``'s form) against ``budget``."""
    tol = budget.get("tolerance", TOLERANCE)
    problems = []
    for lookup, allowed in budget["lookups"].items():
        if lookup not in got:
            problems.append(f"{lookup}: not predicted")
            continue
        have = got[lookup]["per_tag"]
        for tag, e in have.items():
            a = allowed["per_tag"].get(tag)
            if a is None:
                problems.append(f"{lookup}: new collective tag {tag}: "
                                f"{e['bytes']}B x{e['calls']}")
                continue
            if e["bytes"] > a["bytes"] * tol:
                problems.append(f"{lookup}: {tag}: {e['bytes']}B exceeds "
                                f"budget {a['bytes']}B x{tol}")
            if e["calls"] > a["calls"] * 2:
                problems.append(f"{lookup}: {tag}: {e['calls']} calls "
                                f"exceed 2x budget {a['calls']}")
        for tag in allowed["per_tag"]:
            if tag not in have:
                problems.append(f"{lookup}: budgeted tag {tag} missing from "
                                f"the step: a collective stopped counting?")
    return problems


def check(path: str = BUDGET_PATH) -> List[str]:
    with open(path) as f:
        budget = json.load(f)
    return compare(budget, predict(budget["mesh"], budget["batch_size"]))


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="the sharded step's "
                                             "collective budget")
    ap.add_argument("mode", choices=["capture", "check"])
    ap.add_argument("--path", default=BUDGET_PATH)
    args = ap.parse_args(argv)
    if args.mode == "capture":
        print(json.dumps(capture(args.path), indent=2, sort_keys=True))
        return 0
    problems = check(args.path)
    for p in problems:
        print(f"VIOLATION: {p}")
    if not problems:
        print("collective volume within budget")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
