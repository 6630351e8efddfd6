"""AUC against pack_budget on the bundled sample data (the port's
counterpart of tools/pack_budget_curve.py).

The pack budget caps the entries a multivalue slot keeps in the packed
pool; this measures what that cap costs in quality.  train.yaml's
``pack_budget: auto`` takes the p95-occupancy point of the curve
(``features/analyze.suggest_pack_budget``), printed first on stderr.

    python -m wide_deep_tpu_torch.tools.pack_budget_curve \
        [--budgets 1,2,3,8] [--epochs 5] [--seeds 123,321] [--device cpu]

Each (budget, seed) trains the small conf's model (``testing.small_config``)
on data/train at batch 64 and prints one JSON line: the budget, the seed,
the pools' packed lengths, the eval AUC and logloss on data/eval/eval1, and
the device (the card's name and power limit as nvidia-smi gives them).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import List, Optional, Sequence

from wide_deep_tpu_torch.features.native import REPO_ROOT
from wide_deep_tpu_torch.models.joint import resolve_device
from wide_deep_tpu_torch.tools.bench import device_name


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    """-> the printed lines, as dicts."""
    p = argparse.ArgumentParser(description="AUC against pack_budget")
    p.add_argument("--budgets", default="1,2,3,8")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--seeds", default="123,321")
    p.add_argument("--model_type", default="wide_deep")
    p.add_argument("--train_data", default=os.path.join(REPO_ROOT, "data",
                                                        "train"))
    p.add_argument("--eval_data", default=os.path.join(REPO_ROOT, "data",
                                                       "eval", "eval1"))
    p.add_argument("--device", default=None,
                   help="'cpu' trains on the host; default: the card")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    from wide_deep_tpu_torch.features.analyze import suggest_pack_budget
    from wide_deep_tpu_torch.features.plan import FeaturePlan
    from wide_deep_tpu_torch.testing import small_config
    from wide_deep_tpu_torch.tools.quality_onchip import release
    from wide_deep_tpu_torch.training.loop import Trainer

    train, evald = args.train_data, args.eval_data
    cfg = small_config(tempfile.mkdtemp(prefix="wdt_curve_conf_"))
    probe = FeaturePlan(cfg, fold=False, pack_budget=3)
    auto = suggest_pack_budget(probe, train)
    print(f"# p95-occupancy suggestion (pack_budget: auto): {auto}",
          file=sys.stderr)
    files = (sorted(os.path.join(train, f) for f in os.listdir(train))
             if os.path.isdir(train) else [train])
    out = []
    for budget in [int(b) for b in args.budgets.split(",")]:
        for seed in [int(s) for s in args.seeds.split(",")]:
            tr = Trainer(
                cfg, model_type=args.model_type,
                model_dir=tempfile.mkdtemp(prefix="wdt_curve_m_"),
                overrides=dict(train_data=train, eval_data=evald,
                               test_data=evald, keep_train=True,
                               batch_size=64, num_examples=4000,
                               pack_budget=budget),
                device=device)
            # the seed draws the weights, the dropout masks and the
            # shuffle orders
            tr.seed = seed
            tr._gen.manual_seed(seed)
            assert tr.plan.pack_budget == budget
            tr.ensure_initialized(restore=False)
            for epoch in range(args.epochs):
                for f in files:
                    tr.train_file(f, epoch_seed=epoch)
            res = tr.evaluate(evald)
            line = {"pack_budget": budget, "seed": seed,
                    "wide_pool": tr.plan.wide_packed_len,
                    "pools": {f"d{g.dim}": tr.plan.group_packed_len[g.dim]
                              for g in tr.plan.groups},
                    "auc": round(res["auc"], 5),
                    "logloss": round(res["average_loss"], 5),
                    "device": device_name(device)}
            print(json.dumps(line), flush=True)
            out.append(line)
            release(tr)
    return out


if __name__ == "__main__":
    main()
