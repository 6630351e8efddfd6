"""Dataset analyzer: label balance, packed-pool occupancy, OOV rates (the
port's copy of tools/analyze_data.py; the same flags, the same report).

Device step cost is linear in the packed pool widths, so this tool measures
what the data actually needs and suggests a ``pack_budget`` (train.yaml).
Also reports vocab out-of-vocabulary rates (silently dropped values) and
missing-value rates for continuous features.

    python -m wide_deep_tpu_torch.tools.analyze_data --data data/train \
        [--max_rows 50000]
"""

from __future__ import annotations

import argparse
from collections import Counter, defaultdict
from typing import Optional, Sequence

import numpy as np


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description="analyze a TSV CTR dataset")
    p.add_argument("--data", default="data/train")
    p.add_argument("--max_rows", type=int, default=50000)
    args = p.parse_args(argv)

    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.features.pipeline import list_files
    from wide_deep_tpu_torch.features.plan import FeaturePlan

    config = Config()
    plan = FeaturePlan(config)
    col = plan.column_index
    feature_conf = plan.feature_conf

    labels = Counter()
    value_counts = defaultdict(list)   # multivalue feature -> per-row counts
    oov = Counter()
    seen = Counter()
    missing_cont = Counter()
    vocab_maps = {s.name: set(s.vocab) for s in plan.indicator_slots
                  if s.kind == "vocab"}
    n_rows = 0
    for path in list_files(args.data):
        with open(path, encoding="utf-8") as f:
            for line in f:
                cells = line.rstrip("\n").split("\t")
                if len(cells) != len(plan.columns):
                    continue
                n_rows += 1
                labels[cells[0]] += 1
                for name, conf in feature_conf.items():
                    cell = cells[col[name]]
                    if conf["type"] == "continuous":
                        if cell in ("-", ""):
                            missing_cont[name] += 1
                        continue
                    values = (cell.split(",") if plan.multivalue
                              and "," in cell else [cell])
                    if conf.get("max_len", 1) > 1:
                        value_counts[name].append(len(values))
                    if conf["transform"] == "vocab":
                        for v in values:
                            seen[name] += 1
                            if v not in vocab_maps[name]:
                                oov[name] += 1
                if n_rows >= args.max_rows:
                    break
        if n_rows >= args.max_rows:
            break

    print(f"rows analyzed: {n_rows}")
    total = sum(labels.values())
    for lab, c in sorted(labels.items()):
        print(f"label {lab}: {c} ({c / total:.2%})")

    print("\nmultivalue occupancy (suggests pack_budget):")
    p95s = []
    for name, counts in sorted(value_counts.items()):
        arr = np.array(counts)
        p95 = int(np.percentile(arr, 95))
        p95s.append(p95)
        print(f"  {name}: mean={arr.mean():.2f} p95={p95} max={arr.max()} "
              f"(static max_len={feature_conf[name]['max_len']})")
    if p95s:
        # single source of truth for the suggestion (what `pack_budget:
        # auto` resolves — features/analyze.py)
        from wide_deep_tpu_torch.features.analyze import suggest_pack_budget
        suggestion = suggest_pack_budget(plan, args.data,
                                         max_rows=args.max_rows)
        print(f"  -> suggested train.yaml pack_budget: {suggestion} "
              f"(current {plan.pack_budget}; set `pack_budget: auto` to "
              f"apply this automatically — features/analyze.py)")

    print("\nvocab OOV rates (dropped values):")
    for name in sorted(vocab_maps):
        if seen[name]:
            rate = oov[name] / seen[name]
            flag = "  <-- check vocab" if rate > 0.05 else ""
            print(f"  {name}: {rate:.2%}{flag}")

    if missing_cont:
        print("\ncontinuous missing ('-') rates:")
        for name, c in sorted(missing_cont.items()):
            print(f"  {name}: {c / n_rows:.2%}")

    print("\npool widths (device cost is linear in these):")
    print(f"  wide: {plan.wide_packed_len}")
    for g in plan.groups:
        print(f"  dim-{g.dim}: {plan.group_packed_len[g.dim]} "
              f"({len(g.slots)} slots)")


if __name__ == "__main__":
    main()
