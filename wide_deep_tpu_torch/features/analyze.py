"""Dataset statistics feeding FeaturePlan decisions, and the record of the
plan decisions a model trained with (the port's copy of the JAX package's
``features/analyze.py``).

Device step cost is linear in the packed id-pool widths, and pool width is
pack_budget x the number of multivalue slots.  ``pack_budget: auto`` in
train.yaml scans the training data and uses the 95th-percentile value count.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Optional

import numpy as np

log = logging.getLogger("wide_deep_tpu_torch")

DEFAULT_BUDGET = 3  # fallback when no multivalue data is visible


def multivalue_occupancy(plan, data_path: str, max_rows: int = 20000):
    """-> {feature: np.array of per-row value counts} over the first
    ``max_rows`` well-formed rows (multivalue features only)."""
    from wide_deep_tpu_torch.features.pipeline import list_files

    counts = {name: [] for name, conf in plan.feature_conf.items()
              if conf["type"] == "category" and conf.get("max_len", 1) > 1}
    if not counts or not plan.multivalue:
        return {}
    col = plan.column_index
    n_cols = len(plan.columns)
    n_rows = 0
    for path in list_files(data_path):
        with open(path, errors="replace") as f:
            for line in f:
                cells = line.rstrip("\n").split("\t")
                if len(cells) != n_cols:
                    continue
                n_rows += 1
                for name, acc in counts.items():
                    cell = cells[col[name]]
                    acc.append(cell.count(",") + 1 if cell not in ("-", "")
                               else 1)
                if n_rows >= max_rows:
                    break
        if n_rows >= max_rows:
            break
    return {k: np.asarray(v) for k, v in counts.items() if v}


def suggest_pack_budget(plan, data_path: str, max_rows: int = 20000,
                        percentile: float = 95.0) -> int:
    """p95 of per-row multivalue counts, the measured-occupancy pool size."""
    occ = multivalue_occupancy(plan, data_path, max_rows)
    if not occ:
        return DEFAULT_BUDGET
    p95s = [int(np.percentile(arr, percentile)) for arr in occ.values()]
    max_len = max(plan.feature_conf[n].get("max_len", 1) for n in occ)
    return int(np.clip(max(p95s), 1, max_len))


def resolve_pack_budget(config, train_data: Optional[str] = None,
                        raw=None) -> Optional[int]:
    """train.yaml ``pack_budget`` -> int | None (None = plan default).

    ``auto`` scans ``train_data`` (or the configured train_data) and logs
    the choice; a missing dataset falls back to the default with a warning.
    ``raw`` overrides the configured value (Trainer CLI overrides).
    """
    if raw is None:
        raw = config.train.get("pack_budget")
    if raw in (None, ""):
        return None
    if str(raw).lower() != "auto":
        return int(raw)
    from wide_deep_tpu_torch.features.plan import FeaturePlan
    probe = FeaturePlan(config, fold=False, pack_budget=DEFAULT_BUDGET)
    path = train_data or config.train.get("train_data")
    if not path:
        log.warning("pack_budget: auto requested but no train_data is "
                    "configured; using default %d", DEFAULT_BUDGET)
        return DEFAULT_BUDGET
    try:
        budget = suggest_pack_budget(probe, path)
    except (OSError, FileNotFoundError) as e:
        log.warning("pack_budget: auto requested but %s unreadable (%s); "
                    "using default %d", path, e, DEFAULT_BUDGET)
        return DEFAULT_BUDGET
    log.info("pack_budget: auto -> %d (p95 occupancy of %s)", budget, path)
    return budget


# ------------------------------------------------- train-time persistence
PLAN_META_FILE = "plan_meta.json"


def save_plan_meta(model_dir: str, plan) -> None:
    """Record the plan decisions resolved at training time (pack_budget,
    fold, multivalue) next to the checkpoints, so export re-uses the values
    the model trained with instead of re-deriving them from whatever data is
    visible at export time (train/serve feature-skew guard)."""
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, PLAN_META_FILE), "w") as f:
        json.dump({"pack_budget": plan.pack_budget, "fold": plan.fold,
                   "multivalue": plan.multivalue}, f)


def load_plan_meta(model_dir: str):
    """-> dict, or None where the model dir has no record."""
    path = os.path.join(model_dir, PLAN_META_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)
