"""The single-device train step (port of the non-deferred single-device
path of wide_deep_tpu/training/step.py), and the eval and predict steps.

One step: forward + loss, gradients by autograd, the dense per-arm update
(FTRL for ``linear`` including the fold columns, Adagrad for ``dnn``), then
the fused touched-rows update of each sparse table.  Sparse tables are
gathered detached in the forward; the gradient reaches the gathered rows
(the "sinks", leaf tensors made by models/deep.py), which is the compact
per-entry gradient optim/sparse.apply_fused_update consumes with the batch's
``sopt_*`` plan.  Params, BN state and optimizer state are updated in place.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from wide_deep_tpu_torch import metrics as metrics_lib
from wide_deep_tpu_torch.models.joint import WideDeep
from wide_deep_tpu_torch.optim import JointOptimizer, tree_get, tree_items
from wide_deep_tpu_torch.optim import sparse as sparse_lib


def init_opt_state(tx: JointOptimizer, params,
                   sparse_tables: Optional[Dict[str, Any]] = None):
    return {"dense": tx.init(params),
            "sparse": {name: sparse_lib.init_table_state(t)
                       for name, t in (sparse_tables or {}).items()}}


def train_step(model: WideDeep, tx: JointOptimizer, params, mstate,
               opt_state, batch: Dict[str, torch.Tensor],
               sparse_tables: Optional[Dict[str, Any]] = None,
               rng: Optional[torch.Generator] = None,
               with_summaries: bool = False):
    """One training step -> (new BN state, loss), plus with
    ``with_summaries`` the per-layer activation stats {tag: scalar tensor}
    (zero fraction, mean, std); params and opt_state change in place."""
    sparse_tables = sparse_tables or {}
    sparse_paths = {t.path for t in sparse_tables.values()}
    leaves = [(p, t) for p, t in tree_items(params) if p not in sparse_paths]
    for _, t in leaves:
        t.requires_grad_(True)
    for t in sparse_tables.values():
        if f"sopt_uids_{t.path[-1]}" not in batch:
            raise ValueError(f"{t.name}: fused tables need the batch's "
                             f"compact plan (sopt_*_{t.path[-1]})")
    sinks: Dict[str, torch.Tensor] = {}
    loss, aux = model.loss_fn(
        params, mstate, batch, True, rng, sinks=sinks if sparse_tables
        else None, collect_summaries=with_summaries)
    new_mstate = aux[0]
    sink_items = sorted(sinks.items())
    grads = torch.autograd.grad(
        loss, [t for _, t in leaves] + [s for _, s in sink_items],
        allow_unused=True)
    dense_grads = {p: (g if g is not None else torch.zeros_like(t))
                   for (p, t), g in zip(leaves, grads)}
    sink_grads = dict(zip((k for k, _ in sink_items), grads[len(leaves):]))
    tx.update_(params, dense_grads, opt_state["dense"])
    for name, t in sparse_tables.items():
        key = t.path[-1]
        rg = sink_grads[key]
        plan = {k: batch[f"sopt_{k}_{key}"]
                for k in ("uids", "ids", "perm", "tiles")}
        sparse_lib.apply_fused_update(t, tree_get(params, t.path), rg,
                                      plan, opt_state["sparse"][name])
    if with_summaries:
        return new_mstate, loss.detach(), aux[3]
    return new_mstate, loss.detach()


@torch.no_grad()
def eval_step(model: WideDeep, params, mstate,
              batch: Dict[str, torch.Tensor], acc):
    """Fold one eval batch into the metric accumulators (metrics.py)."""
    _, (_, per_ex, preds) = model.loss_fn(params, mstate, batch,
                                          training=False)
    if model.n_classes == 2:
        probs = preds["logistic"]
        correct = None                  # (p >= 0.5) == label
    else:
        # multiclass: accuracy from argmax(probabilities) == label; probs
        # feeds only the threshold metrics, which finalize drops
        probs = preds["probabilities"].max(dim=-1).values
        correct = preds["class_ids"] == batch["label"].to(torch.int32)
    w = batch["weight"] * batch["mask"]
    return metrics_lib.update_metrics(acc, probs, batch["label"], w, per_ex,
                                      correct=correct)


@torch.no_grad()
def predict_step(model: WideDeep, params, mstate,
                 batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return model.predict(params, mstate, batch)
