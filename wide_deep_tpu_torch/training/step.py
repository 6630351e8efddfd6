"""The single-device train step (port of the single-device paths of
wide_deep_tpu/training/step.py), and the eval and predict steps.

One step: forward + loss, gradients by autograd, the dense per-arm update
(optim.JointOptimizer), then the touched-rows update of each sparse table.
Every sparse table is fused (optim/sparse.plan_sparse_tables) and its
batch must carry its compact plan (``sopt_*``).  The table is gathered
detached in the forward; the gradient reaches the gathered rows (the
"sinks", leaf tensors made by models/deep.py), which is the compact
per-entry gradient optim/sparse.apply_fused_update consumes with the
plan.  Params, BN state and optimizer state are updated in place.

On a mesh of ranks (``model.mesh``, the sharded branch of JAX
training/step.py:150-175) the loss is this rank's share of the global
weighted mean, the replicated leaves' gradients are summed over every rank
(model ranks after the first add zeros, since their rows repeat the first's)
in one all-reduce per dtype, so every rank applies the same bits; the
row-sharded leaves' gradients come from the exchange's backward, already
the rank's shard's; and a sparse table whose batch carries per-shard
compact plans (``sopt_ok_*``) takes optim/sparse.apply_fused_sharded_update.
The loss returned is the global one, the same bits on every rank.

The step's phases are spans (tracing.py), each timed on the batch's
device: ``train.forward``, ``train.backward`` (the mesh's gradient
all-reduce included) and ``train.update`` with its children
``train.update.dense`` and ``train.update.sparse``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from wide_deep_tpu_torch import metrics as metrics_lib
from wide_deep_tpu_torch import tracing
from wide_deep_tpu_torch.models.joint import WideDeep
from wide_deep_tpu_torch.optim import JointOptimizer, tree_get, tree_items
from wide_deep_tpu_torch.optim import sparse as sparse_lib
from wide_deep_tpu_torch.optim.sparse import PLAN_KEYS


def init_opt_state(tx: JointOptimizer, params,
                   sparse_tables: Optional[Dict[str, Any]] = None):
    """The dense optimizer's state, and each sparse table's step count (a
    fused table's slots live in its param matrix)."""
    return {"dense": tx.init(params),
            "sparse": {name: {"count": 0} for name in sparse_tables or {}}}


def train_step(model: WideDeep, tx: JointOptimizer, params, mstate,
               opt_state, batch: Dict[str, torch.Tensor],
               sparse_tables: Optional[Dict[str, Any]] = None,
               rng: Optional[torch.Generator] = None,
               with_summaries: bool = False):
    """One training step -> (new BN state, loss), plus with
    ``with_summaries`` the per-layer activation stats {tag: scalar tensor}
    (zero fraction, mean, std); params and opt_state change in place."""
    sparse_tables = sparse_tables or {}
    for name, t in sparse_tables.items():
        if f"sopt_uids_{t.path[-1]}" not in batch:
            raise ValueError(f"{name}: sparse tables need the batch's "
                             f"compact plan (sopt_*_{t.path[-1]})")
    dev = batch["label"].device
    table_paths = {t.path for t in sparse_tables.values()}
    leaves = [(p, t) for p, t in tree_items(params) if p not in table_paths]
    for _, t in leaves:
        t.requires_grad_(True)
    sinks: Dict[str, Optional[torch.Tensor]] = {
        t.path[-1]: None for t in sparse_tables.values()}
    with tracing.span("train.forward", dev):
        loss, aux = model.loss_fn(
            params, mstate, batch, True, rng,
            sinks=sinks if sinks else None,
            collect_summaries=with_summaries)
    new_mstate = aux[0]
    sink_items = sorted(sinks.items())
    mesh = model.mesh
    with tracing.span("train.backward", dev):
        grads = torch.autograd.grad(
            loss, [t for _, t in leaves] + [s for _, s in sink_items],
            allow_unused=True)
        dense_grads = {p: (g if g is not None else torch.zeros_like(t))
                       for (p, t), g in zip(leaves, grads)}
        if mesh is not None:
            _sum_replicated_grads(dense_grads, model.sharded_paths, mesh)
            loss = _global_loss(loss.detach(), mesh)
    sink_grads = dict(zip((k for k, _ in sink_items), grads[len(leaves):]))
    with tracing.span("train.update", dev):
        with tracing.span("train.update.dense", dev):
            tx.update_(params, dense_grads, opt_state["dense"])
        with tracing.span("train.update.sparse", dev):
            _update_tables(sparse_tables, params, opt_state, batch,
                           sink_grads, mesh)
    if with_summaries:
        return new_mstate, loss.detach(), aux[3]
    return new_mstate, loss.detach()


def _update_tables(sparse_tables, params, opt_state, batch, sink_grads,
                   mesh) -> None:
    """The touched-rows update of each sparse table, in place."""
    # the plans' distinct rows: read when the Trainer made the batch
    # (TensorBatch), else from its plans
    lives = getattr(batch, "compact_live", None)
    if lives is None and sparse_tables:
        lives = sparse_lib.compact_live(batch)
    for name, t in sparse_tables.items():
        key = t.path[-1]
        param = tree_get(params, t.path)
        st = opt_state["sparse"][name]
        if f"sopt_ok_{key}" in batch:
            from wide_deep_tpu_torch.models.deep import plan_row
            if mesh is None:
                raise ValueError(f"{name}: per-shard compact plans need a "
                                 f"model on a mesh")
            sparse_lib.apply_fused_sharded_update(
                t, param, sink_grads[key], batch[t.ids_key],
                plan_row(batch, "sopt", t.dim), st, mesh)
        else:
            plan = {k: batch[f"sopt_{k}_{key}"] for k in PLAN_KEYS}
            plan["live"] = lives[key]
            sparse_lib.apply_fused_update(t, param, sink_grads[key], plan,
                                          st)


def _sum_replicated_grads(grads: Dict[Any, torch.Tensor],
                          sharded_paths, mesh) -> None:
    """In place: each replicated leaf's gradient summed over every rank,
    one all-reduce per dtype over a flat buffer; ranks past the first of
    their model group add zeros (their rows, and so their gradients,
    repeat the first's)."""
    from wide_deep_tpu_torch.parallel import mesh as mesh_lib
    by_dtype: Dict[torch.dtype, list] = {}
    for p, g in grads.items():
        if p not in sharded_paths:
            by_dtype.setdefault(g.dtype, []).append(p)
    for dtype, paths in by_dtype.items():
        flat = torch.cat([grads[p].reshape(-1) for p in paths])
        if mesh.model_idx:
            flat = torch.zeros_like(flat)
        flat = mesh_lib.all_reduce(flat, None, "grads")
        at = 0
        for p in paths:
            n = grads[p].numel()
            grads[p] = flat[at:at + n].view(grads[p].shape)
            at += n


def _global_loss(loss: torch.Tensor, mesh) -> torch.Tensor:
    """The global batch's loss from each rank's share, the same bits on
    every rank."""
    from wide_deep_tpu_torch.parallel import mesh as mesh_lib
    share = loss.reshape(1) if mesh.model_idx == 0 else torch.zeros(
        1, dtype=loss.dtype, device=loss.device)
    return mesh_lib.all_reduce(share, None, "loss")[0]


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
