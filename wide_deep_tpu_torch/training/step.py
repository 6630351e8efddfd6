"""The single-device train step (port of the single-device paths of
wide_deep_tpu/training/step.py, the deferred sparse update and its flush
included), and the eval and predict steps.

One step: forward + loss, gradients by autograd, the dense per-arm update
(optim.JointOptimizer), then the touched-rows update of each sparse table.
A sparse table whose batch carries its compact plan (``sopt_*``) is
gathered detached in the forward; the gradient reaches the gathered rows
(the "sinks", leaf tensors made by models/deep.py), which is the compact
per-entry gradient optim/sparse.apply_fused_update (fused tables) or
apply_compact_update (tables built unfused by hand) consumes with the plan.
An unfused table without a plan gets its dense gradient, which
apply_sparse_update reads at the batch's ids.  Params, BN state and
optimizer state are updated in place.

On a mesh of ranks (``model.mesh``, the sharded branch of JAX
training/step.py:150-175) the loss is this rank's share of the global
weighted mean, the replicated leaves' gradients are summed over every rank
(model ranks after the first add zeros, since their rows repeat the first's)
in one all-reduce per dtype, so every rank applies the same bits; the
row-sharded leaves' gradients come from the exchange's backward, already
the rank's shard's; and a sparse table whose batch carries per-shard
compact plans (``sopt_ok_*``) takes optim/sparse.apply_fused_sharded_update.
The loss returned is the global one, the same bits on every rank.

``defer_sparse`` moves the fused update one step later: a step first
applies the update the previous step left in ``opt_state
["sparse_pending"]`` and leaves its own there.  The forward sees the same
tables either way; ``flush_step`` applies what is pending, and must run
before an evaluation, a checkpoint or an export reads the tables.

The step's phases are spans (tracing.py), each timed on the batch's
device: ``train.forward``, ``train.backward`` (the mesh's gradient
all-reduce included) and ``train.update`` with its children
``train.update.dense`` and ``train.update.sparse`` (``defer_sparse``'s
pending update included, at the step's start).
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
    return {"dense": tx.init(params),
            "sparse": {name: sparse_lib.init_table_state(
                           t, tree_get(params, t.path))
                       for name, t in (sparse_tables or {}).items()}}


def _apply_pending(sparse_tables, params, opt_state) -> None:
    """Apply each fused table's pending update (``opt_state
    ["sparse_pending"][name]``: its gradient rows ``rg`` and plan)."""
    pending = opt_state["sparse_pending"]
    for name, t in sparse_tables.items():
        if not t.fused:
            raise ValueError(f"{name}: defer_sparse takes fused tables only")
        p = pending[name]
        sparse_lib.apply_fused_update(
            t, tree_get(params, t.path), p["rg"],
            {k: p[k] for k in PLAN_KEYS}, opt_state["sparse"][name])


def train_step(model: WideDeep, tx: JointOptimizer, params, mstate,
               opt_state, batch: Dict[str, torch.Tensor],
               sparse_tables: Optional[Dict[str, Any]] = None,
               rng: Optional[torch.Generator] = None,
               with_summaries: bool = False, defer_sparse: bool = False):
    """One training step -> (new BN state, loss), plus with
    ``with_summaries`` the per-layer activation stats {tag: scalar tensor}
    (zero fraction, mean, std); params and opt_state change in place.
    ``defer_sparse``: see the module docstring; ``opt_state`` must then
    hold ``sparse_pending``."""
    sparse_tables = sparse_tables or {}
    compact = {name: t for name, t in sparse_tables.items()
               if f"sopt_uids_{t.path[-1]}" in batch}
    for name, t in sparse_tables.items():
        if (t.fused or defer_sparse) and name not in compact:
            raise ValueError(f"{name}: fused tables need the batch's "
                             f"compact plan (sopt_*_{t.path[-1]})")
    dev = batch["label"].device
    if defer_sparse:
        with tracing.span("train.update", dev), \
                tracing.span("train.update.sparse", dev):
            _apply_pending(sparse_tables, params, opt_state)
    # unfused tables without a plan take their dense gradient
    sink_paths = {t.path for t in compact.values()}
    leaves = [(p, t) for p, t in tree_items(params) if p not in sink_paths]
    for _, t in leaves:
        t.requires_grad_(True)
    sinks: Dict[str, Optional[torch.Tensor]] = {
        t.path[-1]: None for t in compact.values()}
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
            _update_tables(sparse_tables, compact, params, opt_state, batch,
                           dense_grads, sink_grads, mesh, defer_sparse)
    if with_summaries:
        return new_mstate, loss.detach(), aux[3]
    return new_mstate, loss.detach()


def _update_tables(sparse_tables, compact, params, opt_state, batch,
                   dense_grads, sink_grads, mesh, defer_sparse) -> None:
    """The touched-rows update of each sparse table, in place; under
    ``defer_sparse``, this step's update left pending instead."""
    if defer_sparse:
        # this step's update waits for the next step; its plan is cloned,
        # since the batch's device buffer is handed out again
        opt_state["sparse_pending"] = {
            name: {"rg": sink_grads[t.path[-1]],
                   **{k: batch[f"sopt_{k}_{t.path[-1]}"].clone()
                      for k in PLAN_KEYS}}
            for name, t in sparse_tables.items()}
        return
    for name, t in sparse_tables.items():
        key = t.path[-1]
        param = tree_get(params, t.path)
        st = opt_state["sparse"][name]
        if name in compact and f"sopt_ok_{key}" in batch:
            from wide_deep_tpu_torch.models.deep import plan_row
            if not t.fused or mesh is None:
                raise ValueError(f"{name}: per-shard compact plans need a "
                                 f"fused table and a model on a mesh")
            sparse_lib.apply_fused_sharded_update(
                t, param, sink_grads[key], batch[t.ids_key],
                plan_row(batch, "sopt", t.dim), st, mesh)
        elif name in compact:
            plan = {k: batch[f"sopt_{k}_{key}"] for k in PLAN_KEYS}
            apply = (sparse_lib.apply_fused_update if t.fused
                     else sparse_lib.apply_compact_update)
            apply(t, param, sink_grads[key], plan, st)
        else:
            sparse_lib.apply_sparse_update(t, param, dense_grads[t.path],
                                           batch[t.ids_key], st)


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


def seed_pending(sparse_tables: Dict[str, Any], opt_state,
                 batch: Dict[str, torch.Tensor]) -> None:
    """Start a ``defer_sparse`` run: for each fused table a pending update
    of ``batch``'s plan with zero gradients, and its count one lower (-1
    from a fresh initialisation), since applying the seed ticks it; step k's
    gradients then apply at the count an immediate run applies them at."""
    opt_state["sparse_pending"] = {}
    for name, t in sparse_tables.items():
        key = t.path[-1]
        opt_state["sparse"][name]["count"] -= 1
        opt_state["sparse_pending"][name] = {
            "rg": torch.zeros((batch[t.ids_key].numel(), t.dim),
                              dtype=t.sink_dtype,
                              device=batch[t.ids_key].device),
            **{k: batch[f"sopt_{k}_{key}"].clone() for k in PLAN_KEYS}}


@torch.no_grad()
def flush_step(sparse_tables: Dict[str, Any], params, opt_state) -> None:
    """Apply the pending fused updates of a ``defer_sparse`` run, in place,
    so the tables hold every step trained.  The pending entries keep their
    plans with zero gradients: a later step's apply of them leaves the
    weights as they are (it still ticks each table's count)."""
    _apply_pending(sparse_tables, params, opt_state)
    for p in opt_state["sparse_pending"].values():
        p["rg"] = torch.zeros_like(p["rg"])


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
