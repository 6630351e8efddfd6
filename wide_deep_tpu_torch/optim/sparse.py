"""Touched-rows optimizer updates for huge embedding tables (port of
wide_deep_tpu/optim/sparse.py's single-device paths).

Eligible tables (``plan.sparse_opt_group``: unfolded groups of at least
SPARSE_MIN_ROWS rows; production: the 10,000,128-row d32 table) store the
param and its optimizer slots side by side in one float32 [rows, 128]
matrix: param in columns [0, dim), the Adagrad accumulator in [dim, 2*dim)
initialised to 0.1, zero padding after.  They are left out of the dense
optimizer.  Each step, per table (``apply_fused_update``):

1. K1 (ops/scatter.range_scatter_add) sums the per-entry gradients of the
   gathered rows into one float32 row per unique id, by the batch's compact
   plan (``sopt_*``);
2. the touched rows are gathered (sentinel uids clipped), the row formula
   runs on them;
3. K3 (ops/rowdma.rowdma_scatter_rows) writes them back in place, skipping
   the sentinels.

Untouched rows are never read or written (reference SparseApply* semantics).

Tables built by hand with ``fused=False`` keep the param in its own
layout and the optimizer slots in their state (``init_table_state``):
``apply_compact_update`` takes the same compact per-entry gradient and
plan (K1 sums it, the formula runs on the gathered rows, the changes are
added back at the sorted unique uids), ``apply_sparse_update`` a dense
per-row-summed gradient and the raw batch ids.  ``plan_sparse_tables``
makes fused tables only, as the JAX package's does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch

from wide_deep_tpu_torch.optim import (Schedule, _on, _rsqrt, _sqrt,
                                      exponential_decay, tree_get, tree_set)

# the compact plan's keys (ops/scatter.make_compact_plan) a sparse update
# takes: the batch carries each as ``sopt_<key>_d<dim>``
PLAN_KEYS = ("uids", "ids", "perm", "tiles")

SPARSE_MIN_ROWS = 1 << 22      # smaller tables sweep densely
SPARSE_CAPABLE = ("Adagrad", "ProximalAdagrad", "Ftrl", "SGD")
_SLOT_KEYS = ("accum", "linear")


@dataclasses.dataclass(frozen=True)
class SparseTable:
    """One sparsely-updated table: param location + batch id source."""

    name: str                      # state key, e.g. "dnn.embed.d32"
    path: Tuple[Any, ...]          # param tree path ("dnn", "embed", "d32")
    ids_key: str                   # batch key holding [B, P] ids
    spec: Dict[str, Any]           # optimizer spec
    lr: Union[Schedule, float]     # a schedule, or a constant rate
    dim: int = 0                   # embedding columns
    fused: bool = False            # param stored as float32 [rows, 128]
    sink_dtype: Any = None         # dtype of the gathered-rows gradient


def _lr_at(lr, count: int) -> torch.Tensor:
    return (lr(count) if callable(lr)
            else torch.tensor(lr, dtype=torch.float32))


def _n_slots(spec: Dict[str, Any]) -> int:
    return {"SGD": 0, "Adagrad": 1, "ProximalAdagrad": 1, "Ftrl": 2}[
        spec["name"]]


def fused_layout(spec: Dict[str, Any], dim: int) -> Dict[str, int]:
    """Column offsets of the optimizer slots inside a fused table."""
    names = _SLOT_KEYS[:_n_slots(spec)]
    return {k: (i + 1) * dim for i, k in enumerate(names)}


def plan_sparse_tables(plan, model_conf, decay_steps: float, batch_size: int,
                       enabled: bool = True
                       ) -> Tuple[Dict[str, SparseTable], frozenset]:
    """Tables the fused optimizer owns -> ({name: SparseTable}, paths).
    Derived from ``plan.sparse_opt_group``, the predicate that also picks
    the fused param layout, so routing and shapes cannot drift."""
    spec = model_conf["dnn_optimizer"]
    if not enabled or spec["name"] not in SPARSE_CAPABLE:
        return {}, frozenset()
    from wide_deep_tpu_torch.models.deep import DTYPES
    lr0 = spec.get("learning_rate", model_conf["dnn_initial_learning_rate"])
    schedule = exponential_decay(
        lr0, model_conf.get("dnn_decay_rate", 1.0), decay_steps)
    sink_dtype = DTYPES[model_conf.get("embedding_dtype") or "float32"]
    out: Dict[str, SparseTable] = {}
    for g in plan.groups:
        if plan.sparse_opt_group(g, batch_size):
            name = f"dnn.embed.d{g.dim}"
            out[name] = SparseTable(
                name=name, path=("dnn", "embed", f"d{g.dim}"),
                ids_key=f"emb_ids_d{g.dim}", spec=spec, lr=schedule,
                dim=g.dim, fused=True, sink_dtype=sink_dtype)
    return out, frozenset(t.path for t in out.values())


def fused_live_width(spec: Dict[str, Any], dim: int) -> int:
    """Columns of a fused [rows, FUSED_WIDTH] table that carry data (param
    + optimizer slots); the columns past them are zero padding to the row
    width K3 writes (ops/rowdma.py)."""
    return (1 + _n_slots(spec)) * dim


def compact_fused_ckpt(params, sparse_tables: Dict[str, SparseTable]):
    """Checkpoint view of ``params``: fused tables as views of their live
    column block.  The padding columns are zero by construction (init makes
    them zero and apply_fused_update writes them back unchanged), so
    leaving them out halves the d32 table's checkpoint (5.12 -> 2.56 GB at
    production shapes, Adagrad) with an exact resume.  The views share the
    live tables' storage: a restore into them writes the live tables."""
    for t in (sparse_tables or {}).values():
        if not t.fused:
            continue
        p = tree_get(params, t.path)
        used = fused_live_width(t.spec, t.dim)
        if p.shape[1] > used:
            params = tree_set(params, t.path, p[:, :used])
    return params


@torch.no_grad()
def expand_fused_ckpt(params, sparse_tables: Dict[str, SparseTable], like):
    """Inverse of compact_fused_ckpt, in place: each restored fused table
    is written into the live table of ``like`` at its path (unless it is a
    view of it already) and the live table's padding columns are zeroed;
    the result holds the live tables.  A table already at full width
    passes through unchanged."""
    for t in (sparse_tables or {}).values():
        if not t.fused:
            continue
        target = tree_get(like, t.path)
        p = tree_get(params, t.path)
        if p.shape == target.shape:
            continue
        used = p.shape[1]
        if p.data_ptr() != target.data_ptr():
            target[:, :used].copy_(p)
        target[:, used:].zero_()
        params = tree_set(params, t.path, target)
    return params


def init_table_state(table: SparseTable,
                     param: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """A table's optimizer state: its step count, and for a table that is
    not fused its slots, as the dense optimizers make them (``accum`` at
    the initial accumulator value, ``linear`` zero, in the param's dtype).
    A fused table's slots live in its param matrix."""
    st: Dict[str, Any] = {"count": 0}
    if table.fused:
        return st
    name = table.spec["name"]
    if name in ("Adagrad", "ProximalAdagrad", "Ftrl"):
        st["accum"] = torch.full_like(
            param, table.spec.get("initial_accumulator_value", 0.1))
    if name == "Ftrl":
        st["linear"] = torch.zeros_like(param)
    return st


@torch.no_grad()
def init_fused_params(params, sparse_tables: Dict[str, SparseTable]):
    """Set the slot column blocks of fused tables to their init values
    (the model creates them zero), in place."""
    for t in (sparse_tables or {}).values():
        p = tree_get(params, t.path)
        for key, off in fused_layout(t.spec, t.dim).items():
            val = (t.spec.get("initial_accumulator_value", 0.1)
                   if key == "accum" else 0.0)
            if val:
                p[:, off:off + t.dim] = val
    return params


def _row_update(spec: Dict[str, Any], lr, w: torch.Tensor, g: torch.Tensor,
                slots: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One optimizer step on float32 row slices: (w, g, slots) -> (w',
    slots'), the formulas of the dense optimizers, with their roots and
    divisions (``_sqrt``, ``_rsqrt``, ``_on``), so the card's rows get
    the host's bits."""
    name = spec["name"]
    new_slots: Dict[str, torch.Tensor] = {}
    if name == "SGD":
        w_new = w - lr * g
    elif name == "Adagrad":
        n2 = slots["accum"] + g * g
        w_new = w - lr * g * _rsqrt(n2 + 1e-7)
        new_slots["accum"] = n2
    elif name == "ProximalAdagrad":
        l1 = spec.get("l1_regularization_strength", 0.0)
        l2 = spec.get("l2_regularization_strength", 0.0)
        n2 = slots["accum"] + g * g
        adj = lr * _rsqrt(n2)
        prox = w - adj * g
        w_new = (torch.sign(prox)
                 * torch.clamp(torch.abs(prox) - adj * l1, min=0.0)
                 / (1.0 + adj * l2))
        # rows whose gradient is exactly zero (pool padding) keep their
        # weights: the proximal shrink is not a zero-gradient fixed point
        w_new = torch.where(torch.all(g == 0.0, dim=-1, keepdim=True),
                            w, w_new)
        new_slots["accum"] = n2
    elif name == "Ftrl":
        l1 = spec.get("l1_regularization_strength", 0.0)
        l2 = spec.get("l2_regularization_strength", 0.0)
        lr = _on(lr, w)
        n = slots["accum"]
        n2 = n + g * g
        root_n2 = _sqrt(n2)
        z2 = slots["linear"] + g - (root_n2 - _sqrt(n)) / lr * w
        w_new = torch.where(torch.abs(z2) <= l1, torch.zeros_like(w),
                            (torch.sign(z2) * l1 - z2)
                            / (root_n2 / lr + 2 * l2))
        new_slots["accum"] = n2
        new_slots["linear"] = z2
    else:
        raise ValueError(f"no sparse formula for {name}")
    return w_new, new_slots


@torch.no_grad()
def apply_fused_update(table: SparseTable, fused: torch.Tensor,
                       row_grads: torch.Tensor,
                       plan: Dict[str, torch.Tensor],
                       state: Dict[str, Any]) -> torch.Tensor:
    """Touched-rows update of a fused [rows, 128] table, in place.

    ``row_grads`` [N, dim] is the gradient of the rows the forward gathered
    (one per pool entry); ``plan`` the batch's compact plan {uids, ids,
    perm, tiles}.  K1 sums duplicates into one float32 row per unique id,
    the formula runs on the gathered rows, K3 writes them back; padding
    columns are written back unchanged."""
    from wide_deep_tpu_torch.ops.rowdma import rowdma_scatter_rows
    from wide_deep_tpu_torch.ops.scatter import range_scatter_add
    lr = _lr_at(table.lr, state["count"])
    n, d = row_grads.shape
    g_unique = range_scatter_add(plan["ids"], plan["perm"],
                                 row_grads.float().contiguous(),
                                 plan["tiles"], n, torch.float32)
    uids = plan["uids"]
    safe = torch.clamp(uids, 0, fused.shape[0] - 1)
    full = fused.index_select(0, safe)
    layout = fused_layout(table.spec, d)
    w = full[:, :d]
    slots = {k: full[:, off:off + d] for k, off in layout.items()}
    w_new, new_rows = _row_update(table.spec, lr, w, g_unique, slots)
    used = (1 + len(layout)) * d
    new_full = torch.cat(
        [w_new] + [new_rows[k] for k in _SLOT_KEYS if k in new_rows]
        + [full[:, used:]], dim=1).contiguous()
    rowdma_scatter_rows(fused, uids, new_full)
    state["count"] += 1
    return fused


@torch.no_grad()
def apply_fused_sharded_update(table: SparseTable, fused: torch.Tensor,
                               row_grads: torch.Tensor, ids: torch.Tensor,
                               plan: Dict[str, Any], state: Dict[str, Any],
                               mesh) -> torch.Tensor:
    """Touched-rows update of this rank's row shard of a fused table, in
    place (JAX optim/sparse.py:433-552).  ``row_grads`` [N_local, dim] is
    the rank's compact per-entry gradient, ``ids`` its batch ids, ``plan``
    its row of the batch's per-shard compact plan {uids, ids, perm, tiles}
    plus the host ints ``ok`` and ``live``.  The cotangent and the ids are
    all-gathered over 'data' first, before any branch; then K1 sums the
    shard's ``live`` entries into the compact space (rows = cap, uids
    local to the shard), the unique rows are gathered from the shard, the
    row formula (``_row_update``) runs and K3 writes them back into the
    shard.  A shard whose stream overflowed the plan's cap (``ok`` 0)
    takes the exact path: the shard's entries summed per row
    (parallel/exchange.exact_shard_sum), every touched row updated and
    written back with ``index_copy_`` (duplicates write the same
    values)."""
    from wide_deep_tpu_torch.ops.rowdma import rowdma_scatter_rows
    from wide_deep_tpu_torch.ops.scatter import range_scatter_add
    from wide_deep_tpu_torch.parallel import exchange
    from wide_deep_tpu_torch.parallel import mesh as mesh_lib
    lr = _lr_at(table.lr, state["count"])
    d = row_grads.shape[1]
    shard_rows = fused.shape[0]
    g_all = mesh_lib.all_gather(row_grads.float().contiguous(),
                                mesh.data_group, "sparse_update")
    ids_all = mesh_lib.all_gather(ids.reshape(-1).int().contiguous(),
                                  mesh.data_group, "sparse_update")
    layout = fused_layout(table.spec, d)
    used = (1 + len(layout)) * d

    def formula(full, g):
        w = full[:, :d]
        slots = {k: full[:, off:off + d] for k, off in layout.items()}
        w_new, new_rows = _row_update(table.spec, lr, w, g, slots)
        return torch.cat(
            [w_new] + [new_rows[k] for k in _SLOT_KEYS if k in new_rows]
            + [full[:, used:]], dim=1).contiguous()

    if int(plan["ok"]):
        cap = plan["ids"].shape[-1]
        live = int(plan["live"])
        g_unique = range_scatter_add(plan["ids"][:live], plan["perm"][:live],
                                     g_all, plan["tiles"], cap,
                                     torch.float32)
        uids = plan["uids"]
        full = fused.index_select(0, torch.clamp(uids, 0, shard_rows - 1))
        rowdma_scatter_rows(fused, uids, formula(full, g_unique))
    else:
        local = ids_all.long() - mesh.shard * shard_rows
        g_dense = exchange.exact_shard_sum(local, g_all, shard_rows,
                                           torch.float32)
        mine = local[(local >= 0) & (local < shard_rows)]
        full = fused.index_select(0, mine)
        fused.index_copy_(0, mine, formula(full, g_dense.index_select(
            0, mine)))
    state["count"] += 1
    return fused


@torch.no_grad()
def apply_sparse_update(table: SparseTable, param: torch.Tensor,
                        grad: torch.Tensor, ids: torch.Tensor,
                        state: Dict[str, Any]) -> torch.Tensor:
    """Touched-rows update of a table that is not fused, in place, from its
    dense gradient ``grad`` (already summed per row) and the raw batch
    ``ids`` (duplicates allowed: each duplicate computes the same new
    values, so the writes agree)."""
    lr = _lr_at(table.lr, state["count"])
    ids = ids.reshape(-1).long()
    g = grad.index_select(0, ids).float()
    w = param.index_select(0, ids).float()
    slots = {k: state[k].index_select(0, ids).float()
             for k in _SLOT_KEYS if k in state}
    w_new, new_rows = _row_update(table.spec, lr, w, g, slots)
    for k, rows in new_rows.items():
        state[k].index_copy_(0, ids, rows.to(state[k].dtype))
    param.index_copy_(0, ids, w_new.to(param.dtype))
    state["count"] += 1
    return param


@torch.no_grad()
def apply_compact_update(table: SparseTable, param: torch.Tensor,
                         row_grads: torch.Tensor,
                         plan: Dict[str, torch.Tensor],
                         state: Dict[str, Any]) -> torch.Tensor:
    """Touched-rows update of a table that is not fused, in place, from the
    compact per-entry gradient ``row_grads`` [N, D] and the batch's compact
    plan: K1 (ops/scatter.range_scatter_add) sums duplicates into one
    float32 row per unique id, the formula runs on the gathered rows, and
    each row's change (new - old, in the slot's or param's dtype) is added
    back at the sorted unique uids, as the JAX package writes it.  The
    sentinel uids past the table's rows are dropped."""
    from wide_deep_tpu_torch.ops.scatter import range_scatter_add
    lr = _lr_at(table.lr, state["count"])
    n, d = row_grads.shape
    g_unique = range_scatter_add(plan["ids"], plan["perm"],
                                 row_grads.float().contiguous(),
                                 plan["tiles"], n, torch.float32)
    uids = plan["uids"]
    rows = param.shape[0]
    safe = torch.clamp(uids, 0, rows - 1).long()
    w = param.index_select(0, safe).float()
    slots = {k: state[k].index_select(0, safe).float()
             for k in _SLOT_KEYS if k in state}
    w_new, new_rows = _row_update(table.spec, lr, w, g_unique, slots)
    live = (uids >= 0) & (uids < rows)
    at = safe[live]
    for k, vals in new_rows.items():
        state[k].index_add_(0, at, (vals - slots[k]).to(
            state[k].dtype)[live])
    param.index_add_(0, at, (w_new - w).to(param.dtype)[live])
    state["count"] += 1
    return param
