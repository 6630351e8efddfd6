"""Touched-rows optimizer updates for huge embedding tables (port of
wide_deep_tpu/optim/sparse.py's single-device paths).

Eligible tables (``plan.sparse_opt_group``: unfolded groups of at least
SPARSE_MIN_ROWS rows; production: the 10,000,128-row d32 table) store the
param and its optimizer slots side by side in one float32 [rows, width]
matrix: param in columns [0, dim), the Adagrad accumulator in [dim, 2*dim)
initialised to 0.1, zero padding after.  The width is the table's own
(``fused_width``): 128 for every rule whose live columns fit 128, and for
RowwiseAdagrad (one accumulator column a row, after the param) its live
columns rounded up to whole float4s (a d128 table: 129 -> 132).  The
table's rule is model.yaml's ``dnn_embedding_optimizer`` where set, else
``dnn_optimizer`` (``table_spec``).  They are left out of the dense
optimizer.  Each step, per table (``apply_fused_update``):

1. K1 (ops/scatter.range_scatter_add) sums the per-entry gradients of the
   gathered rows into one float32 row per unique id, by the batch's compact
   plan (``sopt_*``);
2. the touched rows are gathered (sentinel uids clipped), the row formula
   runs on them;
3. K3 (ops/rowdma.rowdma_scatter_rows) writes them back in place, skipping
   the sentinels.

Untouched rows are never read or written (reference SparseApply* semantics).
``plan_sparse_tables`` makes every sparse table the step updates.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch

from wide_deep_tpu_torch import tracing
from wide_deep_tpu_torch.optim import (Schedule, _on, _rsqrt, _sqrt,
                                      exponential_decay, tree_get, tree_set)

# the compact plan's keys (ops/scatter.make_compact_plan) a sparse update
# takes: the batch carries each as ``sopt_<key>_d<dim>``
PLAN_KEYS = ("uids", "ids", "perm", "tiles")

SPARSE_MIN_ROWS = 1 << 22      # smaller tables sweep densely
SPARSE_CAPABLE = ("Adagrad", "ProximalAdagrad", "Ftrl", "SGD",
                  "RowwiseAdagrad")
# the unit a RowwiseAdagrad table's row width is rounded up to: one float4,
# what K3 moves a lane at a time (csrc/rowdma.cu; the choice is measured in
# PERF.md)
FUSED_ALIGN = 4
ROWWISE_EPS = 1e-7      # inside the root, as the port's Adagrad has it
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


def _lr_at(lr, count: int) -> torch.Tensor:
    return (lr(count) if callable(lr)
            else torch.tensor(lr, dtype=torch.float32))


def _n_slots(spec: Dict[str, Any]) -> int:
    return {"SGD": 0, "Adagrad": 1, "ProximalAdagrad": 1, "Ftrl": 2,
            "RowwiseAdagrad": 1}[spec["name"]]


def slot_width(spec: Dict[str, Any], dim: int) -> int:
    """Columns of each optimizer slot of a ``dim``-wide table: one a row
    under RowwiseAdagrad, else ``dim``."""
    return 1 if spec["name"] == "RowwiseAdagrad" else dim


def table_spec(model_conf: Dict[str, Any]) -> Dict[str, Any]:
    """The fused tables' optimizer: ``dnn_embedding_optimizer`` where set,
    else ``dnn_optimizer``."""
    return (model_conf.get("dnn_embedding_optimizer")
            or model_conf["dnn_optimizer"])


def fused_layout(spec: Dict[str, Any], dim: int) -> Dict[str, int]:
    """Column offsets of the optimizer slots inside a fused table (each
    ``slot_width`` wide)."""
    names = _SLOT_KEYS[:_n_slots(spec)]
    sw = slot_width(spec, dim)
    return {k: dim + i * sw for i, k in enumerate(names)}


def fused_width(spec: Optional[Dict[str, Any]], dim: int) -> Optional[int]:
    """float32 columns of a fused ``dim``-wide table under ``spec``: 128
    (ops/rowdma.FUSED_WIDTH, the JAX package's layout) where the live
    columns fit it; under RowwiseAdagrad the live columns rounded up to
    whole float4s; None where the rule's row fits neither (the table is
    not fused)."""
    from wide_deep_tpu_torch.ops.rowdma import FUSED_WIDTH
    if spec is None or spec["name"] not in SPARSE_CAPABLE:
        return None
    live = fused_live_width(spec, dim)
    if spec["name"] == "RowwiseAdagrad":
        return -(-live // FUSED_ALIGN) * FUSED_ALIGN
    return FUSED_WIDTH if live <= FUSED_WIDTH else None


def plan_sparse_tables(plan, model_conf, decay_steps: float, batch_size: int,
                       enabled: bool = True
                       ) -> Tuple[Dict[str, SparseTable], frozenset]:
    """Tables the fused optimizer owns -> ({name: SparseTable}, paths).
    Derived from ``plan.sparse_opt_group``, the predicate that also picks
    the fused param layout, so routing and shapes cannot drift."""
    spec = table_spec(model_conf)
    if not enabled or spec["name"] not in SPARSE_CAPABLE:
        return {}, frozenset()
    lr0 = spec.get("learning_rate", model_conf["dnn_initial_learning_rate"])
    schedule = exponential_decay(
        lr0, model_conf.get("dnn_decay_rate", 1.0), decay_steps)
    out: Dict[str, SparseTable] = {}
    for g in plan.groups:
        if plan.sparse_opt_group(g, batch_size):
            name = f"dnn.embed.d{g.dim}"
            out[name] = SparseTable(
                name=name, path=("dnn", "embed", f"d{g.dim}"),
                ids_key=f"emb_ids_d{g.dim}", spec=spec, lr=schedule,
                dim=g.dim)
    return out, frozenset(t.path for t in out.values())


def fused_live_width(spec: Dict[str, Any], dim: int) -> int:
    """Columns of a fused table that carry data (param + optimizer slots);
    the columns past them, to ``fused_width``, are zero padding to the row
    width K3 writes (ops/rowdma.py)."""
    return dim + _n_slots(spec) * slot_width(spec, dim)


def compact_fused_ckpt(params, sparse_tables: Dict[str, SparseTable]):
    """Checkpoint view of ``params``: fused tables as views of their live
    column block.  The padding columns are zero by construction (init makes
    them zero and apply_fused_update writes them back unchanged), so
    leaving them out halves the d32 table's checkpoint (5.12 -> 2.56 GB at
    production shapes, Adagrad) with an exact resume.  The views share the
    live tables' storage: a restore into them writes the live tables."""
    for t in (sparse_tables or {}).values():
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


@torch.no_grad()
def init_fused_params(params, sparse_tables: Dict[str, SparseTable]):
    """Set the slot column blocks of fused tables to their init values
    (the model creates them zero), in place."""
    for t in (sparse_tables or {}).values():
        p = tree_get(params, t.path)
        sw = slot_width(t.spec, t.dim)
        for key, off in fused_layout(t.spec, t.dim).items():
            val = (t.spec.get("initial_accumulator_value", 0.1)
                   if key == "accum" else 0.0)
            if val:
                p[:, off:off + sw] = val
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
    elif name == "RowwiseAdagrad":
        # the port's Adagrad with one accumulator a row, which takes the
        # row's mean squared gradient: a_r += mean_j g_rj^2, w_r -= lr g_r /
        # sqrt(a_r + 1e-7).  The mean is summed in float64 (the float32
        # squares add exactly there up to its rounding) and rounded once,
        # so the card's rows get the host's bits, whatever order each
        # sums in
        sq = g.double().square().sum(dim=-1, keepdim=True)
        n2 = slots["accum"] + (sq / g.shape[-1]).float()
        w_new = w - lr * g * _rsqrt(n2 + ROWWISE_EPS)
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


def _fused_rows(spec: Dict[str, Any], lr, full: torch.Tensor,
                g: torch.Tensor) -> torch.Tensor:
    """Fused rows ``full`` [N, width] after one step of ``spec`` with the
    summed gradient ``g`` [N, dim]: the param and slot columns computed by
    ``_row_update``, the padding columns as they were."""
    d = g.shape[1]
    sw = slot_width(spec, d)
    layout = fused_layout(spec, d)
    slots = {k: full[:, off:off + sw] for k, off in layout.items()}
    w_new, new_rows = _row_update(spec, lr, full[:, :d], g, slots)
    used = fused_live_width(spec, d)
    return torch.cat(
        [w_new] + [new_rows[k] for k in _SLOT_KEYS if k in new_rows]
        + [full[:, used:]], dim=1).contiguous()


def compact_live(batch) -> Dict[str, int]:
    """{"d<dim>": the distinct rows of the group's single-device compact
    plan (``sopt_ids_d<dim>``'s last rank plus one)} of a batch of numpy
    arrays or tensors, counted as ``sparse.touched_rows``.  The Trainer
    reads it from the host batch when it packs one
    (``training/loop.TensorBatch``); read from a card tensor it waits for
    the card."""
    out = {}
    for key, v in batch.items():
        if key.startswith("sopt_ids_d") and v.ndim == 1:
            out[key[len("sopt_ids_"):]] = live = (int(v[-1]) + 1 if len(v)
                                                  else 0)
            tracing.count("sparse.touched_rows", live)
    return out


@torch.no_grad()
def apply_fused_update(table: SparseTable, fused: torch.Tensor,
                       row_grads: torch.Tensor,
                       plan: Dict[str, torch.Tensor],
                       state: Dict[str, Any]) -> torch.Tensor:
    """Touched-rows update of a fused [rows, width] table, in place.

    ``row_grads`` [N, dim] is the gradient of the rows the forward gathered
    (one per pool entry); ``plan`` the batch's compact plan {uids, ids,
    perm, tiles} and ``live``, its distinct rows (an int:
    ``compact_live``).  K1 sums duplicates into one float32 row per unique
    id (from the gradient in its own dtype: the same float32 sums), the
    formula runs on the gathered rows, K3 writes them back; padding
    columns are written back unchanged.  The plan's rows past ``live``, its
    sentinels, are neither summed into, gathered, computed nor passed to
    K3."""
    from wide_deep_tpu_torch.ops.rowdma import rowdma_scatter_rows
    from wide_deep_tpu_torch.ops.scatter import range_scatter_add
    lr = _lr_at(table.lr, state["count"])
    live = int(plan["live"])
    g_unique = range_scatter_add(plan["ids"], plan["perm"],
                                 row_grads.contiguous(), plan["tiles"], live,
                                 torch.float32)
    uids = plan["uids"][:live]
    safe = torch.clamp(uids, 0, fused.shape[0] - 1)
    full = fused.index_select(0, safe)
    rowdma_scatter_rows(fused, uids, _fused_rows(table.spec, lr, full,
                                                 g_unique))
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
    shard_rows = fused.shape[0]
    g_all = mesh_lib.all_gather(row_grads.float().contiguous(),
                                mesh.data_group, "sparse_update")
    ids_all = mesh_lib.all_gather(ids.reshape(-1).int().contiguous(),
                                  mesh.data_group, "sparse_update")

    def formula(full, g):
        return _fused_rows(table.spec, lr, full, g)

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
