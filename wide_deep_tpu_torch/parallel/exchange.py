"""The explicit sharded-embedding exchange (port of
wide_deep_tpu/parallel/exchange.py), on the mesh's process groups.

Every gather from a row-sharded leaf runs this collective schedule, so its
communication volume is a contract (exchange.py:1-28 there):

    ids:   all_gather over 'data'          B/d x P  ->  B x P     (int32)
    rows:  local masked gather             (no communication)
           all_reduce over 'model'         B x P x D  (one shard owns a
                                           row, the others add zeros)
           reduce_scatter over 'data'      B x P x D  ->  B/d x P x D

Bytes per rank grow with ids x D and never with the table's rows.  The
backward is the transposes: the cotangent is all-gathered over 'data' (the
ids gathered in the forward are kept), then summed into the rank's own
shard:

* with the batch's per-shard plan row (``scat_*`` range or ``wscat_*``
  window, ``planned_sharded_gather``, exchange.py:104-257 there): K1 over
  the plan's localized sorted stream, or K2 under its windows
  (``tiles.shape[0] == 3``), over the stream's live prefix (``live`` ids,
  which the host knows: at most ``shard_live_cap`` of them in JAX's
  live-cap branch, counted in ``branch_counts``).  A shard whose flag
  ``ok`` is 0 is summed exactly without the plan, by K1 over the masked
  local ids sorted on the device;
* without a plan (``explicit_sharded_gather``, exchange.py:48-90 there):
  that exact sum.

The collectives all run before any branch, so ranks that disagree on ``ok``
never wait on each other.  On the CPU K1 and K2 are their plain versions.
The forward equals ``index_select`` on the whole table bit for bit.  The
plans' ``ok`` and ``live`` flags are host ints (the batch keeps them on the
host), so no branch syncs with the card.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from wide_deep_tpu_torch.parallel import mesh as mesh_lib

# live-cap and exact-branch counts of the planned backward (per rank)
branch_counts: Dict[str, int] = {}


def _tick(name: str) -> None:
    branch_counts[name] = branch_counts.get(name, 0) + 1


def exact_shard_sum(local_ids: torch.Tensor, g: torch.Tensor,
                    shard_rows: int, out_dtype) -> torch.Tensor:
    """[shard_rows, D] sum of the rows of ``g`` [N, D] at ``local_ids`` [N]
    (ids outside [0, shard_rows) drop), in float32, rounded once: the ids
    are stably sorted on the device and K1 runs over them without a plan
    (ops/scatter.sorted_stream_sum), so two calls give the same bits."""
    from wide_deep_tpu_torch.ops.scatter import sorted_stream_sum
    ids = torch.where((local_ids >= 0) & (local_ids < shard_rows),
                      local_ids, torch.full_like(local_ids, shard_rows))
    order = torch.argsort(ids, stable=True)
    return sorted_stream_sum(ids[order].int().contiguous(),
                             order.int().contiguous(), g.contiguous(),
                             shard_rows, out_dtype)


def planned_shard_sum(plan: Dict[str, Any], g_all: torch.Tensor,
                      local_ids: torch.Tensor, shard_rows: int, n_ids: int,
                      n_shards: int, out_dtype) -> torch.Tensor:
    """The rank's [shard_rows, D] gradient from the all-gathered cotangent
    ``g_all`` [n_ids, D] by its plan row (see the module docstring)."""
    from wide_deep_tpu_torch.ops.scatter import (range_scatter_add,
                                                 shard_live_cap, window_cap,
                                                 window_scatter_add)
    if int(plan["ok"]) == 0:
        _tick("exact")
        out = exact_shard_sum(local_ids, g_all.to(out_dtype), shard_rows,
                              out_dtype)
        if g_all.is_cuda and plan["tiles"].shape[0] == 3:
            from wide_deep_tpu_torch.ops import scatter
            scatter.window_ok0_launches += 1   # K1 in K2's place
        return out
    cap = plan["ids"].shape[-1]
    live = int(plan["live"])
    small = shard_live_cap(n_ids, n_shards)
    _tick("live_cap" if live <= small < cap else "full")
    # the live prefix: the plan pads its stream with id 0 past it
    ids, perm = plan["ids"][:live], plan["perm"][:live]
    tiles = plan["tiles"]
    g = g_all.to(out_dtype).contiguous()
    if tiles.shape[0] == 3:
        return window_scatter_add(ids, perm, g, tiles, shard_rows,
                                  window_cap(cap, shard_rows), out_dtype)
    return range_scatter_add(ids, perm, g, tiles, shard_rows, out_dtype)


class ExchangeGather(torch.autograd.Function):
    """Rows of the column-wise concatenation of row-sharded ``tables`` (each
    this rank's [shard_rows, D_i] shard; the later ones cast to the first's
    dtype) at the global ids ``ids`` [N_local] -> [N_local, sum D_i]; the
    backward gives each table its [shard_rows, D_i] gradient in its own
    dtype.  ``plan``: the rank's plan row, or None."""

    @staticmethod
    def forward(ctx, mesh, ids, plan, *tables):
        dtype = tables[0].dtype
        shard_rows = tables[0].shape[0]
        ids_all = mesh_lib.all_gather(ids.int(), mesh.data_group, "lookup")
        local = ids_all.long() - mesh.shard * shard_rows
        mask = (local >= 0) & (local < shard_rows)
        safe = torch.clamp(local, 0, shard_rows - 1)
        rows = [t.index_select(0, safe).to(dtype) for t in tables]
        part = rows[0] if len(rows) == 1 else torch.cat(rows, dim=1)
        zero = torch.zeros((), dtype=dtype, device=part.device)
        part = torch.where(mask[:, None], part, zero)
        part = mesh_lib.all_reduce(part, mesh.model_group, "lookup")
        out = mesh_lib.reduce_scatter(part, mesh.data_group, "lookup")
        ctx.mesh, ctx.plan = mesh, plan
        ctx.meta = (shard_rows, dtype, [(t.shape[1], t.dtype)
                                        for t in tables])
        ctx.save_for_backward(local)
        return out

    @staticmethod
    def backward(ctx, ct):
        (local,) = ctx.saved_tensors
        mesh, plan = ctx.mesh, ctx.plan
        shard_rows, dtype, cols = ctx.meta
        ct_all = mesh_lib.all_gather(ct.to(dtype).contiguous(),
                                     mesh.data_group, "lookup_bwd")
        if plan is not None:
            d = planned_shard_sum(plan, ct_all, local, shard_rows,
                                  local.shape[0], mesh.world, dtype)
        else:
            d = exact_shard_sum(local, ct_all, shard_rows, dtype)
        grads, at = [], 0
        for width, tdtype in cols:
            grads.append(d[:, at:at + width].to(tdtype))
            at += width
        return (None, None, None) + tuple(grads)


def explicit_sharded_gather(tables: Sequence[torch.Tensor],
                            ids: torch.Tensor, mesh) -> torch.Tensor:
    """[N_local, sum D] rows of the row-sharded ``tables`` at ``ids``
    (exchange.py:48-90 there); the backward sums without a plan."""
    return ExchangeGather.apply(mesh, ids, None, *tables)


def planned_sharded_gather(tables: Sequence[torch.Tensor],
                           ids: torch.Tensor, plan: Dict[str, Any],
                           mesh) -> torch.Tensor:
    """The same forward; the backward runs K1 or K2 on the rank's plan row
    (exchange.py:104-257 there)."""
    return ExchangeGather.apply(mesh, ids, plan, *tables)


def gather_rows_nograd(table: torch.Tensor, ids: torch.Tensor,
                       mesh) -> torch.Tensor:
    """The exchange's forward alone, for a table whose gradient goes
    elsewhere (the fused sparse optimizer's sinks)."""
    with torch.no_grad():
        return ExchangeGather.apply(mesh, ids, None, table)


class StaticRowsGather(torch.autograd.Function):
    """Rows ``rows`` (the same index vector on every rank, e.g. the wide
    table's indicator rows) of a row-sharded table: a masked local gather
    summed over every rank.  Backward: the cotangent summed over 'data'
    (each data slice's loss once), scattered into the rank's shard."""

    @staticmethod
    def forward(ctx, mesh, rows, table):
        shard_rows = table.shape[0]
        local = rows.long() - mesh.shard * shard_rows
        mask = (local >= 0) & (local < shard_rows)
        part = table.index_select(0, torch.clamp(local, 0, shard_rows - 1))
        part = torch.where(mask[:, None], part,
                           torch.zeros((), dtype=part.dtype,
                                       device=part.device))
        part = mesh_lib.all_reduce(part, mesh.model_group, "lookup")
        part = mesh_lib.all_reduce(part, mesh.data_group, "lookup")
        ctx.mesh = mesh
        ctx.meta = (shard_rows, table.dtype)
        ctx.save_for_backward(local)
        return part

    @staticmethod
    def backward(ctx, ct):
        (local,) = ctx.saved_tensors
        shard_rows, dtype = ctx.meta
        ct = mesh_lib.all_reduce(ct.contiguous(), ctx.mesh.data_group,
                                 "lookup_bwd")
        return None, None, exact_shard_sum(local, ct.to(dtype), shard_rows,
                                           dtype)


class AllReduceSum(torch.autograd.Function):
    """Sum over ``group`` whose backward sums the cotangents over the same
    group: every member's loss reads the sum (the global BatchNorm
    moments)."""

    @staticmethod
    def forward(ctx, group, tag, x):
        ctx.group, ctx.tag = group, tag
        return mesh_lib.all_reduce(x, group, tag)

    @staticmethod
    def backward(ctx, ct):
        return None, None, mesh_lib.all_reduce(ct.contiguous(), ctx.group,
                                               ctx.tag + "_bwd")


def lookup_mesh_for(model) -> Optional[Any]:
    """The mesh a model's gathers exchange over (None: one device)."""
    return getattr(model, "mesh", None)


def enable_explicit_lookup(model, mesh, sharded_paths: frozenset) -> None:
    """Route the model's gathers from the leaves at ``sharded_paths``
    (``mesh.param_shardings``) through the exchange (exchange.py:333-348
    there).  The port has no GSPMD: ``sharded_lookup: gspmd`` also runs
    the exchange, without kernel plans (a difference on purpose,
    ROADMAP.md Queue 3)."""
    model.mesh = mesh
    model.sharded_paths = frozenset(sharded_paths)
