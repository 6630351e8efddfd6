"""The collectives of one sharded train step, from shapes alone (the port's
counterpart of wide_deep_tpu/parallel/hlo_stats.py).

The JAX package reads its step's collectives out of the compiled HLO.  The
port has no HLO: its collectives are the calls of parallel/mesh.py, each of
which adds the bytes this rank puts into it to ``collective_bytes[tag]``.
``step_collectives`` predicts those counts for a configuration and a mesh
shape without a process group and without allocating a tensor: the plan
and the batch spec give every gather's ids and widths, the model's params
drawn on the ``meta`` device give the replicated gradients and the
BatchNorm widths.  Per step and per rank, by tag and by op kind:

* ``lookup`` / ``lookup_bwd``: the explicit exchange (ids all-gathered over
  'data', rows all-reduced over 'model' and reduce-scattered over 'data';
  the cotangent all-gathered back over 'data'), and the static rows of the
  wide table (all-reduced over 'model' and 'data'; back over 'data');
* ``dedup_rows`` / ``dedup_rows_bwd``: the dedup exchange, one all-gather
  of the shard's ``cap`` unique rows over every rank (S x cap x D in all,
  static) and the reduce-scatter of the [S * cap, D] float32 slot sums;
* ``bn`` / ``bn_bwd``: BatchNorm's global moments over 'data';
* ``loss``: the global weight sum over 'data' and the loss over every rank;
* ``grads``: one all-reduce a dtype of every replicated gradient;
* ``sparse_update``: the fused optimizer's cotangent and ids over 'data'.

A collective over a group of one rank is not made and counts nothing.
The step is the Trainer's: its plan is ``build_training_plan``'s for
``data x model`` ranks, each a process, fed with the global batch when
``global_batch_input`` (the input service, or a 'data' axis of 1).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

class _Tally:
    def __init__(self):
        self.ops: Dict[str, Dict[str, int]] = {}

    def add(self, tag: str, op: str, nbytes: int, group: int) -> None:
        """One collective of ``nbytes`` over a group of ``group`` ranks."""
        if group <= 1:
            return
        e = self.ops.setdefault(f"{tag}/{op}", {"bytes": 0, "calls": 0})
        e["bytes"] += int(nbytes)
        e["calls"] += 1

    def result(self) -> Dict[str, Any]:
        by_tag: Dict[str, int] = {}
        for key, e in self.ops.items():
            tag = key.split("/")[0]
            by_tag[tag] = by_tag.get(tag, 0) + e["bytes"]
        return {"by_tag": by_tag, "ops": dict(sorted(self.ops.items())),
                "total_bytes": sum(by_tag.values())}


def _elt(dtype: torch.dtype) -> int:
    return torch.empty(0, dtype=dtype).element_size()


def _explicit(t: _Tally, n_local: int, width: int, elt: int, data: int,
              model: int, backward: bool = True) -> None:
    """ExchangeGather over ``n_local`` ids of rows ``width`` wide."""
    t.add("lookup", "all_gather", n_local * 4, data)
    t.add("lookup", "all_reduce", data * n_local * width * elt, model)
    t.add("lookup", "reduce_scatter", data * n_local * width * elt, data)
    if backward:
        t.add("lookup_bwd", "all_gather", n_local * width * elt, data)


class _Lookup:
    """``config`` with train.yaml's ``sharded_lookup`` replaced."""

    def __init__(self, config, lookup: str):
        self._config, self._lookup = config, lookup

    def __getattr__(self, name):
        return getattr(self._config, name)

    @property
    def distribution(self) -> Dict[str, Any]:
        return dict(self._config.distribution, sharded_lookup=self._lookup)


def step_collectives(config, train_conf: Dict[str, Any], data: int,
                     model: int, global_batch_input: Optional[bool] = None,
                     lookup: Optional[str] = None) -> Dict[str, Any]:
    """-> {"by_tag": {tag: bytes}, "ops": {"tag/op": {bytes, calls}},
    "total_bytes", "plan"}: what one rank's ``collective_bytes`` gains in
    one train step of the Trainer on a ``data x model`` mesh, for the
    two-class wide_deep model (the JAX tool's model; train.yaml's
    ``sharded_lookup``, or ``lookup``; ``train_conf``'s batch size, pack
    budget, ``shard_threshold``, ``sparse_optimizer`` and
    ``scatter_mode``)."""
    if lookup is not None:
        config = _Lookup(config, lookup)
    from wide_deep_tpu_torch.models.joint import build_model
    from wide_deep_tpu_torch.optim import sparse as sparse_lib
    from wide_deep_tpu_torch.optim import tree_items
    from wide_deep_tpu_torch.parallel.mesh import param_shardings
    from wide_deep_tpu_torch.training.loop import build_training_plan

    world = data * model
    if global_batch_input is None:
        global_batch_input = data == 1 or bool(
            config.distribution.get("input_service"))
    B = int(train_conf["batch_size"])
    if B % data:
        raise ValueError(f"batch {B} does not split over data {data}")
    b = B // data
    plan = build_training_plan(config, train_conf, "wide_deep", world,
                               n_procs=world,
                               global_batch_input=global_batch_input)
    net = build_model(config, plan=plan, model_type="wide_deep", n_classes=2)
    meta = torch.device("meta")
    params, mstate = net.init(0, net.sample_batch(meta), device=meta)
    sharded = (param_shardings(params, world,
                               train_conf.get("shard_threshold"))
               if world > 1 else frozenset())
    decay = max(float(train_conf["num_examples"]) / B, 1.0)
    _, sink_paths = sparse_lib.plan_sparse_tables(
        plan, config.model, decay, B, enabled=plan.sparse_opt)
    t = _Tally()

    # the wide arm: the pooled gather and the indicator's static rows
    if ("linear", "w") in sharded:
        w = params["linear"]["w"]
        width, elt = w.shape[1], _elt(w.dtype)
        _explicit(t, b * plan.wide_packed_len, width, elt, data, model)
        n_static = len(plan.indicator_wide_rows) if plan.indicator_dim else 0
        if n_static:
            t.add("lookup", "all_reduce", n_static * width * elt, model)
            t.add("lookup", "all_reduce", n_static * width * elt, data)
            t.add("lookup_bwd", "all_reduce", n_static * width * elt, data)

    # the deep arm's groups
    fold = params["linear"].get("fold")
    for g in plan.groups:
        path = ("dnn", "embed", f"d{g.dim}")
        if path not in sharded:
            continue
        n_local = b * plan.group_packed_len[g.dim]
        table = params["dnn"]["embed"][f"d{g.dim}"]
        if path in sink_paths:
            # the fused optimizer's sink: the forward alone, embedding
            # columns of the float32 fused table
            _explicit(t, n_local, g.dim, _elt(table.dtype), data, model,
                      backward=False)
            continue
        width = g.dim + (fold[f"d{g.dim}"].shape[1]
                         if fold is not None and g.folded else 0)
        elt = _elt(table.dtype)
        if plan.dedup_group(g, B):
            from wide_deep_tpu_torch.ops.scatter import dedup_cap
            cap = dedup_cap(B * plan.group_packed_len[g.dim], g.rows,
                            world)
            t.add("dedup_rows", "all_gather", cap * width * elt, world)
            t.add("dedup_rows_bwd", "reduce_scatter",
                  world * cap * width * 4, world)
        else:
            _explicit(t, n_local, width, elt, data, model)

    # BatchNorm's global moments: [units + 1] sums and counts, [units]
    # squared deviations, each summed back in the backward
    for _, st in sorted(mstate.get("bn", {}).items()):
        units = int(st["mean"].shape[0])
        for tag in ("bn", "bn_bwd"):
            t.add(tag, "all_reduce", (units + 1) * 4, data)
            t.add(tag, "all_reduce", units * 4, data)

    # the loss: the global weight sum, then each rank's share
    t.add("loss", "all_reduce", 4, data)
    t.add("loss", "all_reduce", 4, world)

    # every replicated gradient, one flat buffer a dtype
    by_dtype: Dict[torch.dtype, int] = {}
    for p, leaf in tree_items(params):
        if p in sink_paths or p in sharded:
            continue
        by_dtype[leaf.dtype] = by_dtype.get(leaf.dtype, 0) + int(
            np.prod(leaf.shape)) * _elt(leaf.dtype)
    for nbytes in by_dtype.values():
        t.add("grads", "all_reduce", nbytes, world)

    # the sharded fused optimizer: the compact cotangent and its ids
    if plan.scatter_shards > 1:
        for g in plan.groups:
            if ("dnn", "embed", f"d{g.dim}") in sink_paths:
                n_local = b * plan.group_packed_len[g.dim]
                t.add("sparse_update", "all_gather", n_local * g.dim * 4,
                      data)
                t.add("sparse_update", "all_gather", n_local * 4, data)
    out = t.result()
    out["plan"] = {"scatter_shards": plan.scatter_shards,
                   "shard_kind": plan.shard_kind,
                   "pallas_scatter": plan.pallas_scatter,
                   "sparse_opt": plan.sparse_opt}
    return out
