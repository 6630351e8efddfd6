"""Deep arm: fused embedding input layer + multi-tower DAG-connected MLPs.

The port of wide_deep_tpu/models/deep.py on one device:

* One gather per embedding dim group from a packed id pool, per-feature
  mean combining as a one-hot segment contraction, the multi-hot indicator
  block and the continuous block.
* Folded groups (plan "wide fold") carry the wide arm's weights as trailing
  columns: ``FusedGatherSplit`` gathers both with one index and, in the
  backward, scatters each param's gradient separately.  With a host-built
  plan in the batch the backward runs the hand-written scatter kernels
  (ops/scatter.py K1 range / K2 window); without one it is ``index_add_``.
* Groups under the fused sparse optimizer (optim/sparse.py) are gathered
  from the detached table; the gradient goes to the gathered rows instead
  (the step's "sinks"), never to a dense [rows, D] table gradient.
* Towers: the five named connectivity modes plus ``i-j`` connection lists,
  masked train-mode BatchNorm with moving statistics, dropout.
* On a mesh of ranks (``shard``: the mesh and the row-sharded param paths,
  parallel/exchange.enable_explicit_lookup) every gather from a row-sharded
  table goes through the exchange (JAX ``table_gather``, deep.py:384-411
  there), with the rank's per-shard plan row when the batch carries one;
  replicated tables sum their gradient in a fixed order (K1 over the
  stably sorted ids on the card); BatchNorm's masked moments are taken over
  the global batch (an all-reduce over 'data', deep.py:568-580 there).

Parameters are plain nested dicts of tensors with the JAX package's key
paths (``embed/d<dim>``, ``towers/<i>/{hidden,bn,logits}``); BN state is
``t<i>_l<j>_bn/{mean,var}``.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from wide_deep_tpu_torch.features.plan import FeaturePlan
from wide_deep_tpu_torch.models.activations import activation_fn
from wide_deep_tpu_torch.parallel import exchange

BN_MOMENTUM = 0.99
BN_EPS = 1e-3

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# Summary sink: while a dict is installed here (``summary_scope``),
# tower_forward records each hidden layer's activation stats into it (the
# reference's add_layer_summary, model_util.py:15-17).  Thread-local, so a
# forward in another thread (an eval beside training) records nothing.
_SINK_TLS = threading.local()


def _current_sink() -> Optional[Dict[str, Any]]:
    return getattr(_SINK_TLS, "sink", None)


class summary_scope:
    """Context manager installing a summary sink for this thread."""

    def __init__(self, sink: Dict[str, Any]):
        self.sink = sink

    def __enter__(self):
        self._prev = _current_sink()
        _SINK_TLS.sink = self.sink
        return self.sink

    def __exit__(self, *exc):
        _SINK_TLS.sink = self._prev
        return False


def set_parity_precision() -> None:
    """Full float32 matrix products and convolutions on the card: TF32
    keeps ~3 decimal digits, and the port is held against the JAX package
    in float32.  cuDNN runs only deterministic algorithms, chosen without
    benchmarking: the CNN arm's convolutions then give the same bits on
    every call."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


@dataclasses.dataclass(frozen=True)
class TowerSpec:
    hidden_units: Tuple[int, ...]
    connected_mode: Union[str, Tuple[Tuple[int, int], ...]]


@dataclasses.dataclass(frozen=True)
class DeepSpec:
    towers: Tuple[TowerSpec, ...]
    activation: str = "relu"
    dropout: float = 0.0
    batch_norm: bool = False
    l1: float = 0.0
    l2: float = 0.0
    dtype: Any = torch.float32
    embedding_dtype: Any = torch.float32

    @staticmethod
    def from_model_conf(model_conf: Dict[str, Any],
                        dtype=torch.float32) -> "DeepSpec":
        """Build from Config().model (hidden units may be 1-D or nested)."""
        hidden = model_conf["dnn_hidden_units"]
        if hidden and isinstance(hidden[0], list):
            towers_hidden = [tuple(h) for h in hidden]
        else:
            towers_hidden = [tuple(hidden)]
        mode = model_conf.get("dnn_connected_mode", "simple")
        if isinstance(mode, list) and mode and all(
                isinstance(m, str) and "-" in m for m in mode):
            modes = [parse_connected_mode(mode)] * len(towers_hidden)
        elif isinstance(mode, list):
            modes = [parse_connected_mode(m) for m in mode]
            if len(modes) == 1:
                modes = modes * len(towers_hidden)
        else:
            modes = [parse_connected_mode(mode)] * len(towers_hidden)
        if len(modes) != len(towers_hidden):
            raise ValueError(
                f"{len(towers_hidden)} towers but {len(modes)} connected modes")
        towers = tuple(TowerSpec(h, m) for h, m in zip(towers_hidden, modes))
        return DeepSpec(
            towers=towers,
            activation=model_conf.get("dnn_activation_function", "relu"),
            dropout=float(model_conf.get("dnn_dropout") or 0.0),
            batch_norm=bool(model_conf.get("dnn_batch_normalization")),
            l1=float(model_conf.get("dnn_l1") or 0.0),
            l2=float(model_conf.get("dnn_l2") or 0.0),
            dtype=dtype,
            embedding_dtype=DTYPES[model_conf.get("embedding_dtype")
                                   or "float32"])


NAMED_MODES = ("simple", "first_dense", "last_dense", "dense", "resnet")


def parse_connected_mode(mode) -> Union[str, Tuple[Tuple[int, int], ...]]:
    """Validate a mode name or parse an `i-j` connection list."""
    if isinstance(mode, str):
        if mode not in NAMED_MODES:
            raise ValueError(
                f"invalid connected_mode `{mode}`; expected one of "
                f"{NAMED_MODES} or a connection list like ['0-1','1-2']")
        return mode
    pairs = []
    for item in mode:
        i, j = (int(p) for p in str(item).split("-"))
        if i >= j:
            raise ValueError(f"connection `{item}`: source must precede target")
        pairs.append((i, j))
    return tuple(pairs)


def _connection_map(pairs: Sequence[Tuple[int, int]]) -> Dict[int, List[int]]:
    out: Dict[int, List[int]] = {}
    for i, j in pairs:
        out.setdefault(j, []).append(i)
    return out


# --------------------------------------------------------------- param store
Init = Callable[[torch.Generator, Tuple[int, ...], torch.device],
                torch.Tensor]


class ParamStore:
    """Read-or-create view over a params tree: in create mode missing leaves
    are made with their initializer, so the forward pass is the one source
    of parameter shapes (connection modes, width-changing activations)."""

    def __init__(self, tree: Dict[str, Any], create: bool = False,
                 gen: Optional[torch.Generator] = None,
                 device: Optional[torch.device] = None):
        self.tree = tree
        self.create = create
        self.gen = gen
        self.device = device

    def get(self, path: Sequence[Union[str, int]], shape, init: Init):
        node = self.tree
        for pos, key in enumerate(path[:-1]):
            next_is_int = isinstance(path[pos + 1], int)
            if isinstance(key, int):
                while self.create and len(node) <= key:
                    node.append([] if next_is_int else {})
                node = node[key]
            else:
                if self.create and key not in node:
                    node[key] = [] if next_is_int else {}
                node = node[key]
        leaf = path[-1]
        if self.create and leaf not in node:
            node[leaf] = init(self.gen, tuple(shape), self.device)
        return node[leaf]


def glorot_uniform(gen, shape, device):
    limit = float(np.sqrt(6.0 / (shape[0] + shape[1])))
    return torch.empty(shape, dtype=torch.float32, device=device).uniform_(
        -limit, limit, generator=gen)


def zeros_init(_, shape, device):
    return torch.zeros(shape, dtype=torch.float32, device=device)


def ones_init(_, shape, device):
    return torch.ones(shape, dtype=torch.float32, device=device)


def embedding_init_(gen, block: torch.Tensor) -> torch.Tensor:
    """In place: truncated N(0, 1) on [-2, 2], divided by sqrt(dim) (the tf
    embedding_column default the JAX package follows)."""
    torch.nn.init.trunc_normal_(block, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return block.div_(math.sqrt(block.shape[1]))


# ----------------------------------------------------- gathers with kernels
def _scatter_by_plan(scat, g_flat, rows, out_dtype):
    from wide_deep_tpu_torch.ops.scatter import (apply_scatter_plan,
                                                 apply_window_plan)
    apply = apply_window_plan if "ok" in scat else apply_scatter_plan
    return apply(scat, g_flat.contiguous(), rows, out_dtype)


class FusedGatherSplit(torch.autograd.Function):
    """One gather serves both arms, two gradients serve both optimizers.

    Forward: rows of ``cat([table, fcol.to(table.dtype)], 1)`` at ``ids``
    -> (embedding part [N, D], wide part [N, n] in fcol's dtype).
    Backward: with a plan (``scat``, from the batch) one scatter kernel call
    over the [N, D + n] cotangent in the table's dtype, split after — so
    with a bfloat16 table the wide columns' sums are rounded to bfloat16, as
    in the JAX package's planned path; without a plan, ``index_add_`` per
    param in its own dtype (``sorted_sum``: in float32 over the stably
    sorted ids, rounded once, parallel/exchange.exact_shard_sum: on the
    card K1, the same bits on every call)."""

    @staticmethod
    def forward(ctx, table, fcol, ids, scat, sorted_sum=False):
        ctx.save_for_backward(ids)
        ctx.scat = scat
        ctx.sorted_sum = sorted_sum
        ctx.shapes = (table.shape, table.dtype, fcol.shape, fcol.dtype)
        fused = torch.cat([table, fcol.to(table.dtype)], dim=1)
        full = fused.index_select(0, ids)
        d = table.shape[1]
        return full[:, :d], full[:, d:].to(fcol.dtype)

    @staticmethod
    def backward(ctx, ct_emb, ct_wide):
        (ids,) = ctx.saved_tensors
        t_shape, t_dtype, f_shape, f_dtype = ctx.shapes
        if ctx.scat is not None:
            g = torch.cat([ct_emb.to(t_dtype), ct_wide.to(t_dtype)], dim=1)
            dense = _scatter_by_plan(ctx.scat, g, t_shape[0], t_dtype)
            d = t_shape[1]
            return dense[:, :d], dense[:, d:].to(f_dtype), None, None, None
        if ctx.sorted_sum:
            return (exchange.exact_shard_sum(ids, ct_emb, t_shape[0],
                                             t_dtype),
                    exchange.exact_shard_sum(ids, ct_wide, f_shape[0],
                                             f_dtype),
                    None, None, None)
        d_table = torch.zeros(t_shape, dtype=t_dtype, device=ids.device)
        d_table.index_add_(0, ids, ct_emb.to(t_dtype))
        d_fcol = torch.zeros(f_shape, dtype=f_dtype, device=ids.device)
        d_fcol.index_add_(0, ids, ct_wide.to(f_dtype))
        return d_table, d_fcol, None, None, None


class GatherWithPlan(torch.autograd.Function):
    """Plain table gather whose backward runs a scatter kernel by the
    batch's plan (unfolded big groups)."""

    @staticmethod
    def forward(ctx, table, ids, scat):
        ctx.save_for_backward(ids)
        ctx.scat = scat
        ctx.shape = (table.shape, table.dtype)
        return table.index_select(0, ids)

    @staticmethod
    def backward(ctx, ct):
        (ids,) = ctx.saved_tensors
        shape, dtype = ctx.shape
        return (_scatter_by_plan(ctx.scat, ct.to(dtype), shape[0], dtype),
                None, None)


def shard_plan_of(batch, dim: int):
    """The rank's row of the group's per-shard range (``scat_*``) or window
    (``wscat_*``) plan: ids, perm and tiles on the device, ``ok`` and
    ``live`` as host ints; None when the batch carries none."""
    for prefix in ("scat", "wscat"):
        if f"{prefix}_ok_d{dim}" in batch and (
                batch[f"{prefix}_tiles_d{dim}"].dim() == 3):
            return plan_row(batch, prefix, dim)
    return None


def plan_row(batch, prefix: str, dim: int) -> Dict[str, Any]:
    """A per-shard plan's row from a rank's batch: its [1, ...] arrays
    without the leading axis, ``ok`` and ``live`` as ints."""
    out: Dict[str, Any] = {}
    for k in ("uids", "ids", "perm", "tiles", "ok", "live"):
        v = batch.get(f"{prefix}_{k}_d{dim}")
        if v is None:
            continue
        out[k] = int(v.reshape(-1)[0]) if k in ("ok", "live") else v[0]
    return out


def _plan_of(batch, dim: int):
    """The group's range (``scat_*``) or window (``wscat_*``) plan."""
    for prefix in ("scat", "wscat"):
        if f"{prefix}_ids_d{dim}" in batch:
            keys = ("ids", "perm", "tiles") + (
                ("ok",) if prefix == "wscat" else ())
            return {k: batch[f"{prefix}_{k}_d{dim}"] for k in keys}
    return None


# ------------------------------------------------------------- input layer
class PlanConstants:
    """Static metadata derived from the plan for the input layer."""

    def __init__(self, plan: FeaturePlan):
        self.indicator_dim = plan.indicator_dim
        self.n_continuous = len(plan.continuous_slots)
        self.indicator_wide_rows = np.asarray(plan.indicator_wide_rows,
                                              np.int64)
        self._on_device: Dict[torch.device, torch.Tensor] = {}

    def wide_rows_on(self, device: torch.device) -> torch.Tensor:
        """``indicator_wide_rows`` on ``device``, copied there once: a step
        issues no host-to-device copy of its own."""
        rows = self._on_device.get(device)
        if rows is None:
            rows = torch.from_numpy(self.indicator_wide_rows).to(device)
            self._on_device[device] = rows
        return rows


def indicator_block(batch: Dict[str, torch.Tensor], indicator_dim: int,
                    dtype=torch.float32) -> torch.Tensor:
    """Multi-hot [B, indicator_dim] block from packed indicator ids/wts
    (duplicates count; padding entries carry weight 0)."""
    ids = batch["ind_ids"].long()
    wts = batch["ind_wts"].to(dtype)
    out = torch.zeros((ids.shape[0], indicator_dim), dtype=dtype,
                      device=ids.device)
    return out.scatter_add_(1, ids, wts)


def deep_input_layer(store: ParamStore, plan: FeaturePlan,
                     consts: PlanConstants, batch: Dict[str, torch.Tensor],
                     dtype=torch.float32, embedding_dtype=torch.float32,
                     fold_params: Optional[Dict[str, torch.Tensor]] = None,
                     sinks: Optional[Dict[str, torch.Tensor]] = None,
                     shard=None):
    """Packed batch -> ([B, deep_input_dim] dense input, fold_wide | None).

    ``sinks``: when a dict, the rows gathered for the groups it names
    (``d<dim>`` keys: the step's sparse tables with a compact plan in the
    batch) are gathered from the detached table and become leaf tensors
    that require grad, stored under their key; their gradient is the
    compact per-entry gradient the step hands to optim/sparse's
    apply_fused_update (fused tables) or apply_compact_update.

    ``shard``: (mesh, row-sharded param paths) on a mesh of ranks, else
    None."""
    mesh, sharded = shard if shard is not None else (None, frozenset())
    parts = []
    B = batch["mask"].shape[0]
    fold_wide = None
    for g in plan.groups:
        ids2 = batch[f"emb_ids_d{g.dim}"]            # [B, P] packed pool
        wts = batch[f"emb_wts_d{g.dim}"]              # [B, P]
        seg = batch[f"emb_seg_d{g.dim}"]              # [B, P] slot index
        P = ids2.shape[1]
        ids = ids2.reshape(-1)
        if plan.sparse_opt_group(g, B):
            from wide_deep_tpu_torch.ops.rowdma import FUSED_WIDTH

            def fused_init(gen, shape, device, _d=g.dim):
                t = torch.zeros(shape, dtype=torch.float32, device=device)
                embedding_init_(gen, t[:, :_d])
                return t

            table = store.get(("embed", f"d{g.dim}"), (g.rows, FUSED_WIDTH),
                              fused_init)
            if ("dnn", "embed", f"d{g.dim}") in sharded:
                rows = exchange.gather_rows_nograd(
                    table.detach()[:, :g.dim], ids, mesh)
            else:
                rows = table.detach().index_select(0, ids)[:, :g.dim]
            gathered = rows.to(embedding_dtype)
        else:
            def emb_init(gen, shape, device):
                t = torch.empty(shape, dtype=torch.float32, device=device)
                return embedding_init_(gen, t).to(embedding_dtype)

            table = store.get(("embed", f"d{g.dim}"), (g.rows, g.dim),
                              emb_init)
            scat = _plan_of(batch, g.dim)
            wide_rows = None
            if ("dnn", "embed", f"d{g.dim}") in sharded:
                gathered, wide_rows = _sharded_gather(
                    mesh, table, ids, shard_plan_of(batch, g.dim),
                    fold_params[f"d{g.dim}"]
                    if fold_params is not None and g.folded else None,
                    detach=sinks is not None and f"d{g.dim}" in sinks)
            elif sinks is not None and f"d{g.dim}" in sinks:
                gathered = table.detach().index_select(0, ids)
            elif fold_params is not None and g.folded:
                fcol = fold_params[f"d{g.dim}"]
                gathered, wide_rows = FusedGatherSplit.apply(
                    table, fcol, ids, scat, mesh is not None and scat is None)
            elif scat is not None:
                gathered = GatherWithPlan.apply(table, ids, scat)
            elif mesh is not None:
                from wide_deep_tpu_torch.models.linear import GatherRows
                gathered = GatherRows.apply(table, ids)
            else:
                gathered = table.index_select(0, ids)
            if wide_rows is not None:
                presence = (wts > 0).float()
                fw = torch.einsum("bpn,bp->bn",
                                  wide_rows.float().reshape(B, P, -1),
                                  presence)
                fold_wide = fw if fold_wide is None else fold_wide + fw
        if sinks is not None and f"d{g.dim}" in sinks:
            gathered = gathered.detach().requires_grad_(True)
            sinks[f"d{g.dim}"] = gathered
        weighted = gathered.float().reshape(B, P, g.dim) * wts[..., None]
        onehot = F.one_hot(seg.long(), len(g.slots)).float()
        combined = torch.einsum("blf,bld->bfd", onehot, weighted)
        parts.append(combined.reshape(B, -1).to(dtype))
    if consts.indicator_dim:
        ind = batch.get("_ind_block")
        if ind is None:
            ind = indicator_block(batch, consts.indicator_dim, dtype)
        parts.append(ind.to(dtype))
    if consts.n_continuous:
        parts.append(batch["cont"].to(dtype))
    return torch.cat(parts, dim=-1), fold_wide


def _sharded_gather(mesh, table, ids, plan, fcol, detach: bool):
    """A row-sharded group's rows through the exchange -> (embedding rows
    [N, D], fold rows [N, n] in fcol's dtype, or None).  The fold columns
    ride the same exchange (the table and its fold shard concatenated
    column-wise, as the JAX package's explicit path concatenates them);
    ``detach``: the gradient goes to the step's sink instead."""
    if detach:
        return exchange.gather_rows_nograd(table.detach(), ids, mesh), None
    tables = [table] if fcol is None else [table, fcol]
    full = exchange.planned_sharded_gather(tables, ids, plan, mesh) \
        if plan is not None else exchange.explicit_sharded_gather(
            tables, ids, mesh)
    d = table.shape[1]
    if fcol is None:
        return full, None
    return full[:, :d], full[:, d:].to(fcol.dtype)


# ------------------------------------------------------------------- towers
def _dense(store: ParamStore, path, x, units, dtype):
    kernel = store.get(tuple(path) + ("kernel",), (x.shape[-1], units),
                       glorot_uniform)
    bias = store.get(tuple(path) + ("bias",), (units,), zeros_init)
    # products of `dtype`-rounded operands summed in float32 (the JAX
    # package's preferred_element_type); TF32 is off (set_parity_precision)
    y = torch.matmul(x.to(dtype).float(), kernel.to(dtype).float()) + bias
    return y.to(dtype)


def _batch_norm(store: ParamStore, state: Optional[Dict], new_state: Dict,
                tower_idx: int, layer_idx: int, x, training: bool,
                mask: Optional[torch.Tensor] = None, mesh=None):
    """Train-mode BN with masked moments (padding rows excluded), moving
    stats new = 0.99 * old + 0.01 * batch (biased variance), eps 1e-3.
    On a mesh the moments are the global batch's: the masked sums and
    counts are summed over 'data' (``AllReduceSum``, whose backward sums
    the cotangents back)."""
    scale = store.get(("towers", tower_idx, "bn", layer_idx, "scale"),
                      (x.shape[-1],), ones_init)
    bias = store.get(("towers", tower_idx, "bn", layer_idx, "bias"),
                     (x.shape[-1],), zeros_init)
    skey = f"t{tower_idx}_l{layer_idx}_bn"
    xf = x.float()
    if training or state is None or skey not in state:
        if mesh is not None:
            m = (mask.float() if mask is not None
                 else torch.ones(xf.shape[0], device=xf.device))[:, None]
            s1 = exchange.AllReduceSum.apply(mesh.data_group, "bn", torch.cat(
                [torch.sum(xf * m, dim=0), torch.sum(m).reshape(1)]))
            denom = torch.clamp(s1[-1], min=1.0)
            mean = s1[:-1] / denom
            var = exchange.AllReduceSum.apply(
                mesh.data_group, "bn",
                torch.sum(m * (xf - mean) ** 2, dim=0)) / denom
        elif mask is not None:
            m = mask.float()[:, None]
            denom = torch.clamp(torch.sum(m), min=1.0)
            mean = torch.sum(xf * m, dim=0) / denom
            var = torch.sum(m * (xf - mean) ** 2, dim=0) / denom
        else:
            mean = torch.mean(xf, dim=0)
            var = torch.var(xf, dim=0, unbiased=False)
    else:
        mean, var = state[skey]["mean"], state[skey]["var"]
    if training:
        if state is not None and skey in state:
            old_mean, old_var = state[skey]["mean"], state[skey]["var"]
        else:
            old_mean = torch.zeros_like(mean)
            old_var = torch.ones_like(var)
        new_state[skey] = {
            "mean": (BN_MOMENTUM * old_mean
                     + (1 - BN_MOMENTUM) * mean).detach(),
            "var": (BN_MOMENTUM * old_var + (1 - BN_MOMENTUM) * var).detach(),
        }
    elif state is not None and skey in state:
        new_state[skey] = state[skey]
    inv = torch.rsqrt(var + BN_EPS)
    return ((xf - mean) * inv * scale + bias).to(x.dtype)


def tower_forward(store: ParamStore, spec: DeepSpec, tower_idx: int,
                  x: torch.Tensor, n_logits: int, training: bool,
                  rng: Optional[torch.Generator],
                  bn_state: Optional[Dict], new_bn_state: Dict,
                  mask: Optional[torch.Tensor] = None,
                  mesh=None) -> torch.Tensor:
    """One tower: DAG-connected hidden stack -> logits [B, n_logits]."""
    tower = spec.towers[tower_idx]
    act = activation_fn(spec.activation)
    mode = tower.connected_mode
    conn = _connection_map(mode) if not isinstance(mode, str) else None
    net = x
    collections = [x]
    for layer_id, units in enumerate(tower.hidden_units):
        h = _dense(store, ("towers", tower_idx, "hidden", layer_id), net,
                   units, spec.dtype)
        h = act(h)
        if spec.dropout and training:
            if rng is None:
                raise ValueError("dropout needs a torch.Generator (rng)")
            keep = 1.0 - spec.dropout
            drop = torch.rand(h.shape, generator=rng, device=h.device) < keep
            h = torch.where(drop, h / keep, torch.zeros_like(h))
        if spec.batch_norm:
            h = _batch_norm(store, bn_state, new_bn_state, tower_idx,
                            layer_id, h, training, mask, mesh)
        if isinstance(mode, str):
            if mode == "simple":
                net = h
            elif mode == "first_dense":
                net = torch.cat([h, x], dim=1)
            elif mode == "last_dense":
                net = h
                collections.append(h)
            elif mode == "dense":
                collections.append(h)
                net = torch.cat(collections, dim=1)
            else:  # resnet: concat with this layer's input
                net = torch.cat([h, collections[layer_id]], dim=1)
                collections.append(net)
        else:  # arbitrary connections
            sources = [collections[i] for i in conn.get(layer_id + 1, [])]
            net = torch.cat(sources + [h], dim=1) if sources else h
            collections.append(net)
        sink = _current_sink()
        if sink is not None:
            # over the whole batch, padding rows included, as in the JAX
            # package
            scope = f"dnn_{tower_idx}/hiddenlayer_{layer_id}"
            netf = net.detach().float()
            sink[f"{scope}/zero_fraction"] = (netf == 0).float().mean()
            sink[f"{scope}/activation_mean"] = netf.mean()
            sink[f"{scope}/activation_std"] = netf.std(correction=0)
    if isinstance(mode, str) and mode == "last_dense":
        net = torch.cat(collections, dim=1)
    return _dense(store, ("towers", tower_idx, "logits"), net, n_logits,
                  spec.dtype).float()


def deep_logits(store: ParamStore, plan: FeaturePlan, consts: PlanConstants,
                spec: DeepSpec, batch: Dict[str, torch.Tensor],
                n_logits: int, training: bool,
                rng: Optional[torch.Generator], bn_state: Optional[Dict],
                fold_params: Optional[Dict[str, torch.Tensor]] = None,
                sinks: Optional[Dict[str, torch.Tensor]] = None,
                shard=None
                ) -> Tuple[torch.Tensor, Dict, Optional[torch.Tensor]]:
    """Input layer + summed tower logits -> (logits, new BN state,
    fold_wide | None); ``shard`` as deep_input_layer takes it."""
    x, fold_wide = deep_input_layer(store, plan, consts, batch, spec.dtype,
                                    spec.embedding_dtype, fold_params, sinks,
                                    shard)
    mesh = shard[0] if shard is not None else None
    new_bn_state: Dict = {}
    logits = None
    mask = batch.get("mask")
    for t in range(len(spec.towers)):
        lt = tower_forward(store, spec, t, x, n_logits, training, rng,
                           bn_state, new_bn_state, mask, mesh)
        logits = lt if logits is None else logits + lt
    return logits, new_bn_state, fold_wide


def init_deep_params(gen: torch.Generator, plan: FeaturePlan,
                     consts: PlanConstants, spec: DeepSpec, n_logits: int,
                     sample_batch: Dict[str, torch.Tensor],
                     device: torch.device):
    """Create the deep arm's params + BN state (mean 0, var 1) by running
    the forward once in create mode."""
    params: Dict[str, Any] = {}
    store = ParamStore(params, create=True, gen=gen, device=device)
    with torch.no_grad():
        _, new_state, _ = deep_logits(store, plan, consts, spec,
                                      sample_batch, n_logits, training=True,
                                      rng=gen, bn_state=None)
    init_state = {k: {"mean": torch.zeros_like(v["mean"]),
                      "var": torch.ones_like(v["var"])}
                  for k, v in new_state.items()}
    return params, init_state


def l2_l1_penalty(params: Dict[str, Any], spec: DeepSpec) -> torch.Tensor:
    """Sum of L1/L2 kernel penalties over all tower dense kernels."""
    total = torch.zeros((), dtype=torch.float32)
    if not (spec.l1 or spec.l2):
        return total
    for tower in params.get("towers", []):
        kernels = [layer["kernel"] for layer in tower.get("hidden", [])]
        if "logits" in tower:
            kernels.append(tower["logits"]["kernel"])
        for k in kernels:
            kf = k.float()
            if spec.l1:
                total = total + spec.l1 * torch.sum(torch.abs(kf))
            if spec.l2:
                total = total + spec.l2 * 0.5 * torch.sum(kf * kf)
    return total
