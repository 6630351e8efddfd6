"""Wide (linear) arm: one sparse-linear layer over the unified wide space
(port of wide_deep_tpu/models/linear.py).

The plan packs every pooled wide column into one id space, so the arm is a
single [wide_dim, n_logits] table: logit = sum_j w[id_j] * wt_j + b, plus the
vocab/identity columns as the multi-hot indicator block times the table's
rows for them.  Weights start at zero, which FTRL's sparsity relies on.  The
pooled gather's backward (``GatherRows``) sums the rows of repeated ids in
the same order on every call; on the card it runs K1, where the JAX
package's gradient is XLA's scatter-add.

Optional FM second-order term (``linear_fm_factors: k``): a [wide_dim, k]
factor table ``v`` and 0.5 * sum_d((sum_i x_i v_id)^2 - sum_i x_i^2 v_id^2)
over the active wide features (Rendle 2010), trained by the linear arm's
optimizer.  Its pooled gather goes through ``GatherRows`` as ``w``'s does.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from wide_deep_tpu_torch.features.plan import FeaturePlan


def init_linear_params(plan: FeaturePlan, n_logits: int, device,
                       with_fold: bool = False, fm_factors: int = 0,
                       gen: Optional[torch.Generator] = None
                       ) -> Dict[str, Any]:
    """Zero ``w``, ``b`` (and fold columns); with ``fm_factors`` k > 0 the
    factor table ``v`` [wide_dim, k] float32, 0.01 * N(0, 1) drawn from
    ``gen`` (the JAX package draws its own; tests carry it across)."""
    params: Dict[str, Any] = {
        "w": torch.zeros((plan.wide_dim, n_logits), dtype=torch.float32,
                         device=device),
        "b": torch.zeros((n_logits,), dtype=torch.float32, device=device),
    }
    if with_fold and plan.fold:
        # folded wide weights: float32 trailing column(s) of each folded
        # dim group's embedding table, owned by the linear optimizer
        fold = {f"d{g.dim}": torch.zeros((g.rows, n_logits),
                                         dtype=torch.float32, device=device)
                for g in plan.groups if g.folded}
        if fold:
            params["fold"] = fold
    if fm_factors > 0:
        params["v"] = torch.empty(
            (plan.wide_dim, fm_factors), dtype=torch.float32,
            device=device).normal_(generator=gen).mul_(0.01)
    return params


class GatherRows(torch.autograd.Function):
    """``table.index_select(0, ids)`` whose backward gives the same bits on
    every call.  On the card ``index_select``'s own backward
    (``index_add_``) adds the rows of a repeated id with float32 atomics in
    whatever order the threads arrive, so FTRL's n and z of the wide table
    took other low bits from run to run; ``index_put_`` with
    ``accumulate`` is deterministic but gives each id to one warp (1.15 ms
    of a production step on an H100, with hot ids).  So the card sorts the
    ids stably and sums each id's rows with K1
    (ops/scatter.sorted_stream_sum), in float32 and in stream order.  On the CPU the backward is ``index_add_``, which
    adds them in stream order."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.shape = (table.shape, table.dtype)
        return table.index_select(0, ids)

    @staticmethod
    def backward(ctx, ct):
        (ids,) = ctx.saved_tensors
        shape, dtype = ctx.shape
        if ct.is_cuda:
            from wide_deep_tpu_torch.ops.scatter import sorted_stream_sum
            perm = torch.argsort(ids, stable=True)
            grad = sorted_stream_sum(
                ids[perm].int().contiguous(), perm.int().contiguous(),
                ct.float().contiguous(), shape[0], torch.float32)
            return grad.to(dtype), None
        grad = torch.zeros(shape, dtype=dtype, device=ct.device)
        grad.index_add_(0, ids, ct.to(dtype))
        return grad, None


def _fm_term(v: torch.Tensor, batch: Dict[str, torch.Tensor],
             consts) -> torch.Tensor:
    """[B] pairwise-interaction term over the active wide features."""
    ids = batch["wide_ids"]
    B, L = ids.shape
    gathered = GatherRows.apply(v, ids.reshape(-1)).reshape(B, L, -1)
    wts = batch["wide_wts"][..., None]
    s1 = (gathered * wts).sum(dim=1)                       # [B, k]
    s2 = ((gathered ** 2) * (wts ** 2)).sum(dim=1)         # [B, k]
    if consts is not None and consts.indicator_dim:
        from wide_deep_tpu_torch.models.deep import indicator_block
        ind = batch.get("_ind_block")
        if ind is None:
            ind = indicator_block(batch, consts.indicator_dim)
        ind = ind.float()
        v_ind = v.index_select(0, consts.wide_rows_on(v.device))  # [Di, k]
        s1 = s1 + torch.matmul(ind, v_ind)
        s2 = s2 + torch.matmul(ind ** 2, v_ind ** 2)
    return 0.5 * (s1 ** 2 - s2).sum(dim=-1)


def linear_logits(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
                  consts=None) -> torch.Tensor:
    """[B, n_logits] wide logits: the pooled gather (hash/cross/bucketized
    slots) plus the indicator block against its static wide rows."""
    w = params["w"]
    ids = batch["wide_ids"]
    B, L = ids.shape
    gathered = GatherRows.apply(w, ids.reshape(-1)).reshape(B, L, -1)
    out = torch.einsum("bln,bl->bn", gathered, batch["wide_wts"])
    if consts is not None and consts.indicator_dim:
        from wide_deep_tpu_torch.models.deep import indicator_block
        ind = batch.get("_ind_block")
        if ind is None:
            ind = indicator_block(batch, consts.indicator_dim)
        out = out + torch.matmul(ind.float(), w.index_select(
            0, consts.wide_rows_on(w.device)))
    if "v" in params:
        out = out + _fm_term(params["v"], batch, consts)[:, None]
    return out + params["b"]
