"""Wide (linear) arm: one sparse-linear layer over the unified wide space
(port of wide_deep_tpu/models/linear.py without the FM term).

The plan packs every pooled wide column into one id space, so the arm is a
single [wide_dim, n_logits] table: logit = sum_j w[id_j] * wt_j + b, plus the
vocab/identity columns as the multi-hot indicator block times the table's
rows for them.  Weights start at zero, which FTRL's sparsity relies on.  The
gather's backward is ``index_add_`` (``index_select``'s gradient): no TPU
kernel stands behind it.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from wide_deep_tpu_torch.features.plan import FeaturePlan


def init_linear_params(plan: FeaturePlan, n_logits: int, device,
                       with_fold: bool = False) -> Dict[str, Any]:
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
    return params


def linear_logits(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
                  consts=None) -> torch.Tensor:
    """[B, n_logits] wide logits: the pooled gather (hash/cross/bucketized
    slots) plus the indicator block against its static wide rows."""
    w = params["w"]
    ids = batch["wide_ids"]
    B, L = ids.shape
    gathered = w.index_select(0, ids.reshape(-1)).reshape(B, L, -1)
    out = torch.einsum("bln,bl->bn", gathered, batch["wide_wts"])
    if consts is not None and consts.indicator_dim:
        from wide_deep_tpu_torch.models.deep import indicator_block
        ind = batch.get("_ind_block")
        if ind is None:
            ind = indicator_block(batch, consts.indicator_dim)
        out = out + torch.matmul(ind.float(), w.index_select(
            0, consts.wide_rows_on(w.device)))
    return out + params["b"]
