"""Operations and bytes, from shapes and from a batch's own ids: the
model's FLOPs a step (``step_mfu``) and the least bytes the step's
sparse-gradient work needs (``kernels_roofline``).

The byte arithmetic follows chip_smoke.py's phase 1 (wide_deep_tpu_torch's
repository at commit 5396835d8e2c28384b317c5c7862110fa5df19db): each live
entry's id and gradient entry are read once, and each distinct touched row
is read and written once.  Unlike phase 1, the dense output table that
today's K1 writes whole is not counted: a kernel that writes only the
touched rows must not read over 100%.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

# NVIDIA H100 SXM, dense rates (NVIDIA's data sheet) at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
ID_BYTES = 4
F32 = 4
BF16 = 2


def mlp_macs_per_example(input_dim: int, hidden) -> int:
    macs, width = 0, input_dim
    for units in list(hidden) + [1]:
        macs += width * units
        width = units
    return macs


def fm_macs_per_example(wide_pool: int, indicator_dim: int, k: int) -> int:
    """The FM term's multiply-adds forward: the pooled factors and their
    squares (s1, s2 over the pool) and the indicator block's two products
    with its factor rows."""
    return 2 * wide_pool * k + 2 * indicator_dim * k


def step_flops(model) -> float:
    """The model's FLOPs a step: the MLP's GEMMs and the FM term, forward
    and backward (3x the forward's multiply-adds, 2 FLOPs each); gathers,
    scatters and optimizer sweeps count 0."""
    plan = model.plan
    macs = mlp_macs_per_example(plan.deep_input_dim, model.hidden)
    if model.fm:
        macs += fm_macs_per_example(plan.wide_packed_len, plan.indicator_dim,
                                    model.fm)
    return 2.0 * 3.0 * macs * model.batch_size


def grad_work(model, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
    """The bytes and adds of one step's sparse-gradient work on ``batch``
    (a host batch of the model's plan): the wide gather's backward (and
    the FM factors'), each embedding group's gradient sum (with the folded
    wide column), and the touched-rows update of the table under the
    fused optimizer (its parameter and slot columns read and written)."""
    plan = model.plan
    n_bytes = 0.0
    n_ops = 0.0
    live = batch["wide_wts"] != 0
    ids = batch["wide_ids"][live]
    distinct = np.unique(ids).size
    widths = [1] + ([model.fm] if model.fm else [])
    for width in widths:
        n_bytes += ids.size * (ID_BYTES + width * F32)
        n_bytes += distinct * 2 * width * F32
        n_ops += ids.size * width
    for g in plan.groups:
        live = batch[f"emb_wts_d{g.dim}"] != 0
        ids = batch[f"emb_ids_d{g.dim}"][live]
        distinct = np.unique(ids).size
        if g.dim in model.sparse_dims:
            row = (1 + plan.sparse_slots) * g.dim * F32
            n_bytes += ids.size * (ID_BYTES + g.dim * BF16)
            n_bytes += distinct * (ID_BYTES + 2 * row)
            n_ops += ids.size * g.dim
            continue
        width = g.dim + (1 if plan.fold and g.folded else 0)
        es = BF16 if model.emb_dtype.itemsize == 2 else F32
        n_bytes += ids.size * (ID_BYTES + width * es)
        n_bytes += distinct * 2 * width * es
        n_ops += ids.size * width
    return {"bytes": n_bytes, "ops": n_ops}


def bound_s(work: Dict[str, float]) -> float:
    return max(work["bytes"] / HBM_BYTES_PER_S, work["ops"] / F32_FLOPS_PER_S)
