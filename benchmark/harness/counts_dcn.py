"""Operations and bytes of the DLRM-DCNv2 step, from shapes and from a
batch's own ids: the model's FLOPs a step and the least bytes its d128
gradient sum and row-wise touched-rows update need.  ``harness/dcn.py``
records them under the counters that ``harness/counts.py``'s Wide & Deep
numbers have (``flops_per_step``, ``grad_bound_s``), which ``step_mfu``
and ``kernels_roofline`` read.

The FLOPs are the GEMMs of the bottom MLP, the cross network and the top
MLP, forward and backward (3x the forward's multiply-adds, 2 FLOPs each);
the pooling, the gathers, the scatters and the optimizer sweeps count 0.

The least bytes: the gradient sum reads each live entry's id, its place in
the stream and its bfloat16 gradient row once and writes each distinct
row's float32 sum once; the touched-rows write-back reads each distinct
row's new fused row and writes it into the table once, with its uid.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .counts import BF16, F32, F32_FLOPS_PER_S, HBM_BYTES_PER_S, ID_BYTES


def macs_per_example(spec) -> int:
    """The forward's multiply-adds an example (reference/dcn.Spec)."""
    macs, width = 0, len(spec.dense)
    for units in spec.bottom:
        macs += width * units
        width = units
    w = spec.x0_width
    macs += spec.cross_layers * 2 * w * spec.rank
    for units in list(spec.top) + [1]:
        macs += w * units
        w = units
    return macs


def step_flops(spec, batch_size: int) -> float:
    return 2.0 * 3.0 * macs_per_example(spec) * batch_size


def grad_work(spec, width: int, batch: Dict[str, np.ndarray]
              ) -> Dict[str, float]:
    """Bytes and adds of one step's d128 gradient sum and write-back on
    ``batch`` (a host batch of the program's plan); ``width``: the fused
    table's row width in float32."""
    d = spec.dim
    live = int(np.count_nonzero(batch[f"emb_wts_d{d}"]))
    distinct = int(batch[f"sopt_ids_d{d}"][-1]) + 1
    n_bytes = live * (2 * ID_BYTES + d * BF16) + distinct * d * F32
    n_bytes += distinct * (ID_BYTES + 2 * width * F32)
    return {"bytes": float(n_bytes), "ops": float(live * d)}


def bound_s(work: Dict[str, float]) -> float:
    return max(work["bytes"] / HBM_BYTES_PER_S, work["ops"] / F32_FLOPS_PER_S)
