"""Streaming evaluation metrics: accuracy, AUC-ROC, AUC-PR, means, loss.

The port's copy of wide_deep_tpu/metrics.py: float32 accumulators on the
device, folded one batch at a time, and finalised on the host.  The metric
set is the reference's canned head's (accuracy, auc, auc_precision_recall,
average_loss, loss, label/mean, prediction/mean; the loop adds
global_step).  AUC follows tf.metrics.auc's bucketed confusion matrix:
200 thresholds with +/-1e-7 end anchors, one [T, B] comparison per batch and
trapezoidal integration.  Padding rows carry weight 0.  The [T, B] products
run in full float32 on the card (``models.deep.set_parity_precision``).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch

NUM_THRESHOLDS = 200
_EPS = 1e-7

# np.trapezoid is numpy >= 2.0's name of np.trapz
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def thresholds(num: int = NUM_THRESHOLDS) -> np.ndarray:
    """tf.metrics.auc threshold ladder with epsilon end anchors."""
    inner = [(i + 1) / (num - 1) for i in range(num - 2)]
    return np.array([-_EPS] + inner + [1.0 + _EPS], dtype=np.float32)


@functools.lru_cache(maxsize=8)
def _thresholds_on(num: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(thresholds(num)).to(device)


def init_metrics(num_thresholds: int = NUM_THRESHOLDS,
                 device=None) -> Dict[str, torch.Tensor]:
    T = num_thresholds

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {"tp": z(T), "fp": z(T), "tn": z(T), "fn": z(T),
            "loss_sum": z(), "weight_sum": z(),
            "correct": z(), "label_sum": z(), "pred_sum": z()}


def update_metrics(acc: Dict[str, torch.Tensor], probs: torch.Tensor,
                   labels: torch.Tensor, weights: torch.Tensor,
                   per_example_loss: torch.Tensor,
                   correct: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
    """Fold one batch into the accumulators (all [B] vectors; ``weights``
    already include the padding mask).  ``correct``: a 0/1 vector, which
    the multiclass head gives as ``argmax(probabilities) == label``; the
    default ``(p >= 0.5) == label`` is the binary head's."""
    t = _thresholds_on(acc["tp"].shape[0], acc["tp"].device)
    p = probs.float()
    y = labels.float()
    w = weights.float()
    pred_pos = (p[None, :] > t[:, None]).float()              # [T, B]
    wy = w * y
    wn = w * (1.0 - y)
    out = dict(acc)
    out["tp"] = acc["tp"] + pred_pos @ wy
    out["fp"] = acc["fp"] + pred_pos @ wn
    out["fn"] = acc["fn"] + (1.0 - pred_pos) @ wy
    out["tn"] = acc["tn"] + (1.0 - pred_pos) @ wn
    out["loss_sum"] = acc["loss_sum"] + torch.sum(per_example_loss.float() * w)
    out["weight_sum"] = acc["weight_sum"] + torch.sum(w)
    if correct is None:
        correct = (p >= 0.5).float() == y
    out["correct"] = acc["correct"] + torch.sum(correct.float() * w)
    out["label_sum"] = acc["label_sum"] + torch.sum(wy)
    out["pred_sum"] = acc["pred_sum"] + torch.sum(p * w)
    return out


def finalize_metrics(acc: Dict[str, torch.Tensor],
                     binary: bool = True) -> Dict[str, float]:
    """Accumulators -> metrics on the host.  ``binary=False`` (multiclass
    head) gives loss and accuracy only, as the reference's multiclass head
    did: the threshold metrics need one positive-class probability."""
    a = {k: v.detach().cpu().numpy() for k, v in acc.items()}
    eps = 1e-12
    w = max(float(a["weight_sum"]), eps)
    out = {
        "accuracy": float(a["correct"]) / w,
        "average_loss": float(a["loss_sum"]) / w,
        "loss": float(a["loss_sum"]) / w,
    }
    if not binary:
        return out
    tp, fp, tn, fn = a["tp"], a["fp"], a["tn"], a["fn"]
    tpr = tp / np.maximum(tp + fn, eps)
    fpr = fp / np.maximum(fp + tn, eps)
    # thresholds ascend, so tpr and fpr descend: integrate along rising fpr
    auc_roc = float(_trapezoid(tpr[::-1], fpr[::-1]))
    precision = tp / np.maximum(tp + fp, eps)
    auc_pr = float(_trapezoid(precision[::-1], tpr[::-1]))
    out.update({
        "auc": auc_roc,
        "auc_precision_recall": auc_pr,
        "label/mean": float(a["label_sum"]) / w,
        "prediction/mean": float(a["pred_sum"]) / w,
    })
    return out
