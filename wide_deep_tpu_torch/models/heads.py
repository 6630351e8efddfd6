"""Classification heads: loss + predictions (port of
wide_deep_tpu/models/heads.py).

Binary: one logit, sigmoid cross-entropy; multiclass: softmax
cross-entropy.  The loss is the weighted mean of per-example losses, the
weights combining the pos/neg sample weights with the batch padding mask.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F


def n_logits_for(n_classes: int) -> int:
    if n_classes < 2:
        raise ValueError("n_classes must be >= 2")
    return 1 if n_classes == 2 else n_classes


def head_loss(logits: torch.Tensor, labels: torch.Tensor,
              weights: torch.Tensor, n_classes: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weighted mean loss, per-example loss)."""
    if n_classes == 2:
        z = logits[:, 0]
        y = labels.float()
        # softplus form: well-defined gradient at z == 0
        per_ex = F.softplus(-z) + z * (1.0 - y)
    else:
        y = labels.long()
        logp = F.log_softmax(logits, dim=-1)
        per_ex = -torch.gather(logp, 1, y[:, None])[:, 0]
    w = weights.float()
    total_w = torch.clamp(torch.sum(w), min=1e-12)
    return torch.sum(per_ex * w) / total_w, per_ex


def head_predictions(logits: torch.Tensor,
                     n_classes: int) -> Dict[str, torch.Tensor]:
    """logits -> {logits, (logistic,) probabilities, class_ids}."""
    if n_classes == 2:
        p = torch.sigmoid(logits[:, 0])
        probs = torch.stack([1.0 - p, p], dim=1)
        class_ids = (p >= 0.5).to(torch.int32)
        return {"logits": logits, "logistic": p, "probabilities": probs,
                "class_ids": class_ids}
    probs = torch.softmax(logits, dim=-1)
    return {"logits": logits, "probabilities": probs,
            "class_ids": torch.argmax(logits, dim=-1).to(torch.int32)}
