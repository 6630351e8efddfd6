"""The reference's training steps: the model of model.py under the
configuration's optimizers, in plain PyTorch.

The update formulas are frozen copies of wide_deep_tpu_torch/optim/
__init__.py (FTRL on the linear arm, Adagrad on the dnn arm, each with its
exponential decay on its own step count) and of the touched-rows Adagrad
row formula of wide_deep_tpu_torch/optim/sparse.py for the table the
configuration puts under the touched-rows optimizer, at commit
5396835d8e2c28384b317c5c7862110fa5df19db.  Every leaf keeps its own slots;
nothing is fused.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .model import Model


def exponential_decay(lr0: float, decay_rate: float, decay_steps: float):
    if decay_rate == 1.0 or decay_steps <= 0:
        return lambda step: torch.tensor(lr0, dtype=torch.float32)
    rate = torch.tensor(decay_rate, dtype=torch.float32)
    return lambda step: lr0 * rate ** (
        torch.tensor(step, dtype=torch.float32) / decay_steps)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x.double()).to(x.dtype)


def _rsqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x.double()).float().reciprocal().to(x.dtype)


def _on(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), float(t), dtype=t.dtype, device=like.device)


def ftrl_(spec, lr, w, g, n, z, first: bool):
    l1 = spec.get("l1_regularization_strength", 0.0)
    l2 = spec.get("l2_regularization_strength", 0.0)
    lr = _on(lr, w)
    g = g.float()
    n2 = n + g ** 2
    root_n2 = _sqrt(n2)
    root_n = _sqrt(n.to(w.dtype)).float() if first else _sqrt(n)
    z2 = z + g - (root_n2 - root_n) / lr * w
    w_new = torch.where(torch.abs(z2) <= l1, torch.zeros_like(w),
                        (torch.sign(z2) * l1 - z2)
                        / (root_n2 / lr + 2 * l2))
    w.add_((w_new - w).to(w.dtype))
    n.copy_(n2)
    z.copy_(z2)


def adagrad_(lr, w, g, s, eps: float = 1e-7):
    s.copy_(g * g + s)
    inv = torch.where(s > 0, _rsqrt(s + eps), torch.zeros_like(s))
    u = (-lr).to(g.dtype) * (inv * g)
    w.copy_((w + u).to(w.dtype))


def adagrad_rows_(lr, w, g, accum):
    """The touched-rows Adagrad on float32 rows: rows whose gradient is
    zero keep their values exactly, so the whole table may be swept."""
    n2 = accum + g * g
    w.copy_(w - lr * g * _rsqrt(n2 + 1e-7))
    accum.copy_(n2)


class Trainer:
    """Params (a flat {path: tensor} dict, the program's key paths), the
    optimizers' slots and step counts, and ``step``."""

    def __init__(self, model: Model, config, params: Dict[str, torch.Tensor]):
        mc = config.model
        self.model = model
        self.params = params
        decay_steps = max(float(config.train["num_examples"])
                          / model.batch_size, 1.0)
        self.lin_spec = mc["linear_optimizer"]
        self.dnn_spec = mc["dnn_optimizer"]
        if self.lin_spec["name"] != "Ftrl" or self.dnn_spec["name"] != (
                "Adagrad"):
            raise ValueError("the reference runs FTRL (linear) and Adagrad "
                             "(dnn)")

        def schedule(arm, spec):
            return exponential_decay(
                spec.get("learning_rate", mc[f"{arm}_initial_learning_rate"]),
                mc.get(f"{arm}_decay_rate", 1.0), decay_steps)
        self.lin_lr = schedule("linear", self.lin_spec)
        self.dnn_lr = schedule("dnn", self.dnn_spec)
        self.sparse = {f"dnn/embed/d{d}" for d in model.sparse_dims}
        self.slots: Dict[str, Dict[str, torch.Tensor]] = {}
        # each slot's initial value, before its rounding to the param's dtype
        self.slot_inits: Dict[str, Dict[str, float]] = {}
        for path, t in params.items():
            if path.startswith("linear/"):
                acc0 = self.lin_spec.get("initial_accumulator_value", 0.1)
                self.slots[path] = {
                    "accum": torch.full_like(t, acc0).to(torch.float32),
                    "linear": torch.zeros_like(t, dtype=torch.float32)}
                self.slot_inits[path] = {"accum": acc0, "linear": 0.0}
            else:
                acc0 = self.dnn_spec.get("initial_accumulator_value", 0.1)
                self.slots[path] = {"accum": torch.full_like(t, acc0)}
                self.slot_inits[path] = {"accum": acc0}
        self.counts = {"linear": 0, "dnn": 0, "sparse": 0}
        self.losses: List[float] = []
        self.first_grads: Optional[Dict[str, torch.Tensor]] = None

    def step(self, batch: Dict[str, torch.Tensor]) -> float:
        leaves = list(self.params.items())
        for _, t in leaves:
            t.requires_grad_(True)
        loss = self.model.loss(self.params, batch)
        grads = torch.autograd.grad(loss, [t for _, t in leaves],
                                    allow_unused=True)
        grads = {p: (g if g is not None else torch.zeros_like(t))
                 for (p, t), g in zip(leaves, grads)}
        for _, t in leaves:
            t.requires_grad_(False)
        if self.first_grads is None:
            self.first_grads = {p: g.detach() for p, g in grads.items()}
        with torch.no_grad():
            lin_lr = self.lin_lr(self.counts["linear"])
            dnn_lr = self.dnn_lr(self.counts["dnn"])
            sparse_lr = self.dnn_lr(self.counts["sparse"])
            for path, w in self.params.items():
                g = grads[path]
                s = self.slots[path]
                if path.startswith("linear/"):
                    ftrl_(self.lin_spec, lin_lr, w, g, s["accum"],
                          s["linear"], first=self.counts["linear"] == 0)
                elif path in self.sparse:
                    adagrad_rows_(sparse_lr, w, g.float(), s["accum"])
                else:
                    adagrad_(dnn_lr, w, g, s["accum"])
            for k in self.counts:
                self.counts[k] += 1
        value = float(loss.detach())
        self.losses.append(value)
        return value
