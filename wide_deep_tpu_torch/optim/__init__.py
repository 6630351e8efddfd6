"""Optimizers: FTRL, Adagrad and ProximalAdagrad per arm, each with
exponential LR decay (port of wide_deep_tpu/optim/__init__.py; the other
optimizers wait).

Semantics follow the JAX package exactly, not ``torch.optim``:

* FTRL-Proximal, TF ApplyFtrl form (optim/__init__.py:52-95 there).
* ProximalAdagrad, TF ApplyProximalAdagrad form (:104-142 there): the
  accumulator starts at 0.1 rounded to the param's dtype and is kept in
  float32, as the JAX package's is after its first update.
* Adagrad as optax.adagrad: accumulator initialised to 0.1 in the param's
  own dtype (bfloat16 for bfloat16 tables), ``n += g^2``,
  ``w += (-lr) * g * rsqrt(n + 1e-7)``, every step in the param's dtype.
* Each arm's decay runs on that arm's own step count.

``JointOptimizer`` partitions the param tree by its top-level arm key and
updates in place; paths handled by the fused sparse optimizer
(optim/sparse.py) are left out.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Tuple

import torch

Schedule = Callable[[int], torch.Tensor]
SUPPORTED = ("Ftrl", "Adagrad", "ProximalAdagrad")


def exponential_decay(lr0: float, decay_rate: float,
                      decay_steps: float) -> Schedule:
    """TF-style continuous exponential decay, in float32 like the JAX
    package's schedule: lr0 * rate ** (step / decay_steps)."""
    if decay_rate == 1.0 or decay_steps <= 0:
        return lambda step: torch.tensor(lr0, dtype=torch.float32)
    rate = torch.tensor(decay_rate, dtype=torch.float32)
    return lambda step: lr0 * rate ** (
        torch.tensor(step, dtype=torch.float32) / decay_steps)


def tree_items(tree, prefix: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """(path, leaf) pairs of a tree of dicts and lists, in key order."""
    if isinstance(tree, dict):
        for k in tree:
            yield from tree_items(tree[k], prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from tree_items(v, prefix + (i,))
    else:
        yield prefix, tree


def tree_get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def tree_set(tree, path, value):
    """A copy of ``tree`` with the leaf at ``path`` replaced: the dicts and
    lists along the path are copied, every other node is shared."""
    if not path:
        return value
    out = dict(tree) if isinstance(tree, dict) else list(tree)
    out[path[0]] = tree_set(tree[path[0]], path[1:], value)
    return out


def _ftrl_(spec, lr, w, g, n, z):
    """One FTRL step in place on (w, n, z)."""
    l1 = spec.get("l1_regularization_strength", 0.0)
    l2 = spec.get("l2_regularization_strength", 0.0)
    g = g.float()
    n2 = n + g ** 2
    z2 = z + g - (torch.sqrt(n2) - torch.sqrt(n)) / lr * w
    w_new = torch.where(torch.abs(z2) <= l1, torch.zeros_like(w),
                        (torch.sign(z2) * l1 - z2)
                        / (torch.sqrt(n2) / lr + 2 * l2))
    w.add_((w_new - w).to(w.dtype))
    n.copy_(n2)
    z.copy_(z2)


def _proximal_adagrad_(spec, lr, w, g, n):
    """One ProximalAdagrad step in place on (w, n)."""
    l1 = spec.get("l1_regularization_strength", 0.0)
    l2 = spec.get("l2_regularization_strength", 0.0)
    g = g.float()
    n.add_(g * g)
    adj = lr * torch.rsqrt(n)
    prox = w - adj * g
    w_new = (torch.sign(prox) * torch.clamp(torch.abs(prox) - adj * l1,
                                            min=0.0) / (1.0 + adj * l2))
    w.add_((w_new - w).to(w.dtype))


def _adagrad_(lr, w, g, s, eps: float = 1e-7):
    """One optax Adagrad step in place on (w, s), in the param's dtype."""
    s.copy_(g * g + s)
    inv = torch.where(s > 0, torch.rsqrt(s + eps), torch.zeros_like(s))
    u = (-lr).to(g.dtype) * (inv * g)
    w.copy_((w + u).to(w.dtype))


class JointOptimizer:
    """Per-arm optimizers over one loss, partitioned by top-level key."""

    def __init__(self, model_conf: Dict[str, Any], decay_steps: float,
                 arms: Dict[str, bool], sparse_paths=frozenset()):
        self.arms = {}
        for arm in ("linear", "dnn"):
            if not arms.get(arm):
                continue
            spec = model_conf[f"{arm}_optimizer"]
            if spec["name"] not in SUPPORTED:
                raise NotImplementedError(
                    f"{spec['name']} is not ported yet (ported: "
                    f"{SUPPORTED})")
            lr0 = spec.get("learning_rate",
                           model_conf[f"{arm}_initial_learning_rate"])
            self.arms[arm] = (spec, exponential_decay(
                lr0, model_conf.get(f"{arm}_decay_rate", 1.0), decay_steps))
        if arms.get("cnn"):
            raise NotImplementedError("the CNN arm is not ported yet")
        self.sparse_paths = frozenset(sparse_paths)

    def leaves(self, params, arm: str):
        """(path, tensor) of one arm's densely updated params."""
        return [(p, t) for p, t in tree_items(params[arm], (arm,))
                if p not in self.sparse_paths]

    def init(self, params) -> Dict[str, Any]:
        state: Dict[str, Any] = {}
        for arm, (spec, _) in self.arms.items():
            acc0 = spec.get("initial_accumulator_value", 0.1)
            leaves = self.leaves(params, arm)
            accum_dtype = (torch.float32 if spec["name"] == "ProximalAdagrad"
                           else None)
            st = {"count": 0,
                  "accum": {p: torch.full_like(t, acc0).detach().to(
                                accum_dtype or t.dtype)
                            for p, t in leaves}}
            if spec["name"] == "Ftrl":
                st["linear"] = {p: torch.zeros_like(t).detach()
                                for p, t in leaves}
            state[arm] = st
        return state

    @torch.no_grad()
    def update_(self, params, grads: Dict[Tuple, torch.Tensor],
                state: Dict[str, Any]) -> None:
        """One step of every arm, in place on params and state; ``grads``
        maps leaf paths to gradients (zeros where a leaf had none)."""
        for arm, (spec, schedule) in self.arms.items():
            st = state[arm]
            lr = schedule(st["count"])
            for path, w in self.leaves(params, arm):
                g = grads[path]
                if spec["name"] == "Ftrl":
                    _ftrl_(spec, lr, w, g, st["accum"][path],
                           st["linear"][path])
                elif spec["name"] == "ProximalAdagrad":
                    _proximal_adagrad_(spec, lr, w, g, st["accum"][path])
                else:
                    _adagrad_(lr, w, g, st["accum"][path])
            st["count"] += 1


def build_joint_optimizer(model_conf: Dict[str, Any], decay_steps: float,
                          arms: Dict[str, bool],
                          sparse_paths=frozenset()) -> JointOptimizer:
    return JointOptimizer(model_conf, decay_steps, arms, sparse_paths)
