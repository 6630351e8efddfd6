"""Optimizers: the seven of model.yaml (Ftrl, Adagrad, ProximalAdagrad,
Adam, RMSProp, SGD, Momentum) per arm, each with exponential LR decay
(port of wide_deep_tpu/optim/__init__.py).

Semantics follow the JAX package exactly, not ``torch.optim``:

* FTRL-Proximal, TF ApplyFtrl form (optim/__init__.py:52-95 there), and
  ProximalAdagrad, TF ApplyProximalAdagrad form (:104-142 there): their
  slots are kept in float32, as the JAX package's are after its first
  update, the accumulator starting at 0.1 rounded to the param's dtype.
* The rest as optax 0.2.6 computes them (:172-187 there), every step in
  the param's dtype (bfloat16 for bfloat16 tables and dense layers), each
  Python constant rounded to that dtype first, as JAX's weak-typed
  scalars are, and the learning rate cast to it before it scales:
  - Adagrad (``scale_by_rss``): accumulator initialised to 0.1,
    ``n += g^2``, ``w += (-lr) * g * rsqrt(n + 1e-7)``;
  - Adam (``scale_by_adam``): ``mu`` and ``nu`` start at 0,
    ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 + b2 nu``, bias
    corrections ``1 - b^(count+1)`` computed in float32 and cast,
    ``w += (-lr) * (mu_hat / (sqrt(nu_hat) + eps))``;
  - RMSProp (``scale_by_rms``, ``eps`` inside the root, initial scale 0):
    ``nu = (1-d) g^2 + d nu``, ``u = (-lr) * (rsqrt(nu + eps) * g)``, then
    with ``momentum > 0`` the ``trace`` ``t = u + m t``, ``u = t`` (optax
    keeps a trace at momentum 0 too, where it is the identity);
  - SGD: ``w += (-lr) * g``; Momentum (``trace(m)`` then the LR):
    ``t = g + m t``, ``w += (-lr) * t``.
* Each arm's decay and Adam's bias correction run on that arm's own step
  count, read before it increments.
* Every optimizer gives the same bits on the card as on the host: roots
  are taken in float64 and rounded once (``_sqrt``; ``_rsqrt`` is the
  reciprocal of that root), and divisions by a scalar divide by a scalar
  held on the tensor's device (``_on``): the card multiplies by the
  reciprocal of a host scalar, and neither its float32 root nor its
  rsqrt is correctly rounded.

``JointOptimizer`` partitions the param tree by its top-level arm key and
updates in place; paths handled by the fused sparse optimizer
(optim/sparse.py) are left out.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Tuple

import torch

Schedule = Callable[[int], torch.Tensor]
SUPPORTED = ("Adagrad", "Adam", "Ftrl", "RMSProp", "SGD", "Momentum",
             "ProximalAdagrad")


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


def _ftrl_(spec, lr, w, g, n, z, first: bool = False):
    """One FTRL step in place on (w, n, z); n and z are float32.
    ``first``: the arm's first step, where the JAX package's accumulator
    still has the param's dtype, so its root is taken in that dtype."""
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


def _proximal_adagrad_(spec, lr, w, g, n):
    """One ProximalAdagrad step in place on (w, n)."""
    l1 = spec.get("l1_regularization_strength", 0.0)
    l2 = spec.get("l2_regularization_strength", 0.0)
    g = g.float()
    n.add_(g * g)
    adj = lr * _rsqrt(n)
    prox = w - adj * g
    w_new = (torch.sign(prox) * torch.clamp(torch.abs(prox) - adj * l1,
                                            min=0.0) / (1.0 + adj * l2))
    w.add_((w_new - w).to(w.dtype))


def _adagrad_(lr, w, g, s, eps: float = 1e-7):
    """One optax Adagrad step in place on (w, s), in the param's dtype."""
    s.copy_(g * g + s)
    inv = torch.where(s > 0, _rsqrt(s + eps), torch.zeros_like(s))
    u = (-lr).to(g.dtype) * (inv * g)
    w.copy_((w + u).to(w.dtype))


def _const(x: float, dtype: torch.dtype) -> torch.Tensor:
    """A Python constant as JAX's weak-typed scalar meets a ``dtype``
    array: rounded to ``dtype`` first."""
    return torch.tensor(x, dtype=dtype)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The square root correctly rounded to ``x``'s dtype, on the card as
    on the host: taken in float64 and rounded once (neither the card's
    float32 root nor torch's vectorized host one is correctly rounded; a
    float64 root rounded to float32 or bfloat16 is)."""
    return torch.sqrt(x.double()).to(x.dtype)


def _rsqrt(x: torch.Tensor) -> torch.Tensor:
    """``torch.rsqrt`` as the host computes it for float32, on the card as
    on the host: the root taken in float64 and rounded once to float32
    (for a bfloat16 ``x`` too), its reciprocal correctly rounded, then
    rounded to ``x``'s dtype (the card's rsqrt is an approximation)."""
    return torch.sqrt(x.double()).float().reciprocal().to(x.dtype)


def _on(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim ``t`` as a tensor on ``like``'s device, made by a fill: a
    division by a host scalar runs on the card as a multiplication by its
    reciprocal, which rounds otherwise than the host's division."""
    return torch.full((), float(t), dtype=t.dtype, device=like.device)


def _adam_(spec, lr, count: int, w, g, mu, nu):
    """One optax Adam step in place on (w, mu, nu), in the param's dtype;
    ``count``: the arm's count before this step."""
    b1 = spec.get("beta1", 0.9)
    b2 = spec.get("beta2", 0.999)
    eps = spec.get("epsilon", 1e-8)
    dt = mu.dtype
    mu.copy_(_const(1 - b1, dt) * g + _const(b1, dt) * mu)
    nu.copy_(_const(1 - b2, dt) * (g * g) + _const(b2, dt) * nu)
    k = torch.tensor(float(count + 1), dtype=torch.float32)
    bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** k
    bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** k
    u = ((mu / _on(bc1.to(dt), mu))
         / (_sqrt(nu / _on(bc2.to(dt), nu)) + _const(eps, dt)))
    w.copy_(w + (-lr).to(dt) * u)


def _rmsprop_(spec, lr, w, g, nu, trace=None):
    """One optax RMSProp step in place on (w, nu[, trace])."""
    decay = spec.get("decay", 0.9)
    eps = spec.get("epsilon", 1e-10)
    dt = nu.dtype
    nu.copy_(_const(1 - decay, dt) * (g * g) + _const(decay, dt) * nu)
    inv = _rsqrt(nu + _const(eps, dt))
    u = (-lr).to(dt) * (inv * g)
    if trace is not None:
        trace.copy_(u + _const(spec["momentum"], dt) * trace)
        u = trace
    w.copy_(w + u)


def _sgd_(lr, w, g, trace=None, momentum: float = 0.0):
    """One optax SGD step in place on w; with ``trace`` (Momentum) the
    trace ``t = g + m t`` is the step's direction."""
    if trace is not None:
        trace.copy_(g + _const(momentum, trace.dtype) * trace)
        g = trace
    w.copy_(w + (-lr).to(g.dtype) * g)


def slot_inits(spec) -> Dict[str, Tuple[float, Any]]:
    """The per-leaf slots of an optimizer: {name: (initial value, dtype)},
    dtype None meaning the param's own."""
    name = spec["name"]
    acc0 = spec.get("initial_accumulator_value", 0.1)
    if name == "Ftrl":
        return {"accum": (acc0, torch.float32),
                "linear": (0.0, torch.float32)}
    if name == "Adagrad":
        return {"accum": (acc0, None)}
    if name == "ProximalAdagrad":
        return {"accum": (acc0, torch.float32)}
    if name == "Adam":
        return {"mu": (0.0, None), "nu": (0.0, None)}
    if name == "RMSProp":
        trace = {"trace": (0.0, None)} if spec.get("momentum", 0.0) else {}
        return {"nu": (0.0, None), **trace}
    if name == "Momentum":
        return {"trace": (0.0, None)}
    if name == "SGD":
        return {}
    raise ValueError(f"unknown optimizer `{name}`")


def leaf_update_(spec, lr, count: int, w, g, slots: Dict[str, Any]) -> None:
    """One step of optimizer ``spec`` on one leaf, in place on ``w`` and
    its ``slots`` (``slot_inits``' names); ``lr`` is the arm's schedule at
    ``count``, the arm's count before this step."""
    name = spec["name"]
    if name == "Ftrl":
        _ftrl_(spec, lr, w, g, slots["accum"], slots["linear"],
               first=count == 0)
    elif name == "ProximalAdagrad":
        _proximal_adagrad_(spec, lr, w, g, slots["accum"])
    elif name == "Adagrad":
        _adagrad_(lr, w, g, slots["accum"])
    elif name == "Adam":
        _adam_(spec, lr, count, w, g, slots["mu"], slots["nu"])
    elif name == "RMSProp":
        _rmsprop_(spec, lr, w, g, slots["nu"], slots.get("trace"))
    elif name == "Momentum":
        _sgd_(lr, w, g, slots["trace"], spec.get("momentum", 0.9))
    else:
        _sgd_(lr, w, g)


class JointOptimizer:
    """Per-arm optimizers over one loss, partitioned by top-level key: each
    of ``linear``, ``dnn`` and ``cnn`` present in ``arms`` takes its
    ``<arm>_optimizer``, ``<arm>_initial_learning_rate`` and
    ``<arm>_decay_rate`` from model.yaml."""

    def __init__(self, model_conf: Dict[str, Any], decay_steps: float,
                 arms: Dict[str, bool], sparse_paths=frozenset()):
        self.arms = {}
        for arm in ("linear", "dnn", "cnn"):
            if not arms.get(arm):
                continue
            spec = model_conf[f"{arm}_optimizer"]
            if spec["name"] not in SUPPORTED:
                raise ValueError(f"unknown optimizer `{spec['name']}`")
            lr0 = spec.get("learning_rate",
                           model_conf[f"{arm}_initial_learning_rate"])
            self.arms[arm] = (spec, exponential_decay(
                lr0, model_conf.get(f"{arm}_decay_rate", 1.0), decay_steps))
        self.sparse_paths = frozenset(sparse_paths)

    def leaves(self, params, arm: str):
        """(path, tensor) of one arm's densely updated params."""
        return [(p, t) for p, t in tree_items(params[arm], (arm,))
                if p not in self.sparse_paths]

    def init(self, params) -> Dict[str, Any]:
        state: Dict[str, Any] = {}
        for arm, (spec, _) in self.arms.items():
            leaves = self.leaves(params, arm)
            st: Dict[str, Any] = {"count": 0}
            for slot, (value, dtype) in slot_inits(spec).items():
                # the value is rounded to the param's dtype first, as
                # optax's full_like does
                st[slot] = {p: torch.full_like(t, value).detach().to(
                                dtype or t.dtype)
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
            names = list(slot_inits(spec))
            for path, w in self.leaves(params, arm):
                leaf_update_(spec, lr, st["count"], w, grads[path],
                             {k: st[k][path] for k in names})
            st["count"] += 1


def build_joint_optimizer(model_conf: Dict[str, Any], decay_steps: float,
                          arms: Dict[str, bool],
                          sparse_paths=frozenset()) -> JointOptimizer:
    return JointOptimizer(model_conf, decay_steps, arms, sparse_paths)
