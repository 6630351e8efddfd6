"""The plain reference of DLRM with a DCN-V2 interaction (Naumov et al.,
arXiv:1906.00091; Wang et al., arXiv:2008.13535): the parse of the rows,
the forward, the loss, the gradients and the optimizers in plain PyTorch,
float32 with TF32 off, with no kernel, no kernel plan, no fused table and
nothing of the program under test.

The model, as a configuration's yaml states it:

* Dense features (continuous, ``log1p``: log(max(x, 0) + 1), a missing
  cell 0) through the bottom MLP (``dnn_bottom_units``, ReLU after each
  layer).
* Each categorical feature (``hash_bucket``) keeps up to min(``max_len``,
  ``pack_budget``) values of its cell, hashed by XXH64 into its own rows;
  the tables lie one after another in feature order in one table of
  ``embedding_dim`` columns (rows padded to a multiple of 256), float32,
  its rows rounded to ``embedding_dtype`` when read; a feature pools its
  rows by their sum (``combiner: sum``) or mean.
* ``x0`` = [bottom output, pooled rows in feature order], the cross layers
  ``x_{l+1} = x0 * (W_l (V_l x_l) + b_l) + x_l``, the top MLP with ReLU and
  its logit; every product takes ``dense_dtype``-rounded operands, sums in
  float32 and rounds its output to ``dense_dtype``; the products with x0
  and the residual sums are float32, the cross output rounded once.
* The loss is the mean sigmoid cross-entropy.
* The optimizers: Adagrad on the dense leaves (accumulator at the initial
  value, ``n += g^2``, ``w -= lr g / sqrt(n + 1e-7)``) and the row-wise
  Adagrad of ``dnn_embedding_optimizer`` on the table (one accumulator a
  row at the initial value, ``a += mean_j g_j^2``, ``w -= lr g / sqrt(a +
  1e-7)``), on the rows a step touches; each at a constant rate.

The table is held only at the rows the batches given to ``Trainer`` touch
(``held_rows``): a step leaves every other row as it was.

``lowp`` runs the same model with every value that the configuration
rounds to bfloat16 rounded to fp8 (e4m3, one scale a tensor) instead: the
control that a comparison has to fail.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import yaml

from .hashing import fingerprint64_str

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FP8_MAX = 448.0
ROW_ALIGN = 256
EPS = 1e-7


def _yaml(conf_dir: str, name: str) -> Any:
    with open(os.path.join(conf_dir, name + ".yaml")) as f:
        return yaml.safe_load(f) or {}


def _opt(value, lr: float) -> Dict[str, Any]:
    spec = dict(value) if isinstance(value, dict) else {"name": str(value)}
    spec.setdefault("learning_rate", lr)
    return spec


class Spec:
    """What the model takes from a configuration's yaml."""

    def __init__(self, conf_dir: str):
        schema = _yaml(conf_dir, "schema")
        cols = [str(c).lower() for c in schema["columns"]]
        self.column = {c: i for i, c in enumerate(cols)}
        train = _yaml(conf_dir, "train")["train"]
        self.batch_size = int(train["batch_size"])
        budget = train.get("pack_budget")
        self.budget = 3 if budget in (None, "") else int(budget)
        if not train.get("multivalue"):
            raise ValueError("the reference reads multi-valued cells")
        self.dense: List[str] = []
        self.sparse: List[Tuple[str, int, int, bool]] = []  # name rows L sum
        dims = set()
        for name, conf in (_yaml(conf_dir, "feature") or {}).items():
            name = str(name).lower()
            if conf["type"] == "continuous":
                if conf.get("transform") != "log1p":
                    raise ValueError("the reference's dense features are "
                                     "log1p counts")
                self.dense.append(name)
                continue
            if conf.get("transform") != "hash_bucket":
                raise ValueError("the reference's categorical features are "
                                 "hash_bucket")
            dims.add(int(conf["embedding_dim"]))
            keep = min(int(conf.get("max_len", 1)), self.budget)
            self.sparse.append((name, int(conf["parameter"]), keep,
                                conf.get("combiner") == "sum"))
        if len(dims) != 1:
            raise ValueError("the reference takes one embedding width")
        self.dim = dims.pop()
        self.offsets = np.cumsum([0] + [r for _, r, _, _ in self.sparse])
        self.table_rows = -(-int(self.offsets[-1]) // ROW_ALIGN) * ROW_ALIGN
        self.pool = sum(k for _, _, k, _ in self.sparse)
        mc = _yaml(conf_dir, "model")
        lr = float(mc.get("dnn_initial_learning_rate") or 0.05)
        self.dnn_opt = _opt(mc["dnn_optimizer"], lr)
        self.emb_opt = _opt(mc["dnn_embedding_optimizer"], lr)
        if (self.dnn_opt["name"], self.emb_opt["name"]) != (
                "Adagrad", "RowwiseAdagrad"):
            raise ValueError("the reference runs Adagrad (dense) and "
                             "RowwiseAdagrad (table)")
        if mc.get("dnn_decay_rate") not in (None, 0, 1, 1.0):
            raise ValueError("the reference runs constant rates")
        if mc.get("dnn_batch_normalization") or mc.get("dnn_dropout"):
            raise ValueError("the reference runs without BN or dropout")
        self.bottom = tuple(int(u) for u in mc["dnn_bottom_units"])
        inter = mc["dnn_interaction"]
        self.cross_layers = int(inter["layers"])
        self.rank = int(inter["rank"])
        self.top = tuple(int(u) for u in mc["dnn_hidden_units"])
        self.dtype = DTYPES[mc.get("dense_dtype") or "float32"]
        self.emb_dtype = DTYPES[mc.get("embedding_dtype") or "float32"]
        self.x0_width = self.bottom[-1] + len(self.sparse) * self.dim

    def leaf_specs(self) -> List[Tuple[str, Tuple[int, ...], Any, str]]:
        """(path, shape, dtype, init) of every param leaf under the
        program's key paths; init is embedding, glorot or zeros."""
        out = [("dnn/embed/d%d" % self.dim, (self.table_rows, self.dim),
                torch.float32, "embedding")]

        def dense(path, fan_in, units, bias=True):
            out.append((f"{path}/kernel", (fan_in, units), torch.float32,
                        "glorot"))
            if bias:
                out.append((f"{path}/bias", (units,), torch.float32,
                            "zeros"))
        width = len(self.dense)
        for j, units in enumerate(self.bottom):
            dense(f"dnn/bottom/{j}", width, units)
            width = units
        w = self.x0_width
        for layer in range(self.cross_layers):
            dense(f"dnn/cross/{layer}/down", w, self.rank, bias=False)
            dense(f"dnn/cross/{layer}/up", self.rank, w)
        for j, units in enumerate(self.top):
            dense(f"dnn/towers/0/hidden/{j}", w, units)
            w = units
        dense("dnn/towers/0/logits", w, 1)
        return out


# ------------------------------------------------------------------ parse
def parse_lines(spec: Spec, lines: Sequence[str]) -> Dict[str, np.ndarray]:
    """TSV rows -> {label [B], cont [B, n_dense] float32, ids [B, pool]
    int64 table rows, wts [B, pool] float32}: a feature's values in its own
    columns of the pool (``Spec.sparse``'s order, ``keep`` each), unfilled
    places weight 0."""
    B = len(lines)
    cells = [ln.split("\t") for ln in lines]
    label = np.array([1.0 if c[0] == "1" else 0.0 for c in cells],
                     np.float32)
    cont = np.zeros((B, len(spec.dense)), np.float32)
    for j, name in enumerate(spec.dense):
        col = spec.column[name]
        for b, c in enumerate(cells):
            cont[b, j] = _log1p_count(c[col])
    ids = np.zeros((B, spec.pool), np.int64)
    wts = np.zeros((B, spec.pool), np.float32)
    at = 0
    for f, (name, rows, keep, summed) in enumerate(spec.sparse):
        col = spec.column[name]
        cache: Dict[str, int] = {}
        off = int(spec.offsets[f])
        for b, c in enumerate(cells):
            cell = c[col]
            values = [""] if cell in ("", "-") else cell.split(",")[:keep]
            w = 1.0 if summed else 1.0 / len(values)
            for k, v in enumerate(values):
                h = cache.get(v)
                if h is None:
                    h = cache[v] = off + fingerprint64_str(v) % rows
                ids[b, at + k] = h
                wts[b, at + k] = w
        at += keep
    return {"label": label, "cont": cont, "ids": ids, "wts": wts}


def _log1p_count(cell: str) -> float:
    if cell in ("", "-"):
        return 0.0
    try:
        x = float(cell)
    except ValueError:
        return 0.0
    return float(np.log1p(max(x, 0.0))) if math.isfinite(x) else 0.0


def held_rows(batches: Sequence[Dict[str, np.ndarray]]) -> np.ndarray:
    """The sorted table rows the batches' live entries touch."""
    return np.unique(np.concatenate(
        [b["ids"][b["wts"] != 0] for b in batches]))


# ---------------------------------------------------------------- forward
class _Fp8(torch.autograd.Function):
    """Forward: rounded to fp8 e4m3 at one scale for the tensor (its
    largest magnitude at 448); backward: the cotangent as it is."""

    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().max().float()
        if not torch.isfinite(amax) or float(amax) == 0.0:
            return x.clone()
        scale = amax / FP8_MAX
        q = (x.float() / scale).to(torch.float8_e4m3fn).float() * scale
        return q.to(x.dtype)

    @staticmethod
    def backward(ctx, ct):
        return ct


class Model:
    def __init__(self, spec: Spec, lowp: bool = False):
        self.spec = spec
        self.lowp = lowp
        # float32 products in float32: TF32 keeps ~3 decimal digits
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def _round(self, x, dtype):
        if self.lowp and dtype == torch.bfloat16:
            x = _Fp8.apply(x)
        return x.to(dtype)

    def _dense(self, p, path, x, bias=True):
        dt = self.spec.dtype
        y = torch.matmul(self._round(x, dt).float(),
                         self._round(p[f"{path}/kernel"], dt).float())
        if bias:
            y = y + p[f"{path}/bias"]
        return self._round(y, dt)

    def logits(self, p: Dict[str, torch.Tensor], batch) -> torch.Tensor:
        """``p``'s table is [held rows, dim]; ``batch["slot"]`` maps each
        pool entry to its held row."""
        s = self.spec
        B, P = batch["ids"].shape
        F = len(s.sparse)
        rows = p[f"dnn/embed/d{s.dim}"].index_select(
            0, batch["slot"].reshape(-1))
        rows = self._round(rows, s.emb_dtype).float().reshape(B, P, s.dim)
        weighted = rows * batch["wts"][..., None]
        # each feature's sum over its own columns of the pool, in torch's
        # order for a slice: float32 sums in another order than the
        # program's may round x0 to bfloat16 one ulp apart (PERF.md §2
        # sets the loss limit from such readings)
        starts = np.cumsum([0] + [k for _, _, k, _ in s.sparse])
        pooled = torch.stack([weighted[:, a:b].sum(dim=1)
                              for a, b in zip(starts[:-1], starts[1:])],
                             dim=1)
        emb = self._round(pooled.reshape(B, F * s.dim), s.dtype)
        h = self._round(batch["cont"], s.dtype)
        for j, _ in enumerate(s.bottom):
            h = torch.relu(self._dense(p, f"dnn/bottom/{j}", h))
        x0 = torch.cat([h, emb], dim=1).float()
        x = x0
        for layer in range(s.cross_layers):
            u = self._dense(p, f"dnn/cross/{layer}/down", x, bias=False)
            v = self._dense(p, f"dnn/cross/{layer}/up", u)
            x = x0 * v.float() + x
        h = self._round(x, s.dtype)
        for j, _ in enumerate(s.top):
            h = torch.relu(self._dense(p, f"dnn/towers/0/hidden/{j}", h))
        return self._dense(p, "dnn/towers/0/logits", h).float()

    def loss(self, p, batch) -> torch.Tensor:
        z = self.logits(p, batch)[:, 0]
        y = batch["label"]
        per_ex = torch.nn.functional.softplus(-z) + z * (1.0 - y)
        return per_ex.mean()


def device_batch(spec: Spec, batch: Dict[str, np.ndarray],
                 held: np.ndarray, device) -> Dict[str, torch.Tensor]:
    """A parsed batch on ``device`` with each entry's held row
    (``slot``)."""
    slot = np.searchsorted(held, batch["ids"])
    slot = np.minimum(slot, len(held) - 1)
    return {k: torch.from_numpy(v).to(device)
            for k, v in dict(batch, slot=slot).items()}


# -------------------------------------------------------------- optimizers
def _rsqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x.double()).float().reciprocal().to(x.dtype)


def adagrad_(lr, w, g, s):
    s.copy_(g * g + s)
    inv = torch.where(s > 0, _rsqrt(s + EPS), torch.zeros_like(s))
    w.copy_(w + (-lr).to(g.dtype) * (inv * g))


def rowwise_adagrad_(lr, w, g, a):
    """Rows whose gradient is zero keep their values exactly (their
    accumulator too), so every held row may be swept.  The mean of the
    squares is taken in float64 and rounded once: the exact mean."""
    a.add_(g.double().square().mean(dim=-1, keepdim=True).float())
    w.sub_(lr * g * _rsqrt(a + EPS))


class Trainer:
    """Params ({path: tensor}, the table at its held rows), the slots, the
    losses, the first step's gradients, and ``step``."""

    def __init__(self, model: Model, params: Dict[str, torch.Tensor]):
        s = model.spec
        self.model = model
        self.params = params
        self.table = f"dnn/embed/d{s.dim}"
        self.dnn_lr = torch.tensor(float(s.dnn_opt["learning_rate"]),
                                   dtype=torch.float32)
        self.emb_lr = torch.tensor(float(s.emb_opt["learning_rate"]),
                                   dtype=torch.float32)
        acc_d = s.dnn_opt.get("initial_accumulator_value", 0.1)
        acc_e = s.emb_opt.get("initial_accumulator_value", 0.1)
        self.slot_inits = {p: {"accum": acc_e if p == self.table else acc_d}
                           for p in params}
        self.slots = {
            p: {"accum": torch.full((t.shape[0], 1) if p == self.table
                                    else t.shape, self.slot_inits[p]["accum"],
                                    dtype=torch.float32, device=t.device)}
            for p, t in params.items()}
        self.losses: List[float] = []
        self.first_grads: Optional[Dict[str, torch.Tensor]] = None

    def step(self, batch) -> float:
        leaves = list(self.params.items())
        for _, t in leaves:
            t.requires_grad_(True)
        loss = self.model.loss(self.params, batch)
        grads = torch.autograd.grad(loss, [t for _, t in leaves])
        for _, t in leaves:
            t.requires_grad_(False)
        grads = {p: g for (p, _), g in zip(leaves, grads)}
        if self.first_grads is None:
            self.first_grads = {p: g.detach() for p, g in grads.items()}
        with torch.no_grad():
            for p, w in self.params.items():
                a = self.slots[p]["accum"]
                if p == self.table:
                    touched = torch.zeros(w.shape[0], dtype=torch.bool,
                                          device=w.device)
                    live = batch["wts"].reshape(-1) != 0
                    touched[batch["slot"].reshape(-1)[live]] = True
                    g = grads[p][touched]
                    wr, ar = w[touched], a[touched]
                    rowwise_adagrad_(self.emb_lr, wr, g, ar)
                    w[touched] = wr
                    a[touched] = ar
                else:
                    adagrad_(self.dnn_lr, w, grads[p], a)
        self.losses.append(float(loss.detach()))
        return self.losses[-1]
