"""The plain reference of the wide & deep model: forward, loss and
gradients in plain PyTorch, with no kernel, no kernel plan and no fused
table layout.

It follows the semantics of wide_deep_tpu_torch/models/{deep,linear,joint,
heads}.py at commit 5396835d8e2c28384b317c5c7862110fa5df19db on one device,
as the configuration states them:

* Embedding tables are stored in ``embedding_dtype``; the one table under
  the touched-rows optimizer (``plan.sparse_opt_group``) in float32, its
  gathered rows rounded to ``embedding_dtype``.
* A table's gradient is the float32 sum of its per-entry cotangents, each
  rounded to the table's dtype first, rounded once to the table's dtype
  (``Gather``).  The folded wide columns are gathered rounded to the
  embedding dtype; their gradient is rounded likewise where the program
  sums the group by a kernel plan (``plan.kernel_planned``), else summed
  in float32.
* The MLP multiplies ``dense_dtype``-rounded operands in float32 (TF32 off)
  and rounds each layer's output to ``dense_dtype``; BatchNorm takes the
  masked batch moments; the loss is the weighted mean sigmoid
  cross-entropy.

``lowp`` runs the same model with every value that the configuration
rounds to bfloat16 rounded to fp8 (e4m3, one scale a tensor) instead: the
control that a comparison has to fail.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .plan import FeaturePlan, fold_enabled

BN_EPS = 1e-3
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FP8_MAX = 448.0


def _pinned_budget(budget):
    if str(budget).lower() == "auto":
        raise ValueError("the reference takes a pinned pack_budget: auto "
                         "sizes the pools from a data file")
    return budget


class Gather(torch.autograd.Function):
    """``table.index_select(0, ids)``; the gradient is the float32 sum of
    the cotangents (in the table's dtype), rounded once to that dtype."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.shape = (table.shape, table.dtype)
        return table.index_select(0, ids)

    @staticmethod
    def backward(ctx, ct):
        (ids,) = ctx.saved_tensors
        shape, dtype = ctx.shape
        g = torch.zeros(shape, dtype=torch.float32, device=ct.device)
        g.index_add_(0, ids, ct.to(dtype).float())
        return g.to(dtype), None


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
    """The model of one configuration; params are a nested dict with the
    program's key paths (``leaf_specs``)."""

    def __init__(self, config, batch_size: int, lowp: bool = False):
        model_conf = config.model
        train = config.train
        self.plan = FeaturePlan(
            config, multivalue=train["multivalue"],
            fold=fold_enabled(config, "wide_deep"),
            pack_budget=_pinned_budget(train.get("pack_budget")),
            pallas_scatter=str(train.get("scatter_mode") or "pallas")
            == "pallas",
            sparse_opt=bool(train.get("sparse_optimizer")))
        self.batch_size = batch_size
        self.dtype = DTYPES[model_conf.get("dense_dtype") or "float32"]
        self.emb_dtype = DTYPES[model_conf.get("embedding_dtype")
                                or "float32"]
        hidden = model_conf["dnn_hidden_units"]
        if hidden and isinstance(hidden[0], list):
            raise ValueError("the reference runs one tower")
        if (model_conf.get("dnn_connected_mode") or "simple") != "simple":
            raise ValueError("the reference runs dnn_connected_mode: simple")
        if (model_conf.get("dnn_activation_function") or "relu") != "relu":
            raise ValueError("the reference runs relu")
        if model_conf.get("dnn_dropout") or model_conf.get(
                "dnn_l1") or model_conf.get("dnn_l2"):
            raise ValueError("the reference runs without dropout or "
                             "penalties")
        self.hidden = tuple(int(h) for h in hidden)
        self.batch_norm = bool(model_conf.get("dnn_batch_normalization"))
        self.fm = int(model_conf.get("linear_fm_factors") or 0)
        self.lowp = lowp
        plan = self.plan
        self.sparse_dims = {g.dim for g in plan.groups
                            if plan.sparse_opt_group(g, batch_size)}
        self.planned_dims = {g.dim for g in plan.groups
                             if plan.kernel_planned(g, batch_size)}
        self.ind_rows = np.asarray(plan.indicator_wide_rows, np.int64)

    # --------------------------------------------------------------- leaves
    def leaf_specs(self) -> List[Tuple[str, Tuple[int, ...], Any, str]]:
        """(path, shape, dtype, init) of every param leaf, in the program's
        key order; init is one of embedding, glorot, zeros, ones, fm."""
        plan = self.plan
        out = []
        for g in plan.groups:
            dt = torch.float32 if g.dim in self.sparse_dims else self.emb_dtype
            out.append((f"dnn/embed/d{g.dim}", (g.rows, g.dim), dt,
                        "embedding"))
        width = plan.deep_input_dim
        for j, units in enumerate(self.hidden):
            out.append((f"dnn/towers/0/hidden/{j}/kernel", (width, units),
                        torch.float32, "glorot"))
            out.append((f"dnn/towers/0/hidden/{j}/bias", (units,),
                        torch.float32, "zeros"))
            if self.batch_norm:
                out.append((f"dnn/towers/0/bn/{j}/scale", (units,),
                            torch.float32, "ones"))
                out.append((f"dnn/towers/0/bn/{j}/bias", (units,),
                            torch.float32, "zeros"))
            width = units
        out.append(("dnn/towers/0/logits/kernel", (width, 1), torch.float32,
                    "glorot"))
        out.append(("dnn/towers/0/logits/bias", (1,), torch.float32,
                    "zeros"))
        out.append(("linear/w", (plan.wide_dim, 1), torch.float32, "zeros"))
        out.append(("linear/b", (1,), torch.float32, "zeros"))
        for g in plan.groups:
            if plan.fold and g.folded:
                out.append((f"linear/fold/d{g.dim}", (g.rows, 1),
                            torch.float32, "zeros"))
        if self.fm:
            out.append(("linear/v", (plan.wide_dim, self.fm), torch.float32,
                        "fm"))
        return out

    # -------------------------------------------------------------- forward
    def _q(self, x: torch.Tensor) -> torch.Tensor:
        return _Fp8.apply(x) if self.lowp else x

    def _round(self, x: torch.Tensor, dtype) -> torch.Tensor:
        """``x`` in ``dtype``; under ``lowp`` a bfloat16 value goes
        through fp8 first."""
        if self.lowp and dtype == torch.bfloat16:
            x = _Fp8.apply(x)
        return x.to(dtype)

    def _dense(self, x, kernel, bias):
        dt = self.dtype
        y = torch.matmul(self._round(x, dt).float(),
                         self._round(kernel, dt).float()) + bias
        return self._round(y, dt)

    def _batch_norm(self, x, scale, bias, mask):
        """Training mode: the masked batch moments."""
        xf = x.float()
        m = mask.float()[:, None]
        denom = torch.clamp(torch.sum(m), min=1.0)
        mean = torch.sum(xf * m, dim=0) / denom
        var = torch.sum(m * (xf - mean) ** 2, dim=0) / denom
        inv = torch.rsqrt(var + BN_EPS)
        return ((xf - mean) * inv * scale + bias).to(x.dtype)

    def logits(self, p: Dict[str, torch.Tensor],
               batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        plan = self.plan
        B = batch["mask"].shape[0]
        ind = None
        if plan.indicator_dim:
            ids = batch["ind_ids"].long()
            ind = torch.zeros((B, plan.indicator_dim), dtype=torch.float32,
                              device=ids.device).scatter_add_(
                1, ids, batch["ind_wts"].float())
        parts = []
        fold_wide = None
        for g in plan.groups:
            ids2 = batch[f"emb_ids_d{g.dim}"]
            wts = batch[f"emb_wts_d{g.dim}"]
            seg = batch[f"emb_seg_d{g.dim}"]
            P = ids2.shape[1]
            ids = ids2.reshape(-1).long()
            table = p[f"dnn/embed/d{g.dim}"]
            gathered = Gather.apply(table, ids)
            if g.dim in self.sparse_dims:
                gathered = self._round(gathered, self.emb_dtype)
            else:
                gathered = self._q(gathered)
            if plan.fold and g.folded:
                fcol = p[f"linear/fold/d{g.dim}"]
                if g.dim in self.planned_dims:
                    wide_rows = Gather.apply(fcol.to(table.dtype),
                                             ids).to(fcol.dtype)
                else:
                    rounded = fcol + (fcol.to(table.dtype).to(fcol.dtype)
                                      - fcol).detach()
                    wide_rows = Gather.apply(rounded, ids)
                presence = (wts > 0).float()
                fw = torch.einsum("bpn,bp->bn",
                                  wide_rows.float().reshape(B, P, -1),
                                  presence)
                fold_wide = fw if fold_wide is None else fold_wide + fw
            weighted = gathered.float().reshape(B, P, g.dim) * wts[..., None]
            onehot = F.one_hot(seg.long(), len(g.slots)).float()
            combined = torch.einsum("blf,bld->bfd", onehot, weighted)
            parts.append(self._round(combined.reshape(B, -1), self.dtype))
        if ind is not None:
            parts.append(self._round(ind, self.dtype))
        if plan.continuous_slots:
            parts.append(self._round(batch["cont"], self.dtype))
        net = torch.cat(parts, dim=-1)
        for j, _ in enumerate(self.hidden):
            h = self._dense(net, p[f"dnn/towers/0/hidden/{j}/kernel"],
                            p[f"dnn/towers/0/hidden/{j}/bias"])
            h = torch.relu(h)
            if self.batch_norm:
                h = self._batch_norm(h, p[f"dnn/towers/0/bn/{j}/scale"],
                                     p[f"dnn/towers/0/bn/{j}/bias"],
                                     batch["mask"])
            net = h
        logits = self._dense(net, p["dnn/towers/0/logits/kernel"],
                             p["dnn/towers/0/logits/bias"]).float()
        if fold_wide is not None:
            logits = logits + fold_wide
        # the wide arm
        w = p["linear/w"]
        wids = batch["wide_ids"]
        L = wids.shape[1]
        wg = Gather.apply(w, wids.reshape(-1).long()).reshape(B, L, -1)
        out = torch.einsum("bln,bl->bn", wg, batch["wide_wts"])
        rows = None
        if ind is not None:
            rows = torch.from_numpy(self.ind_rows).to(w.device)
            out = out + torch.matmul(ind, w.index_select(0, rows))
        if self.fm:
            out = out + self._fm_term(p["linear/v"], batch, ind,
                                      rows)[:, None]
        return logits + (out + p["linear/b"])

    def _fm_term(self, v, batch, ind, rows):
        ids = batch["wide_ids"]
        B, L = ids.shape
        gathered = Gather.apply(v, ids.reshape(-1).long()).reshape(B, L, -1)
        wts = batch["wide_wts"][..., None]
        s1 = (gathered * wts).sum(dim=1)
        s2 = ((gathered ** 2) * (wts ** 2)).sum(dim=1)
        if ind is not None:
            v_ind = v.index_select(0, rows)
            s1 = s1 + torch.matmul(ind, v_ind)
            s2 = s2 + torch.matmul(ind ** 2, v_ind ** 2)
        return 0.5 * (s1 ** 2 - s2).sum(dim=-1)

    def loss(self, p, batch) -> torch.Tensor:
        z = self.logits(p, batch)[:, 0]
        y = batch["label"].float()
        per_ex = F.softplus(-z) + z * (1.0 - y)
        w = (batch["weight"] * batch["mask"]).float()
        return torch.sum(per_ex * w) / torch.clamp(torch.sum(w), min=1e-12)


def init_leaf(spec: Tuple[str, Tuple[int, ...], Any, str], gen_for,
              device, rows_per_call: int) -> torch.Tensor:
    """One param leaf made from its init rule, ``rows_per_call`` rows a
    call, each block from its own generator ``gen_for(block)``: a block can
    be made again alone.  Embedding: N(0, 1) cut to [-2, 2], over the root
    of the width; glorot: U(-l, l), l = sqrt(6 / (fan_in + fan_out)); fm:
    0.01 N(0, 1); zeros; ones."""
    path, shape, dtype, kind = spec
    out = torch.empty(shape, dtype=dtype, device=device)
    for k, lo in enumerate(range(0, shape[0], rows_per_call)):
        out[lo:lo + rows_per_call] = init_block(spec, k, gen_for(k), device,
                                                rows_per_call)
    return out


def init_block(spec, block: int, gen, device, rows_per_call: int
               ) -> torch.Tensor:
    """Rows ``[block * rows_per_call, ...)`` of a leaf (``init_leaf``)."""
    _, shape, dtype, kind = spec
    lo = block * rows_per_call
    n = min(rows_per_call, shape[0] - lo)
    sub = (n,) + tuple(shape[1:])
    t = torch.empty(sub, dtype=torch.float32, device=device)
    if kind == "embedding":
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        t.div_(math.sqrt(shape[1]))
    elif kind == "glorot":
        limit = math.sqrt(6.0 / (shape[0] + shape[1]))
        t.uniform_(-limit, limit, generator=gen)
    elif kind == "fm":
        t.normal_(generator=gen).mul_(0.01)
    elif kind == "ones":
        t.fill_(1.0)
    else:
        t.zero_()
    return t.to(dtype)
