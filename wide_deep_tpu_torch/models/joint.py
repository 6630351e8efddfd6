"""Joint Wide & Deep (& CNN) model (port of wide_deep_tpu/models/joint.py).

The model is a plain object; params and state live outside it as nested
dicts of tensors whose top-level keys (``linear``, ``dnn``, ``cnn``) are
also the per-arm optimizer partition.  ``logits = deep + fold_wide + linear
(+ cnn)``, a logistic head for two classes, softmax otherwise.  State is
``{"bn": ..., "cnn_bn": ...}``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from wide_deep_tpu_torch.features.plan import FeaturePlan, fold_enabled
from wide_deep_tpu_torch.models import heads
from wide_deep_tpu_torch.models.cnn import (CnnSpec, cnn_logits,
                                            init_cnn_params)
from wide_deep_tpu_torch.models.deep import (DTYPES, DeepSpec, ParamStore,
                                             PlanConstants, deep_logits,
                                             indicator_block,
                                             init_deep_params, l2_l1_penalty,
                                             set_parity_precision,
                                             summary_scope)
from wide_deep_tpu_torch.models.linear import init_linear_params, linear_logits

MODEL_TYPES = ("wide", "deep", "wide_deep")


def resolve_device(device=None) -> torch.device:
    """The port's entry points run on the card unless the caller asks for
    the CPU; they never fall back on their own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)


@dataclasses.dataclass
class WideDeep:
    """Model definition (static); params/state live outside."""

    plan: FeaturePlan
    deep_spec: Optional[DeepSpec] = None
    model_type: str = "wide_deep"
    n_classes: int = 2
    cnn_spec: Optional[CnnSpec] = None
    fm_factors: int = 0             # >0 adds the FM pairwise term (wide arm)
    # a mesh of ranks (parallel/exchange.enable_explicit_lookup): the
    # rank's mesh and the paths of the row-sharded params
    mesh: Any = None
    sharded_paths: frozenset = frozenset()

    def __post_init__(self):
        if self.model_type not in MODEL_TYPES:
            raise ValueError(
                f"model_type must be one of {MODEL_TYPES}, got "
                f"{self.model_type!r}")
        if self.model_type != "wide" and self.deep_spec is None:
            raise ValueError(f"model_type {self.model_type} needs a DeepSpec")
        if self.plan.fold and self.model_type == "wide":
            raise ValueError(
                "a folded FeaturePlan carries wide weights in the embedding "
                "tables — model_type 'wide' has none; build the plan with "
                "fold=False (plan.fold_enabled(config, model_type))")
        if self.plan.fold and self.fm_factors:
            raise ValueError(
                "linear_fm_factors needs every wide slot in the id pool; "
                "build the plan with fold=False")
        self.consts = PlanConstants(self.plan)
        self.n_logits = heads.n_logits_for(self.n_classes)

    @property
    def has_wide(self) -> bool:
        return self.model_type in ("wide", "wide_deep")

    @property
    def has_deep(self) -> bool:
        return self.model_type in ("deep", "wide_deep")

    @property
    def has_cnn(self) -> bool:
        return self.cnn_spec is not None

    def sample_batch(self, device) -> Dict[str, torch.Tensor]:
        """A one-row batch of zeros (mask 1) on ``device``, with the
        ``image`` entry when the model has the CNN arm: what ``init`` takes
        its shapes from."""
        cnn = self.cnn_spec
        spec = self.plan.batch_spec(
            1, self.n_classes, with_image=cnn is not None,
            image_shape=cnn.image_shape if cnn else (224, 224, 3))
        sample = {k: torch.zeros(shape, dtype=getattr(torch, dt.__name__),
                                 device=device)
                  for k, (shape, dt) in spec.items()}
        sample["mask"] = torch.ones_like(sample["mask"])
        return sample

    def init(self, seed: int, sample_batch: Dict[str, torch.Tensor],
             device=None) -> Tuple[Dict, Dict]:
        """(params, state) drawn from a ``torch.Generator`` seeded with
        ``seed`` on ``device`` (default: the card); state = {'bn': ...}.
        Shapes come from one forward over the first row of
        ``sample_batch``, which must lie on that device.  On the ``meta``
        device only shapes and dtypes come out and nothing is drawn or
        allocated.  The CNN arm draws last, from ``sample_batch["image"]``,
        so the other arms' weights do not depend on it."""
        device = resolve_device(device)
        gen = torch.Generator(
            device="cpu" if device.type == "meta" else device
        ).manual_seed(int(seed))
        sample = {k: v[:1] for k, v in sample_batch.items()}
        params: Dict[str, Any] = {}
        state: Dict[str, Any] = {}
        if self.has_wide:
            params["linear"] = None     # keeps the arms' key order
        if self.has_deep:
            params["dnn"], state["bn"] = init_deep_params(
                gen, self.plan, self.consts, self.deep_spec, self.n_logits,
                sample, device)
        if self.has_wide:
            # the FM factors are drawn after the deep arm, which so draws
            # the same weights with and without them
            params["linear"] = init_linear_params(
                self.plan, self.n_logits, device, with_fold=self.has_deep,
                fm_factors=self.fm_factors, gen=gen)
        if self.has_cnn:
            params["cnn"], state["cnn_bn"] = init_cnn_params(
                gen, self.cnn_spec, self.n_logits, sample["image"], device)
        return params, state

    def apply(self, params: Dict, state: Dict,
              batch: Dict[str, torch.Tensor], training: bool = False,
              rng: Optional[torch.Generator] = None,
              sinks: Optional[Dict[str, torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, Dict]:
        """Forward pass -> (logits [B, n_logits], new_state)."""
        logits = None
        new_state: Dict[str, Any] = {}
        shard = ((self.mesh, self.sharded_paths) if self.mesh is not None
                 else None)

        def add(x):
            nonlocal logits
            logits = x if logits is None else logits + x

        if self.consts.indicator_dim and "ind_ids" in batch:
            batch = dict(batch)
            batch["_ind_block"] = indicator_block(
                batch, self.consts.indicator_dim)
        if self.has_deep:
            fold_params = (params.get("linear", {}).get("fold")
                           if self.has_wide else None)
            dl, new_bn, fold_wide = deep_logits(
                ParamStore(params["dnn"]), self.plan, self.consts,
                self.deep_spec, batch, self.n_logits, training, rng,
                state.get("bn"), fold_params, sinks, shard)
            new_state["bn"] = new_bn
            add(dl)
            if fold_wide is not None:
                add(fold_wide)
        if self.has_wide:
            add(linear_logits(params["linear"], batch, self.consts, shard))
        if self.has_cnn:
            cl, new_state["cnn_bn"] = cnn_logits(
                params["cnn"], self.cnn_spec, batch["image"], self.n_logits,
                training, state.get("cnn_bn"))
            add(cl)
        return logits, new_state

    def loss_fn(self, params: Dict, state: Dict,
                batch: Dict[str, torch.Tensor], training: bool,
                rng: Optional[torch.Generator] = None,
                sinks: Optional[Dict[str, torch.Tensor]] = None,
                collect_summaries: bool = False):
        """-> (loss, (new_state, per-example loss, predictions)), plus the
        per-layer summary stats (models/deep.summary_scope) as a fourth
        aux entry when ``collect_summaries``."""
        stats: Dict[str, torch.Tensor] = {}
        with summary_scope(stats if collect_summaries else None):
            logits, new_state = self.apply(params, state, batch, training,
                                           rng, sinks)
        weights = batch["weight"] * batch["mask"]
        total_w = None
        if self.mesh is not None and training:
            # this rank's share of the global batch's weighted mean: its
            # rows' weighted sum over the global weight sum (summed over
            # 'data'); the penalty joins once, on data rank 0
            from wide_deep_tpu_torch.parallel import mesh as mesh_lib
            total_w = mesh_lib.all_reduce(
                torch.sum(weights.float()).reshape(1).detach(),
                self.mesh.data_group, "loss")[0]
        loss, per_ex = heads.head_loss(logits, batch["label"], weights,
                                       self.n_classes, total_w)
        if self.has_deep and (self.deep_spec.l1 or self.deep_spec.l2) and (
                self.mesh is None or self.mesh.data_idx == 0):
            loss = loss + l2_l1_penalty(params["dnn"], self.deep_spec)
        preds = heads.head_predictions(logits, self.n_classes)
        if collect_summaries:
            return loss, (new_state, per_ex, preds, stats)
        return loss, (new_state, per_ex, preds)

    def predict(self, params: Dict, state: Dict,
                batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        logits, _ = self.apply(params, state, batch, training=False)
        return heads.head_predictions(logits, self.n_classes)


def build_model(config, plan: Optional[FeaturePlan] = None,
                model_type: Optional[str] = None, n_classes: int = 2,
                dtype=None) -> WideDeep:
    """Config -> WideDeep.  ``dtype`` overrides the dense compute dtype
    (default: model.yaml dense_dtype); the CNN arm (``cnn_use_flag``)
    computes in float32 either way."""
    set_parity_precision()
    model_conf = config.model
    model_type = model_type or config.train["model_type"]
    if plan is None:
        plan = FeaturePlan(config, fold=fold_enabled(config, model_type))
    if dtype is None:
        dtype = DTYPES[model_conf.get("dense_dtype") or "float32"]
    deep_spec = None
    if model_type != "wide":
        deep_spec = DeepSpec.from_model_conf(model_conf, dtype=dtype)
    cnn_spec = (CnnSpec.from_model_conf(model_conf)
                if model_conf.get("cnn_use_flag") else None)
    return WideDeep(plan=plan, deep_spec=deep_spec, model_type=model_type,
                    n_classes=n_classes, cnn_spec=cnn_spec,
                    fm_factors=int(model_conf.get("linear_fm_factors") or 0))
