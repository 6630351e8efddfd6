"""Trainer: the single-device training loop (a slim port of
wide_deep_tpu/training/loop.py: construction, initialisation and
``train_file``; evaluation, prediction, checkpoints and the multi-device
paths are not ported yet).
"""

from __future__ import annotations

import itertools
import logging
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from wide_deep_tpu_torch.config import Config
from wide_deep_tpu_torch.features.pipeline import (CsvDataset,
                                                   PrefetchIterator,
                                                   default_transformer)
from wide_deep_tpu_torch.features.plan import FeaturePlan, fold_enabled
from wide_deep_tpu_torch.models.joint import (WideDeep, build_model,
                                              resolve_device)
from wide_deep_tpu_torch.optim import build_joint_optimizer
from wide_deep_tpu_torch.optim import sparse as sparse_lib
from wide_deep_tpu_torch.training.step import init_opt_state, train_step

log = logging.getLogger("wide_deep_tpu_torch")


def build_training_plan(config: Config, train_conf: Dict[str, Any],
                        model_type: str, n_dev: int = 1) -> FeaturePlan:
    """The training FeaturePlan on one device: kernel plans for the big
    groups when ``scatter_mode: pallas`` (the JAX package's name for the
    kernel backward), the fused sparse optimizer when ``sparse_optimizer``
    is also on, and ``pack_budget: auto`` resolved from the train data."""
    if n_dev != 1:
        raise NotImplementedError("multi-GPU training is not ported yet")
    from wide_deep_tpu_torch.features.analyze import resolve_pack_budget
    budget = train_conf.get("pack_budget")
    if str(budget).lower() == "auto":
        budget = resolve_pack_budget(config, train_conf.get("train_data"),
                                     raw=budget)
    kernels = str(train_conf.get("scatter_mode") or "pallas") == "pallas"
    return FeaturePlan(
        config, multivalue=train_conf["multivalue"],
        fold=fold_enabled(config, model_type),
        pack_budget=budget if budget not in (None, "") else None,
        pallas_scatter=kernels,
        sparse_opt=bool(train_conf.get("sparse_optimizer")) and kernels)


def batch_to_device(batch: Dict[str, np.ndarray],
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """Host batch -> tensors on ``device``.  Window plans' ``ok`` flags stay
    on the CPU: apply_window_plan branches on them without a device sync."""
    return {k: (torch.from_numpy(v) if "_ok_" in k
                else torch.from_numpy(v).to(device, non_blocking=True))
            for k, v in batch.items()}


class Trainer:
    def __init__(self, config: Optional[Config] = None,
                 model_type: Optional[str] = None,
                 model_dir: Optional[str] = None,
                 n_classes: int = 2,
                 dtype=None,
                 overrides: Optional[Dict[str, Any]] = None,
                 device=None):
        self.device = resolve_device(device)
        self.config = config or Config()
        self.train_conf = dict(self.config.train)
        if overrides:
            self.train_conf.update(
                {k: v for k, v in overrides.items() if v is not None})
        self.model_type = model_type or self.train_conf["model_type"]
        self.model_dir = os.path.join(
            model_dir or self.train_conf["model_dir"], self.model_type)
        self.runconfig = self.config.runconfig
        self.batch_size = int(self.train_conf["batch_size"])
        self.n_classes = n_classes
        self.seed = int(self.runconfig["tf_random_seed"])
        self.plan = build_training_plan(self.config, self.train_conf,
                                        self.model_type)
        self.model: WideDeep = build_model(
            self.config, plan=self.plan, model_type=self.model_type,
            n_classes=n_classes, dtype=dtype)
        decay_steps = max(
            float(self.train_conf["num_examples"]) / self.batch_size, 1.0)
        self.sparse_tables, sparse_paths = (
            sparse_lib.plan_sparse_tables(
                self.plan, self.config.model, decay_steps, self.batch_size,
                enabled=self.plan.sparse_opt)
            if self.model.has_deep else ({}, frozenset()))
        self.tx = build_joint_optimizer(
            self.config.model, decay_steps,
            arms={"linear": self.model.has_wide,
                  "dnn": self.model.has_deep},
            sparse_paths=sparse_paths)
        self.pos_weight = self.train_conf.get("pos_sample_loss_weight")
        self.neg_weight = self.train_conf.get("neg_sample_loss_weight")
        self.transformer = default_transformer(
            self.plan, n_classes, self.pos_weight, self.neg_weight)
        self.params = None
        self.mstate = None
        self.opt_state = None
        self.global_step = 0
        self.losses: List[torch.Tensor] = []   # per-step loss, on device
        self._gen = torch.Generator(device=self.device).manual_seed(
            self.seed)

    def ensure_initialized(self):
        """Draw params and BN state from the seed unless they were set (the
        tests set the JAX package's through interop.from_jax), then the
        optimizer state."""
        if self.params is None:
            spec = self.plan.batch_spec(1, self.n_classes)
            sample = {k: torch.zeros(shape, dtype=getattr(torch, dt.__name__),
                                     device=self.device)
                      for k, (shape, dt) in spec.items()}
            sample["mask"] = torch.ones_like(sample["mask"])
            self.params, self.mstate = self.model.init(self.seed, sample,
                                                       self.device)
            sparse_lib.init_fused_params(self.params, self.sparse_tables)
        if self.opt_state is None:
            self.opt_state = init_opt_state(self.tx, self.params,
                                            self.sparse_tables)

    def train_batch(self, batch: Dict[str, np.ndarray]) -> torch.Tensor:
        """One step on a host batch; returns the loss (on device)."""
        self.ensure_initialized()
        self.mstate, loss = train_step(
            self.model, self.tx, self.params, self.mstate, self.opt_state,
            batch_to_device(batch, self.device), self.sparse_tables,
            rng=self._gen)
        self.global_step += 1
        self.losses.append(loss)
        return loss

    def _dataset(self, path: str, epoch_seed: int = 0) -> CsvDataset:
        return CsvDataset(
            self.plan, path, "train", self.batch_size,
            n_classes=self.n_classes, pos_weight=self.pos_weight,
            neg_weight=self.neg_weight,
            shuffle_buffer=int(self.train_conf["num_examples"]),
            seed=self.seed + epoch_seed, transformer=self.transformer)

    def train_file(self, path: str, epoch_seed: int = 0,
                   max_steps: Optional[int] = None) -> float:
        """Train over one file (at most ``max_steps`` batches); returns the
        last batch loss."""
        self.ensure_initialized()
        t0 = time.time()
        loss = None
        batches = iter(self._dataset(path, epoch_seed))
        if max_steps is not None:
            batches = itertools.islice(batches, max_steps)
        for batch in PrefetchIterator(batches):
            loss = self.train_batch(batch)
        log.info("finished %s in %.1f s (step %d)", os.path.basename(path),
                 time.time() - t0, self.global_step)
        return float("nan") if loss is None else float(loss)
