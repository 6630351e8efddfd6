"""Trainer: the single-device training loop (a slim port of
wide_deep_tpu/training/loop.py: construction, initialisation, ``train_file``
behind the device prefetch, ``evaluate`` and ``predict``; checkpoints and
the multi-device paths are not ported yet).
"""

from __future__ import annotations

import itertools
import logging
import os
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from wide_deep_tpu_torch import metrics as metrics_lib
from wide_deep_tpu_torch.config import Config
from wide_deep_tpu_torch.features.pipeline import (CsvDataset,
                                                   DevicePrefetchIterator,
                                                   PrefetchIterator,
                                                   default_transformer)
from wide_deep_tpu_torch.features.plan import FeaturePlan, fold_enabled
from wide_deep_tpu_torch.models.joint import (WideDeep, build_model,
                                              resolve_device)
from wide_deep_tpu_torch.optim import build_joint_optimizer
from wide_deep_tpu_torch.optim import sparse as sparse_lib
from wide_deep_tpu_torch.training.step import (eval_step, init_opt_state,
                                               predict_step, train_step)

log = logging.getLogger("wide_deep_tpu_torch")

# every key of a packed transfer starts on this boundary: the kernels read
# ids, perm and tiles with wide loads
PACK_ALIGN = 256


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


def pack_layout(batch: Dict[str, np.ndarray]
                ) -> Tuple[Dict[str, int], int]:
    """Byte offsets of a batch's keys in one transfer buffer, each
    ``PACK_ALIGN``-aligned, and the buffer's size.  The window plans' ``ok``
    flags stay out: they stay on the host, where apply_window_plan branches
    on them without a device sync."""
    offsets, n = {}, 0
    for k, v in batch.items():
        if "_ok_" in k:
            continue
        offsets[k] = n
        n += -(-v.nbytes // PACK_ALIGN) * PACK_ALIGN
    return offsets, n


def pack_into(staging: np.ndarray, batch: Dict[str, np.ndarray],
              offsets: Dict[str, int]) -> None:
    """Copy each laid-out key's bytes into the uint8 buffer ``staging``."""
    for k, off in offsets.items():
        v = np.ascontiguousarray(batch[k])
        staging[off:off + v.nbytes] = v.reshape(-1).view(np.uint8)


def unpack(buf: torch.Tensor, batch: Dict[str, np.ndarray],
           offsets: Dict[str, int]) -> Dict[str, torch.Tensor]:
    """Per-key views of the uint8 tensor ``buf`` filled by ``pack_into``;
    keys left out of the layout (the ``ok`` flags) as host tensors."""
    out = {}
    for k, v in batch.items():
        if k in offsets:
            dt = torch.from_numpy(np.empty(0, v.dtype)).dtype
            out[k] = buf[offsets[k]:offsets[k] + v.nbytes].view(dt).view(
                v.shape)
        else:
            out[k] = torch.from_numpy(v)
    return out


class DeviceBatch(dict):
    """A batch on the card: views of one device buffer, filled by one copy
    on a side stream that records ``ready``.  ``claim`` makes the current
    stream wait for the copy and keeps the buffer alive until that stream's
    work on it is done."""

    def __init__(self, tensors: Dict[str, torch.Tensor],
                 buffer: torch.Tensor, ready: torch.cuda.Event):
        super().__init__(tensors)
        self.buffer = buffer
        self.ready = ready

    def claim(self) -> "DeviceBatch":
        stream = torch.cuda.current_stream(self.buffer.device)
        stream.wait_event(self.ready)
        self.buffer.record_stream(stream)
        return self


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
            self.plan, n_classes, self.pos_weight, self.neg_weight,
            num_parallel_calls=self.train_conf.get("num_parallel_calls"))
        self.params = None
        self.mstate = None
        self.opt_state = None
        self.global_step = 0
        self.losses: List[torch.Tensor] = []   # per-step loss, on device
        self._gen = torch.Generator(device=self.device).manual_seed(
            self.seed)
        self._copy_stream: Optional[torch.cuda.Stream] = None

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

    # ------------------------------------------------------------- transfer
    def _to_device(self, batch: Dict[str, np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
        """Host batch -> tensors on the Trainer's device: the JAX package's
        one ``device_put`` a batch.  On the card every key but the window
        plans' ``ok`` flags is packed into one pinned buffer
        (``pack_layout``) and sent by one copy on a side stream; the result
        is a DeviceBatch whose ``claim`` orders the consumer's stream after
        the copy.  Safe to call from a prefetch thread.  On the CPU: views
        of the numpy arrays."""
        if self.device.type != "cuda":
            return {k: torch.from_numpy(v) for k, v in batch.items()}
        offsets, n = pack_layout(batch)
        with torch.cuda.device(self.device):
            host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
            pack_into(host.numpy(), batch, offsets)
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream()
            stream = self._copy_stream
            with torch.cuda.stream(stream):
                buf = torch.empty(n, dtype=torch.uint8, device=self.device)
                buf.copy_(host, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(stream)
        return DeviceBatch(unpack(buf, batch, offsets), buf, ready)

    def _device_batch(self, batch) -> Dict[str, torch.Tensor]:
        """A host batch through ``_to_device``; a DeviceBatch claimed for
        the current stream; tensors as they are."""
        if any(isinstance(v, np.ndarray) for v in batch.values()):
            batch = self._to_device(batch)
        if isinstance(batch, DeviceBatch):
            batch.claim()
        return batch

    # ---------------------------------------------------------------- train
    def train_batch(self, batch) -> torch.Tensor:
        """One step on a host batch (numpy arrays) or on one already on the
        device (``_to_device``'s); returns the loss (on device)."""
        self.ensure_initialized()
        self.mstate, loss = train_step(
            self.model, self.tx, self.params, self.mstate, self.opt_state,
            self._device_batch(batch), self.sparse_tables, rng=self._gen)
        self.global_step += 1
        self.losses.append(loss)
        return loss

    def _dataset(self, path: str, mode: str,
                 epoch_seed: int = 0) -> CsvDataset:
        return CsvDataset(
            self.plan, path, mode, self.batch_size,
            n_classes=self.n_classes, pos_weight=self.pos_weight,
            neg_weight=self.neg_weight,
            shuffle_buffer=int(self.train_conf["num_examples"]),
            seed=self.seed + epoch_seed, transformer=self.transformer)

    def train_file(self, path: str, epoch_seed: int = 0,
                   max_steps: Optional[int] = None) -> float:
        """Train over one file (at most ``max_steps`` batches); returns the
        last batch loss.  Parse, host-to-device copy and step overlap: the
        loader and the copy each run in a thread of their own."""
        self.ensure_initialized()
        t0 = time.time()
        loss = None
        batches = iter(self._dataset(path, "train", epoch_seed))
        if max_steps is not None:
            batches = itertools.islice(batches, max_steps)
        for batch in DevicePrefetchIterator(PrefetchIterator(batches),
                                            self._to_device):
            loss = self.train_batch(batch)
        log.info("finished %s in %.1f s (step %d)", os.path.basename(path),
                 time.time() - t0, self.global_step)
        return float("nan") if loss is None else float(loss)

    # ---------------------------------------------------------- eval, pred
    def evaluate(self, data_path: Optional[str] = None,
                 checkpoint_path: Optional[str] = None) -> Dict[str, float]:
        """The metric set (metrics.py) over ``data_path`` (default: the
        train conf's ``test_data``) with the current params, plus
        ``global_step``."""
        if checkpoint_path:
            raise NotImplementedError("checkpoints are not ported yet")
        self.ensure_initialized()
        data_path = data_path or self.train_conf["test_data"]
        acc = metrics_lib.init_metrics(device=self.device)
        for batch in PrefetchIterator(self._dataset(data_path, "eval")):
            acc = eval_step(self.model, self.params, self.mstate,
                            self._device_batch(batch), acc)
        results = metrics_lib.finalize_metrics(acc,
                                               binary=self.n_classes == 2)
        results["global_step"] = self.global_step
        return results

    def predict(self, data_path: Optional[str] = None,
                checkpoint_path: Optional[str] = None
                ) -> Iterator[Dict[str, Any]]:
        """Per-example predictions over ``data_path`` (default:
        ``test_data``), streamed: one dict of numpy values per real row."""
        if checkpoint_path:
            raise NotImplementedError("checkpoints are not ported yet")
        self.ensure_initialized()
        data_path = data_path or self.train_conf["test_data"]
        for batch in PrefetchIterator(self._dataset(data_path, "pred")):
            preds = predict_step(self.model, self.params, self.mstate,
                                 self._device_batch(batch))
            preds = {k: v.cpu().numpy() for k, v in preds.items()}
            for i in range(int(batch["mask"].sum())):
                yield {k: v[i] for k, v in preds.items()}
