"""Trainer: the single-device training loop (the port of
wide_deep_tpu/training/loop.py without its multi-device path), after the reference's entry-point loops (python/train.py:65-170,
eval.py:56-83, pred.py:52-74):

* ``train_and_eval``: per epoch, per train file: train, then evaluate the
  eval data; the test data every ``epochs_per_eval`` epochs;
* ``dynamic_train``: rolling window, train on file[i], test on file[i+1];
* ``train_stream``: a live TSV stream over TCP (features/stream.py);
* ``train``, ``evaluate`` and ``predict`` one-shots.

With the CNN arm (``cnn_use_flag``) each TSV row pairs with an image of the
TFRecord file train.yaml's ``image_{train,eval,test}_data`` names, by the
row's index (features/image.ImageCsvDataset); the image joins the batch's
one packed transfer.

``train_file`` runs the loader and the host-to-device copy in threads
ahead of the step, checkpoints at the runconfig's cadence
(training/checkpoint.py), writes TensorBoard summaries every
``save_summary_steps`` steps and logs steps/s every
``log_step_count_steps``.  keep_train=0 wipes the model dir first
(``maybe_wipe_model_dir``); otherwise a Trainer resumes from the latest
checkpoint.
"""

from __future__ import annotations

import collections
import itertools
import logging
import os
import shutil
import time
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from wide_deep_tpu_torch import metrics as metrics_lib
from wide_deep_tpu_torch.config import Config
from wide_deep_tpu_torch.features.pipeline import (CsvDataset,
                                                   DevicePrefetchIterator,
                                                   PrefetchIterator,
                                                   default_transformer,
                                                   list_files)
from wide_deep_tpu_torch.features.plan import FeaturePlan, fold_enabled
from wide_deep_tpu_torch.models.joint import (WideDeep, build_model,
                                              resolve_device)
from wide_deep_tpu_torch.optim import build_joint_optimizer, tree_items
from wide_deep_tpu_torch.optim import sparse as sparse_lib
from wide_deep_tpu_torch.training.checkpoint import CheckpointManager
from wide_deep_tpu_torch.training.step import (eval_step, init_opt_state,
                                               predict_step, train_step)

log = logging.getLogger("wide_deep_tpu_torch")

# every key of a packed transfer starts on this boundary: the kernels read
# ids, perm and tiles with wide loads
PACK_ALIGN = 256
# Trainer.losses keeps the losses of this many most recent steps
LOSS_HISTORY = 1000


def resolve_checkpoint(checkpoint_path: str):
    """Split an explicit checkpoint path into (manager_dir, step).  Steps
    lie in ``<model_dir>/<step>/``, so a path whose basename is an integer
    pins that step; a path to the model dir itself means the latest (step
    None)."""
    p = os.path.abspath(checkpoint_path.rstrip("/"))
    base = os.path.basename(p)
    if base.isdigit():
        return os.path.dirname(p), int(base)
    return p, None


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


def to_device(batch: Dict[str, np.ndarray], device: torch.device,
              stream: "torch.cuda.Stream") -> DeviceBatch:
    """A host batch to the card in one copy: every key ``pack_layout``
    lays out is packed into one pinned buffer, sent by one copy on
    ``stream``, and viewed back per key.  The pinned buffer comes from
    PyTorch's caching host allocator, which records the copy on it and
    hands its memory out again only once the copy is done, so a caller may
    pack the next batch at once."""
    offsets, n = pack_layout(batch)
    with torch.cuda.device(device):
        host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        pack_into(host.numpy(), batch, offsets)
        with torch.cuda.stream(stream):
            buf = torch.empty(n, dtype=torch.uint8, device=device)
            buf.copy_(host, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(stream)
    return DeviceBatch(unpack(buf, batch, offsets), buf, ready)


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
                  "dnn": self.model.has_deep, "cnn": self.model.has_cnn},
            sparse_paths=sparse_paths)
        self.pos_weight = self.train_conf.get("pos_sample_loss_weight")
        self.neg_weight = self.train_conf.get("neg_sample_loss_weight")
        # step-cadenced eval (train.yaml eval_every_n_steps; 0 = off): a
        # full eval pass inline every N train steps
        self.eval_every_n_steps = int(
            self.train_conf.get("eval_every_n_steps") or 0)
        self.transformer = default_transformer(
            self.plan, n_classes, self.pos_weight, self.neg_weight,
            num_parallel_calls=self.train_conf.get("num_parallel_calls"))
        self.params = None
        self.mstate = None
        self.opt_state = None
        self.global_step = 0
        # the losses of the most recent steps, on the device
        self.losses: collections.deque = collections.deque(
            maxlen=LOSS_HISTORY)
        # the per-layer stats of the last step that computed them
        self.summary_stats: Dict[str, torch.Tensor] = {}
        self._gen = torch.Generator(device=self.device).manual_seed(
            self.seed)
        self._copy_stream: Optional[torch.cuda.Stream] = None
        self._ckpt: Optional[CheckpointManager] = None
        self._summary_writer = None

    def ensure_initialized(self, restore: bool = True):
        """Once: draw params and BN state from the seed unless they were
        set (the tests set the JAX package's through interop.from_jax), the
        optimizer state, the checkpoint manager and the plan record; then,
        with ``restore`` and freshly drawn params, the latest checkpoint."""
        if self._ckpt is not None:
            return
        fresh = self.params is None
        if fresh:
            sample = self.model.sample_batch(self.device)
            self.params, self.mstate = self.model.init(self.seed, sample,
                                                       self.device)
            sparse_lib.init_fused_params(self.params, self.sparse_tables)
        if self.opt_state is None:
            self.opt_state = init_opt_state(self.tx, self.params,
                                            self.sparse_tables)
        self._ckpt = CheckpointManager(self.model_dir, self.runconfig)
        # the plan decisions the params train with (auto pack_budget,
        # fold), for export.  Written once: eval and predict pass here too,
        # and their plan may differ from the one the checkpointed params
        # were trained with; a wiped (keep_train=0) dir gets a new record
        from wide_deep_tpu_torch.features.analyze import (load_plan_meta,
                                                          save_plan_meta)
        if load_plan_meta(self.model_dir) is None:
            save_plan_meta(self.model_dir, self.plan)
        if restore and fresh:
            restored = self._restore_tree(self._ckpt)
            if restored is not None:
                log.info("restored checkpoint at step %d", self.global_step)

    def _ckpt_tree(self) -> Dict[str, Any]:
        """What a checkpoint holds: the params with each fused table as a
        view of its live columns (optim/sparse.compact_fused_ckpt), the BN
        state, the optimizer state, the step and the dropout generator's
        state (its draws depend on it, so a resume draws what an
        uninterrupted run would)."""
        return {"params": sparse_lib.compact_fused_ckpt(self.params,
                                                        self.sparse_tables),
                "mstate": self.mstate, "opt_state": self.opt_state,
                "step": self.global_step, "rng": self._gen.get_state()}

    def _restore_tree(self, mgr: CheckpointManager,
                      step: Optional[int] = None):
        """Restore ``step`` (default: the latest) into the live state in
        place; the fused tables' padding columns are zeroed
        (optim/sparse.expand_fused_ckpt).  -> the restored tree, or None
        when there is no checkpoint."""
        restored = mgr.restore(self._ckpt_tree(), step=step)
        if restored is None:
            return None
        self.params = sparse_lib.expand_fused_ckpt(
            restored["params"], self.sparse_tables, self.params)
        self.mstate = restored["mstate"]
        self.opt_state = restored["opt_state"]
        self.global_step = int(restored["step"])
        self._gen.set_state(restored["rng"])
        return restored

    def maybe_wipe_model_dir(self):
        if not self.train_conf["keep_train"] and os.path.isdir(self.model_dir):
            shutil.rmtree(self.model_dir)

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
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        return to_device(batch, self.device, self._copy_stream)

    def _device_batch(self, batch) -> Dict[str, torch.Tensor]:
        """A host batch through ``_to_device``; a DeviceBatch claimed for
        the current stream; tensors as they are."""
        if any(isinstance(v, np.ndarray) for v in batch.values()):
            batch = self._to_device(batch)
        if isinstance(batch, DeviceBatch):
            batch.claim()
        return batch

    # ---------------------------------------------------------------- train
    def train_batch(self, batch, with_summaries: bool = False) -> torch.Tensor:
        """One step on a host batch (numpy arrays) or on one already on the
        device (``_to_device``'s); returns the loss (on device).
        ``with_summaries`` also computes the per-layer activation stats
        into ``summary_stats``."""
        self.ensure_initialized()
        out = train_step(
            self.model, self.tx, self.params, self.mstate, self.opt_state,
            self._device_batch(batch), self.sparse_tables, rng=self._gen,
            with_summaries=with_summaries)
        self.mstate, loss = out[0], out[1]
        if with_summaries:
            self.summary_stats = out[2]
        self.global_step += 1
        self.losses.append(loss)
        return loss

    def _image_path(self, mode: str, data_path: str) -> Optional[str]:
        """The TFRecord file whose images pair with ``data_path``'s rows:
        the train images for training, the test images for the test data
        and for prediction, else the eval images; None without the CNN
        arm."""
        if not self.model.has_cnn:
            return None
        if mode == "train":
            return self.train_conf.get("image_train_data")
        if data_path == self.train_conf.get("test_data") or mode == "pred":
            return self.train_conf.get("image_test_data")
        return self.train_conf.get("image_eval_data")

    def _dataset(self, path: str, mode: str, epoch_seed: int = 0):
        """A CsvDataset over ``path``, or with the CNN arm an
        ImageCsvDataset pairing its rows with ``_image_path``'s images."""
        kwargs = dict(
            n_classes=self.n_classes, pos_weight=self.pos_weight,
            neg_weight=self.neg_weight,
            shuffle_buffer=int(self.train_conf["num_examples"]),
            seed=self.seed + epoch_seed, transformer=self.transformer)
        img = self._image_path(mode, path)
        if img:
            from wide_deep_tpu_torch.features.image import ImageCsvDataset
            cnn = self.model.cnn_spec
            return ImageCsvDataset(
                self.plan, path, img, mode, self.batch_size,
                height=cnn.height, width=cnn.width, channels=cnn.channels,
                **kwargs)
        return CsvDataset(self.plan, path, mode, self.batch_size, **kwargs)

    def train_file(self, path: str, epoch_seed: int = 0,
                   max_steps: Optional[int] = None) -> float:
        """Train over one file (at most ``max_steps`` batches); returns the
        last batch loss.  Parse, host-to-device copy and step overlap: the
        loader and the copy each run in a thread of their own.  Summaries,
        step logs, checkpoints and cadenced evals at the configured steps;
        only the log and summary steps read the loss on the host."""
        self.ensure_initialized()
        log_every = int(self.runconfig.get("log_step_count_steps") or 100)
        summary_every = int(self.runconfig.get("save_summary_steps") or 0)
        t0 = time.time()
        last_log_step, last_log_time = self.global_step, t0
        loss = None
        batches = iter(self._dataset(path, "train", epoch_seed))
        if max_steps is not None:
            batches = itertools.islice(batches, max_steps)
        for batch in DevicePrefetchIterator(PrefetchIterator(batches),
                                            self._to_device):
            summarize = bool(summary_every) and (
                (self.global_step + 1) % summary_every == 0)
            if summarize:
                loss = self.train_batch(batch, with_summaries=True)
                self._write_summaries(float(loss), self.summary_stats)
            else:
                loss = self.train_batch(batch)
            if self.global_step % log_every == 0:
                now = time.time()
                sps = (self.global_step - last_log_step) / max(
                    now - last_log_time, 1e-9)
                log.info("step %d  loss %.5f  %.1f steps/s  %.0f ex/s",
                         self.global_step, float(loss), sps,
                         sps * self.batch_size)
                last_log_step, last_log_time = self.global_step, now
            if self._ckpt.should_save(self.global_step):
                self._ckpt.save(self.global_step, self._ckpt_tree())
            if (self.eval_every_n_steps
                    and self.global_step % self.eval_every_n_steps == 0):
                res = self.evaluate(self.train_conf["eval_data"])
                log.info("step %d cadenced eval: %s", self.global_step,
                         _fmt(res))
                self._write_eval_summaries(res)
        log.info("finished %s in %.1f s (step %d)", os.path.basename(path),
                 time.time() - t0, self.global_step)
        return float("nan") if loss is None else float(loss)

    def train_stream(self, host: str, port: int,
                     max_batches: Optional[int] = None,
                     flush_timeout_s: float = 1.0,
                     reconnect: bool = False,
                     max_retries: int = 30) -> float:
        """Train on a live TSV stream (features/stream.StreamDataset):
        batches in arrival order, a partial batch after ``flush_timeout_s``
        of idleness, each through ``_to_device`` and the step, with the
        configured checkpoint cadence.  Returns the last batch loss; the
        stream ending (the producer closed, or with ``reconnect`` every
        retry spent) returns normally."""
        from wide_deep_tpu_torch.features.stream import StreamDataset
        self.ensure_initialized()
        ds = StreamDataset(
            self.plan, host, port, mode="train", batch_size=self.batch_size,
            n_classes=self.n_classes, pos_weight=self.pos_weight,
            neg_weight=self.neg_weight, flush_timeout_s=flush_timeout_s,
            max_batches=max_batches, transformer=self.transformer,
            reconnect=reconnect, max_retries=max_retries)
        loss = None
        for batch in ds:
            loss = self.train_batch(self._to_device(batch))
            if self._ckpt.should_save(self.global_step):
                self._ckpt.save(self.global_step, self._ckpt_tree())
        log.info("stream ended after %d rows (step %d)", ds.rows_seen,
                 self.global_step)
        return float("nan") if loss is None else float(loss)

    def save(self, force: bool = True):
        """Checkpoint the current step; durable on return."""
        self.ensure_initialized()
        self._ckpt.save(self.global_step, self._ckpt_tree(), force=force)
        self._ckpt.wait()

    def _writer(self):
        if self._summary_writer is None:
            from wide_deep_tpu_torch.training.summary import SummaryWriter
            self._summary_writer = SummaryWriter(
                os.path.join(self.model_dir, "summaries"))
        return self._summary_writer

    def _write_summaries(self, loss: float, stats: Dict[str, torch.Tensor]):
        """The loss and the per-layer stats as scalars, and the towers'
        kernels and biases as histograms (host side), at the
        save_summary_steps cadence (train.yaml:93, model_util.py:15-17)."""
        w = self._writer()
        names = sorted(stats)
        values = (torch.stack([stats[k].float() for k in names]).tolist()
                  if names else [])
        scalars = {"loss": loss}
        scalars.update(zip(names, values))
        w.scalars(scalars, self.global_step)
        for path, leaf in sorted(
                (tuple(map(str, p)), t) for p, t in tree_items(self.params)):
            if path[-1] in ("kernel", "b", "bias") and "towers" in path:
                w.histogram("/".join(path),
                            leaf.detach().float().cpu().numpy(),
                            self.global_step)
        w.flush()

    def _write_eval_summaries(self, results: Dict[str, float]):
        """Eval metrics under an eval/ tag prefix at the step-cadenced eval
        points."""
        w = self._writer()
        w.scalars({f"eval/{k}": float(v) for k, v in results.items()
                   if k != "global_step"}, self.global_step)
        w.flush()

    def _restore_pinned(self, checkpoint_path: str):
        """Restore the exact checkpoint an explicit path names (the
        reference's eval.py:74-78, pred.py:47-49); raises if it does not
        exist."""
        mgr_dir, step = resolve_checkpoint(checkpoint_path)
        mgr = CheckpointManager(mgr_dir, self.runconfig)
        steps = mgr.all_steps()
        if step is None:
            step = mgr.latest_step()
        if step is None or step not in steps:
            raise FileNotFoundError(
                f"no checkpoint at {checkpoint_path!r} "
                f"(available steps under {mgr_dir}: {steps})")
        self._restore_tree(mgr, step=step)

    # ---------------------------------------------------------- eval, pred
    def evaluate(self, data_path: Optional[str] = None,
                 checkpoint_path: Optional[str] = None) -> Dict[str, float]:
        """The metric set (metrics.py) over ``data_path`` (default: the
        train conf's ``test_data``) with the current params, plus
        ``global_step``; from the checkpoint ``checkpoint_path`` names
        (``resolve_checkpoint``) where one is given."""
        self.ensure_initialized(restore=not checkpoint_path)
        if checkpoint_path:
            self._restore_pinned(checkpoint_path)
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
        ``test_data``), streamed: one dict of numpy values per real row;
        from the checkpoint ``checkpoint_path`` names where one is given."""
        self.ensure_initialized(restore=not checkpoint_path)
        if checkpoint_path:
            self._restore_pinned(checkpoint_path)
        data_path = data_path or self.train_conf["test_data"]
        for batch in PrefetchIterator(self._dataset(data_path, "pred")):
            preds = predict_step(self.model, self.params, self.mstate,
                                 self._device_batch(batch))
            preds = {k: v.cpu().numpy() for k, v in preds.items()}
            for i in range(int(batch["mask"].sum())):
                yield {k: v[i] for k, v in preds.items()}

    # ------------------------------------------------------------ loop modes
    def train_and_eval(self):
        """The reference's train.py:65-106: per epoch, each train file then
        an eval pass over the eval data; the test data every
        ``epochs_per_eval`` epochs; a forced save at the end of each
        epoch."""
        conf = self.train_conf
        for epoch in range(int(conf["train_epochs"])):
            for path in list_files(conf["train_data"]):
                self.train_file(path, epoch_seed=epoch)
                res = self.evaluate(conf["eval_data"])
                log.info("epoch %d eval %s: %s", epoch,
                         os.path.basename(path), _fmt(res))
            if (epoch + 1) % int(conf["epochs_per_eval"]) == 0:
                res = self.evaluate(conf["test_data"])
                log.info("epoch %d test: %s", epoch, _fmt(res))
            self.save()

    def dynamic_train(self):
        """Rolling-window mode (train.py:109-148): train file[i], test
        file[i+1], files sorted by name."""
        conf = self.train_conf
        files = sorted(list_files(conf["train_data"]))
        for epoch in range(int(conf["train_epochs"])):
            for i, path in enumerate(files):
                self.train_file(path, epoch_seed=epoch)
                if i + 1 < len(files):
                    res = self.evaluate(files[i + 1])
                    log.info("dynamic eval on %s: %s",
                             os.path.basename(files[i + 1]), _fmt(res))
            self.save()

    def train_and_evaluate(self):
        """The reference's train_and_eval_api mode by name
        (train.py:151-170); the same interleaved loop as
        ``train_and_eval``."""
        return self.train_and_eval()

    def train(self):
        """Plain training, no interleaved eval (the distributed mode's
        default, train.py:213-214)."""
        conf = self.train_conf
        for epoch in range(int(conf["train_epochs"])):
            for path in list_files(conf["train_data"]):
                self.train_file(path, epoch_seed=epoch)
            self.save()


def _fmt(res: Dict[str, float]) -> str:
    return "  ".join(f"{k}={v:.6g}" for k, v in sorted(res.items()))
