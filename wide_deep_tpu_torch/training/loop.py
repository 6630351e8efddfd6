"""Trainer: the training loop (the port of wide_deep_tpu/training/loop.py),
after the reference's entry-point loops (python/train.py:65-170,
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

On a mesh of ranks (``torch.distributed`` initialized with more than one
process, parallel/mesh.py; JAX loop.py:164-200) each rank holds its row
shard of every row-sharded leaf and trains on its rows of the global
batch: from the input service (``distribution.input_service``: its slice
of each global batch with its own shard's kernel plans), else from its own
rows of the files (``num_shards`` / ``shard_index`` over the 'data' axis)
without kernel plans, as the JAX package does; a mesh whose 'data' axis is
1 reads the global batch on every rank and keeps the plans.  Batch counts
are agreed before each batch (``_synced_batches``); checkpoints hold whole
leaves (rank 0 writes; training/checkpoint.py), so they move between any
numbers of ranks; ``evaluate`` gives one device's metrics.
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
import torch.distributed as dist

from wide_deep_tpu_torch import metrics as metrics_lib
from wide_deep_tpu_torch import tracing
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
from wide_deep_tpu_torch.parallel import mesh as mesh_lib
from wide_deep_tpu_torch.training import checkpoint as ckpt_lib
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
                        model_type: str, n_dev: int = 1, n_procs: int = 1,
                        global_batch_input: bool = False) -> FeaturePlan:
    """The training FeaturePlan for ``n_dev`` table shards fed by
    ``n_procs`` processes (the JAX package's topology gate, loop.py:61-141
    there): kernel plans for the big groups when ``scatter_mode: pallas``
    (the JAX package's name for the kernel backward), per table shard on a
    mesh, and only where some host sees the global batch's id stream (one
    process, or ``global_batch_input``: the input service); the fused
    sparse optimizer where its plans are; ``pack_budget: auto`` resolved
    from the train data.  ``sharded_lookup: dedup`` on a mesh fed with
    the global batch gives the big groups the dedup exchange's unique-id
    plans (``shard_kind="dedup"``) in place of the kernel plans, and keeps
    the fused optimizer's per-shard compact plans."""
    from wide_deep_tpu_torch.features.analyze import resolve_pack_budget
    budget = train_conf.get("pack_budget")
    if str(budget).lower() == "auto":
        budget = resolve_pack_budget(config, train_conf.get("train_data"),
                                     raw=budget)
    single_host_input = n_procs == 1 or global_batch_input
    lookup = config.distribution.get("sharded_lookup") or "auto"
    dedup_lookup = n_dev > 1 and lookup == "dedup" and single_host_input
    explicit_lookup = n_dev > 1 and (
        lookup in ("explicit", "auto") or dedup_lookup)
    kernels = str(train_conf.get("scatter_mode") or "pallas") == "pallas"
    pallas_scatter = kernels and (
        n_dev == 1
        or (explicit_lookup and not dedup_lookup and single_host_input))
    scatter_shards = (n_dev if n_dev > 1 and (pallas_scatter or dedup_lookup)
                      else 1)
    sparse_opt = (bool(train_conf.get("sparse_optimizer")) and kernels
                  and (n_dev == 1 or (scatter_shards == n_dev
                                      and single_host_input)))
    return FeaturePlan(
        config, multivalue=train_conf["multivalue"],
        fold=fold_enabled(config, model_type),
        pack_budget=budget if budget not in (None, "") else None,
        pallas_scatter=pallas_scatter, scatter_shards=scatter_shards,
        shard_threshold=train_conf.get("shard_threshold"),
        shard_kind="dedup" if dedup_lookup else "scatter",
        sparse_opt=sparse_opt)


def pack_layout(batch: Dict[str, np.ndarray]
                ) -> Tuple[Dict[str, int], int]:
    """Byte offsets of a batch's keys in one transfer buffer, each
    ``PACK_ALIGN``-aligned, and the buffer's size.  The window plans' ``ok``
    flags stay out, and the per-shard plans' ``live`` counts beside their
    ``ok`` flags: they stay on the host, where apply_window_plan and the
    sharded paths branch on them without a device sync."""
    offsets, n = {}, 0
    for k, v in batch.items():
        if "_ok_" in k or ("_live_" in k
                           and k.replace("_live_", "_ok_") in batch):
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
    keys left out of the layout (the ``ok`` and ``live`` flags) as host
    tensors."""
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
    pack the next batch at once.  Spans ``input.h2d`` (pack and copy) and
    ``input.h2d.copy`` (the copy, on ``stream``); counter
    ``input.h2d_bytes``."""
    offsets, n = pack_layout(batch)
    with torch.cuda.device(device), tracing.span("input.h2d"):
        host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        pack_into(host.numpy(), batch, offsets)
        with torch.cuda.stream(stream), tracing.span("input.h2d.copy",
                                                     device):
            buf = torch.empty(n, dtype=torch.uint8, device=device)
            buf.copy_(host, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(stream)
        tracing.count("input.h2d_bytes", n)
    return DeviceBatch(unpack(buf, batch, offsets), buf, ready)


class Trainer:
    def __init__(self, config: Optional[Config] = None,
                 model_type: Optional[str] = None,
                 model_dir: Optional[str] = None,
                 n_classes: int = 2,
                 dtype=None,
                 overrides: Optional[Dict[str, Any]] = None,
                 device=None, mesh=None):
        self.config = config or Config()
        # a mesh of ranks: the one given, else train.yaml's over the
        # initialized process group when it has more than one rank
        if mesh is None and dist.is_initialized() and (
                dist.get_world_size() > 1):
            dev, _, _ = mesh_lib.placement(dist.get_rank(),
                                           dist.get_world_size(), device)
            mesh = mesh_lib.mesh_from_config(self.config, dev)
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(
            device)
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
        self.input_service = (
            self.config.distribution.get("input_service") or None)
        n_dev = mesh.world if mesh is not None else 1
        if mesh is not None and self.input_service and mesh.model > 1:
            raise NotImplementedError(
                "the input service slices batches over every rank, so it "
                "takes meshes with model: 1 (ROADMAP.md Queue 1); a mesh "
                "with data: 1 reads the global batch on every rank")
        # every rank reads the global batch when the 'data' axis is 1
        self._global_input = bool(self.input_service) or (
            mesh is not None and mesh.data == 1)
        self.plan = build_training_plan(
            self.config, self.train_conf, self.model_type, n_dev,
            n_procs=n_dev, global_batch_input=self._global_input)
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
        # the paths of the row-sharded leaves, once the params are sharded
        self.sharded_paths: Optional[frozenset] = None

    @property
    def is_chief(self) -> bool:
        """Rank 0 of a mesh, or the one process."""
        return self.mesh is None or self.mesh.rank == 0

    @property
    def per_rank_batch(self) -> int:
        """Rows of each rank's part of the global batch."""
        return self.batch_size // (self.mesh.data if self.mesh else 1)

    def _shard_params(self) -> None:
        """On a mesh: each row-sharded leaf of the (whole) params replaced
        by this rank's rows, and the model's gathers from them routed
        through the exchange (parallel/exchange.enable_explicit_lookup)."""
        if self.mesh is None or self.sharded_paths is not None:
            return
        from wide_deep_tpu_torch.parallel.exchange import (
            enable_explicit_lookup)
        paths = mesh_lib.param_shardings(
            self.params, self.mesh.world,
            self.train_conf.get("shard_threshold"))
        mesh_lib.shard_params(self.params, paths, self.mesh)
        self.sharded_paths = paths
        enable_explicit_lookup(self.model, self.mesh, paths)

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
        self._shard_params()
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
        if self.is_chief and load_plan_meta(self.model_dir) is None:
            save_plan_meta(self.model_dir, self.plan)
        if self.mesh is not None:
            mesh_lib.host_any(False, self.mesh)   # the record is written
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
        tree = self._ckpt_tree()
        ranges = None
        if self.mesh is not None:
            leaves = dict(ckpt_lib.named_leaves(tree))
            ranges = {}
            for name in ckpt_lib.sharded_names(tree, self.sharded_paths):
                rows = leaves[name].shape[0]
                ranges[name] = (self.mesh.shard * rows,
                                (self.mesh.shard + 1) * rows)
        restored = mgr.restore(tree, step=step, row_ranges=ranges)
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
        if (self.is_chief and not self.train_conf["keep_train"]
                and os.path.isdir(self.model_dir)):
            shutil.rmtree(self.model_dir)
        if self.mesh is not None:
            mesh_lib.host_any(False, self.mesh)   # every rank sees it done

    def _should_save(self) -> bool:
        """The checkpoint cadence's decision for this step; on a mesh rank
        0's, so that every rank joins the same saves."""
        want = self._ckpt.should_save(self.global_step)
        if self.mesh is not None and not self._ckpt.save_steps:
            want = mesh_lib.host_broadcast(want, self.mesh)
        return want

    def _save_step(self, force: bool = False) -> None:
        """Checkpoint the current step.  On a mesh every rank calls it: the
        row-sharded leaves are gathered whole onto rank 0, which writes
        the files one device writes, durable before any rank returns."""
        tree = self._ckpt_tree()
        if self.mesh is None:
            self._ckpt.save(self.global_step, tree, force=force)
            return
        names = ckpt_lib.sharded_names(tree, self.sharded_paths)
        whole = ckpt_lib.gather_sharded(tree, names)
        if whole is not None:
            self._ckpt.save(self.global_step, whole, force=True)
        mesh_lib.host_any(False, self.mesh)   # committed before anyone reads

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
        into ``summary_stats``.  The call is the span ``train.step``."""
        with tracing.span("train.step"):
            self.ensure_initialized()
            out = train_step(
                self.model, self.tx, self.params, self.mstate,
                self.opt_state, self._device_batch(batch),
                self.sparse_tables, rng=self._gen,
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
        ImageCsvDataset pairing its rows with ``_image_path``'s images.  On
        a mesh: the input service's slices for training when it is set
        (``_remote_dataset``); else this rank's rows (the 'data' axis's
        round-robin shard) at the rank's batch size, or with a 'data' axis
        of 1 the global batch cut to the rank's plan rows."""
        mesh = self.mesh
        if mesh is not None and self.input_service and mode == "train":
            return self._remote_dataset(path, epoch_seed)
        global_rows = mesh is not None and mesh.data == 1
        kwargs = dict(
            n_classes=self.n_classes, pos_weight=self.pos_weight,
            neg_weight=self.neg_weight,
            shuffle_buffer=int(self.train_conf["num_examples"]),
            seed=self.seed + epoch_seed, transformer=self.transformer)
        if mesh is not None and not global_rows:
            kwargs.update(num_shards=mesh.data, shard_index=mesh.data_idx)
        batch = self.batch_size if global_rows else self.per_rank_batch
        img = self._image_path(mode, path)
        if img:
            from wide_deep_tpu_torch.features.image import ImageCsvDataset
            cnn = self.model.cnn_spec
            ds = ImageCsvDataset(
                self.plan, path, img, mode, batch,
                height=cnn.height, width=cnn.width, channels=cnn.channels,
                **kwargs)
        else:
            ds = CsvDataset(self.plan, path, mode, batch, **kwargs)
        if global_rows and self.plan.scatter_shards > 1:
            return _RankRows(ds, mesh)
        return ds

    def _remote_dataset(self, path: str, epoch_seed: int):
        """This rank's slices of the input service's global batches (JAX
        loop.py:382-436): the loader is checked to serve this run's stream
        (``stream_fingerprint``), and ``run_token`` (the step, the same on
        every rank) keys a fresh stream for a resumed run."""
        from wide_deep_tpu_torch.features.input_service import (
            RemoteInputDataset, group_range_for_proc, loader_for_proc,
            stream_fingerprint)
        mesh = self.mesh
        addrs = [a.strip() for a in self.input_service.split(",")
                 if a.strip()]
        image_shape = (224, 224, 3)
        if self.model.has_cnn:
            image_shape = self.model.cnn_spec.image_shape
        fingerprint = stream_fingerprint(
            self.seed, self.batch_size, self.n_classes,
            self.plan.scatter_shards, mesh.world,
            pos_weight=self.pos_weight, neg_weight=self.neg_weight,
            model_type=self.model_type,
            shuffle_buffer=int(self.train_conf["num_examples"]))
        return RemoteInputDataset(
            self.plan, loader_for_proc(addrs, mesh.rank, mesh.world), path,
            "train", global_batch=self.batch_size,
            group_range=group_range_for_proc(len(addrs), mesh.rank,
                                             mesh.world),
            proc=mesh.rank, n_procs=mesh.world, epoch_seed=epoch_seed,
            n_classes=self.n_classes, with_image=self.model.has_cnn,
            image_shape=image_shape, fingerprint=fingerprint,
            run_token=self.global_step)

    def _synced_batches(self, batches, mode: str, spec=None):
        """The dataset's batches with batch counts agreed over the ranks
        (JAX loop.py:487-524): every step of a mesh needs every rank, and
        round-robin row shards can leave one rank a batch more than
        another.  Before each batch the ranks agree (over the mode's own
        host group, so this may run in a loader thread beside the step's
        collectives) whether any still has data; an exhausted rank feeds
        zero-weight padding batches (of ``spec``, default the plan's at
        the rank's batch size) until all are done.  One process: the
        batches as they are."""
        if self.mesh is None:
            yield from batches
            return
        it = iter(batches)
        pad = None
        exhausted = False
        while True:
            batch = None if exhausted else next(it, None)
            exhausted = batch is None
            if not mesh_lib.host_any(batch is not None, self.mesh,
                                     self.mesh.loader_groups[mode]):
                return
            if batch is None:
                if pad is None:
                    spec = spec or self.plan.batch_spec(
                        self.per_rank_batch, self.n_classes,
                        with_image=self.model.has_cnn, mode=mode)
                    pad = {k: np.zeros(shape, dt)
                           for k, (shape, dt) in spec.items()}
                batch = pad
            yield batch

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
        ds = self._dataset(path, "train", epoch_seed)
        batches = self._synced_batches(
            itertools.islice(ds, max_steps), "train",
            getattr(ds, "local_spec", None))
        for batch in DevicePrefetchIterator(PrefetchIterator(batches),
                                            self._to_device):
            summarize = bool(summary_every) and (
                (self.global_step + 1) % summary_every == 0)
            if summarize:
                loss = self.train_batch(batch, with_summaries=True)
                if self.is_chief:
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
            if self._should_save():
                self._save_step()
            if (self.eval_every_n_steps
                    and self.global_step % self.eval_every_n_steps == 0):
                res = self.evaluate(self.train_conf["eval_data"])
                log.info("step %d cadenced eval: %s", self.global_step,
                         _fmt(res))
                if self.is_chief:
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
        if self.mesh is not None:
            raise ValueError("train_stream runs on one process; the ranks "
                             "of a mesh train from files or the input "
                             "service")
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
        self._save_step(force=force)
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
        for batch in PrefetchIterator(self._synced_batches(
                self._dataset(data_path, "eval"), "eval")):
            acc = eval_step(self.model, self.params, self.mstate,
                            self._device_batch(batch), acc)
        if self.mesh is not None:
            # each data slice's sums, added over 'data' (a model group's
            # ranks hold the same rows)
            acc = {k: mesh_lib.all_reduce(v.reshape(-1), self.mesh.data_group,
                                          "metrics").reshape(v.shape)
                   for k, v in acc.items()}
        results = metrics_lib.finalize_metrics(acc,
                                               binary=self.n_classes == 2)
        results["global_step"] = self.global_step
        return results

    def predict(self, data_path: Optional[str] = None,
                checkpoint_path: Optional[str] = None
                ) -> Iterator[Dict[str, Any]]:
        """Per-example predictions over ``data_path`` (default:
        ``test_data``), streamed: one dict of numpy values per real row;
        from the checkpoint ``checkpoint_path`` names where one is given.
        One process, as the JAX package's predict (loop.py:703-711 there):
        ranks score through ``evaluate`` or a served bundle."""
        if self.mesh is not None:
            raise ValueError(
                "predict() runs on one process (the reference's pred.py "
                "likewise); run tools.pred against the checkpoint on one "
                "card, use evaluate() on the ranks, or serve the export")
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


class _RankRows:
    """A global-batch dataset cut to one rank's part (parallel/mesh
    .shard_batch): its batch rows and its row of each per-shard plan."""

    def __init__(self, dataset, mesh):
        self.dataset, self.mesh = dataset, mesh
        self.mode = dataset.mode

    def __iter__(self):
        for batch in self.dataset:
            yield mesh_lib.shard_batch(batch, self.mesh, self.mesh.world)


def _fmt(res: Dict[str, float]) -> str:
    return "  ".join(f"{k}={v:.6g}" for k, v in sorted(res.items()))
