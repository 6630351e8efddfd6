"""The training cells: set-up, the first steps read for ``correct``, the
measured window, the traced stretch, and the reference.

The feed (the traffic mix's ``feed``, ``packed``): set-up parses a pool of
``file_batches`` batches with the program's own loader (CsvDataset over
the native transformer, file order); the window cycles the pool through
the composition ``Trainer.train_file`` uses (PrefetchIterator,
DevicePrefetchIterator over ``Trainer._to_device``,
``Trainer.train_batch``), so every step pays its packed host-to-device
copy.  The loader is bypassed.

The first three steps go through the window's own call and feed, on rows
that all differ, with probes around them (``Probe``): the losses, the
gradient each optimizer is handed at the first step, and each leaf's and
each optimizer slot's change over the three.  The reference follows the
same rows from the same weights once the window has closed and the
program is freed.
"""

from __future__ import annotations

import contextlib
import gc
import multiprocessing
import os
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from reference.config import Config as RefConfig
from reference.model import Model as RefModel
from reference.parse import FeatureTransformer, transform_lines
from reference.train import Trainer as RefTrainer

from . import confdir, counts, env, judge, rows
from . import trace as trace_lib
from .record import Recorder, log, read_metrics
from .weights import Weights, const_change_norm

PROBED_STEPS = 3
HOST_TRACE_STEPS = 3
PARSE_WORKERS = 6
PARSE_CHUNK = 6_400


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _sq_norm(t) -> float:
    import torch
    return float(torch.sum(torch.square(t.float()), dtype=torch.float64))


def _path(p) -> str:
    return "/".join(str(k) for k in p)


def slot_start(value: float, param_dtype, slot_dtype) -> float:
    """The value a slot starts at: the optimizer's initial value rounded
    to its param's dtype, then to the slot's."""
    import torch
    return float(torch.full((), value, dtype=param_dtype).to(slot_dtype))


# ------------------------------------------------------------------ set-up
class Setup:
    """What a run makes before the program: its conf dir, the reference
    model of the configuration, the rows file."""

    def __init__(self, cell, seed: int, n_rows: Optional[int] = None):
        self.cell = cell
        self.seed = int(seed)
        self.traffic = cell.traffic
        self.work = env.scratch_dir(cell.name)
        self.model_dir = os.path.join(self.work, "model")
        self.conf_dir = confdir.write_conf(cell, self.work, self.seed,
                                           self.model_dir)
        self.ref_config = RefConfig(self.conf_dir)
        self.batch_size = int(self.ref_config.train["batch_size"])
        self.ref_model = RefModel(self.ref_config, self.batch_size)
        self.rows_path = os.path.join(self.work, "rows.tsv")
        self.n_rows = n_rows or (int(self.traffic["file_batches"])
                                 * self.batch_size)
        t = time.perf_counter()
        n_bytes = rows.write_rows(self.ref_config, self.rows_path,
                                  self.n_rows, self.seed, self.traffic)
        log(f"rows: {self.n_rows} ({n_bytes / 1e6:.1f} MB) in "
            f"{time.perf_counter() - t:.2f} s")

    def cleanup(self) -> None:
        import shutil
        shutil.rmtree(self.work, ignore_errors=True)


# ----------------------------------------------------------------- program
def build_trainer(setup: Setup, device, weights: Weights):
    """The program's Trainer on the run's conf, holding ``weights``."""
    import torch
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.optim import sparse as sparse_lib
    from wide_deep_tpu_torch.optim import tree_items
    from wide_deep_tpu_torch.training.loop import Trainer
    t = time.perf_counter()
    tr = Trainer(Config(setup.conf_dir), "wide_deep",
                 model_dir=setup.model_dir, device=device)
    log(f"trainer: constructed in {time.perf_counter() - t:.2f} s")
    meta = torch.device("meta")
    shapes, state = tr.model.init(tr.seed, tr.model.sample_batch(meta), meta)
    fused = {t.path: t for t in tr.sparse_tables.values()}
    have = {_path(p) for p, _ in tree_items(shapes)}
    want = set(weights.index)
    if have != want:
        raise RuntimeError(f"the program's params and the reference's "
                           f"differ: {sorted(have ^ want)}")

    def build(node, prefix=()):
        if isinstance(node, dict):
            return {k: build(v, prefix + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [build(v, prefix + (i,)) for i, v in enumerate(node)]
        path = _path(prefix)
        if prefix in fused:
            t = torch.zeros(node.shape, dtype=node.dtype, device=device)
            dim = fused[prefix].dim
            for lo, block in weights.blocks(path):
                t[lo:lo + block.shape[0], :dim] = block
            return t
        t = weights.leaf(path)
        if t.shape != node.shape or t.dtype != node.dtype:
            raise RuntimeError(f"{path}: the program holds {node.dtype} "
                               f"{tuple(node.shape)}, the reference "
                               f"{t.dtype} {tuple(t.shape)}")
        return t

    t = time.perf_counter()
    tr.params = build(shapes)
    sparse_lib.init_fused_params(tr.params, tr.sparse_tables)
    _sync(torch.device(device))
    log(f"trainer: weights made in {time.perf_counter() - t:.2f} s")
    tr.mstate = {arm: {k: {"mean": torch.zeros(v["mean"].shape,
                                                device=device),
                           "var": torch.ones(v["var"].shape, device=device)}
                       for k, v in sub.items()}
                 for arm, sub in state.items()}
    tr.ensure_initialized(restore=False)
    return tr


class Probe:
    """Readings of the program's next ``PROBED_STEPS`` calls of
    ``Trainer.train_batch``: each loss, the norm of every leaf's gradient
    as its optimizer is handed it at the first (the fused table's summed
    per unique row, as K1 sums it), and each leaf's and each optimizer
    slot's change after the last (``<leaf>:<slot>``: FTRL's ``accum`` and
    ``linear``, Adagrad's ``accum``; a fused table's from its slot
    columns)."""

    def __init__(self, tr, weights: Weights):
        self.tr = tr
        self.weights = weights
        self.losses: List[float] = []
        self.grad_sq: Dict[str, float] = {}
        self.change: Dict[str, float] = {}
        self.slots: Dict[str, float] = {}
        self._orig = tr.train_batch
        tr.train_batch = self._step

    @contextlib.contextmanager
    def _grads(self):
        from wide_deep_tpu_torch.optim import sparse as sparse_mod
        import torch
        tx = self.tr.tx
        update = tx.update_
        fused = sparse_mod.apply_fused_update

        def update_(params, grads, state):
            for p, g in grads.items():
                self.grad_sq[_path(p)] = _sq_norm(g)
            return update(params, grads, state)

        def apply_fused_update(table, t, row_grads, plan, state):
            g = torch.zeros(row_grads.shape, dtype=torch.float32,
                            device=row_grads.device)
            g.index_add_(0, plan["ids"].long(),
                         row_grads.float()[plan["perm"].long()])
            self.grad_sq[_path(table.path)] = _sq_norm(g)
            return fused(table, t, row_grads, plan, state)

        tx.update_ = update_
        sparse_mod.apply_fused_update = apply_fused_update
        try:
            yield
        finally:
            del tx.update_
            sparse_mod.apply_fused_update = fused

    def _step(self, batch, with_summaries: bool = False):
        if not self.losses:
            with self._grads():
                loss = self._orig(batch, with_summaries)
        else:
            loss = self._orig(batch, with_summaries)
        self.losses.append(float(loss))
        if len(self.losses) == PROBED_STEPS:
            del self.tr.train_batch
            self._read_change()
        return loss

    def _read_change(self) -> None:
        from wide_deep_tpu_torch.optim import slot_inits, tree_get, tree_items
        from wide_deep_tpu_torch.optim.sparse import fused_layout
        tr = self.tr
        fused = {t.path: t.dim for t in tr.sparse_tables.values()}
        for p, t in tree_items(tr.params):
            cur = t[:, :fused[p]] if p in fused else t
            self.change[_path(p)] = self.weights.change_norm(_path(p), cur)
        for arm, (spec, _) in tr.tx.arms.items():
            st = tr.opt_state["dense"][arm]
            for p, w in tr.tx.leaves(tr.params, arm):
                for k, (value, _) in slot_inits(spec).items():
                    s = st[k][p]
                    self.slots[f"{_path(p)}:{k}"] = const_change_norm(
                        s, slot_start(value, w.dtype, s.dtype))
        for t in tr.sparse_tables.values():
            # the program's touched-rows tables are fused: their slots are
            # column blocks of the table beside its param columns
            acc0 = t.spec.get("initial_accumulator_value", 0.1)
            w = tree_get(tr.params, t.path)
            for k, off in fused_layout(t.spec, t.dim).items():
                self.slots[f"{_path(t.path)}:{k}"] = const_change_norm(
                    w[:, off:off + t.dim],
                    slot_start(acc0 if k == "accum" else 0.0, w.dtype,
                               w.dtype))

    def readings(self) -> Dict[str, Any]:
        return {"losses": self.losses,
                "grad_norms": {k: v ** 0.5 for k, v in self.grad_sq.items()},
                "change_norms": dict(self.change),
                "slot_norms": dict(self.slots)}


class Cycle:
    """The packed pool, over and over, until ``stop``; counts what it
    handed out."""

    def __init__(self, pool):
        self.pool = pool
        self.stop = threading.Event()
        self.given = 0

    def __iter__(self):
        while not self.stop.is_set():
            item = self.pool[self.given % len(self.pool)]
            self.given += 1
            yield item


def run_program(setup: Setup, device, seconds: float, trace: bool,
                weights: Weights, start: float) -> Dict[str, Any]:
    """The program's part of a run -> its readings, the window's numbers
    and the recorder; the program is freed on return."""
    import torch
    from wide_deep_tpu_torch.features.pipeline import (CsvDataset,
                                                       DevicePrefetchIterator,
                                                       PrefetchIterator)
    traffic = setup.traffic
    B = setup.batch_size
    t = time.perf_counter()
    if device.type == "cuda":
        from wide_deep_tpu_torch.ops import cuda_build
        cuda_build.build()
        torch.zeros(1, device=device)
        log(f"kernels built or found, card initialised in "
            f"{time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    tr = build_trainer(setup, device, weights)
    _sync(device)
    log(f"trainer: built and given the weights in "
        f"{time.perf_counter() - t:.2f} s")
    rec = Recorder()
    out: Dict[str, Any] = {"rec": rec}
    if traffic["feed"] != "packed":
        raise ValueError(f"unknown feed {traffic['feed']!r}: the harness "
                         f"drives packed batches")
    probe = Probe(tr, weights)
    t = time.perf_counter()
    pool = list(CsvDataset(tr.plan, setup.rows_path, "train", B,
                           n_classes=tr.n_classes, pos_weight=tr.pos_weight,
                           neg_weight=tr.neg_weight, shuffle_buffer=0,
                           seed=tr.seed, transformer=tr.transformer,
                           drop_remainder=True))
    log(f"pool: {len(pool)} batches parsed in "
        f"{time.perf_counter() - t:.2f} s")
    cycle = Cycle(pool)
    it = iter(DevicePrefetchIterator(PrefetchIterator(cycle), tr._to_device))
    t = time.perf_counter()
    for _ in range(PROBED_STEPS + int(traffic["warm_steps"])):
        tr.train_batch(next(it))
    _sync(device)
    log(f"probed and warm-up steps: {time.perf_counter() - t:.2f} s")
    if len(probe.losses) != PROBED_STEPS:
        raise RuntimeError("the probed steps did not run")
    window = _window(tr, it, seconds, rec, device)
    out.update(window)
    out["setup_s"] = window["window_start"] - start
    out["readings"] = probe.readings()
    losses = list(tr.losses)[-window["steps"]:]
    out["failed"] = int(sum(not np.isfinite(float(x)) for x in losses))
    if trace and device.type == "cuda":
        _traced_stretch(tr, setup, traffic, rec, out, it, pool)
    if device.type == "cuda":
        out["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(
            device))
    cycle.stop.set()
    for _ in it:
        pass
    return out


def _window(tr, it, seconds, rec, device) -> Dict[str, Any]:
    steps = 0
    t0 = time.perf_counter()
    start = time.time()
    while True:
        batch = next(it)
        ts = time.perf_counter()
        tr.train_batch(batch)
        rec.add("train_batch", time.perf_counter() - ts)
        steps += 1
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    elapsed = time.perf_counter() - t0
    rec.add("window", elapsed)
    q = np.percentile(rec.spans["train_batch"], [10, 50, 90])
    log(f"window: {steps} steps in {elapsed:.3f} s; train_batch host ms "
        f"p10 {1e3 * q[0]:.2f} p50 {1e3 * q[1]:.2f} p90 {1e3 * q[2]:.2f}")
    return {"steps": steps, "window_s": elapsed, "window_start": start}


def _traced_stretch(tr, setup, traffic, rec, out, it, pool) -> None:
    """Profiled stretches after the window: ``trace_steps`` steps of the
    same feed with the card's activity alone (the per-layer metrics), then
    ``HOST_TRACE_STEPS`` with the host's ops too (what the host did in the
    idle gaps)."""
    k = int(traffic["trace_steps"])
    cap = trace_lib.Capture(os.path.join(setup.work, "trace.json"))
    hcap = trace_lib.Capture(os.path.join(setup.work, "trace_host.json"),
                             host=True)
    consumed = out["steps"] + PROBED_STEPS + int(traffic["warm_steps"])
    with cap:
        for _ in range(k):
            tr.train_batch(next(it))
    with hcap:
        for _ in range(HOST_TRACE_STEPS):
            tr.train_batch(next(it))
    work = [counts.grad_work(setup.ref_model, pool[(consumed + i) % len(pool)])
            for i in range(k)]
    rec.count("grad_bound_s", sum(counts.bound_s(w) for w in work))
    out["trace"] = trace_lib.Trace(cap, k)
    out["host_trace"] = trace_lib.Trace(hcap, HOST_TRACE_STEPS)
    for c in (cap, hcap):
        trace_lib.remove(c.path)
    work = sorted(out["trace"].grad_work_by_name().items(),
                  key=lambda kv: -kv[1])
    log("sparse-gradient work, device ms a step: " + "; ".join(
        f"{name[:160]} {ms:.4f}" for name, ms in work))


# --------------------------------------------------------------- reference
def probed_lines(setup: Setup) -> List[List[str]]:
    """The rows of the program's probed steps, as the packed pool gives
    them: file order."""
    lines = rows.read_lines(setup.rows_path)
    B = setup.batch_size
    return [lines[k * B:(k + 1) * B] for k in range(PROBED_STEPS)]


def _parse_chunk(args):
    conf_dir, batch_size, lines, mode = args
    model = RefModel(RefConfig(conf_dir), batch_size)
    return transform_lines(FeatureTransformer(model.plan), lines, len(lines),
                           mode)


def parse_batches(setup: Setup, batches: List[List[str]],
                  mode: str = "train") -> List[Dict]:
    """The reference's own parse of each batch's rows, chunks of rows in a
    few forked processes (numpy only), joined along the batch axis."""
    jobs, owner = [], []
    for k, b in enumerate(batches):
        for lo in range(0, len(b), PARSE_CHUNK):
            jobs.append((setup.conf_dir, setup.batch_size,
                         b[lo:lo + PARSE_CHUNK], mode))
            owner.append(k)
    ctx = multiprocessing.get_context("fork")
    with ctx.Pool(min(PARSE_WORKERS, len(jobs))) as pool:
        parts = pool.map(_parse_chunk, jobs)
        pool.close()
        pool.join()
    out = []
    for k in range(len(batches)):
        chunk = [p for p, o in zip(parts, owner) if o == k]
        out.append({key: np.concatenate([c[key] for c in chunk])
                    for key in chunk[0]})
    return out


def reference_readings(setup: Setup, weights: Weights, batches, device,
                       lowp: bool = False,
                       half_batch: bool = False) -> Dict[str, Any]:
    """The reference's losses, first gradients, and changes of leaves and
    slots over the probed steps from the same weights.  ``lowp``: the control (fp8 where the
    configuration says bfloat16); ``half_batch``: the planted fault of a
    step that leaves out half of each batch."""
    import torch
    model = RefModel(setup.ref_config, setup.batch_size, lowp=lowp)
    ref = RefTrainer(model, setup.ref_config, weights.all())
    for b in batches:
        t = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
        if half_batch:
            t["mask"] = t["mask"].clone()
            t["mask"][setup.batch_size // 2:] = 0
        ref.step(t)
    out = {"losses": list(ref.losses),
           "grad_norms": {p: _sq_norm(g) ** 0.5
                          for p, g in ref.first_grads.items()},
           "change_norms": {p: weights.change_norm(p, t)
                            for p, t in ref.params.items()},
           "slot_norms": {
               f"{p}:{k}": const_change_norm(s, slot_start(
                   ref.slot_inits[p][k], ref.params[p].dtype, s.dtype))
               for p, slots in ref.slots.items() for k, s in slots.items()}}
    del ref
    gc.collect()
    return out


# --------------------------------------------------------------------- run
def run(cell, args, start: float, device_name: str = "cuda"
        ) -> Dict[str, Any]:
    if device_name == "cuda":
        env.require_cards(int(cell.workload["chips"]))
    setup = Setup(cell, args.seed)
    import torch
    device = torch.device(device_name)
    weights = Weights(setup.ref_model.leaf_specs(), setup.seed, device)
    prog = run_program(setup, device, float(args.seconds), bool(args.trace),
                       weights, start)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    batches = parse_batches(setup, probed_lines(setup))
    ref = reference_readings(setup, weights, batches, device)
    log(f"reference: {time.perf_counter() - t:.2f} s")
    numbers = judge.training_numbers(prog["readings"], ref)
    # a step whose loss is not a number is no sound step: none is allowed
    numbers["nonfinite_losses"] = (prog["failed"], "window")
    limits = dict(cell.limits["train"], nonfinite_losses=0)
    correct = judge.verdict(numbers, limits)
    rec = prog["rec"]
    B = setup.batch_size
    rec.count("window_steps", prog["steps"])
    rec.count("batch_size", B)
    rec.count("flops_per_step", counts.step_flops(setup.ref_model))
    rec.count("peak_flops_per_s", float(cell.config["peak_flops_per_s"]))
    result: Dict[str, Any] = {
        "correct": bool(correct), "attempted": int(prog["steps"]),
        "failed": int(prog["failed"])}
    if args.trace:
        result["metrics"] = read_metrics(cell.per_layer, rec,
                                         prog.get("trace"))
    else:
        result["metrics"] = {
            "train_examples_per_s": {
                "value": prog["steps"] * B / prog["window_s"],
                "unit": "examples/s"},
            "setup_s": {"value": prog["setup_s"], "unit": "s"}}
    dev: Dict[str, Any] = {"count": int(cell.workload["chips"]),
                           "memory_peak_bytes":
                               int(prog.get("memory_peak_bytes", 0))}
    if device.type == "cuda":
        dev = {**env.card(), **dev}
    trace = prog.get("trace")
    if trace is not None:
        dev["busy_s"] = trace.busy_s
        dev["window_s"] = trace.window_s
        result["breakdown"] = trace.breakdown(prog.get("host_trace"))
    result["device"] = dev
    result["compared"] = {k: {"value": v, "limit": limits[k], "at": at}
                          for k, (v, at) in numbers.items()}
    result["_readings"] = {"program": prog["readings"], "reference": ref}
    setup.cleanup()
    return result
