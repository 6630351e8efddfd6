"""The DLRM-DCNv2 training cells (traffic kind ``dcn``): set-up, the first
steps read for ``correct``, the measured window, the traced stretch, and
the plain reference of reference/dcn.py.

The feed is harness/train.py's ``packed`` one: a pool of ``file_batches``
batches parsed in set-up by the program's loader, cycled through
PrefetchIterator, DevicePrefetchIterator over ``Trainer._to_device`` and
``Trainer.train_batch``; the window (``train._window``), the probes
(``train.Probe``) and the profiler captures (harness/trace.py) are the
training cells' own.  What is this kind's: the rows (harness/dcn_rows.py),
the program's model type (``deep``), the fused table's row width (one
accumulator column a row under RowwiseAdagrad), the FLOPs and bytes
(harness/counts_dcn.py), and the reference, which holds the table only
at the rows the probed steps touch.

A program that cannot read the configuration (its config layer refuses a
key) fails in set-up, before any row is made.
"""

from __future__ import annotations

import gc
import multiprocessing
import os
import time
from typing import Any, Dict, List

import numpy as np

from reference import dcn as ref_dcn

from . import confdir, counts_dcn, dcn_rows, env, judge, train
from . import trace as trace_lib
from .record import Recorder, log, read_metrics
from .weights import Weights, const_change_norm

PROBED_STEPS = train.PROBED_STEPS
HOST_TRACE_STEPS = train.HOST_TRACE_STEPS


# ------------------------------------------------------------------ set-up
class Setup:
    """The run's conf dir (read by the program's config layer first), the
    reference's spec of the configuration, the rows file."""

    def __init__(self, cell, seed: int):
        self.cell = cell
        self.seed = int(seed)
        self.traffic = cell.traffic
        self.work = env.scratch_dir(cell.name)
        self.model_dir = os.path.join(self.work, "model")
        self.conf_dir = confdir.write_conf(cell, self.work, self.seed,
                                           self.model_dir)
        t = time.perf_counter()
        from wide_deep_tpu_torch.config import Config
        program_conf = Config(self.conf_dir)
        program_conf.read_feature_conf()
        _ = program_conf.model          # validated as it is read
        log(f"the program reads the configuration "
            f"({time.perf_counter() - t:.2f} s)")
        self.spec = ref_dcn.Spec(self.conf_dir)
        self.batch_size = self.spec.batch_size
        self.rows_path = os.path.join(self.work, "rows.tsv")
        self.n_rows = int(self.traffic["file_batches"]) * self.batch_size
        t = time.perf_counter()
        n_bytes = dcn_rows.write_rows(self.spec, self.rows_path, self.n_rows,
                                      self.seed, self.traffic["rows"])
        log(f"rows: {self.n_rows} ({n_bytes / 1e6:.1f} MB) in "
            f"{time.perf_counter() - t:.2f} s")

    def cleanup(self) -> None:
        import shutil
        shutil.rmtree(self.work, ignore_errors=True)


# ----------------------------------------------------------------- program
def build_trainer(setup: Setup, device, weights: Weights):
    """The program's Trainer (model type ``deep``) on the run's conf,
    holding ``weights``: the table in its fused matrix's param columns,
    the slots at their initial values."""
    import torch
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.optim import sparse as sparse_lib
    from wide_deep_tpu_torch.optim import tree_items
    from wide_deep_tpu_torch.training.loop import Trainer
    t = time.perf_counter()
    tr = Trainer(Config(setup.conf_dir), "deep", model_dir=setup.model_dir,
                 device=device)
    log(f"trainer: constructed in {time.perf_counter() - t:.2f} s")
    meta = torch.device("meta")
    shapes, state = tr.model.init(tr.seed, tr.model.sample_batch(meta), meta)
    fused = {t.path: t for t in tr.sparse_tables.values()}
    have = {train._path(p) for p, _ in tree_items(shapes)}
    if have != set(weights.index):
        raise RuntimeError(f"the program's params and the reference's "
                           f"differ: {sorted(have ^ set(weights.index))}")

    def build(node, prefix=()):
        if isinstance(node, dict):
            return {k: build(v, prefix + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [build(v, prefix + (i,)) for i, v in enumerate(node)]
        path = train._path(prefix)
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
    train._sync(torch.device(device))
    log(f"trainer: weights made in {time.perf_counter() - t:.2f} s")
    tr.mstate = state
    tr.ensure_initialized(restore=False)
    return tr


class Probe(train.Probe):
    """train.Probe with each fused slot read at its own width (one
    column a row under RowwiseAdagrad)."""

    def _read_change(self) -> None:
        from wide_deep_tpu_torch.optim import slot_inits, tree_get, tree_items
        from wide_deep_tpu_torch.optim.sparse import fused_layout, slot_width
        tr = self.tr
        fused = {t.path: t.dim for t in tr.sparse_tables.values()}
        for p, t in tree_items(tr.params):
            cur = t[:, :fused[p]] if p in fused else t
            self.change[train._path(p)] = self.weights.change_norm(
                train._path(p), cur)
        for arm, (spec, _) in tr.tx.arms.items():
            st = tr.opt_state["dense"][arm]
            for p, w in tr.tx.leaves(tr.params, arm):
                for k, (value, _) in slot_inits(spec).items():
                    s = st[k][p]
                    self.slots[f"{train._path(p)}:{k}"] = const_change_norm(
                        s, train.slot_start(value, w.dtype, s.dtype))
        for t in tr.sparse_tables.values():
            acc0 = t.spec.get("initial_accumulator_value", 0.1)
            w = tree_get(tr.params, t.path)
            sw = slot_width(t.spec, t.dim)
            for k, off in fused_layout(t.spec, t.dim).items():
                self.slots[f"{train._path(t.path)}:{k}"] = const_change_norm(
                    w[:, off:off + sw],
                    train.slot_start(acc0 if k == "accum" else 0.0, w.dtype,
                                     w.dtype))


def fused_width(tr) -> int:
    from wide_deep_tpu_torch.optim import tree_get
    (t,) = tr.sparse_tables.values()
    return int(tree_get(tr.params, t.path).shape[1])


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
    tr = build_trainer(setup, device, weights)
    rec = Recorder()
    out: Dict[str, Any] = {"rec": rec, "fused_width": fused_width(tr)}
    if traffic["feed"] != "packed":
        raise ValueError(f"unknown feed {traffic['feed']!r}: the harness "
                         f"drives packed batches")
    probe = Probe(tr, weights)
    t = time.perf_counter()
    pool = list(CsvDataset(tr.plan, setup.rows_path, "train", B,
                           n_classes=tr.n_classes, shuffle_buffer=0,
                           seed=tr.seed, transformer=tr.transformer,
                           drop_remainder=True))
    log(f"pool: {len(pool)} batches parsed in "
        f"{time.perf_counter() - t:.2f} s; "
        + ", ".join(f"{k} {tuple(v.shape)}" for k, v in pool[0].items()
                    if k.endswith("_d%d" % setup.spec.dim)))
    cycle = train.Cycle(pool)
    it = iter(DevicePrefetchIterator(PrefetchIterator(cycle), tr._to_device))
    t = time.perf_counter()
    for _ in range(PROBED_STEPS + int(traffic["warm_steps"])):
        tr.train_batch(next(it))
    train._sync(device)
    log(f"probed and warm-up steps: {time.perf_counter() - t:.2f} s")
    if len(probe.losses) != PROBED_STEPS:
        raise RuntimeError("the probed steps did not run")
    window = train._window(tr, it, seconds, rec, device)
    out.update(window)
    out["setup_s"] = window["window_start"] - start
    out["readings"] = probe.readings()
    losses = list(tr.losses)[-window["steps"]:]
    out["failed"] = int(sum(not np.isfinite(float(x)) for x in losses))
    if trace and device.type == "cuda":
        consumed = (out["steps"] + PROBED_STEPS
                    + int(traffic["warm_steps"]))
        _traced_stretch(tr, setup, rec, out, it, pool, consumed)
    if device.type == "cuda":
        out["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(
            device))
    cycle.stop.set()
    for _ in it:
        pass
    return out


def _traced_stretch(tr, setup, rec, out, it, pool, consumed) -> None:
    """``trace_steps`` steps with the card's activity alone (the per-layer
    metrics), then ``HOST_TRACE_STEPS`` with the host's ops too."""
    from wide_deep_tpu_torch import tracing
    k = int(setup.traffic["trace_steps"])
    cap = trace_lib.Capture(os.path.join(setup.work, "trace.json"))
    hcap = trace_lib.Capture(os.path.join(setup.work, "trace_host.json"),
                             host=True)
    tracing.reset()
    with cap:
        for _ in range(k):
            tr.train_batch(next(it))
    counters = dict(tracing.snapshot()["counters"])
    with hcap:
        for _ in range(HOST_TRACE_STEPS):
            tr.train_batch(next(it))
    width = out["fused_width"]
    work = [counts_dcn.grad_work(setup.spec, width,
                                 pool[(consumed + i) % len(pool)])
            for i in range(k)]
    rec.count("grad_bound_s", sum(counts_dcn.bound_s(w) for w in work))
    out["trace"] = trace_lib.Trace(cap, k)
    out["host_trace"] = trace_lib.Trace(hcap, HOST_TRACE_STEPS)
    for c in (cap, hcap):
        trace_lib.remove(c.path)
    log("program counters over the card-only capture: " + "; ".join(
        f"{name} {v}" for name, v in sorted(counters.items())
        if name.startswith(("embed.", "sparse.", "kernels.rowdma.rowdma",
                            "kernels.scatter.range_launches.d"))))
    ops = sorted(out["trace"].grad_work_by_name().items(),
                 key=lambda kv: -kv[1])
    log("sparse-gradient work, device ms a step: " + "; ".join(
        f"{name[:160]} {ms:.4f}" for name, ms in ops))


# --------------------------------------------------------------- reference
def _parse(args):
    conf_dir, lines = args
    return ref_dcn.parse_lines(ref_dcn.Spec(conf_dir), lines)


def probed_batches(setup: Setup) -> List[Dict[str, np.ndarray]]:
    """The reference's own parse of the probed steps' rows (file order, as
    the packed pool gives them), a forked process a batch."""
    B = setup.batch_size
    with open(setup.rows_path, encoding="utf-8") as f:
        lines = [next(f).rstrip("\n") for _ in range(PROBED_STEPS * B)]
    jobs = [(setup.conf_dir, lines[k * B:(k + 1) * B])
            for k in range(PROBED_STEPS)]
    ctx = multiprocessing.get_context("fork")
    with ctx.Pool(PROBED_STEPS) as pool:
        out = pool.map(_parse, jobs)
        pool.close()
        pool.join()
    return out


def reference_readings(setup: Setup, weights: Weights, batches, device,
                       lowp: bool = False) -> Dict[str, Any]:
    """The reference's losses, first gradients, and changes of leaves and
    slots over the probed steps from the same weights, its table held at
    the rows the steps touch.  ``lowp``: the control (fp8 where the
    configuration says bfloat16)."""
    import torch
    spec = setup.spec
    held = ref_dcn.held_rows(batches)
    table = f"dnn/embed/d{spec.dim}"
    held_t = torch.from_numpy(held).to(device)
    init_rows = []
    for lo, block in weights.blocks(table):
        sel = held_t[(held_t >= lo) & (held_t < lo + block.shape[0])] - lo
        init_rows.append(block.index_select(0, sel))
    start = torch.cat(init_rows)
    params = {table: start.clone()}
    for path, *_ in spec.leaf_specs():
        if path != table:
            params[path] = weights.leaf(path)
    ref = ref_dcn.Trainer(ref_dcn.Model(spec, lowp=lowp), params)
    for b in batches:
        ref.step(ref_dcn.device_batch(spec, b, held, device))

    def norm(t):
        return float(torch.sum(torch.square(t.float()),
                               dtype=torch.float64)) ** 0.5
    out = {"losses": list(ref.losses),
           "grad_norms": {p: norm(g) for p, g in ref.first_grads.items()},
           "change_norms": {p: (norm(t - start) if p == table
                                else weights.change_norm(p, t))
                            for p, t in ref.params.items()},
           "slot_norms": {
               f"{p}:{k}": const_change_norm(s, train.slot_start(
                   ref.slot_inits[p][k], torch.float32, s.dtype))
               for p, slots in ref.slots.items() for k, s in slots.items()}}
    del ref, params
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
    weights = Weights(setup.spec.leaf_specs(), setup.seed, device)
    prog = run_program(setup, device, float(args.seconds), bool(args.trace),
                       weights, start)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = reference_readings(setup, weights, probed_batches(setup), device)
    log(f"reference: {time.perf_counter() - t:.2f} s")
    numbers = judge.training_numbers(prog["readings"], ref)
    numbers["nonfinite_losses"] = (prog["failed"], "window")
    limits = dict(cell.limits["train"], nonfinite_losses=0)
    correct = judge.verdict(numbers, limits)
    rec = prog["rec"]
    B = setup.batch_size
    rec.count("window_steps", prog["steps"])
    rec.count("batch_size", B)
    rec.count("flops_per_step", counts_dcn.step_flops(setup.spec, B))
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
