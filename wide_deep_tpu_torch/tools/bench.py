"""Benchmark: wide_deep training throughput on one card, examples/s.

    python -m wide_deep_tpu_torch.tools.bench [--device cpu]

The port's counterpart of ``bench.py``.  It builds the port's ``Trainer`` on
``conf/`` as shipped at batch 25600 (``BENCH_BATCH_SIZE``), with
``pack_budget`` pinned to 3 (``BENCH_PACK_BUDGET`` overrides, "auto"
included), and measures two stages:

* **device**: one synthetic batch (``testing.synthetic_batch``) copied to
  the card once, 3 warm-up steps, then 20 steps between two
  ``torch.cuda.synchronize()`` calls: ``step_ms`` and examples/s.  Each
  measured step's host time goes to stderr with its median, min and max.
  The loss must be finite; one that did not fall over the warm-up only
  warns.  ``BENCH_PROFILE=<dir>`` writes a torch.profiler Chrome trace of
  3 more steps there.
* **end to end** (``BENCH_E2E=0`` skips it): a diverse TSV from
  ``testing.generate_ctr_tsv`` (``hash_spread=None``), cached by size under
  ``build/bench/`` (``BENCH_E2E_FILE`` names another file); the C++
  loader's rate on one batch at 1, 2 and 4 threads; the loader alone
  through CsvDataset's fast path; the time of ``Trainer._to_device`` for
  one batch, first and steady; then ``BENCH_E2E_BATCHES`` (default 24)
  steps with the loader, the copy and the step overlapped, as
  ``Trainer.train_file`` runs them, with the time a step waited for its
  batch and the time it took to dispatch.

The one JSON line on stdout keeps ``bench.py``'s keys where they mean the
same thing, plus ``warmup_s`` and ``device`` (the card's name and power
limit from nvidia-smi).  Other knobs: ``BENCH_SCATTER=xla`` (no kernel
plans: the backward takes the plain sums), ``BENCH_SPARSE=0`` (no fused
sparse optimizer), ``BENCH_DENSE_DTYPE=bfloat16|float32``.  Left out on
purpose, because they exist only for XLA's compilation:
``BENCH_PHASE_TIMERS``, ``BENCH_AOT_PREWARM``, ``BENCH_ASSUME_OK`` and the
compile cache.  Unlike ``bench.py``, a failed end-to-end stage (the native
loader missing included) is an error: the tool exits non-zero.

With ``--device cpu`` every time is of the plain versions on the host clock.
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace
from typing import Dict, Optional

import numpy as np
import torch

from wide_deep_tpu_torch.testing import REPO_ROOT
from wide_deep_tpu_torch.tools import parse, parser

REFERENCE_CPU_EXAMPLES_PER_S = 5000.0
BATCH_SIZE = 25600
WARMUP_STEPS = 3
MEASURE_STEPS = 20
PROFILE_STEPS = 3
E2E_WARM_BATCHES = 2
E2E_BATCHES = 24
LOADER_THREADS = (1, 2, 4)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_name(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if device.type != "cuda":
        return str(device)
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def make_program(config, batch_size: int, device) -> SimpleNamespace:
    """The benchmark's program: the port's Trainer (plan, model, optimizer,
    native loader) built as a user builds it, initialised, plus one
    synthetic batch of its plan.  Nothing is copied to the card yet."""
    from wide_deep_tpu_torch import testing
    from wide_deep_tpu_torch.training.loop import Trainer
    overrides = {"batch_size": batch_size,
                 "pack_budget": os.environ.get("BENCH_PACK_BUDGET") or 3}
    if os.environ.get("BENCH_SCATTER") == "xla":
        overrides["scatter_mode"] = "xla"
    if os.environ.get("BENCH_SPARSE") == "0":
        overrides["sparse_optimizer"] = False
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32,
             None: None}[os.environ.get("BENCH_DENSE_DTYPE")]
    trainer = Trainer(config, "wide_deep",
                      model_dir=os.path.join(REPO_ROOT, "build", "bench"),
                      overrides=overrides, dtype=dtype, device=device)
    log(trainer.plan.describe())
    log(f"sparse tables: {sorted(trainer.sparse_tables)}")
    t0 = time.time()
    trainer.ensure_initialized()
    sync(trainer.device)
    log(f"init in {time.time() - t0:.1f}s")
    batch = testing.synthetic_batch(trainer.plan, batch_size,
                                    np.random.default_rng(0))
    return SimpleNamespace(config=config, trainer=trainer, batch=batch,
                           batch_size=batch_size, device=trainer.device)


def bench_device(prog, warmup: int = WARMUP_STEPS,
                 measure: int = MEASURE_STEPS) -> Dict[str, float]:
    """Steps on one batch already on the device: warm-up, then ``measure``
    steps between two synchronizations."""
    tr, dev = prog.trainer, prog.device
    dbatch = tr._to_device(prog.batch)
    t0 = time.time()
    for i in range(warmup):
        loss = tr.train_batch(dbatch)
        if i == 0:
            loss0 = float(loss)
    sync(dev)
    warmup_s = time.time() - t0
    loss_w = float(loss)
    log(f"warmup {warmup_s:.1f}s; loss {loss0:.4f} -> {loss_w:.4f}")
    if not (np.isfinite(loss0) and np.isfinite(loss_w)):
        raise RuntimeError(f"non-finite loss over the warm-up: {loss0}, "
                           f"{loss_w}")
    if loss_w >= loss0:
        log(f"WARNING: loss did not improve over warmup: {loss0} -> "
            f"{loss_w}")
    profile_dir = os.environ.get("BENCH_PROFILE")
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            for _ in range(PROFILE_STEPS):
                tr.train_batch(dbatch)
            sync(dev)
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
        log(f"profile written to {profile_dir}")
    host_ms = []
    t0 = time.time()
    for _ in range(measure):
        ts = time.perf_counter()
        loss = tr.train_batch(dbatch)
        host_ms.append((time.perf_counter() - ts) * 1e3)
    sync(dev)
    dt = time.time() - t0
    if not np.isfinite(float(loss)):
        raise RuntimeError(f"non-finite loss: {float(loss)}")
    step_ms = dt / measure * 1e3
    log("step host ms: " + " ".join(f"{x:.2f}" for x in host_ms))
    log(f"step host ms: median {float(np.median(host_ms)):.2f}, min "
        f"{min(host_ms):.2f}, max {max(host_ms):.2f}")
    log(f"{measure} steps in {dt:.3f}s -> "
        f"{prog.batch_size / step_ms * 1e3:.0f} ex/s, step {step_ms:.2f} ms")
    return {"warmup_s": warmup_s, "step_ms": step_ms,
            "steps": warmup + measure + (PROFILE_STEPS if profile_dir
                                         else 0)}


def e2e_file(prog, need_rows: int) -> str:
    """A diverse generated TSV of ``need_rows`` rows, cached by size."""
    from wide_deep_tpu_torch.testing import generate_ctr_tsv
    path = os.environ.get("BENCH_E2E_FILE") or os.path.join(
        REPO_ROOT, "build", "bench", f"e2e_train_{need_rows}.tsv")
    marker = path + ".rows"
    if os.path.exists(path) and os.path.exists(marker):
        with open(marker) as f:
            if f.read().strip() == str(need_rows):
                return path
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    t0 = time.time()
    # hash_spread=None: id diversity in proportion to each hash space, so
    # the window plans see production-like streams
    generate_ctr_tsv(prog.config, path, need_rows, seed=11, pos_rate=0.08,
                     hash_spread=None)
    with open(marker, "w") as f:
        f.write(str(need_rows))
    log(f"e2e: generated {need_rows} rows in {time.time() - t0:.0f}s")
    return path


def bench_end_to_end(prog, measure_batches: int = E2E_BATCHES,
                     warm_batches: int = E2E_WARM_BATCHES
                     ) -> Dict[str, object]:
    """Real TSV rows through the native loader, ``_to_device`` and the
    step, overlapped; plus the loader's and the copy's rates alone."""
    from wide_deep_tpu_torch.features.native import NativeTransformer
    from wide_deep_tpu_torch.features.pipeline import (CsvDataset,
                                                       DevicePrefetchIterator,
                                                       PrefetchIterator)
    tr, dev, B = prog.trainer, prog.device, prog.batch_size
    plan = tr.plan
    if not isinstance(tr.transformer, NativeTransformer):
        raise RuntimeError("the end-to-end stage measures the native "
                           "loader, and the Trainer has none")
    need_rows = (measure_batches + warm_batches + 2) * B
    path = e2e_file(prog, need_rows)
    log(f"e2e: {need_rows} rows in {path} "
        f"({os.path.getsize(path) / 1e6:.0f} MB)")
    out: Dict[str, object] = {}

    # the C++ parser alone on one batch of lines, by thread count
    with open(path, "rb") as f:
        one = b"".join(f.readline() for _ in range(B))
    curve = {}
    for n_threads in LOADER_THREADS:
        nt = NativeTransformer(plan, tr.n_classes, tr.pos_weight,
                               tr.neg_weight, n_threads=n_threads)
        nt.transform_text(one, B, B)          # thread pool warm-up
        t0 = time.perf_counter()
        nt.transform_text(one, B, B)
        curve[str(n_threads)] = B / (time.perf_counter() - t0)
    out["loader_rows_per_sec_by_threads"] = curve
    log(f"e2e: loader thread curve {curve}")

    def dataset():
        return CsvDataset(plan, path, "train", B, n_classes=tr.n_classes,
                          pos_weight=tr.pos_weight, neg_weight=tr.neg_weight,
                          seed=1, shuffle_buffer=50000,
                          transformer=tr.transformer, drop_remainder=True)

    # the loader alone through the dataset's fast path: file read,
    # shuffle, parse, kernel plans; no device
    it = iter(dataset())
    for _ in range(warm_batches):
        next(it)
    t0 = time.perf_counter()
    for _ in range(measure_batches):
        next(it)
    loader_rate = measure_batches * B / (time.perf_counter() - t0)
    out["loader_examples_per_sec"] = loader_rate
    log(f"e2e: loader alone {loader_rate:,.0f} rows/s")

    # one batch's host-to-device transfer: the first pays the pinned
    # buffer's allocation, the steady ones reuse it
    probe = next(iter(dataset()))
    out["batch_mbytes"] = sum(v.nbytes for v in probe.values()) / 1e6
    t0 = time.perf_counter()
    tr._to_device(probe)
    sync(dev)
    out["transfer_first_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for _ in range(3):
        tr._to_device(probe)
        sync(dev)
    out["transfer_steady_ms_per_batch"] = (time.perf_counter() - t0) / 3e-3
    log(f"e2e: transfer first {out['transfer_first_ms']:.3f} ms, steady "
        f"{out['transfer_steady_ms_per_batch']:.3f} ms per "
        f"{out['batch_mbytes']:.1f} MB batch")

    # loader thread -> copy thread -> step, as Trainer.train_file runs them;
    # the threads end once the last batch is taken
    batches = itertools.islice(dataset(), warm_batches + measure_batches)
    it = iter(DevicePrefetchIterator(PrefetchIterator(batches),
                                     tr._to_device))
    for _ in range(warm_batches):
        loss = tr.train_batch(next(it))
    sync(dev)
    wait_s = dispatch_s = 0.0
    t0 = time.perf_counter()
    for _ in range(measure_batches):
        tq = time.perf_counter()
        b = next(it)
        td = time.perf_counter()
        loss = tr.train_batch(b)
        wait_s += td - tq
        dispatch_s += time.perf_counter() - td
    sync(dev)
    dt = time.perf_counter() - t0
    if not np.isfinite(float(loss)):
        raise RuntimeError(f"non-finite end-to-end loss: {float(loss)}")
    out["e2e_wait_ms_per_step"] = wait_s / measure_batches * 1e3
    out["e2e_dispatch_ms_per_step"] = dispatch_s / measure_batches * 1e3
    out["end_to_end_examples_per_sec"] = measure_batches * B / dt
    out["end_to_end_step_ms"] = dt / measure_batches * 1e3
    out["steps"] = warm_batches + measure_batches
    log(f"e2e: per step: waited {out['e2e_wait_ms_per_step']:.2f} ms for "
        f"the batch, dispatched in {out['e2e_dispatch_ms_per_step']:.2f} "
        f"ms; {measure_batches} steps in {dt:.2f}s -> "
        f"{out['end_to_end_examples_per_sec']:,.0f} examples/s")
    return out


def run(prog, warmup: int = WARMUP_STEPS, measure: int = MEASURE_STEPS,
        e2e_batches: Optional[int] = E2E_BATCHES,
        e2e_warm: int = E2E_WARM_BATCHES) -> Dict[str, object]:
    """Both stages (the end-to-end one unless ``e2e_batches`` is None) ->
    the JSON line's dict."""
    dev = prog.device
    d = bench_device(prog, warmup, measure)
    ex_s = prog.batch_size / d["step_ms"] * 1e3
    out = {"metric": "wide_deep_train_examples_per_sec_per_chip",
           "value": ex_s, "unit": "examples/s/chip",
           "vs_baseline": ex_s / REFERENCE_CPU_EXAMPLES_PER_S,
           "step_ms": d["step_ms"], "warmup_s": d["warmup_s"],
           "batch_size": prog.batch_size, "device": device_name(dev)}
    steps = d["steps"]
    if e2e_batches is not None:
        e2e = bench_end_to_end(prog, e2e_batches, e2e_warm)
        steps += e2e.pop("steps")
        out.update(e2e)
    out["train_steps"] = steps
    return out


def main(argv=None):
    from wide_deep_tpu_torch.config import Config
    _, device = parse(parser(__doc__.splitlines()[0]), argv)
    batch = int(os.environ.get("BENCH_BATCH_SIZE", BATCH_SIZE))
    prog = make_program(Config(os.path.join(REPO_ROOT, "conf")), batch,
                        device)
    e2e = os.environ.get("BENCH_E2E", "1") != "0"
    out = run(prog, e2e_batches=(int(os.environ.get(
        "BENCH_E2E_BATCHES", E2E_BATCHES)) if e2e else None))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
