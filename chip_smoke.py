#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's main path on one card and hold its kernels
against their plain versions.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and a C++ compiler; builds the kernels from
``wide_deep_tpu_torch/csrc`` itself (into ``build/kernels``) and the C++
loader from ``csrc/fastdata.cc`` (into ``build/native``).  Phases, one line
each on stdout:

0. the card's name and power limit (nvidia-smi), the kernels' and the
   loader's build times;
1. K1 (range scatter-add) at the production d8, d4, d32-compact and wide
   (the wide arm's gather backward) shapes, K2 (window scatter-add) at the
   d16 shape, K1 again on that d16 stream as
   the window plan's ok=0 branch runs it, K3 (row write-back) and P2 (bulk
   row scatter) on one [10,000,128, 128] float32 table with sentinel uids,
   P2 again at that shape in bfloat16, P1 (resident gather) at its tool's
   shape (2^20 ids from a [25600, 8] pool): each against its plain PyTorch
   version on the same inputs, with its time from CUDA events beside the
   plain version's, one PyTorch library call's and the bound, and the
   device time of the kernel and of the library call from a torch.profiler
   window of 10 more calls each, after a warm-up call (the event time less the device time is the
   wrapper's host time), and again with the L2 cache flushed before each
   call by a device-to-device copy of twice its size, left out of the
   window (the warm window re-reads inputs that fit in the 50 MB L2); K1
   and K2 are each called twice and must give the
   same bits (K2's line gives the sub-window the kernel launches with, which
   must be the one its wrapper assumes); then K1 at the FM factors' gather
   backward at the global batch of 4 x 25,600 rows (``k1_fm_row``: the FM
   plan's 74-slot wide pool with each row's last 24 slots the padding, a
   run of over 2.45M entries on row 0), its chunk pass, carry levels and
   memset apart in the device times;
2. the port's ``Trainer`` on the production config (conf/, batch 25600,
   pack_budget 3): 2 steps through ``train_file`` on a generated TSV (the
   native loader's fast path, then one host-to-device copy a batch, both in
   prefetch threads), then 5 steps on seeded synthetic batches; every step,
   each read on its own,
   must launch K1 once at each of its four sites (d8, d4, d32 compact,
   wide) and K2 and K3 once each, except that a file batch whose d16 plan says ok=0
   launches K1 on the d16 stream in K2's place (its line says so), and the
   sweep kernel once a dense leaf under Ftrl and under Adagrad
   (``sweep_leaves``, both non-zero); losses
   and params must stay finite, touched d32 rows must change and an
   untouched one not;
   then (2c, after the launch counts are read) torch.profiler over 3 more
   steps after a warm-up step: wall time, the device's busy share, the top kernels by device
   time, the device time of the port's own kernels in the step, with the
   device's memsets (K1 clears its output with one; the Chrome trace goes
   to build/step_trace.json), and the host-to-device copies a step makes,
   which must be one, with their device time and the host time of
   ``Trainer._to_device``;
3. the probes' path: ``main`` of the port's two microbenchmark tools,
   in-process on the card as a user runs them (P1's; P2's in float32 and
   with ``bf16``), each of which checks its kernel against the plain
   version and prints both times; the counts are set to 0 before the
   phase and read around each tool, which must launch its kernel and no
   other;
4. ``Trainer.evaluate`` and ``Trainer.predict`` over phase 2's TSV with
   phase 2's Trainer: finite metrics, an AUC in [0, 1], one prediction a
   line, and no kernel launch;
5. the bench tool's ``main`` (``wide_deep_tpu_torch.tools.bench``) in-process
   at batch 25600 with 6 end-to-end batches and its device stage's 3-step
   profile (``BENCH_PROFILE``, read by phase 12), once phase 2's Trainer
   is freed: its JSON line must hold every key, and each of its train
   steps must launch the kernels as phase 2's do;
6. the CLIs with checkpoints, once phase 5's objects are freed, on conf/
   copied to a temporary dir (pack_budget 3; runconfig: a checkpoint and a
   summary every 2 steps, 2 checkpoints kept, a step log every step) over
   generated TSVs (two train files of 51,200 rows, eval and test files of
   25,600): ``tools.train.main`` in-process (train_and_eval, one epoch, 4
   steps at batch 25600), each step's launches read on its own as in phase
   2; steps 2 and 4 on disk and no more, the d32 table 64 columns wide
   there; the checkpoint's bytes and its save and restore seconds; step 4
   restored into a new Trainer equal to the CLI's final state leaf by leaf,
   bit for bit; a Trainer restored from the pinned step 2 training the
   second file again: its losses and final state bit for bit the CLI's
   steps 3-4; ``tools.eval.main`` from the pinned step 2 and from the
   latest (equal to the CLI Trainer's own evaluate), with no kernel launch;
   ``tools.pred.main``'s one line a test row; the summary file's scalar and
   histogram tags; ``tools.inspect_checkpoint.main`` listing every leaf;
7. serving from phase 6's latest checkpoint (step 4): ``tools.export.main``
   in-process (the bundle's bytes and seconds; the d32 table exported as
   [10,000,128, 32] bfloat16); a ``ServingModel`` on the card (max batch
   1024, buckets 16 / 128 / 1024) warmed up; the first 1024 test rows'
   scores bit for bit ``predict_step``'s on the same bucket, and all 25,600
   test rows bit for bit ``Trainer.predict``'s from the restored step 4 at
   the same batch of 1024; a ``PredictorServer`` on TCP (and gRPC where the grpc
   package imports; its line says which): the C++ client, built from
   cpp/serving_client.cc into build/native, prints what the Python TCP
   client gets, a malformed row comes back valid: false with the rows after
   it unshifted, status answers, and a version 2 exported while four
   clients score is hot-reloaded with every request answered and the old
   model drained; ``tools.bench_serving.main`` over TCP at concurrency 1, 8
   and 64 with 1 and 64 rows a request (fewer device calls than requests
   at 64);
   ``tools.microbench_serving_latency.main`` (device ms by bucket); a
   TLS-only ``PredictorServer`` on the card (a self-signed certificate
   from the openssl CLI) with ``tools.tls_proxy`` in front: the C++ client
   through the proxy prints what the direct TLS Python client gets, and a
   plaintext client on the TLS port is refused; ``tools.serving_slo``'s
   ``measure`` at 64 requests a shape (its lines printed, not gated); and
   no kernel launch anywhere in the phase;
8. the training configurations beyond the production one, each from a
   copy of conf/ with only the named model.yaml keys changed, each
   Trainer freed before the next (K1's sites told apart by the output
   shape each passes, ``site_names``; each configuration's own table of
   launches a step, ``SITES_*``):
   a. ``linear_fm_factors: 8`` (the fold goes off): the plan's wide_dim
      and ``v``'s bytes; 3 synthetic steps, then 2 ``train_file`` steps on
      a generated TSV run twice from one state, bit for bit (losses,
      params, BN and optimizer state); step 0's update of every leaf
      (FTRL on the wide table and ``v``, Adagrad on the rest, the fused d32
      rows) replayed on the host: 0 ulp apart (``recorded_update``; K1 at
      the ``v`` site is phase 1's ``k1_fm_row``); a step's device time
      from a profiler window;
   b. ``OPTIMIZER_CONFIGS``: conf/ as shipped (FTRL on the wide table and
      the fold columns, Adagrad on the rest, the fused Adagrad d32 rows),
      ProximalAdagrad on both arms, FTRL on both arms (the fused FTRL
      rows), Adam, RMSProp, Momentum and SGD on both arms: 2 synthetic
      steps each, finite losses, K3 0 a step for Adam, RMSProp and
      Momentum (not sparse-capable) and 1 for the rest; step 0's update on
      the card against the same update replayed on the host, the worst ulp
      by leaf printed, each 0 (leaves above ``RECORD_MAX_NUMEL``
      elements, the dense d32 table of the three, are not copied); in 8a
      and 8b every synthetic step launches the sweep kernel once a dense
      leaf under Ftrl or Adagrad (``sweep_leaves``);
   c. the production config: ``serve_file`` on 127.0.0.1 port 0 with a
      generated TSV of 51,200 rows, ``Trainer.train_stream(max_batches=2)``:
      each step launches what a file step does, and the same two batches,
      read by ``StreamDataset`` again, through ``train_batch`` from the
      checkpoint taken just before the stream give the same losses bit for
      bit;
   e. (after a) the sweep kernel (csrc/optim_sweep.cu) at the cells'
      largest dense leaves (``SWEEP_ROWS``: FTRL over [12,715,008, 8] and
      [10,000,640, 1] float32, Adagrad over [1,500,160, 17] bfloat16): the
      eager chain's bits on the card from one state, then each one's time
      by CUDA events and on the device beside the bound;
   (``chip_smoke.py --only optim`` runs 8a, 8e and 8b alone;)
9. quality on the card: ``tools.quality_onchip`` part B in-process (wide,
   deep and wide_deep on the production config, 5 epochs over data/train
   at batch 64, each Trainer freed before the next) holding
   tests/test_quality.py's AUC bars (> 0.70 / 0.62 / 0.64) and, for the
   wide model, its logloss (< 0.60) and prediction/mean (in (0.12, 0.40))
   bars, which the deep arm misses on the production tables in the JAX
   package too (``CALIBRATION_BARS``; every figure printed beside its
   bar), every step's launches read against its model type's table
   (``SITES_QUALITY``); then
   ``tools.quality_matrix.main`` on two variants at 200,000 rows, every
   step's launches read (``SITES_MATRIX``), AUC > 0.70;
10. the CNN arm, each Trainer on a copy of conf/ (``conf_copy``) with
    ``cnn_use_flag: 1``, batch 64, over data/train's rows paired by index
    with data/image/train.tfrecords, freed before the next, every step's
    launches read against ``SITES_QUALITY["wide_deep"]`` (K1 wide, K1 d32
    compact and K3 once each):
    a. VGG16 (conf/'s ``cnn_model``, Adagrad lr 0.05, decay 0.8): 20
       ``train_file`` steps, finite losses, every ``cnn`` leaf changed at
       step 0, step 0's update replayed on the host (``recorded_update``:
       0 ulp), step 0's K1 and K3 launches held against their plain
       versions on the same inputs (``held_to_plain``: K1 at the wide
       gather and at the d32 compact sum, K3's write of the touched rows),
       the median step ms between CUDA events and images/s; the
       image assembly's host ms a batch; a profiler window (device ms a
       step, the convolutions' device ms and share, the top kernels, the
       port's kernels, one host-to-device copy a step); the arm's forward
       + backward twice on one batch of 64 (the same bits), and at batch
       2 against the port on the host in float32 and float64
       (``testing.cnn_disagreement``, the CPU tests' tolerances); a
       checkpoint restored into a new Trainer bit for bit; ``evaluate``
       over data/eval with no launch; ``tools.train.main`` (2 steps),
       ``tools.eval.main`` and ``tools.export.main`` with the
       ``--image_*_data`` flags, the bundle holding every ``cnn`` leaf;
    b. ResNet-50 v2 (``cnn_model: resnet``, size 50): 5 steps, step 0's
       K1 and K3 launches held against their plain versions, final_bn's
       running stats after step 0 against the host's ``0.99 old + 0.01
       batch`` (population variance), the profile, an eval forward from the
       running stats against the host's, the double call and the card vs
       host check, ``evaluate``;
    c. data/image/train.tfrecords read (crc checked) and written back by
       the port's codec: the same bytes, PIL not loaded;
11. training across ranks (PR 13): conf/ copied with ``pack_budget: 3``
    and the mesh ``{data: 2, model: 1}``, a generated TSV of 5 global
    batches of 25,600 rows and an eval TSV of 25,600: first one device
    trains the 5 batches from the seed's weights, evaluates and saves;
    then ``wide_deep_tpu_torch.tools.input_server`` (a subprocess) and 2
    ranks (``chip_smoke.py --sharded-rank``, the WDT_* variables of the
    JAX launcher; ``parallel.mesh.placement``: both on the one card over
    gloo, a card each over NCCL where there are two) run
    ``tools.train.main`` on the production model at full width, 12,800
    rows a rank, each holding half of every row-sharded table: every
    step's launches read against ``SITES_SHARDED`` (K1 on the rank's d8
    range plan row, its d32 compact plan row, the replicated d4 group and
    the wide table's shard; K2 on its d16 window plan row, or K1 when the
    row says ok=0; K3 into its d32 shard), step 0's K1 / K2 / K3 launches
    held against their plain versions on the per-shard inputs, each
    step's ms by CUDA events and the exchange's bytes by the port's
    counter; the ranks' losses the same bits; their losses, ``evaluate``
    and whole state after 5 steps against one device's within
    ``SHARDED_*_TOL``; one device's checkpoint restored into each rank's
    rows bit for bit, and the ranks' checkpoint (rank 0 writes the whole
    leaves) into one device bit for bit; then the mesh ``{data: 1,
    model: 2}`` without the input service (each rank reads the global
    batch), its losses against one device's; the NCCL ranks on separate
    cards only with two cards, else a line says they did not run; then
    ``sharded_lookup: dedup`` (PR 14) on ``{data: 1, model: 2}`` and on
    ``{data: 2, model: 1}`` behind an input service of its own: every
    step's launches read against ``SITES_DEDUP`` (K1 at the d8 and d16
    groups' slot sums, never K2), step 0's launches held against their
    plain versions, the slot sums also timed without the routing of
    weight-0 entries (the carry pass apart), losses against one device's;
    in every run of the phase each step's exchange bytes a rank, by tag,
    must equal ``parallel.collective_stats``' prediction from shapes
    alone; every held launch is timed beside its plain version and its
    library call (``index_add_``, ``index_copy_``);
12. the perf gate (PR 14) on phase 5's trace of the bench tool's device
    stage (3 steps, ``BENCH_PROFILE``): ``tools.parse_trace``,
    ``tools.perf_regression capture`` (build/perf_budget_capture.json)
    and ``check`` against that capture; the ms a step by bucket and the
    port's kernels printed; fails on an empty trace or a kernel the step
    launched missing from the ``kernel`` bucket; the committed
    perf_budget_torch.json compared, not gated;
13. DLRM-DCNv2 (``dnn_bottom_units``, ``dnn_interaction: dcn``, the
    RowwiseAdagrad d128 table, sum pooling; alone: ``python3 chip_smoke.py
    --only dcn``): K1 at d128 over the stream of the benchmark cell
    ``dcnv2_train_packed`` (8,192 rows x 214 ids drawn zipf-1.3 over the
    26 tables' rows held on one of 8 GPUs, ``DCN_TABLES``; its compact
    plan, 1,753,088 entries, bfloat16 gradients summed in float32 into
    the plan's distinct rows, as the step calls it) and K3 writing those
    rows into the [26,500,352, 132] float32 table (and
    again at 136 columns, the rounding to whole 32-byte sectors that the
    table's width does not take), each held to its plain version and
    timed as a phase 1 row; then the port's Trainer on a small DCN conf
    (``DCN_SMALL``, its tables fused at any size) for 3 steps on the card
    and on the host from one state: every step launches K1 once at d128
    and K3 once at width 132 and the sweep kernel once a dense Adagrad
    leaf, the card's losses and state within
    ``DCN_TOL`` of the host's, and the step's ms by CUDA events;
then one JSON line describing the kernels (with each row's launches on the
CLI path, on the CNN path and, by rank, on the sharded path and the dedup
path; the dedup slot sums have rows of their own, and 8e's sweeps rows
with their launches on phase 2's steps and on phase 13's; every row must
have launched on its path), and the device line.

Exits non-zero on any failure, and at once when there is no CUDA device.
"""

import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 25600
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_OPS_PER_S = 67e12          # float32 outside the tensor cores
BF16_TOL = 2.0 ** -7           # one bfloat16 ulp, relative
SLO_REQUESTS = 64              # phase 7's serving_slo.measure, a shape
# csrc kernels a train step launches (K1's chunk and carry passes, K2, K3)
# and the device's memsets (K1 clears its output with one)
PORTED_STEP_KERNELS = ("range_chunk_kernel", "range_carry_kernel",
                       "window_scatter_kernel", "rowdma_kernel", "Memset")


def log(msg):
    print(msg, flush=True)


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dev_us(e):
    """A profiler entry's own device time in microseconds."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0))


def on_device(e):
    """Whether a profiler entry is work on the card (a kernel, memset or
    copy): the schedule's ``ProfilerStep*`` spans also carry a device-side
    entry, which covers the step's kernels and would count them twice."""
    return (str(e.device_type).endswith("CUDA")
            and not e.key.startswith("ProfilerStep"))


_L2 = {}


def flush_l2():
    """Evict the card's L2 cache (50 MB on an H100): a device-to-device copy
    of twice its size, which shows in a profile as one "Memcpy DtoD"."""
    import torch
    if not _L2:
        n = 2 * torch.cuda.get_device_properties(0).L2_cache_size
        _L2["src"] = torch.ones(n, dtype=torch.uint8, device="cuda")
        _L2["dst"] = torch.empty_like(_L2["src"])
    _L2["dst"].copy_(_L2["src"])


def device_ms(fn, calls=10, flushed=False, attempts=3):
    """Device time of one ``fn()`` by what ran: every kernel, memset and
    copy on the card in a torch.profiler window around ``calls`` calls,
    after one warm-up call inside the profiler (the tracer can miss the
    first operations after it starts) -> ({short name: ms per call},
    whether the window is whole).  The tracer also drops events now and
    then (a whole window, or some of a kernel's launches): a window is
    whole when it holds device work and every entry ran a multiple of
    ``calls`` times; up to ``attempts`` windows are taken until one is.
    ``flushed``: the L2 cache is flushed before each call (``flush_l2``),
    and the flush's copies are left out, so the inputs come from HBM, as
    the step's first touch of them does; the call itself must then make
    no device-to-device copy."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=calls,
                                       repeat=1)) as prof:
            for i in range(calls + 1):
                if flushed:
                    flush_l2()
                fn()
                if i == calls:
                    torch.cuda.synchronize()
                prof.step()
        parts, whole = {}, True
        for e in prof.key_averages():
            if flushed and "DtoD" in e.key:
                continue
            if on_device(e) and dev_us(e) > 0:
                m = re.search(r"(\w+)[<(]", e.key)
                name = m.group(1) if m else e.key.split(" (")[0]
                parts[name] = parts.get(name, 0.0) + dev_us(e) / 1e3 / calls
                whole = whole and e.count % calls == 0
        if parts and whole:
            return parts, True
    return parts, False


def bits(t):
    import torch
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def check_scatter(name, fn, plain, library, out_dtype, n_live, d, rows,
                  in_bytes_per_el, extra_bytes, source, replaces,
                  memset=False, magnitudes=None):
    """Hold one scatter kernel against its plain version, require the same
    bits from two calls, and time it.  ``memset``: the kernel clears its
    output first; the row then also gives the bound with those bytes.
    ``magnitudes``: the plain sum of |g| (rows summing thousands of
    repeats): float32 round-off grows with the magnitudes summed, not with
    what is left after they cancel, so the tolerance is 1e-6 of it."""
    import torch
    got = fn()
    again = fn()
    want = plain()
    torch.cuda.synchronize()
    if not torch.equal(bits(got), bits(again)):
        raise SystemExit(f"{name}: two calls gave different bits")
    gf, wf = got.float(), want.float()
    err = (gf - wf).abs()
    if out_dtype == torch.bfloat16:
        tol = BF16_TOL * wf.abs() + 1e-6   # each rounds its f32 sum once
        tol_text = "<= 1 bf16 ulp (2^-7 rel) + 1e-6"
    elif magnitudes is not None:
        tol = 1e-6 * magnitudes().float() + 1e-6
        tol_text = "<= 1e-6 of the row's sum of |g| + 1e-6"
    else:
        tol = 1e-5 * wf.abs() + 1e-5       # f32 sums in another order
        tol_text = "<= 1e-5 rel + 1e-5"
    ok = bool((err <= tol).all())
    max_err = float(err.max()) if err.numel() else 0.0
    out_es = torch.finfo(out_dtype).bits // 8
    n_bytes = n_live * (4 + 4 + d * in_bytes_per_el) + rows * d * out_es \
        + extra_bytes
    row = timed_row(name, source, replaces, max_err, tol_text, ok, fn,
                    plain, library, n_bytes, n_live * d)
    if memset:
        row["bound_ms_with_memset"] = bound_ms(
            n_bytes + rows * d * out_es, n_live * d)[0]
    return row


def check_writeback(name, fn, table, uids, new_rows, source, replaces):
    """Hold one row write-back kernel (K3, P2) against the plain version on
    a copy of ``table`` (exact) and time it; ``index_copy_`` of the live
    rows is the library call."""
    import torch

    from wide_deep_tpu_torch.ops import rowdma
    n = uids.shape[0]
    valid = (uids >= 0) & (uids < table.shape[0])
    n_valid = int(valid.sum())
    if n_valid == n:
        raise SystemExit("expected sentinel uids in the compact plan")
    table_p = table.clone()
    fn(table, uids, new_rows)
    rowdma.rowdma_scatter_rows_plain(table_p, uids, new_rows)
    torch.cuda.synchronize()
    exact = bool(torch.equal(table, table_p))
    max_err = float((table - table_p).abs().max())
    del table_p
    lib_uids = uids[valid].long()
    lib_rows = new_rows[valid]
    row_bytes = table.shape[1] * table.element_size()
    return timed_row(
        name, source, replaces, max_err, "exact", exact,
        lambda: fn(table, uids, new_rows),
        lambda: rowdma.rowdma_scatter_rows_plain(table, uids, new_rows),
        lambda: table.index_copy_(0, lib_uids, lib_rows),
        n * 4 + n_valid * row_bytes * 2, 0)


def timed_row(name, source, replaces, max_err, tol_text, ok, fn, plain,
              library, n_bytes, n_ops):
    """One kernel's row of the kernels line: its time, the plain
    version's, the library call's (each the median of 20 runs by CUDA
    events, the tools' timer), the kernel's and the library call's device
    time (``device_ms``) and the bound; logged on one line."""
    import torch

    from wide_deep_tpu_torch.tools import median_ms
    dev = torch.device("cuda")
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": 0, "max_abs_err": max_err,
           "tolerance": tol_text, "ok": ok,
           "ms": median_ms(fn, 20, dev), "plain_ms": median_ms(plain, 20, dev),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": median_ms(library, 20, dev)}
    windows = {"device_ms": device_ms(fn),
               "library_device_ms": device_ms(library),
               "device_ms_flushed": device_ms(fn, flushed=True),
               "library_device_ms_flushed": device_ms(library, flushed=True)}
    if any("DtoD" in k for key in ("device_ms", "library_device_ms")
           for k in windows[key][0]):
        raise SystemExit(f"{name}: a device-to-device copy in the call; "
                         f"the flushed time could not leave out the flush")
    for key, (p, _) in windows.items():
        row[key] = sum(p.values())
    # windows the profiler left incomplete in every attempt
    row["profile_incomplete"] = [k for k, (_, whole) in windows.items()
                                 if not whole]
    parts, cold = windows["device_ms"][0], windows["device_ms_flushed"][0]
    log(f"phase 1: {name}: max_abs_err {max_err:.3g} ({tol_text}) "
        f"{'ok' if ok else 'FAILED'}; kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}); on the device: kernel "
        f"{row['device_ms']:.4f} ms ("
        + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
        + f"), library {row['library_device_ms']:.4f} ms; L2 flushed "
        f"before each call: kernel {row['device_ms_flushed']:.4f} ms ("
        + ", ".join(f"{k} {v:.4f}" for k, v in cold.items())
        + f"), library {row['library_device_ms_flushed']:.4f} ms"
        + (f"; the profiler dropped events in {row['profile_incomplete']}"
           if row["profile_incomplete"] else ""))
    if not ok:
        raise SystemExit(f"{name} disagrees with its plain version")
    return row


FM_ROWS = 4 * BATCH      # k1_fm_row's rows: the reference cluster's global
                         # batch, 4 workers x 25,600
FM_PADDING = 24          # padded slots of a parsed row's 74 in the FM pool


def k1_fm_row(device, gen):
    """K1 at the FM factors' gather backward (``linear_fm_factors: 8``) at
    FM_ROWS rows: the FM plan's wide pool from ``testing.synthetic_batch``,
    which fills every slot, with each row's last FM_PADDING slots set to
    the padding id 0, as the generated TSV rows leave them once parsed
    (32.4% of the pool), sorted stably; float32 gradients of width 8
    into [wide_dim, 8] float32, held to its plain version and timed as a
    kernels row (``check_scatter``).  -> the row."""
    import numpy as np
    import torch

    from wide_deep_tpu_torch import testing
    from wide_deep_tpu_torch.ops import scatter
    from wide_deep_tpu_torch.training.loop import build_training_plan
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fm_")
    try:
        config = conf_copy(tmp, "conf_fm", linear_fm_factors=FM_FACTORS)
        plan = build_training_plan(
            config, dict(config.train, batch_size=FM_ROWS, pack_budget=3),
            "wide_deep")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    wide = testing.synthetic_batch(plan, FM_ROWS, np.random.default_rng(7)
                                   )["wide_ids"]
    wide[:, -FM_PADDING:] = 0
    wide = wide.reshape(-1)
    order = np.argsort(wide, kind="stable").astype(np.int32)
    ids = torch.from_numpy(wide[order]).to(device)
    perm = torch.from_numpy(order).to(device)
    g = torch.randn((wide.size, FM_FACTORS), generator=gen, device=device)
    rows = plan.wide_dim
    log(f"phase 1: K1 v (FM): {wide.size} ids ({FM_ROWS} rows x "
        f"{plan.wide_packed_len} slots), a run of {int((wide == 0).sum())} on "
        f"row 0; {scatter.range_carry_levels(wide.size)} carry levels")
    return check_scatter(
        "K1 range_scatter_add v (FM)",
        lambda: scatter.sorted_stream_sum(ids, perm, g, rows, torch.float32),
        lambda: scatter.range_scatter_add_plain(ids, perm, g, rows,
                                                torch.float32),
        lambda: torch.zeros((rows, FM_FACTORS), device=device).index_add_(
            0, ids.long(), g[perm.long()]),
        torch.float32, wide.size, FM_FACTORS, rows, 4, 0,
        "wide_deep_tpu_torch/csrc/range_scatter.cu",
        "wide_deep_tpu/ops/scatter.py:184", memset=True,
        magnitudes=lambda: scatter.range_scatter_add_plain(
            ids, perm, g.abs(), rows, torch.float32))


def phase_kernels(plan, batch, device):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from wide_deep_tpu_torch.ops import gather, rowdma, scatter

    gen = torch.Generator(device=device).manual_seed(0)
    groups = {g.dim: g for g in plan.groups}
    rows_out = []

    def t(key):
        return torch.from_numpy(batch[key]).to(device)

    def stream(prefix, dim, width, dtype, rows):
        ids, perm = t(f"{prefix}_ids_d{dim}"), t(f"{prefix}_perm_d{dim}")
        tiles = t(f"{prefix}_tiles_d{dim}")
        g = torch.randn((ids.shape[0], width), generator=gen, device=device,
                        dtype=torch.float32).to(dtype)
        keep = (ids >= 0) & (ids < rows)
        lib_ids = ids[keep].long()
        lib_g = g[perm[keep].long()]
        n_live = int(keep.sum())
        return ids, perm, tiles, g, lib_ids, lib_g, n_live

    src = "wide_deep_tpu_torch/csrc/range_scatter.cu"
    rep = "wide_deep_tpu/ops/scatter.py:184"
    for dim, in_dt in ((8, torch.bfloat16), (4, torch.bfloat16)):
        g_ = groups[dim]
        width = dim + 1                       # embedding + folded wide col
        ids, perm, tiles, g, lib_ids, lib_g, n_live = stream(
            "scat", dim, width, in_dt, g_.rows)
        rows = g_.rows
        rows_out.append(check_scatter(
            f"K1 range_scatter_add d{dim}",
            lambda: scatter.range_scatter_add(ids, perm, g, tiles, rows,
                                              in_dt),
            lambda: scatter.range_scatter_add_plain(ids, perm, g, rows,
                                                    in_dt),
            lambda: torch.zeros((rows, width), dtype=in_dt,
                                device=device).index_add_(0, lib_ids, lib_g),
            in_dt, n_live, width, rows, 2, 0, src, rep, memset=True))
    # the wide gather's backward: the pooled wide ids sorted stably, one
    # float32 gradient column, into the [wide_dim, 1] table's gradient
    wide = batch["wide_ids"].reshape(-1)
    wperm = np.argsort(wide, kind="stable").astype(np.int32)
    w_ids = torch.from_numpy(wide[wperm]).to(device)
    w_perm = torch.from_numpy(wperm).to(device)
    w_g = torch.randn((wide.size, 1), generator=gen, device=device)
    w_rows = plan.wide_dim
    rows_out.append(check_scatter(
        "K1 range_scatter_add wide",
        lambda: scatter.sorted_stream_sum(w_ids, w_perm, w_g, w_rows,
                                          torch.float32),
        lambda: scatter.range_scatter_add_plain(w_ids, w_perm, w_g, w_rows,
                                                torch.float32),
        lambda: torch.zeros((w_rows, 1), device=device).index_add_(
            0, w_ids.long(), w_g[w_perm.long()]),
        torch.float32, wide.size, 1, w_rows, 4, 0, src, rep, memset=True,
        magnitudes=lambda: scatter.range_scatter_add_plain(
            w_ids, w_perm, w_g.abs(), w_rows, torch.float32)))
    del w_ids, w_perm, w_g
    # d32 compact sum of the fused sparse optimizer: f32 in and out
    ids, perm, tiles, g, lib_ids, lib_g, n_live = stream(
        "sopt", 32, 32, torch.float32, BATCH * plan.group_packed_len[32])
    n = ids.shape[0]
    rows_out.append(check_scatter(
        "K1 range_scatter_add d32 compact",
        lambda: scatter.range_scatter_add(ids, perm, g, tiles, n,
                                          torch.float32),
        lambda: scatter.range_scatter_add_plain(ids, perm, g, n,
                                                torch.float32),
        lambda: torch.zeros((n, 32), dtype=torch.float32,
                            device=device).index_add_(0, lib_ids, lib_g),
        torch.float32, n_live, 32, n, 4, 0, src, rep, memset=True))
    # K2 at the d16 shape
    g16 = groups[16]
    if int(batch["wscat_ok_d16"][0]) != 1:
        raise SystemExit("the synthetic d16 window plan overflowed (ok=0)")
    ids, perm, tiles, g, lib_ids, lib_g, n_live = stream(
        "wscat", 16, 17, torch.bfloat16, g16.rows)
    wcap = scatter.window_cap(ids.shape[0], g16.rows)
    sub = scatter.kernel_window_sub_rows(17, torch.bfloat16)
    if sub != scatter.window_sub_rows(17, torch.bfloat16):
        raise SystemExit(f"K2 launches {sub}-row sub-windows, its wrapper "
                         f"assumes {scatter.window_sub_rows(17, torch.bfloat16)}")
    log(f"phase 1: K2 d16: {n_live} live ids, {tiles.shape[1]} windows of "
        f"{scatter.MAXR} rows, {-(-g16.rows // sub)} blocks of {sub}-row "
        f"sub-windows ({sub * 17 * 2}-byte slabs)")
    rows_out.append(check_scatter(
        "K2 window_scatter_add d16",
        lambda: scatter.window_scatter_add(ids, perm, g, tiles, g16.rows,
                                           wcap, torch.bfloat16),
        lambda: scatter.window_scatter_add_plain(ids, perm, g, g16.rows,
                                                 torch.bfloat16),
        lambda: torch.zeros((g16.rows, 17), dtype=torch.bfloat16,
                            device=device).index_add_(0, lib_ids, lib_g),
        torch.bfloat16, n_live, 17, g16.rows, 2, tiles.numel() * 4,
        "wide_deep_tpu_torch/csrc/window_scatter.cu",
        "wide_deep_tpu/ops/scatter.py:355"))
    # the d16 window plan's ok=0 branch: K1 on the same stream, no tiles;
    # timed against today's library call, zeros + index_add_ in bf16
    rows_out.append(check_scatter(
        "K1 range_scatter_add d16 ok=0",
        lambda: scatter.sorted_stream_sum(ids, perm, g, g16.rows,
                                          torch.bfloat16),
        lambda: scatter.range_scatter_add_plain(ids, perm, g, g16.rows,
                                                torch.bfloat16),
        lambda: torch.zeros((g16.rows, 17), dtype=torch.bfloat16,
                            device=device).index_add_(0, lib_ids, lib_g),
        torch.bfloat16, n_live, 17, g16.rows, 2, 0, src, rep, memset=True))
    del ids, perm, tiles, g, lib_ids, lib_g
    # logged, not a row of the kernels line: its site launches in phase 8a
    k1_fm_row(device, gen)
    torch.cuda.empty_cache()

    # K3, then P2, on the production fused table, sentinel uids included
    g32 = groups[32]
    uids = t("sopt_uids_d32")
    n = uids.shape[0]
    log(f"phase 1: row write-backs: {n} sorted uids "
        f"({int((uids >= g32.rows).sum())} sentinels) into "
        f"[{g32.rows}, {rowdma.FUSED_WIDTH}]")
    table = torch.randn((g32.rows, rowdma.FUSED_WIDTH), generator=gen,
                        device=device)
    new_rows = torch.randn((n, rowdma.FUSED_WIDTH), generator=gen,
                           device=device)
    rows_out.append(check_writeback(
        "K3 rowdma_scatter_rows d32", rowdma.rowdma_scatter_rows, table,
        uids, new_rows, "wide_deep_tpu_torch/csrc/rowdma.cu",
        "wide_deep_tpu/ops/rowdma.py:80"))
    # fresh values for P2: K3's runs already wrote new_rows into the table,
    # and a kernel that wrote nothing would then pass the check
    p2 = ("wide_deep_tpu_torch/csrc/bulk_row_scatter.cu",
          "tools/microbench_rowdma_scatter.py:68")
    table.normal_(generator=gen)
    p2_row = check_writeback("P2 bulk_scatter_rows f32",
                             rowdma.bulk_scatter_rows, table, uids, new_rows,
                             *p2)
    del table
    torch.cuda.empty_cache()
    table = torch.randn((g32.rows, rowdma.FUSED_WIDTH), generator=gen,
                        device=device).to(torch.bfloat16)
    p2_row["bf16"] = check_writeback(
        "P2 bulk_scatter_rows bf16", rowdma.bulk_scatter_rows, table, uids,
        new_rows.to(torch.bfloat16), *p2)
    del table, new_rows
    torch.cuda.empty_cache()

    # P1 at its tool's shape: 2^20 ids (the d8 stream) from a [25600, 8]
    # pool
    n1, b1, d1 = 1 << 20, 25600, 8
    seg = torch.randint(0, b1, (n1,), generator=gen, device=device,
                        dtype=torch.int32)
    w = torch.rand(n1, generator=gen, device=device)
    dpool = torch.randn((b1, d1), generator=gen, device=device)
    got = gather.resident_gather(seg, w, dpool)
    want = gather.resident_gather_plain(seg, w, dpool)
    torch.cuda.synchronize()
    offsets = torch.arange(n1, device=device, dtype=torch.int32)
    rows_out.append(timed_row(
        "P1 resident_gather", "wide_deep_tpu_torch/csrc/resident_gather.cu",
        "tools/microbench_vmem_gather.py:38",
        float((got - want).abs().max()), "exact",
        bool(torch.equal(got, want)),
        lambda: gather.resident_gather(seg, w, dpool),
        lambda: gather.resident_gather_plain(seg, w, dpool),
        lambda: F.embedding_bag(seg, dpool, offsets, mode="sum",
                                per_sample_weights=w),
        n1 * (4 + 4 + d1 * 4) + b1 * d1 * 4, n1 * d1))
    rows_out.append(p2_row)
    del seg, w, dpool, got, want, offsets
    _L2.clear()
    torch.cuda.empty_cache()
    return rows_out


# K1's call sites on the production step, by the gradient width D they pass
# (17: the d16 fold's stream, summed by K1 when its window plan says ok=0;
# 1: the wide table's gather, summed by K1 over its stably sorted ids)
K1_SITES = {9: "d8", 5: "d4", 32: "d32 compact", 17: "d16 ok=0", 1: "wide"}
# launches each production step must add: K1 once at each of its four
# sites, K3 once, and on the d16 stream either K2 (ok=1) or K1 (ok=0) once
PER_STEP = {"K1 d8": 1, "K1 d4": 1, "K1 d32 compact": 1, "K1 wide": 1,
            "K3": 1}


def counts():
    from wide_deep_tpu_torch.ops import gather, optim_sweep, rowdma, scatter
    out = {"K1": scatter.range_launches, "K2": scatter.window_launches,
           "d16 ok=0": scatter.window_ok0_launches,
           "K3": rowdma.rowdma_launches,
           "P1": gather.resident_gather_launches,
           "P2": rowdma.bulk_scatter_launches,
           "S Ftrl": optim_sweep.ftrl_launches,
           "S Adagrad": optim_sweep.adagrad_launches}
    for d, n in scatter.range_launches_by_width().items():
        out[f"K1 {K1_SITES.get(d, f'D={d}')}"] = n
    return out


def reset_counts():
    from wide_deep_tpu_torch.ops import gather, optim_sweep, rowdma, scatter
    scatter.range_launches = 0
    scatter.window_launches = 0
    scatter.window_ok0_launches = 0
    rowdma.rowdma_launches = 0
    gather.resident_gather_launches = 0
    rowdma.bulk_scatter_launches = 0
    optim_sweep.ftrl_launches = 0
    optim_sweep.adagrad_launches = 0
    scatter.range_launches_by_shape.clear()


def delta(before, after):
    return {k: after[k] - before.get(k, 0) for k in after}


def check_step(what, d):
    """One production step's counter changes ``d``: K1 once at each of its
    four sites, K3 once, the probes (P1, P2) never, and on the
    d16 stream K2 once, or (ok=0) K1 once at D=17 and K2 never."""
    ok0 = d["d16 ok=0"]
    want = dict(PER_STEP, **{"K1 d16 ok=0": ok0})
    got = {k: d.get(k, 0) for k in want}
    if (got != want or ok0 + d["K2"] != 1 or d["K1"] != 4 + ok0
            or d["P1"] or d["P2"]):
        raise SystemExit(f"{what} launched {d}")


def phase_trainer(card, tmp):
    import numpy as np
    import torch

    from wide_deep_tpu_torch import testing
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.features.native import NativeTransformer
    from wide_deep_tpu_torch.optim import tree_items
    from wide_deep_tpu_torch.training.loop import Trainer

    config = Config(os.path.join(ROOT, "conf"))
    tsv = os.path.join(tmp, "train.tsv")
    testing.generate_ctr_tsv(config, tsv, 2 * BATCH, seed=0,
                             hash_spread=None)
    trainer = Trainer(config, "wide_deep", model_dir=tmp,
                      overrides={"batch_size": BATCH, "pack_budget": 3},
                      device="cuda")
    if not isinstance(trainer.transformer, NativeTransformer):
        raise SystemExit(f"the Trainer loads with "
                         f"{type(trainer.transformer).__name__}, not the "
                         f"native loader")
    t0 = time.time()
    trainer.ensure_initialized()
    torch.cuda.synchronize()
    log(f"phase 2: Trainer initialised in {time.time() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")

    # each file step's counter changes, read around the Trainer's own step
    file_steps = []
    train_batch = trainer.train_batch

    def counted_step(batch):
        c0 = counts()
        loss = train_batch(batch)
        file_steps.append(delta(c0, counts()))
        return loss

    trainer.train_batch = counted_step
    reset_counts()                      # the main path starts here
    # (a) two steps through train_file on the generated TSV
    t0 = time.time()
    trainer.train_file(tsv, max_steps=2)
    torch.cuda.synchronize()
    del trainer.train_batch
    if len(file_steps) != 2 or trainer.global_step != 2:
        raise SystemExit(f"train_file took {len(file_steps)} steps")
    # the main path's dense update: one sweep a Ftrl / Adagrad leaf a step
    sweeps = sweep_leaves(trainer)
    if not all(sweeps.values()):
        raise SystemExit(f"the production config sweeps {sweeps} a step")
    for i, d in enumerate(file_steps):
        check_step(f"file step {i}", d)
        check_sweeps(f"file step {i}", d, sweeps)
    file_counts = counts()
    file_losses = [float(x) for x in trainer.losses]
    log(f"phase 2a: train_file 2 steps in {time.time() - t0:.1f} s through "
        f"the native loader ({trainer.transformer.n_threads} threads, fast "
        f"path) and one prefetched copy a batch; file-step losses "
        f"{file_losses}, launches per step {file_steps}"
        + (f" (d16 ok=0 on {file_counts['d16 ok=0']} batch(es): K1 in "
           f"K2's place)" if file_counts["d16 ok=0"] else ""))

    # (b) five steps on seeded synthetic batches
    rng = np.random.default_rng(1)
    table = trainer.params["dnn"]["embed"]["d32"]
    step_ms, losses = [], []
    for i in range(5):
        batch = testing.synthetic_batch(trainer.plan, BATCH, rng)
        if int(batch["wscat_ok_d16"][0]) != 1:
            raise SystemExit(f"synthetic step {i}: d16 window plan ok=0")
        # rows read with a non-zero pool weight get a non-zero gradient
        live = batch["emb_ids_d32"][batch["emb_wts_d32"] > 0]
        touched = torch.from_numpy(np.unique(live)[:256]).long()
        untouched = int(np.setdiff1d(np.arange(1000),
                                     batch["emb_ids_d32"])[0])
        before = table[touched.to(table.device)].clone()
        before_u = table[untouched].clone()
        c0 = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = trainer.train_batch(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        d = delta(c0, counts())
        check_step(f"synthetic step {i}", d)
        check_sweeps(f"synthetic step {i}", d, sweeps)
        if d["K2"] != 1:
            raise SystemExit(f"synthetic step {i}: d16 took the ok=0 branch")
        losses.append(float(loss))
        after = table[touched.to(table.device)]
        if not bool((after[:, :32] != before[:, :32]).any(dim=1).all()):
            raise SystemExit("a touched d32 row did not change")
        if not torch.equal(table[untouched], before_u):
            raise SystemExit("an untouched d32 row changed")
    main_counts = counts()
    all_losses = file_losses + losses
    if not all(np.isfinite(all_losses)):
        raise SystemExit(f"non-finite loss: {all_losses}")
    for path, leaf in tree_items(trainer.params):
        if not bool(torch.isfinite(leaf).all()):
            raise SystemExit(f"non-finite param {'/'.join(map(str, path))}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"phase 2b: 5 synthetic steps, median step "
        f"{float(np.median(step_ms)):.2f} ms (min {min(step_ms):.2f}, max "
        f"{max(step_ms):.2f}) at batch {BATCH} on {card}; losses {losses}; "
        f"launches per step K1 4 (d8, d4, d32 compact, wide 1 each), K2 1, "
        f"K3 1, sweeps {sweeps}; "
        f"peak memory {peak:.2f} GB")
    profile_steps(trainer, rng)
    return trainer, tsv, main_counts


def profile_steps(trainer, rng, n_steps=3):
    """Where a step's time goes: torch.profiler over ``n_steps`` synthetic
    steps after one warm-up step inside the profiler (the tracer can miss
    the first operations after it starts; batches built before the window)
    -> one line with the wall time per step, the device's busy share and
    the top operators by device time.  Runs after the main path's launch
    counts were read."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from wide_deep_tpu_torch import testing
    batches = [testing.synthetic_batch(trainer.plan, BATCH, rng)
               for _ in range(n_steps + 1)]
    torch.cuda.synchronize()
    to_device_ms = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=n_steps,
                                   repeat=1)) as prof:
        for i, b in enumerate(batches):
            if i == 1:                  # the recorded steps start here
                t0 = time.perf_counter()
            th = time.perf_counter()
            db = trainer._to_device(b)
            if i:
                to_device_ms.append((time.perf_counter() - th) * 1e3)
            trainer.train_batch(db)
            if i == n_steps:
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
            prof.step()

    # the kernels' own entries (device type CUDA), so no time counts twice
    kernels = sorted(filter(on_device, prof.key_averages()),
                     key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3 / n_steps
    top = [f"{e.key[:60]} {dev_us(e) / 1e3 / n_steps:.3f} ms x"
           f"{e.count // n_steps}" for e in kernels[:15] if dev_us(e) > 0]
    log(f"phase 2c: profile of {n_steps} steps: {wall_ms:.2f} ms/step wall, "
        f"device busy {busy_ms:.2f} ms/step "
        f"({100 * busy_ms / wall_ms:.1f}%); top by device time: "
        + ("; ".join(top) if top else "the profiler saw no device time"))
    ported = [f"{name} {sum(dev_us(e) for e in hits) / 1e3 / n_steps:.4f} "
              f"ms x{sum(e.count for e in hits) // n_steps}"
              for name in PORTED_STEP_KERNELS
              for hits in [[e for e in kernels if name in e.key]]]
    log("phase 2c: the port's kernels, device time per step: "
        + "; ".join(ported))
    h2d = [e for e in kernels if "HtoD" in e.key]
    n_h2d = sum(e.count for e in h2d) / n_steps
    mb = sum(v.nbytes for v in batches[0].values()) / 1e6
    log(f"phase 2c: host-to-device copies per step: {n_h2d:g} ("
        + ", ".join(f"{e.key} x{e.count}" for e in h2d)
        + f"), {sum(dev_us(e) for e in h2d) / 1e3 / n_steps:.4f} ms/step on "
        f"the device for a {mb:.1f} MB batch; Trainer._to_device host time "
        f"{', '.join(f'{x:.2f}' for x in to_device_ms)} ms")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    prof.export_chrome_trace(os.path.join(ROOT, "build", "step_trace.json"))
    if n_h2d != 1:
        raise SystemExit(f"{n_h2d:g} host-to-device copies a step, not 1")


def phase_tools():
    """This slice's path: the two probe tools' ``main`` in-process on the
    card, with the arguments a user gives them; each checks its kernel
    against the plain version (exiting non-zero on a mismatch) and prints
    its times.  -> {"P1": launches, "P2": launches (float32 run),
    "P2 bf16": launches}."""
    import gc

    import torch

    from wide_deep_tpu_torch.tools import (microbench_rowdma_scatter,
                                           microbench_vmem_gather)
    out = {}
    reset_counts()                      # the probes' path starts here
    for key, tool, argv in (("P1", microbench_vmem_gather, []),
                            ("P2", microbench_rowdma_scatter, []),
                            ("P2 bf16", microbench_rowdma_scatter,
                             ["bf16"])):
        name = f"{tool.__name__.rsplit('.', 1)[1]} {' '.join(argv)}".strip()
        c0 = counts()
        t0 = time.time()
        tool.main(argv)
        torch.cuda.synchronize()
        d = delta(c0, counts())
        gc.collect()
        torch.cuda.empty_cache()
        kernel = key.split()[0]
        out[key] = d[kernel]
        others = {k: v for k, v in d.items() if v and k != kernel}
        log(f"phase 3: {name}: {d[kernel]} {kernel} launches in "
            f"{time.time() - t0:.1f} s")
        if not d[kernel] or others:
            raise SystemExit(f"phase 3: {name} launched {d}")
    return out


def phase_eval(trainer, tsv):
    """Phase 4: evaluate and predict over the TSV on the card: finite
    metrics, an AUC in [0, 1], one prediction a line, no kernel launch."""
    import math

    import numpy as np
    import torch
    with open(tsv) as f:
        n_rows = sum(1 for line in f if line.strip())
    n_batches = -(-n_rows // BATCH)
    c0 = counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = trainer.evaluate(tsv)
    eval_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    preds = list(trainer.predict(tsv))
    pred_s = time.perf_counter() - t0
    d = {k: v for k, v in delta(c0, counts()).items() if v}
    if d:
        raise SystemExit(f"phase 4: evaluate/predict launched {d}")
    bad = [k for k, v in res.items() if not math.isfinite(v)]
    if bad or not 0.0 <= res["auc"] <= 1.0:
        raise SystemExit(f"phase 4: metrics {res}")
    if len(preds) != n_rows:
        raise SystemExit(f"phase 4: {len(preds)} predictions for {n_rows} "
                         f"lines")
    probs = np.array([p["logistic"] for p in preds])
    if not (np.isfinite(probs).all() and (probs >= 0).all()
            and (probs <= 1).all()):
        raise SystemExit("phase 4: a prediction is not a probability")
    log(f"phase 4: evaluate over {n_rows} rows ({n_batches} batches) in "
        f"{eval_s:.2f} s ({eval_s / n_batches * 1e3:.1f} ms per batch, "
        f"loader included): {res}; predict gave {len(preds)} rows in "
        f"{pred_s:.2f} s ({pred_s / n_batches * 1e3:.1f} ms per batch); no "
        f"kernel launched")


BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "step_ms",
              "warmup_s", "device", "loader_rows_per_sec_by_threads",
              "loader_examples_per_sec", "transfer_first_ms",
              "transfer_steady_ms_per_batch", "batch_mbytes",
              "e2e_wait_ms_per_step", "e2e_dispatch_ms_per_step",
              "end_to_end_examples_per_sec", "end_to_end_step_ms")


def phase_bench(card, profile_dir):
    """Phase 5: the bench tool's ``main`` as a user runs it (batch 25600,
    6 end-to-end batches, its device stage's 3-step profile written to
    ``profile_dir`` for phase 12); its JSON line must hold every key, and
    each of its train steps must launch K1 at its four sites, K3, and K2
    or (d16 ok=0) K1 once more, as phase 2's steps do."""
    from wide_deep_tpu_torch.tools import bench
    env = {"BENCH_E2E_BATCHES": "6", "BENCH_PROFILE": profile_dir}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    c0 = counts()
    t0 = time.time()
    try:
        out = bench.main([])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    d = delta(c0, counts())
    missing = [k for k in BENCH_KEYS if k not in out]
    if missing:
        raise SystemExit(f"phase 5: the bench line lacks {missing}")
    if out["device"] != card:
        raise SystemExit(f"phase 5: the bench names {out['device']!r}")
    n = out["train_steps"]
    ok0 = d["d16 ok=0"]
    want = {"K1 d8": n, "K1 d4": n, "K1 d32 compact": n, "K1 wide": n,
            "K3": n}
    if ({k: d.get(k, 0) for k in want} != want or d["K2"] + ok0 != n
            or d["K1"] != 4 * n + ok0 or d["P1"] or d["P2"]):
        raise SystemExit(f"phase 5: {n} steps launched {d}")
    log(f"phase 5: bench in {time.time() - t0:.1f} s: step "
        f"{out['step_ms']:.2f} ms, end to end "
        f"{out['end_to_end_step_ms']:.2f} ms/step; {n} train steps launched "
        f"K1 {d['K1']} ({ok0} on d16 ok=0), K2 {d['K2']}, K3 {d['K3']}")
    return d


CLI_RUNCONFIG = {"save_checkpoints_steps": 2, "save_checkpoints_secs": "",
                 "keep_checkpoint_max": 2, "save_summary_steps": 2,
                 "log_step_count_steps": 1}
CLI_TRAIN_ROWS, CLI_EVAL_ROWS = 2 * BATCH, BATCH
# the fused d32 table and its live width on disk: (1 + 1 Adagrad slot) x 32
FUSED_LEAF, FUSED_LIVE = ("dnn", "embed", "d32"), 64


def same_bits(a, b):
    """Whether two trees of tensors and ints are equal leaf by leaf, bit for
    bit (tensors compared on their device) -> the differing leaves."""
    import torch

    from wide_deep_tpu_torch.optim import tree_items
    la, lb = dict(tree_items(a)), dict(tree_items(b))
    if sorted(map(str, la)) != sorted(map(str, lb)):
        return ["<tree structure>"]
    bad = []
    for path, va in la.items():
        vb = lb[path]
        if isinstance(va, torch.Tensor):
            ok = (va.dtype == vb.dtype and va.shape == vb.shape
                  and torch.equal(va.detach().reshape(-1).view(torch.uint8),
                                  vb.detach().reshape(-1).view(torch.uint8)))
        else:
            ok = va == vb
        if not ok:
            bad.append("/".join(map(str, path)))
    return bad


def state_diff(a, b):
    return [f"{what}/{leaf}" for what in ("params", "mstate", "opt_state")
            for leaf in same_bits(getattr(a, what), getattr(b, what))]


def phase_cli(card, tmp):
    """Phase 6: train -> restore -> resume -> eval -> pred -> inspect
    through the port's CLIs and checkpoints at the production config (see
    the module docstring), in the directory ``tmp``, which the caller
    removes.  -> the launches of the CLI's train run."""
    import contextlib
    import gc
    import io
    import math
    import re

    import torch

    from wide_deep_tpu_torch import testing
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.optim import tree_get
    from wide_deep_tpu_torch.tools import eval as eval_tool
    from wide_deep_tpu_torch.tools import inspect_checkpoint, pred, train
    from wide_deep_tpu_torch.tools.common import (base_parser,
                                                  overrides_from, parse_args)
    from wide_deep_tpu_torch.training import checkpoint as ck
    from wide_deep_tpu_torch.training.loop import Trainer
    from wide_deep_tpu_torch.training.summary import read_records

    t_phase = time.time()
    cwd = os.getcwd()
    real_step, real_save = Trainer.train_batch, ck.CheckpointManager.save
    try:
        os.chdir(tmp)                   # the train tool's logs/train.pid
        conf = os.path.join(tmp, "conf")
        shutil.copytree(os.path.join(ROOT, "conf"), conf)
        path = os.path.join(conf, "train.yaml")
        with open(path) as f:
            text = f.read().replace("pack_budget: auto", "pack_budget: 3")
        for key, value in CLI_RUNCONFIG.items():
            text, n = re.subn(rf"(\n  {key}:)[^\n]*", rf"\1 {value}", text)
            if n != 1:
                raise SystemExit(f"phase 6: no {key} in conf/train.yaml")
        with open(path, "w") as f:
            f.write(text)
        config = Config(conf)
        os.makedirs(os.path.join(tmp, "train"))
        t0 = time.time()
        files = {"train/part1": (CLI_TRAIN_ROWS, 21),
                 "train/part2": (CLI_TRAIN_ROWS, 22),
                 "eval.tsv": (CLI_EVAL_ROWS, 23),
                 "test.tsv": (CLI_EVAL_ROWS, 24)}
        for name, (n, seed) in files.items():
            testing.generate_ctr_tsv(config, os.path.join(tmp, name), n,
                                     seed=seed, hash_spread=None)
        gen_s = time.time() - t0
        model_dir = os.path.join(tmp, "model", "wide_deep")
        argv = ["--conf_dir", conf, "--model_dir",
                os.path.join(tmp, "model"), "--batch_size", str(BATCH),
                "--train_data", os.path.join(tmp, "train"),
                "--eval_data", os.path.join(tmp, "eval.tsv"),
                "--test_data", os.path.join(tmp, "test.tsv")]

        # (1) the CLI's train, each step's launches and time read on its own
        steps, step_ms, saves = [], [], []

        def counted(self, batch, with_summaries=False):
            torch.cuda.synchronize()
            c0, t0 = counts(), time.perf_counter()
            loss = real_step(self, batch, with_summaries=with_summaries)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            steps.append(delta(c0, counts()))
            return loss

        def recorded(self, step, tree, force=False):
            real_save(self, step, tree, force=force)
            if self.last_save.get("step") == step and not any(
                    s is self.last_save for s in saves):
                saves.append(self.last_save)

        Trainer.train_batch = counted
        ck.CheckpointManager.save = recorded
        reset_counts()                  # the CLI path starts here
        t0 = time.time()
        cli = train.main(argv + ["--keep_train", "0", "--train_epochs", "1",
                                 "--dynamic_train", "0"])
        torch.cuda.synchronize()
        train_s = time.time() - t0
        cli_counts = counts()
        Trainer.train_batch, ck.CheckpointManager.save = real_step, real_save
        if len(steps) != 4 or cli.global_step != 4:
            raise SystemExit(f"phase 6: the CLI took {len(steps)} steps")
        for i, d in enumerate(steps):
            check_step(f"phase 6: CLI step {i + 1}", d)
        on_disk = ck.committed_steps(model_dir)
        if on_disk != [2, 4] or [s["step"] for s in saves] != [2, 4]:
            raise SystemExit(f"phase 6: steps {on_disk} on disk, saves "
                             f"{saves}")
        d32 = ck.read_index(model_dir, 4)["tensors"][
            "params/" + "/".join(FUSED_LEAF)]
        rows = tree_get(cli.params, FUSED_LEAF).shape[0]
        if d32["shape"] != [rows, FUSED_LIVE]:
            raise SystemExit(f"phase 6: the d32 table on disk is {d32}")
        ck_bytes = [s["bytes"] for s in saves]
        copy_s = ", ".join(f"{s['copy_s']:.2f}" for s in saves)
        write_s = ", ".join(f"{s['write_s']:.2f}" for s in saves)
        cli_losses = [float(x) for x in cli.losses]
        log(f"phase 6: generated {sum(n for n, _ in files.values())} rows in "
            f"{gen_s:.1f} s; tools.train.main: 4 steps in {train_s:.1f} s "
            f"(two evaluations of the eval file and one of the test file, "
            f"the checkpoints and summaries included); step time "
            f"{', '.join(f'{x:.2f}' for x in step_ms)} ms (each synced); "
            f"losses {cli_losses}; launches per step {steps}; on disk "
            f"steps {on_disk}, d32 {d32['shape']} {d32['dtype']}; "
            f"checkpoint bytes {ck_bytes}; host copy {copy_s} s, write "
            f"{write_s} s (in the writer thread) on {card}")

        # (2) step 4 into a new Trainer: every leaf bit for bit
        p, cfg = base_parser("chip_smoke", argv)
        over = overrides_from(parse_args(p, argv))
        over["keep_train"] = True

        def new_trainer():
            tr = Trainer(cfg, "wide_deep", overrides=over, device="cuda")
            tr.ensure_initialized(restore=False)
            torch.cuda.synchronize()
            return tr

        fresh = new_trainer()
        t0 = time.perf_counter()
        fresh._restore_tree(fresh._ckpt)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        bad = state_diff(cli, fresh)
        if bad or fresh.global_step != 4 or not torch.equal(
                fresh._gen.get_state(), cli._gen.get_state()):
            raise SystemExit(f"phase 6: the restored step 4 differs: {bad}")
        del fresh
        gc.collect()
        torch.cuda.empty_cache()
        log(f"phase 6: step 4 restored into a new Trainer in {restore_s:.2f}"
            f" s ({ck_bytes[-1] / restore_s / 1e9:.2f} GB/s): every leaf "
            f"bit for bit the CLI's (torch.equal of the bytes on the card)")

        # (6) the summaries, before the resume writes its own
        sdir = os.path.join(model_dir, "summaries")
        blob = b"".join(rec for name in os.listdir(sdir)
                        for rec in read_records(os.path.join(sdir, name)))
        tags = [b"loss", b"dnn_0/hiddenlayer_2/activation_std",
                b"dnn_0/hiddenlayer_0/zero_fraction",
                b"dnn/towers/0/hidden/0/kernel", b"dnn/towers/0/logits/bias"]
        missing = [t for t in tags if t not in blob]
        if missing:
            raise SystemExit(f"phase 6: the summaries lack {missing}")

        # (3) resume from the pinned step 2 over the second file
        res = new_trainer()
        res._restore_pinned(os.path.join(model_dir, "2"))
        if res.global_step != 2:
            raise SystemExit(f"phase 6: pinned restore gave step "
                             f"{res.global_step}")
        t0 = time.time()
        res.train_file(os.path.join(tmp, "train", "part2"), epoch_seed=0)
        torch.cuda.synchronize()
        res_losses = [float(x) for x in res.losses]
        bad = state_diff(cli, res)
        if res_losses != cli_losses[2:] or bad:
            raise SystemExit(f"phase 6: the resume from step 2 differs from "
                             f"the CLI's steps 3-4: losses {res_losses} vs "
                             f"{cli_losses[2:]}; leaves {bad}")
        log(f"phase 6: resumed from the pinned step 2, trained part2 in "
            f"{time.time() - t0:.1f} s: losses {res_losses} and every leaf "
            f"bit for bit the CLI's steps 3-4")
        del res
        gc.collect()
        torch.cuda.empty_cache()

        # (4) eval from the pinned step 2 and from the latest; (5) pred;
        # (7) inspect
        test_tsv = os.path.join(tmp, "test.tsv")
        want = cli.evaluate(test_tsv)
        c0 = counts()
        t0 = time.time()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            pinned = eval_tool.main(argv + ["--checkpoint_path",
                                            os.path.join(model_dir, "2")])
            gc.collect()
            latest = eval_tool.main(argv + ["--checkpoint_path", model_dir])
            gc.collect()
        eval_s = time.time() - t0
        for name, res in (("pinned", pinned), ("latest", latest)):
            if (not all(math.isfinite(v) for v in res.values())
                    or not 0.0 <= res["auc"] <= 1.0):
                raise SystemExit(f"phase 6: {name} eval gave {res}")
        if pinned["global_step"] != 2 or latest != want:
            raise SystemExit(f"phase 6: eval pinned {pinned}, latest "
                             f"{latest}, the CLI Trainer's own {want}")
        del cli
        gc.collect()
        torch.cuda.empty_cache()
        out = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(out):
            n_pred = pred.main(argv)
        pred_s = time.time() - t0
        lines = out.getvalue().splitlines()
        fmt = re.compile(r"\d+\tclass: [01]\tprobability: \d\.\d{6}")
        if (n_pred != CLI_EVAL_ROWS or len(lines) != CLI_EVAL_ROWS
                or not all(fmt.fullmatch(x) for x in lines)
                or not lines[-1].startswith(f"{CLI_EVAL_ROWS - 1}\t")):
            raise SystemExit(f"phase 6: pred printed {len(lines)} lines, "
                             f"e.g. {lines[:2]}")
        d = {k: v for k, v in delta(c0, counts()).items() if v}
        if d:
            raise SystemExit(f"phase 6: eval/pred launched {d}")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            listed = inspect_checkpoint.main(["--model_dir", model_dir])
        index = ck.read_index(model_dir, 4)
        names = sorted(list(index["tensors"]) + list(index["ints"]))
        printed = [x.split("  ")[0] for x in out.getvalue().splitlines()]
        if sorted(listed) != names or printed != names:
            raise SystemExit(f"phase 6: the inspector listed {len(printed)} "
                             f"of {len(names)} leaves")
        log(f"phase 6: tools.eval.main pinned step 2 {pinned}; latest "
            f"{latest} (== the CLI Trainer's evaluate) in {eval_s:.1f} s for "
            f"both; tools.pred.main {len(lines)} lines in {pred_s:.1f} s; no "
            f"kernel launched; summaries hold {[t.decode() for t in tags]}; "
            f"the inspector listed all {len(names)} leaves; phase 6 in "
            f"{time.time() - t_phase:.1f} s")
        return cli_counts
    finally:
        Trainer.train_batch, ck.CheckpointManager.save = real_step, real_save
        os.chdir(cwd)


SERVING_BATCH = 1024        # ServingModel max_batch_size: buckets 16, 128, 1024


def _bundle_bytes(version_dir):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(version_dir) for f in files)


def phase_serving(card, tmp):
    """Phase 7: serving on the card from phase 6's latest checkpoint (step
    4 in ``tmp``; see the module docstring).  -> the launches counted
    across the phase (all must be 0)."""
    import concurrent.futures as futures
    import contextlib
    import gc
    import io
    import subprocess
    import threading

    import numpy as np
    import torch

    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.serving.client import (TcpPredictorClient,
                                                    build_cpp_client)
    from wide_deep_tpu_torch.serving.server import (PredictorServer,
                                                    ServingModel)
    from wide_deep_tpu_torch.tools import (bench_serving,
                                           microbench_serving_latency)
    from wide_deep_tpu_torch.tools import export as export_tool
    from wide_deep_tpu_torch.training.loop import Trainer, to_device
    from wide_deep_tpu_torch.training.step import predict_step

    t_phase = time.time()
    conf = os.path.join(tmp, "conf")
    model_root = os.path.join(tmp, "model")
    export_root = os.path.join(tmp, "export")
    test_tsv = os.path.join(tmp, "test.tsv")
    with open(test_tsv, encoding="utf-8") as f:
        rows = [line.rstrip("\n") for line in f if line.strip()]
    reset_counts()                      # the serving path starts here

    def export(version):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            path = export_tool.main(["--conf_dir", conf, "--model_dir",
                                     model_root, "--export_dir",
                                     export_root, "--model_version",
                                     str(version)])
        return path, time.perf_counter() - t0

    # (1) export step 4
    v1, export_s = export(1)
    with open(os.path.join(v1, "bundle.json")) as f:
        meta = json.load(f)
    n_bytes = _bundle_bytes(v1)
    if meta["global_step"] != 4:
        raise SystemExit(f"phase 7: the bundle holds step "
                         f"{meta['global_step']}")
    log(f"phase 7: tools.export.main wrote step 4 as {v1} in "
        f"{export_s:.2f} s: {n_bytes} bytes on {card}")

    # (2) the ServingModel on the card
    t0 = time.perf_counter()
    model = ServingModel(v1, SERVING_BATCH, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    d32 = model.params["dnn"]["embed"]["d32"]
    if tuple(d32.shape) != (10000128, 32) or d32.dtype != torch.bfloat16:
        raise SystemExit(f"phase 7: the served d32 table is "
                         f"{tuple(d32.shape)} {d32.dtype}")
    t0 = time.perf_counter()
    model.warmup()
    warm_s = time.perf_counter() - t0
    log(f"phase 7: ServingModel loaded in {load_s:.2f} s "
        f"({torch.cuda.memory_allocated() / 1e9:.2f} GB on the card; d32 "
        f"[10000128, 32] bfloat16), warmed buckets {model.batch_buckets} "
        f"in {warm_s:.2f} s on {card}")

    # (3) scores: predict_step on the same bucket bit for bit; all test rows
    # against Trainer.predict from the restored step 4
    first = rows[:SERVING_BATCH]
    got = model.score_rows(first)
    with torch.inference_mode():
        want = predict_step(model.model, model.params, model.mstate,
                            to_device(model.transform(first, SERVING_BATCH),
                                      model.device,
                                      torch.cuda.Stream()).claim())
    want = want["probabilities"][:len(first)].cpu().numpy()
    if not np.array_equal(np.asarray(got["scores"], np.float32), want):
        raise SystemExit("phase 7: served scores differ from predict_step "
                         "on the same bucket")
    t0 = time.perf_counter()
    served = model.score_rows(rows)
    serve_all_s = time.perf_counter() - t0
    # Trainer.predict from the restored step 4 at the server's batch of
    # 1024 rows: the same weights (the export casts the d32 table to
    # bfloat16, as the Trainer's gather casts the rows it reads) and the
    # same kernels at the same shapes, so the same bits.  At another batch
    # size cuBLAS picks another GEMM kernel, whose float32 sums can round
    # a bfloat16 activation the other way: up to 8.7e-4 in a probability
    # against a batch of 25,600
    tr = Trainer(Config(conf), "wide_deep", model_dir=model_root,
                 device="cuda", overrides={"keep_train": True,
                                           "batch_size": SERVING_BATCH})
    ref = list(tr.predict(test_tsv))
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    probs = np.asarray(served["scores"], np.float32)
    ref_p = np.array([p["probabilities"] for p in ref], np.float32)
    ids = np.asarray(served["class_ids"])
    ref_ids = np.array([int(p["class_ids"]) for p in ref])
    if (len(ref) != len(rows) or not all(served["valid"])
            or not np.array_equal(probs, ref_p)
            or not np.array_equal(ids, ref_ids)):
        err = (float(np.abs(probs - ref_p).max())
               if probs.shape == ref_p.shape else None)
        raise SystemExit(f"phase 7: served vs Trainer.predict: {len(ref)} "
                         f"predictions for {len(rows)} rows, max |dp| "
                         f"{err}")
    log(f"phase 7: scores: {len(first)} rows bit for bit predict_step's on "
        f"the same 1024-row bucket; all {len(rows)} test rows in one "
        f"request ({-(-len(rows) // SERVING_BATCH)} chunks) in "
        f"{serve_all_s:.2f} s, bit for bit Trainer.predict's from the "
        f"restored step 4 at batch {SERVING_BATCH}, on {card}")

    # (4) the server: TCP, and gRPC where the grpc package imports
    try:
        import grpc  # noqa: F401
        port = 0
    except ImportError:
        port = None
    srv = PredictorServer(model, port=port, tcp_port=0,
                          model_base_path=export_root,
                          reload_interval_s=0.5)
    srv.start()
    log(f"phase 7: PredictorServer on TCP :{srv.tcp_port}"
        + (f" and gRPC :{srv.port}" if port is not None
           else " only: the grpc package does not import here"))
    c = TcpPredictorClient(port=srv.tcp_port, timeout=120)
    try:
        some = rows[:8]
        resp = c.predict(some)
        py_lines = [f"{i}\tclass: {cid}\tprobability: {p[cid]:.6f}"
                    for i, (p, cid) in enumerate(zip(resp["scores"],
                                                     resp["class_ids"]))]
        built = build_cpp_client()
        data = os.path.join(tmp, "some.tsv")
        with open(data, "w", encoding="utf-8") as f:
            f.write("\n".join(some) + "\n")
        proc = subprocess.run(
            [built["path"], f"--data_file={data}", "--num_rows=8",
             "--server_host=localhost", f"--server_port={srv.tcp_port}"],
            capture_output=True, text=True, timeout=120)
        if proc.returncode or proc.stdout.splitlines() != py_lines:
            raise SystemExit(f"phase 7: the C++ client printed "
                             f"{proc.stdout!r} ({proc.stderr!r}), the "
                             f"Python TCP client {py_lines}")
        if port is not None:
            from wide_deep_tpu_torch.serving.client import PredictorClient
            g = PredictorClient(port=srv.port, timeout=120)
            try:
                if g.predict(some)["scores"] != resp["scores"]:
                    raise SystemExit("phase 7: gRPC and TCP disagree")
            finally:
                g.close()
        mixed = c.predict(some[:3] + ["bad\trow"] + some[3:])
        if (mixed["valid"] != [True] * 3 + [False] + [True] * 5
                or mixed["scores"][3] != [0.0, 0.0]
                or mixed["scores"][:3] + mixed["scores"][4:]
                != resp["scores"]):
            raise SystemExit(f"phase 7: the malformed row gave {mixed}")
        status = c.status()["models"]
        if [(m["name"], m["version"]) for m in status] != [("wide_deep",
                                                           "1")]:
            raise SystemExit(f"phase 7: status {status}")
        log(f"phase 7: the C++ client (built into "
            f"{os.path.relpath(built['path'], ROOT)} in "
            f"{built['seconds']:.1f} s) and the Python TCP client printed "
            f"the same {len(py_lines)} lines"
            + (", gRPC the same scores" if port is not None else "")
            + f"; a malformed 4th row came back valid: false with zero "
            f"scores and the rows after it unshifted; status {status}")

        # hot reload to version 2 under load
        stop = threading.Event()
        seen, errors = [], []

        def hammer():
            cl = TcpPredictorClient(port=srv.tcp_port, timeout=120)
            try:
                while not stop.is_set():
                    try:
                        r = cl.predict(some)
                        if r["scores"] != resp["scores"]:
                            errors.append("scores changed")
                        seen.append(r["model_version"])
                    except Exception as e:  # noqa: BLE001 — counted
                        errors.append(repr(e))
            finally:
                cl.close()

        old = srv.model
        with futures.ThreadPoolExecutor(4) as pool:
            running = [pool.submit(hammer) for _ in range(4)]
            try:
                t0 = time.time()
                v2, export2_s = export(2)
                deadline = time.time() + 120
                while srv.model.version != "2" and time.time() < deadline:
                    time.sleep(0.1)
                swap_s = time.time() - t0
                n_swap = len(seen)
                while len(seen) < n_swap + 20 and time.time() < deadline:
                    time.sleep(0.05)
            finally:
                stop.set()
            for f in running:
                f.result(timeout=120)
        old.batcher._thread.join(timeout=60)
        if (srv.model.version != "2" or errors or "1" not in seen
                or "2" not in seen or old.batcher._thread.is_alive()):
            raise SystemExit(f"phase 7: hot reload: version "
                             f"{srv.model.version}, errors {errors[:3]}, "
                             f"versions seen {sorted(set(seen))}")
        log(f"phase 7: hot reload: version 2 exported ({export2_s:.2f} s) "
            f"while 4 TCP clients scored; served {swap_s:.2f} s after the "
            f"export began; {len(seen)} requests in flight around the swap "
            f"all answered ({seen.count('1')} by version 1, "
            f"{seen.count('2')} by version 2), the old model drained and "
            f"closed")
    finally:
        c.close()
        srv.stop()
        srv.model.close()
    del model, old, srv
    gc.collect()
    torch.cuda.empty_cache()
    serve_tls_and_slo(card, tmp, v2, rows[:8])

    # (5) bench_serving at concurrency 1, 8, 64 with 1 and 64 rows a
    # request, over TCP: a connection is a server thread, where the gRPC
    # endpoint's pool of 8 workers would hold 64 clients to 8 requests in
    # the server at once
    bench = []
    for rpr in (1, 64):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            bench += bench_serving.main(
                ["--bundle_dir", v2, "--port", "0", "--transport", "tcp",
                 "--rows_per_request", str(rpr), "--concurrency", "1,8,64"])
        gc.collect()
        torch.cuda.empty_cache()
    for line in bench:
        log(f"phase 7: bench_serving {json.dumps(line)}")
        if line["errors"] or line["device"] != card:
            raise SystemExit(f"phase 7: bench line {line}")
        if (line["concurrency"] == 64
                and line["device_calls"] >= line["requests"]):
            raise SystemExit(f"phase 7: no coalescing at concurrency 64: "
                             f"{line}")

    # (6) the latency of one scoring call by bucket
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        lat = microbench_serving_latency.main(["--bundle_dir", v2])
    for row in lat:
        log(f"phase 7: serving latency bucket {row['bucket']}: device "
            f"{row['device_ms']:.4f} ms ({row['device_us_per_row']:.3f} "
            f"us/row), one call by events {row['event_ms']:.4f} ms, host "
            f"transform {row['host_ms']:.3f} ms, copy {row['copy_ms']:.4f} "
            f"ms on {card}; top on the device: "
            + "; ".join(f"{k} {v:.4f} ms" for k, v in row["device_top"]))
    gc.collect()
    torch.cuda.empty_cache()

    # (7) no kernel of the port ran anywhere in the phase
    launched = {k: v for k, v in counts().items() if v}
    if launched:
        raise SystemExit(f"phase 7: serving launched {launched}")
    log(f"phase 7: no kernel launched (K1, K2, K3, P1, P2 all 0); phase 7 "
        f"in {time.time() - t_phase:.1f} s")
    return counts()


def serve_tls_and_slo(card, tmp, bundle, some):
    """Phase 7's TLS and SLO part on ``bundle``: a TLS-only
    ``PredictorServer`` on the card with ``tools.tls_proxy`` in front, the
    C++ client through the proxy printing what the direct TLS Python client
    gets for ``some``; then ``tools.serving_slo.measure`` at a small request
    count (printed, not gated: event times spread up to 2x between runs on
    a shared host)."""
    import gc
    import subprocess

    import torch

    from wide_deep_tpu_torch.serving.client import (TcpPredictorClient,
                                                    build_cpp_client)
    from wide_deep_tpu_torch.serving.server import (PredictorServer,
                                                    ServingModel)
    from wide_deep_tpu_torch.tools import serving_slo
    from wide_deep_tpu_torch.tools.tls_proxy import TlsProxy

    t0 = time.time()
    cert, key = os.path.join(tmp, "cert.pem"), os.path.join(tmp, "key.pem")
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", key, "-out", cert, "-days", "2", "-subj",
         "/CN=localhost", "-addext", "subjectAltName=DNS:localhost"],
        check=True, capture_output=True, timeout=120)
    data = os.path.join(tmp, "tls_rows.tsv")
    with open(data, "w", encoding="utf-8") as f:
        f.write("\n".join(some) + "\n")
    model = ServingModel(bundle, SERVING_BATCH, device="cuda")
    model.warmup()
    srv = PredictorServer(model, port=None, tcp_port=0, tls_cert=cert,
                          tls_key=key)
    srv.start()
    tls_port = srv.tcp_port
    proxy = TlsProxy("localhost", tls_port, listen_port=0, tls_ca=cert)
    proxy.start()
    try:
        direct = TcpPredictorClient(port=tls_port, tls_ca=cert,
                                    timeout=120)
        try:
            resp = direct.predict(some)
        finally:
            direct.close()
        want = [f"{i}\tclass: {cid}\tprobability: {p[cid]:.6f}"
                for i, (p, cid) in enumerate(zip(resp["scores"],
                                                 resp["class_ids"]))]
        proc = subprocess.run(
            [build_cpp_client()["path"], f"--data_file={data}",
             f"--num_rows={len(some)}", "--server_host=localhost",
             f"--server_port={proxy.port}"],
            capture_output=True, text=True, timeout=120)
        if proc.returncode or proc.stdout.splitlines() != want:
            raise SystemExit(f"phase 7: the C++ client through the TLS "
                             f"proxy printed {proc.stdout!r} "
                             f"({proc.stderr!r}), the direct TLS client "
                             f"{want}")
        plain = TcpPredictorClient(port=tls_port, timeout=10)
        try:
            plain.predict(some[:1])
            raise SystemExit("phase 7: the TLS port answered a plaintext "
                             "client")
        except (IOError, RuntimeError):
            pass
        finally:
            plain.close()
    finally:
        proxy.stop()
        srv.stop()
        model.close()
    del model, srv
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 7: TLS-only PredictorServer on TCP :{tls_port} with "
        f"tools.tls_proxy in front: the C++ client through the proxy "
        f"printed the direct TLS Python client's {len(want)} lines; a "
        f"plaintext client on the TLS port refused; in "
        f"{time.time() - t0:.1f} s")
    t0 = time.time()
    slo = serving_slo.measure(bundle, num_requests=SLO_REQUESTS,
                              concurrency=8, device="cuda")
    for entry in slo:
        log(f"phase 7: serving_slo.measure (not gated) {json.dumps(entry)} "
            f"on {card}")
    log(f"phase 7: serving_slo.measure over "
        f"{sorted({e['transport'] for e in slo})} in "
        f"{time.time() - t0:.1f} s")
    return slo


# ------------------------------------------------------------------ phase 8
FM_FACTORS = 8              # phase 8a's linear_fm_factors (model.yaml: 0)
# phase 8b's configurations: conf/ with only these model.yaml keys changed
L1_L2 = "l1_regularization_strength: 0.5, l2_regularization_strength: 1.0"
OPTIMIZER_CONFIGS = (
    ("production", {}),
    ("ProximalAdagrad", {
        "linear_optimizer": f"{{name: ProximalAdagrad, {L1_L2}}}",
        "dnn_optimizer": "ProximalAdagrad"}),
    ("Ftrl", {"dnn_optimizer": f"{{name: Ftrl, {L1_L2}}}"}),
) + tuple((name, {"linear_optimizer": name, "dnn_optimizer": name})
          for name in ("Adam", "RMSProp", "Momentum", "SGD"))
NOT_SPARSE_CAPABLE = ("Adam", "RMSProp", "Momentum")
# launches a step of each phase-8 configuration must add, by site; on the
# d16 stream either K2 (ok=1) or K1 (ok=0) once, as check_step has it
SITES_FM = {"K1 wide": 1, "K1 v": 1, "K1 d8": 1, "K1 d4": 1,
            "K1 d32 compact": 1, "K3": 1}
SITES_FOLDED = {"K1 wide": 1, "K1 d8": 1, "K1 d4": 1, "K1 d32 compact": 1,
                "K3": 1}
# Adam, RMSProp and Momentum are not sparse-capable: the plan's
# sparse_opt goes off and the d32 table's gather backward is
# index_select's own (its 25,600 ids take no kernel plan)
SITES_NO_SPARSE = {"K1 wide": 1, "K1 d8": 1, "K1 d4": 1,
                   "K1 d32 compact": 0, "K3": 0}


def conf_copy(tmp, name, **model):
    """conf/ copied to ``tmp/<name>`` with the named model.yaml keys
    replaced -> its Config."""
    import re

    from wide_deep_tpu_torch.config import Config
    dst = os.path.join(tmp, name)
    shutil.copytree(os.path.join(ROOT, "conf"), dst)
    path = os.path.join(dst, "model.yaml")
    with open(path) as f:
        text = f.read()
    for key, value in model.items():
        text, n = re.subn(rf"(?m)^{key}:.*$", f"{key}: {value}", text)
        if n != 1:
            raise SystemExit(f"phase 8: no {key} in conf/model.yaml")
    with open(path, "w") as f:
        f.write(text)
    return Config(dst)


def site_names(trainer, batch=BATCH):
    """{(rows, D): site} of K1's call sites in ``trainer``'s step at
    ``batch`` rows, from its plan: the wide gather (and the FM factors'),
    the kernel-planned groups (D + 1 when folded), the d16 stream's ok=0
    branch and the fused tables' compact sums, whose rows are the batch's
    distinct ids, and so keyed (None, D)."""
    plan = trainer.plan
    out = {(plan.wide_dim, 1): "K1 wide"}
    if trainer.model.fm_factors:
        out[plan.wide_dim, trainer.model.fm_factors] = "K1 v"
    for g in plan.groups:
        width = g.dim + (1 if g.folded else 0)
        if plan.sparse_opt_group(g, batch):
            out[None, g.dim] = f"K1 d{g.dim} compact"
        elif plan.scatter_group(g, batch):
            out[g.rows, width] = f"K1 d{g.dim}"
        elif plan.window_group(g, batch):
            out[g.rows, width] = f"K1 d{g.dim} ok=0"
    return out


def site_counts(trainer, batch=BATCH, names=None):
    """The counters by site of ``trainer``'s step (``names``, default
    ``site_names``)."""
    from wide_deep_tpu_torch.ops import scatter
    c = {k: v for k, v in counts().items() if not k.startswith("K1 ")}
    names = names or site_names(trainer, batch)
    for shape, n in scatter.range_launches_by_shape.items():
        key = site_of(names, *shape)
        c[key] = c.get(key, 0) + n
    return c


def site_of(names, rows, d):
    """K1's site of a launch into [rows, d] by ``site_names``' map."""
    return names.get((rows, d), names.get((None, d),
                                          f"K1 rows={rows} D={d}"))


def nonzero(d):
    """A counter change without its zero entries, for the log."""
    return {k: v for k, v in d.items() if v}


def check_sites(what, d, sites, window=True):
    """One step's counter changes ``d`` against a configuration's table
    ``sites``; with ``window``, on the d16 stream K2 once, or (ok=0) K1
    once at its site and K2 never; without, K2 never; the probes never."""
    ok0 = d["d16 ok=0"]
    want = dict(sites, **{"K1 d16 ok=0": ok0})
    got = {k: d.get(k, 0) for k in want}
    n_k1 = sum(v for k, v in want.items() if k.startswith("K1"))
    if (got != want or ok0 + d["K2"] != (1 if window else 0)
            or d["K1"] != n_k1 or d["P1"] or d["P2"]):
        raise SystemExit(f"{what} launched {d}, want {want}")


def clone_tree(tree):
    """Tensors cloned, everything else copied, structure kept."""
    import copy

    import torch
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone_tree(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    return copy.deepcopy(tree)


def clone_state(trainer):
    """A copy on the card of what a step changes: params, BN state,
    optimizer state, step and generator state."""
    return {"params": clone_tree(trainer.params),
            "mstate": clone_tree(trainer.mstate),
            "opt_state": clone_tree(trainer.opt_state),
            "step": trainer.global_step, "rng": trainer._gen.get_state()}


def load_state(trainer, snap):
    """Put ``clone_state``'s copy back: params and optimizer tensors in
    place (the step updates them in place), counts and keys as they were,
    the BN state (a new tree each step) as a copy."""
    import torch

    def put(live, saved):
        for k in list(live) if isinstance(live, dict) else []:
            if k not in saved:
                del live[k]
        for k, v in (saved.items() if isinstance(saved, dict)
                     else enumerate(saved)):
            if isinstance(v, torch.Tensor):
                with torch.no_grad():
                    live[k].copy_(v)
            elif isinstance(v, (dict, list)) and k in live:
                put(live[k], v)
            else:
                live[k] = clone_tree(v)
    put(trainer.params, snap["params"])
    put(trainer.opt_state, snap["opt_state"])
    trainer.mstate = clone_tree(snap["mstate"])
    trainer.global_step = snap["step"]
    trainer._gen.set_state(snap["rng"])


def ulp_distance(a, b):
    """Elementwise distance in units in the last place of two tensors of
    one floating dtype (+0 and -0 are one value)."""
    import torch
    ints = {torch.bfloat16: (torch.int16, 0x7FFF),
            torch.float32: (torch.int32, 0x7FFFFFFF)}[a.dtype]

    def ordered(t):
        i = t.contiguous().view(ints[0]).long()
        mag = i & ints[1]
        return torch.where(i < 0, -mag, mag)
    return (ordered(a) - ordered(b)).abs()


RECORD_MAX_NUMEL = 1 << 27     # leaves above it are not copied to the host


def recorded_update(trainer):
    """Wrap ``trainer``'s next optimizer update: the dense update
    (``tx.update_``: each leaf's param, gradient, slots, lr and count are
    copied to the host before the card's update and its results after;
    leaves of more than ``RECORD_MAX_NUMEL`` elements are left out) and the
    fused tables' row formula (``optim.sparse._row_update``: the touched
    rows, their summed gradient and slots as K1 and the gather gave them,
    and the rows it returns, which K3 writes) -> a function, to call after
    the step, that replays the same updates on the host and returns the
    worst ulp distance to the card's results by leaf (slots included) and
    the paths left out."""
    from wide_deep_tpu_torch.optim import slot_inits, sparse, tree_get
    tx = trainer.tx
    taken, rows, skipped = [], [], []
    row_update = sparse._row_update

    def host(t):
        return t.detach().cpu().clone()

    def wrapped(params, grads, state):
        del tx.update_                  # the next steps run the real one
        picked = []
        for arm, (spec, schedule) in tx.arms.items():
            st = state[arm]
            for path, w in tx.leaves(params, arm):
                if w.numel() > RECORD_MAX_NUMEL:
                    skipped.append("/".join(map(str, path)))
                    continue
                picked.append((arm, path, spec, schedule(st["count"]),
                               st["count"], host(w), host(grads[path]),
                               {k: host(st[k][path])
                                for k in slot_inits(spec)}))
        tx.update_(params, grads, state)
        for arm, path, spec, lr, count, w, g, slots in picked:
            after = [host(tree_get(params, path))] + [
                host(state[arm][k][path]) for k in slots]
            taken.append((path, spec, lr, count, w, g, slots, after))

    def row_wrapped(spec, lr, w, g, slots):
        before = (host(w), host(g), {k: host(v) for k, v in slots.items()})
        w_new, new = row_update(spec, lr, w, g, slots)
        rows.append((spec, lr) + before
                    + ([host(w_new)] + [host(new[k]) for k in sorted(new)],))
        return w_new, new

    tx.update_ = wrapped
    sparse._row_update = row_wrapped

    def worst_ulp(host_out, card_out):
        return max(int(ulp_distance(a, b).max()) if a.numel() else 0
                   for a, b in zip(host_out, card_out))

    def replay():
        from wide_deep_tpu_torch.optim import leaf_update_
        sparse._row_update = row_update
        worst = {}
        for path, spec, lr, count, w, g, slots, after in taken:
            leaf_update_(spec, lr, count, w, g, slots)
            worst["/".join(map(str, path))] = worst_ulp(
                [w] + list(slots.values()), after)
        # a table's calls over the recorded steps under one key: each step
        # updates its batch's distinct rows, so their counts differ
        for spec, lr, w, g, slots, after in rows:
            w_new, new = row_update(spec, lr, w, g, slots)
            key = f"dnn/embed/d{w.shape[1]} fused rows"
            worst[key] = max(worst.get(key, 0), worst_ulp(
                [w_new] + [new[k] for k in sorted(new)], after))
        return worst, skipped
    return replay


def sweep_leaves(trainer):
    """The sweep kernel's launches a step of ``trainer``, by counter: one
    a dense leaf under Ftrl or Adagrad (csrc/optim_sweep.cu)."""
    want = {"S Ftrl": 0, "S Adagrad": 0}
    for arm, (spec, _) in trainer.tx.arms.items():
        key = f"S {spec['name']}"
        if key in want:
            want[key] += len(trainer.tx.leaves(trainer.params, arm))
    return want


def check_sweeps(what, d, sweeps):
    """A counter change ``d`` over steps against ``sweeps``, the launches
    they must add (``sweep_leaves`` times the steps)."""
    got = {k: d.get(k, 0) for k in sweeps}
    if got != sweeps:
        raise SystemExit(f"{what}: sweep launches {got}, want {sweeps}")


def synthetic_steps(trainer, sites, n, what, seed):
    """``n`` synthetic steps, each synchronized and its launches checked
    against ``sites`` and ``sweep_leaves`` -> (losses, step ms)."""
    import numpy as np
    import torch

    from wide_deep_tpu_torch import testing
    rng = np.random.default_rng(seed)
    losses, ms = [], []
    sweeps = sweep_leaves(trainer)
    for i in range(n):
        batch = testing.synthetic_batch(trainer.plan, BATCH, rng)
        db = trainer._to_device(batch)
        torch.cuda.synchronize()
        c0, t0 = site_counts(trainer), time.perf_counter()
        losses.append(float(trainer.train_batch(db)))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        d = delta(c0, site_counts(trainer))
        check_sites(f"{what} synthetic step {i}", d, sites)
        check_sweeps(f"{what} synthetic step {i}", d, sweeps)
    if not all(np.isfinite(losses)):
        raise SystemExit(f"{what}: non-finite loss {losses}")
    return losses, ms


def release():
    """Return the card memory of objects the caller has dropped."""
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def phase_fm(card, tmp):
    """8a: the FM term on the production config (module docstring)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from wide_deep_tpu_torch import testing
    from wide_deep_tpu_torch.training.loop import Trainer

    t0 = time.time()
    config = conf_copy(tmp, "conf_fm", linear_fm_factors=FM_FACTORS)
    tr = Trainer(config, "wide_deep", model_dir=os.path.join(tmp, "fm"),
                 overrides={"batch_size": BATCH, "pack_budget": 3},
                 device="cuda")
    if tr.plan.fold or tr.model.fm_factors != FM_FACTORS:
        raise SystemExit("phase 8a: the FM config kept the fold")
    tr.ensure_initialized(restore=False)
    torch.cuda.synchronize()
    v = tr.params["linear"]["v"]
    log(f"phase 8a: FM k={FM_FACTORS}: fold off, wide_dim "
        f"{tr.plan.wide_dim}, v {list(v.shape)} float32 "
        f"{v.numel() * 4} bytes; K1 sites {sorted(site_names(tr).values())}"
        f"; initialised in {time.time() - t0:.1f} s")
    replay = recorded_update(tr)
    losses, ms = synthetic_steps(tr, SITES_FM, 3, "phase 8a", seed=41)
    worst, skipped = replay()
    if "linear/v" not in worst or max(worst.values()) > 0 or skipped:
        raise SystemExit(f"phase 8a: the card's update differs from the "
                         f"host's: {worst} ulp; not copied: {skipped}")
    log(f"phase 8a: 3 synthetic steps {', '.join(f'{x:.2f}' for x in ms)} "
        f"ms (step 0 with its update copied to the host), losses {losses};"
        f" launches per step {SITES_FM} and K2 1, sweeps {sweep_leaves(tr)}"
        f"; step 0 on the card vs the host, worst ulp by leaf (param and "
        f"slots): {json.dumps(worst)}")
    del replay

    # two file steps, twice from the same state: bit for bit
    tsv = os.path.join(tmp, "fm.tsv")
    testing.generate_ctr_tsv(config, tsv, 2 * BATCH, seed=0,
                             hash_spread=None)
    snap = clone_state(tr)
    runs = []
    for _ in range(2):
        load_state(tr, snap)
        steps = []
        train_batch = tr.train_batch

        def counted(batch, **kw):
            c0 = site_counts(tr)
            loss = train_batch(batch, **kw)
            steps.append(delta(c0, site_counts(tr)))
            return loss
        tr.train_batch = counted
        tr.train_file(tsv, max_steps=2)
        torch.cuda.synchronize()
        del tr.train_batch
        for i, d in enumerate(steps):
            check_sites(f"phase 8a: file step {i}", d, SITES_FM)
        runs.append(([float(x) for x in list(tr.losses)[-2:]],
                     clone_state(tr)))
    (la, sa), (lb, sb) = runs
    bad = [f"{w}/{leaf}" for w in ("params", "mstate", "opt_state")
           for leaf in same_bits(sa[w], sb[w])]
    if la != lb or bad or sa["step"] != sb["step"]:
        raise SystemExit(f"phase 8a: two runs of the file steps differ: "
                         f"losses {la} / {lb}, leaves {bad[:8]}")
    del snap, runs, sa, sb
    log(f"phase 8a: 2 train_file steps run twice from one state: losses "
        f"{la} both times, params, BN and optimizer state bit for bit; "
        f"launches per step {[nonzero(d) for d in steps]}")

    # device time of a step (the sweep over v alone: phase 8e)
    batches = [tr._to_device(testing.synthetic_batch(
        tr.plan, BATCH, np.random.default_rng(44 + i))) for i in range(3)]
    torch.cuda.synchronize()
    tr.train_batch(batches[0])          # outside the window: warm
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for b in batches[1:]:
            tr.train_batch(b)
        torch.cuda.synchronize()
    step_dev = sum(dev_us(e) for e in prof.key_averages()
                   if on_device(e)) / 1e3 / 2
    log(f"phase 8a: device time a step {step_dev:.3f} ms (profiler, 2 "
        f"steps); phase 8a in {time.time() - t0:.1f} s")
    del tr, batches, v, prof
    release()
    return {"step_ms": ms, "device_ms": step_dev}


# phase 8e: the sweep kernel at the cells' largest dense leaves, by rule,
# site, shape and dtype
SWEEP_ROWS = (("Ftrl", "v (FM, k = 8)", (12_715_008, 8), "float32"),
              ("Ftrl", "wide", (10_000_640, 1), "float32"),
              ("Adagrad", "d16 table", (1_500_160, 17), "bfloat16"))


def phase_sweeps():
    """8e: the sweep kernel (csrc/optim_sweep.cu) at ``SWEEP_ROWS``' shapes:
    one step from one state by the kernel and by the eager chain on the
    card (``optim._ftrl_`` / ``_adagrad_``), the same bits; then each one's
    time, the median of 10 by CUDA events and the device time of a
    profiler window of 5 calls, beside the bound (the bytes read and
    written once over HBM_BYTES_PER_S) -> the rows."""
    import torch

    from wide_deep_tpu_torch.ops import optim_sweep
    from wide_deep_tpu_torch.optim import _adagrad_, _ftrl_
    from wide_deep_tpu_torch.tools import median_ms
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    lr = torch.tensor(0.05)
    l1, l2 = 0.5, 1.0
    spec = {"l1_regularization_strength": l1,
            "l2_regularization_strength": l2}
    rows = []
    for rule, site, shape, dtype in SWEEP_ROWS:
        dt = getattr(torch, dtype)
        w = (torch.randn(shape, generator=gen, device=dev) * 0.05).to(dt)
        g = (torch.randn(shape, generator=gen, device=dev) * 1e-3).to(dt)
        g[torch.rand(shape, generator=gen, device=dev) < 0.3] = 0
        if rule == "Ftrl":
            slots = [torch.full(shape, 0.1, device=dev),
                     torch.randn(shape, generator=gen, device=dev) * 0.1]
            n_bytes = w.numel() * (3 * w.element_size() + 16)

            def kernel():
                optim_sweep.ftrl_(lr, w, g, *slots, l1, l2)

            def eager():
                _ftrl_(spec, lr, w, g, *slots)
        else:
            slots = [torch.full(shape, 0.1, dtype=dt, device=dev)]
            n_bytes = w.numel() * 5 * w.element_size()

            def kernel():
                optim_sweep.adagrad_(lr, w, g, *slots)

            def eager():
                _adagrad_(lr, w, g, *slots)
        start = [t.clone() for t in (w, *slots)]
        out = []
        for fn in (kernel, eager):
            for t, t0 in zip((w, *slots), start):
                t.copy_(t0)
            fn()
            out.append([bits(t).clone() for t in (w, *slots)])
        del start
        same = all(torch.equal(a, b) for a, b in zip(*out))
        del out
        if not same:
            raise SystemExit(f"phase 8e: {rule} over {site}: the kernel's "
                             f"bits differ from the eager chain's")
        times = {}
        for key, fn in (("kernel", kernel), ("eager", eager)):
            parts, whole = device_ms(fn, calls=5)
            times[key] = {"ms": median_ms(fn, 10, dev),
                          "device_ms": sum(parts.values()),
                          "launches": len(parts), "whole": whole}
        b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        row = {"rule": rule, "site": site, "shape": list(shape),
               "dtype": dtype, "bound_ms": b_ms, **times}
        rows.append(row)
        k, e = times["kernel"], times["eager"]
        # the share of the bound by the device time where the profiler
        # kept the whole window, else by the events' time
        by = "device" if k["whole"] else "events"
        k_ms = k["device_ms"] if k["whole"] else k["ms"]
        log(f"phase 8e: {rule} over {site} {list(shape)} {dtype}: the "
            f"kernel's bits are the eager chain's; kernel {k['ms']:.4f} ms "
            f"(device {k['device_ms']:.4f} ms, {k['launches']} kernel kind), "
            f"eager chain {e['ms']:.4f} ms (device {e['device_ms']:.4f} ms "
            f"over {e['launches']} kernel kinds), bound {b_ms:.4f} ms "
            f"({n_bytes / w.numel():.0f} bytes an element): kernel at "
            f"{100 * b_ms / k_ms:.1f}% of its bound by its {by} time"
            + "".join(f"; the profiler dropped the {key}'s events"
                      for key, t in times.items() if not t["whole"]))
        del w, g, slots
        release()
    return rows


def sweep_rows(sweeps, main_counts, dcn_counts):
    """8e's rows (``phase_sweeps``) as rows of the kernels line: the
    kernel's time beside the eager chain's (``plain_ms``) and the bound;
    its launches on the main path (phase 2's steps) and on phase 13's DCN
    steps."""
    rows = []
    for r in sweeps:
        key = f"S {r['rule']}"
        k, e = r["kernel"], r["eager"]
        rows.append({
            "name": f"{key} optim_elementwise_{r['rule'].lower()}_kernel "
                    f"{r['site']}",
            "route": "cuda",
            "source": "wide_deep_tpu_torch/csrc/optim_sweep.cu",
            "replaces": None, "plain": f"optim._{r['rule'].lower()}_",
            "launches": main_counts.get(key, 0),
            "launches_dcn": dcn_counts.get(key, 0),
            "shape": r["shape"], "dtype": r["dtype"], "max_abs_err": 0.0,
            "tolerance": "0 ulp against the eager chain", "ok": True,
            "ms": k["ms"], "device_ms": k["device_ms"],
            "plain_ms": e["ms"], "plain_device_ms": e["device_ms"],
            "bound_ms": r["bound_ms"], "bound_by": "HBM bytes",
            # device times the profiler left incomplete in every attempt
            "profile_incomplete": [key for key, t in (
                ("device_ms", k), ("plain_device_ms", e)) if not t["whole"]]})
    return rows


def phase_optimizers(card, tmp):
    """8b: step 0 of each configuration of ``OPTIMIZER_CONFIGS``, replayed
    on the host (``recorded_update``), then a second step."""
    import torch

    from wide_deep_tpu_torch.training.loop import Trainer
    out = {}
    for name, keys in OPTIMIZER_CONFIGS:
        t0 = time.time()
        config = conf_copy(tmp, f"conf_{name}", **keys)
        tr = Trainer(config, "wide_deep",
                     model_dir=os.path.join(tmp, name),
                     overrides={"batch_size": BATCH, "pack_budget": 3},
                     device="cuda")
        sparse = name not in NOT_SPARSE_CAPABLE
        if tr.plan.sparse_opt != sparse or bool(tr.sparse_tables) != sparse:
            raise SystemExit(f"phase 8b: {name}: sparse_opt "
                             f"{tr.plan.sparse_opt}, tables "
                             f"{sorted(tr.sparse_tables)}")
        tr.ensure_initialized(restore=False)
        torch.cuda.synchronize()
        init_s = time.time() - t0
        replay = recorded_update(tr)
        sites = SITES_FOLDED if sparse else SITES_NO_SPARSE
        losses, ms = synthetic_steps(tr, sites, 2, f"phase 8b: {name}",
                                     seed=51)
        worst, skipped = replay()
        fused = [k for k in worst if "fused rows" in k]
        if (not worst or max(worst.values()) > 0
                or len(fused) != len(tr.sparse_tables)):
            raise SystemExit(f"phase 8b: {name}: the card's update differs "
                             f"from the host's: {worst} ulp")
        big = max(tr.plan.groups, key=lambda g: g.rows)
        table = tr.params["dnn"]["embed"][f"d{big.dim}"]
        specs = {arm: spec["name"] for arm, (spec, _) in tr.tx.arms.items()}
        log(f"phase 8b: {name} ({specs}): initialised in {init_s:.1f} s "
            f"(d{big.dim} {list(table.shape)} {str(table.dtype)[6:]}), "
            f"2 synthetic "
            f"steps {', '.join(f'{x:.2f}' for x in ms)} ms, losses {losses};"
            f" launches per step {sites} and K2 1, sweeps "
            f"{sweep_leaves(tr)}; step 0 on the card vs "
            f"the host, worst ulp by leaf (param and slots): "
            f"{json.dumps(worst)}"
            + (f"; not copied: {skipped}" if skipped else ""))
        out[name] = {"step_ms": ms, "worst_ulp": worst}
        del tr, table, replay
        release()
    return out


def phase_stream(card, tmp):
    """8c: the stream."""
    import torch

    from wide_deep_tpu_torch import testing
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.features.stream import StreamDataset, serve_file
    from wide_deep_tpu_torch.training.loop import Trainer

    t0 = time.time()
    config = Config(os.path.join(ROOT, "conf"))
    tsv = os.path.join(tmp, "stream.tsv")
    testing.generate_ctr_tsv(config, tsv, 2 * BATCH, seed=31,
                             hash_spread=None)
    tr = Trainer(config, "wide_deep", model_dir=os.path.join(tmp, "stream"),
                 overrides={"batch_size": BATCH, "pack_budget": 3},
                 device="cuda")
    tr.ensure_initialized(restore=False)
    t1 = time.time()
    tr.save()                           # step 0, just before the stream
    save_s = time.time() - t1
    steps = []
    train_batch = tr.train_batch

    def counted(batch, **kw):
        c0 = counts()
        loss = train_batch(batch, **kw)
        steps.append(delta(c0, counts()))
        return loss
    tr.train_batch = counted
    srv, thread = serve_file(tsv, "127.0.0.1", 0)
    t1 = time.time()
    tr.train_stream("127.0.0.1", srv.getsockname()[1], max_batches=2,
                    flush_timeout_s=5.0)
    torch.cuda.synchronize()
    stream_s = time.time() - t1
    del tr.train_batch
    srv.close()
    thread.join(60)
    if len(steps) != 2 or tr.global_step != 2:
        raise SystemExit(f"phase 8c: the stream took {len(steps)} steps")
    for i, d in enumerate(steps):
        check_step(f"phase 8c: stream step {i}", d)
    stream_losses = [float(x) for x in list(tr.losses)[-2:]]

    # the same two batches from step 0's checkpoint through train_batch
    tr._restore_tree(tr._ckpt, step=0)
    srv, thread = serve_file(tsv, "127.0.0.1", 0)
    ds = StreamDataset(tr.plan, "127.0.0.1", srv.getsockname()[1],
                       mode="train", batch_size=BATCH,
                       pos_weight=tr.pos_weight, neg_weight=tr.neg_weight,
                       flush_timeout_s=5.0, max_batches=2,
                       transformer=tr.transformer)
    again = [float(tr.train_batch(b)) for b in ds]
    srv.close()
    thread.join(60)
    if again != stream_losses:
        raise SystemExit(f"phase 8c: stream losses {stream_losses}, the "
                         f"same batches from the checkpoint {again}")
    log(f"phase 8c: train_stream over {ds.rows_seen} streamed rows: 2 steps"
        f" in {stream_s:.1f} s, losses {stream_losses}, launches per step "
        f"{[nonzero(d) for d in steps]}; from the step-0 checkpoint (saved "
        f"in {save_s:.1f} s) "
        f"the same two batches read again gave the same losses bit for bit;"
        f" phase 8c in {time.time() - t0:.1f} s")


def phase_configs(card, tmp):
    """Phase 8: the training configurations beyond the production one."""
    t0 = time.time()
    fm = phase_fm(card, tmp)
    sweeps = phase_sweeps()
    opts = phase_optimizers(card, tmp)
    phase_stream(card, tmp)
    release()
    log(f"phase 8 in {time.time() - t0:.1f} s")
    return {"fm": fm, "sweeps": sweeps, "optimizers": opts}


# ------------------------------------------------------------------ phase 9
# quality_onchip part B: the production config at batch 64, where no fold
# group's stream is long enough for a kernel plan (their backward is
# index_add_'s); a step launches K1 at the wide gather (wide arm), K1 at
# the fused d32 table's compact sum and K3 (deep arm)
QUALITY_BATCH = 64
SITES_QUALITY = {
    "wide": {"K1 wide": 1, "K3": 0},
    "deep": {"K1 wide": 0, "K1 d32 compact": 1, "K3": 1},
    "wide_deep": {"K1 wide": 1, "K1 d32 compact": 1, "K3": 1},
}
# tests/test_quality.py's bars: AUC above these, logloss below 0.60,
# prediction/mean in (0.12, 0.40).  The last two hold the wide model only:
# on the production tables the deep arm under-predicts (seeds spread its
# logloss over 0.61-0.76) in the JAX package as in the port
# (tests/test_torch_quality.py::test_large_table_calibration_matches_jax)
QUALITY_BARS = {"wide": 0.70, "deep": 0.62, "wide_deep": 0.64}
CALIBRATION_BARS = ("wide",)
# quality_matrix's small conf at batch 512: no stream long enough for a
# kernel plan and no table large enough to fuse; a step launches K1 at the
# wide gather, and at the FM factors' gather in the FM variant
MATRIX_BATCH = 512
MATRIX_ARGS = ["--rows", "200000", "--eval_rows", "20000", "--only",
               "wide_deep_simple,wd_fm8"]
SITES_MATRIX = {"wide_deep_simple": {"K1 wide": 1, "K3": 0},
                "wd_fm8": {"K1 wide": 1, "K1 v": 1, "K3": 0}}


def counted_steps(tr, sites, batch, what, steps):
    """Wrap ``tr.train_batch``: each step's launches by site checked
    against ``sites`` (no window plan at ``batch``); ``steps[what]``
    counts them."""
    train_batch = tr.train_batch
    steps[what] = 0

    def counted(b, **kw):
        c0 = site_counts(tr, batch)
        loss = train_batch(b, **kw)
        check_sites(f"phase 9: {what} step {steps[what]}",
                    delta(c0, site_counts(tr, batch)), sites, window=False)
        steps[what] += 1
        return loss
    tr.train_batch = counted


def phase_quality(card, tmp):
    """Phase 9: quality on the card.  ``tools.quality_onchip`` part B
    in-process (each model type on the production config, 5 epochs over
    data/train at batch 64, AUC on data/eval/eval1) against
    tests/test_quality.py's bars, every step's launches read; then
    ``tools.quality_matrix.main`` on two variants at 200,000 rows (the
    committed quality_matrix_torch.json is the full run), every step's
    launches read."""
    import contextlib
    import io

    import numpy as np
    import torch

    from wide_deep_tpu_torch.tools import quality_matrix, quality_onchip
    t0 = time.time()
    steps = {}
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rows = quality_onchip.part_b(
            torch.device("cuda"),
            on_trainer=lambda tr: counted_steps(
                tr, SITES_QUALITY[tr.model_type], QUALITY_BATCH,
                tr.model_type, steps))
    for r in rows:
        mt = r["model_type"]
        calibrated = (r["average_loss"] < 0.60
                      and 0.12 < r["prediction/mean"] < 0.40)
        ok = (r["auc"] > QUALITY_BARS[mt] and np.isfinite(r["average_loss"])
              and (calibrated or mt not in CALIBRATION_BARS)
              and steps[mt] == r["steps"] > 0)
        log(f"phase 9: quality_onchip part B, {mt} on the production "
            f"config: AUC {r['auc']:.4f} (bar > {QUALITY_BARS[mt]}), "
            f"logloss {r['average_loss']:.4f} (bar < 0.60), prediction/mean "
            f"{r['prediction/mean']:.4f} (bar in (0.12, 0.40)): the "
            f"logloss and mean bars {'met' if calibrated else 'missed'}"
            f"{'' if mt in CALIBRATION_BARS else ' (not asserted)'}; "
            f"{r['steps']} steps each launching {SITES_QUALITY[mt]}, K2 0; "
            f"{r['seconds']:.1f} s on {card}")
        if not ok:
            raise SystemExit(f"phase 9: {mt} misses its bars or launches: "
                             f"{r}, {steps[mt]} steps counted")
    part_b_s = time.time() - t0
    t1 = time.time()
    with contextlib.redirect_stdout(out):
        res = quality_matrix.main(
            MATRIX_ARGS + ["--work_dir", os.path.join(tmp, "matrix"),
                           "--device", "cuda"],
            on_trainer=lambda name, tr: counted_steps(
                tr, SITES_MATRIX[name], MATRIX_BATCH, name, steps))
    for r in res["results"]:
        log(f"phase 9: quality_matrix {r['variant']} at {res['rows']} rows: "
            f"AUC {r['auc']}, logloss {r['logloss']}, {r['steps']} steps "
            f"each launching {SITES_MATRIX[r['variant']]}; "
            f"{r['train_s']} s")
        if (not np.isfinite(r["logloss"]) or not r["auc"] > 0.70
                or steps[r["variant"]] != r["steps"]):
            raise SystemExit(f"phase 9: quality_matrix {r}")
    log(f"phase 9: part B in {part_b_s:.1f} s, the matrix in "
        f"{time.time() - t1:.1f} s; phase 9 in {time.time() - t0:.1f} s")
    return {"part_b": rows, "matrix": res}


# ----------------------------------------------------------------- phase 10
# the CNN arm: conf/ as shipped with cnn_use_flag 1 (VGG16 at 224 x 224 x 3,
# its own Adagrad, lr 0.05, decay 0.8), then ResNet-50 v2, at batch 64 over
# data/train's rows paired by index with data/image/train.tfrecords
CNN_BATCH = 64
CNN_VGG_STEPS = 20
CNN_RESNET_STEPS = 5
CNN_CLI_ROWS = 2 * CNN_BATCH
CNN_TRAIN = os.path.join(ROOT, "data", "train")
CNN_EVAL = os.path.join(ROOT, "data", "eval")
CNN_IMAGES = os.path.join(ROOT, "data", "image", "train.tfrecords")
# the profiler's CPU-side ops whose device time is the convolutions'
CONV_OPS = ("aten::convolution", "aten::convolution_backward")
# ResNet-50 v2 forward ~4.1 GFLOP an image at 224 x 224, VGG16 ~15.5;
# forward + backward ~3x (float32, TF32 off: the 67 TFLOP/s rate)
CNN_FWD_FLOP = {"vgg16": 15.5e9, "resnet": 4.1e9}


def cnn_trainer(config, model_dir, restore=False):
    """A Trainer at batch 64 over data/train and data/eval with the
    TFRecord's images, initialised (and with ``restore`` restored)."""
    from wide_deep_tpu_torch.training.loop import Trainer
    tr = Trainer(config, "wide_deep", model_dir=model_dir,
                 overrides=dict(
                     batch_size=CNN_BATCH, keep_train=True,
                     num_examples=4000, train_data=CNN_TRAIN,
                     eval_data=CNN_EVAL, test_data=CNN_EVAL,
                     image_train_data=CNN_IMAGES,
                     image_eval_data=CNN_IMAGES,
                     image_test_data=CNN_IMAGES), device="cuda")
    tr.ensure_initialized(restore=restore)
    return tr


def held_to_plain(tr, what):
    """Wrap K1 (``ops/scatter.sorted_stream_sum``, which ``range_scatter_add``
    calls) and K3 (``ops/rowdma.rowdma_scatter_rows``) for one step: each
    launch is held on the card against its plain version on the same
    inputs, K1 within 1e-6 of the row's sum of |g| + 1e-6 (float32 sums in
    another order; one bfloat16 ulp more for a bfloat16 output), K3 exact
    on a copy of the table.  -> a function, to call after the step, that
    logs each launch by site, checks that the sites are
    ``SITES_QUALITY["wide_deep"]``'s and restores the wrappers; exits
    non-zero on a mismatch."""
    import torch

    from wide_deep_tpu_torch.ops import rowdma, scatter
    k1, k3 = scatter.sorted_stream_sum, rowdma.rowdma_scatter_rows
    names, seen = site_names(tr, CNN_BATCH), []

    def k1_held(ids_sorted, perm, g_flat, rows, out_dtype):
        want = scatter.range_scatter_add_plain(ids_sorted, perm, g_flat,
                                               rows, torch.float32)
        mag = scatter.range_scatter_add_plain(ids_sorted, perm, g_flat.abs(),
                                              rows, torch.float32)
        got = k1(ids_sorted, perm, g_flat, rows, out_dtype)
        err = (got.float() - want).abs()
        tol = 1e-6 * mag + 1e-6
        if out_dtype == torch.bfloat16:
            tol += BF16_TOL * want.abs()
        d = g_flat.shape[1]
        seen.append((site_of(names, rows, d),
                     f"{g_flat.shape[0]} ids -> [{rows}, {d}]",
                     float(err.max()) if err.numel() else 0.0,
                     bool((err <= tol).all())))
        return got

    def k3_held(table, uids, new_rows):
        want = rowdma.rowdma_scatter_rows_plain(table.clone(), uids, new_rows)
        k3(table, uids, new_rows)
        exact = bool(torch.equal(table, want))
        err = 0.0 if exact else float((table - want).abs().max())
        del want
        seen.append(("K3", f"{uids.numel()} uids into {list(table.shape)}",
                     err, exact))
        return table

    scatter.sorted_stream_sum, rowdma.rowdma_scatter_rows = k1_held, k3_held

    def check():
        scatter.sorted_stream_sum, rowdma.rowdma_scatter_rows = k1, k3
        got = {}
        for site, *_ in seen:
            got[site] = got.get(site, 0) + 1
        want = nonzero(SITES_QUALITY["wide_deep"])
        log(f"phase 10: {what} step 0's launches against their plain "
            f"versions on the same inputs: " + "; ".join(
                f"{site} ({shape}) max_abs_err {err:.3g} "
                f"{'ok' if ok else 'DISAGREES'}"
                for site, shape, err, ok in seen))
        if got != want or not all(ok for *_, ok in seen):
            raise SystemExit(f"phase 10: {what}: the path's kernels "
                             f"{seen}, want sites {want}")
    return check


def cnn_steps(tr, what, n, on_first=None):
    """``n`` steps of ``tr.train_file`` over data/train, each step's
    launches checked against SITES_QUALITY["wide_deep"] and its time taken
    between CUDA events on the step's stream; step 0's K1 and K3 launches
    held against their plain versions (``held_to_plain``); ``on_first()``
    runs after step 0.  -> (losses, step ms)."""
    import numpy as np
    import torch
    train_batch, events, losses = tr.train_batch, [], []

    def counted(batch, **kw):
        c0 = site_counts(tr, CNN_BATCH)
        check = held_to_plain(tr, what) if not events else None
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        loss = train_batch(batch, **kw)
        end.record()
        events.append((start, end))
        losses.append(loss)
        if check is not None:
            check()
        check_sites(f"phase 10: {what} step {len(events) - 1}",
                    delta(c0, site_counts(tr, CNN_BATCH)),
                    SITES_QUALITY["wide_deep"], window=False)
        if len(events) == 1 and on_first is not None:
            on_first()
        return loss

    tr.train_batch = counted
    try:
        tr.train_file(CNN_TRAIN, max_steps=n)
    finally:
        del tr.train_batch
    torch.cuda.synchronize()
    losses = [float(x) for x in losses]
    if len(losses) != n or not all(np.isfinite(losses)):
        raise SystemExit(f"phase 10: {what} took {len(losses)} steps, "
                         f"losses {losses}")
    return losses, [s.elapsed_time(e) for s, e in events]


def cnn_host_batches(tr, n):
    """``n`` host batches of the Trainer's train dataset, and the image
    assembly's host ms a batch (reading, decoding and placing its 64
    records: ImageCsvDataset._image_at)."""
    ds = tr._dataset(CNN_TRAIN, "train")
    image_at, spent = ds._image_at, []

    def timed(*a):
        t0 = time.perf_counter()
        out = image_at(*a)
        spent.append(time.perf_counter() - t0)
        return out
    ds._image_at = timed
    it = iter(ds)
    batches = [next(it) for _ in range(n)]
    return batches, sum(spent) * 1e3 / n


def cnn_profile(tr, batches, what, n_steps=3):
    """torch.profiler over ``n_steps`` steps on host batches after a
    warm-up step -> one line: device ms a step, the convolutions' device ms
    and share, the top kernels, the port's kernels; the host-to-device
    copies a step must be one."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=n_steps,
                                   repeat=1)) as prof:
        for i, b in enumerate(batches[:n_steps + 1]):
            tr.train_batch(tr._to_device(b))
            if i == n_steps:
                torch.cuda.synchronize()
            prof.step()
    events = prof.key_averages()
    kernels = sorted(filter(on_device, events), key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in kernels) / 1e3 / n_steps
    conv = sum(getattr(e, "device_time_total", getattr(
        e, "cuda_time_total", 0)) for e in events
        if e.key in CONV_OPS) / 1e3 / n_steps
    top = [f"{e.key[:50]} {dev_us(e) / 1e3 / n_steps:.3f} ms"
           for e in kernels[:8]]
    ported = [f"{name} {sum(dev_us(e) for e in hits) / 1e3 / n_steps:.4f} "
              f"ms x{sum(e.count for e in hits) // n_steps}"
              for name in PORTED_STEP_KERNELS
              for hits in [[e for e in kernels if name in e.key]]]
    n_h2d = sum(e.count for e in kernels if "HtoD" in e.key) / n_steps
    log(f"phase 10: {what} profile of {n_steps} steps: device busy "
        f"{busy:.2f} ms/step, convolutions (forward + backward) "
        f"{conv:.2f} ms ({100 * conv / max(busy, 1e-9):.1f}%); top: "
        + "; ".join(top) + "; the port's kernels: " + "; ".join(ported)
        + f"; host-to-device copies a step: {n_h2d:g}")
    if n_h2d != 1:
        raise SystemExit(f"phase 10: {what}: {n_h2d:g} host-to-device "
                         f"copies a step, not 1")
    return busy, conv


def cnn_checks(tr, what, images, with_f32_grads):
    """The arm's forward + backward twice on one batch of 64 on the card
    (the same bits), then at batch 2 against the port on the host, float32
    and float64 (testing.cnn_disagreement)."""
    import numpy as np
    import torch

    from wide_deep_tpu_torch import testing
    spec, params = tr.model.cnn_spec, tr.params["cnn"]
    state = tr.mstate.get("cnn_bn")
    cot = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (images.shape[0], 1)).astype(np.float32))
    dev = images.to("cuda")
    (l0, s0, g0), (l1, s1, g1) = [
        testing.cnn_forward_backward(spec, params, state, dev, cot)
        for _ in range(2)]
    same = (same_bits(l0, l1) == [] and same_bits(s0, s1) == []
            and all(same_bits(g0[p], g1[p]) == [] for p in g0))
    del l0, s0, g0, l1, s1, g1
    release()
    log(f"phase 10: {what}: forward + backward twice on one batch of "
        f"{images.shape[0]}: {'the same bits' if same else 'DIFFERENT'}")
    if not same:
        raise SystemExit(f"phase 10: {what}: two calls differ")
    rows = []
    for dt in (torch.float32, torch.float64):
        host = testing.cnn_forward_backward(
            spec, params, state, images[:2].to(dt), cot[:2].to(dt))
        card = testing.cnn_forward_backward(
            spec, params, state, images[:2].to("cuda", dt), cot[:2].to(dt))
        d = testing.cnn_disagreement(
            spec, host, card, with_grads=dt == torch.float64 or with_f32_grads)
        rows.append(f"{str(dt)[6:]} {d}")
        if not d["ok"]:
            raise SystemExit(f"phase 10: {what}: card vs host {dt}: {d}")
    log(f"phase 10: {what}: the card against the port on the host at batch "
        f"2 (logits max abs error / host's max, worst BN state and gradient "
        f"leaf by norm): " + "; ".join(rows))


def phase_cnn_vgg(card, tmp):
    """10a: VGG16 (module docstring)."""
    import contextlib
    import io
    import json as json_lib

    import numpy as np
    import torch

    from wide_deep_tpu_torch.optim import tree_items
    from wide_deep_tpu_torch.tools import eval as eval_tool
    from wide_deep_tpu_torch.tools import export as export_tool
    from wide_deep_tpu_torch.tools import train as train_tool

    t_phase = time.time()
    config = conf_copy(tmp, "cnn_vgg16", cnn_use_flag=1)
    model_dir = os.path.join(tmp, "vgg16")
    tr = cnn_trainer(config, model_dir)
    cnn_leaves = dict(tree_items(tr.params["cnn"], ("cnn",)))
    n_cnn = sum(t.numel() for t in cnn_leaves.values())
    before = {p: t.clone() for p, t in cnn_leaves.items()}
    replay = recorded_update(tr)
    first = {}

    def on_first():
        torch.cuda.synchronize()
        first["moved"] = [p for p, t in cnn_leaves.items()
                          if not torch.equal(t, before[p])]
        first["worst"], first["skipped"] = replay()
        before.clear()

    losses, ms = cnn_steps(tr, "VGG16", CNN_VGG_STEPS, on_first)
    if len(first["moved"]) != len(cnn_leaves):
        raise SystemExit(f"phase 10: VGG16 leaves unchanged after step 0: "
                         f"{sorted(set(cnn_leaves) - set(first['moved']))}")
    cnn_ulp = {k: v for k, v in first["worst"].items()
               if k.startswith("cnn/")}
    if len(cnn_ulp) != len(cnn_leaves) or any(first["worst"].values()):
        raise SystemExit(f"phase 10: step 0's update on the host: "
                         f"{first['worst']} (skipped {first['skipped']})")
    med = float(np.median(ms[1:]))
    flop = 3 * CNN_FWD_FLOP["vgg16"] * CNN_BATCH
    log(f"phase 10a: VGG16 + wide_deep (conf/, cnn_use_flag 1; "
        f"{n_cnn:,} CNN params in {len(cnn_leaves)} leaves) at batch "
        f"{CNN_BATCH}: {CNN_VGG_STEPS} train_file steps, losses "
        f"{[round(x, 5) for x in losses]}; step ms by CUDA events median "
        f"{med:.2f} (min {min(ms[1:]):.2f}, max {max(ms[1:]):.2f}; step 0 "
        f"{ms[0]:.2f} with the update recorded and the kernels held), {CNN_BATCH / med * 1e3:.1f} "
        f"images/s; bound {bound_ms(0, flop)[0]:.2f} ms (3 x 15.5 GFLOP an "
        f"image at 67 TFLOP/s); every step launched "
        f"{SITES_QUALITY['wide_deep']}; every cnn leaf changed at step 0; "
        f"step 0 replayed on the host: {len(cnn_ulp)} cnn leaves, worst "
        f"{max(cnn_ulp.values())} ulp (all {len(first['worst'])} recorded "
        f"leaves 0 ulp; not copied: {first['skipped']}); peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB on {card}")

    batches, img_ms = cnn_host_batches(tr, 4)
    mb = sum(v.nbytes for v in batches[0].values()) / 1e6
    log(f"phase 10a: image assembly on the host {img_ms:.1f} ms a batch of "
        f"{CNN_BATCH} (read, decode, place); the batch is {mb:.1f} MB, "
        f"{batches[0]['image'].nbytes / 1e6:.1f} MB of it images")
    busy, conv = cnn_profile(tr, batches, "VGG16")
    cnn_checks(tr, "VGG16", torch.from_numpy(batches[0]["image"]), True)
    del batches
    release()

    # a checkpoint, restored into a new Trainer bit for bit
    t0 = time.time()
    tr.save()
    save_s = time.time() - t0
    t0 = time.time()
    tr2 = cnn_trainer(config, model_dir, restore=True)
    diff = state_diff(tr, tr2)
    opt_cnn = len(tr2.opt_state["dense"]["cnn"]["accum"])
    log(f"phase 10a: checkpoint at step {tr.global_step} saved in "
        f"{save_s:.1f} s, restored into a new Trainer in "
        f"{time.time() - t0:.1f} s: params (cnn included), mstate and "
        f"optimizer state ({opt_cnn} cnn Adagrad slots) "
        f"{'bit for bit' if not diff else diff}")
    if diff or tr2.global_step != tr.global_step:
        raise SystemExit(f"phase 10a: the restore differs: {diff}")
    del tr2
    release()

    c0 = counts()
    t0 = time.time()
    res = tr.evaluate(CNN_EVAL)
    d = nonzero(delta(c0, counts()))
    log(f"phase 10a: evaluate over data/eval with the TFRecord's images in "
        f"{time.time() - t0:.1f} s: AUC {res['auc']:.4f}, logloss "
        f"{res['average_loss']:.4f}; launches {d or 'none'}")
    if (d or not 0.0 <= res["auc"] <= 1.0
            or not all(np.isfinite(v) for v in res.values())):
        raise SystemExit(f"phase 10a: evaluate {res}, launches {d}")
    del tr
    release()

    # the CLIs: train 2 steps, eval, export
    tsv = os.path.join(tmp, "cnn_cli.tsv")
    with open(os.path.join(CNN_TRAIN, "train1")) as f, open(tsv, "w") as out:
        for _ in range(CNN_CLI_ROWS):
            out.write(f.readline())
    argv = ["--conf_dir", config.conf_dir, "--model_dir",
            os.path.join(tmp, "cli"), "--batch_size", str(CNN_BATCH),
            "--train_data", tsv, "--eval_data", tsv, "--test_data", tsv,
            "--image_train_data", CNN_IMAGES, "--image_eval_data",
            CNN_IMAGES, "--image_test_data", CNN_IMAGES]
    out = io.StringIO()
    c0 = counts()
    t0 = time.time()
    cwd = os.getcwd()
    os.chdir(tmp)                       # the train tool's logs/train.pid
    try:
        with contextlib.redirect_stdout(out):
            cli = train_tool.main(argv + ["--keep_train", "0",
                                          "--train_epochs", "1",
                                          "--dynamic_train", "0"])
            steps = cli.global_step
            del cli
            release()
            res = eval_tool.main(argv)
            version = export_tool.main(
                ["--conf_dir", config.conf_dir, "--model_dir",
                 os.path.join(tmp, "cli"), "--export_dir",
                 os.path.join(tmp, "cli_export")])
    finally:
        os.chdir(cwd)
    d = nonzero(delta(c0, counts()))
    want = {k: steps * v for k, v in SITES_QUALITY["wide_deep"].items() if v}
    with open(os.path.join(version, "params", "index.json")) as f:
        index = json_lib.load(f)
    shapes = {n: tuple(v["shape"]) for n, v in index["tensors"].items()
              if n.startswith("params/cnn/")}
    want_shapes = {"params/" + "/".join(p): tuple(t.shape)
                   for p, t in cnn_leaves.items()}
    cnn_names = sorted(shapes)
    log(f"phase 10a: tools.train.main {steps} steps at batch {CNN_BATCH} "
        f"with --image_*_data, tools.eval.main (AUC {res['auc']:.4f}, "
        f"global_step {res['global_step']}), tools.export.main: the bundle "
        f"holds the Trainer's {len(cnn_names)} cnn leaves, names and shapes; "
        f"launches {d} in {time.time() - t0:.1f} s")
    if (steps != CNN_CLI_ROWS // CNN_BATCH or res["global_step"] != steps
            or shapes != want_shapes
            or {k: d.get(k, 0) for k in want} != want or d.get("K2")):
        raise SystemExit(f"phase 10a: the CLIs: {steps} steps, {res}, "
                         f"launches {d}, cnn leaves {cnn_names}")
    log(f"phase 10a in {time.time() - t_phase:.1f} s")
    return {"step_ms": med, "busy_ms": busy, "conv_ms": conv}


def phase_cnn_resnet(card, tmp):
    """10b: ResNet-50 v2 (module docstring)."""
    import numpy as np
    import torch

    from wide_deep_tpu_torch import testing
    from wide_deep_tpu_torch.models.cnn import cnn_logits
    from wide_deep_tpu_torch.models.cnn import resnet as resnet_lib

    t_phase = time.time()
    config = conf_copy(tmp, "cnn_resnet50", cnn_use_flag=1,
                       cnn_model="resnet", cnn_resnet_size=50)
    tr = cnn_trainer(config, os.path.join(tmp, "resnet50"))
    bn_relu, seen = resnet_lib._bn_relu, {}

    def spy(store, state, new_state, name, x, training, relu=True):
        if name == "final_bn" and training and "x" not in seen:
            seen["x"] = x.detach().double().cpu()
            seen["old"] = {k: v.double().cpu()
                           for k, v in state[name].items()}
        return bn_relu(store, state, new_state, name, x, training, relu)

    def on_first():
        resnet_lib._bn_relu = bn_relu
        seen["new"] = {k: v.double().cpu()
                       for k, v in tr.mstate["cnn_bn"]["final_bn"].items()}

    resnet_lib._bn_relu = spy
    try:
        losses, ms = cnn_steps(tr, "ResNet-50", CNN_RESNET_STEPS, on_first)
    finally:
        resnet_lib._bn_relu = bn_relu
    x, old, new = seen["x"], seen["old"], seen["new"]
    n = x.numel() // x.shape[-1]
    errs = {}
    for ddof in (0, 1):
        stat = {"mean": x.mean(dim=(0, 1, 2)),
                "var": x.var(dim=(0, 1, 2), correction=ddof)}
        errs[ddof] = max(float(((0.99 * old[k] + 0.01 * stat[k]) - new[k])
                               .abs().max() / new[k].abs().max())
                         for k in stat)
    med = float(np.median(ms[1:]))
    log(f"phase 10b: ResNet-50 v2 + wide_deep at batch {CNN_BATCH}: "
        f"{CNN_RESNET_STEPS} train_file steps, losses "
        f"{[round(v, 5) for v in losses]}; step ms median {med:.2f} (min "
        f"{min(ms[1:]):.2f}, max {max(ms[1:]):.2f}), "
        f"{CNN_BATCH / med * 1e3:.1f} images/s; bound "
        f"{bound_ms(0, 3 * CNN_FWD_FLOP['resnet'] * CNN_BATCH)[0]:.2f} ms; "
        f"every step launched {SITES_QUALITY['wide_deep']}; final_bn's "
        f"running stats after step 0 against the host's 0.99 old + 0.01 "
        f"batch over its {n} values a channel: population variance "
        f"{errs[0]:.2e}, sample variance {errs[1]:.2e} (relative)")
    if not errs[0] <= 1e-5:
        raise SystemExit(f"phase 10b: the running stats move otherwise "
                         f"than the JAX formula: {errs}")
    batches, img_ms = cnn_host_batches(tr, 4)
    cnn_profile(tr, batches, "ResNet-50")
    images = torch.from_numpy(batches[0]["image"])
    del batches
    # eval reads the running stats: the card's eval forward is the host's
    # from those stats, and not the batch-stat forward
    with torch.no_grad():
        spec, params = tr.model.cnn_spec, tr.params["cnn"]
        state = tr.mstate["cnn_bn"]
        dev = images[:2].to("cuda")
        card = cnn_logits(params, spec, dev, 1, False, state)[0].cpu()
        batch_stats = cnn_logits(params, spec, dev, 1, False, None)[0].cpu()
        host = cnn_logits(host_copy(params), spec, images[:2], 1, False,
                          host_copy(state))[0]
    err = float((card - host).abs().max() / host.abs().max())
    gap = float((batch_stats - host).abs().max() / host.abs().max())
    log(f"phase 10b: eval forward from the running stats: card vs host "
        f"{err:.2e}; against a batch-statistics forward {gap:.2e}")
    if not (err <= testing.CNN_FWD_TOL and gap > 10 * testing.CNN_FWD_TOL):
        raise SystemExit(f"phase 10b: eval does not read the running stats")
    cnn_checks(tr, "ResNet-50", images, False)
    c0 = counts()
    res = tr.evaluate(CNN_EVAL)
    d = nonzero(delta(c0, counts()))
    log(f"phase 10b: evaluate over data/eval: AUC {res['auc']:.4f}, logloss "
        f"{res['average_loss']:.4f}; launches {d or 'none'}; phase 10b in "
        f"{time.time() - t_phase:.1f} s")
    if (d or not 0.0 <= res["auc"] <= 1.0
            or not all(np.isfinite(v) for v in res.values())):
        raise SystemExit(f"phase 10b: evaluate {res}, launches {d}")
    del tr
    release()
    return {"step_ms": med}


def host_copy(tree):
    """A tree of tensors copied to the host."""
    if isinstance(tree, dict):
        return {k: host_copy(v) for k, v in tree.items()}
    return tree.detach().cpu()


def phase_tfrecord(tmp):
    """10c: data/image/train.tfrecords read through the port's codec and
    written back: the same bytes; PIL stays unloaded."""
    from wide_deep_tpu_torch.features import tfrecord
    had_pil = "PIL" in sys.modules
    t0 = time.time()
    recs = list(tfrecord.read_records(CNN_IMAGES, verify=True))
    out = os.path.join(tmp, "round_trip.tfrecords")
    tfrecord.write_records(out, iter(recs))
    with open(CNN_IMAGES, "rb") as a, open(out, "rb") as b:
        same = a.read() == b.read()
    pil = "PIL" in sys.modules and not had_pil
    log(f"phase 10c: {len(recs)} records of data/image/train.tfrecords read "
        f"(crc checked) and written back in {time.time() - t0:.1f} s: "
        f"{'the same bytes' if same else 'DIFFERENT bytes'}; PIL "
        f"{'loaded' if pil else 'not loaded'}")
    if not same or pil or len(recs) != 24:
        raise SystemExit("phase 10c: the round trip failed")


def phase_cnn(card, tmp):
    """Phase 10: the CNN arm (module docstring).  -> its launches."""
    t0 = time.time()
    reset_counts()                      # the CNN path starts here
    vgg = phase_cnn_vgg(card, tmp)
    release()
    resnet = phase_cnn_resnet(card, tmp)
    cnn_counts = counts()
    phase_tfrecord(tmp)
    log(f"phase 10 in {time.time() - t0:.1f} s: VGG16 {vgg['step_ms']:.2f} "
        f"ms a step, ResNet-50 {resnet['step_ms']:.2f}; launches "
        f"{nonzero(cnn_counts)}")
    return cnn_counts


# ------------------------------------------------------------------ phase 11
SHARDED_RANKS = 2
SHARDED_STEPS = 5              # global batches of BATCH rows on the ranks
# the ranks against one device from the same weights and batches, after
# SHARDED_STEPS steps.  The dense layers compute in bfloat16 (conf/), so a
# half batch's kernel and bias gradients round otherwise than the whole
# batch's, and BN's moments are sums of two halves; Adagrad's first steps
# move a weight by ~lr whatever the gradient's size, so a small leaf (a
# bias) moves most.  Measured on the card (PERF.md, PR 13 call 1): worst
# leaf 2.84e-2 of its largest value (a BN bias), losses 1.13e-4 relative,
# AUC / logloss 2.2e-4; the bars are about twice the readings.
SHARDED_STATE_TOL = 2.0 ** -4  # per leaf: max |a - b| / max |b|
SHARDED_LOSS_TOL = 2.0 ** -12  # relative, each step's loss
SHARDED_EVAL_TOL = 5e-4        # AUC and logloss, absolute
# K1's sites on a rank's step (2 ranks, conf/): d8's range plan row and
# the d32 compact plan row (one each); d4 is replicated (its table and
# fold column each summed by K1 over the stably sorted ids); the wide
# table's shard (the pooled gather and the indicator rows); d16's window
# plan row runs K2, or K1 when its flag says ok=0
SITES_SHARDED = {"K1 d8": 1, "K1 d4": 2, "K1 d32 compact": 1, "K1 wide": 2,
                 "K3": 1}
# ... and under sharded_lookup: dedup: no kernel plan rows; the d8 and d16
# groups' dedup exchange sums its cotangent by slot with K1 (the slot
# sums), never K2
SITES_DEDUP = {"K1 d8 dedup": 1, "K1 d16 dedup": 1, "K1 d4": 2,
               "K1 d32 compact": 1, "K1 wide": 2, "K3": 1}


def sharded_site_names(trainer, batch):
    """{(rows, D): site} of K1's call sites on a rank's step: the shapes
    of its shard's sums (``SITES_SHARDED``), and the dedup exchange's slot
    sums into [S * cap, D] (``SITES_DEDUP``)."""
    from wide_deep_tpu_torch.ops.scatter import dedup_cap, shard_cap
    plan, mesh = trainer.plan, trainer.mesh
    paths = trainer.sharded_paths
    s = mesh.world
    w_rows = plan.wide_dim // s if ("linear", "w") in paths else plan.wide_dim
    out = {(w_rows, 1): "K1 wide"}
    for g in plan.groups:
        width = g.dim + (1 if g.folded else 0)
        n = batch * plan.group_packed_len[g.dim]
        if plan.sparse_opt_group(g, batch):
            out[shard_cap(n, s), g.dim] = f"K1 d{g.dim} compact"
        elif plan.dedup_group(g, batch):
            out[s * dedup_cap(n, g.rows, s), width] = f"K1 d{g.dim} dedup"
        elif plan.scatter_group(g, batch):
            out[g.rows // s, width] = f"K1 d{g.dim}"
        elif plan.window_group(g, batch):
            out[g.rows // s, width] = f"K1 d{g.dim} ok=0"
        elif ("dnn", "embed", f"d{g.dim}") not in paths:
            out[g.rows, g.dim] = f"K1 d{g.dim}"
            if g.folded:
                out[g.rows, 1] = f"K1 d{g.dim}"
    return out


def event_ms(fn, calls=5):
    """Median ms of ``calls`` calls of ``fn`` by CUDA events."""
    import torch
    out = []
    for _ in range(calls):
        e0, e1 = torch.cuda.Event(True), torch.cuda.Event(True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1))
    return sorted(out)[len(out) // 2]


def held_to_plain_sharded(trainer, batch, seen):
    """Wrap K1, K2 and K3 for one rank step, as ``held_to_plain`` does:
    each launch against its plain version on the same per-shard inputs
    (K1 and K2 within 1e-6 of each row's sum of |g| + 1e-6, one bfloat16
    ulp more for a bfloat16 output; K3 exact on a copy of the shard), and
    timed again on them, with the plain version and the library call
    (``index_add_`` of the live rows into zeros; ``index_copy_`` for K3):
    medians of 5 calls by CUDA events, beside the bound (ids and perm read
    once, the live entries' rows read once, the output written once);
    appended to ``seen`` as dicts.  The dedup exchange's slot sums
    (``exchange.slot_sum``) are also timed without the routing of
    weight-0 entries, K1's carry pass apart (device ms of a profiler
    window).  -> a function restoring the wrappers."""
    import torch

    from wide_deep_tpu_torch.ops import rowdma, scatter
    from wide_deep_tpu_torch.parallel import exchange
    k1, k2 = scatter.sorted_stream_sum, scatter.window_scatter_add
    k3 = rowdma.rowdma_scatter_rows
    slot_sum = exchange.slot_sum
    names = sharded_site_names(trainer, batch)

    def counted_off(fn):
        """``fn()``, its kernels' launches kept off the counts."""
        saved = (scatter.range_launches, scatter.window_launches,
                 rowdma.rowdma_launches,
                 dict(scatter.range_launches_by_shape))
        out = fn()
        (scatter.range_launches, scatter.window_launches,
         rowdma.rowdma_launches, by_shape) = saved
        scatter.range_launches_by_shape.clear()
        scatter.range_launches_by_shape.update(by_shape)
        return out

    def timed(call):
        """event_ms of a kernel call, its launches kept off the counts."""
        return counted_off(lambda: event_ms(call))

    def against(name, shape, got, ids, perm, g, rows, out_dtype, call):
        want = scatter.range_scatter_add_plain(ids, perm, g, rows,
                                               torch.float32)
        mag = scatter.range_scatter_add_plain(ids, perm, g.abs(), rows,
                                              torch.float32)
        err = (got.float() - want).abs()
        tol = 1e-6 * mag + 1e-6
        if out_dtype == torch.bfloat16:
            tol += BF16_TOL * want.abs()
        live = (ids >= 0) & (ids < rows)
        lib_ids, lib_g = ids[live].long(), g[perm[live].long()].to(out_dtype)
        n, n_live, d = ids.numel(), lib_ids.numel(), g.shape[1]
        out_b = torch.finfo(out_dtype).bits // 8
        b_ms, b_by = bound_ms(n * 8 + n_live * d * g.element_size()
                              + rows * d * out_b, n_live * d)
        seen.append({
            "site": name, "shape": shape,
            "max_abs_err": float(err.max()) if err.numel() else 0.0,
            "ok": bool((err <= tol).all()), "ms": timed(call),
            "plain_ms": event_ms(lambda: scatter.range_scatter_add_plain(
                ids, perm, g, rows, out_dtype)),
            "library_ms": event_ms(lambda: torch.zeros(
                (rows, d), dtype=out_dtype, device=g.device).index_add_(
                    0, lib_ids, lib_g)),
            "bound_ms": b_ms, "bound_by": b_by})

    def k1_held(ids, perm, g, rows, out_dtype):
        got = k1(ids, perm, g, rows, out_dtype)
        d = g.shape[1]
        against(names.get((rows, d), f"K1 rows={rows} D={d}"),
                f"{ids.numel()} of {g.shape[0]} rows -> [{rows}, {d}]", got,
                ids, perm, g, rows, out_dtype,
                lambda: k1(ids, perm, g, rows, out_dtype))
        return got

    def k2_held(ids, perm, g, tiles, rows, wcap, out_dtype=None):
        got = k2(ids, perm, g, tiles, rows, wcap, out_dtype)
        against("K2", f"{ids.numel()} of {g.shape[0]} rows, "
                f"{tiles.shape[1]} windows -> [{rows}, {g.shape[1]}]", got,
                ids, perm, g, rows, out_dtype or g.dtype,
                lambda: k2(ids, perm, g, tiles, rows, wcap, out_dtype))
        return got

    def k3_held(table, uids, new_rows):
        want = rowdma.rowdma_scatter_rows_plain(table.clone(), uids,
                                                new_rows)
        k3(table, uids, new_rows)
        exact = bool(torch.equal(table, want))
        err = 0.0 if exact else float((table - want).abs().max())
        del want
        # writing the same rows again leaves the shard as it is
        ms = timed(lambda: k3(table, uids, new_rows))
        valid = (uids >= 0) & (uids < table.shape[0])
        live = int(valid.sum())
        lib_uids, lib_rows = uids[valid].long(), new_rows[valid]
        b_ms, b_by = bound_ms(uids.numel() * 4 + 2 * live * new_rows.shape[1]
                              * new_rows.element_size(), 0)
        seen.append({
            "site": "K3", "shape": f"{uids.numel()} uids into "
                                   f"{list(table.shape)}",
            "max_abs_err": err, "ok": exact, "ms": ms,
            "plain_ms": event_ms(lambda: rowdma.rowdma_scatter_rows_plain(
                table, uids, new_rows)),
            "library_ms": event_ms(lambda: table.index_copy_(0, lib_uids,
                                                             lib_rows)),
            "bound_ms": b_ms, "bound_by": b_by})
        return table

    def slot_sum_held(slots, g, n_slots, live=None):
        out = slot_sum(slots, g, n_slots, live)
        if live is not None:
            # K1 over the slot stream with and without the weight-0
            # entries routed out: event ms, and the carry pass's device ms
            site = names.get((n_slots, g.shape[1]), f"rows={n_slots}")
            gf = g.float().contiguous()
            for routed in (True, False):
                ids, perm = exchange.slot_stream(slots, n_slots,
                                                 live if routed else None)
                call = lambda: k1(ids, perm, gf, n_slots, torch.float32)
                parts, _ = counted_off(lambda: device_ms(call, calls=5))
                seen.append({
                    "site": f"{site} carry", "routed": routed,
                    "entries": int(slots.numel()),
                    "live": int((ids < n_slots).sum()),
                    "ms": timed(call),
                    "carry_ms": parts.get("range_carry_kernel", 0.0),
                    "chunk_ms": parts.get("range_chunk_kernel", 0.0)})
        return out

    scatter.sorted_stream_sum = k1_held
    scatter.window_scatter_add = k2_held
    rowdma.rowdma_scatter_rows = k3_held
    exchange.slot_sum = slot_sum_held

    def restore():
        scatter.sorted_stream_sum, scatter.window_scatter_add = k1, k2
        rowdma.rowdma_scatter_rows = k3
        exchange.slot_sum = slot_sum
    return restore


def sharded_rank(spec):
    """One rank of phase 11, in its own process (``chip_smoke.py
    --sharded-rank``; the WDT_* variables name its rank): the train CLI
    (``tools.train.main``) with every step's launches, CUDA-event ms,
    exchange bytes and loss recorded, step 0's kernels held to their plain
    versions; then ``evaluate``, and (``restore``) one device's checkpoint
    restored into the rank, each row shard against the file's rows.  ->
    writes its results as JSON to ``spec["out"]``."""
    import torch

    from wide_deep_tpu_torch.ops import cuda_build
    from wide_deep_tpu_torch.parallel import exchange
    from wide_deep_tpu_torch.parallel import mesh as mesh_lib
    from wide_deep_tpu_torch.tools import train as train_cli
    from wide_deep_tpu_torch.training import checkpoint as ckpt_lib
    from wide_deep_tpu_torch.training.loop import Trainer, resolve_checkpoint

    from torch.profiler import ProfilerActivity, profile, schedule

    cuda_build.build()
    steps, seen, prof = [], [], {}
    train_batch = Trainer.train_batch

    def recorded(self, batch, with_summaries=False):
        if len(steps) == 1:
            # steps 2 and 3 profiled, step 1 the tracer's warm-up
            prof["p"] = profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                schedule=schedule(wait=0, warmup=1, active=2, repeat=1))
            prof["p"].__enter__()
        if not steps:
            restore = held_to_plain_sharded(self, self.batch_size, seen)
        names = sharded_site_names(self, self.batch_size)
        c0 = site_counts(self, self.batch_size, names)
        b0 = dict(mesh_lib.collective_bytes)
        e0, e1 = torch.cuda.Event(True), torch.cuda.Event(True)
        e0.record()
        loss = train_batch(self, batch, with_summaries)
        e1.record()
        torch.cuda.synchronize()
        if not steps:
            restore()
        d = delta(c0, site_counts(self, self.batch_size, names))
        b = {k: v - b0.get(k, 0) for k, v in
             mesh_lib.collective_bytes.items() if v - b0.get(k, 0)}
        steps.append({"ms": e0.elapsed_time(e1), "loss": float(loss),
                      "launches": nonzero(d), "bytes": b})
        if "p" in prof and "busy_ms" not in prof:
            prof["p"].step()
            if len(steps) == 4:
                prof["p"].__exit__(None, None, None)
                kernels = sorted(filter(on_device, prof["p"].key_averages()),
                                 key=dev_us, reverse=True)
                prof["busy_ms"] = sum(dev_us(e) for e in kernels) / 2e3
                prof["top"] = [f"{e.key[:50]} {dev_us(e) / 2e3:.3f}"
                               for e in kernels[:6]]
                # the port's kernels' device ms a step, by kernel
                prof["ported"] = {
                    name: round(sum(dev_us(e) for e in kernels
                                    if name in e.key) / 2e3, 4)
                    for name in PORTED_STEP_KERNELS}
        return loss

    Trainer.train_batch = recorded
    t0 = time.time()
    tr = train_cli.main(spec["argv"])
    train_s = time.time() - t0
    Trainer.train_batch = train_batch
    mesh = tr.mesh
    out = {"rank": mesh.rank, "backend": mesh.backend,
           "device": str(tr.device), "mesh": [mesh.data, mesh.model],
           "steps": steps, "held": seen, "train_s": train_s,
           "branches": dict(exchange.branch_counts),
           "paths": sorted("/".join(p) for p in tr.sharded_paths),
           "sites": sorted(set(sharded_site_names(
               tr, tr.batch_size).values())),
           "memory_gb": torch.cuda.max_memory_allocated(tr.device) / 1e9,
           "device_ms": prof.get("busy_ms"), "top": prof.get("top"),
           "ported_ms": prof.get("ported")}
    totals = {}
    for s in steps:
        for k, v in s["launches"].items():
            totals[k] = totals.get(k, 0) + v
    out["launches"] = totals
    if spec.get("eval_data"):
        c0 = counts()
        t0 = time.time()
        out["eval"] = tr.evaluate(spec["eval_data"])
        out["eval_s"] = time.time() - t0
        out["eval_launches"] = nonzero(delta(c0, counts()))
    if spec.get("restore"):
        # one device's checkpoint into the ranks: every leaf of the rank
        # against its rows of the file, bit for bit
        t0 = time.time()
        tr._restore_pinned(spec["restore"])
        files = ckpt_lib.load_tensors(*resolve_checkpoint(spec["restore"]))
        tree = tr._ckpt_tree()
        names = ckpt_lib.sharded_names(tree, tr.sharded_paths)
        bad = []
        for name, leaf in ckpt_lib.named_leaves(tree):
            if not isinstance(leaf, torch.Tensor):
                continue
            want = files[name]
            if name in names:
                rows = leaf.shape[0]
                want = want[mesh.shard * rows:(mesh.shard + 1) * rows]
            if not torch.equal(leaf.detach().cpu(), want):
                bad.append(name)
        out["restored_step"] = tr.global_step
        out["restore_bad"] = bad
        out["restore_s"] = time.time() - t0
    with open(spec["out"], "w") as f:
        json.dump(out, f)


def sharded_conf(tmp, name, mesh, service="", lookup="auto"):
    """conf/ copied to ``tmp/<name>`` for the ranks: pack_budget 3, the
    mesh ``{data, model}``, the input service's address (or none), the
    ``sharded_lookup``."""
    import re
    dst = os.path.join(tmp, name)
    if not os.path.isdir(dst):
        shutil.copytree(os.path.join(ROOT, "conf"), dst)
    path = os.path.join(dst, "train.yaml")
    with open(path) as f:
        text = f.read()
    for pat, rep in ((r"(?m)^  pack_budget:.*$", "  pack_budget: 3"),
                     (r"(?m)^    data: .*$", f"    data: {mesh[0]}"),
                     (r"(?m)^    model: .*$", f"    model: {mesh[1]}"),
                     (r"(?m)^  input_service:.*$",
                      f'  input_service: "{service}"'),
                     (r"(?m)^  sharded_lookup:.*$",
                      f"  sharded_lookup: {lookup}")):
        text, n = re.subn(pat, rep, text)
        if n != 1:
            raise SystemExit(f"phase 11: no {pat} in conf/train.yaml")
    with open(path, "w") as f:
        f.write(text)
    return dst


def start_input_server(tmp, conf_dir, train_tsv):
    """``tools.input_server`` for ``SHARDED_RANKS`` ranks on a subprocess
    -> (the process, its port); its output drained in a thread."""
    import subprocess
    server = subprocess.Popen(
        [sys.executable, "-m", "wide_deep_tpu_torch.tools.input_server",
         "--conf_dir", conf_dir, "--port", "0", "--n_devices",
         str(SHARDED_RANKS), "--n_procs", str(SHARDED_RANKS),
         "--train_data", train_tsv, "--batch_size", str(BATCH)],
        cwd=tmp, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=dict(os.environ, PYTHONPATH=ROOT))
    line, deadline = "", time.time() + 120
    while time.time() < deadline and "table shards)" not in line:
        line = server.stdout.readline()
        if not line and server.poll() is not None:
            raise SystemExit("phase 11: the input server exited")
    port = int(line.split("input service on :")[1].split()[0])
    log(f"phase 11: {line.strip()}")
    threading_drain(server)
    return server, port


def check_bytes(tag, res, conf_dir):
    """Every step's exchange bytes a rank, by tag, equal
    ``parallel.collective_stats``' prediction from shapes alone."""
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.parallel.collective_stats import step_collectives
    config = Config(conf_dir)
    mesh = res[0]["mesh"]
    want = step_collectives(config, dict(config.train, batch_size=BATCH),
                            mesh[0], mesh[1])["by_tag"]
    for r in res:
        for i, st in enumerate(r["steps"]):
            if st["bytes"] != want:
                raise SystemExit(f"phase 11: {tag} rank {r['rank']} step {i}"
                                 f" counted {st['bytes']}, collective_stats "
                                 f"predicts {want}")
    log(f"phase 11: {tag}: every step's bytes a rank equal "
        f"collective_stats' prediction: {want} (sum {sum(want.values())})")
    return want


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(tmp, tag, conf_dir, model_dir, train_tsv, eval_tsv=None,
              restore=None, timeout=900):
    """``SHARDED_RANKS`` rank processes of ``chip_smoke.py --sharded-rank``
    on the train CLI (WDT_* variables, tcp on a free local port) -> their
    results, rank order.  Exits non-zero when a rank fails."""
    import subprocess
    port = free_port()
    procs, specs = [], []
    for r in range(SHARDED_RANKS):
        spec = {"out": os.path.join(tmp, f"{tag}_rank{r}.json"),
                "argv": ["--conf_dir", conf_dir, "--model_dir", model_dir,
                         "--train_data", train_tsv, "--batch_size",
                         str(BATCH), "--keep_train", "0", "--train_epochs",
                         "1", "--distributed", "1"],
                "eval_data": eval_tsv, "restore": restore}
        env = dict(os.environ, WDT_COORDINATOR=f"127.0.0.1:{port}",
                   WDT_NUM_PROCESSES=str(SHARDED_RANKS),
                   WDT_PROCESS_INDEX=str(r))
        logf = open(os.path.join(tmp, f"{tag}_rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
             "--sharded-rank", json.dumps(spec)], env=env, cwd=tmp,
            stdout=logf, stderr=subprocess.STDOUT), logf))
        specs.append(spec)
    deadline = time.time() + timeout
    failed = None
    for p, logf in procs:
        try:
            p.wait(timeout=max(deadline - time.time(), 1))
        except subprocess.TimeoutExpired:
            failed = "timed out"
        logf.close()
        if p.returncode not in (0, None) and failed is None:
            failed = f"exit {p.returncode}"
    for p, _ in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    if failed:
        for r in range(SHARDED_RANKS):
            with open(os.path.join(tmp, f"{tag}_rank{r}.log")) as f:
                sys.stderr.write(f"--- {tag} rank {r}:\n{f.read()[-6000:]}\n")
        raise SystemExit(f"phase 11: {tag}: a rank {failed}")
    out = []
    for spec in specs:
        with open(spec["out"]) as f:
            out.append(json.load(f))
    return out


def check_rank_steps(tag, res, dedup=False):
    """Each rank's steps launched the sharded sites (``SITES_SHARDED``; on
    the d16 stream K2, or K1 when the plan row says ok=0; with ``dedup``
    ``SITES_DEDUP``, K2 never), held step 0's kernels to their plain
    versions, and the ranks' losses are the same bits."""
    sites_of = SITES_DEDUP if dedup else SITES_SHARDED
    for r in res:
        for i, s in enumerate(r["steps"]):
            d = dict(s["launches"])
            for k in ("K1", "K2", "K3", "d16 ok=0", "P1", "P2"):
                d.setdefault(k, 0)
            check_sites(f"phase 11: {tag} rank {r['rank']} step {i}", d,
                        sites_of, window=not dedup)
        held = [h for h in r["held"] if "routed" not in h]
        sites = {}
        for h in held:
            sites[h["site"]] = sites.get(h["site"], 0) + 1
        want = dict(sites_of)
        ok0 = r["steps"][0]["launches"].get("d16 ok=0", 0)
        if ok0:
            want["K1 d16 ok=0"] = 1
        elif not dedup:
            want["K2"] = 1
        if sites != want or not all(h["ok"] for h in held):
            raise SystemExit(f"phase 11: {tag} rank {r['rank']} step 0's "
                             f"kernels {held}, want sites {want}")
        log(f"phase 11: {tag} rank {r['rank']} ({r['device']}, "
            f"{r['backend']}) step 0's launches against their plain "
            f"versions on the per-shard inputs (event ms: kernel, plain, "
            f"library; bound ms): " +
            "; ".join(f"{h['site']} ({h['shape']}) max_abs_err "
                      f"{h['max_abs_err']:.3g} ok, {h['ms']:.4f} / "
                      f"{h['plain_ms']:.4f} / {h['library_ms']:.4f} ms, "
                      f"bound {h['bound_ms']:.4f} ({h['bound_by']})"
                      for h in held))
        carry = [h for h in r["held"] if "routed" in h]
        if carry:
            log(f"phase 11: {tag} rank {r['rank']} the slot sums' K1 with "
                f"and without the weight-0 entries routed out (event ms; "
                f"device ms of the chunk and carry passes): " + "; ".join(
                    f"{h['site']} {'routed' if h['routed'] else 'unrouted'}"
                    f" ({h['live']} live of {h['entries']}) {h['ms']:.4f} "
                    f"ms, chunk {h['chunk_ms']:.4f}, carry "
                    f"{h['carry_ms']:.4f}" for h in carry))
    losses = [[s["loss"] for s in r["steps"]] for r in res]
    if any(x != losses[0] for x in losses[1:]):
        raise SystemExit(f"phase 11: {tag}: the ranks' losses differ: "
                         f"{losses}")
    return losses[0]


def state_rel_diff(dir_a, step_a, dir_b, step_b):
    """{leaf: max |a - b| / max |b|} of two checkpoints' tensors."""
    import torch

    from wide_deep_tpu_torch.training.checkpoint import load_tensors
    a, b = load_tensors(dir_a, step_a), load_tensors(dir_b, step_b)
    if sorted(a) != sorted(b):
        raise SystemExit(f"phase 11: the checkpoints' leaves differ: "
                         f"{sorted(set(a) ^ set(b))}")
    out = {}
    for k in a:
        if a[k].shape != b[k].shape:
            raise SystemExit(f"phase 11: {k}: {a[k].shape} vs {b[k].shape}")
        if not a[k].is_floating_point():
            out[k] = 0.0 if torch.equal(a[k], b[k]) else float("inf")
            continue
        x, y = a[k].float(), b[k].float()
        scale = float(y.abs().max()) or 1.0
        out[k] = float((x - y).abs().max()) / scale
    return out


def phase_sharded(card, tmp):
    """Phase 11: the production model trained across ranks (module
    docstring) -> each rank's launches on the sharded path, rank order."""
    import subprocess

    import numpy as np
    import torch

    from wide_deep_tpu_torch import testing
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.parallel.mesh import placement
    from wide_deep_tpu_torch.training.checkpoint import (committed_steps,
                                                         load_tensors,
                                                         named_leaves)
    from wide_deep_tpu_torch.training.loop import Trainer

    t_phase = time.time()
    n_cards = torch.cuda.device_count()
    _, _, per_card = placement(0, SHARDED_RANKS, n_cards=n_cards)
    conf_dir = sharded_conf(tmp, "conf_sharded", (SHARDED_RANKS, 1))
    config = Config(conf_dir)
    train_tsv = os.path.join(tmp, "sharded_train.tsv")
    eval_tsv = os.path.join(tmp, "sharded_eval.tsv")
    t0 = time.time()
    testing.generate_ctr_tsv(config, train_tsv, SHARDED_STEPS * BATCH,
                             seed=11, hash_spread=None)
    testing.generate_ctr_tsv(config, eval_tsv, BATCH, seed=12,
                             hash_spread=None)
    gen_s = time.time() - t0

    # one device: the same weights (the seed's draw), the same global
    # batches, then its checkpoint
    one_dir = os.path.join(tmp, "one")
    tr = Trainer(config, "wide_deep", model_dir=one_dir,
                 overrides={"batch_size": BATCH, "train_data": train_tsv,
                            "keep_train": False}, device="cuda")
    tr.ensure_initialized(restore=False)
    one_ms, one_losses = [], []
    train_batch = tr.train_batch

    def timed(batch, with_summaries=False):
        e0, e1 = torch.cuda.Event(True), torch.cuda.Event(True)
        e0.record()
        loss = train_batch(batch, with_summaries)
        e1.record()
        torch.cuda.synchronize()
        one_ms.append(e0.elapsed_time(e1))
        one_losses.append(float(loss))
        return loss
    tr.train_batch = timed
    tr.train_file(train_tsv)
    one_eval = tr.evaluate(eval_tsv)
    tr.save()
    one_dir = tr.model_dir
    del tr, train_batch
    release()
    log(f"phase 11: one device: {len(one_losses)} steps of {BATCH} rows "
        f"(median {float(np.median(one_ms[1:])):.2f} ms by CUDA events), "
        f"losses {one_losses}; AUC {one_eval['auc']:.6f}, logloss "
        f"{one_eval['average_loss']:.6f}; generated the TSVs in "
        f"{gen_s:.1f} s")

    # the input service and the ranks on its slices
    server, port = start_input_server(tmp, conf_dir, train_tsv)
    try:
        sharded_conf(tmp, "conf_sharded", (SHARDED_RANKS, 1),
                     f"127.0.0.1:{port}")
        ranks_dir = os.path.join(tmp, "ranks")
        res = run_ranks(tmp, "data2", conf_dir, ranks_dir, train_tsv,
                        eval_tsv, restore=os.path.join(
                            one_dir, str(committed_steps(one_dir)[-1])))
    finally:
        server.kill()
        server.wait()
    losses = check_rank_steps("{data: 2, model: 1}", res)
    if len(losses) != SHARDED_STEPS:
        raise SystemExit(f"phase 11: the ranks took {len(losses)} steps")
    explicit_bytes = check_bytes("{data: 2, model: 1}", res, conf_dir)
    worst_loss = max(abs(a - b) / abs(b) for a, b in zip(losses, one_losses))
    for r in res:
        ms = [s["ms"] for s in r["steps"]]
        per_step = r["steps"][-1]["bytes"]
        log(f"phase 11: rank {r['rank']} on {r['device']} over "
            f"{r['backend']} ({per_card} ranks a card): step ms by CUDA "
            f"events {[round(x, 2) for x in ms]} (median of steps 1-"
            f"{len(ms) - 1}: {float(np.median(ms[1:])):.2f}); device busy "
            f"{r['device_ms']:.3f} ms a step (profiler, steps 2-3; top "
            f"{r['top']}; the port's kernels {r['ported_ms']}); exchange "
            f"bytes a step {per_step} (sum {sum(per_step.values())}); "
            f"live-cap / full / exact branches {r['branches']}; launches "
            f"{r['launches']}; peak {r['memory_gb']:.2f} GB; row-sharded "
            f"{r['paths']}")
    # the ranks against one device: losses, evaluate, whole state
    e0, e1 = res[0]["eval"], one_eval
    eval_gap = max(abs(e0[k] - e1[k]) for k in ("auc", "average_loss"))
    ranks_dir_m = os.path.join(ranks_dir, "wide_deep")
    r_step = committed_steps(ranks_dir_m)[-1]
    o_step = committed_steps(one_dir)[-1]
    diffs = state_rel_diff(ranks_dir_m, r_step, one_dir, o_step)
    worst = sorted(diffs.items(), key=lambda kv: -kv[1])[:4]
    log(f"phase 11: ranks vs one device: losses {losses} (worst relative "
        f"{worst_loss:.3e}, bar {SHARDED_LOSS_TOL:.3e}); evaluate AUC "
        f"{e0['auc']:.6f} vs {e1['auc']:.6f}, logloss "
        f"{e0['average_loss']:.6f} vs {e1['average_loss']:.6f} (worst "
        f"{eval_gap:.3e}, bar {SHARDED_EVAL_TOL}), the same on both ranks: "
        f"{res[0]['eval'] == res[1]['eval']}, launches "
        f"{res[0]['eval_launches'] or 'none'}; step {r_step}'s state, "
        f"worst leaves (max |diff| / max |leaf|) "
        f"{[(k, f'{v:.3e}') for k, v in worst]}, bar "
        f"{SHARDED_STATE_TOL:.3e}")
    if (worst_loss > SHARDED_LOSS_TOL or eval_gap > SHARDED_EVAL_TOL
            or res[0]["eval"] != res[1]["eval"]
            or max(diffs.values()) > SHARDED_STATE_TOL or r_step != o_step):
        raise SystemExit("phase 11: the ranks left one device's results")
    # 1 -> N: each rank restored one device's checkpoint to its own rows
    for r in res:
        if r["restore_bad"] or r["restored_step"] != o_step:
            raise SystemExit(f"phase 11: rank {r['rank']} restored step "
                             f"{r['restored_step']} with {r['restore_bad']}"
                             f" unlike the file")
    # N -> 1: one device restores the ranks' checkpoint, bit for bit
    t0 = time.time()
    tr = Trainer(config, "wide_deep", model_dir=ranks_dir,
                 overrides={"batch_size": BATCH}, device="cuda")
    tr.ensure_initialized(restore=True)
    files = load_tensors(ranks_dir_m, r_step)
    gb = sum(t.nbytes for t in files.values()) / 1e9
    bad = [n for n, leaf in named_leaves(tr._ckpt_tree())
           if isinstance(leaf, torch.Tensor)
           and not torch.equal(leaf.detach().cpu(), files[n])]
    log(f"phase 11: checkpoints: one device's step {o_step} restored into "
        f"each rank's rows bit for bit ({res[0]['restore_s']:.1f} s); the "
        f"ranks' step {r_step} ({gb:.2f} GB, written by rank 0) restored "
        f"into one device bit for bit: "
        f"{not bad and tr.global_step == r_step} ({time.time() - t0:.1f} s)")
    if bad or tr.global_step != r_step:
        raise SystemExit(f"phase 11: N -> 1 restore differs in {bad}")
    del tr, files
    release()

    # the model axis: {data: 1, model: 2}, every rank reading the global
    # batch (its plan row of it), no input service
    conf_m = sharded_conf(tmp, "conf_model_axis", (1, SHARDED_RANKS))
    res_m = run_ranks(tmp, "model2", conf_m, os.path.join(tmp, "ranks_m"),
                      train_tsv)
    losses_m = check_rank_steps("{data: 1, model: 2}", res_m)
    check_bytes("{data: 1, model: 2}", res_m, conf_m)
    worst_m = max(abs(a - b) / abs(b)
                  for a, b in zip(losses_m, one_losses))
    log(f"phase 11: {{data: 1, model: 2}}: losses {losses_m} against one "
        f"device's {one_losses} (worst relative "
        f"{worst_m:.3e}); step ms "
        f"{[round(s['ms'], 2) for s in res_m[0]['steps']]}; exchange bytes a step {res_m[0]['steps'][-1]['bytes']}")
    if len(losses_m) != SHARDED_STEPS or worst_m > SHARDED_LOSS_TOL:
        raise SystemExit("phase 11: the model axis left one device's losses")
    if n_cards >= SHARDED_RANKS:
        res_n = run_ranks(tmp, "nccl", conf_m, os.path.join(tmp, "ranks_n"),
                          train_tsv)
        losses_n = check_rank_steps("NCCL, a card each", res_n)
        log(f"phase 11: NCCL ranks on {[r['device'] for r in res_n]}: "
            f"losses {losses_n}")
    else:
        log(f"phase 11: one card ({n_cards}): the NCCL ranks on separate "
            f"cards did not run")

    # sharded_lookup: dedup, on both meshes (the data axis behind an input
    # service of its own, whose plans are the dedup exchange's)
    dedup = {}     # tag: (conf dir, model dir, the ranks' results)
    conf_dm = sharded_conf(tmp, "conf_dedup_model", (1, SHARDED_RANKS),
                           lookup="dedup")
    dir_dm = os.path.join(tmp, "ranks_dm")
    dedup["{data: 1, model: 2}"] = (conf_dm, dir_dm, run_ranks(
        tmp, "dedup_model2", conf_dm, dir_dm, train_tsv))
    conf_dd = sharded_conf(tmp, "conf_dedup_data", (SHARDED_RANKS, 1),
                           lookup="dedup")
    server, port = start_input_server(tmp, conf_dd, train_tsv)
    try:
        sharded_conf(tmp, "conf_dedup_data", (SHARDED_RANKS, 1),
                     f"127.0.0.1:{port}", lookup="dedup")
        dir_dd = os.path.join(tmp, "ranks_dd")
        dedup["{data: 2, model: 1}"] = (conf_dd, dir_dd, run_ranks(
            tmp, "dedup_data2", conf_dd, dir_dd, train_tsv))
    finally:
        server.kill()
        server.wait()
    for tag, (conf_x, dir_x, res_x) in dedup.items():
        losses_x = check_rank_steps(f"dedup {tag}", res_x, dedup=True)
        want = check_bytes(f"dedup {tag}", res_x, conf_x)
        worst_x = max(abs(a - b) / abs(b)
                      for a, b in zip(losses_x, one_losses))
        dir_x = os.path.join(dir_x, "wide_deep")
        step_x = committed_steps(dir_x)[-1]
        diffs_x = state_rel_diff(dir_x, step_x, one_dir, o_step)
        worst_leaf = max(diffs_x.items(), key=lambda kv: kv[1])
        r0 = res_x[0]
        ms = [st["ms"] for st in r0["steps"]]
        log(f"phase 11: dedup {tag}: losses {losses_x} against one "
            f"device's (worst relative {worst_x:.3e}, bar "
            f"{SHARDED_LOSS_TOL:.3e}); step {step_x}'s state, worst leaf "
            f"{worst_leaf[0]} {worst_leaf[1]:.3e} (bar "
            f"{SHARDED_STATE_TOL:.3e}); step ms by CUDA events "
            f"{[round(x, 2) for x in ms]} (median of steps 1-{len(ms) - 1}:"
            f" {float(np.median(ms[1:])):.2f}); device busy a rank "
            f"{[round(r['device_ms'], 3) for r in res_x]} ms a step (top "
            f"{r0['top']}; the port's kernels {r0['ported_ms']}); the "
            f"dedup all-gather {want.get('dedup_rows', 0)} bytes a rank a "
            f"step beside the explicit lookup's "
            f"{explicit_bytes.get('lookup', 0)} ({{data: 2, model: 1}}); "
            f"all bytes {sum(want.values())} beside the explicit "
            f"exchange's {sum(explicit_bytes.values())}; launches "
            f"{r0['launches']}; peak {r0['memory_gb']:.2f} GB")
        if (len(losses_x) != SHARDED_STEPS or worst_x > SHARDED_LOSS_TOL
                or worst_leaf[1] > SHARDED_STATE_TOL or step_x != o_step):
            raise SystemExit(f"phase 11: dedup {tag} left one device's "
                             f"results")
    log(f"phase 11 in {time.time() - t_phase:.1f} s")
    res_d = dedup["{data: 1, model: 2}"][2]
    return ([r["launches"] for r in res],
            [r["launches"] for r in res_d], res_d[0]["held"])


# ----------------------------------------------------------------- phase 13
# the DLRM-DCNv2 cell's tables as one of 8 GPUs holds them (rows, multi-hot
# size), benchmark/configs/dlrm_dcnv2_criteo1tb_8th.json
DCN_TABLES = ((5000000, 3), (39060, 2), (17295, 1), (7424, 2), (20265, 6),
              (3, 1), (7122, 1), (1543, 1), (63, 1), (5000000, 7),
              (383494, 3), (405282, 8), (10, 1), (2209, 6), (11938, 9),
              (155, 5), (4, 1), (976, 1), (14, 1), (5000000, 12),
              (5000000, 100), (5000000, 27), (590152, 10), (12973, 3),
              (108, 1), (36, 1))
DCN_BATCH = 8192
# the small conf of the Trainer check: (rows, hotness) of 4 tables
DCN_SMALL = ((50021, 3), (20011, 100), (3001, 1), (997, 7))
# card against host over 3 steps: the two sum in other orders (cuBLAS
# against the host's GEMMs, K1 against index_add_), a flipped bfloat16
# rounding moves an O(1) value by 2^-8, and Adagrad's first steps move
# every weight by about its rate whatever the gradient's size, so the
# flips grow step by step (PR 20's first card run: the third loss 2.2e-3
# apart): the losses within 1e-2 relative, each leaf's change within 5%
# of its norm
DCN_TOL = {"loss": 1e-2, "change": 5e-2}


def dcn_stream(rng):
    """The cell's d128 pool as the loader packs it: each row the 26
    features' values in order (zipf-1.3 over each table's rows), as table
    rows of the one d128 group -> int32 [DCN_BATCH * 214]."""
    import numpy as np
    offsets = np.cumsum([0] + [r for r, _ in DCN_TABLES])
    cols = [offsets[f] + rng.zipf(1.3, (DCN_BATCH, hot)) % rows
            for f, (rows, hot) in enumerate(DCN_TABLES)]
    return np.concatenate(cols, axis=1).reshape(-1).astype(np.int32), int(
        offsets[-1])


def dcn_kernel_rows(device):
    """K1 at d128 and K3 at widths 132 and 136 at the cell's shapes ->
    the kernels rows."""
    import numpy as np
    import torch

    from wide_deep_tpu_torch.ops import rowdma, scatter
    rng = np.random.default_rng(13)
    gen = torch.Generator(device=device).manual_seed(13)
    ids, n_rows = dcn_stream(rng)
    table_rows = -(-n_rows // 256) * 256
    plan = scatter.make_compact_plan(ids, table_rows)
    n = ids.size
    live = int(plan["ids"][-1]) + 1
    log(f"phase 13: the d128 stream: {n} entries, {live} distinct rows of "
        f"{table_rows}; {scatter.range_carry_levels(n)} carry levels")
    tp = {k: torch.from_numpy(v).to(device) for k, v in plan.items()}
    g = torch.randn((n, 128), generator=gen, device=device).to(
        torch.bfloat16)
    rows = []
    # the step's call: the bfloat16 sink gradient in, float32 sums out, over
    # the plan's distinct rows (optim/sparse.apply_fused_update)
    rows.append(check_scatter(
        "K1 range_scatter_add d128 compact",
        lambda: scatter.range_scatter_add(tp["ids"], tp["perm"], g,
                                          tp["tiles"], live, torch.float32),
        lambda: scatter.range_scatter_add_plain(tp["ids"], tp["perm"],
                                                g, live, torch.float32),
        lambda: torch.zeros((live, 128), device=device).index_add_(
            0, tp["ids"].long(), g[tp["perm"].long()].float()),
        torch.float32, n, 128, live, 2, 0,
        "wide_deep_tpu_torch/csrc/range_scatter.cu",
        "wide_deep_tpu/ops/scatter.py:184", memset=True,
        magnitudes=lambda: scatter.range_scatter_add_plain(
            tp["ids"], tp["perm"], g.abs(), live, torch.float32)))
    del g
    release()
    # the step's write-back: the distinct rows, and one sentinel uid past
    # them (check_writeback holds the kernel to skipping it)
    uids = tp["uids"][:live + 1].contiguous()
    for width in (132, 136):
        table = torch.zeros((table_rows, width), device=device)
        new_rows = torch.randn((live + 1, width), generator=gen,
                               device=device)
        rows.append(check_writeback(
            f"K3 rowdma_scatter_rows w{width}", rowdma.rowdma_scatter_rows,
            table, uids, new_rows,
            "wide_deep_tpu_torch/csrc/rowdma.cu",
            "wide_deep_tpu/ops/rowdma.py:80"))
        del table, new_rows
        release()
    return rows


def dcn_small_conf(tmp):
    """The small DCN conf of the Trainer check in ``tmp``: DCN_SMALL's
    tables at d128, the cell's widths elsewhere (bottom 512-256-128, 3
    cross layers of rank 512, top 1024-1024-512-256)."""
    import yaml
    os.makedirs(tmp, exist_ok=True)
    dense = [f"i{j}" for j in range(1, 14)]
    cats = [f"c{j}" for j in range(1, len(DCN_SMALL) + 1)]
    docs = {
        "schema": {"columns": ["clicked"] + dense + cats},
        "feature": dict(
            {d: {"type": "continuous", "transform": "log1p"} for d in dense},
            **{c: {"type": "category", "transform": "hash_bucket",
                   "parameter": r, "embedding_dim": 128, "max_len": h,
                   "combiner": "sum"} for c, (r, h) in zip(cats, DCN_SMALL)}),
        "cross_feature": {},
        "model": {"linear_optimizer": "Ftrl",
                  "dnn_optimizer": {"name": "Adagrad",
                                    "learning_rate": 0.005},
                  "dnn_embedding_optimizer": {"name": "RowwiseAdagrad",
                                              "learning_rate": 0.005},
                  "dnn_bottom_units": [512, 256, 128],
                  "dnn_interaction": {"type": "dcn", "layers": 3,
                                      "rank": 512},
                  "dnn_hidden_units": [1024, 1024, 512, 256],
                  "embedding_dtype": "bfloat16", "dense_dtype": "bfloat16"},
        "train": {"train": {
            "model_dir": os.path.join(tmp, "m"), "model_type": "deep",
            "train_data": "x", "eval_data": "x", "test_data": "x",
            "batch_size": 1024, "num_examples": 1 << 20, "multivalue": 1,
            "pack_budget": 100, "sparse_optimizer": 1,
            "scatter_mode": "pallas", "keep_train": 0}},
        "serving": {"SavedModel": {"model_dir": "x", "model_type": "deep"}},
        "data_process": {}}
    for name, doc in docs.items():
        with open(os.path.join(tmp, name + ".yaml"), "w") as f:
            yaml.safe_dump(doc, f, sort_keys=False)
    return tmp


def phase_dcn(card, tmp):
    """Phase 13 (module docstring) -> (kernels rows, launch counts)."""
    import numpy as np
    import torch

    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.features.pipeline import FeatureTransformer
    from wide_deep_tpu_torch.ops import rowdma, scatter
    from wide_deep_tpu_torch.optim import sparse as sparse_lib
    from wide_deep_tpu_torch.optim import tree_items
    from wide_deep_tpu_torch.tools import median_ms
    from wide_deep_tpu_torch.training.loop import Trainer
    t0 = time.time()
    device = torch.device("cuda")
    rows = dcn_kernel_rows(device)
    conf = dcn_small_conf(os.path.join(tmp, "dcn_conf"))
    rng = np.random.default_rng(5)
    batches = []
    saved = sparse_lib.SPARSE_MIN_ROWS
    sparse_lib.SPARSE_MIN_ROWS = 1
    try:
        trs = {}
        for dev in ("cpu", "cuda"):
            trs[dev] = Trainer(Config(conf), "deep",
                               model_dir=os.path.join(tmp, f"dcn_{dev}"),
                               device=dev)
        trs["cpu"].ensure_initialized(restore=False)
        trs["cuda"].ensure_initialized(restore=False)
        with torch.no_grad():
            for (p, a), (_, b) in zip(tree_items(trs["cpu"].params),
                                      tree_items(trs["cuda"].params)):
                b.copy_(a)
        plan = trs["cpu"].plan
        spec = plan.batch_spec(1024)
        for _ in range(3):
            lines = []
            for r in range(1024):
                cells = [str(int(rng.random() < 0.1))] + [
                    str(int(rng.lognormal(1.0, 2.0))) for _ in range(13)]
                for j, (n_rows, hot) in enumerate(DCN_SMALL):
                    cells.append(",".join(
                        f"c{j}_{v}" for v in rng.zipf(1.3, hot) % n_rows))
                lines.append("\t".join(cells))
            b = FeatureTransformer(plan).transform(
                [ln.split("\t") for ln in lines], 1024)
            assert set(b) == set(spec), sorted(set(b) ^ set(spec))
            batches.append(b)
        counts0 = (scatter.range_launches_by_width().get(128, 0),
                   rowdma.rowdma_launches_by_width.get(132, 0))
        c0 = counts()
        losses = {}
        for dev, tr in trs.items():
            losses[dev] = []
            for b in batches:
                losses[dev].append(float(tr.train_batch(b)))
        torch.cuda.synchronize()
        held = (scatter.range_launches_by_width().get(128, 0) - counts0[0],
                rowdma.rowdma_launches_by_width.get(132, 0) - counts0[1])
        if held != (3, 3):
            raise SystemExit(f"phase 13: K1 d128 / K3 w132 launches over 3 "
                             f"steps: {held}, want (3, 3)")
        sweeps = {k: 3 * v for k, v in sweep_leaves(trs["cuda"]).items()}
        swept = delta(c0, counts())
        check_sweeps("phase 13: DCN Trainer over 3 steps", swept, sweeps)
        loss_gap = max(abs(a - b) / abs(a)
                       for a, b in zip(losses["cpu"], losses["cuda"]))
        start = Trainer(Config(conf), "deep",
                        model_dir=os.path.join(tmp, "dcn_start"),
                        device="cpu")
        start.ensure_initialized(restore=False)
        worst, at = 0.0, ""
        with torch.no_grad():
            for (p, w0), (_, a), (_, b) in zip(
                    tree_items(start.params), tree_items(trs["cpu"].params),
                    tree_items(trs["cuda"].params)):
                gap = float(torch.linalg.norm(b.cpu() - a))
                rel = gap / max(float(torch.linalg.norm(a - w0)), 1e-30)
                if rel > worst:
                    worst, at = rel, "/".join(str(k) for k in p)
        log(f"phase 13: DCN Trainer, card against host: losses "
            f"{losses['cuda']} / {losses['cpu']} ({loss_gap:.3g} apart at "
            f"most); the worst leaf's change {worst:.3g} of its norm apart "
            f"({at})")
        if loss_gap > DCN_TOL["loss"] or worst > DCN_TOL["change"]:
            raise SystemExit(f"phase 13: card and host apart beyond "
                             f"{DCN_TOL}")
        tr = trs["cuda"]
        dev_batch = tr._device_batch(batches[0])
        step_ms = median_ms(lambda: tr.train_batch(dev_batch), 10, device)
    finally:
        sparse_lib.SPARSE_MIN_ROWS = saved
    log(f"phase 13: DCN Trainer at batch 1024: K1 d128 and K3 w132 once "
        f"a step, sweeps over 3 steps {sweeps}; {step_ms:.3f} ms a step "
        f"(CUDA events, median of 10); phase 13 in {time.time() - t0:.1f} s")
    return rows, dict(sweeps, **{"K1 d128": held[0], "K3 w132": held[1]})


def phase_perf_gate(profile_dir):
    """Phase 12: the perf gate on phase 5's trace of 3 device-stage steps
    (the bench tool under ``BENCH_PROFILE``): ``tools.parse_trace``'s
    device events, ``tools.perf_regression capture`` into
    build/perf_budget_capture.json and ``check`` of the trace against that
    capture, which must pass; the bucket profile and the port's kernels a
    step printed; fails when the trace holds no device event or a kernel
    the step launched (K1, K3, and K2 or the d16 stream's K1) is missing
    from the ``kernel`` bucket.  The committed perf_budget_torch.json is
    compared and printed, not gated (tests/test_torch_chip_gates.py gates
    it)."""
    import contextlib
    import io

    from wide_deep_tpu_torch.tools import parse_trace
    from wide_deep_tpu_torch.tools import perf_regression as pr
    from wide_deep_tpu_torch.tools.bench import PROFILE_STEPS
    t0 = time.time()

    def run(args):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = pr.main(args)
        return rc, buf.getvalue().strip().splitlines()[-1]

    try:
        events = parse_trace.device_events(profile_dir)
        if not events:
            raise SystemExit(f"phase 12: no device event in a trace under "
                             f"{profile_dir}")
        out = os.path.join(ROOT, "build", "perf_budget_capture.json")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        steps = ["--profile_dir", profile_dir, "--steps", str(PROFILE_STEPS)]
        rc, line = run(["capture"] + steps + ["--out", out])
        if rc:
            raise SystemExit(f"phase 12: capture failed: {line}")
        rc, verdict = run(["check"] + steps + ["--budget", out])
        if rc:
            raise SystemExit(f"phase 12: the trace fails against its own "
                             f"capture: {verdict}")
        with open(out) as f:
            meta = json.load(f)
        kernels = meta["kernels"]
        need = {"range_chunk_kernel", "rowdma_kernel"}
        if kernels.get("range_chunk_kernel", {}).get("launches", 0) < 5:
            need.add("window_scatter_kernel")     # d16 ok=1: K2 ran
        missing = sorted(need - set(kernels))
        log(f"phase 12: {sum(n for _, n in events.values())} device events "
            f"in the trace; ms a step by bucket "
            f"{meta['buckets_ms_per_step']}; the port's kernels a step "
            f"{kernels}; card {meta['card']!r}; check against its own "
            f"capture: {verdict}")
        if missing:
            raise SystemExit(f"phase 12: the step's kernels {missing} are "
                             f"missing from the kernel bucket")
        committed = os.path.join(ROOT, "perf_budget_torch.json")
        if os.path.exists(committed):
            rc, verdict = run(["check"] + steps + ["--budget", committed])
            log(f"phase 12: against the committed perf_budget_torch.json "
                f"(not gated): {verdict}")
    finally:
        shutil.rmtree(profile_dir, ignore_errors=True)
    log(f"phase 12 in {time.time() - t0:.1f} s")


def threading_drain(proc):
    """Read a child's remaining output in a thread, so it never blocks on a
    full pipe."""
    import threading
    threading.Thread(target=proc.stdout.read, daemon=True).start()


def count_key(name):
    """A kernels-line row's counter: "K1 range_scatter_add d8" -> "K1 d8",
    "K3 rowdma_scatter_rows d32" -> "K3", "P2 bulk_scatter_rows f32" ->
    "P2"."""
    parts = name.split(" ", 2)
    return f"K1 {parts[2]}" if parts[0] == "K1" else parts[0]


def main():
    import gc

    import torch
    if len(sys.argv) == 3 and sys.argv[1] == "--sharded-rank":
        # one rank of phase 11, started by phase_sharded
        sys.path.insert(0, ROOT)
        sharded_rank(json.loads(sys.argv[2]))
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import wide_deep_tpu_torch  # noqa: F401
    except ModuleNotFoundError as e:
        # alone, without the repo beside it: no result, a reason
        print(f"chip_smoke: {e}; run it from the repo's root", file=sys.stderr)
        return 2
    import numpy as np

    from concurrent.futures import ThreadPoolExecutor

    from wide_deep_tpu_torch import testing
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.features import native
    from wide_deep_tpu_torch.ops import cuda_build
    from wide_deep_tpu_torch.tools.bench import device_name
    from wide_deep_tpu_torch.training.loop import build_training_plan

    card = device_name(torch.device("cuda"))    # nvidia-smi's line
    log(card)
    only = None
    if sys.argv[1:]:
        if len(sys.argv) != 3 or sys.argv[1] != "--only" or sys.argv[2] \
                not in ("dcn", "optim"):
            print("usage: chip_smoke.py [--only dcn|optim]", file=sys.stderr)
            return 2
        only = sys.argv[2]
    t0 = time.time()
    with ThreadPoolExecutor(1) as pool:     # g++ beside the nvcc processes
        loader = pool.submit(native.build)
        built = cuda_build.build()
        kernels_s = time.time() - t0
        loader = loader.result()
    log(f"phase 0: built {sorted(built) or 'nothing (cached)'} in "
        f"{kernels_s:.1f} s; the C++ loader "
        f"{'built' if loader['built'] else 'found'} in "
        f"{loader['seconds']:.1f} s: {os.path.relpath(loader['path'], ROOT)}")

    if only == "dcn":
        tmp = tempfile.mkdtemp(prefix="chip_smoke_dcn_")
        try:
            dcn_rows, _ = phase_dcn(card, tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        log(json.dumps({"kernels": dcn_rows}))
        return 0
    if only == "optim":
        tmp = tempfile.mkdtemp(prefix="chip_smoke_optim_")
        try:
            phase_fm(card, tmp)
            sweeps = phase_sweeps()
            phase_optimizers(card, tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        log(json.dumps({"sweeps": sweeps}))
        return 0
    device = torch.device("cuda")
    config = Config(os.path.join(ROOT, "conf"))
    train_conf = dict(config.train, batch_size=BATCH, pack_budget=3)
    plan = build_training_plan(config, train_conf, "wide_deep")
    batch = testing.synthetic_batch(plan, BATCH, np.random.default_rng(0))
    kernels = phase_kernels(plan, batch, device)
    del batch

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        trainer, tsv, main_counts = phase_trainer(card, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        tool_counts = phase_tools()
        phase_eval(trainer, tsv)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    profile_dir = tempfile.mkdtemp(prefix="chip_smoke_profile_")
    phase_bench(card, profile_dir)
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        cli_counts = phase_cli(card, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        phase_serving(card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_configs_")
    try:
        configs = phase_configs(card, tmp)
        release()
        phase_quality(card, tmp)
        release()
        cnn_counts = phase_cnn(card, tmp)
        release()
        sharded, sharded_dedup, dedup_held = phase_sharded(card, tmp)
        release()
        dcn_rows, dcn_counts = phase_dcn(card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_perf_gate(profile_dir)

    # K1 (the d16 ok=0 site on file steps), K2 and K3 launch on the train
    # path, P1 and P2 on the tools' path; the CLI path's launches beside
    paths = dict(main_counts, **tool_counts)
    for row in kernels:
        row["launches"] = paths.get(count_key(row["name"]), 0)
        if not row["name"].startswith("P"):
            row["launches_cli"] = cli_counts.get(count_key(row["name"]), 0)
            row["launches_cnn"] = cnn_counts.get(count_key(row["name"]), 0)
            # each rank's launches on the sharded path (phase 11), and
            # under sharded_lookup: dedup
            row["launches_sharded"] = [s.get(count_key(row["name"]), 0)
                                       for s in sharded]
            row["launches_dedup"] = [s.get(count_key(row["name"]), 0)
                                     for s in sharded_dedup]
        if "bf16" in row:
            row["bf16"]["launches"] = tool_counts["P2 bf16"]
    # the dedup exchange's slot sums, a K1 site of its own: its numbers
    # from rank 0's step 0 of the dedup run {data: 1, model: 2}
    for h in dedup_held:
        if not h["site"].endswith(" dedup"):
            continue
        dim = h["site"].split()[1]
        kernels.append({
            "name": f"K1 range_scatter_add {dim} dedup", "route": "cuda",
            "source": "wide_deep_tpu_torch/csrc/range_scatter.cu",
            "replaces": "wide_deep_tpu/ops/scatter.py:184",
            "launches": sharded_dedup[0].get(h["site"], 0),
            "launches_dedup": [s.get(h["site"], 0) for s in sharded_dedup],
            "shape": h["shape"], "max_abs_err": h["max_abs_err"],
            "tolerance": "<= 1e-6 of the row's sum of |g| + 1e-6",
            "ok": h["ok"], "ms": h["ms"], "plain_ms": h["plain_ms"],
            "bound_ms": h["bound_ms"], "bound_by": h["bound_by"],
            "library_ms": h["library_ms"]})
    for row in dcn_rows:
        row["launches"] = dcn_counts["K1 d128" if row["name"].startswith(
            "K1") else "K3 w132"] if "w136" not in row["name"] else 0
    # the optimizer sweeps, counted on the main path (phase 2)
    kernels.extend(sweep_rows(configs["sweeps"], main_counts, dcn_counts))
    if not all(row["launches"] > 0 for row in kernels):
        raise SystemExit(f"a kernel never ran on its path: train "
                         f"{main_counts}, tools {tool_counts}")
    # the CNN path's kernels: K1 at the wide gather and the d32 compact sum,
    # K3 (SITES_QUALITY["wide_deep"])
    if not all(cnn_counts.get(k, 0) > 0 for k, v in
               SITES_QUALITY["wide_deep"].items() if v):
        raise SystemExit(f"a kernel never ran on the CNN path: {cnn_counts}")
    # the sharded path's kernels: K1 at each of its sites, K3, and on the
    # d16 stream K2 or (ok=0) K1
    if not all(all(s.get(k, 0) > 0 for k in SITES_SHARDED)
               and s.get("K2", 0) + s.get("K1 d16 ok=0", 0) > 0
               for s in sharded):
        raise SystemExit(f"a kernel never ran on the sharded path: "
                         f"{sharded}")
    if not all(all(s.get(k, 0) > 0 for k in SITES_DEDUP)
               for s in sharded_dedup):
        raise SystemExit(f"a kernel never ran on the dedup path: "
                         f"{sharded_dedup}")
    kernels.extend(dcn_rows)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
