#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's main path on one card and hold its kernels
against their plain versions.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; builds the kernels from
``wide_deep_tpu_torch/csrc`` itself (into ``build/kernels``).  Phases, one
line each on stdout:

0. the card's name and power limit (nvidia-smi), the kernels' build time;
1. K1 (range scatter-add) at the production d8, d4 and d32-compact shapes,
   K2 (window scatter-add) at the d16 shape, K1 again on that d16 stream as
   the window plan's ok=0 branch runs it, K3 (row write-back) and P2 (bulk
   row scatter) on one [10,000,128, 128] float32 table with sentinel uids,
   P2 again at that shape in bfloat16, P1 (resident gather) at its tool's
   shape (2^20 ids from a [25600, 8] pool): each against its plain PyTorch
   version on the same inputs, with its time from CUDA events beside the
   plain version's, one PyTorch library call's and the bound, and the
   device time of the kernel and of the library call from a torch.profiler
   window of 10 more calls each (the event time less the device time is the
   wrapper's host time); K1 and K2 are each called twice and must give the
   same bits (K2's line gives the sub-window the kernel launches with, which
   must be the one its wrapper assumes);
2. the port's ``Trainer`` on the production config (conf/, batch 25600,
   pack_budget 3): 2 steps through ``train_file`` on a generated TSV, then
   5 steps on seeded synthetic batches; every step, each read on its own,
   must launch K1 once at each of its three sites (d8, d4, d32 compact) and
   K2 and K3 once each, except that a file batch whose d16 plan says ok=0
   launches K1 on the d16 stream in K2's place (its line says so); losses
   and params must stay finite, touched d32 rows must change and an
   untouched one not;
   then (2c, after the launch counts are read) torch.profiler over 3 more
   steps: wall time, the device's busy share, the top kernels by device
   time, and the device time of the port's own kernels in the step, with
   the device's memsets (K1 clears its output with one; the Chrome trace
   goes to build/step_trace.json);
3. the probes' path: ``main`` of the port's two microbenchmark tools,
   in-process on the card as a user runs them (P1's; P2's in float32 and
   with ``bf16``), each of which checks its kernel against the plain
   version and prints both times; the counts are set to 0 before the
   phase and read around each tool, which must launch its kernel and no
   other;
4. one JSON line describing the kernels, then the device line.

Exits non-zero on any failure, and at once when there is no CUDA device.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 25600
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_OPS_PER_S = 67e12          # float32 outside the tensor cores
BF16_TOL = 2.0 ** -7           # one bfloat16 ulp, relative
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


def device_ms(fn, calls=10):
    """Device time of one ``fn()`` by what ran: every kernel, memset and
    copy on the card in a torch.profiler window around ``calls`` calls ->
    {short name: ms per call}."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    parts = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA") and dev_us(e) > 0:
            m = re.search(r"(\w+)[<(]", e.key)
            name = m.group(1) if m else e.key.split(" (")[0]
            parts[name] = parts.get(name, 0.0) + dev_us(e) / 1e3 / calls
    return parts


def bits(t):
    import torch
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def check_scatter(name, fn, plain, library, out_dtype, n_live, d, rows,
                  in_bytes_per_el, extra_bytes, source, replaces,
                  memset=False):
    """Hold one scatter kernel against its plain version, require the same
    bits from two calls, and time it.  ``memset``: the kernel clears its
    output first; the row then also gives the bound with those bytes."""
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
    parts, lib_parts = device_ms(fn), device_ms(library)
    row["device_ms"] = sum(parts.values())
    row["library_device_ms"] = sum(lib_parts.values())
    log(f"phase 1: {name}: max_abs_err {max_err:.3g} ({tol_text}) "
        f"{'ok' if ok else 'FAILED'}; kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}); on the device: kernel "
        f"{row['device_ms']:.4f} ms ("
        + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
        + f"), library {row['library_device_ms']:.4f} ms")
    if not ok:
        raise SystemExit(f"{name} disagrees with its plain version")
    return row


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
    torch.cuda.empty_cache()
    return rows_out


# K1's call sites on the production step, by the gradient width D they pass
# (17: the d16 fold's stream, summed by K1 when its window plan says ok=0)
K1_SITES = {9: "d8", 5: "d4", 32: "d32 compact", 17: "d16 ok=0"}
# launches each production step must add: K1 once at each of its three
# range-plan sites, K3 once, and on the d16 stream either K2 (ok=1) or K1
# (ok=0) once
PER_STEP = {"K1 d8": 1, "K1 d4": 1, "K1 d32 compact": 1, "K3": 1}


def counts():
    from wide_deep_tpu_torch.ops import gather, rowdma, scatter
    out = {"K1": scatter.range_launches, "K2": scatter.window_launches,
           "d16 ok=0": scatter.window_ok0_launches,
           "K3": rowdma.rowdma_launches,
           "P1": gather.resident_gather_launches,
           "P2": rowdma.bulk_scatter_launches}
    for d, n in scatter.range_launches_by_width.items():
        out[f"K1 {K1_SITES.get(d, f'D={d}')}"] = n
    return out


def reset_counts():
    from wide_deep_tpu_torch.ops import gather, rowdma, scatter
    scatter.range_launches = 0
    scatter.range_launches_by_width.clear()
    scatter.window_launches = 0
    scatter.window_ok0_launches = 0
    rowdma.rowdma_launches = 0
    gather.resident_gather_launches = 0
    rowdma.bulk_scatter_launches = 0


def delta(before, after):
    return {k: after[k] - before.get(k, 0) for k in after}


def check_step(what, d):
    """One production step's counter changes ``d``: K1 once at each of its
    three range-plan sites, K3 once, the probes (P1, P2) never, and on the
    d16 stream K2 once, or (ok=0) K1 once at D=17 and K2 never."""
    ok0 = d["d16 ok=0"]
    want = dict(PER_STEP, **{"K1 d16 ok=0": ok0})
    got = {k: d.get(k, 0) for k in want}
    if (got != want or ok0 + d["K2"] != 1 or d["K1"] != 3 + ok0
            or d["P1"] or d["P2"]):
        raise SystemExit(f"{what} launched {d}")


def phase_trainer(card, tmp):
    import numpy as np
    import torch

    from wide_deep_tpu_torch import testing
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.optim import tree_items
    from wide_deep_tpu_torch.training.loop import Trainer

    config = Config(os.path.join(ROOT, "conf"))
    tsv = os.path.join(tmp, "train.tsv")
    testing.generate_ctr_tsv(config, tsv, 2 * BATCH, seed=0,
                             hash_spread=None)
    trainer = Trainer(config, "wide_deep", model_dir=tmp,
                      overrides={"batch_size": BATCH, "pack_budget": 3},
                      device="cuda")
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
    for i, d in enumerate(file_steps):
        check_step(f"file step {i}", d)
    file_counts = counts()
    file_losses = [float(x) for x in trainer.losses]
    log(f"phase 2a: train_file 2 steps in {time.time() - t0:.1f} s, losses "
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
        f"launches per step K1 3 (d8, d4, d32 compact 1 each), K2 1, K3 1; "
        f"peak memory {peak:.2f} GB")
    profile_steps(trainer, rng)
    return main_counts, float(np.median(step_ms))


def profile_steps(trainer, rng, n_steps=3):
    """Where a step's time goes: torch.profiler over ``n_steps`` synthetic
    steps (batches built before the window) -> one line with the wall time
    per step, the device's busy share and the top operators by device
    time.  Runs after the main path's launch counts were read."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from wide_deep_tpu_torch import testing
    batches = [testing.synthetic_batch(trainer.plan, BATCH, rng)
               for _ in range(n_steps)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            trainer.train_batch(b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps

    # the kernels' own entries (device type CUDA), so no time counts twice
    kernels = sorted((e for e in prof.key_averages()
                      if str(e.device_type).endswith("CUDA")),
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
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    prof.export_chrome_trace(os.path.join(ROOT, "build", "step_trace.json"))


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


def count_key(name):
    """A kernels-line row's counter: "K1 range_scatter_add d8" -> "K1 d8",
    "K3 rowdma_scatter_rows d32" -> "K3", "P2 bulk_scatter_rows f32" ->
    "P2"."""
    parts = name.split(" ", 2)
    return f"K1 {parts[2]}" if parts[0] == "K1" else parts[0]


def main():
    import gc

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    from wide_deep_tpu_torch import testing
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.ops import cuda_build
    from wide_deep_tpu_torch.training.loop import build_training_plan

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(card)
    t0 = time.time()
    built = cuda_build.build()
    log(f"phase 0: built {sorted(built) or 'nothing (cached)'} in "
        f"{time.time() - t0:.1f} s")

    device = torch.device("cuda")
    config = Config(os.path.join(ROOT, "conf"))
    train_conf = dict(config.train, batch_size=BATCH, pack_budget=3)
    plan = build_training_plan(config, train_conf, "wide_deep")
    batch = testing.synthetic_batch(plan, BATCH, np.random.default_rng(0))
    kernels = phase_kernels(plan, batch, device)
    del batch

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        main_counts, _ = phase_trainer(card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    tool_counts = phase_tools()

    # K1 (the d16 ok=0 site on file steps), K2 and K3 launch on the train
    # path, P1 and P2 on the tools' path
    paths = dict(main_counts, **tool_counts)
    for row in kernels:
        row["launches"] = paths.get(count_key(row["name"]), 0)
        if "bf16" in row:
            row["bf16"]["launches"] = tool_counts["P2 bf16"]
    if not all(row["launches"] > 0 for row in kernels):
        raise SystemExit(f"a kernel never ran on its path: train "
                         f"{main_counts}, tools {tool_counts}")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
