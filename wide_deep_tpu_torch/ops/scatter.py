"""Scatter-add plans and the two hand-written scatter kernels (K1, K2).

Host side (numpy, the port's own copies of wide_deep_tpu/ops/scatter.py's
plan builders, bit-identical to them — tests/test_torch_scatter.py): a flat
id stream is sorted once on the host and cut into tiles, so the device never
sorts.  Device side:

* **K1** ``range_scatter_add`` replaces the Pallas range kernel
  (wide_deep_tpu/ops/scatter.py::range_scatter_add): the sum over a range
  plan's sorted stream, as a segmented sum over chunks of RANGE_CHUNK
  positions, one warp each, whose edge runs are finished by carry levels
  that sum the cut runs' partials the same way (``range_carry_levels``).
  CUDA source: csrc/range_scatter.cu.
* **K2** ``window_scatter_add`` replaces the Pallas window kernel
  (wide_deep_tpu/ops/scatter.py::window_scatter_add): the same sum over
  fixed write-only windows of MAXR rows, one block per sub-window of
  ``window_sub_rows`` rows.  CUDA source: csrc/window_scatter.cu.

Both are bound by bytes on the card (the id stream, the permutation and the
gradient rows read once, the dense [rows, D] output written once); the notes
in the CUDA sources say what each design does about it.

Beside each kernel sits its plain PyTorch version (``index_add_`` into
float32 zeros, then one cast).  A wrapper takes the plain version only for
tensors on the CPU; on a CUDA tensor it launches its kernel or raises.  Each
launch adds one to the module's counter (``range_launches``,
``window_launches``; K1 also to ``range_launches_by_shape``, keyed by its
output's (rows, D), which tells its call sites apart in every
configuration; ``range_launches_by_width()`` sums it by D, which tells the
production step's sites apart; ``range_carry_launches`` counts K1's carry
levels).  A window plan whose
ok flag is 0 (a window over its cap) is summed by K1 over the plan's sorted
stream: ``window_ok0_launches`` counts those launches apart, and they count
as K1's too.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from wide_deep_tpu_torch.ops import cuda_build

T_IDS = 1024     # max live ids per tile; the plan ABI shared with the JAX
                 # package and its C++ loader
MAXR = 2048      # row-range cap per range tile; rows per window
ALIGN_IDS = 128  # tile stream starts are multiples of this
ALIGN_ROWS = 256 # range-tile row_los are multiples of this

PALLAS_SCATTER_MIN_IDS = 1 << 17   # range plans for streams at least this
                                   # long (plan gating shared with the JAX
                                   # package's FeaturePlan)
PALLAS_WINDOW_MIN_IDS = 1 << 16    # window plans likewise
COMPACT_FRAC = 0.875               # live-cap fraction (see live_cap)
RANGE_CHUNK = 32                   # K1's stream positions per warp
WINDOW_SLAB_BYTES = 32 * 1024      # K2's shared-memory slab per block
WINDOW_MIN_SUB_ROWS = 16           # K2's narrowest sub-window

range_launches = 0         # K1 kernel launches
range_carry_launches = 0   # K1's carry-level launches (range_carry_levels)
range_launches_by_shape: Dict[Tuple[int, int], int] = {}  # by (rows, D)
window_launches = 0        # K2 kernel launches
window_ok0_launches = 0    # K1 launches of apply_window_plan's ok=0 branch


# ---------------------------------------------------------------- host plans
def _rows_pad(rows: int, maxr: int = MAXR) -> int:
    """Output rows padded so every ALIGN_ROWS-aligned slab fits."""
    aligned = ((rows + ALIGN_ROWS - 1) // ALIGN_ROWS) * ALIGN_ROWS
    return max(aligned, maxr)


def n_tiles_for(n_ids: int, rows: int, t_ids: int = T_IDS,
                maxr: int = MAXR) -> int:
    """Static upper bound on range tiles for ``n_ids`` sorted ids over a
    table of ``rows`` (raw) rows."""
    rows = _rows_pad(rows, maxr)
    return int(np.ceil(n_ids / t_ids)
               + np.ceil(rows / max(maxr - ALIGN_ROWS, 1)) + 1)


def build_scatter_tiles(ids_sorted: np.ndarray, rows: int,
                        t_ids: int = T_IDS, maxr: int = MAXR
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray]:
    """Host tiling of a sorted id stream -> (starts, offs, counts, row_los),
    each [n_tiles_for(...)] int32 padded with empty tiles.  Tile t's live
    ids are ``ids_sorted[starts+offs : starts+offs+counts]``; consecutive
    tiles partition the stream, each <= t_ids ids spanning < maxr rows."""
    n = int(ids_sorted.shape[0])
    n_tiles = n_tiles_for(n, rows, t_ids, maxr)
    starts = np.zeros(n_tiles, np.int32)
    offs = np.zeros(n_tiles, np.int32)
    counts = np.zeros(n_tiles, np.int32)
    row_los = np.zeros(n_tiles, np.int32)
    rows_pad = _rows_pad(rows, maxr)
    max_lo = rows_pad - maxr
    t = 0
    i = 0
    while i < n:
        lo = (int(ids_sorted[i]) // ALIGN_ROWS) * ALIGN_ROWS
        lo = min(lo, max_lo)
        j_cap = min(i + t_ids, n)
        j = int(np.searchsorted(ids_sorted[i:j_cap], lo + maxr,
                                side="left")) + i
        assert j > i, (i, int(ids_sorted[i]), lo, rows)  # id out of range
        starts[t] = (i // ALIGN_IDS) * ALIGN_IDS
        offs[t] = i - starts[t]
        counts[t] = j - i
        row_los[t] = lo
        t += 1
        i = j
    assert t <= n_tiles, (t, n_tiles)
    return starts, offs, counts, row_los


def live_cap(n_ids: int) -> int:
    """ALIGN_IDS-aligned COMPACT_FRAC of the stream (the JAX package's
    static live-id cap; kept for plan parity)."""
    cap = int(np.ceil(n_ids * COMPACT_FRAC / ALIGN_IDS)) * ALIGN_IDS
    return min(n_ids, cap)


def scatter_batch_spec(n_ids: int, rows: int):
    """Shapes/dtypes of the per-batch range-plan arrays."""
    nt = n_tiles_for(n_ids, rows)
    return {"ids": ((n_ids,), np.int32),
            "perm": ((n_ids,), np.int32),
            "tiles": ((4, nt), np.int32),
            "live": ((1,), np.int32)}


def make_scatter_plan(ids_flat: np.ndarray, rows: int,
                      weights_flat: Optional[np.ndarray] = None):
    """Flat (unsorted) ids -> {ids, perm, tiles, live} range-plan arrays.

    ``perm`` maps sorted position -> flat position (stable sort).  Entries
    of weight 0 are pool padding with exactly zero gradient: they get an
    out-of-range sentinel, sort to the tail and stay out of every tile;
    ``live`` counts the rest."""
    n = int(ids_flat.shape[0])
    sentinel = _rows_pad(rows)
    if weights_flat is not None:
        ids_flat = np.where(weights_flat != 0, ids_flat,
                            sentinel).astype(np.int32)
    order = np.argsort(ids_flat, kind="stable").astype(np.int32)
    ids_sorted = ids_flat[order].astype(np.int32)
    live = int(np.searchsorted(ids_sorted, sentinel, side="left"))
    nt = n_tiles_for(n, rows)
    starts, offs, counts, row_los = build_scatter_tiles(
        ids_sorted[:live], rows)
    tiles = np.zeros((4, nt), np.int32)
    for i, arr in enumerate((starts, offs, counts, row_los)):
        tiles[i, :arr.shape[0]] = arr
    return {"ids": ids_sorted, "perm": order, "tiles": tiles,
            "live": np.array([live], np.int32)}


def window_cap(n_ids: int, rows: int) -> int:
    """Static per-window id cap: 4x the mean ids-per-window,
    ALIGN_IDS-aligned, clamped to [ALIGN_IDS, T_IDS]."""
    n_tiles = max((rows + MAXR - 1) // MAXR, 1)
    mean = n_ids / n_tiles
    cap = int(np.ceil(4.0 * mean / ALIGN_IDS)) * ALIGN_IDS
    return max(ALIGN_IDS, min(cap, T_IDS))


def window_rows_pad(rows: int) -> int:
    return max((rows + MAXR - 1) // MAXR, 1) * MAXR


def window_batch_spec(n_ids: int, rows: int):
    """Shapes/dtypes of the per-batch window-plan arrays."""
    nt = window_rows_pad(rows) // MAXR
    return {"ids": ((n_ids,), np.int32),
            "perm": ((n_ids,), np.int32),
            "tiles": ((3, nt), np.int32),   # starts, offs, counts
            "ok": ((1,), np.int32)}


def make_window_plan(ids_flat: np.ndarray, rows: int,
                     weights_flat: Optional[np.ndarray] = None):
    """Flat ids -> {ids, perm, tiles, ok} window-plan arrays.  ok=0 when a
    window holds more ids than window_cap (the consumer then takes the plain
    sum).  Weight-0 padding is remapped past the last window."""
    n = int(ids_flat.shape[0])
    spec = window_batch_spec(n, rows)
    out = {k: np.zeros(shape, dt) for k, (shape, dt) in spec.items()}
    if weights_flat is not None:
        sentinel = window_rows_pad(rows)
        ids_flat = np.where(weights_flat != 0, ids_flat,
                            sentinel).astype(np.int32)
    order = np.argsort(ids_flat, kind="stable").astype(np.int32)
    ids_sorted = ids_flat[order].astype(np.int32)
    out["ids"], out["perm"] = ids_sorted, order
    nt = spec["tiles"][0][1]
    cap = window_cap(n, rows)
    bounds = np.searchsorted(
        ids_sorted, np.arange(nt + 1, dtype=np.int64) * MAXR, side="left")
    counts = np.diff(bounds)
    if counts.max(initial=0) > cap:
        return out  # ok stays 0
    starts = (bounds[:-1] // ALIGN_IDS) * ALIGN_IDS
    out["tiles"][0] = starts
    out["tiles"][1] = bounds[:-1] - starts
    out["tiles"][2] = counts
    out["ok"][0] = 1
    return out


def compact_plan_spec(n_ids: int):
    """Shapes/dtypes of a compact (dedup) plan for an [n_ids] stream."""
    nt = n_tiles_for(n_ids, n_ids)
    return {"uids": ((n_ids,), np.int32),
            "ids": ((n_ids,), np.int32),
            "perm": ((n_ids,), np.int32),
            "tiles": ((4, nt), np.int32)}


def make_compact_plan(ids_flat: np.ndarray, rows: int):
    """Flat ids -> {uids, ids, perm, tiles}: ``ids`` is the sorted stream's
    compact rank (0,0,1,2,2,...), ``uids[r]`` the table row of rank r,
    padded with distinct ascending sentinels >= rows."""
    n = int(ids_flat.shape[0])
    spec = compact_plan_spec(n)
    order = np.argsort(ids_flat, kind="stable").astype(np.int32)
    ids_sorted = ids_flat[order].astype(np.int32)
    first = np.empty(n, bool)
    first[0] = True
    np.not_equal(ids_sorted[1:], ids_sorted[:-1], out=first[1:])
    compact = (np.cumsum(first) - 1).astype(np.int32)
    u = int(compact[-1]) + 1
    uids = (rows + np.arange(n, dtype=np.int64)).astype(np.int32)
    uids[:u] = ids_sorted[first]
    starts, offs, counts, row_los = build_scatter_tiles(compact, n)
    nt = spec["tiles"][0][1]
    tiles = np.zeros((4, nt), np.int32)
    k = starts.shape[0]
    assert k <= nt, (k, nt)
    tiles[0, :k], tiles[1, :k] = starts, offs
    tiles[2, :k], tiles[3, :k] = counts, row_los
    return {"uids": uids, "ids": compact, "perm": order, "tiles": tiles}


# ------------------------------------------------- per-table-shard plans
# The port's copies of wide_deep_tpu/ops/scatter.py:617-688 (compact) and
# :783-951 (range, window), bit-identical to them (tests/
# test_torch_exchange.py) and to what cpp/fastdata.cc emits for a plan with
# scatter_shards > 1 (tests/test_torch_parallel.py).
# Each rank of a sharded run takes the row of its own table shard
# (parallel/exchange.py, optim/sparse.apply_fused_sharded_update).
SHARD_SLACK = 2  # integer so the C++ emitter computes the identical cap
SHARD_LIVE_NUM = 5
SHARD_LIVE_DEN = 4


def shard_cap(n_ids: int, n_shards: int) -> int:
    """Static per-shard stream length: SHARD_SLACK x the even split,
    ALIGN_IDS-aligned, never above n_ids.  MUST match cpp/fastdata.cc
    shard_cap (parity test enforces)."""
    cap = (n_ids * SHARD_SLACK + n_shards - 1) // n_shards
    cap = ((cap + ALIGN_IDS - 1) // ALIGN_IDS) * ALIGN_IDS
    return min(cap, n_ids)


def shard_live_cap(n_ids: int, n_shards: int) -> int:
    """Static compacted per-shard stream length: 1.25x the even split,
    ALIGN_IDS-aligned, never above shard_cap."""
    cap = ((n_ids * SHARD_LIVE_NUM + n_shards * SHARD_LIVE_DEN - 1)
           // (n_shards * SHARD_LIVE_DEN))
    cap = ((cap + ALIGN_IDS - 1) // ALIGN_IDS) * ALIGN_IDS
    return min(cap, shard_cap(n_ids, n_shards))


def sharded_scatter_batch_spec(n_ids: int, rows: int, n_shards: int):
    """Shapes/dtypes of the per-batch sharded scatter-plan arrays."""
    cap = shard_cap(n_ids, n_shards)
    nt = n_tiles_for(cap, rows // n_shards)
    return {"ids": ((n_shards, cap), np.int32),
            "perm": ((n_shards, cap), np.int32),
            "tiles": ((n_shards, 4, nt), np.int32),
            "ok": ((n_shards,), np.int32),
            "live": ((n_shards,), np.int32)}


def make_sharded_scatter_plan(ids_flat: np.ndarray, rows: int,
                              n_shards: int,
                              weights_flat: Optional[np.ndarray] = None):
    """Host: flat id vector -> per-shard {ids, perm, tiles, ok} np arrays.

    ``ids[s]`` holds shard s's ids LOCALIZED to its row range (id -
    s*shard_rows), sorted ascending, zero-padded past its live count;
    ``perm[s]`` maps sorted position -> position in the GLOBAL flat stream
    (so each device gathers its grad rows from the all-gathered cotangent);
    ``tiles[s]`` is the build_scatter_tiles output padded with empty tiles;
    ``ok[s]`` is 0 when the shard's id count overflowed the static cap
    (the consumer then sums that shard exactly without the plan).

    ``weights_flat``: entries with weight 0 are packed-pool PADDING whose
    gradients are exactly zero — remapped to an out-of-range sentinel so
    they land in NO shard.  Without the remap every padding entry (id 0)
    counts against SHARD 0's cap: at production padding occupancies
    (~15-22%) and 8 shards, shard 0's count (~n*(1/8 + padding)) exceeds
    the 2x-even-split cap every batch, permanently demoting the row-shard
    that holds the hottest rows to the XLA fallback.

    ``live[s]`` is shard s's id count — the consumer's per-shard live-cap
    compaction conds on it (shard_live_cap above)."""
    n = int(ids_flat.shape[0])
    if rows % n_shards:
        raise ValueError(f"rows {rows} % n_shards {n_shards} != 0")
    shard_rows = rows // n_shards
    spec = sharded_scatter_batch_spec(n, rows, n_shards)
    cap = spec["ids"][0][1]
    nt = spec["tiles"][0][2]
    out = {k: np.zeros(shape, dt) for k, (shape, dt) in spec.items()}
    if weights_flat is not None:
        ids_flat = np.where(weights_flat != 0, ids_flat,
                            rows).astype(np.int32)
    order = np.argsort(ids_flat, kind="stable").astype(np.int32)
    ids_sorted = ids_flat[order].astype(np.int32)
    bounds = np.searchsorted(
        ids_sorted, np.arange(n_shards + 1, dtype=np.int64) * shard_rows,
        side="left")
    for s in range(n_shards):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        cnt = hi - lo
        out["live"][s] = cnt
        if cnt > cap:
            continue  # ok stays 0: the consumer sums shard s without the plan
        out["ok"][s] = 1
        if cnt == 0:
            continue  # valid empty plan (all tiles empty)
        local = ids_sorted[lo:hi] - s * shard_rows
        out["ids"][s, :cnt] = local
        out["perm"][s, :cnt] = order[lo:hi]
        starts, offs, counts, row_los = build_scatter_tiles(
            local, shard_rows)
        k = starts.shape[0]
        assert k <= nt, (k, nt)
        out["tiles"][s, 0, :k] = starts
        out["tiles"][s, 1, :k] = offs
        out["tiles"][s, 2, :k] = counts
        out["tiles"][s, 3, :k] = row_los
    return out


def sharded_window_batch_spec(n_ids: int, rows: int, n_shards: int):
    """Shapes/dtypes of per-shard WINDOW-mode plan arrays.  Same layout as
    the sharded range plan but tiles are [3, n_windows] (starts, offs,
    counts — window t covers the FIXED local rows [t*MAXR, (t+1)*MAXR)),
    which is how consumers (parallel/exchange.py) tell the modes apart."""
    cap = shard_cap(n_ids, n_shards)
    nt = window_rows_pad(rows // n_shards) // MAXR
    return {"ids": ((n_shards, cap), np.int32),
            "perm": ((n_shards, cap), np.int32),
            "tiles": ((n_shards, 3, nt), np.int32),
            "ok": ((n_shards,), np.int32),
            "live": ((n_shards,), np.int32)}


def make_sharded_window_plan(ids_flat: np.ndarray, rows: int, n_shards: int,
                             weights_flat: Optional[np.ndarray] = None):
    """Host: flat id vector -> per-shard window-mode {ids, perm, tiles, ok}.

    The sparse-stream analog of make_sharded_scatter_plan (the d16 case on
    a mesh: too few ids for range mode, enough to beat the XLA serial
    scatter with write-only fixed windows).  ``ok[s]`` is 0 when shard s's
    stream overflowed the cap OR one of its windows overflowed the static
    window_cap(cap, shard_rows); weight-0 padding is remapped out of every
    shard (zero gradients, see make_sharded_scatter_plan); ``live[s]`` is
    shard s's id count (the consumer's live-cap compaction)."""
    n = int(ids_flat.shape[0])
    if rows % n_shards:
        raise ValueError(f"rows {rows} % n_shards {n_shards} != 0")
    shard_rows = rows // n_shards
    spec = sharded_window_batch_spec(n, rows, n_shards)
    cap = spec["ids"][0][1]
    nt = spec["tiles"][0][2]
    wcap = window_cap(cap, shard_rows)
    out = {k: np.zeros(shape, dt) for k, (shape, dt) in spec.items()}
    if weights_flat is not None:
        ids_flat = np.where(weights_flat != 0, ids_flat,
                            rows).astype(np.int32)
    order = np.argsort(ids_flat, kind="stable").astype(np.int32)
    ids_sorted = ids_flat[order].astype(np.int32)
    shard_bounds = np.searchsorted(
        ids_sorted, np.arange(n_shards + 1, dtype=np.int64) * shard_rows,
        side="left")
    for s in range(n_shards):
        lo, hi = int(shard_bounds[s]), int(shard_bounds[s + 1])
        cnt = hi - lo
        out["live"][s] = cnt
        if cnt > cap:
            continue  # ok stays 0: the consumer sums shard s without the plan
        local = ids_sorted[lo:hi] - s * shard_rows
        bounds = np.searchsorted(
            local, np.arange(nt + 1, dtype=np.int64) * MAXR, side="left")
        counts = np.diff(bounds)
        if counts.max(initial=0) > wcap:
            continue  # hot window: ok stays 0
        out["ok"][s] = 1
        if cnt == 0:
            continue  # valid empty plan (all windows empty)
        out["ids"][s, :cnt] = local
        out["perm"][s, :cnt] = order[lo:hi]
        starts = (bounds[:-1] // ALIGN_IDS) * ALIGN_IDS
        out["tiles"][s, 0] = starts
        out["tiles"][s, 1] = bounds[:-1] - starts
        out["tiles"][s, 2] = counts
    return out


def sharded_compact_plan_spec(n_ids: int, n_shards: int):
    """Shapes/dtypes of PER-TABLE-SHARD compact plans (the multi-device
    fused-optimizer path, optim/sparse.apply_fused_sharded_update): same
    row-shard layout discipline as the sharded scatter plans."""
    cap = shard_cap(n_ids, n_shards)
    nt = n_tiles_for(cap, cap)
    return {"uids": ((n_shards, cap), np.int32),
            "ids": ((n_shards, cap), np.int32),
            "perm": ((n_shards, cap), np.int32),
            "tiles": ((n_shards, 4, nt), np.int32),
            "ok": ((n_shards,), np.int32),
            "live": ((n_shards,), np.int32)}


def make_sharded_compact_plan(ids_flat: np.ndarray, rows: int,
                              n_shards: int):
    """Host: flat id vector -> per-shard compact (dedup) plans.

    Shard s gets make_compact_plan of ITS slice of the globally-sorted
    stream, with ``uids`` LOCALIZED to the shard's row range and ``perm``
    mapping into the GLOBAL flat stream (each device gathers its grad rows
    from the all-gathered cotangent).  ``ok[s]`` is 0 when the shard's
    stream overflows the static cap (consumer falls back to the serial
    per-row update for that shard); ``live[s]`` is the shard's entry count
    (live-cap compaction, shard_live_cap).  Global-batch hosts only
    (single-process meshes or the input service), like the other sharded
    plans."""
    n = int(ids_flat.shape[0])
    if rows % n_shards:
        raise ValueError(f"rows {rows} % n_shards {n_shards} != 0")
    shard_rows = rows // n_shards
    spec = sharded_compact_plan_spec(n, n_shards)
    cap = spec["ids"][0][1]
    nt = spec["tiles"][0][2]
    out = {k: np.zeros(shape, dt) for k, (shape, dt) in spec.items()}
    # sentinel-pad every shard's uids with distinct ascending values >=
    # shard_rows (consumers gather clipped + scatter with drop semantics)
    out["uids"][:] = (shard_rows
                      + np.arange(cap, dtype=np.int64)[None, :]).astype(
                          np.int32)
    order = np.argsort(ids_flat, kind="stable").astype(np.int32)
    ids_sorted = ids_flat[order].astype(np.int32)
    bounds = np.searchsorted(
        ids_sorted, np.arange(n_shards + 1, dtype=np.int64) * shard_rows,
        side="left")
    for s in range(n_shards):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        cnt = hi - lo
        out["live"][s] = cnt
        if cnt > cap:
            continue  # ok stays 0
        out["ok"][s] = 1
        if cnt == 0:
            continue  # valid empty plan
        local = ids_sorted[lo:hi] - s * shard_rows
        first = np.empty(cnt, bool)
        first[0] = True
        np.not_equal(local[1:], local[:-1], out=first[1:])
        compact = (np.cumsum(first) - 1).astype(np.int32)
        u = int(compact[-1]) + 1
        out["uids"][s, :u] = local[first]
        out["ids"][s, :cnt] = compact
        out["perm"][s, :cnt] = order[lo:hi]
        starts, offs, counts, row_los = build_scatter_tiles(compact, cap)
        k = starts.shape[0]
        assert k <= nt, (k, nt)
        out["tiles"][s, 0, :k], out["tiles"][s, 1, :k] = starts, offs
        out["tiles"][s, 2, :k], out["tiles"][s, 3, :k] = counts, row_los
    return out


# ------------------------------------------------------------- dedup plans
# Host side of the dedup exchange (parallel/exchange.DedupGather, train.yaml
# sharded_lookup: dedup; the JAX package's ops/scatter.py:686-782): per table
# shard, the UNIQUE ids the whole batch needs (localized, sentinel-padded to
# a static cap), plus a per-entry flat slot (shard*cap + position) mapping
# each batch entry to its row in the all-gathered unique-row block.  The
# exchange then moves O(unique x D) row payload instead of the explicit
# exchange's O(B x P x D): the win grows with id duplication (hot keys).
DEDUP_SLACK = 1.5  # cap = slack x the expected unique count per shard


def dedup_cap(n_ids: int, rows: int, n_shards: int) -> int:
    """Static per-shard unique-id cap: DEDUP_SLACK x the expected unique
    count of n_ids uniform draws over rows (hashed ids; real skew only
    LOWERS the unique count), ALIGN_IDS-aligned, clamped by the always-safe
    bounds (shard_rows, n_ids).  The same float arithmetic, in the same
    order, as the JAX package's, so the caps agree bit for bit."""
    shard_rows = rows // n_shards
    lam = n_ids / float(rows)
    e_unique = rows * (1.0 - np.exp(-lam))
    cap = int(np.ceil(DEDUP_SLACK * e_unique / n_shards / ALIGN_IDS)
              ) * ALIGN_IDS
    safe = ((shard_rows + ALIGN_IDS - 1) // ALIGN_IDS) * ALIGN_IDS
    return max(ALIGN_IDS, min(cap, safe, n_ids))


def dedup_batch_spec(n_ids: int, rows: int, n_shards: int,
                     batch_shape) -> dict:
    """Shapes/dtypes of the per-batch dedup-plan arrays."""
    cap = dedup_cap(n_ids, rows, n_shards)
    return {"uids": ((n_shards, cap), np.int32),
            "slots": (tuple(batch_shape), np.int32)}


def make_dedup_plan(ids: np.ndarray, rows: int, n_shards: int):
    """Host: [B, P] id matrix -> {uids [S, cap], slots [B, P]} np arrays.

    ``uids[s]`` holds shard s's unique ids LOCALIZED to its row range,
    sorted, padded with the sentinel ``shard_rows`` (out of local range:
    gathers mask it, scatters drop it); ``slots[b, p]`` = s*cap + j where
    entry (b, p)'s id is ``uids[s, j]``.  Raises when a shard's unique
    count exceeds the static cap (use sharded_lookup: explicit for such
    data) or an id lies outside [0, rows)."""
    flat = ids.reshape(-1)
    n = int(flat.shape[0])
    if rows % n_shards:
        raise ValueError(f"rows {rows} % n_shards {n_shards} != 0")
    shard_rows = rows // n_shards
    cap = dedup_cap(n, rows, n_shards)
    uniq, inverse = np.unique(flat, return_inverse=True)
    if len(uniq) and (uniq[0] < 0 or uniq[-1] >= rows):
        # an out-of-range id would fall outside every shard's bounds and
        # leave its slot unassigned: fail as the C++ emitter does
        raise ValueError(
            f"dedup plan: ids out of range [0, {rows}): "
            f"min={int(uniq[0])}, max={int(uniq[-1])} — miswired feature "
            f"or wrong table rows")
    bounds = np.searchsorted(
        uniq, np.arange(n_shards + 1, dtype=np.int64) * shard_rows,
        side="left")
    counts = np.diff(bounds)
    if counts.max(initial=0) > cap:
        raise ValueError(
            f"dedup exchange: a table shard needs {int(counts.max())} "
            f"unique ids > static cap {cap} (n_ids={n}, rows={rows}, "
            f"shards={n_shards}); unusually spread ids — raise "
            f"DEDUP_SLACK or use sharded_lookup: explicit")
    uids = np.full((n_shards, cap), shard_rows, np.int32)
    pos = np.empty(len(uniq), np.int64)
    for s in range(n_shards):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        uids[s, :hi - lo] = uniq[lo:hi] - s * shard_rows
        pos[lo:hi] = s * cap + np.arange(hi - lo)
    slots = pos[inverse].reshape(ids.shape).astype(np.int32)
    return {"uids": uids, "slots": slots}


# ---------------------------------------------------------- device wrappers
_FLOATS = (torch.float32, torch.bfloat16)


def _check_stream(ids_sorted, perm, g_flat, rows, out_dtype):
    dev = g_flat.device
    for name, t in (("ids_sorted", ids_sorted), ("perm", perm)):
        if t.dtype != torch.int32 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 on {dev}")
    if (g_flat.dim() != 2 or g_flat.dtype not in _FLOATS
            or not g_flat.is_contiguous()):
        raise ValueError("g_flat must be a contiguous [N, D] float32 or "
                         "bfloat16 tensor")
    # the stream may be shorter than g: a shard's stream picks its rows of
    # the all-gathered gradient by perm (parallel/exchange.py)
    if ids_sorted.dim() != 1 or perm.shape != ids_sorted.shape:
        raise ValueError("ids_sorted and perm must be one [n] stream")
    if out_dtype not in _FLOATS:
        raise ValueError("out_dtype must be float32 or bfloat16")
    if rows < 0:
        raise ValueError("rows must be >= 0")


def _check_tiles(tiles, n_tile_rows, dev):
    if (tiles.dtype != torch.int32 or tiles.device != dev
            or not tiles.is_contiguous()):
        raise ValueError(f"tiles must be contiguous int32 on {dev}")
    if tiles.dim() != 2 or tiles.shape[0] != n_tile_rows:
        raise ValueError(f"tiles must be [{n_tile_rows}, n_tiles]")


def range_scatter_add_plain(ids_sorted, perm, g_flat, rows, out_dtype=None):
    """K1's plain version: ``zeros[rows, D].at[ids_sorted].add(g_flat[perm])``
    by ``index_add_`` into float32 zeros, one cast to ``out_dtype``
    (default: g's dtype); ids outside [0, rows) (plan sentinels) drop."""
    keep = (ids_sorted >= 0) & (ids_sorted < rows)
    out = torch.zeros((rows, g_flat.shape[1]), dtype=torch.float32,
                      device=g_flat.device)
    out.index_add_(0, ids_sorted[keep].long(),
                   g_flat[perm[keep].long()].float())
    return out.to(out_dtype or g_flat.dtype)


window_scatter_add_plain = range_scatter_add_plain  # K2: the same function


def _range_pass_chunks(n: int):
    """The chunks of K1's passes over ``n`` stream positions: the chunk
    pass's (RANGE_CHUNK positions each), then each carry level's, over the
    2 slots a chunk of the pass before, while that had more than one."""
    c = -(-n // RANGE_CHUNK)
    out = [c] if c else []
    while c > 1:
        c = -(-2 * c // RANGE_CHUNK)
        out.append(c)
    return out


def range_carry_levels(n: int) -> int:
    """K1's carry levels (``range_carry_kernel`` launches) for ``n`` stream
    positions (``kernel_range_carry_levels`` is the kernel's own)."""
    return max(len(_range_pass_chunks(n)) - 1, 0)


def range_scratch_floats(n: int, d: int) -> int:
    """float32 elements of K1's scratch for ``n`` stream positions of width
    ``d``: per chunk of every pass, two keys and two partial rows
    (``kernel_range_scratch_floats`` is the kernel's own)."""
    return sum(_range_pass_chunks(n)) * (2 + 2 * d)


def _lib_range():
    lib = cuda_build.library("range_scatter")
    fn = lib.wdt_range_scatter_add
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, p, i, p, ctypes.c_int64, p]
        fn.restype = ctypes.c_int
    return fn


def kernel_range_scratch_floats(n: int, d: int) -> int:
    """The scratch csrc/range_scatter.cu needs (``range_scratch_floats``
    must agree with it); builds the kernel library."""
    fn = cuda_build.library("range_scatter").wdt_range_scratch_floats
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int64
    return fn(n, d)


def kernel_range_carry_levels(n: int) -> int:
    """The carry levels csrc/range_scatter.cu launches (``range_carry_levels``
    must agree with it); builds the kernel library."""
    fn = cuda_build.library("range_scatter").wdt_range_carry_levels
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(n)


def _lib_window():
    lib = cuda_build.library("window_scatter")
    fn = lib.wdt_window_scatter_add
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, p, i, i, i, p, i, p]
        fn.restype = ctypes.c_int
    return fn


def kernel_window_sub_rows(d: int, out_dtype: torch.dtype) -> int:
    """The sub-window rows csrc/window_scatter.cu launches K2 with for rows
    of ``d`` ``out_dtype`` elements (0: it refuses them); builds the kernel
    library.  ``window_sub_rows`` must agree with it."""
    fn = cuda_build.library("window_scatter").wdt_window_sub_rows
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(d, torch.finfo(out_dtype).bits // 8)


def _require_cuda(t: torch.Tensor, what: str):
    if t.device.type != "cuda":
        raise ValueError(f"{what}: tensors must be on the CPU (plain "
                         f"version) or on a CUDA device, got {t.device}")


def range_scatter_add(ids_sorted: torch.Tensor, perm: torch.Tensor,
                      g_flat: torch.Tensor, tiles: torch.Tensor, rows: int,
                      out_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """K1: ``zeros[rows, D].at[ids_sorted].add(g_flat[perm])`` under a range
    plan (``tiles`` int32 [4, nt]: starts, offs, counts, row_los) -> a new
    [rows, D] tensor in ``out_dtype`` (default: g's dtype), summed in
    float32, each row rounded once.  CPU tensors take the plain version;
    CUDA tensors launch csrc/range_scatter.cu on the current stream, which
    needs only the sorted stream (the tiles are checked, not read) and
    gives the same bits on every call."""
    _check_tiles(tiles, 4, g_flat.device)
    return sorted_stream_sum(ids_sorted, perm, g_flat, rows,
                             out_dtype or g_flat.dtype)


def sorted_stream_sum(ids_sorted: torch.Tensor, perm: torch.Tensor,
                      g_flat: torch.Tensor, rows: int,
                      out_dtype: torch.dtype) -> torch.Tensor:
    """K1 without a plan's tiles: the same sum over any sorted stream whose
    ids outside [0, rows) drop (a range plan's or a window plan's
    sentinels).  CPU tensors take the plain version; CUDA tensors launch
    csrc/range_scatter.cu, counted in ``range_launches`` and by width, its
    carry levels in ``range_carry_launches``."""
    global range_launches, range_carry_launches
    _check_stream(ids_sorted, perm, g_flat, rows, out_dtype)
    if g_flat.device.type == "cpu":
        return range_scatter_add_plain(ids_sorted, perm, g_flat, rows,
                                       out_dtype)
    _require_cuda(g_flat, "range_scatter_add")
    fn = _lib_range()
    n, d = ids_sorted.shape[0], g_flat.shape[1]
    dev = g_flat.device
    out = torch.empty((rows, d), dtype=out_dtype, device=dev)
    scratch = torch.empty(range_scratch_floats(n, d), dtype=torch.float32,
                          device=dev)
    err = fn(ids_sorted.data_ptr(), perm.data_ptr(), g_flat.data_ptr(),
             int(g_flat.dtype == torch.bfloat16), n, rows, d, out.data_ptr(),
             int(out_dtype == torch.bfloat16), scratch.data_ptr(),
             scratch.numel(), cuda_build.stream_handle(dev))
    cuda_build.check(err, "range_scatter_add")
    range_launches += 1
    if rows and d:
        range_carry_launches += range_carry_levels(n)
    range_launches_by_shape[rows, d] = (
        range_launches_by_shape.get((rows, d), 0) + 1)
    return out


def range_launches_by_width() -> Dict[int, int]:
    """K1's launches by the gradient's width D."""
    out: Dict[int, int] = {}
    for (_, d), n in range_launches_by_shape.items():
        out[d] = out.get(d, 0) + n
    return out


def window_sub_rows(d: int, out_dtype: torch.dtype) -> int:
    """K2's sub-window: the largest power of two <= MAXR rows whose slab of
    [rows, d] ``out_dtype`` elements fits WINDOW_SLAB_BYTES: the host's
    copy of the kernel's choice (``kernel_window_sub_rows``), so that the
    wrapper refuses on any device what the kernel would.  Raises ValueError
    for rows wider than a slab of WINDOW_MIN_SUB_ROWS rows holds."""
    row_bytes = d * (torch.finfo(out_dtype).bits // 8)
    sub = MAXR
    while sub > WINDOW_MIN_SUB_ROWS and sub * row_bytes > WINDOW_SLAB_BYTES:
        sub //= 2
    if sub * row_bytes > WINDOW_SLAB_BYTES:
        raise ValueError(
            f"window_scatter_add takes rows of at most "
            f"{WINDOW_SLAB_BYTES // WINDOW_MIN_SUB_ROWS} bytes; D={d} in "
            f"{out_dtype} is {row_bytes}")
    return sub


def window_scatter_add(ids_sorted: torch.Tensor, perm: torch.Tensor,
                       g_flat: torch.Tensor, tiles: torch.Tensor, rows: int,
                       wcap: int, out_dtype: Optional[torch.dtype] = None
                       ) -> torch.Tensor:
    """K2: the same sum under a window plan whose ok flag is 1 (``tiles``
    int32 [3, nt]: starts, offs, counts of window t = rows [t*MAXR,
    (t+1)*MAXR), each holding <= ``wcap`` ids).  CPU tensors take the plain
    version; CUDA tensors launch csrc/window_scatter.cu, which writes every
    output element once.  Raises ValueError, on any device, for rows wider
    than the kernel takes (``window_sub_rows``)."""
    global window_launches
    out_dtype = out_dtype or g_flat.dtype
    _check_stream(ids_sorted, perm, g_flat, rows, out_dtype)
    _check_tiles(tiles, 3, g_flat.device)
    if tiles.shape[1] * MAXR < rows:
        raise ValueError(f"{tiles.shape[1]} windows cannot cover {rows} rows")
    if not 0 < wcap <= T_IDS:
        raise ValueError(f"wcap must be in (0, {T_IDS}], got {wcap}")
    window_sub_rows(g_flat.shape[1], out_dtype)
    if g_flat.device.type == "cpu":
        return window_scatter_add_plain(ids_sorted, perm, g_flat, rows,
                                        out_dtype)
    _require_cuda(g_flat, "window_scatter_add")
    fn = _lib_window()
    d = g_flat.shape[1]
    dev = g_flat.device
    out = torch.empty((rows, d), dtype=out_dtype, device=dev)
    err = fn(ids_sorted.data_ptr(), perm.data_ptr(), g_flat.data_ptr(),
             int(g_flat.dtype == torch.bfloat16), tiles.data_ptr(),
             tiles.shape[1], rows, d, out.data_ptr(),
             int(out_dtype == torch.bfloat16), cuda_build.stream_handle(dev))
    cuda_build.check(err, "window_scatter_add")
    window_launches += 1
    return out


def apply_scatter_plan(plan: Dict[str, torch.Tensor], g_flat: torch.Tensor,
                       rows: int, out_dtype=None) -> torch.Tensor:
    """Scatter-add ``g_flat`` [N, D] by a range plan -> [rows, D].  The
    tiles cover only the live (non-padding) ids, so the kernel never reads
    the padded tail of the stream."""
    return range_scatter_add(plan["ids"], plan["perm"], g_flat,
                             plan["tiles"], rows, out_dtype)


def apply_window_plan(plan: Dict[str, torch.Tensor], g_flat: torch.Tensor,
                      rows: int, out_dtype=None) -> torch.Tensor:
    """Scatter-add by a window plan.  ok=1 runs K2; ok=0 (a window over its
    static cap) runs K1 over the plan's sorted stream (``sorted_stream_sum``,
    counted in ``window_ok0_launches`` too): a float32 sum rounded once, the
    same bits on every call.  The JAX package's ok=0 branch accumulates in
    ``out_dtype`` instead, so in bfloat16 the two differ by its roundings
    (a difference on purpose, ROADMAP.md Queue 3).  ``ok`` is read on the
    host: the port's batches keep it on the CPU."""
    global window_ok0_launches
    out_dtype = out_dtype or g_flat.dtype
    n = g_flat.shape[0]
    if int(plan["ok"][0]) > 0:
        return window_scatter_add(plan["ids"], plan["perm"], g_flat,
                                  plan["tiles"], rows, window_cap(n, rows),
                                  out_dtype)
    out = sorted_stream_sum(plan["ids"], plan["perm"], g_flat, rows,
                            out_dtype)
    if g_flat.device.type == "cuda":
        window_ok0_launches += 1
    return out
