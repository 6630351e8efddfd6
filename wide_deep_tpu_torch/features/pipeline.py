"""Host-side data pipeline: TSV CTR logs -> packed fixed-shape numpy batches.

The port's own copy of the JAX package's ``features/pipeline.py``: the
Python transformer, the native C++ loader's paths through ``CsvDataset``
(features/native.py) and the prefetch iterators.  All parsing,
hashing, vocab lookup, bucketization, crossing and combiner weights happen on
the host, so the device sees only dense, statically shaped int32/float32
arrays, plus the per-batch kernel plans (ops/scatter.py) of the big
embedding groups in train mode.

Parsing semantics (reference dataset.py:86-195): schema-ordered TSV, tab
delimiter, first column the click label, ``-`` as the per-type default,
``multivalue`` cells split on ``,`` and truncated to ``max_len``, pos/neg
sample weights, vocab out-of-vocabulary values dropped, identity out-of-range
mapped to bucket 0, a seeded shuffle buffer and round-robin row sharding.
Every batch is padded to ``batch_size`` rows; ``mask`` marks real rows.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from wide_deep_tpu_torch import tracing
from wide_deep_tpu_torch.features import hashing
from wide_deep_tpu_torch.features.plan import FeaturePlan

Batch = Dict[str, np.ndarray]

log = logging.getLogger("wide_deep_tpu_torch")


def list_files(path: str) -> List[str]:
    """File path -> [path]; directory -> its sorted non-hidden files.
    Remote schemes (hdfs:// and registered ones) resolve through
    features/fs.py; local paths stay on os."""
    from wide_deep_tpu_torch.features import fs
    if fs.scheme_of(path) is None and not os.path.exists(path):
        raise FileNotFoundError(f"no data at {path}")
    if fs.isdir(path):
        # one remote call for the file/dir bit of every entry
        return sorted(
            p for p, is_file in fs.listdir_entries(path)
            if not os.path.basename(p).startswith(".") and is_file)
    if fs.isfile(path):
        return [path]
    raise FileNotFoundError(f"no data at {path}")


def train_plans(plan: FeaturePlan, g, batch_size: int, ids: np.ndarray,
                wts: np.ndarray) -> Batch:
    """The kernel plans a train batch carries for dim group ``g``: a range
    plan (``scat_*``), a window plan (``wscat_*``), the dedup exchange's
    unique ids and slots (``dscat_*``) and/or a compact plan for the fused
    sparse optimizer (``sopt_*``), as the plan's gates decide;
    per table shard when the plan has ``scatter_shards > 1`` (the JAX
    package's features/pipeline.py:300-360).  Weights route zero-gradient
    pool padding out of the range and window streams."""
    from wide_deep_tpu_torch.ops import scatter as sc
    out: Batch = {}
    flat_ids, flat_wts = ids.reshape(-1), wts.reshape(-1)
    s = plan.scatter_shards
    if plan.scatter_group(g, batch_size):
        sp = (sc.make_sharded_scatter_plan(flat_ids, g.rows, s, flat_wts)
              if s > 1 else sc.make_scatter_plan(flat_ids, g.rows, flat_wts))
        for key, arr in sp.items():
            out[f"scat_{key}_d{g.dim}"] = arr
    if plan.window_group(g, batch_size):
        wp = (sc.make_sharded_window_plan(flat_ids, g.rows, s, flat_wts)
              if s > 1 else sc.make_window_plan(flat_ids, g.rows, flat_wts))
        for key, arr in wp.items():
            out[f"wscat_{key}_d{g.dim}"] = arr
    if plan.dedup_group(g, batch_size):
        for key, arr in sc.make_dedup_plan(ids, g.rows, s).items():
            out[f"dscat_{key}_d{g.dim}"] = arr
    if plan.sparse_opt_group(g, batch_size):
        cp = (sc.make_sharded_compact_plan(flat_ids, g.rows, s)
              if s > 1 else sc.make_compact_plan(flat_ids, g.rows))
        for key, arr in cp.items():
            out[f"sopt_{key}_d{g.dim}"] = arr
    return out


class FeatureTransformer:
    """Compiles rows of raw TSV strings into a packed Batch.

    Pure-numpy/Python implementation, the port's copy of the JAX package's
    FeatureTransformer (features/native.py is its C++ counterpart).
    """

    def __init__(self, plan: FeaturePlan, n_classes: int = 2,
                 pos_weight: Optional[float] = None,
                 neg_weight: Optional[float] = None):
        self.plan = plan
        self.n_classes = n_classes
        self.pos_weight = pos_weight
        self.neg_weight = neg_weight
        self.weighted = pos_weight is not None and neg_weight is not None
        # per-feature value caches: raw string -> (bucket id | fingerprint)
        self._hash_cache: Dict[str, Dict[str, int]] = {}
        self._fp_cache: Dict[str, int] = {}
        self._vocab_maps = {
            s.name: {v: i for i, v in enumerate(s.vocab)}
            for s in plan.indicator_slots if s.kind == "vocab"}
        # feature name -> schema column index
        self._col = plan.column_index
        self._conf = plan.feature_conf

    # ------------------------------------------------------------ value logic
    def _split(self, cell: str, max_len: int) -> List[str]:
        if cell == "-" or cell == "":
            return [""]
        if self.plan.multivalue and "," in cell:
            vals = cell.split(",")
            return vals[:max_len]
        return [cell]

    def _hash_ids(self, feature: str, values: List[str], size: int) -> List[int]:
        cache = self._hash_cache.setdefault(feature, {})
        out = []
        for v in values:
            h = cache.get(v)
            if h is None:
                h = hashing.fingerprint64_str(v) % size
                if len(cache) < 1_000_000:
                    cache[v] = h
            out.append(h)
        return out

    def _fingerprints(self, values: List[str]) -> List[int]:
        out = []
        for v in values:
            h = self._fp_cache.get(v)
            if h is None:
                h = hashing.fingerprint64_str(v)
                if len(self._fp_cache) < 2_000_000:
                    self._fp_cache[v] = h
            out.append(h)
        return out

    @staticmethod
    def _to_int(cell: str) -> int:
        """Junk-tolerant int parse; non-finite ("1e309") and beyond-int64
        magnitudes map to the 0 default — the C++ loader's to_int clamps
        identically (an unclamped static_cast<int64_t>(inf) is UB), and
        the fuzz parity suite (tests/test_fuzz_native.py) pins them
        together."""
        f = FeatureTransformer._to_float(cell)
        if abs(f) > 2.0 ** 62:  # int64-safe (C++ casts; UB beyond)
            return 0
        return int(f)

    @staticmethod
    def _to_float(cell: str) -> float:
        """Junk-tolerant float parse; inf/nan cells ("1e309", "nan") map
        to the 0.0 default instead of poisoning the batch (an inf
        continuous feature NaNs the loss several steps later with no
        pointer back to the bad row)."""
        if cell in ("-", ""):
            return 0.0
        # pin to the C-locale grammar the C++ loader parses (fuzz-parity
        # contract): >63 chars, Python-only forms (underscores, unicode
        # digits) and non-finite results are all junk -> 0.0 default
        if len(cell) > 63 or "_" in cell or not cell.isascii():
            return 0.0
        try:
            f = float(cell)
        except ValueError:
            return 0.0
        return f if math.isfinite(f) else 0.0

    # -------------------------------------------------------------- transform
    def transform(self, rows: Sequence[Sequence[str]], batch_size: int,
                  mode: str = "train") -> Batch:
        """Pack parsed rows (lists of cells) into a fixed-shape Batch.

        ``len(rows) <= batch_size``; the tail is zero-padded with mask 0.
        """
        plan = self.plan
        B, n = batch_size, len(rows)
        assert n <= B
        has_label = mode != "pred"
        out: Batch = {}
        if has_label:
            out["label"] = np.zeros((B,), np.float32)
            out["weight"] = np.zeros((B,), np.float32)
        out["mask"] = np.zeros((B,), np.float32)
        out["mask"][:n] = 1.0
        Pw = plan.wide_packed_len
        wide_ids = np.zeros((B, Pw), np.int32)
        wide_wts = np.zeros((B, Pw), np.float32)
        Pg = plan.group_packed_len
        g_ids = {g.dim: np.zeros((B, Pg[g.dim]), np.int32) for g in plan.groups}
        g_wts = {g.dim: np.zeros((B, Pg[g.dim]), np.float32) for g in plan.groups}
        g_seg = {g.dim: np.zeros((B, Pg[g.dim]), np.int32) for g in plan.groups}
        ind_ids = np.zeros((B, plan.indicator_total_len), np.int32)
        ind_wts = np.zeros((B, plan.indicator_total_len), np.float32)
        cont = np.zeros((B, len(plan.continuous_slots)), np.float32)

        embed_by_name = plan.embed_slot_by_name
        wide_by_name = plan.wide_slot_by_name

        for b, cells in enumerate(rows):
            # packed-pool cursors: entries appended in slot order; overflow
            # beyond the static pool capacity is dropped (plan.PACK_BUDGET)
            wcur = 0
            gcur = {g.dim: 0 for g in plan.groups}

            budget = plan.pack_budget

            def wide_put_slot(ws, ids_list):
                # per-slot cap = pack_budget for multivalue slots, so pools
                # fit exactly and no slot can starve later slots.  Folded
                # slots have no pool column: their wide weight rides the
                # fused embedding table (plan "wide fold").
                nonlocal wcur
                if ws.folded:
                    return
                cap = 1 if ws.max_len == 1 else budget
                for i in ids_list[:cap]:
                    if wcur >= Pw:
                        break
                    wide_ids[b, wcur] = ws.offset + i
                    wide_wts[b, wcur] = 1.0
                    wcur += 1

            def emb_put(es, local_ids):
                cap_slot = 1 if es.max_len == 1 else budget
                kept = local_ids[:cap_slot]
                k = len(kept)
                if k == 0:
                    return
                w = 1.0 / k
                dim = es.dim
                cap = Pg[dim]
                c = gcur[dim]
                for i in kept:
                    if c >= cap:
                        break
                    g_ids[dim][b, c] = es.row_offset + i
                    g_wts[dim][b, c] = w
                    g_seg[dim][b, c] = es.index
                    c += 1
                gcur[dim] = c
            if has_label:
                if self.n_classes == 2:
                    lab = 1.0 if cells[0] == "1" else 0.0
                else:  # multiclass: integer class id in the label column
                    lab = float(self._to_int(cells[0]))
                out["label"][b] = lab
                if self.weighted:
                    out["weight"][b] = self.pos_weight if lab else self.neg_weight
                else:
                    out["weight"][b] = 1.0
            # cross member raw values, collected as we walk features
            member_vals: Dict[str, List[int]] = {}

            for name in plan.feature_order:
                conf = self._conf[name]
                cell = cells[self._col[name]]
                ftype, tran = conf["type"], conf["transform"]
                if ftype == "continuous":
                    slot = next(s for s in plan.continuous_slots if s.name == name)
                    raw = self._to_float(cell)
                    cont[b, slot.index] = slot.normalize(raw)
                    if slot.boundaries:
                        ws = wide_by_name[name]
                        bucket = int(np.searchsorted(slot.boundaries, raw,
                                                     side="right"))
                        wide_put_slot(ws, [bucket])
                        member_vals[name] = [bucket]
                    continue

                ws = wide_by_name[name]
                values = self._split(cell, ws.max_len)
                if tran == "hash_bucket":
                    ids = self._hash_ids(name, values, ws.size)
                    wide_put_slot(ws, ids)
                    _, es = embed_by_name[name]
                    emb_put(es, ids)
                    member_vals[name] = self._fingerprints(values)
                elif tran == "vocab":
                    # wide contribution rides the indicator block
                    # (models/linear.py dense path) — no pool entry
                    vm = self._vocab_maps[name]
                    ids = [vm[v] for v in values if v in vm]
                    islot = next(s for s in plan.indicator_slots if s.name == name)
                    for j, i in enumerate(ids):
                        ind_ids[b, islot.col_offset + j] = islot.offset + i
                        ind_wts[b, islot.col_offset + j] = 1.0
                    member_vals[name] = self._fingerprints(values)
                else:  # identity (wide via indicator block, like vocab)
                    ids = []
                    for v in values:
                        i = self._to_int(v)
                        ids.append(i if 0 <= i < ws.size else 0)
                    islot = next(s for s in plan.indicator_slots if s.name == name)
                    for j, i in enumerate(ids):
                        ind_ids[b, islot.col_offset + j] = islot.offset + i
                        ind_wts[b, islot.col_offset + j] = 1.0
                    member_vals[name] = ids

            # crosses: chained fingerprints over the cartesian product
            for cs in plan.crosses:
                vals = [member_vals.get(m.name, [0]) or [0] for m in cs.members]
                ws = wide_by_name[cs.name]
                combos: List[int] = [hashing._P5]
                for col in vals:
                    combos = [hashing.combine64(acc, v)
                              for acc in combos for v in col]
                    if len(combos) > cs.max_len:
                        combos = combos[:cs.max_len]
                cids = [acc % cs.bucket_size for acc in combos]
                wide_put_slot(ws, cids)
                es = embed_by_name.get(cs.name)
                if es is not None:
                    _, s = es
                    emb_put(s, cids)

        out["wide_ids"], out["wide_wts"] = wide_ids, wide_wts
        for g in plan.groups:
            out[f"emb_ids_d{g.dim}"] = g_ids[g.dim]
            out[f"emb_wts_d{g.dim}"] = g_wts[g.dim]
            out[f"emb_seg_d{g.dim}"] = g_seg[g.dim]
            if mode == "train":
                out.update(train_plans(plan, g, B, g_ids[g.dim],
                                       g_wts[g.dim]))
        if plan.indicator_total_len:
            out["ind_ids"], out["ind_wts"] = ind_ids, ind_wts
        if plan.continuous_slots:
            out["cont"] = cont
        return out


class CsvDataset:
    """Schema-ordered TSV dataset with shuffle/shard/batch (reference
    dataset.py analog): the JAX package's CsvDataset on local files.

    With the native transformer (``transform_text``) the C++ loader parses
    raw lines: files that fit ``FAST_SLURP_MAX_BYTES`` together take the
    vectorized fast path (``_iter_native_fast``), larger inputs stream line
    by line.  The Python transformer takes pre-split cells."""

    def __init__(self, plan: FeaturePlan, data_path: str, mode: str,
                 batch_size: int, n_classes: int = 2,
                 pos_weight: Optional[float] = None,
                 neg_weight: Optional[float] = None,
                 shuffle_buffer: int = 10000, seed: int = 123,
                 num_shards: int = 1, shard_index: int = 0,
                 transformer=None, drop_remainder: bool = False):
        if mode not in ("train", "eval", "pred"):
            raise ValueError(f"bad mode {mode}")
        self.plan = plan
        self.files = list_files(data_path)
        self.mode = mode
        self.batch_size = batch_size
        self.shuffle_buffer = shuffle_buffer if mode == "train" else 0
        self.seed = seed
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.drop_remainder = drop_remainder
        if transformer is None:
            transformer = default_transformer(plan, n_classes, pos_weight,
                                              neg_weight)
        self.transformer = transformer
        self._native = hasattr(transformer, "transform_text")
        self._n_cols = len(plan.columns)
        self._epoch = 0

    def _raw_lines_indexed(self) -> Iterator[Tuple[int, str]]:
        """(row index, line) of the files' non-empty lines, round-robin
        sharded; the index counts lines across the file list before
        sharding.  Files decode as UTF-8 whatever the locale (features/fs.py
        opens them)."""
        from wide_deep_tpu_torch.features import fs
        idx = 0
        for path in self.files:
            with fs.open_text(path, errors="replace") as f:
                for line in f:
                    line = line.rstrip("\n").rstrip("\r")
                    if not line:
                        continue
                    if idx % self.num_shards == self.shard_index:
                        yield idx, line
                    idx += 1

    def _rows_indexed(self) -> Iterator[Tuple[int, List[str]]]:
        expect = self._n_cols
        has_label = self.mode != "pred"
        for idx, line in self._raw_lines_indexed():
            cells = line.split("\t")
            if has_label:
                if len(cells) != expect:
                    continue  # malformed row, skip (decode_csv errored)
            else:
                # pred data may or may not carry the label column
                if len(cells) == expect - 1:
                    cells = [""] + cells
                elif len(cells) != expect:
                    continue
            yield idx, cells

    # files whose total size fits this are read whole for the vectorized
    # fast path; larger inputs stream line by line
    FAST_SLURP_MAX_BYTES = 2 << 30

    def _fast_path_ok(self) -> bool:
        if not self._native:
            return False
        try:
            total = sum(os.path.getsize(p) for p in self.files)
        except OSError:
            return False  # remote filesystems: stream
        return total <= self.FAST_SLURP_MAX_BYTES

    def _iter_native_fast(self) -> Iterator[Tuple[Batch, np.ndarray]]:
        """Vectorized batch emission for the native parser: the files are
        read as bytes, line boundaries found in one scan (three int arrays,
        no per-line objects), the whole shuffle order drawn up front from
        ``default_rng(seed + epoch)`` as the JAX package draws it, and each
        batch's lines joined for ``transform_text``.

        Two differences from the streaming path, as in the JAX package: the
        order (both are valid shuffles), and invalid UTF-8 reaches the
        byte-oriented C++ parser raw where streaming replaces it with
        U+FFFD."""
        from wide_deep_tpu_torch.features import fs
        blobs: List[bytes] = []
        fids: List[np.ndarray] = []
        sts: List[np.ndarray] = []
        ens: List[np.ndarray] = []
        for path in self.files:
            with fs.open_bytes(path) as f:
                data = f.read()
            if not data:
                continue
            if not data.endswith(b"\n"):
                data += b"\n"
            arr = np.frombuffer(data, np.uint8)
            nl = np.flatnonzero(arr == 10)
            starts = np.empty(nl.size, np.int64)
            starts[0] = 0
            starts[1:] = nl[:-1] + 1
            ends = nl - (arr[np.maximum(nl - 1, 0)] == 13)  # strip \r
            keep = ends > starts
            starts, ends = starts[keep], ends[keep]
            blobs.append(data)
            fids.append(np.full(starts.size, len(blobs) - 1, np.int32))
            sts.append(starts)
            ens.append(ends)
        if not blobs:
            return
        fid = np.concatenate(fids)
        st = np.concatenate(sts)
        en = np.concatenate(ens)
        orig = np.arange(fid.size, dtype=np.int64)
        if self.num_shards > 1:
            fid = fid[self.shard_index::self.num_shards]
            st = st[self.shard_index::self.num_shards]
            en = en[self.shard_index::self.num_shards]
            orig = orig[self.shard_index::self.num_shards]
        n = fid.size
        if self.shuffle_buffer > 1 and n:
            rng = np.random.default_rng(self.seed + self._epoch)
            self._epoch += 1
            S = min(self.shuffle_buffer, n)
            if S >= n:
                order = rng.permutation(n)
            else:
                # the streaming buffer shuffle, its order computed up front:
                # the buffer holds S indices; each draw sends slot j out and
                # refills it with the next incoming index
                order = np.empty(n, np.int64)
                buf = np.arange(S)
                js = rng.integers(0, S, n - S)
                for k in range(n - S):
                    j = js[k]
                    order[k] = buf[j]
                    buf[j] = S + k
                order[n - S:] = buf[rng.permutation(S)]
        else:
            order = np.arange(n)
        B = self.batch_size
        for lo in range(0, n, B):
            idx = order[lo:lo + B]
            if idx.size < B and self.drop_remainder:
                return
            text = b"\n".join(blobs[fid[i]][st[i]:en[i]] for i in idx)
            batch = self.transformer.transform_text(
                text, int(idx.size), B, self.mode)
            orig_idx = np.full(B, -1, np.int64)
            orig_idx[:idx.size] = orig[idx]
            yield batch, orig_idx

    def __iter__(self) -> Iterator[Batch]:
        for batch, _ in self._iter_impl():
            yield batch

    def iter_with_indices(self) -> Iterator[Tuple[Batch, np.ndarray]]:
        """(batch, row indices [batch_size] int64): each row's index among
        the files' non-empty lines before sharding, -1 for the padding rows
        of a partial last batch."""
        yield from self._iter_impl()

    def _iter_impl(self) -> Iterator[Tuple[Batch, np.ndarray]]:
        if self._fast_path_ok():
            yield from self._iter_native_fast()
            return
        pairs = (self._raw_lines_indexed() if self._native
                 else self._rows_indexed())
        if self.shuffle_buffer > 1:
            rng = np.random.default_rng(self.seed + self._epoch)
            self._epoch += 1
            buf: List = []

            def shuffled():
                for r in pairs:
                    buf.append(r)
                    if len(buf) >= self.shuffle_buffer:
                        j = rng.integers(len(buf))
                        buf[j], buf[-1] = buf[-1], buf[j]
                        yield buf.pop()
                for j in rng.permutation(len(buf)):
                    yield buf[j]
            source = shuffled()
        else:
            source = pairs
        chunk: List = []
        idxs: List[int] = []
        for idx, r in source:
            chunk.append(r)
            idxs.append(idx)
            if len(chunk) == self.batch_size:
                yield self._emit(chunk), self._pad_idxs(idxs)
                chunk, idxs = [], []
        if chunk and not self.drop_remainder:
            yield self._emit(chunk), self._pad_idxs(idxs)

    def _pad_idxs(self, idxs: List[int]) -> np.ndarray:
        out = np.full(self.batch_size, -1, np.int64)
        out[:len(idxs)] = idxs
        return out

    def _emit(self, chunk: List) -> Batch:
        if self._native:
            text = "\n".join(chunk).encode("utf-8", errors="replace")
            return self.transformer.transform_text(
                text, len(chunk), self.batch_size, self.mode)
        return self.transformer.transform(chunk, self.batch_size, self.mode)


def default_transformer(plan: FeaturePlan, n_classes: int = 2,
                        pos_weight: Optional[float] = None,
                        neg_weight: Optional[float] = None,
                        num_parallel_calls: Optional[int] = None):
    """The native C++ transformer (``num_parallel_calls``, train.yaml's,
    sets its thread count).  Only where no C++ compiler is found does the
    Python transformer stand in, with a warning; a failed compile or load
    raises."""
    from wide_deep_tpu_torch.features import native
    if native.find_compiler() is None:
        log.warning("no C++ compiler found (%s): the native loader "
                    "cannot be built from %s; using the Python loader",
                    native.compiler_names(), native.SOURCE)
        return FeatureTransformer(plan, n_classes, pos_weight, neg_weight)
    return native.NativeTransformer(plan, n_classes, pos_weight, neg_weight,
                                    n_threads=num_parallel_calls or 0)


class PrefetchIterator:
    """Background-thread prefetch over a batch iterable (the tf.data
    ``prefetch`` analog): host-side parsing/packing overlaps the device
    step instead of serializing with it.  The consumer's wait for the
    queue is the span ``input.wait.<stage>`` (tracing.py)."""

    def __init__(self, iterable, depth: int = 2, stage: str = "parsed"):
        import queue
        import threading
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._wait_span = f"input.wait.{stage}"
        self._done = object()
        self._error: Optional[BaseException] = None

        def worker():
            try:
                for item in iterable:
                    self._queue.put(item)
            except BaseException as e:  # noqa: BLE001 — re-raised in consumer
                self._error = e
            finally:
                self._queue.put(self._done)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        with tracing.span(self._wait_span):
            item = self._queue.get()
        if item is self._done:
            # re-arm the sentinel so further next() calls keep raising
            # StopIteration instead of blocking on the drained queue
            self._queue.put(self._done)
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item


class DevicePrefetchIterator(PrefetchIterator):
    """Host-to-device copies in a background thread, up to ``depth``
    batches ahead of the consumer (the JAX package's
    DevicePrefetchIterator): over a ``PrefetchIterator`` of parsed batches,
    parse, copy and step overlap, and the sustained rate is that of the
    slowest stage instead of their sum.  An exception in either thread is
    raised in the consumer."""

    def __init__(self, iterable, to_device, depth: int = 2):
        super().__init__((to_device(b) for b in iterable), depth=depth,
                         stage="device")
