"""The reference's parser: raw TSV rows -> the packed batch the model
reads.

``FeatureTransformer`` is a frozen copy of the Python transformer of
wide_deep_tpu_torch/features/pipeline.py at commit
5396835d8e2c28384b317c5c7862110fa5df19db, without the kernel plans.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import hashing
from .plan import FeaturePlan

Batch = Dict[str, np.ndarray]


def transform_lines(transformer: "FeatureTransformer", lines: Sequence[str],
                    batch_size: int, mode: str = "train") -> Batch:
    """The batch of ``lines`` (TSV text without newlines); rows with a
    wrong number of cells are skipped, as the loaders skip them."""
    expect = len(transformer.plan.columns)
    rows = [c for c in (ln.split("\t") for ln in lines) if len(c) == expect]
    return transformer.transform(rows, batch_size, mode)


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
        if plan.indicator_total_len:
            out["ind_ids"], out["ind_wts"] = ind_ids, ind_wts
        if plan.continuous_slots:
            out["cont"] = cont
        return out
