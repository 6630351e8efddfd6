"""FeaturePlan: the compiled, static feature layout for wide_deep_tpu_torch.

The port's own copy of ``wide_deep_tpu/features/plan.py`` (kept in step with
it; tests/test_torch_scatter.py pins the two to identical layouts and plan
arrays).  It replaces the reference's runtime ``tf.feature_column`` graph
(reference build_estimator.py:49-169) with an ahead-of-time compiled plan.
The *output* of the feature transform goes to the device, not the transform
itself, so everything here is static metadata that
the host pipeline (features/pipeline.py) and the model (models/) share:

* **Wide space** — every wide id source (hash/cross/bucketized-continuous)
  gets a disjoint ``[offset, offset+size)`` range in one unified id space of
  ``wide_dim`` rows.  A batch carries one densely packed
  ``wide_ids``/``wide_wts`` pool of shape ``[B, wide_packed_len]``; the wide
  arm is a single gather + weighted sum regardless of how many wide columns
  the config declares.  (Vocab/identity wide weights ride the indicator
  block instead — models/linear.py.)
* **Wide fold** — a hash feature / deep cross uses the *same* bucket ids for
  its wide weight and its embedding row, so when both arms exist the wide
  weight is stored as trailing column(s) of the fused embedding table and the
  slot vanishes from the wide pool entirely: one gather serves both arms
  (models/deep.py fused path; the extra columns stay under the 'linear'
  param partition so FTRL semantics are preserved).  On the production
  config this removes ~95% of the wide pool's id traffic — the dominant
  device cost (ARCHITECTURE.md).  Groups with more than ``fold_max_rows``
  rows stay unfolded (the per-step table||wide concat scales with rows).
* **Dim groups** — deep embedding consumers (hash features and deep crosses)
  are grouped by embedding dimension; each group's tables are concatenated
  row-wise into one ``[rows, dim]`` table so a whole group is one gather
  from a densely packed ``[B, packed_len]`` id pool with a parallel segment
  column; per-feature mean-combining is a per-row one-hot matmul in the
  model.  Device gather/scatter cost is linear in pool width, so pools are
  sized for realistic occupancy (pack_budget), not worst case.
* **Indicator block** — vocab/identity features one-hot into a dense block of
  ``indicator_dim`` columns via offset ids (multi-hot with counts, matching
  ``indicator_column`` semantics).
* **Continuous block** — normalized scalars (min_max/standard/log/raw).

Embedding sizes use the reference's empirical rule
``dim(n) = int(2 ** ceil(ln(n ** 0.25)))`` (build_estimator.py:57-59).
Deep input layout order: dim groups ascending by dim (features in config
order), then indicators, then continuous — fixed and documented so exports
stay stable.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from wide_deep_tpu_torch.config import Config

CROSS_MAX_LEN = 16  # static cap on cartesian-product size of a cross
ROW_ALIGN = 256     # table row counts padded to this multiple so row-sharded
                    # tables divide evenly over up to 256 devices
PACK_BUDGET = 3     # packed-pool capacity contributed by each multivalue
                    # slot (singles contribute 1); see packed_len below
FOLD_MAX_ROWS = 4 * 1024 * 1024  # wide-fold eligibility: dim groups with more
                    # rows than this keep their wide ids in the wide pool (the
                    # per-step concat of table+wide column scales with rows,
                    # the saved id traffic with batch; ~4M rows is breakeven
                    # at batch 25600, measured on the TPU package)
SHARD_THRESHOLD = 1 << 16  # min table elements for a row-sharded table
                    # (multi-device plans; kept so the plan's gating
                    # matches the JAX package's, which owns the value)


def _align_rows(n: int) -> int:
    return ((n + ROW_ALIGN - 1) // ROW_ALIGN) * ROW_ALIGN


def embedding_dim(n_buckets: int) -> int:
    """Empirical embedding size, same rule as the reference."""
    return int(2 ** math.ceil(math.log(n_buckets ** 0.25)))


def fold_default(config: Config) -> bool:
    """Whether the wide fold is on for this config (model.yaml ``wide_fold``,
    default on).  The FM term (linear_fm_factors) reads factor rows by wide
    id, which requires every wide slot in the pool — FM disables the fold."""
    model_conf = config.model
    if int(model_conf.get("linear_fm_factors") or 0) > 0:
        return False
    v = model_conf.get("wide_fold")
    return True if v is None else bool(v)


def fold_enabled(config: Config, model_type: str) -> bool:
    """Fold requires both arms: a wide-only model has no embedding tables to
    carry the wide columns, and a deep-only model has no wide arm at all."""
    return model_type == "wide_deep" and fold_default(config)


@dataclasses.dataclass(frozen=True)
class WideSlot:
    name: str
    kind: str          # hash | vocab | identity | bucketized | cross
    size: int          # rows this slot owns in the wide space
    offset: int        # first row in the unified wide space (-1 when folded)
    max_len: int       # static per-example id capacity
    col_offset: int    # first column in the packed [B, Lw] id tensor (-1 folded)
    folded: bool = False  # wide weight lives as extra column(s) of the slot's
                          # fused embedding table (no wide-pool entry, no rows
                          # in the wide table) — see "wide fold" in the module
                          # docstring


@dataclasses.dataclass(frozen=True)
class EmbedSlot:
    name: str
    kind: str          # hash | cross
    vocab_size: int
    dim: int
    max_len: int
    row_offset: int    # row offset inside the dim group's fused table
    col_offset: int    # first column in the group's [B, Lg] id tensor
    index: int         # position of this feature inside the group (0..Fg-1)


@dataclasses.dataclass(frozen=True)
class DimGroup:
    dim: int
    rows: int          # fused table rows (sum of member vocab sizes)
    total_len: int     # Lg: packed id-tensor width
    slots: Tuple[EmbedSlot, ...]
    folded: bool = False  # wide weights for this group's slots ride the fused
                          # table as trailing column(s)


@dataclasses.dataclass(frozen=True)
class IndicatorSlot:
    name: str
    kind: str          # vocab | identity
    size: int
    offset: int        # first column in the indicator block
    max_len: int
    col_offset: int    # first column in the packed [B, Li] id tensor
    vocab: Optional[Tuple[str, ...]] = None


@dataclasses.dataclass(frozen=True)
class ContinuousSlot:
    name: str
    transform: Optional[str]   # min_max | standard | log | None
    a: float                   # min or mean (0 when unused)
    b: float                   # max or std  (1 when unused)
    index: int                 # column in the continuous block
    boundaries: Tuple[float, ...] = ()

    def normalize(self, x):
        if self.transform == "min_max":
            return (x - self.a) / (self.b - self.a)
        if self.transform == "standard":
            return (x - self.a) / self.b
        if self.transform == "log":
            return np.log(np.maximum(x, 1e-12))
        if self.transform == "log1p":
            # a count's log(x + 1), negatives taken as 0 (Criteo's dense
            # features, as MLPerf's DLRM preprocesses them)
            return np.log1p(np.maximum(x, 0.0))
        return x


@dataclasses.dataclass(frozen=True)
class CrossMember:
    name: str
    kind: str                   # string | identity | bucketized
    identity_size: int = 0
    boundaries: Tuple[float, ...] = ()


@dataclasses.dataclass(frozen=True)
class CrossSpec:
    name: str
    members: Tuple[CrossMember, ...]
    bucket_size: int
    is_deep: bool
    max_len: int


class FeaturePlan:
    """Everything static about the feature layout, compiled from Config."""

    def __init__(self, config: Config, multivalue: Optional[bool] = None,
                 pack_budget: Optional[int] = None,
                 fold: Optional[bool] = None,
                 fold_max_rows: Optional[int] = None,
                 pallas_scatter: bool = False,
                 scatter_shards: int = 1,
                 shard_threshold: Optional[int] = None,
                 sparse_opt: bool = False,
                 shard_kind: str = "scatter"):
        self.config = config
        train = config.train
        self.multivalue = train["multivalue"] if multivalue is None else multivalue
        if pack_budget is not None:
            self.pack_budget = int(pack_budget)
        else:
            raw_budget = train.get("pack_budget")
            # "auto" is resolved by callers that can see the data
            # (features/analyze.resolve_pack_budget); a bare FeaturePlan
            # falls back to the default
            self.pack_budget = (int(raw_budget)
                                if isinstance(raw_budget, int) and raw_budget
                                else PACK_BUDGET)
        if fold is None:
            fold = fold_default(config)
        self.fold = bool(fold)
        if fold_max_rows is None:
            fold_max_rows = config.model.get("wide_fold_max_rows")
        # explicit 0 means "fold no tables"; only unset falls back
        self.fold_max_rows = int(FOLD_MAX_ROWS if fold_max_rows is None
                                 else fold_max_rows)
        # pallas_scatter (the name of train.yaml's scatter_mode: pallas):
        # batches additionally carry a host-built scatter plan (sorted ids +
        # permutation + range/window tiles) per big dim group so the
        # backward runs the hand-written scatter kernels of ops/scatter.py.
        # scatter_shards > 1: the plans are emitted PER TABLE SHARD (one
        # localized stream per rank, ops/scatter.make_sharded_*_plan) for
        # the exchange's backward and the sharded fused optimizer
        # (parallel/exchange.py, optim/sparse.py); only groups whose tables
        # row-shard (parallel/mesh.param_shardings' rule) carry them.
        self.pallas_scatter = bool(pallas_scatter)
        self.scatter_shards = int(scatter_shards)
        self.shard_threshold = int(SHARD_THRESHOLD if shard_threshold is None
                                   else shard_threshold)
        # shard_kind (scatter_shards > 1): 'scatter' emits per-shard kernel
        # plans for planned_sharded_gather; 'dedup' emits unique-id + slot
        # plans for the dedup exchange (dedup_sharded_gather)
        if shard_kind not in ("scatter", "dedup"):
            raise ValueError(f"shard_kind must be scatter|dedup, "
                             f"got {shard_kind!r}")
        self.shard_kind = shard_kind
        # sparse_opt: batches additionally carry a compact (dedup) scatter
        # plan per huge dim group (ops/scatter.make_compact_plan) so the
        # train step applies the fused touched-rows optimizer
        # (optim/sparse.apply_fused_update) without ever materializing a
        # dense [rows, D] gradient.  Set by the Trainer from train.yaml
        # ``sparse_optimizer``; gated here on the dnn optimizer having a
        # sparse row formula (optim.sparse.SPARSE_CAPABLE) because the flag
        # also fixes the sparse tables' PARAM LAYOUT (see sparse_opt_group)
        # — an incapable optimizer must see plain [rows, dim] tables.
        # The fused tables' rule is model.yaml's dnn_embedding_optimizer
        # where set, else dnn_optimizer (optim.sparse.table_spec).
        self.sparse_slots = 0
        self.sparse_spec: Optional[Dict[str, Any]] = None
        if sparse_opt:
            from wide_deep_tpu_torch.optim.sparse import (SPARSE_CAPABLE,
                                                          _n_slots,
                                                          table_spec)
            spec = table_spec(config.model)
            sparse_opt = spec["name"] in SPARSE_CAPABLE
            if sparse_opt:
                self.sparse_slots = _n_slots(spec)
                self.sparse_spec = spec
        self.sparse_opt = bool(sparse_opt)
        schema = config.schema_columns()
        self.columns = schema
        self.label = schema[0]
        self.column_index = {name: i for i, name in enumerate(schema)}
        feature_conf = config.read_feature_conf()
        cross_conf = config.read_cross_feature_conf()
        # preserve config order, restricted to schema order for determinism
        self.feature_order = [c for c in feature_conf]
        self.feature_conf = feature_conf

        wide_raw: List[Tuple[str, str, int, int]] = []  # name,kind,size,L
        embed_raw: List[Tuple[str, str, int, int, int]] = []  # name,kind,rows,dim,L
        indicator_slots: List[IndicatorSlot] = []
        continuous_slots: List[ContinuousSlot] = []
        ind_off = ind_col = 0

        def eff_len(ml: int) -> int:
            return ml if self.multivalue else 1

        for name in self.feature_order:
            conf = feature_conf[name]
            ftype, tran, param = conf["type"], conf["transform"], conf["parameter"]
            L = eff_len(conf.get("max_len", 1))
            if ftype == "category":
                if tran == "hash_bucket":
                    size = int(param)
                    wide_raw.append((name, "hash", size, L))
                    # per-feature embedding_dim override, else the empirical
                    # rule (build_estimator.py:57-59)
                    dim = conf.get("embedding_dim") or embedding_dim(size)
                    embed_raw.append((name, "hash", size, dim, L))
                elif tran == "vocab":
                    vocab = tuple(str(v) for v in param)
                    size = len(vocab)
                    wide_raw.append((name, "vocab", size, L))
                    indicator_slots.append(IndicatorSlot(
                        name, "vocab", size, ind_off, L, ind_col, vocab))
                    ind_off += size; ind_col += L
                else:  # identity
                    size = int(param)
                    wide_raw.append((name, "identity", size, L))
                    indicator_slots.append(IndicatorSlot(
                        name, "identity", size, ind_off, L, ind_col))
                    ind_off += size; ind_col += L
            else:  # continuous
                param = param or {}
                norm = param.get("normalization") or (0.0, 1.0)
                bounds = tuple(float(b) for b in (param.get("boundaries") or ()))
                continuous_slots.append(ContinuousSlot(
                    name, tran, float(norm[0]), float(norm[1]),
                    len(continuous_slots), bounds))
                if bounds:
                    wide_raw.append((name, "bucketized", len(bounds) + 1, 1))

        # crosses
        crosses: List[CrossSpec] = []
        deep_cross_names = set()
        for members, bucket_size, is_deep in cross_conf:
            cms: List[CrossMember] = []
            prod_len = 1
            for m in members:
                fc = feature_conf[m]
                if fc["type"] == "continuous":
                    cms.append(CrossMember(
                        m, "bucketized",
                        boundaries=tuple(float(b) for b in fc["parameter"]["boundaries"])))
                elif fc["transform"] == "identity":
                    cms.append(CrossMember(m, "identity", identity_size=int(fc["parameter"])))
                else:
                    cms.append(CrossMember(m, "string"))
                prod_len *= eff_len(fc.get("max_len", 1))
            cname = "&".join(members)
            L = min(prod_len, CROSS_MAX_LEN)
            crosses.append(CrossSpec(cname, tuple(cms), bucket_size, is_deep, L))
            wide_raw.append((cname, "cross", bucket_size, L))
            if is_deep:
                deep_cross_names.add(cname)
                embed_raw.append((cname, "cross", bucket_size,
                                  embedding_dim(bucket_size), L))

        # dim groups: ascending dim, members in declaration order.  A group
        # folds (carries its members' wide weights as trailing table columns)
        # when small enough that the per-step table+wide concat costs less
        # than the wide-pool id traffic it removes.
        groups: List[DimGroup] = []
        slot_dim: Dict[str, int] = {}
        for dim in sorted({d for _, _, _, d, _ in embed_raw}):
            slots: List[EmbedSlot] = []
            row = col = 0
            for name, kind, rows, d, L in embed_raw:
                if d != dim:
                    continue
                slots.append(EmbedSlot(name, kind, rows, d, L, row, col, len(slots)))
                slot_dim[name] = d
                row += rows; col += L
            aligned = _align_rows(row)
            groups.append(DimGroup(dim, aligned, col, tuple(slots),
                                   folded=self.fold
                                   and aligned <= self.fold_max_rows))
        folded_dims = frozenset(g.dim for g in groups if g.folded)

        # wide slots: hash features and deep crosses whose dim group folds
        # get no wide-pool column and no rows in the wide table — their wide
        # weight is column dim.. of the fused embedding table instead
        # (models/deep.py fused gather; FTRL still owns it via the 'linear'
        # param partition).  Everything else packs as before.
        wide_slots: List[WideSlot] = []
        wide_off = wide_col = 0
        for name, kind, size, L in wide_raw:
            is_foldable = (kind == "hash"
                           or (kind == "cross" and name in deep_cross_names))
            if is_foldable and slot_dim.get(name) in folded_dims:
                wide_slots.append(WideSlot(name, kind, size, -1, L, -1,
                                           folded=True))
                continue
            wide_slots.append(WideSlot(name, kind, size, wide_off, L, wide_col))
            wide_off += size; wide_col += L

        def packed_capacity(slots) -> int:
            """Shared per-row id-pool capacity: 1 per single-valued slot,
            PACK_BUDGET per multivalue slot, or its max_len where that is
            less (no more ids fit its cells) (gather/scatter cost is linear
            in this, so the pool is sized for realistic occupancy rather
            than worst case; overflow entries are dropped deterministically
            in slot order).  Vocab/identity wide slots don't use the pool:
            their wide contribution rides the indicator block as a dense
            matmul against a 379-row static gather (models/linear.py)."""
            return sum(min(s.max_len, self.pack_budget)
                       for s in slots
                       if s.kind not in ("vocab", "identity")
                       and not getattr(s, "folded", False))

        self.wide_slots = wide_slots
        self.folded_dims = folded_dims
        self.folded_names = frozenset(
            s.name for s in wide_slots if s.folded)
        self.wide_dim = _align_rows(wide_off)
        self.wide_total_len = wide_col
        self.wide_packed_len = packed_capacity(wide_slots)
        self.group_packed_len = {g.dim: packed_capacity(g.slots)
                                 for g in groups}
        self.groups = groups
        self.indicator_slots = indicator_slots
        self.indicator_dim = ind_off
        self.indicator_total_len = ind_col
        self.continuous_slots = continuous_slots
        self.crosses = crosses
        self.deep_embed_dim = sum(len(g.slots) * g.dim for g in groups)
        self.deep_input_dim = (self.deep_embed_dim + self.indicator_dim
                               + len(continuous_slots))
        # embedding features pooled by their sum (feature.yaml
        # ``combiner: sum``); the others take the mean
        self.sum_pooled = frozenset(
            name for name, conf in feature_conf.items()
            if conf.get("combiner") == "sum")
        self.wide_slot_by_name = {s.name: s for s in wide_slots}
        self.embed_slot_by_name = {
            s.name: (g, s) for g in groups for s in g.slots}
        # indicator column -> wide-table row (for the dense vocab/identity
        # wide path): indicator offsets and wide offsets differ, so the wide
        # arm gathers these rows with a static index vector
        ind_rows = np.zeros(max(self.indicator_dim, 1), dtype=np.int32)
        for isl in indicator_slots:
            ws = self.wide_slot_by_name[isl.name]
            ind_rows[isl.offset:isl.offset + isl.size] = (
                ws.offset + np.arange(isl.size, dtype=np.int32))
        self.indicator_wide_rows = ind_rows

    def scatter_group(self, g: "DimGroup", batch_size: int) -> bool:
        """Whether this dim group's train batches carry a Pallas scatter
        plan (ops/scatter.py).  Profitable when the id stream is large (the
        kernel's cost is ~per-tile, XLA's is ~45 ns/id) and dense enough
        that range slabs aren't mostly empty; tiny streams into huge tables
        (production d32: 25.6k ids / 10M rows) stay on XLA.

        With scatter_shards > 1 the plan is per-shard and only tables that
        will actually row-shard on the mesh qualify (replicated tables keep
        the GSPMD scatter — a pallas_call can't be auto-partitioned)."""
        from wide_deep_tpu_torch.ops.scatter import PALLAS_SCATTER_MIN_IDS
        n_ids = batch_size * self.group_packed_len[g.dim]
        if not (self.pallas_scatter
                and n_ids >= PALLAS_SCATTER_MIN_IDS
                and n_ids * 16 >= g.rows):
            return False
        # sparse-optimizer groups stop-gradient their table (the compact
        # '_sparse_rows' sink carries the cotangent, models/deep.py), so
        # a range plan for them would be built and shipped every batch
        # but never consumed
        if self.sparse_opt_group(g, batch_size):
            return False
        if self.scatter_shards > 1:
            return (self.shard_kind == "scatter"
                    and g.rows % self.scatter_shards == 0
                    and g.rows * g.dim
                    >= self.shard_threshold * self.scatter_shards)
        return True

    def dedup_group(self, g: "DimGroup", batch_size: int) -> bool:
        """Whether this dim group's train batches carry a dedup-exchange
        plan (ops/scatter.make_dedup_plan for
        parallel/exchange.dedup_sharded_gather): mesh-sharded tables under
        ``sharded_lookup: dedup``."""
        return (self.shard_kind == "dedup"
                and self.scatter_shards > 1
                and g.rows % self.scatter_shards == 0
                and g.rows * g.dim
                >= self.shard_threshold * self.scatter_shards)

    def window_group(self, g: "DimGroup", batch_size: int) -> bool:
        """Whether this dim group's train batches carry a window-mode
        Pallas plan (ops/scatter.py window-scatter): sparse-but-large id
        streams (the d16 case) where the range kernel's RMW slabs lose but
        write-only fixed windows win; mutually exclusive with range mode.

        With scatter_shards > 1 the plan is PER TABLE SHARD
        (make_sharded_window_plan, [S, 3, n_windows] tiles) and only
        row-sharding tables under the explicit exchange qualify — same
        gating as scatter_group's sharded branch."""
        from wide_deep_tpu_torch.ops.scatter import PALLAS_WINDOW_MIN_IDS
        if not self.pallas_scatter or self.scatter_group(g, batch_size):
            return False
        n_ids = batch_size * self.group_packed_len[g.dim]
        if n_ids < PALLAS_WINDOW_MIN_IDS:
            return False
        if self.sparse_opt_group(g, batch_size):
            return False  # stop-gradded table: the plan would never run
        if self.scatter_shards > 1:
            return (self.shard_kind == "scatter"
                    and g.rows % self.scatter_shards == 0
                    and g.rows * g.dim
                    >= self.shard_threshold * self.scatter_shards)
        return True

    def sparse_opt_group(self, g: "DimGroup", batch_size: int = 0) -> bool:
        """Whether this dim group carries the fused touched-rows optimizer
        (optim/sparse.apply_fused_update): huge tables, unfolded (a folded
        table's wide column belongs to the linear optimizer); divisible
        row counts on multi-device plans.

        DELIBERATELY batch-size independent (``batch_size`` kept for API
        compat): the decision also fixes the PARAM LAYOUT — sparse tables
        store param + optimizer slots fused in one f32 [rows, 128] matrix
        (ops/rowdma.py) — so init (B=1), train, eval and pred must all
        agree.  optim.sparse.plan_sparse_tables derives its table set from
        this predicate; the two cannot drift.  The row's width is the
        table's own (``fused_width``): [rows, 128] where the rule's live
        columns fit 128, whole float4s past the live columns under
        RowwiseAdagrad, which alone may pass 128.

        On multi-device plans (scatter_shards > 1) the batch carries
        PER-TABLE-SHARD compact plans (make_sharded_compact_plan) and the
        step updates each row shard inside shard_map
        (optim.sparse.apply_fused_sharded_update)."""
        if not self.sparse_opt or (self.fold and g.folded):
            return False
        if self.scatter_shards > 1 and g.rows % self.scatter_shards:
            return False
        from wide_deep_tpu_torch.optim import sparse as sparse_lib
        return (g.rows >= sparse_lib.SPARSE_MIN_ROWS
                and sparse_lib.fused_width(self.sparse_spec, g.dim)
                is not None)

    def fused_width(self, g: "DimGroup") -> int:
        """float32 columns of group ``g``'s fused table (a group that
        ``sparse_opt_group`` admits)."""
        from wide_deep_tpu_torch.optim import sparse as sparse_lib
        return sparse_lib.fused_width(self.sparse_spec, g.dim)

    def _plan_specs(self, g: "DimGroup", n_ids: int, batch_size: int):
        """(batch key prefix, spec) of each kernel plan a train batch
        carries for group ``g``: range (``scat``), window (``wscat``),
        compact (``sopt``); per table shard when ``scatter_shards > 1``;
        the dedup exchange's unique ids and slots (``dscat``)."""
        from wide_deep_tpu_torch.ops import scatter as sc
        s = self.scatter_shards
        out = []
        if self.scatter_group(g, batch_size):
            out.append(("scat", sc.sharded_scatter_batch_spec(n_ids, g.rows, s)
                        if s > 1 else sc.scatter_batch_spec(n_ids, g.rows)))
        if self.window_group(g, batch_size):
            out.append(("wscat", sc.sharded_window_batch_spec(n_ids, g.rows, s)
                        if s > 1 else sc.window_batch_spec(n_ids, g.rows)))
        if self.dedup_group(g, batch_size):
            out.append(("dscat", sc.dedup_batch_spec(
                n_ids, g.rows, s, (batch_size, n_ids // batch_size))))
        if self.sparse_opt_group(g, batch_size):
            out.append(("sopt", sc.sharded_compact_plan_spec(n_ids, s)
                        if s > 1 else sc.compact_plan_spec(n_ids)))
        return out

    # ------------------------------------------------------------- descriptors
    def batch_spec(self, batch_size: int, n_classes: int = 2,
                   with_image: bool = False,
                   image_shape: Tuple[int, int, int] = (224, 224, 3),
                   mode: str = "train") -> Dict[str, Tuple[Tuple[int, ...], Any]]:
        """Shape/dtype contract of a packed batch (see pipeline.Batch)."""
        spec: Dict[str, Tuple[Tuple[int, ...], Any]] = {}
        B = batch_size
        if mode != "pred":
            # label is float32 uniformly (class id for multiclass); heads cast
            spec["label"] = ((B,), np.float32)
            spec["weight"] = ((B,), np.float32)
        spec["mask"] = ((B,), np.float32)
        spec["wide_ids"] = ((B, self.wide_packed_len), np.int32)
        spec["wide_wts"] = ((B, self.wide_packed_len), np.float32)
        for g in self.groups:
            P = self.group_packed_len[g.dim]
            spec[f"emb_ids_d{g.dim}"] = ((B, P), np.int32)
            spec[f"emb_wts_d{g.dim}"] = ((B, P), np.float32)
            spec[f"emb_seg_d{g.dim}"] = ((B, P), np.int32)
            if mode == "train":
                for prefix, sd_spec in self._plan_specs(g, B * P, B):
                    for key, sd in sd_spec.items():
                        spec[f"{prefix}_{key}_d{g.dim}"] = sd
        if self.indicator_total_len:
            spec["ind_ids"] = ((B, self.indicator_total_len), np.int32)
            spec["ind_wts"] = ((B, self.indicator_total_len), np.float32)
        if self.continuous_slots:
            spec["cont"] = ((B, len(self.continuous_slots)), np.float32)
        if with_image:
            spec["image"] = ((B,) + tuple(image_shape), np.float32)
        return spec

    def describe(self) -> str:
        n_folded = len(self.folded_names)
        lines = [
            f"wide: {len(self.wide_slots)} slots ({n_folded} folded), "
            f"dim={self.wide_dim}, pool={self.wide_packed_len}",
            f"deep: input_dim={self.deep_input_dim} "
            f"(embed={self.deep_embed_dim}, indicator={self.indicator_dim}, "
            f"continuous={len(self.continuous_slots)})",
        ]
        for g in self.groups:
            lines.append(
                f"  dim-{g.dim} group: {len(g.slots)} tables, rows={g.rows}, "
                f"pool={self.group_packed_len[g.dim]}"
                + (" [folded wide]" if g.folded else ""))
        lines.append(f"crosses: {len(self.crosses)}")
        return "\n".join(lines)

    # ----------------------------------------------------------- serialization
    def to_dict(self) -> Dict[str, Any]:
        return {
            "multivalue": self.multivalue,
            "fold": self.fold,
            "fold_max_rows": self.fold_max_rows,
            "pack_budget": self.pack_budget,
            "columns": self.columns,
            "wide_dim": self.wide_dim,
            "deep_input_dim": self.deep_input_dim,
            "wide_slots": [dataclasses.asdict(s) for s in self.wide_slots],
            "groups": [
                {"dim": g.dim, "rows": g.rows, "total_len": g.total_len,
                 "folded": g.folded,
                 "slots": [dataclasses.asdict(s) for s in g.slots]}
                for g in self.groups],
            "indicator_slots": [dataclasses.asdict(s) for s in self.indicator_slots],
            "continuous_slots": [dataclasses.asdict(s) for s in self.continuous_slots],
            "crosses": [dataclasses.asdict(c) for c in self.crosses],
            # only where some feature sums: a plan without reads as the
            # JAX package's does
            **({"sum_pooled": sorted(self.sum_pooled)}
               if self.sum_pooled else {}),
        }
