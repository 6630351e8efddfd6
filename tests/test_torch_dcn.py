"""DLRM with a DCN-V2 interaction on the port (model.yaml
``dnn_bottom_units``, ``dnn_interaction``, ``dnn_embedding_optimizer:
RowwiseAdagrad``; feature.yaml ``combiner: sum``; the ``log1p`` transform),
held on the CPU against the benchmark's plain reference
(benchmark/reference/dcn.py) on seeded weights, at small sizes: four
tables of ~1,000 rows at d128, hotness 1-7 (and one of hotness 100, past
the native loader's old 64-value cap, for the loaders' check), three dense
counts.

Both sides round to bfloat16 at the same points and sum in float32; they
differ only in the order of some float32 sums (the port pools by a
one-hot contraction and sums the table's gradient by its compact plan,
the reference by slices and autograd's index_put).  On this CPU the two
give the same bits; the tolerances leave room for a sum order that flips
a bfloat16 rounding now and then (one step is 2^-8 relative) and stay
well under what the reference's fp8 control moves (the logits by ~4e-2,
checked here too), each written beside its check.
"""

import os

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

from paths import REPO  # noqa: E402

BENCH = os.path.join(REPO, "benchmark")

TABLES = ((1009, 1), (997, 3), (1013, 7), (983, 2))   # (rows, hotness)
N_DENSE = 3
B = 32


def write_dcn_conf(dst, tables=TABLES, combiner="sum", rank=64,
                   emb_opt="RowwiseAdagrad") -> str:
    """A small DLRM-DCNv2 conf in ``dst``: ``tables`` as (rows, hotness),
    one d128 group pooled by ``combiner``, bottom [32, 16], two cross
    layers of rank ``rank``, top [64, 32], bfloat16 dtypes."""
    os.makedirs(dst, exist_ok=True)
    dense = [f"i{j + 1}" for j in range(N_DENSE)]
    cats = [f"c{j + 1}" for j in range(len(tables))]

    def dump(name, doc):
        with open(os.path.join(dst, name + ".yaml"), "w") as f:
            yaml.safe_dump(doc, f, sort_keys=False)
    dump("schema", {"columns": ["clicked"] + dense + cats})
    feats = {d: {"type": "continuous", "transform": "log1p"} for d in dense}
    for name, (rows, hot) in zip(cats, tables):
        feats[name] = {"type": "category", "transform": "hash_bucket",
                       "parameter": rows, "embedding_dim": 128,
                       "max_len": hot, "combiner": combiner}
    dump("feature", feats)
    dump("cross_feature", {})
    model = {"linear_optimizer": "Ftrl",
             "dnn_optimizer": {"name": "Adagrad", "learning_rate": 0.05,
                               "initial_accumulator_value": 0.1},
             "dnn_embedding_optimizer": {"name": emb_opt,
                                         "learning_rate": 0.05,
                                         "initial_accumulator_value": 0.1},
             "dnn_hidden_units": [64, 32], "dnn_bottom_units": [32, 16],
             "dnn_interaction": {"type": "dcn", "layers": 2, "rank": rank},
             "dnn_connected_mode": "simple",
             "dnn_activation_function": "relu",
             "dnn_batch_normalization": 0,
             "embedding_dtype": "bfloat16", "dense_dtype": "bfloat16"}
    dump("model", model)
    dump("train", {"train": {
        "model_dir": os.path.join(dst, "model"), "model_type": "deep",
        "train_data": "x", "eval_data": "x", "test_data": "x",
        "batch_size": B, "num_examples": 1 << 20, "multivalue": 1,
        "pack_budget": 100, "sparse_optimizer": 1, "scatter_mode": "pallas",
        "keep_train": 0}})
    dump("serving", {"SavedModel": {"model_dir": "x",
                                    "model_type": "deep"}})
    dump("data_process", {})
    return str(dst)


def write_rows(path, n, seed, tables=TABLES, hot_less=False) -> str:
    """``n`` TSV rows: a label, ``N_DENSE`` counts (a tenth missing), each
    table's hotness of values (``hot_less``: one fewer in every other
    row)."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for r in range(n):
            cells = [str(int(rng.random() < 0.3))]
            for _ in range(N_DENSE):
                cells.append("-" if rng.random() < 0.1
                             else str(int(rng.lognormal(1.0, 1.5))))
            for j, (rows, hot) in enumerate(tables):
                k = max(1, hot - (r % 2)) if hot_less else hot
                vals = rng.zipf(1.3, k) % (rows * 2)
                cells.append(",".join(f"c{j}_{v}" for v in vals))
            f.write("\t".join(cells) + "\n")
    return path


def _ref():
    import sys
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    from reference import dcn
    return dcn


def ref_weights(spec, seed: int):
    """Seeded float32 weights for every leaf the reference names: the
    table N(0, 1) cut to [-2, 2] over the root of the width, kernels
    Glorot-uniform, biases small normal (nonzero, so their gradients and
    changes are compared with something to hold)."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for path, shape, _, init in spec.leaf_specs():
        t = torch.empty(shape)
        if init == "embedding":
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                        generator=gen)
            t /= shape[1] ** 0.5
        elif init == "glorot":
            lim = (6.0 / (shape[0] + shape[1])) ** 0.5
            t.uniform_(-lim, lim, generator=gen)
        else:
            t.normal_(0.0, 0.01, generator=gen)
        out[path] = t
    return out


@pytest.fixture
def fused_small(monkeypatch):
    """Tables of ~1,000 rows take the fused optimizer, as the 2^22-row
    tables of the configuration do."""
    import wide_deep_tpu_torch.optim.sparse as tsparse
    monkeypatch.setattr(tsparse, "SPARSE_MIN_ROWS", 1)


def port_trainer(conf, tmp_path, data, native=False):
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.features.pipeline import FeatureTransformer
    from wide_deep_tpu_torch.training.loop import Trainer
    tr = Trainer(Config(conf), "deep", model_dir=str(tmp_path / "m"),
                 overrides={"train_data": data, "eval_data": data,
                            "test_data": data, "batch_size": B},
                 device="cpu")
    if not native:
        tr.transformer = FeatureTransformer(tr.plan, tr.n_classes)
    return tr


def load_weights(tr, weights):
    """The reference's weights into the port's params, in its layout: the
    table in the param columns of its fused matrix."""
    from wide_deep_tpu_torch.optim import sparse as sparse_lib
    from wide_deep_tpu_torch.optim import tree_items
    tr.ensure_initialized(restore=False)
    fused = {t.path: t for t in tr.sparse_tables.values()}
    with torch.no_grad():
        for p, t in tree_items(tr.params):
            w = weights["/".join(str(k) for k in p)]
            if p in fused:
                t.zero_()
                t[:, :w.shape[1]] = w
            else:
                t.copy_(w)
        sparse_lib.init_fused_params(tr.params, tr.sparse_tables)


def port_batches(tr, data, n):
    from wide_deep_tpu_torch.features.pipeline import CsvDataset
    ds = CsvDataset(tr.plan, data, "train", B, shuffle_buffer=0,
                    seed=tr.seed, transformer=tr.transformer,
                    drop_remainder=True)
    out = []
    for b in ds:
        out.append(b)
        if len(out) == n:
            return out
    raise AssertionError("too few rows")


def ref_side(conf, data, n_batches, weights, lowp=False):
    dcn = _ref()
    spec = dcn.Spec(conf)
    with open(data) as f:
        lines = f.read().splitlines()
    parsed = [dcn.parse_lines(spec, lines[k * B:(k + 1) * B])
              for k in range(n_batches)]
    held = dcn.held_rows(parsed)
    table = f"dnn/embed/d{spec.dim}"
    params = {p: (w[torch.from_numpy(held)].clone() if p == table
                  else w.clone()) for p, w in weights.items()}
    model = dcn.Model(spec, lowp=lowp)
    batches = [dcn.device_batch(spec, b, held, "cpu") for b in parsed]
    return spec, model, params, batches, held


@pytest.fixture
def case(tmp_path, fused_small):
    conf = write_dcn_conf(str(tmp_path / "conf"))
    data = write_rows(str(tmp_path / "rows.tsv"), 3 * B, seed=5)
    dcn = _ref()
    weights = ref_weights(dcn.Spec(conf), seed=11)
    tr = port_trainer(conf, tmp_path, data)
    load_weights(tr, weights)
    return conf, data, weights, tr


def _to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_grads(tr, batch):
    """(loss, logits, {leaf path: gradient}) of the port's forward on one
    batch; the table's gradient summed per row from its sink."""
    from wide_deep_tpu_torch.optim import tree_items
    t = _to_torch(batch)
    leaves = [(p, x) for p, x in tree_items(tr.params)
              if p not in {s.path for s in tr.sparse_tables.values()}]
    for _, x in leaves:
        x.requires_grad_(True)
    sinks = {"d128": None}
    logits, _ = tr.model.apply(tr.params, tr.mstate, t, True, None, sinks)
    loss, _ = tr.model.loss_fn(tr.params, tr.mstate, t, True, None,
                               sinks=sinks)
    gs = torch.autograd.grad(loss, [x for _, x in leaves] + [sinks["d128"]])
    for _, x in leaves:
        x.requires_grad_(False)
    out = {"/".join(str(k) for k in p): g for (p, _), g in zip(leaves, gs)}
    table = tr.params["dnn"]["embed"]["d128"]
    g_rows = torch.zeros((table.shape[0], 128))
    g_rows.index_add_(0, t["emb_ids_d128"].reshape(-1).long(),
                      gs[-1].float())
    out["dnn/embed/d128"] = g_rows
    return loss.detach(), logits.detach(), out


def test_forward_loss_and_gradients_match_reference(case):
    conf, data, weights, tr = case
    spec, model, params, batches, held = ref_side(conf, data, 1, weights)
    loss, logits, grads = _port_grads(tr, port_batches(tr, data, 1)[0])
    table = f"dnn/embed/d{spec.dim}"
    leaves = list(params.items())
    for _, x in leaves:
        x.requires_grad_(True)
    ref_logits = model.logits(params, batches[0])
    ref_loss = model.loss(params, batches[0])
    ref_value = float(ref_loss.detach())
    ref_grads = dict(zip(params, torch.autograd.grad(
        ref_loss, [x for _, x in leaves])))
    # logits of O(1): a flipped bfloat16 rounding in the last layers moves
    # one by ~4e-3; the fp8 control moves them by ~4e-2
    torch.testing.assert_close(logits, ref_logits.detach(), rtol=0,
                               atol=4e-3)
    lowp = _ref().Model(spec, lowp=True).logits(params, batches[0])
    assert float((lowp - ref_logits).detach().abs().max()) > 4e-3
    # the mean loss over 32 rows averages such flips out
    assert abs(float(loss) - ref_value) < 1e-3 * abs(ref_value)
    assert set(grads) == set(ref_grads)
    for p, g in ref_grads.items():
        got = grads[p][torch.from_numpy(held)] if p == table else grads[p]
        # a leaf's gradient as a whole: the norm of the gap within 1% of
        # the norm (a flipped bfloat16 activation feeds every gradient)
        gap = float(torch.linalg.norm(got - g))
        assert gap <= 1e-2 * float(torch.linalg.norm(g)) + 1e-9, p


def test_three_steps_match_reference(case):
    """Three steps of dense Adagrad plus RowwiseAdagrad from the same
    weights: each leaf's change and each accumulator's."""
    conf, data, weights, tr = case
    spec, model, params, batches, held = ref_side(conf, data, 3, weights)
    ref = _ref().Trainer(model, params)
    for b in batches:
        ref.step(b)
    for b in port_batches(tr, data, 3):
        tr.train_batch(tr._to_device(b) if tr.device.type == "cuda"
                       else _to_torch(b))
    table = f"dnn/embed/d{spec.dim}"
    from wide_deep_tpu_torch.optim import tree_items
    got = {"/".join(str(k) for k in p): x.detach()
           for p, x in tree_items(tr.params)}
    fused = got[table]
    for p, w in ref.params.items():
        now = (fused[torch.from_numpy(held), :spec.dim] if p == table
               else got[p])
        start = (weights[p][torch.from_numpy(held)] if p == table
                 else weights[p])
        want, have = w - start, now - start
        # the change over three steps, as a whole: within 1% (the
        # gradients' tolerance carried through Adagrad's normalisation)
        assert float(torch.linalg.norm(have - want)) <= (
            1e-2 * float(torch.linalg.norm(want)) + 1e-9), p
    acc = fused[torch.from_numpy(held), spec.dim:spec.dim + 1]
    want = ref.slots[table]["accum"] - 0.1
    # the accumulators take squared gradients: twice their tolerance
    assert float(torch.linalg.norm((acc - 0.1) - want)) <= (
        2e-2 * float(torch.linalg.norm(want))), "row accumulators"
    # untouched rows and the padding columns stay as they were
    untouched = torch.ones(fused.shape[0], dtype=torch.bool)
    untouched[torch.from_numpy(held)] = False
    assert torch.equal(fused[untouched, :spec.dim],
                       weights[table][untouched])
    assert torch.all(fused[untouched, spec.dim] == np.float32(0.1))
    assert torch.all(fused[:, spec.dim + 1:] == 0)


def test_fused_width_and_checkpoint_round_trip(case, tmp_path):
    """The d128 RowwiseAdagrad table is [rows, 132] (129 live columns in
    whole float4s); a checkpoint stores its 129 live columns and a restore
    gives every bit back with zero padding."""
    conf, data, weights, tr = case
    t = tr.params["dnn"]["embed"]["d128"]
    assert t.shape[1] == 132
    for b in port_batches(tr, data, 2):
        tr.train_batch(_to_torch(b))
    from wide_deep_tpu_torch.optim import sparse as sparse_lib
    view = sparse_lib.compact_fused_ckpt(tr.params, tr.sparse_tables)
    assert view["dnn"]["embed"]["d128"].shape[1] == 129
    tr.save()
    want = t.clone()
    tr2 = port_trainer(conf, tmp_path, data)
    tr2.train_conf["keep_train"] = True
    tr2.ensure_initialized(restore=True)
    got = tr2.params["dnn"]["embed"]["d128"]
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_pooling_sum_and_mean(tmp_path, fused_small, combiner):
    """The loader's weights: 1 a value under ``combiner: sum``, 1/k under
    the mean; the pool is exactly the hotness' sum wide, no value cut
    (pack_budget 100 past each max_len), and the port's forward pools as
    the reference does under either."""
    conf = write_dcn_conf(str(tmp_path / "conf"), combiner=combiner)
    data = write_rows(str(tmp_path / "rows.tsv"), B, seed=3, hot_less=True)
    tr = port_trainer(conf, tmp_path, data)
    b = port_batches(tr, data, 1)[0]
    assert b["emb_ids_d128"].shape == (B, sum(h for _, h in TABLES))
    w = b["emb_wts_d128"]
    seg = b["emb_seg_d128"]
    for row in range(B):
        for f in range(len(TABLES)):
            ws = w[row][(seg[row] == f) & (w[row] != 0)]
            want = 1.0 if combiner == "sum" else 1.0 / len(ws)
            assert np.all(ws == np.float32(want))
    dcn = _ref()
    weights = ref_weights(dcn.Spec(conf), seed=2)
    load_weights(tr, weights)
    spec, model, params, batches, _ = ref_side(conf, data, 1, weights)
    _, logits, _ = _port_grads(tr, b)
    # as in the forward test
    torch.testing.assert_close(
        logits, model.logits(params, batches[0]).detach(), rtol=0,
        atol=4e-3)


def test_native_loader_matches_python(tmp_path, fused_small):
    """The C++ loader packs the DCN conf as the Python one does: sum
    weights, log1p counts, a cell of 100 values (past the old 64 cap)."""
    pytest.importorskip("wide_deep_tpu_torch.features.native")
    from wide_deep_tpu_torch.features import native
    if native.find_compiler() is None:
        pytest.skip("no C++ compiler to build the native loader")
    tables = TABLES + ((1021, 100),)
    conf = write_dcn_conf(str(tmp_path / "conf"), tables=tables)
    data = write_rows(str(tmp_path / "rows.tsv"), B, seed=7, tables=tables,
                      hot_less=True)
    py = port_batches(port_trainer(conf, tmp_path, data), data, 1)[0]
    nat = port_batches(port_trainer(conf, tmp_path, data, native=True),
                       data, 1)[0]
    assert set(py) == set(nat)
    for k in py:
        np.testing.assert_array_equal(py[k], nat[k], err_msg=k)


@pytest.mark.parametrize("model_text,feature_text,match", [
    ("dnn_interaction: {type: dcn, layers: 3, rank: 512}",
     None, None),
    ("dnn_interaction: {type: dot, layers: 3, rank: 512}",
     None, "dnn_interaction type"),
    ("dnn_interaction: {type: dcn, layers: 0, rank: 512}",
     None, "layers must be a positive int"),
    ("dnn_interaction: {type: dcn, layers: 3, rank: 512, width: 2}",
     None, "unknown keys"),
    ("dnn_bottom_units: []", None, "dnn_bottom_units"),
    ("dnn_bottom_units: [512, 0]", None, "dnn_bottom_units"),
    ("dnn_embedding_optimizer: Adam", None, "unknown optimizer"),
    ("dnn_optimizer: RowwiseAdagrad", None, "unknown optimizer"),
    (None, "{type: category, transform: hash_bucket, parameter: 9, "
     "combiner: max}", "combiner"),
    (None, "{type: category, transform: vocab, parameter: [a, b], "
     "combiner: sum}", "combiner"),
    (None, "{type: category, transform: hash_bucket, parameter: 9, "
     "max_len: 129}", "max_len"),
])
def test_config_validation(tmp_path, model_text, feature_text, match):
    from wide_deep_tpu_torch.config import Config, ConfigError
    conf = write_dcn_conf(str(tmp_path / "conf"))
    if model_text:
        with open(os.path.join(conf, "model.yaml"), "a") as f:
            f.write(model_text + "\n")
    if feature_text:
        with open(os.path.join(conf, "feature.yaml"), "a") as f:
            f.write(f"c9: {feature_text}\n")
        with open(os.path.join(conf, "schema.yaml"), "a") as f:
            f.write("- c9\n")
    cfg = Config(conf)
    if match is None:
        assert cfg.model["dnn_interaction"] == {"type": "dcn", "layers": 3,
                                                "rank": 512}
        return
    with pytest.raises(ConfigError, match=match):
        cfg.model
        cfg.read_feature_conf()


def test_embedding_optimizer_needs_fused_tables(tmp_path):
    """dnn_embedding_optimizer rules the fused tables alone: a conf whose
    group is not fused (here: ~4,000 rows, under 2^22) is refused."""
    from wide_deep_tpu_torch.config import ConfigError
    conf = write_dcn_conf(str(tmp_path / "conf"))
    data = write_rows(str(tmp_path / "rows.tsv"), B, seed=1)
    with pytest.raises(ConfigError, match="dnn_embedding_optimizer"):
        port_trainer(conf, tmp_path, data)


def test_confs_without_the_new_keys_read_as_before():
    """conf/ reads without any of the new keys: the parent's layout."""
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.features.plan import FeaturePlan
    cfg = Config(os.path.join(REPO, "conf"))
    m = cfg.model
    for k in ("dnn_bottom_units", "dnn_interaction",
              "dnn_embedding_optimizer"):
        assert k not in m
    assert all("combiner" not in c for c in cfg.read_feature_conf().values())
    plan = FeaturePlan(cfg, pack_budget=3)
    assert plan.sum_pooled == frozenset()
    assert "sum_pooled" not in plan.to_dict()


def test_prod4x_d32_table_keeps_its_layout(monkeypatch, tmp_path):
    """The tables every earlier configuration fuses keep [rows, 128]: the
    benchmark's prod4x d32 table (Adagrad) is 128 wide, its checkpoint
    stores its 64 live columns (2.56 GB at 10,000,128 rows), and K3 writes
    it rows of 128."""
    import sys
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.ops import rowdma
    from wide_deep_tpu_torch.optim import sparse as sparse_lib
    from wide_deep_tpu_torch.training.loop import build_training_plan
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    from harness import confdir, spec as bench_spec
    cell = bench_spec.Cell("prod4x_train_packed")
    conf = confdir.write_conf(cell, str(tmp_path), 1, "m")
    cfg = Config(conf)
    plan = build_training_plan(cfg, cfg.train, "wide_deep")
    (g,) = [g for g in plan.groups if plan.sparse_opt_group(g, 102400)]
    assert (g.dim, g.rows, plan.fused_width(g)) == (32, 10000128, 128)
    tables, _ = sparse_lib.plan_sparse_tables(plan, cfg.model, 8.0, 102400)
    (t,) = tables.values()
    assert sparse_lib.fused_live_width(t.spec, t.dim) == 64
    assert sparse_lib.fused_layout(t.spec, t.dim) == {"accum": 32}
    assert g.rows * 64 * 4 == 2_560_032_768
    # a small table of the same rule takes the same rows to K3
    seen = []
    monkeypatch.setattr(rowdma, "rowdma_scatter_rows",
                        lambda table, uids, rows: seen.append(
                            (tuple(table.shape), tuple(rows.shape))))
    from wide_deep_tpu_torch.ops.scatter import make_compact_plan
    ids = np.array([3, 1, 3, 7], np.int32)
    p = {k: torch.from_numpy(v) for k, v in make_compact_plan(ids, 16)
         .items()}
    p["live"] = sparse_lib.compact_live({"sopt_ids_d32": p["ids"]})["d32"]
    fused = torch.zeros((16, 128))
    sparse_lib.apply_fused_update(t, fused, torch.ones((4, 32)), p,
                                  {"count": 0})
    # the plan's 3 distinct rows, each 128 wide
    assert seen == [((16, 128), (3, 128))]


# ---------------------------------------------------------------- the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


# the cell's tables as one of 8 GPUs holds them (rows, hotness)
CELL_TABLES = ((5000000, 3), (39060, 2), (17295, 1), (7424, 2), (20265, 6),
               (3, 1), (7122, 1), (1543, 1), (63, 1), (5000000, 7),
               (383494, 3), (405282, 8), (10, 1), (2209, 6), (11938, 9),
               (155, 5), (4, 1), (976, 1), (14, 1), (5000000, 12),
               (5000000, 100), (5000000, 27), (590152, 10), (12973, 3),
               (108, 1), (36, 1))


def cell_stream(seed):
    """The cell's d128 pool: 8,192 rows of the 26 tables' hotness of
    zipf-1.3 rows each -> (int32 [1,753,088] table rows, table rows)."""
    rng = np.random.default_rng(seed)
    offsets = np.cumsum([0] + [r for r, _ in CELL_TABLES])
    cols = [offsets[f] + rng.zipf(1.3, (8192, h)) % r
            for f, (r, h) in enumerate(CELL_TABLES)]
    ids = np.concatenate(cols, axis=1).reshape(-1).astype(np.int32)
    return ids, -(-int(offsets[-1]) // 256) * 256


@pytest.mark.cuda
def test_cuda_k1_d128_over_the_cell_stream(cuda_device):
    """K1 at d128 over the cell's compact plan (1,753,088 entries,
    bfloat16 gradients summed in float32): within 1e-6 of each row's sum
    of |g| from the float64 sum (float32 round-off grows with the
    magnitudes summed), the same bits on two calls."""
    from wide_deep_tpu_torch.ops import scatter as tsc
    ids, rows = cell_stream(3)
    assert ids.size == 1_753_088
    plan = {k: torch.from_numpy(v).to(cuda_device)
            for k, v in tsc.make_compact_plan(ids, rows).items()}
    n = ids.size
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    g = torch.randn((n, 128), generator=gen, device=cuda_device).to(
        torch.bfloat16).float()
    out = tsc.range_scatter_add(plan["ids"], plan["perm"], g, plan["tiles"],
                                n, torch.float32)
    again = tsc.range_scatter_add(plan["ids"], plan["perm"], g,
                                  plan["tiles"], n, torch.float32)
    assert torch.equal(out.view(torch.int32), again.view(torch.int32))
    idx = plan["ids"].long()
    gp = g[plan["perm"].long()].double()
    ref = torch.zeros((n, 128), dtype=torch.float64,
                      device=cuda_device).index_add_(0, idx, gp)
    mag = torch.zeros_like(ref).index_add_(0, idx, gp.abs())
    assert bool(((out.double() - ref).abs() <= 1e-6 * mag + 1e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 132, 36])
def test_cuda_k3_at_a_fused_width(cuda_device, width):
    """K3 writes rows of the table's own width (128, the d128
    RowwiseAdagrad table's 132, a d32 one's 36) exactly as the plain
    version does, sentinels skipped, the same bits twice."""
    from wide_deep_tpu_torch.ops import rowdma as trowdma
    gen = torch.Generator(device=cuda_device).manual_seed(width)
    table = torch.randn((50000, width), generator=gen, device=cuda_device)
    uids = torch.cat([torch.randperm(50000, generator=gen,
                                     device=cuda_device)[:20000].sort()
                      .values, 50000 + torch.arange(
                          37, device=cuda_device)]).to(torch.int32)
    new = torch.randn((uids.shape[0], width), generator=gen,
                      device=cuda_device)
    before = trowdma.rowdma_launches_by_width.get(width, 0)
    got = trowdma.rowdma_scatter_rows(table.clone(), uids, new)
    again = trowdma.rowdma_scatter_rows(table.clone(), uids, new)
    ref = trowdma.rowdma_scatter_rows_plain(table.clone(), uids, new)
    assert torch.equal(got, ref) and torch.equal(got, again)
    assert trowdma.rowdma_launches_by_width[width] == before + 2


@pytest.mark.cuda
def test_cuda_rowwise_row_update_matches_host_bits(cuda_device):
    """RowwiseAdagrad's row formula on the card gives the host's bits for
    the rows and their accumulators over three steps (the mean of the
    squares summed in float64, the roots through ``_rsqrt``)."""
    from wide_deep_tpu_torch.optim import exponential_decay
    from wide_deep_tpu_torch.optim.sparse import _row_update
    spec = {"name": "RowwiseAdagrad", "learning_rate": 0.005}
    schedule = exponential_decay(0.005, 1.0, 1.0)
    rng = np.random.default_rng(4)
    w0 = rng.normal(0, 0.09, (200000, 128)).astype(np.float32)
    grads = [torch.from_numpy(rng.normal(0, 1e-3, (200000, 128)).astype(
        np.float32)) for _ in range(3)]
    out = {}
    for dev in ("cpu", cuda_device):
        w = torch.from_numpy(w0).to(dev)
        slots = {"accum": torch.full((200000, 1), 0.1, device=dev)}
        for count, g in enumerate(grads):
            w, slots = _row_update(spec, schedule(count), w, g.to(dev), slots)
        out[str(dev)] = (w.cpu(), slots["accum"].cpu())
    for a, b in zip(out["cpu"], out["cuda"]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128, 129, 300])
@pytest.mark.parametrize("kind,n,rows", [
    ("skewed", 20000, 5000), ("repeated", 30000, 5000),
    ("sentinels", 20000, 8000), ("compact", 20000, None)])
def test_cuda_k1_wide_rows_match_plain(cuda_device, kind, n, rows, d,
                                       g_dtype):
    """K1's wide chunk pass (64 columns or more, the d128 table's) on
    streams whose runs cross chunk edges, run through many chunks, end in
    sentinels, or come from a compact plan, over one and two column
    groups (300 > 256): test_torch_cuda's tolerance, the same bits
    twice."""
    from test_torch_cuda import _check_k1, _k1_case
    from wide_deep_tpu_torch.ops import scatter as tsc
    plan, rows, g, ref, abs_sum = _k1_case(kind, n, rows, d, g_dtype, seed=d)
    tp = {k: torch.from_numpy(v).to(cuda_device) for k, v in plan.items()}
    g = g.to(cuda_device)
    out = tsc.range_scatter_add(tp["ids"], tp["perm"], g, tp["tiles"], rows,
                                torch.float32)
    again = tsc.range_scatter_add(tp["ids"], tp["perm"], g, tp["tiles"],
                                  rows, torch.float32)
    want = tsc.range_scatter_add_plain(tp["ids"], tp["perm"], g, rows,
                                       torch.float32)
    assert torch.equal(out.view(torch.int32), again.view(torch.int32))
    _check_k1(out, want, ref, abs_sum)
