"""The port's quality tools and bars (``wide_deep_tpu_torch/tools/
quality_onchip.py``, ``quality_matrix.py``, ``pack_budget_curve.py``).

On the CPU: the matrix's confs and data are the JAX tool's (``conf_for``
writes the same files for every variant; ``generate_ctr_tsv`` the same
bytes for one seed), ``suggest_pack_budget`` gives the JAX package's
value, and each tool runs through to its JSON at a tiny size.  With
conf/'s learning rates, Adam's and RMSProp's loss rises within the first
three steps in the JAX package as it does in the port (the per-step
losses agree within 1e-5 relative, the same float32 model from the same
weights, carried across with ``interop.from_jax``): the configuration's
own behaviour.

On the card (``cuda``, and ``slow`` as their JAX originals in
tests/test_quality.py are): the planted-signal bars of every model type
and the pack-budget tail-signal bars, at the JAX tests' size.
"""

import filecmp
import importlib.util
import json
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paths import REPO, TRAIN1  # noqa: E402

TRAIN = os.path.join(REPO, "data", "train")
EVAL = os.path.join(REPO, "data", "eval", "eval1")


def _jax_tool(name):
    """A JAX package tool loaded from tools/ by path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the JAX tool's variants (tools/quality_matrix.py main): conf_for's edits
# by name; None: the base conf
VARIANT_EDITS = {
    "wide": None, "deep_simple": None, "wide_deep_simple": None,
    "wd_first_dense": {"connected_mode": "first_dense"},
    "wd_last_dense": {"connected_mode": "last_dense"},
    "wd_dense": {"connected_mode": "dense"},
    "wd_resnet": {"connected_mode": "resnet"},
    "wd_dag_0-1_0-2_1-2": {"connected_mode": "[0-1, 0-2, 1-2]"},
    "wd_multitower": {"hidden_units": "[[64, 32], [32, 16]]"},
    "wd_fm8": {"fm_factors": 8},
    "wd_multiclass3": None,
}


@pytest.fixture(scope="module")
def matrix_confs(tmp_path_factory):
    """Both packages' matrix confs: {name: (JAX conf dir, port conf dir)}."""
    from wide_deep_tpu.testing import write_small_conf as jwrite
    from wide_deep_tpu_torch.testing import write_small_conf as twrite
    from wide_deep_tpu_torch.tools import quality_matrix
    tmp = tmp_path_factory.mktemp("matrix_confs")
    jtool = _jax_tool("quality_matrix")
    jbase = jwrite(str(tmp / "jax" / "conf_base"), hidden_units="[64, 32]",
                   batch_size=512)
    tbase = twrite(str(tmp / "port" / "conf_base"), hidden_units="[64, 32]",
                   batch_size=512)
    port = {name: d for name, d, _, _ in
            quality_matrix.variants(tbase, str(tmp / "port"))}
    out = {}
    for name, edits in VARIANT_EDITS.items():
        jdir = jbase if edits is None else jtool.conf_for(
            jbase, str(tmp / "jax" / f"conf_{name}"), **edits)
        out[name] = (jdir, port[name])
    return out


@pytest.mark.parametrize("name", sorted(VARIANT_EDITS))
def test_matrix_conf_matches_jax(matrix_confs, name):
    """Every file of the variant's conf, model.yaml's text included, is the
    JAX tool's."""
    jdir, tdir = matrix_confs[name]
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir))
    _, mismatch, errors = filecmp.cmpfiles(jdir, tdir, names, shallow=False)
    assert mismatch == [] and errors == []
    with open(os.path.join(tdir, "model.yaml")) as f:
        text = f.read()
    if VARIANT_EDITS[name] and "fm_factors" in VARIANT_EDITS[name]:
        assert "linear_fm_factors: 8" in text
    if VARIANT_EDITS[name] and "connected_mode" in VARIANT_EDITS[name]:
        assert (f"dnn_connected_mode: "
                f"{VARIANT_EDITS[name]['connected_mode']}") in text


@pytest.mark.parametrize("n_classes", [2, 3])
def test_generate_ctr_tsv_same_bytes(tmp_path, n_classes):
    from wide_deep_tpu.config import Config as JConfig
    from wide_deep_tpu.testing import generate_ctr_tsv as jgen
    from wide_deep_tpu.testing import write_small_conf
    from wide_deep_tpu_torch.config import Config as TConfig
    from wide_deep_tpu_torch.testing import generate_ctr_tsv as tgen
    conf = write_small_conf(str(tmp_path / "conf"))
    j, t = str(tmp_path / "jax.tsv"), str(tmp_path / "port.tsv")
    assert (jgen(JConfig(conf), j, 700, 7, 0.08, n_classes)
            == tgen(TConfig(conf), t, 700, 7, 0.08, n_classes))
    with open(j, "rb") as fj, open(t, "rb") as ft:
        data = fj.read()
        assert data == ft.read() and data.count(b"\n") == 700


@pytest.mark.parametrize("small", [True, False], ids=["small", "conf"])
def test_suggest_pack_budget_matches_jax(tmp_path, small):
    """On data/train, for the small conf and conf/ as shipped."""
    from wide_deep_tpu.config import Config as JConfig
    from wide_deep_tpu.features.analyze import suggest_pack_budget as jsug
    from wide_deep_tpu.features.plan import FeaturePlan as JPlan
    from wide_deep_tpu.testing import write_small_conf
    from wide_deep_tpu_torch.config import Config as TConfig
    from wide_deep_tpu_torch.features.analyze import \
        suggest_pack_budget as tsug
    from wide_deep_tpu_torch.features.plan import FeaturePlan as TPlan
    conf = (write_small_conf(str(tmp_path / "conf")) if small
            else os.path.join(REPO, "conf"))
    want = jsug(JPlan(JConfig(conf), fold=False, pack_budget=3), TRAIN)
    got = tsug(TPlan(TConfig(conf), fold=False, pack_budget=3), TRAIN)
    assert got == want and 1 <= got


def _head(src, dst, n):
    with open(src) as f, open(dst, "w") as out:
        for _ in range(n):
            out.write(f.readline())
    return str(dst)


def test_quality_matrix_main_tiny(tmp_path, capsys):
    """Two variants (FM k = 8, the 3-class head) at 300 train rows: the
    JSON written and printed, the device named, each row's metrics
    finite; a second run reuses the generated data."""
    from wide_deep_tpu_torch.tools import quality_matrix
    work = str(tmp_path / "work")
    argv = ["--rows", "300", "--eval_rows", "100", "--batch_size", "64",
            "--only", "wd_fm8,wd_multiclass3", "--work_dir", work,
            "--device", "cpu"]
    res = quality_matrix.main(argv)
    with open(os.path.join(work, "quality_matrix.json")) as f:
        assert json.load(f) == res
    assert res["device"] == "cpu" and res["rows"] == 300
    assert [r["variant"] for r in res["results"]] == ["wd_fm8",
                                                     "wd_multiclass3"]
    fm, mc = res["results"]
    assert 0.0 <= fm["auc"] <= 1.0 and np.isfinite(fm["logloss"])
    assert fm["steps"] >= 300 // 64 and mc["steps"] >= 75 // 64
    assert mc["auc"] is None and 0.0 <= mc["accuracy"] <= 1.0
    printed = capsys.readouterr().out
    assert "wrote 300 rows" in printed
    stamp = os.path.getmtime(os.path.join(work, "train2.tsv"))
    quality_matrix.main(argv[:-6] + ["--only", "wide", "--work_dir", work,
                                     "--device", "cpu", "--out",
                                     str(tmp_path / "out.json")])
    assert "wrote" not in capsys.readouterr().out
    assert os.path.getmtime(os.path.join(work, "train2.tsv")) == stamp
    with open(tmp_path / "out.json") as f:
        assert [r["variant"] for r in json.load(f)["results"]] == ["wide"]


def test_pack_budget_curve_main_tiny(tmp_path, capsys):
    """One budget, one seed, one epoch over 128 rows: one JSON line with
    the pools the budget gives and a finite AUC."""
    from wide_deep_tpu_torch.tools import pack_budget_curve
    train = _head(TRAIN1, tmp_path / "train", 128)
    ev = _head(EVAL, tmp_path / "eval", 64)
    lines = pack_budget_curve.main(["--budgets", "2", "--seeds", "5",
                                    "--epochs", "1", "--train_data", train,
                                    "--eval_data", ev, "--device", "cpu"])
    out, err = capsys.readouterr()
    assert [json.loads(x) for x in out.splitlines()] == lines
    assert "pack_budget: auto" in err
    (line,) = lines
    assert line["pack_budget"] == 2 and line["seed"] == 5
    assert line["device"] == "cpu" and 0.0 <= line["auc"] <= 1.0
    assert np.isfinite(line["logloss"]) and line["pools"]


def test_quality_onchip_parts_tiny(tmp_path, monkeypatch, capsys):
    """Part A (wide_deep, 2 epochs over a reference dir of 128 rows) and
    part B (the wide model, 1 epoch over 128 rows) on the small conf: their
    markdown tables and the last JSON line."""
    from wide_deep_tpu_torch.testing import write_small_conf
    from wide_deep_tpu_torch.tools import quality_onchip
    monkeypatch.setenv("WIDE_DEEP_CONF_DIR",
                       write_small_conf(str(tmp_path / "conf")))
    ref = tmp_path / "ref"
    (ref / "train").mkdir(parents=True)
    (ref / "eval").mkdir()
    _head(TRAIN1, ref / "train" / "t1", 128)
    _head(EVAL, ref / "eval" / "e1", 64)
    train = tmp_path / "b_train"
    train.mkdir()
    _head(TRAIN1, train / "t1", 128)
    monkeypatch.setattr(quality_onchip, "TRAIN", str(train))
    monkeypatch.setattr(quality_onchip, "EVAL", str(ref / "eval" / "e1"))
    monkeypatch.setattr(quality_onchip, "EPOCHS", 1)
    monkeypatch.setattr(quality_onchip, "MODEL_TYPES", ("wide",))
    out = quality_onchip.main(["--device", "cpu", "--seed", "5",
                               "--reference_data", str(ref)])
    text = capsys.readouterr().out
    assert "# Part A" in text and "# Part B" in text
    assert json.loads(text.splitlines()[-1]) == out
    assert out["device"] == "cpu"
    assert [r["epoch"] for r in out["part_a"]] == [0, 1]
    (b,) = out["part_b"]
    assert b["model_type"] == "wide" and b["steps"] == 2 and b["seed"] == 5
    assert 0.0 <= b["auc"] <= 1.0 and np.isfinite(b["average_loss"])


@pytest.mark.parametrize("name", ["Adam", "RMSProp"])
def test_loss_rise_with_conf_rates_matches_jax(tmp_path, name):
    """``name`` on both arms with conf/'s rates (0.05): the JAX package's
    loss rises above its first step's within three steps of 256 rows, and
    the port's per-step losses are the JAX package's within 1e-5."""
    import jax
    from test_torch_features import write_conf
    from wide_deep_tpu.config import Config as JConfig
    from wide_deep_tpu.features.pipeline import FeatureTransformer as JT
    from wide_deep_tpu.parallel import mesh as mesh_lib
    from wide_deep_tpu.training.loop import Trainer as JTrainer
    from wide_deep_tpu_torch.config import Config as TConfig
    from wide_deep_tpu_torch.features.pipeline import FeatureTransformer as TT
    from wide_deep_tpu_torch.interop import from_jax
    from wide_deep_tpu_torch.training.loop import Trainer as TTrainer
    b = 256
    conf_dir = write_conf(tmp_path / "conf")
    path = os.path.join(conf_dir, "model.yaml")
    with open(path) as f:
        text = f.read()
    for key in ("linear_optimizer", "dnn_optimizer"):
        text, n = re.subn(rf"(?m)^{key}:.*$", f"{key}: {name}", text)
        assert n == 1
    with open(path, "w") as f:
        f.write(text)
    data = _head(TRAIN1, tmp_path / "head", 3 * b)
    over = dict(train_data=data, eval_data=data, test_data=data,
                keep_train=True, batch_size=b, pack_budget=3)
    jtr = JTrainer(JConfig(conf_dir), model_type="wide_deep",
                   model_dir=str(tmp_path / "jax"), overrides=over,
                   mesh=mesh_lib.make_mesh(1, 1, jax.devices()[:1]))
    ttr = TTrainer(TConfig(conf_dir), model_type="wide_deep",
                   model_dir=str(tmp_path / "torch"), overrides=over,
                   device="cpu")
    # the Python loaders on both sides: the same batches in the same order
    jtr.transformer = JT(jtr.plan, jtr.n_classes, jtr.pos_weight,
                         jtr.neg_weight)
    ttr.transformer = TT(ttr.plan, ttr.n_classes, ttr.pos_weight,
                         ttr.neg_weight)
    jtr.ensure_initialized(restore=False)
    ttr.params, ttr.mstate = from_jax(jax.device_get(jtr.params),
                                      jax.device_get(jtr.mstate),
                                      device="cpu")
    jlosses, step = [], jtr._train_step

    def record(*args):
        out = step(*args)
        jlosses.append(float(out[3]))
        return out

    jtr._train_step = record
    jtr.train_file(data)
    ttr.train_file(data)
    tlosses = [float(x) for x in ttr.losses]
    assert len(jlosses) == 3
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert max(jlosses[1:]) > jlosses[0] and max(tlosses[1:]) > tlosses[0]


# ------------------------------------------------ the bars, on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the bars train on the card)")
    return torch.device("cuda")


@pytest.fixture
def small_conf(tmp_path):
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.testing import write_small_conf
    return Config(write_small_conf(str(tmp_path / "conf_small")))


@pytest.mark.slow
@pytest.mark.cuda
@pytest.mark.parametrize("model_type,min_auc", [
    ("wide", 0.70), ("deep", 0.62), ("wide_deep", 0.64)])
def test_learns_planted_signal(cuda_device, small_conf, tmp_path, model_type,
                               min_auc):
    """tests/test_quality.py's bars on the card: 5 epochs over data/train
    at batch 64 on the small conf, eval on data/eval/eval1."""
    from wide_deep_tpu_torch.training.loop import Trainer
    tr = Trainer(small_conf, model_type=model_type,
                 model_dir=str(tmp_path), device=cuda_device,
                 overrides=dict(train_data=TRAIN, eval_data=EVAL,
                                test_data=EVAL, keep_train=True,
                                batch_size=64, num_examples=4000))
    tr.ensure_initialized(restore=False)
    for epoch in range(5):
        for f in sorted(os.listdir(TRAIN)):
            tr.train_file(os.path.join(TRAIN, f), epoch_seed=epoch)
    res = tr.evaluate(EVAL)
    assert res["auc"] > min_auc, res
    assert res["average_loss"] < 0.60, res
    # calibration: the prediction mean near the ~25% base rate
    assert 0.12 < res["prediction/mean"] < 0.40, res


@pytest.mark.slow
@pytest.mark.cuda
def test_auto_pack_budget_keeps_tail_signal(cuda_device, small_conf,
                                            tmp_path):
    """tests/test_quality.py's pack-budget bars on the card: the label
    planted only in a multivalue feature's last value; ``auto`` (the p95
    occupancy) keeps it and learns it, a budget of 1 cannot see it."""
    from wide_deep_tpu_torch.features.analyze import resolve_pack_budget
    from wide_deep_tpu_torch.features.plan import FeaturePlan
    from wide_deep_tpu_torch.training.loop import Trainer
    with open(TRAIN1) as f:
        template = f.readline().rstrip("\n").split("\t")
    col = FeaturePlan(small_conf).column_index["ucomp"]
    rng = np.random.default_rng(0)
    noise = [f"u{i}" for i in range(50)]

    def make_rows(n):
        rows = []
        for _ in range(n):
            r = list(template)
            label = int(rng.random() < 0.5)
            r[0] = str(label)
            vals = list(rng.choice(noise, size=6, replace=False))
            if label:
                vals[-1] = "TAILSIG"      # the signal only in the last value
            r[col] = ",".join(vals)
            rows.append("\t".join(r))
        return rows

    train_p, eval_p = tmp_path / "tail_train", tmp_path / "tail_eval"
    train_p.write_text("\n".join(make_rows(800)) + "\n")
    eval_p.write_text("\n".join(make_rows(300)) + "\n")
    assert resolve_pack_budget(small_conf, str(train_p), raw="auto") >= 6
    aucs = {}
    for tag, budget in (("auto", "auto"), ("first_only", 1)):
        tr = Trainer(small_conf, model_type="wide_deep",
                     model_dir=str(tmp_path / tag), device=cuda_device,
                     overrides=dict(train_data=str(train_p),
                                    eval_data=str(eval_p),
                                    test_data=str(eval_p), keep_train=True,
                                    batch_size=64, num_examples=800,
                                    pack_budget=budget))
        if tag == "auto":
            assert tr.plan.pack_budget >= 6, tr.plan.pack_budget
        tr.ensure_initialized(restore=False)
        for epoch in range(3):
            tr.train_file(str(train_p), epoch_seed=epoch)
        aucs[tag] = tr.evaluate(str(eval_p))["auc"]
    assert aucs["auto"] > 0.9, aucs
    assert aucs["first_only"] < 0.65, aucs


@pytest.mark.slow
@pytest.mark.parametrize("model_type", ["deep", "wide_deep"])
def test_large_table_calibration_matches_jax(tmp_path, monkeypatch,
                                             model_type, capsys):
    """quality_onchip part B's setting (5 epochs over data/train at batch
    64, eval on data/eval/eval1) on conf/ as shipped with its one
    10,000,000-bucket feature cut to 1,000,000 (deep's unfolded groups of
    2^20 rows or more fused, SPARSE_MIN_ROWS 2^20 in both packages; the
    wide_deep fold keeps them dense), over three seeds in each
    package from its own init, on the CPU: the port's mean logloss is
    within 0.06 of the JAX package's, and both miss tests/test_quality.py's
    small-conf logloss bar (0.60): with tables this large and 4,000 rows
    of data the deep arm under-predicts in either package.  Prints both
    packages' metrics by seed (``-s``)."""
    import shutil

    import jax
    import wide_deep_tpu.optim.sparse as jsparse
    import wide_deep_tpu_torch.optim.sparse as tsparse
    from wide_deep_tpu.config import Config as JConfig
    from wide_deep_tpu.parallel import mesh as mesh_lib
    from wide_deep_tpu.training.loop import Trainer as JTrainer
    from wide_deep_tpu_torch.config import Config as TConfig
    from wide_deep_tpu_torch.training.loop import Trainer as TTrainer
    conf = str(tmp_path / "conf")
    shutil.copytree(os.path.join(REPO, "conf"), conf)
    path = os.path.join(conf, "feature.yaml")
    with open(path) as f:
        text = f.read()
    assert text.count("parameter: 10000000") == 1
    with open(path, "w") as f:
        f.write(text.replace("parameter: 10000000", "parameter: 1000000"))
    for mod in (jsparse, tsparse):
        monkeypatch.setattr(mod, "SPARSE_MIN_ROWS", 1 << 20)
    over = dict(train_data=TRAIN, eval_data=EVAL, test_data=EVAL,
                keep_train=True, batch_size=64, num_examples=4000)
    losses = {"jax": [], "port": []}
    for seed in (123, 1, 2):
        for pkg in ("jax", "port"):
            if pkg == "jax":
                tr = JTrainer(JConfig(conf), model_type,
                              model_dir=str(tmp_path / f"j{seed}"),
                              overrides=over, mesh=mesh_lib.make_mesh(
                                  1, 1, jax.devices()[:1]))
            else:
                tr = TTrainer(TConfig(conf), model_type,
                              model_dir=str(tmp_path / f"t{seed}"),
                              overrides=over, device="cpu")
                tr._gen.manual_seed(seed)
            tr.seed = seed
            assert bool(tr.sparse_tables) == (model_type == "deep")
            tr.ensure_initialized(restore=False)
            for epoch in range(5):
                for f in sorted(os.listdir(TRAIN)):
                    tr.train_file(os.path.join(TRAIN, f), epoch_seed=epoch)
            res = tr.evaluate(EVAL)
            losses[pkg].append(float(res["average_loss"]))
            with capsys.disabled():
                print(f"{model_type} {pkg} seed {seed}: AUC "
                      f"{res['auc']:.4f} logloss {res['average_loss']:.4f} "
                      f"prediction/mean {res['prediction/mean']:.4f}")
            del tr
    jmean, tmean = np.mean(losses["jax"]), np.mean(losses["port"])
    assert abs(tmean - jmean) < 0.06, losses
    assert jmean > 0.60 and tmean > 0.60, losses
