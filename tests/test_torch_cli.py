"""The port's CLIs (``python -m wide_deep_tpu_torch.tools.{train,eval,pred,
inspect_checkpoint}``) and estimator facade, on the CPU.

* train -> eval (pinned and latest) -> pred -> inspect through each tool's
  ``main(argv)`` with ``--device cpu``: checkpoints at the conf's cadence
  and retention, the latest eval equal to the trained Trainer's own
  evaluate, pred's lines in the JAX tools/pred.py format
  (``<i>\\tclass: <c>\\tprobability: <p>``);
* ``--help`` of each tool, the ``--conf_dir`` pre-scan, the warning for an
  unknown flag, the refusal of a multi-process launch, Ctrl-C saving then
  exiting 130;
* the estimator surface as tests/test_estimator.py has it, its export read
  back by ``load_bundle`` and served, and the dense ProximalAdagrad
  its canned builder uses against the JAX package's (the same float32
  formula, which XLA fuses and rounds in another order: rtol 1e-5).
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paths import UNIT_FIXTURE  # noqa: E402

B = 8


def _setup(tmp_path, monkeypatch, **runconfig):
    """A small conf with the given runconfig lines, generated train (two
    files), eval and test data; the working directory moved to tmp_path
    (the train tool writes logs/train.pid there).  -> the common argv."""
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.testing import generate_ctr_tsv, write_small_conf
    monkeypatch.chdir(tmp_path)
    conf = write_small_conf(str(tmp_path / "conf"), batch_size=B)
    path = os.path.join(conf, "train.yaml")
    with open(path) as f:
        text = f.read()
    for key, value in runconfig.items():
        text = re.sub(rf"(\n  {key}:)[^\n]*", rf"\1 {value}", text)
    with open(path, "w") as f:
        f.write(text)
    config = Config(conf)
    os.makedirs(tmp_path / "train")
    for i in (1, 2):
        generate_ctr_tsv(config, str(tmp_path / "train" / f"part{i}"),
                         2 * B, seed=i)
    generate_ctr_tsv(config, str(tmp_path / "eval"), B + 3, seed=3)
    generate_ctr_tsv(config, str(tmp_path / "test"), B + 5, seed=4)
    return ["--conf_dir", conf, "--device", "cpu",
            "--model_dir", str(tmp_path / "m"),
            "--train_data", str(tmp_path / "train"),
            "--eval_data", str(tmp_path / "eval"),
            "--test_data", str(tmp_path / "test")]


def test_train_eval_pred_inspect(tmp_path, monkeypatch, capsys):
    from wide_deep_tpu_torch.tools import eval as eval_tool
    from wide_deep_tpu_torch.tools import inspect_checkpoint, pred, train
    argv = _setup(tmp_path, monkeypatch, save_checkpoints_steps=2,
                  save_checkpoints_secs="", keep_checkpoint_max=2,
                  save_summary_steps=2, log_step_count_steps=1)
    trainer = train.main(argv + ["--keep_train", "0", "--train_epochs", "2",
                                 "--dynamic_train", "0"])
    model_dir = str(tmp_path / "m" / "wide_deep")
    assert trainer.model_dir == model_dir and trainer.global_step == 8
    # saves at 2, 4, 6, 8 (the end-of-epoch saves were no-ops); the newest
    # 2 kept, and the first by the conf's keep_checkpoint_every_n_hours: 1
    assert trainer._ckpt.all_steps() == [2, 6, 8]
    assert os.path.exists(tmp_path / "logs" / "train.pid")
    assert os.listdir(os.path.join(model_dir, "summaries"))
    capsys.readouterr()

    pinned = eval_tool.main(argv + ["--checkpoint_path",
                                    os.path.join(model_dir, "6")])
    latest = eval_tool.main(argv + ["--checkpoint_path", model_dir])
    out = capsys.readouterr().out
    assert pinned["global_step"] == 6 and latest["global_step"] == 8
    assert latest == trainer.evaluate(str(tmp_path / "test"))
    assert pinned != latest
    for res in (pinned, latest):
        assert all(np.isfinite(v) for v in res.values())
        assert 0.0 <= res["auc"] <= 1.0
    assert "auc: " in out and "global_step: 8" in out
    # without --checkpoint_path: the latest
    assert eval_tool.main(argv) == latest

    capsys.readouterr()
    assert pred.main(argv) == B + 5
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == B + 5
    for i, line in enumerate(lines):
        assert re.fullmatch(rf"{i}\tclass: [01]\tprobability: \d\.\d{{6}}",
                            line), line
    # pred reads the latest checkpoint: the trained Trainer's predictions
    want = [p for p in trainer.predict(str(tmp_path / "test"))]
    for line, p in zip(lines, want):
        c = int(p["class_ids"])
        assert line.endswith(f"class: {c}\tprobability: "
                             f"{float(p['probabilities'][c]):.6f}")

    leaves = inspect_checkpoint.main(["--model_dir", model_dir])
    listed = capsys.readouterr().out.splitlines()
    assert len(listed) == len(leaves) > 20
    assert leaves["step"] == 8
    assert "params/dnn/towers/0/hidden/0/kernel" in leaves
    pinned_leaves = inspect_checkpoint.main(["--model_dir", model_dir,
                                             "--step", "6",
                                             "--tensor_name", "step"])
    assert pinned_leaves == {"step": 6}


@pytest.mark.parametrize("edit", [
    ("linear_fm_factors: 0", "linear_fm_factors: 4"),
    ("dnn_optimizer: Adagrad", "dnn_optimizer: Adam")],
    ids=["fm", "adam"])
def test_train_other_configs(tmp_path, monkeypatch, edit):
    """The train CLI on a conf with the FM term, and on one whose deep arm
    takes Adam: every step's loss finite, the checkpoint holds the new
    state, and eval reads it back."""
    from wide_deep_tpu_torch.tools import eval as eval_tool
    from wide_deep_tpu_torch.tools import train
    from wide_deep_tpu_torch.training.checkpoint import inspect_checkpoint
    argv = _setup(tmp_path, monkeypatch)
    conf = argv[argv.index("--conf_dir") + 1]
    path = os.path.join(conf, "model.yaml")
    with open(path) as f:
        text = f.read()
    assert edit[0] in text
    with open(path, "w") as f:
        f.write(text.replace(*edit))
    trainer = train.main(argv + ["--keep_train", "0", "--train_epochs", "1",
                                 "--dynamic_train", "0"])
    assert trainer.global_step == 4
    assert all(np.isfinite(float(x)) for x in trainer.losses)
    names = set(inspect_checkpoint(trainer.model_dir))
    if "fm" in edit[1]:
        assert "params/linear/v" in names and not trainer.plan.fold
    else:
        assert any(n.startswith("opt_state/dense/dnn/mu/") for n in names)
    res = eval_tool.main(argv + ["--checkpoint_path", trainer.model_dir])
    assert res["global_step"] == 4 and np.isfinite(res["loss"])


@pytest.mark.parametrize("tool", ["train", "eval", "pred",
                                  "inspect_checkpoint"])
def test_help(tool, capsys):
    import importlib
    mod = importlib.import_module(f"wide_deep_tpu_torch.tools.{tool}")
    with pytest.raises(SystemExit) as e:
        mod.main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "--model_dir" in out
    assert ("--device" in out) == (tool != "inspect_checkpoint")


def _jax_common():
    """The JAX package's tools/common.py, loaded by path."""
    import importlib.util

    from paths import REPO
    spec = importlib.util.spec_from_file_location(
        "jax_tools_common", os.path.join(REPO, "tools", "common.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_conf_dir_prescan(tmp_path, monkeypatch):
    """Defaults come from the conf dir named on the command line (or by
    WIDE_DEEP_CONF_DIR), not from the default one; they are the JAX CLI's
    for the same conf, and the command line overrides them."""
    import sys

    from wide_deep_tpu_torch.testing import write_small_conf
    from wide_deep_tpu_torch.tools.common import base_parser, overrides_from
    conf = write_small_conf(str(tmp_path / "conf"), batch_size=77)
    argv = ["--conf_dir", conf]
    p, config = base_parser("t", argv)
    args = p.parse_args(argv)
    assert config.conf_dir == conf and args.batch_size == 77
    assert args.device is None
    monkeypatch.setattr(sys, "argv", ["train.py"] + argv)
    jp, _ = _jax_common().base_parser("t")
    jargs = vars(jp.parse_known_args()[0])
    shared = {k: v for k, v in vars(args).items() if k in jargs}
    assert len(shared) == len(vars(args)) - 1          # all but --device
    assert shared == {k: jargs[k] for k in shared}
    assert args.batch_size != base_parser("t", [])[0].parse_args([]).batch_size
    over = p.parse_args(argv + ["--batch_size", "5"])
    assert overrides_from(over)["batch_size"] == 5
    monkeypatch.setenv("WIDE_DEEP_CONF_DIR", conf)
    p, _ = base_parser("t", [])
    assert p.parse_args([]).batch_size == 77


def test_unknown_flag_warns(tmp_path, monkeypatch, capsys):
    from wide_deep_tpu_torch.tools import eval as eval_tool
    argv = _setup(tmp_path, monkeypatch)
    res = eval_tool.main(argv + ["--bacth_size", "4"])
    out = capsys.readouterr().out
    assert "WARNING: ignoring unrecognized arguments: ['--bacth_size', '4']" \
        in out
    assert res["global_step"] == 0


def test_distributed_launch_raises(tmp_path, monkeypatch):
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.tools import train
    from wide_deep_tpu_torch.tools.common import maybe_init_distributed
    argv = _setup(tmp_path, monkeypatch)
    monkeypatch.setenv("WDT_COORDINATOR", "localhost:1234")
    monkeypatch.setenv("WDT_NUM_PROCESSES", "4")
    with pytest.raises(NotImplementedError, match="4 processes"):
        train.main(argv)
    assert not os.path.exists(tmp_path / "m")
    monkeypatch.delenv("WDT_COORDINATOR")
    monkeypatch.delenv("WDT_NUM_PROCESSES")
    conf = Config(argv[1])
    assert not maybe_init_distributed(conf)["is_distribution"]
    dist = maybe_init_distributed(conf, force=True)  # one process: runs
    assert dist["is_distribution"] and dist["num_processes"] == 1


def test_interrupt_saves_and_exits_130(tmp_path, monkeypatch, capsys):
    from wide_deep_tpu_torch.tools import train
    from wide_deep_tpu_torch.training import loop
    argv = _setup(tmp_path, monkeypatch)

    def interrupted(self):
        self.train_file(self.train_conf["eval_data"])
        raise KeyboardInterrupt

    monkeypatch.setattr(loop.Trainer, "train_and_eval", interrupted)
    with pytest.raises(SystemExit) as e:
        train.main(argv + ["--dynamic_train", "0"])
    assert e.value.code == 130
    assert "interrupted at step 2; saving checkpoint" in capsys.readouterr().out
    from wide_deep_tpu_torch.training.checkpoint import committed_steps
    assert committed_steps(str(tmp_path / "m" / "wide_deep")) == [2]


# ------------------------------------------------------------- estimator
def _est_overrides():
    return dict(train_data=UNIT_FIXTURE, eval_data=UNIT_FIXTURE,
                test_data=UNIT_FIXTURE, keep_train=True, batch_size=16)


def _small(tmp_path):
    from wide_deep_tpu_torch.testing import small_config
    return small_config(str(tmp_path / "conf"))


def test_wide_and_deep_classifier(tmp_path):
    from wide_deep_tpu_torch.estimator import WideAndDeepClassifier
    est = WideAndDeepClassifier(str(tmp_path / "m"), "wide_deep",
                                config=_small(tmp_path),
                                overrides=_est_overrides(), device="cpu")
    est.train(UNIT_FIXTURE)
    first = est.evaluate(UNIT_FIXTURE)
    est.train(UNIT_FIXTURE, epochs=10)
    final = est.evaluate(UNIT_FIXTURE)
    assert final["loss"] < first["loss"]
    assert est.global_step == 11
    assert len(list(est.predict(UNIT_FIXTURE))) == 10
    # export: the saved step as a bundle that load_bundle reads back, whose
    # forward gives the estimator's predictions
    from wide_deep_tpu_torch.serving.export import load_bundle
    from wide_deep_tpu_torch.serving.server import ServingModel
    path = est.export_savedmodel(str(tmp_path / "export"), model_version=2,
                                 as_text=True)
    assert path == str(tmp_path / "export" / "2")
    assert os.path.exists(os.path.join(path, "params.txt"))
    model, params, _, meta = load_bundle(path, device="cpu")
    assert meta["global_step"] == 11 and model.model_type == "wide_deep"
    assert torch.equal(params["linear"]["w"],
                       est._trainer.params["linear"]["w"])
    served = ServingModel(path, 16, device="cpu")
    try:
        with open(UNIT_FIXTURE) as f:
            rows = [line.rstrip("\n") for line in f if line.strip()]
        got = served.score_rows(rows)["scores"]
    finally:
        served.close()
    want = [p["probabilities"].tolist() for p in est.predict(UNIT_FIXTURE)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # each train() ends with a save: evaluate can pin the first one
    pinned = est.evaluate(UNIT_FIXTURE, checkpoint_path=os.path.join(
        est.model_dir, "1"))
    assert pinned == dict(first, global_step=1)


def test_multi_dnn_classifier(tmp_path):
    from wide_deep_tpu_torch.estimator import MultiDNNClassifier
    est = MultiDNNClassifier(
        str(tmp_path / "m"), hidden_units_list=[[16, 8], [8], [16]],
        connected_mode_list=["simple", "resnet", "dense"],
        config=_small(tmp_path), overrides=_est_overrides(), device="cpu")
    assert len(est._trainer.model.deep_spec.towers) == 3
    assert est._trainer.model_type == "deep"
    est.train(UNIT_FIXTURE)
    assert np.isfinite(est.evaluate(UNIT_FIXTURE)["loss"])


def test_canned_builders(tmp_path):
    """build_estimator's canned optimizers (the JAX package's), and a pass
    of training with them; build_custom_estimator takes the conf's."""
    from wide_deep_tpu.estimator import build_estimator as jbuild
    from wide_deep_tpu_torch.estimator import (build_custom_estimator,
                                               build_estimator)
    config = _small(tmp_path)
    est = build_estimator(str(tmp_path / "m"), "wide_deep", config=config,
                          device="cpu")
    model_conf = est._trainer.config.model
    assert model_conf["linear_optimizer"]["name"] == "Ftrl"
    assert model_conf["linear_optimizer"]["learning_rate"] <= 0.005
    assert model_conf["dnn_optimizer"]["name"] == "ProximalAdagrad"
    want = jbuild(str(tmp_path / "j"), "wide_deep", config=config)
    for key in ("linear_optimizer", "dnn_optimizer", "linear_decay_rate",
                "dnn_decay_rate"):
        assert model_conf[key] == want._trainer.config.model[key], key
    est._trainer.train_conf.update(_est_overrides())
    est._trainer.batch_size = 16
    est.train(UNIT_FIXTURE)
    assert np.isfinite(est.evaluate(UNIT_FIXTURE)["loss"])
    custom = build_custom_estimator(str(tmp_path / "c"), "deep",
                                    config=config, device="cpu")
    assert custom._trainer.model_type == "deep"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_proximal_adagrad_matches_jax(dtype):
    """Two steps of the dense ProximalAdagrad on seeded params and
    gradients against the JAX package's proximal_adagrad (a decaying
    learning rate, l1 and l2 on): params within rtol 1e-5 / atol 1e-7
    (float32) or the same bfloat16 values, accumulators within rtol
    1e-5."""
    import jax.numpy as jnp
    import optax

    from wide_deep_tpu.optim import exponential_decay as jdecay
    from wide_deep_tpu.optim import proximal_adagrad
    from wide_deep_tpu_torch.interop import from_jax, to_numpy
    from wide_deep_tpu_torch.optim import JointOptimizer
    spec = {"name": "ProximalAdagrad", "learning_rate": 0.1,
            "l1_regularization_strength": 0.01,
            "l2_regularization_strength": 0.1}
    rng = np.random.default_rng(2)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    params = {"dnn": {"k": jnp.asarray(rng.normal(size=(6, 5)), jdt),
                      "b": jnp.asarray(rng.normal(size=5) * 1e-3, jdt)}}
    grads = [{"dnn": {k: jnp.asarray(rng.normal(size=v.shape), jdt)
                      for k, v in params["dnn"].items()}} for _ in range(2)]
    tx = proximal_adagrad(jdecay(0.1, 0.5, 1.0), 0.01, 0.1)
    state = tx.init(params)
    jp = params
    for g in grads:
        upd, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
    tparams, _ = from_jax(params, {}, device="cpu")
    opt = JointOptimizer({"dnn_optimizer": spec, "dnn_decay_rate": 0.5,
                          "dnn_initial_learning_rate": 0.1}, 1.0,
                         arms={"dnn": True})
    tstate = opt.init(tparams)
    for g in grads:
        tg, _ = from_jax(g, {}, device="cpu")
        opt.update_(tparams, {("dnn", k): v for k, v in tg["dnn"].items()},
                    tstate)
    got = to_numpy(tparams)
    for k in ("k", "b"):
        want = np.asarray(jp["dnn"][k], np.float32)
        if dtype == "bfloat16":
            np.testing.assert_array_equal(got["dnn"][k], want, err_msg=k)
        else:
            np.testing.assert_allclose(got["dnn"][k], want, rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        np.testing.assert_allclose(
            tstate["dnn"]["accum"][("dnn", k)].numpy(),
            np.asarray(state.accum["dnn"][k], np.float32), rtol=1e-5)
    assert tstate["dnn"]["count"] == 2


# ----------------------------------------------------------------- utils
def test_utils_match_jax(caplog):
    """timer / elapse_time as the JAX package's utils; column_to_dtype
    gives the JAX package's map for the same conf."""
    import logging
    import time

    from paths import REPO
    from wide_deep_tpu.config import Config as JConfig
    from wide_deep_tpu.utils import column_to_dtype as jcol
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.utils import column_to_dtype, elapse_time, timer

    @timer("op done")
    def op():
        return 42

    with caplog.at_level(logging.INFO, "wide_deep_tpu_torch"):
        assert op() == 42
    assert any("op done elapsed" in r.message for r in caplog.records)
    assert elapse_time(time.time() - 2.0) >= 2.0
    conf = os.path.join(REPO, "conf")
    got = column_to_dtype(Config(conf))
    assert got == jcol(JConfig(conf)) and len(got) == 61
    assert got["clk"] == "int64" and got["age"] == "float32"


def test_profile_dir_writes_a_trace(tmp_path, monkeypatch):
    """``--profile_dir``: a torch.profiler Chrome trace of the training."""
    import json

    from wide_deep_tpu_torch.tools import train
    from wide_deep_tpu_torch.utils import profile_trace
    argv = _setup(tmp_path, monkeypatch)
    with profile_trace(None):        # no directory: nothing profiled
        pass
    prof = tmp_path / "prof"
    trainer = train.main(argv + ["--profile_dir", str(prof),
                                 "--train_epochs", "1", "--dynamic_train",
                                 "0"])
    assert trainer.global_step == 4
    (name,) = os.listdir(prof)
    with open(prof / name) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name")) for e in events)
