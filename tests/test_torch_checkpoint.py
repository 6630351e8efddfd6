"""The port's checkpoints (training/checkpoint.py, Trainer.save / restore /
pinned evaluate) on the CPU.

Within the port everything is bit for bit: a save/restore round trip gives
every leaf's bits back (the fused table is stored at its live width and its
padding is zero after restore), and 2 steps + save + restore in a new
Trainer + 1 step equals 3 uninterrupted steps, with and without dropout.

Against the JAX package (its orbax checkpoints; the port never reads
them): the same resume sequence from the same ``from_jax`` weights ends
within the tolerance of test_torch_trainer.test_trainer_matches_jax (params
rtol 1e-4 / atol 1e-5); a pinned and a latest evaluate give the JAX
package's metrics on the same steps within rtol 1e-4 (``auc``: 1e-4
absolute), float32 round-off of the training before them; the inspector's
``params/`` and ``mstate/`` names, shapes and dtypes equal JAX
``inspect_checkpoint``'s.
"""

import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from paths import TRAIN1  # noqa: E402
from test_torch_features import force_plans, leaves, write_conf  # noqa: E402

B = 16


def _rows(tmp_path, name, n, start=0):
    path = str(tmp_path / name)
    with open(TRAIN1) as f:
        lines = [line for line in f if line.strip()][start:start + n]
    with open(path, "w") as out:
        out.writelines(lines)
    return path


def _overrides(data, **over):
    out = dict(train_data=data, eval_data=data, test_data=data,
               keep_train=True, batch_size=B, pack_budget=3,
               sparse_optimizer=True, scatter_mode="pallas")
    out.update(over)
    return out


# model.yaml lines the "adam" and "fm" cases replace
OTHER_CONFIGS = {
    "adam": {"linear_optimizer: {name: Ftrl": "linear_optimizer: {name: Adam",
             "dnn_optimizer: Adagrad": "dnn_optimizer: Adam"},
    "fm": {"linear_fm_factors: 0": "linear_fm_factors: 4"}}


def _conf(tmp_path, dropout=0.0, case=None):
    conf_dir = write_conf(tmp_path / "conf")
    path = os.path.join(conf_dir, "model.yaml")
    with open(path) as f:
        text = f.read()
    if dropout:
        text = text.replace("dnn_dropout:", f"dnn_dropout: {dropout}")
    for old, new in OTHER_CONFIGS.get(case, {}).items():
        assert old in text, old
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    return conf_dir


def _port(conf_dir, model_dir, data, **over):
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.features.pipeline import FeatureTransformer
    from wide_deep_tpu_torch.training.loop import Trainer
    tr = Trainer(Config(conf_dir), model_type="wide_deep",
                 model_dir=str(model_dir), overrides=_overrides(data, **over),
                 device="cpu")
    # the Python loader, as on the JAX side of the parity tests
    tr.transformer = FeatureTransformer(tr.plan, tr.n_classes,
                                        tr.pos_weight, tr.neg_weight)
    return tr


def _jax(conf_dir, model_dir, data, **over):
    from wide_deep_tpu.config import Config
    from wide_deep_tpu.features.pipeline import FeatureTransformer
    from wide_deep_tpu.parallel import mesh as mesh_lib
    from wide_deep_tpu.training.loop import Trainer
    tr = Trainer(Config(conf_dir), model_type="wide_deep",
                 model_dir=str(model_dir),
                 mesh=mesh_lib.make_mesh(1, 1, jax.devices()[:1]),
                 overrides=_overrides(data, **over))
    tr.transformer = FeatureTransformer(tr.plan, tr.n_classes,
                                        tr.pos_weight, tr.neg_weight)
    return tr


def _bits(t):
    t = t.detach()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _assert_state_equal(a, b):
    """Every leaf of params, BN state and optimizer state, bit for bit;
    the step counts and the global step too."""
    for what in ("params", "mstate", "opt_state"):
        la, lb = leaves(getattr(a, what)), leaves(getattr(b, what))
        assert sorted(map(str, la)) == sorted(map(str, lb)), what
        for path, va in la.items():
            vb = lb[path]
            if isinstance(va, torch.Tensor):
                assert va.dtype == vb.dtype, (what, path)
                assert torch.equal(_bits(va), _bits(vb)), (what, path)
            else:
                assert va == vb, (what, path)
    assert a.global_step == b.global_step


# --------------------------------------------------------------- manager
def _mgr(tmp_path, **rc):
    from wide_deep_tpu_torch.training.checkpoint import CheckpointManager
    base = {"save_checkpoints_steps": None, "save_checkpoints_secs": None,
            "keep_checkpoint_max": 5, "keep_checkpoint_every_n_hours": 10000}
    base.update(rc)
    return CheckpointManager(str(tmp_path / "m"), base)


def _on_disk(mgr):
    return sorted(int(d) for d in os.listdir(mgr.model_dir) if d.isdigit())


@pytest.mark.parametrize("case", ["step_cadence", "time_cadence",
                                  "retention", "forced_save_survives",
                                  "keep_hours", "resave_is_noop"])
def test_cadence_and_retention(tmp_path, monkeypatch, case):
    """tests/test_edges.py:14-70's cases, plus keep_checkpoint_every_n_hours
    (orbax's keep_time_interval) and a save of a step already on disk."""
    from wide_deep_tpu_torch.training import checkpoint as ck
    if case == "step_cadence":
        mgr = _mgr(tmp_path, save_checkpoints_steps=10)
        assert mgr.should_save(10)
        assert not mgr.should_save(11)
        assert mgr.should_save(20)
        mgr.save(20, {"w": torch.ones(3)})
        assert not mgr.should_save(20)      # just saved
    elif case == "time_cadence":
        mgr = _mgr(tmp_path, save_checkpoints_secs=3600)
        assert not mgr.should_save(5)       # interval not elapsed
        mgr._last_save_time = time.time() - 7200
        assert mgr.should_save(5)
        assert not _mgr(tmp_path / "none").should_save(5)   # neither set
    elif case == "retention":
        mgr = _mgr(tmp_path, save_checkpoints_steps=1, keep_checkpoint_max=2)
        for step in range(1, 5):
            mgr.save(step, {"w": torch.ones(3) * step}, force=True)
        assert _on_disk(mgr) == mgr.all_steps() == [3, 4]
        # cadenced (async) saves count committed steps the same way
        for step in (5, 6):
            mgr.save(step, {"w": torch.ones(3) * step})
        assert mgr.all_steps() == [5, 6]
    elif case == "forced_save_survives":
        mgr = _mgr(tmp_path, keep_checkpoint_max=2)
        for step in (1, 2, 3):
            mgr.save(step, {"w": torch.ones(3) * step}, force=True)
        del mgr                             # no wait, no close
        fresh = _mgr(tmp_path, keep_checkpoint_max=2)
        assert fresh.latest_step() == 3
        w = torch.zeros(3)
        restored = fresh.restore({"w": w})
        assert restored["w"] is w and torch.equal(w, torch.full((3,), 3.0))
        mgr = fresh
    elif case == "keep_hours":
        clock = [0.0]
        monkeypatch.setattr(ck.time, "time", lambda: clock[0])
        mgr = _mgr(tmp_path, keep_checkpoint_max=2,
                   keep_checkpoint_every_n_hours=1)
        assert mgr.keep_secs == 3600
        for step in range(1, 8):            # one save every 25 minutes
            clock[0] = step * 1500.0
            mgr.save(step, {"w": torch.ones(3)}, force=True)
        # the newest two, plus the first and each one saved an hour or
        # more after the last one so kept (steps 1, 4, 7: 1500, 6000 and
        # 10500 s)
        assert mgr.all_steps() == [1, 4, 6, 7]
        # 10000 hours and more turn the rule off, as in the JAX package
        assert _mgr(tmp_path / "x",
                    keep_checkpoint_every_n_hours=10000).keep_secs is None
    else:
        mgr = _mgr(tmp_path)
        mgr.save(7, {"w": torch.ones(3)}, force=True)
        stamp = os.path.getmtime(os.path.join(mgr.model_dir, "7",
                                              ck.TENSORS_FILE))
        mgr.save(7, {"w": torch.zeros(3)}, force=True)
        assert os.path.getmtime(os.path.join(
            mgr.model_dir, "7", ck.TENSORS_FILE)) == stamp
        w = torch.zeros(3)
        mgr.restore({"w": w})
        assert torch.equal(w, torch.ones(3))
    mgr.close()


def test_save_copies_before_returning(tmp_path):
    """The host copy is taken inside save: changing the live tensor right
    after (as the next step does, in place) changes nothing on disk; a view
    is stored as a tensor of its own size; ints and bfloat16 round-trip."""
    from wide_deep_tpu_torch.training.checkpoint import load_tensors
    mgr = _mgr(tmp_path)
    big = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    tree = {"v": big[:, :2], "h": torch.ones(5, dtype=torch.bfloat16) / 3,
            "count": 12, "nested": {"l": [torch.zeros(2), 4]}}
    mgr.save(1, tree)
    big.add_(100.0)
    tree["h"].zero_()
    mgr.wait()
    on_disk = load_tensors(mgr.model_dir, 1)
    assert on_disk["v"].untyped_storage().nbytes() == 8 * 2 * 4
    assert torch.equal(on_disk["v"],
                       torch.arange(64.).reshape(8, 8)[:, :2])
    target = {"v": torch.zeros(8, 2), "h": torch.zeros(5, dtype=torch.bfloat16),
              "count": 0, "nested": {"l": [torch.ones(2), 0]}}
    mgr.restore(target)
    assert torch.equal(target["v"], torch.arange(64.).reshape(8, 8)[:, :2])
    assert torch.equal(_bits(target["h"]),
                       _bits(torch.ones(5, dtype=torch.bfloat16) / 3))
    assert target["count"] == 12 and target["nested"]["l"][1] == 4
    with open(os.path.join(mgr.model_dir, "1", "index.json")) as f:
        index = json.load(f)
    assert index["tensors"]["h"] == {"shape": [5], "dtype": "bfloat16"}
    assert index["ints"] == {"count": 12, "nested/l/1": 4}


def test_restore_checks_names_shapes_dtypes(tmp_path):
    mgr = _mgr(tmp_path)
    mgr.save(1, {"a": torch.ones(3), "b": torch.ones(2)}, force=True)
    a = torch.zeros(3)
    with pytest.raises(ValueError, match="b: the checkpoint holds"):
        mgr.restore({"a": a, "b": torch.zeros(4)})
    assert torch.equal(a, torch.zeros(3))   # nothing written before
    with pytest.raises(ValueError, match="b: the checkpoint holds"):
        mgr.restore({"a": a, "b": torch.zeros(2, dtype=torch.float64)})
    with pytest.raises(ValueError, match="lacks"):
        mgr.restore({"a": a})
    with pytest.raises(ValueError, match="no tensor c"):
        mgr.restore({"a": a, "b": torch.zeros(2), "c": torch.zeros(1)})
    assert _mgr(tmp_path / "empty").restore({"a": a}) is None


def test_leftover_temp_dir_is_not_a_step(tmp_path):
    """A write that died before its rename leaves a hidden temporary
    directory: no step."""
    from wide_deep_tpu_torch.training.checkpoint import committed_steps
    mgr = _mgr(tmp_path)
    mgr.save(2, {"w": torch.ones(2)}, force=True)
    dead = os.path.join(mgr.model_dir, ".4.tmp-12345")
    os.makedirs(dead)
    with open(os.path.join(dead, "tensors.pt"), "wb") as f:
        f.write(b"half")
    os.makedirs(os.path.join(mgr.model_dir, "6"))    # no index: not done
    assert mgr.all_steps() == [2] == committed_steps(mgr.model_dir)
    assert mgr.latest_step() == 2


def test_writer_error_raised_by_next_wait(tmp_path, monkeypatch):
    from wide_deep_tpu_torch.training import checkpoint as ck
    mgr = _mgr(tmp_path)

    def broken(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(ck.torch, "save", broken)
    mgr.save(3, {"w": torch.ones(2)})       # returns; the writer fails
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()                              # raised once, not dropped
    assert mgr.all_steps() == []
    mgr.save(3, {"w": torch.ones(2)})
    with pytest.raises(OSError, match="disk full"):
        mgr.latest_step()                   # any waiting call raises it
    monkeypatch.undo()
    mgr.save(3, {"w": torch.ones(2)}, force=True)
    assert mgr.all_steps() == [3]


# ---------------------------------------------------------------- Trainer
def test_round_trip_bit_exact(tmp_path, monkeypatch):
    """Train 2 steps, save; a new Trainer restores: every leaf's bits, the
    counts and the generator state come back.  The fused table (d8 here)
    is its live width on disk, (1 + 1 Adagrad slot) x 8 = 16 columns of
    128, and its padding is zero after restore."""
    from wide_deep_tpu_torch.ops.rowdma import FUSED_WIDTH
    from wide_deep_tpu_torch.optim import tree_get
    from wide_deep_tpu_torch.optim.sparse import (fused_live_width,
                                                  fused_width)
    from wide_deep_tpu_torch.training.checkpoint import inspect_checkpoint
    force_plans(monkeypatch, "range")
    conf = _conf(tmp_path, dropout=0.5)
    data = _rows(tmp_path, "train", 2 * B)
    a = _port(conf, tmp_path / "m", data)
    a.train_file(data)
    a.save()
    assert a.global_step == 2
    tables = list(a.sparse_tables.values())
    assert tables and all(
        tree_get(a.params, t.path).shape[1] == fused_width(t.spec, t.dim)
        for t in tables)
    on_disk = inspect_checkpoint(a.model_dir)
    for t in tables:
        width = fused_live_width(t.spec, t.dim)
        assert width == 2 * t.dim < FUSED_WIDTH
        assert on_disk["params/" + "/".join(t.path)].shape[1] == width
    assert on_disk["step"] == 2
    assert on_disk["opt_state/dense/dnn/count"] == 2

    b = _port(conf, tmp_path / "m", data)
    b.ensure_initialized()                  # restores the latest
    _assert_state_equal(a, b)
    assert b.opt_state["sparse"]["dnn.embed.d8"]["count"] == 2
    assert torch.equal(a._gen.get_state(), b._gen.get_state())
    for t in tables:
        live = b.params["dnn"]["embed"][t.path[-1]]
        assert live.shape[1] == FUSED_WIDTH
        assert not live[:, fused_live_width(t.spec, t.dim):].any()


@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_resume_equals_uninterrupted(tmp_path, monkeypatch, dropout):
    """2 steps, save, a new Trainer restores, 1 step == 3 steps in one
    Trainer, bit for bit: with dropout only because the generator's state
    is in the checkpoint."""
    force_plans(monkeypatch, "range")
    conf = _conf(tmp_path, dropout=dropout)
    data = _rows(tmp_path, "train", 3 * B)
    whole = _port(conf, tmp_path / "whole", data)
    batches = list(whole._dataset(data, "train"))
    assert len(batches) == 3
    for b in batches:
        whole.train_batch(b)

    first = _port(conf, tmp_path / "resumed", data)
    for b in batches[:2]:
        first.train_batch(b)
    first.save()
    second = _port(conf, tmp_path / "resumed", data)
    second.ensure_initialized()
    assert second.global_step == 2
    second.train_batch(batches[2])
    _assert_state_equal(whole, second)
    assert torch.equal(whole._gen.get_state(), second._gen.get_state())
    assert float(list(whole.losses)[-1]) == float(list(second.losses)[-1])
    if dropout:
        # the generator matters: a resume that drew other masks differs
        third = _port(conf, tmp_path / "resumed", data)
        third.ensure_initialized()
        third._gen.manual_seed(third.seed)
        third.train_batch(batches[2])
        assert float(list(third.losses)[-1]) != float(
            list(whole.losses)[-1])


@pytest.mark.parametrize("case", ["adam", "fm"])
def test_round_trip_and_resume_other_configs(tmp_path, monkeypatch, case):
    """Adam on both arms (the plan's sparse optimizer goes off: Adam is
    not sparse-capable) and the FM term: a save / restore round trip gives
    every leaf's bits back, and 2 steps + save + restore + 1 step equals
    3 uninterrupted steps, bit for bit.  The inspector names the new
    states."""
    from wide_deep_tpu_torch.training.checkpoint import inspect_checkpoint
    force_plans(monkeypatch, "range")
    conf = _conf(tmp_path, dropout=0.5, case=case)
    data = _rows(tmp_path, "train", 3 * B)
    whole = _port(conf, tmp_path / "whole", data)
    batches = list(whole._dataset(data, "train"))
    assert len(batches) == 3
    for b in batches:
        whole.train_batch(b)
    first = _port(conf, tmp_path / "resumed", data)
    for b in batches[:2]:
        first.train_batch(b)
    first.save()
    again = _port(conf, tmp_path / "resumed", data)
    again.ensure_initialized()
    _assert_state_equal(first, again)
    assert torch.equal(first._gen.get_state(), again._gen.get_state())
    again.train_batch(batches[2])
    _assert_state_equal(whole, again)
    assert float(list(whole.losses)[-1]) == float(list(again.losses)[-1])
    names = set(inspect_checkpoint(first.model_dir))
    if case == "adam":
        assert not first.sparse_tables and not first.plan.sparse_opt
        for slot in ("mu", "nu"):
            assert f"opt_state/dense/linear/{slot}/linear/w" in names
            assert (f"opt_state/dense/dnn/{slot}/dnn/towers/0/hidden/0/"
                    f"kernel") in names
        assert not any("/accum/" in n for n in names)
    else:
        assert not first.plan.fold
        assert "params/linear/v" in names
        assert "opt_state/dense/linear/accum/linear/v" in names
        assert "opt_state/dense/linear/linear/linear/v" in names


def _jax_and_port_resume(tmp_path, monkeypatch):
    """The same resume through both packages from the same weights: 2
    steps on one file, save, a new Trainer restores the latest, 1 step on
    another file."""
    from wide_deep_tpu_torch.interop import from_jax
    force_plans(monkeypatch, "range")
    conf = _conf(tmp_path)
    first = _rows(tmp_path, "first", 2 * B)
    second = _rows(tmp_path, "second", B, start=2 * B)
    j1 = _jax(conf, tmp_path / "jax", first)
    j1.ensure_initialized(restore=False)
    t1 = _port(conf, tmp_path / "port", first)
    t1.params, t1.mstate = from_jax(jax.device_get(j1.params),
                                    jax.device_get(j1.mstate), device="cpu")
    for tr in (j1, t1):
        tr.train_file(first)
        tr.save()
    j2 = _jax(conf, tmp_path / "jax", second)
    j2.ensure_initialized()
    t2 = _port(conf, tmp_path / "port", second)
    t2.ensure_initialized()
    assert j2.global_step == t2.global_step == 2
    for tr in (j2, t2):
        tr.train_file(second)
    return j2, t2


def test_resume_matches_jax(tmp_path, monkeypatch):
    from test_torch_features import assert_trees_close
    from wide_deep_tpu_torch.interop import to_numpy
    j2, t2 = _jax_and_port_resume(tmp_path, monkeypatch)
    assert j2.global_step == t2.global_step == 3
    assert_trees_close(jax.device_get(j2.params), to_numpy(t2.params),
                       rtol=1e-4, atol=1e-5, what="params")


def test_inspector_matches_jax(tmp_path, monkeypatch, capsys):
    """The port's inspector and JAX inspect_checkpoint list the same
    ``params/`` and ``mstate/`` leaves with the same shapes and dtypes.
    ``opt_state`` names differ on purpose: optax's state tree is not the
    port's ({dense: {arm: {count, accum, linear}}, sparse: {...}}), and
    the port adds ``rng``."""
    from wide_deep_tpu.training.checkpoint import inspect_checkpoint as jic
    from wide_deep_tpu_torch.tools import inspect_checkpoint as tool
    j2, t2 = _jax_and_port_resume(tmp_path, monkeypatch)
    for tr in (j2, t2):
        tr.save()
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in jic(j2.model_dir).items()
            if k.startswith(("params/", "mstate/"))}
    capsys.readouterr()
    got_all = tool.main(["--model_dir", t2.model_dir])
    printed = capsys.readouterr().out.splitlines()
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in got_all.items()
           if k.startswith(("params/", "mstate/"))}
    assert len(want) > 10 and got == want
    assert any(k.startswith("mstate/bn/") for k in got)
    assert len(printed) == len(got_all)
    for line, name in zip(printed, sorted(got_all)):
        assert line.startswith(name + "  shape=")
    only = tool.main(["--model_dir", t2.model_dir, "--tensor_name",
                      "linear/b", "--print_values"])
    assert sorted(only) == ["opt_state/dense/linear/accum/linear/b",
                            "opt_state/dense/linear/linear/linear/b",
                            "params/linear/b"]


def _pinned_sequence(tr, data):
    """tests/test_round2_fixes.py:82-105: train, save (old step), train 3
    more passes, save; -> (old step, old metrics, new step)."""
    tr.ensure_initialized(restore=False)
    tr.train_file(data)
    tr.save()
    old_step, old = tr.global_step, tr.evaluate(data)
    for _ in range(3):
        tr.train_file(data)
    tr.save()
    return old_step, old, tr.global_step


def test_pinned_and_latest_evaluate_match_jax(tmp_path, monkeypatch):
    from wide_deep_tpu_torch.interop import from_jax
    force_plans(monkeypatch, "range")
    conf = _conf(tmp_path)
    data = _rows(tmp_path, "train", 2 * B)
    jtr = _jax(conf, tmp_path / "jax", data)
    jtr.ensure_initialized(restore=False)
    ttr = _port(conf, tmp_path / "port", data)
    ttr.params, ttr.mstate = from_jax(jax.device_get(jtr.params),
                                      jax.device_get(jtr.mstate),
                                      device="cpu")
    j_old_step, j_old, j_new = _pinned_sequence(jtr, data)
    t_old_step, t_old, t_new = _pinned_sequence(ttr, data)
    assert (t_old_step, t_new) == (j_old_step, j_new) == (2, 8)
    results = {}
    for name, tr in (("jax", jtr), ("port", ttr)):
        pinned = tr.evaluate(data, checkpoint_path=os.path.join(
            tr.model_dir, str(t_old_step)))
        latest = tr.evaluate(data, checkpoint_path=tr.model_dir)
        assert pinned["global_step"] == t_old_step
        assert latest["global_step"] == t_new
        results[name] = (pinned, latest)
    # within the port, the pinned step's metrics are the old model's
    assert results["port"][0] == dict(t_old, global_step=t_old_step)
    for got, want in zip(results["port"], results["jax"]):
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            if k in ("auc", "auc_precision_recall"):
                assert abs(got[k] - v) <= 1e-4, (k, got[k], v)
            else:
                np.testing.assert_allclose(got[k], v, rtol=1e-4, err_msg=k)
    # predict from a pinned step: the old model's predictions
    preds = [p["logistic"] for p in ttr.predict(
        data, checkpoint_path=os.path.join(ttr.model_dir, "2"))]
    assert ttr.global_step == 2 and len(preds) == 2 * B


def test_missing_checkpoint_raises(tmp_path, monkeypatch):
    force_plans(monkeypatch, "range")
    data = _rows(tmp_path, "train", B)
    tr = _port(_conf(tmp_path), tmp_path / "m", data)
    tr.ensure_initialized(restore=False)
    tr.save()
    with pytest.raises(FileNotFoundError, match="available steps"):
        tr.evaluate(data, checkpoint_path=os.path.join(tr.model_dir,
                                                       "99999"))
    with pytest.raises(FileNotFoundError):
        list(tr.predict(data, checkpoint_path=str(tmp_path / "nothing")))


@pytest.mark.parametrize("path,want", [
    ("/m/dir/42", ("/m/dir", 42)),
    ("/m/dir/", ("/m/dir", None)),
    ("/m/dir/42/", ("/m/dir", 42)),
    ("/m/wide_deep", ("/m/wide_deep", None)),
])
def test_resolve_checkpoint(path, want):
    from wide_deep_tpu.training.loop import resolve_checkpoint as jrc
    from wide_deep_tpu_torch.training.loop import resolve_checkpoint
    assert resolve_checkpoint(path) == jrc(path) == want


def test_plan_meta_written_once(tmp_path, monkeypatch):
    """The record of the plan the params trained with is written by the
    first Trainer of a model dir; a later one with another plan leaves it;
    a wiped dir gets a new record.  The same file as the JAX package's."""
    from wide_deep_tpu.features.analyze import load_plan_meta as jload
    from wide_deep_tpu_torch.features.analyze import (PLAN_META_FILE,
                                                      load_plan_meta)
    force_plans(monkeypatch, "range")
    conf = _conf(tmp_path)
    data = _rows(tmp_path, "train", B)
    a = _port(conf, tmp_path / "m", data)
    assert load_plan_meta(a.model_dir) is None
    a.ensure_initialized()
    want = {"pack_budget": 3, "fold": True, "multivalue": True}
    assert load_plan_meta(a.model_dir) == jload(a.model_dir) == want
    b = _port(conf, tmp_path / "m", data, pack_budget=2)
    b.ensure_initialized()
    assert load_plan_meta(b.model_dir)["pack_budget"] == 3
    c = _port(conf, tmp_path / "m", data, pack_budget=2, keep_train=False)
    c.maybe_wipe_model_dir()
    assert not os.path.exists(os.path.join(c.model_dir, PLAN_META_FILE))
    c.ensure_initialized()
    assert load_plan_meta(c.model_dir)["pack_budget"] == 2
