"""The port's loop modes against the JAX package's (tests/test_loop_modes.py,
tests/test_train.py's cadenced eval): ``train_and_eval``, ``dynamic_train``,
``train`` and ``train_and_evaluate`` over a directory of two train files,
from the same ``from_jax`` weights, both through their Python loaders.

Each mode must run the same evaluations in the same order (which file, at
which step) and checkpoint at the end of each epoch; every eval dict
matches the JAX package's within rtol 1e-4 (``auc`` and
``auc_precision_recall`` 1e-4 absolute): test_torch_eval's tolerance
(rtol 1e-5 from the same params) widened by the float32 round-off of the
training steps before it, as in test_torch_checkpoint's pinned evaluate.
"""

import logging
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from paths import TRAIN1  # noqa: E402
from test_torch_features import force_plans, write_conf  # noqa: E402

B = 16


def _data(tmp_path):
    """Two train files of 2 batches each, an eval file, a test file."""
    with open(TRAIN1) as f:
        lines = [line for line in f if line.strip()]
    train = tmp_path / "train"
    os.makedirs(train)
    paths = {}
    for name, lo, n in (("train/train1", 0, 2 * B), ("train/train2", 40, 2 * B),
                        ("eval", 80, B + 3), ("test", 100, B)):
        with open(tmp_path / name, "w") as out:
            out.writelines(lines[lo:lo + n])
        paths[name] = str(tmp_path / name)
    return str(train), paths["eval"], paths["test"]


def _pair(tmp_path, monkeypatch, **over):
    from wide_deep_tpu.config import Config as JConfig
    from wide_deep_tpu.features.pipeline import FeatureTransformer as JT
    from wide_deep_tpu.parallel import mesh as mesh_lib
    from wide_deep_tpu.training.loop import Trainer as JTrainer
    from wide_deep_tpu_torch.config import Config as TConfig
    from wide_deep_tpu_torch.features.pipeline import FeatureTransformer as TT
    from wide_deep_tpu_torch.interop import from_jax
    from wide_deep_tpu_torch.training.loop import Trainer as TTrainer
    force_plans(monkeypatch, "range")
    conf_dir = write_conf(tmp_path / "conf")
    train, eval_, test = _data(tmp_path)
    overrides = dict(train_data=train, eval_data=eval_, test_data=test,
                     keep_train=True, batch_size=B, train_epochs=1,
                     epochs_per_eval=1, pack_budget=3,
                     sparse_optimizer=True, scatter_mode="pallas")
    overrides.update(over)
    jtr = JTrainer(JConfig(conf_dir), model_type="wide_deep",
                   model_dir=str(tmp_path / "jax"),
                   mesh=mesh_lib.make_mesh(1, 1, jax.devices()[:1]),
                   overrides=overrides)
    ttr = TTrainer(TConfig(conf_dir), model_type="wide_deep",
                   model_dir=str(tmp_path / "torch"), overrides=overrides,
                   device="cpu")
    jtr.transformer = JT(jtr.plan, jtr.n_classes, jtr.pos_weight,
                         jtr.neg_weight)
    ttr.transformer = TT(ttr.plan, ttr.n_classes, ttr.pos_weight,
                         ttr.neg_weight)
    jtr.ensure_initialized(restore=False)
    ttr.params, ttr.mstate = from_jax(jax.device_get(jtr.params),
                                      jax.device_get(jtr.mstate),
                                      device="cpu")
    return jtr, ttr


def _spy_evaluate(tr):
    calls = []
    real = tr.evaluate

    def spy(path=None, **kw):
        res = real(path, **kw)
        calls.append((os.path.basename(path or ""), tr.global_step, res))
        return res

    tr.evaluate = spy
    return calls


def _assert_evals_match(got, want):
    assert [c[:2] for c in got] == [c[:2] for c in want]
    for (name, step, g), (_, _, w) in zip(got, want):
        assert sorted(g) == sorted(w), name
        for k, v in w.items():
            if k in ("auc", "auc_precision_recall"):
                assert abs(g[k] - v) <= 1e-4, (name, step, k, g[k], v)
            else:
                np.testing.assert_allclose(g[k], v, rtol=1e-4,
                                           err_msg=f"{name} {step} {k}")


# mode -> the evaluations it runs, (file, step): 2 steps per train file
EXPECTED = {
    "train_and_eval": [("eval", 2), ("eval", 4), ("test", 4)],
    "train_and_evaluate": [("eval", 2), ("eval", 4), ("test", 4)],
    "dynamic_train": [("train2", 2)],
    "train": [],
}


@pytest.mark.parametrize("mode", sorted(EXPECTED))
def test_mode_matches_jax(tmp_path, monkeypatch, caplog, mode):
    jtr, ttr = _pair(tmp_path, monkeypatch)
    jcalls, tcalls = _spy_evaluate(jtr), _spy_evaluate(ttr)
    with caplog.at_level(logging.INFO, "wide_deep_tpu_torch"):
        getattr(jtr, mode)()
        getattr(ttr, mode)()
    assert [c[:2] for c in tcalls] == EXPECTED[mode]
    _assert_evals_match(tcalls, jcalls)
    assert ttr.global_step == jtr.global_step == 4
    # the forced save at the end of the epoch
    assert ttr._ckpt.latest_step() == jtr._ckpt.latest_step() == 4
    msgs = [r.message for r in caplog.records
            if r.name == "wide_deep_tpu_torch"]
    if mode in ("train_and_eval", "train_and_evaluate"):
        assert any("eval train1" in m for m in msgs)
        assert any("epoch 0 test" in m for m in msgs)
    elif mode == "dynamic_train":
        assert any("dynamic eval on train2" in m for m in msgs)
        assert not any("dynamic eval on train1" in m for m in msgs)


def test_eval_every_n_steps(tmp_path, monkeypatch):
    """Step-cadenced eval fires at its cadence, at the same steps as in the
    JAX package, and writes eval/ summaries; it is off by default."""
    from wide_deep_tpu_torch.training.summary import read_records
    jtr, ttr = _pair(tmp_path, monkeypatch, eval_every_n_steps=3)
    assert ttr.eval_every_n_steps == jtr.eval_every_n_steps == 3
    jcalls, tcalls = _spy_evaluate(jtr), _spy_evaluate(ttr)
    train = jtr.train_conf["train_data"]
    for tr in (jtr, ttr):
        for path in sorted(os.listdir(train)):
            tr.train_file(os.path.join(train, path))
    assert [c[:2] for c in tcalls] == [("eval", 3)]
    _assert_evals_match(tcalls, jcalls)
    sdir = os.path.join(ttr.model_dir, "summaries")
    blob = b"".join(rec for f in os.listdir(sdir)
                    for rec in read_records(os.path.join(sdir, f)))
    assert b"eval/auc" in blob and b"eval/loss" in blob
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.training.loop import Trainer
    off = Trainer(Config(write_conf(tmp_path / "conf2")), "wide_deep",
                  model_dir=str(tmp_path / "off"), device="cpu")
    assert off.eval_every_n_steps == 0


def test_maybe_wipe_model_dir(tmp_path):
    """keep_train=0 wipes <model_dir>/<model_type> (train.py:188-191);
    keep_train=1 leaves it."""
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.training.loop import Trainer
    conf = Config(write_conf(tmp_path / "conf"))
    for keep, survives in ((False, False), (True, True)):
        tr = Trainer(conf, "wide_deep", model_dir=str(tmp_path / "m"),
                     overrides={"keep_train": keep}, device="cpu")
        assert tr.model_dir == str(tmp_path / "m" / "wide_deep")
        os.makedirs(tr.model_dir, exist_ok=True)
        marker = os.path.join(tr.model_dir, "marker")
        open(marker, "w").close()
        tr.maybe_wipe_model_dir()
        assert os.path.exists(marker) == survives


def test_losses_are_bounded(tmp_path, monkeypatch):
    """Trainer.losses keeps only the most recent LOSS_HISTORY losses, so a
    run of any length holds a bounded number of device scalars."""
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.training import loop
    monkeypatch.setattr(loop, "LOSS_HISTORY", 2)
    with open(TRAIN1) as f, open(tmp_path / "data", "w") as out:
        out.writelines(f.readlines()[:3 * B])
    tr = loop.Trainer(Config(write_conf(tmp_path / "conf")), "wide_deep",
                      model_dir=str(tmp_path / "m"), device="cpu",
                      overrides=dict(batch_size=B, pack_budget=3))
    seen = []
    real = tr.train_batch

    def spy(batch, with_summaries=False):
        loss = real(batch, with_summaries=with_summaries)
        seen.append(float(loss))
        return loss

    tr.train_batch = spy
    tr.train_file(str(tmp_path / "data"))
    assert len(seen) == 3 and [float(x) for x in tr.losses] == seen[1:]
