"""The joint wide_deep + CNN model trained through the port's entry points
on the CPU, against the JAX package: the Trainer over TSV rows paired with
the committed TFRecord images (row k with image k % 24), the CLIs with the
``--image_*_data`` flags, and the export of a CNN checkpoint.

Tolerances (float32, small conf + ``resnet_cifar`` size 8 on 224 x 224
images, batch 8), each leaf by norm: per-step losses rtol 1e-4; the
``cnn_bn`` state 1e-4; the change of each ``cnn`` leaf over the 3 steps and
of its Adagrad accumulator 1e-2 of JAX's change.  The CNN's float32
backward at this size lands farther from JAX's than 1e-4 in the updates
(sums over 401,408 values a channel taken in other orders, and gradients
routed by near-ties); tests/test_torch_cnn.py holds the same function's
gradients to 1e-10 in float64.  A wrong learning rate,
decay or optimizer on the arm moves the updates by far more.
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from paths import IMAGE_TFRECORDS, TRAIN1, UNIT_FIXTURE  # noqa: E402
from test_torch_features import leaves, write_conf  # noqa: E402

B = 8
N_ROWS = 3 * B


def cnn_conf(dst, **model):
    """The float32 small conf with the CNN arm on (``resnet_cifar`` size 8
    unless ``model`` names other model.yaml values)."""
    conf = write_conf(dst)
    path = os.path.join(conf, "model.yaml")
    with open(path) as f:
        text = f.read()
    edits = dict(dict(cnn_use_flag=1, cnn_model="resnet_cifar",
                      cnn_resnet_size=8), **model)
    for key, value in edits.items():
        text, n = re.subn(rf"(?m)^{key}:.*$", f"{key}: {value}", text)
        assert n == 1, key
    with open(path, "w") as f:
        f.write(text)
    return conf


def _rel(a, b):
    return np.linalg.norm(np.asarray(a, np.float64) - b) / np.linalg.norm(b)


def _image_overrides(data):
    return dict(train_data=data, eval_data=data, test_data=data,
                image_train_data=IMAGE_TFRECORDS,
                image_eval_data=IMAGE_TFRECORDS,
                image_test_data=IMAGE_TFRECORDS, keep_train=True,
                batch_size=B)


def _jax_cnn_slots(opt_state):
    """{path: Adagrad accumulator} of the JAX optimizer's cnn arm."""
    import optax
    dense = opt_state["dense"] if isinstance(opt_state, dict) else opt_state
    inner = dense.inner_states["cnn"].inner_state
    rss = [s for s in jax.tree_util.tree_leaves(
        inner, is_leaf=lambda x: isinstance(x, optax.ScaleByRssState))
        if isinstance(s, optax.ScaleByRssState)][0]
    return {p: v for p, v in leaves(jax.device_get(
        rss.sum_of_squares)).items()
        if p[0] == "cnn" and not isinstance(v, optax.MaskedNode)}


def test_joint_trainer_matches_jax(tmp_path):
    """Both Trainers from JAX's initial weights over the same 24 rows and
    their images (Python loaders on both sides): the same batches, images
    included; JAX's losses over 3 steps; JAX's ``cnn`` leaves, ``cnn_bn``
    state and cnn-arm Adagrad accumulators after them; then both evaluate
    alike."""
    from wide_deep_tpu.config import Config as JConfig
    from wide_deep_tpu.features.pipeline import FeatureTransformer as JT
    from wide_deep_tpu.parallel import mesh as mesh_lib
    from wide_deep_tpu.training.loop import Trainer as JTrainer
    from wide_deep_tpu_torch.config import Config as TConfig
    from wide_deep_tpu_torch.features.image import ImageCsvDataset
    from wide_deep_tpu_torch.features.pipeline import FeatureTransformer as TT
    from wide_deep_tpu_torch.interop import from_jax, to_numpy
    from wide_deep_tpu_torch.training.loop import Trainer as TTrainer

    conf_dir = cnn_conf(tmp_path / "conf")
    data = str(tmp_path / "train_head")
    with open(TRAIN1) as f, open(data, "w") as out:
        for _ in range(N_ROWS):
            out.write(f.readline())
    overrides = _image_overrides(data)
    jtr = JTrainer(JConfig(conf_dir), model_type="wide_deep",
                   model_dir=str(tmp_path / "jax"),
                   mesh=mesh_lib.make_mesh(1, 1, jax.devices()[:1]),
                   overrides=overrides)
    ttr = TTrainer(TConfig(conf_dir), model_type="wide_deep",
                   model_dir=str(tmp_path / "torch"), overrides=overrides,
                   device="cpu")
    assert ttr.model.has_cnn and ttr.model.cnn_spec.model == "resnet_cifar"
    assert sorted(ttr.tx.arms) == ["cnn", "dnn", "linear"]
    assert isinstance(ttr._dataset(data, "train"), ImageCsvDataset)
    jtr.transformer = JT(jtr.plan, jtr.n_classes, jtr.pos_weight,
                         jtr.neg_weight)
    ttr.transformer = TT(ttr.plan, ttr.n_classes, ttr.pos_weight,
                         ttr.neg_weight)
    jtr.ensure_initialized(restore=False)
    ttr.params, ttr.mstate = from_jax(jax.device_get(jtr.params),
                                      jax.device_get(jtr.mstate),
                                      device="cpu")
    assert sorted(ttr.params) == ["cnn", "dnn", "linear"]
    assert sorted(ttr.mstate) == ["bn", "cnn_bn"]
    cnn0 = to_numpy(ttr.params["cnn"])
    ttr.ensure_initialized(restore=False)

    jbatches, jlosses, tbatches = [], [], []
    to_device, step = jtr._to_device, jtr._train_step

    def record_batch(b):
        jbatches.append({k: np.asarray(v) for k, v in b.items()})
        return to_device(b)

    def record_step(*args):
        out = step(*args)
        jlosses.append(float(out[3]))
        return out

    jtr._to_device, jtr._train_step = record_batch, record_step
    train_batch = ttr.train_batch

    def record_port(b):
        tbatches.append(b)
        return train_batch(b)

    ttr.train_batch = record_port
    jtr.train_file(data)
    ttr.train_file(data)

    assert len(jbatches) == len(tbatches) == N_ROWS // B
    for jb, tb in zip(jbatches, tbatches):
        assert sorted(jb) == sorted(tb)
        assert tb["image"].shape == (B, 224, 224, 3)
        for k in jb:
            np.testing.assert_array_equal(jb[k], tb[k], err_msg=k)
    np.testing.assert_allclose([float(x) for x in ttr.losses], jlosses,
                               rtol=1e-4)
    jcnn = leaves(jax.device_get(jtr.params)["cnn"])
    tcnn, start = leaves(to_numpy(ttr.params["cnn"])), leaves(cnn0)
    assert sorted(jcnn) == sorted(tcnn) and len(jcnn) > 10
    for path, want in jcnn.items():
        assert not np.array_equal(tcnn[path], start[path]), path
        assert _rel(tcnn[path] - start[path], want - start[path]) <= 1e-2, \
            path
    jbn = leaves(jax.device_get(jtr.mstate["cnn_bn"]))
    tbn = leaves(to_numpy(ttr.mstate["cnn_bn"]))
    assert sorted(jbn) == sorted(tbn)
    for path, want in jbn.items():
        assert _rel(tbn[path], want) <= 1e-4, path
    jslots = _jax_cnn_slots(jtr.opt_state)
    tslots = ttr.opt_state["dense"]["cnn"]["accum"]
    assert sorted(jslots) == sorted(tslots)
    assert sorted(p[1:] for p in jslots) == sorted(jcnn)
    for path, want in jslots.items():
        assert _rel(tslots[path].numpy() - 0.1, want - 0.1) <= 1e-2, path
    assert ttr.opt_state["dense"]["cnn"]["count"] == N_ROWS // B

    jres, tres = jtr.evaluate(data), ttr.evaluate(data)
    for k in ("auc", "accuracy", "average_loss"):
        np.testing.assert_allclose(tres[k], jres[k], rtol=1e-2, err_msg=k)


def test_cli_train_eval_with_image_flags(tmp_path, monkeypatch, capsys):
    """``tools.train`` / ``tools.eval`` in-process with the
    ``--image_*_data`` flags at batch 8 (tests/test_cnn_train.py's CLI run
    for the JAX package): training reaches the cnn arm, eval prints the
    metric set."""
    from wide_deep_tpu_torch.tools import eval as eval_tool
    from wide_deep_tpu_torch.tools import train
    monkeypatch.chdir(tmp_path)
    conf = cnn_conf(tmp_path / "conf")
    common = ["--conf_dir", conf, "--device", "cpu",
              "--model_dir", str(tmp_path / "m"),
              "--image_train_data", IMAGE_TFRECORDS,
              "--image_eval_data", IMAGE_TFRECORDS,
              "--image_test_data", IMAGE_TFRECORDS, "--batch_size", str(B)]
    trainer = train.main(common + [
        "--train_data", UNIT_FIXTURE, "--eval_data", UNIT_FIXTURE,
        "--test_data", UNIT_FIXTURE, "--train_epochs", "1",
        "--keep_train", "0", "--dynamic_train", "0"])
    assert trainer.model.has_cnn
    assert trainer.train_conf["image_train_data"] == IMAGE_TFRECORDS
    assert trainer.global_step == 2                 # 10 rows at batch 8
    assert trainer.opt_state["dense"]["cnn"]["count"] == 2
    assert np.isfinite(list(trainer.losses)[-1].item())
    capsys.readouterr()
    res = eval_tool.main(common + ["--test_data", UNIT_FIXTURE])
    out = capsys.readouterr().out
    assert "auc" in out and "accuracy" in out
    assert res["global_step"] == 2 and np.isfinite(res["average_loss"])
    assert res == trainer.evaluate(UNIT_FIXTURE)


@pytest.mark.parametrize("model,size", [("resnet_cifar_v1", 8),
                                        ("resnet", 18)])
def test_cnn_checkpoint_exports_as_jax_tree(tmp_path, model, size):
    """A CNN checkpoint of the port exports with its ``cnn`` leaves and
    ``cnn_bn`` state: the bundle's names, shapes and dtypes are the JAX
    package's abstract tree for the same conf (its export's
    ``eval_shape`` of ``model.init`` with the image entry), and
    ``load_bundle`` reads it back equal to the trained leaves."""
    from wide_deep_tpu.config import Config as JConfig
    from wide_deep_tpu.features.plan import FeaturePlan as JPlan
    from wide_deep_tpu.models.joint import build_model as jbuild
    from wide_deep_tpu_torch.config import Config as TConfig
    from wide_deep_tpu_torch.serving.export import (export_savedmodel,
                                                    load_bundle)
    from wide_deep_tpu_torch.training import checkpoint as ckpt
    from wide_deep_tpu_torch.training.loop import Trainer
    conf = cnn_conf(tmp_path / "conf", cnn_model=model,
                    cnn_resnet_size=size)
    tr = Trainer(TConfig(conf), "wide_deep", model_dir=str(tmp_path / "m"),
                 overrides=_image_overrides(UNIT_FIXTURE), device="cpu")
    tr.ensure_initialized(restore=False)
    tr.save()
    version = export_savedmodel(TConfig(conf), str(tmp_path / "ex"),
                                model_type="wide_deep",
                                model_dir=str(tmp_path / "m"))
    stored = ckpt.load_flat(os.path.join(version, "params"))

    jconf = JConfig(conf)
    jplan = JPlan(jconf, fold=tr.plan.fold,
                  pack_budget=tr.plan.to_dict().get("pack_budget"))
    jmodel = jbuild(jconf, plan=jplan, model_type="wide_deep")
    spec = jplan.batch_spec(1, 2, with_image=jmodel.has_cnn)
    sample = {k: np.zeros(shape, dt) for k, (shape, dt) in spec.items()}
    jparams, jmstate = jax.eval_shape(lambda r: jmodel.init(r, sample),
                                      jax.random.PRNGKey(0))
    want = {}
    for what, tree in (("params", jparams), ("mstate", jmstate)):
        for path, leaf in leaves(tree).items():
            want["/".join((what,) + tuple(map(str, path)))] = leaf
    assert sorted(stored) == sorted(want)
    assert any(n.startswith("params/cnn/") for n in want)
    assert any(n.startswith("mstate/cnn_bn/") for n in want)
    for name, leaf in want.items():
        assert tuple(stored[name].shape) == tuple(leaf.shape), name
        assert str(stored[name].dtype) == f"torch.{leaf.dtype.name}", name

    smodel, sparams, smstate, _ = load_bundle(version, TConfig(conf),
                                              device="cpu")
    assert smodel.has_cnn
    for path, leaf in leaves(tr.params["cnn"]).items():
        got = sparams["cnn"]
        for k in path:
            got = got[k]
        assert torch.equal(got, leaf), path
    assert sorted(smstate) == sorted(tr.mstate)


@pytest.mark.slow
def test_conf_vgg_settings_diverge_as_in_jax(tmp_path):
    """conf/'s CNN settings (Adagrad at lr 0.05, accumulator 0.1) on VGG16
    over raw 0-255 pixels blow the loss up within 3 steps in the JAX
    package, and the port follows it step for step (rtol 1e-2, the float32
    drift of a run this unstable): a property
    of the configuration, not of the port.  Slow for the reason the JAX
    package marks its CNN training tests slow (VGG16 at 224 x 224 on the
    CPU, ~1 min)."""
    from wide_deep_tpu.config import Config as JConfig
    from wide_deep_tpu.features.pipeline import FeatureTransformer as JT
    from wide_deep_tpu.parallel import mesh as mesh_lib
    from wide_deep_tpu.training.loop import Trainer as JTrainer
    from wide_deep_tpu_torch.config import Config as TConfig
    from wide_deep_tpu_torch.features.pipeline import FeatureTransformer as TT
    from wide_deep_tpu_torch.interop import from_jax
    from wide_deep_tpu_torch.training.loop import Trainer as TTrainer
    conf = cnn_conf(tmp_path / "conf", cnn_model="vgg16")
    data = str(tmp_path / "rows")
    with open(TRAIN1) as f, open(data, "w") as out:
        for _ in range(12):
            out.write(f.readline())
    overrides = dict(_image_overrides(data), batch_size=4)
    jtr = JTrainer(JConfig(conf), model_type="wide_deep",
                   model_dir=str(tmp_path / "j"),
                   mesh=mesh_lib.make_mesh(1, 1, jax.devices()[:1]),
                   overrides=overrides)
    jtr.transformer = JT(jtr.plan, 2, jtr.pos_weight, jtr.neg_weight)
    jtr.ensure_initialized(restore=False)
    ttr = TTrainer(TConfig(conf), model_type="wide_deep",
                   model_dir=str(tmp_path / "t"), overrides=overrides,
                   device="cpu")
    ttr.transformer = TT(ttr.plan, 2, ttr.pos_weight, ttr.neg_weight)
    ttr.params, ttr.mstate = from_jax(jax.device_get(jtr.params),
                                      jax.device_get(jtr.mstate),
                                      device="cpu")
    ttr.ensure_initialized(restore=False)
    jlosses, step = [], jtr._train_step

    def record(*args):
        out = step(*args)
        jlosses.append(float(out[3]))
        return out
    jtr._train_step = record
    jtr.train_file(data)
    ttr.train_file(data)
    tlosses = [float(x) for x in ttr.losses]
    assert len(jlosses) == len(tlosses) == 3
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-2)
    for losses in (jlosses, tlosses):
        assert losses[0] < 1.0 and losses[2] > 1e6 * losses[0], losses
