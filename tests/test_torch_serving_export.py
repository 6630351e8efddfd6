"""The port's serving export (serving/export.py, tools/export.py) against the
JAX package's, on the CPU.

A module fixture trains the JAX Trainer briefly on the unit fixture, carries
its params to the port (``interop.from_jax``), saves a port checkpoint and
exports both packages' bundles from the same weights.  Then:

* ``bundle.json`` equals the JAX package's key for key;
* the bundle's tensors equal the JAX orbax bundle's leaf for leaf: the same
  names, shapes and dtypes, float32 and bfloat16 bit for bit (the export
  only slices and casts, and both cast float32 to bfloat16 by rounding to
  nearest even);
* ``params.txt`` equals the JAX package's line for line;
* a deep-only model whose tables train as fused sparse-optimizer tables
  (``SPARSE_MIN_ROWS`` 1) exports each as its embedding block alone,
  ``[rows, dim]`` in the embedding dtype, as the JAX package does;
* a missing checkpoint raises, a pinned step exports that step, a bundle
  that does not fit its model is refused, and ``tools.export`` writes what
  ``export_savedmodel`` writes.

The fixture builder is shared with tests/test_torch_serving_server.py and
tests/test_torch_serving_transport.py.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from paths import UNIT_FIXTURE  # noqa: E402
from test_torch_features import force_plans, leaves, write_conf  # noqa: E402

B = 16


def _overrides(**over):
    out = dict(train_data=UNIT_FIXTURE, eval_data=UNIT_FIXTURE,
               test_data=UNIT_FIXTURE, keep_train=True, batch_size=B)
    out.update(over)
    return out


def build_bundles(tmp, model_type="wide_deep", bf16=True, fused=False,
                  edits=()):
    """Train the JAX Trainer 2 steps on the unit fixture, carry its params
    to a port Trainer, checkpoint both and export both bundles (version 1,
    with params.txt).  ``fused``: every embedding table trains as a fused
    sparse-optimizer table; ``edits``: (old, new) replacements in
    model.yaml.  -> namespace of the conf dir, the model dirs, the two
    bundles' version dirs and the JAX params (numpy)."""
    from wide_deep_tpu.config import Config as JConfig
    from wide_deep_tpu.parallel import mesh as mesh_lib
    from wide_deep_tpu.serving.export import export_savedmodel as jexport
    from wide_deep_tpu.training.loop import Trainer as JTrainer
    from wide_deep_tpu_torch.config import Config as TConfig
    from wide_deep_tpu_torch.interop import from_jax
    from wide_deep_tpu_torch.serving.export import export_savedmodel
    from wide_deep_tpu_torch.training.loop import Trainer as TTrainer
    conf_dir = write_conf(tmp / "conf", bf16=bf16)
    if edits:
        path = os.path.join(conf_dir, "model.yaml")
        with open(path) as f:
            text = f.read()
        for old, new in edits:
            assert old in text, old
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
    over = _overrides(**({"pack_budget": 3, "sparse_optimizer": True,
                          "scatter_mode": "pallas"} if fused else {}))
    out = SimpleNamespace(conf_dir=conf_dir, model_type=model_type,
                          jax_model=str(tmp / "jax"),
                          port_model=str(tmp / "torch"))
    with pytest.MonkeyPatch.context() as mp:
        if fused:
            force_plans(mp, "range")
        jtr = JTrainer(JConfig(conf_dir), model_type=model_type,
                       model_dir=out.jax_model, overrides=over,
                       mesh=mesh_lib.make_mesh(1, 1, jax.devices()[:1]))
        jtr.ensure_initialized(restore=False)
        for _ in range(2):
            jtr.train_file(UNIT_FIXTURE)
        jtr.save()
        ttr = TTrainer(TConfig(conf_dir), model_type=model_type,
                       model_dir=out.port_model, overrides=over,
                       device="cpu")
        assert sorted(ttr.sparse_tables) == sorted(jtr.sparse_tables)
        assert bool(ttr.sparse_tables) == fused
        out.jax_params = jax.device_get(jtr.params)
        ttr.params, ttr.mstate = from_jax(out.jax_params,
                                          jax.device_get(jtr.mstate),
                                          device="cpu")
        ttr.ensure_initialized(restore=False)
        ttr.global_step = jtr.global_step
        ttr.save()
        out.step = jtr.global_step
        del jtr, ttr
    out.jax_bundle = jexport(JConfig(conf_dir), str(tmp / "jax_export"),
                             model_type=model_type, model_dir=out.jax_model,
                             model_version=1, as_text=True)
    out.port_bundle = export_savedmodel(
        TConfig(conf_dir), str(tmp / "torch_export"), model_type=model_type,
        model_dir=out.port_model, model_version=1, as_text=True)
    return out


def read_rows(path, n):
    with open(path) as f:
        return [line.rstrip("\n") for line in f if line.strip()][:n]


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    return build_bundles(tmp_path_factory.mktemp("serving_export"))


@pytest.fixture(scope="module")
def fused_bundles(tmp_path_factory):
    return build_bundles(tmp_path_factory.mktemp("serving_fused"),
                         model_type="deep", fused=True)


@pytest.fixture(scope="module")
def fm_bundles(tmp_path_factory):
    return build_bundles(tmp_path_factory.mktemp("serving_fm"),
                         edits=[("linear_fm_factors: 0",
                                 "linear_fm_factors: 4")])


@pytest.fixture(scope="module")
def sgd_bundles(tmp_path_factory):
    """Fused tables under SGD: no optimizer slots, so the checkpoint holds
    them at the serving width, still float32."""
    return build_bundles(tmp_path_factory.mktemp("serving_sgd"),
                         model_type="deep", fused=True,
                         edits=[("dnn_optimizer: Adagrad",
                                 "dnn_optimizer: SGD")])


def _bundle_json(version_dir):
    with open(os.path.join(version_dir, "bundle.json")) as f:
        return json.load(f)


def _jax_bundle_leaves(version_dir):
    """The JAX bundle's {params, mstate} as {name: numpy array}."""
    from wide_deep_tpu.serving.export import load_bundle
    _, params, mstate, _ = load_bundle(version_dir)
    tree = jax.device_get({"params": params, "mstate": mstate})
    return {"/".join(map(str, k)): np.asarray(v)
            for k, v in leaves(tree).items()}


def _port_bundle_leaves(version_dir):
    from wide_deep_tpu_torch.training.checkpoint import load_flat
    return dict(load_flat(os.path.join(version_dir, "params")))


def _assert_bits_equal(name, got, want):
    """A port tensor and a JAX numpy leaf: same shape and dtype, same
    bits."""
    assert tuple(got.shape) == want.shape, name
    if want.dtype.name == "bfloat16":
        assert got.dtype == torch.bfloat16, name
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16), err_msg=name)
    else:
        assert str(got.dtype) == f"torch.{want.dtype.name}", name
        np.testing.assert_array_equal(got.numpy().view(np.uint8),
                                      want.view(np.uint8), err_msg=name)


@pytest.mark.parametrize("which", ["bundles", "fused_bundles",
                                   "fm_bundles", "sgd_bundles"])
def test_bundle_json_matches_jax(which, request):
    b = request.getfixturevalue(which)
    got, want = _bundle_json(b.port_bundle), _bundle_json(b.jax_bundle)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key] == want[key], key
    assert got["global_step"] == b.step == 2
    assert got["model_type"] == b.model_type


@pytest.mark.parametrize("which", ["bundles", "fused_bundles",
                                   "fm_bundles", "sgd_bundles"])
def test_bundle_tensors_match_jax(which, request):
    b = request.getfixturevalue(which)
    got, want = _port_bundle_leaves(b.port_bundle), \
        _jax_bundle_leaves(b.jax_bundle)
    assert sorted(got) == sorted(want)
    for name in want:
        _assert_bits_equal(name, got[name], want[name])
    if which == "bundles":
        assert got["params/dnn/embed/d8"].dtype == torch.bfloat16
        assert got["params/linear/fold/d4"].dtype == torch.float32
    if which == "sgd_bundles":
        # nothing to cut: the checkpoint holds the [rows, dim] float32
        # block, cast to the embedding dtype
        from wide_deep_tpu_torch.training.checkpoint import read_index
        index = read_index(os.path.join(b.port_model, "deep"), b.step)
        assert index["tensors"]["params/dnn/embed/d8"] == {
            "shape": [123136, 8], "dtype": "float32"}
        assert got["params/dnn/embed/d8"].dtype == torch.bfloat16
        assert tuple(got["params/dnn/embed/d8"].shape) == (123136, 8)
    if which == "fm_bundles":
        # FM unfolds the plan: no fold columns, the factor table exported
        assert tuple(got["params/linear/v"].shape)[1] == 4
        assert not any("/fold/" in n for n in got)
    else:
        assert "params/linear/v" not in got


@pytest.mark.parametrize("which", ["bundles", "fused_bundles",
                                   "fm_bundles", "sgd_bundles"])
def test_params_txt_matches_jax(which, request):
    b = request.getfixturevalue(which)
    with open(os.path.join(b.port_bundle, "params.txt")) as f:
        got = f.read().splitlines()
    with open(os.path.join(b.jax_bundle, "params.txt")) as f:
        want = f.read().splitlines()
    assert len(got) == len(want) > 10
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (i, g[:200], w[:200])


def test_fused_tables_export_as_embedding_blocks(fused_bundles):
    """The fused [rows, 128] float32 tables (checkpointed at their live
    [rows, 2 * dim]) come out as [rows, dim] in the embedding dtype, the
    embedding block of the JAX params bit for bit."""
    from wide_deep_tpu_torch.training.checkpoint import read_index
    b = fused_bundles
    index = read_index(os.path.join(b.port_model, "deep"), b.step)
    got = _port_bundle_leaves(b.port_bundle)
    for dim, rows in ((4, 17408), (8, 123136)):
        name = f"params/dnn/embed/d{dim}"
        assert index["tensors"][name] == {"shape": [rows, 2 * dim],
                                          "dtype": "float32"}
        leaf = got[name]
        assert tuple(leaf.shape) == (rows, dim)
        assert leaf.dtype == torch.bfloat16
        fused = b.jax_params["dnn"]["embed"][f"d{dim}"]
        assert fused.shape == (rows, 128)
        want = np.asarray(fused[:, :dim]).astype(jax.numpy.bfloat16)
        _assert_bits_equal(name, leaf, want)


def test_load_bundle_round_trip(bundles):
    """load_bundle gives the bundle's tensors in the model's tree, on the
    device asked for, and a plan equal to the exported one."""
    from wide_deep_tpu_torch.serving.export import load_bundle
    model, params, mstate, meta = load_bundle(bundles.port_bundle,
                                              device="cpu")
    flat = _port_bundle_leaves(bundles.port_bundle)
    tree = {"params": params, "mstate": mstate}
    got = {"/".join(map(str, k)): v for k, v in leaves(tree).items()}
    assert sorted(got) == sorted(flat)
    for name, t in got.items():
        assert t.device.type == "cpu" and t.dtype == flat[name].dtype
        assert torch.equal(t.reshape(-1).view(torch.uint8),
                           flat[name].reshape(-1).view(torch.uint8)), name
    assert json.loads(json.dumps(model.plan.to_dict())) == meta["plan"]
    assert not model.plan.sparse_opt and not model.plan.pallas_scatter
    assert model.model_type == "wide_deep" and model.n_classes == 2


def test_load_bundle_refuses_a_bundle_that_does_not_fit(bundles, tmp_path):
    import shutil

    from wide_deep_tpu_torch.serving.export import load_bundle
    from wide_deep_tpu_torch.training.checkpoint import load_flat, write_flat
    bad = tmp_path / "1"
    shutil.copytree(bundles.port_bundle, bad)
    # copies: the memory-mapped tensors must not outlive their file
    tensors = {k: v.clone() for k, v in load_flat(str(bad / "params")).items()}
    tensors["params/linear/w"] = tensors["params/linear/w"][:-1].clone()
    write_flat(str(bad / "params"), tensors, {})
    with pytest.raises(ValueError, match="params/linear/w"):
        load_bundle(str(bad), device="cpu")
    del tensors["params/linear/b"]
    write_flat(str(bad / "params"), tensors, {})
    with pytest.raises(ValueError, match="missing"):
        load_bundle(str(bad), device="cpu")


def test_missing_checkpoint_raises(bundles, tmp_path):
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.serving.export import export_savedmodel
    config = Config(bundles.conf_dir)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        export_savedmodel(config, str(tmp_path / "e"),
                          model_type="wide_deep",
                          model_dir=str(tmp_path / "empty"))
    pinned = os.path.join(bundles.port_model, "wide_deep", "7")
    with pytest.raises(FileNotFoundError, match=r"available steps: \[2\]"):
        export_savedmodel(config, str(tmp_path / "e"),
                          model_type="wide_deep", checkpoint_path=pinned)
    assert not os.path.exists(tmp_path / "e" / "1")


def test_pinned_step_and_versions(bundles, tmp_path):
    """An explicit checkpoint path exports that step; versions sit side by
    side and latest_version_dir picks the highest; re-exporting a version
    replaces it; no temporary directory is left behind."""
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.serving.export import (export_savedmodel,
                                                    latest_version_dir)
    config = Config(bundles.conf_dir)
    root = str(tmp_path / "e")
    pinned = os.path.join(bundles.port_model, "wide_deep", "2")
    for version in (1, 10, 2, 10):
        export_savedmodel(config, root, model_type="wide_deep",
                          checkpoint_path=pinned, model_version=version)
    assert sorted(os.listdir(root)) == ["1", "10", "2"]
    assert latest_version_dir(root) == os.path.join(root, "10")
    assert _bundle_json(os.path.join(root, "10"))["global_step"] == 2
    assert not os.path.exists(os.path.join(root, "10", "params.txt"))
    with pytest.raises(FileNotFoundError):
        latest_version_dir(str(tmp_path))


def test_export_tool_matches_the_function(bundles, tmp_path, capsys):
    """tools.export's main with flags writes the bundle export_savedmodel
    writes, and prints its path."""
    from wide_deep_tpu_torch.tools import export as export_tool
    path = export_tool.main(["--conf_dir", bundles.conf_dir,
                             "--export_dir", str(tmp_path / "e"),
                             "--model_dir", bundles.port_model,
                             "--model_version", "3", "--as_text", "1"])
    assert path == str(tmp_path / "e" / "3")
    assert f"exported bundle: {path}" in capsys.readouterr().out
    assert _bundle_json(path) == _bundle_json(bundles.port_bundle)
    got, want = _port_bundle_leaves(path), \
        _port_bundle_leaves(bundles.port_bundle)
    assert sorted(got) == sorted(want)
    for name in want:
        assert torch.equal(got[name].float(), want[name].float()), name
