"""The port's Trainer against the JAX package's Trainer on the same
truncated training file, both on one device, with kernel plans forced in
(a range plan for the folded group, the fused sparse optimizer for the
unfolded one).  The port starts from the JAX Trainer's initial params.

Both Trainers read the file through their Python loaders (the streaming
path), or both through their native C++ loaders (the fast path, whose
shuffle order is another).  First the two loaders must yield identical
batches in the same order, then the per-step losses must agree (float32
model: rtol 2e-5, float32 round-off of sums taken in another order) and so
must the params after the last step (rtol 1e-4 / atol 1e-5, that round-off
through the optimizers).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from paths import TRAIN1  # noqa: E402
from test_torch_features import (assert_trees_close, force_plans,  # noqa: E402
                                 write_conf)

B = 16
N_ROWS = 3 * B


def test_trainer_matches_jax(tmp_path, monkeypatch):
    _check_trainers(tmp_path, monkeypatch, native=False)


def test_trainer_matches_jax_native_loaders(tmp_path, monkeypatch):
    _check_trainers(tmp_path, monkeypatch, native=True)


def _check_trainers(tmp_path, monkeypatch, native):
    from wide_deep_tpu.config import Config as JConfig
    from wide_deep_tpu.features.native import NativeTransformer as JNT
    from wide_deep_tpu.features.pipeline import FeatureTransformer as JT
    from wide_deep_tpu.parallel import mesh as mesh_lib
    from wide_deep_tpu.training.loop import Trainer as JTrainer
    from wide_deep_tpu_torch.config import Config as TConfig
    from wide_deep_tpu_torch.features.native import NativeTransformer as TNT
    from wide_deep_tpu_torch.features.pipeline import FeatureTransformer as TT
    from wide_deep_tpu_torch.interop import from_jax, to_numpy
    from wide_deep_tpu_torch.training.loop import Trainer as TTrainer

    force_plans(monkeypatch, "range")
    conf_dir = write_conf(tmp_path / "conf")
    data = str(tmp_path / "train_head")
    with open(TRAIN1) as f, open(data, "w") as out:
        for _ in range(N_ROWS):
            out.write(f.readline())
    overrides = dict(train_data=data, eval_data=data, test_data=data,
                     keep_train=True, batch_size=B, pack_budget=3,
                     sparse_optimizer=True, scatter_mode="pallas")

    jtr = JTrainer(JConfig(conf_dir), model_type="wide_deep",
                   model_dir=str(tmp_path / "jax"),
                   mesh=mesh_lib.make_mesh(1, 1, jax.devices()[:1]),
                   overrides=overrides)
    ttr = TTrainer(TConfig(conf_dir), model_type="wide_deep",
                   model_dir=str(tmp_path / "torch"), overrides=overrides,
                   device="cpu")
    if native:
        assert isinstance(jtr.transformer, JNT)
        assert isinstance(ttr.transformer, TNT)
    else:
        # the Python loader on both sides (the native loaders' fast path
        # shuffles in another order)
        jtr.transformer = JT(jtr.plan, jtr.n_classes, jtr.pos_weight,
                             jtr.neg_weight)
        ttr.transformer = TT(ttr.plan, ttr.n_classes, ttr.pos_weight,
                             ttr.neg_weight)
    jtr.ensure_initialized(restore=False)
    assert sorted(ttr.sparse_tables) == sorted(jtr.sparse_tables) != []
    assert ttr.plan.to_dict() == jtr.plan.to_dict()
    ttr.params, ttr.mstate = from_jax(jax.device_get(jtr.params),
                                      jax.device_get(jtr.mstate),
                                      device="cpu")

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
        assert any(k.startswith("scat_") for k in tb)
        assert any(k.startswith("sopt_") for k in tb)
        for k in jb:
            np.testing.assert_array_equal(jb[k], tb[k], err_msg=k)
    tlosses = [float(x) for x in ttr.losses]
    np.testing.assert_allclose(tlosses, jlosses, rtol=2e-5)
    assert ttr.global_step == jtr.global_step == N_ROWS // B
    assert_trees_close(jax.device_get(jtr.params), to_numpy(ttr.params),
                       rtol=1e-4, atol=1e-5, what="params")
