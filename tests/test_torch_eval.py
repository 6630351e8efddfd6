"""The port's evaluation, prediction and batch transfer against the JAX
package's.

``Trainer.evaluate`` and ``Trainer.predict`` run on the CPU from the JAX
Trainer's params (``interop.from_jax``) over the same file, for the binary
head and a 3-class head.  Tolerances: every metric within rtol 1e-5, ``auc``
and ``auc_precision_recall`` within 1e-5 absolute (float32 sums of the same
terms in another order); predictions within rtol 1e-5 (atol 1e-6 for values
near 0).  ``metrics.update_metrics`` / ``finalize_metrics`` against the JAX
package's on seeded inputs: metrics within rtol 1e-5, accumulators within
rtol 1e-5 plus 1e-6 of the magnitudes they sum (3-class labels make
``w * (1 - y)`` negative, and float32 round-off grows with the magnitudes
summed, not with what is left after they cancel).

Also on the CPU: ``Trainer._to_device`` hands back every key bit for bit,
the packed layout aligns every key to 256 bytes and leaves the window
plans' ``ok`` flags out, and ``DevicePrefetchIterator`` raises what either
of its threads raised in the consumer.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from paths import TRAIN1  # noqa: E402
from test_torch_features import force_plans, write_conf  # noqa: E402

B = 32


def _trainers(tmp_path, monkeypatch, n_classes, data):
    from wide_deep_tpu.config import Config as JConfig
    from wide_deep_tpu.parallel import mesh as mesh_lib
    from wide_deep_tpu.training.loop import Trainer as JTrainer
    from wide_deep_tpu_torch.config import Config as TConfig
    from wide_deep_tpu_torch.interop import from_jax
    from wide_deep_tpu_torch.training.loop import Trainer as TTrainer
    force_plans(monkeypatch, "range")
    conf_dir = write_conf(tmp_path / "conf")
    overrides = dict(train_data=data, eval_data=data, test_data=data,
                     keep_train=True, batch_size=B, pack_budget=3,
                     sparse_optimizer=True, scatter_mode="pallas")
    jtr = JTrainer(JConfig(conf_dir), model_type="wide_deep",
                   model_dir=str(tmp_path / "jax"), n_classes=n_classes,
                   mesh=mesh_lib.make_mesh(1, 1, jax.devices()[:1]),
                   overrides=overrides)
    jtr.ensure_initialized(restore=False)
    ttr = TTrainer(TConfig(conf_dir), model_type="wide_deep",
                   model_dir=str(tmp_path / "torch"), n_classes=n_classes,
                   overrides=overrides, device="cpu")
    assert sorted(ttr.sparse_tables) == sorted(jtr.sparse_tables) != []
    ttr.params, ttr.mstate = from_jax(jax.device_get(jtr.params),
                                      jax.device_get(jtr.mstate),
                                      device="cpu")
    return jtr, ttr


def _data(tmp_path, n_classes, n_rows=200):
    """The sample file's head (binary) or a generated 3-class file; the
    last batch is partial."""
    path = str(tmp_path / f"eval_{n_classes}.tsv")
    if n_classes == 2:
        with open(TRAIN1) as f, open(path, "w") as out:
            for _ in range(n_rows):
                out.write(f.readline())
    else:
        from wide_deep_tpu_torch.config import Config
        from wide_deep_tpu_torch.testing import generate_ctr_tsv
        generate_ctr_tsv(Config(write_conf(tmp_path / "gen_conf")), path,
                         n_rows, seed=3, n_classes=n_classes)
    return path


@pytest.mark.parametrize("n_classes", [2, 3])
def test_evaluate_matches_jax(tmp_path, monkeypatch, n_classes):
    data = _data(tmp_path, n_classes)
    jtr, ttr = _trainers(tmp_path, monkeypatch, n_classes, data)
    want = jtr.evaluate(data)
    got = ttr.evaluate(data)
    assert sorted(got) == sorted(want)
    if n_classes == 2:
        assert {"auc", "auc_precision_recall", "label/mean",
                "prediction/mean"} <= set(got)
    for k, v in want.items():
        if k in ("auc", "auc_precision_recall"):
            assert abs(got[k] - v) <= 1e-5, (k, got[k], v)
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)
    assert got["global_step"] == 0
    assert np.isfinite(got["loss"]) and 0.0 <= got["accuracy"] <= 1.0


@pytest.mark.parametrize("n_classes", [2, 3])
def test_predict_matches_jax(tmp_path, monkeypatch, n_classes):
    data = _data(tmp_path, n_classes, n_rows=70)
    jtr, ttr = _trainers(tmp_path, monkeypatch, n_classes, data)
    want = list(jtr.predict(data))
    got = list(ttr.predict(data))
    assert len(got) == len(want) == 70
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w)
        for k in w:
            assert isinstance(g[k], (np.ndarray, np.generic)), k
            np.testing.assert_allclose(g[k], np.asarray(w[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=f"row {i} {k}")


@pytest.mark.parametrize("multiclass", [False, True])
def test_metrics_match_jax(multiclass):
    import jax.numpy as jnp

    from wide_deep_tpu import metrics as jm
    from wide_deep_tpu_torch import metrics as tm
    np.testing.assert_array_equal(jm.thresholds(), tm.thresholds())
    rng = np.random.default_rng(7)
    jacc, tacc = jm.init_metrics(), tm.init_metrics(device="cpu")
    mag = 0.0
    for _ in range(3):
        n = 257
        probs = rng.random(n).astype(np.float32)
        labels = (rng.integers(0, 3, n) if multiclass
                  else (rng.random(n) < 0.3)).astype(np.float32)
        weights = np.where(rng.random(n) < 0.1, 0.0,
                           rng.choice([0.1, 0.9, 1.0], n)).astype(np.float32)
        loss = rng.random(n).astype(np.float32) * 2
        correct = ((rng.integers(0, 3, n) == labels) if multiclass
                   else None)
        mag += float(np.sum(np.abs(weights) * (1 + np.abs(labels))
                            + np.abs(loss * weights)))
        jacc = jm.update_metrics(
            jacc, jnp.asarray(probs), jnp.asarray(labels),
            jnp.asarray(weights), jnp.asarray(loss),
            correct=None if correct is None else jnp.asarray(correct))
        tacc = tm.update_metrics(
            tacc, torch.from_numpy(probs), torch.from_numpy(labels),
            torch.from_numpy(weights), torch.from_numpy(loss),
            correct=None if correct is None else torch.from_numpy(correct))
    assert sorted(jacc) == sorted(tacc)
    for k in jacc:
        assert tacc[k].dtype == torch.float32
        np.testing.assert_allclose(tacc[k].numpy(), np.asarray(jacc[k]),
                                   rtol=1e-5, atol=1e-6 * mag, err_msg=k)
    want = jm.finalize_metrics(jacc, binary=not multiclass)
    got = tm.finalize_metrics(tacc, binary=not multiclass)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def _plan_batch(monkeypatch, tmp_path):
    """A train batch with range, window and compact plans."""
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.features.plan import FeaturePlan
    from wide_deep_tpu_torch.testing import synthetic_batch
    force_plans(monkeypatch, "range")
    plan = FeaturePlan(Config(write_conf(tmp_path / "conf")),
                       pallas_scatter=True, sparse_opt=True)
    batch = synthetic_batch(plan, 48, np.random.default_rng(0))
    force_plans(monkeypatch, "window")
    plan_w = FeaturePlan(Config(write_conf(tmp_path / "conf_w")),
                         pallas_scatter=True, sparse_opt=True)
    batch.update({k: v for k, v in synthetic_batch(
        plan_w, 48, np.random.default_rng(1)).items() if "wscat_" in k})
    for prefix in ("scat_", "wscat_", "sopt_"):
        assert any(k.startswith(prefix) for k in batch), prefix
    assert any("_ok_" in k for k in batch)
    return batch


def test_pack_layout_aligns_and_leaves_ok_out(monkeypatch, tmp_path):
    from wide_deep_tpu_torch.training.loop import PACK_ALIGN, pack_layout
    batch = _plan_batch(monkeypatch, tmp_path)
    offsets, n = pack_layout(batch)
    assert PACK_ALIGN == 256
    assert sorted(offsets) == sorted(k for k in batch if "_ok_" not in k)
    ends = 0
    for k, off in sorted(offsets.items(), key=lambda kv: kv[1]):
        assert off % 256 == 0 and off >= ends, k
        ends = off + batch[k].nbytes
    assert ends <= n and n % 256 == 0
    assert n - sum(batch[k].nbytes for k in offsets) < 256 * len(offsets)


def test_to_device_round_trips_bits(monkeypatch, tmp_path):
    """The packed buffer's views (the card's path, here on a host buffer)
    and the CPU Trainer's ``_to_device`` give every key back bit for bit;
    the ``ok`` flags stay host tensors."""
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.training.loop import (Trainer, pack_into,
                                                   pack_layout, unpack)
    batch = _plan_batch(monkeypatch, tmp_path)
    offsets, n = pack_layout(batch)
    staging = np.zeros(n, np.uint8)
    pack_into(staging, batch, offsets)
    views = unpack(torch.from_numpy(staging), batch, offsets)
    tr = Trainer(Config(write_conf(tmp_path / "conf_t")), "wide_deep",
                 device="cpu")
    for out in (views, tr._to_device(batch)):
        assert sorted(out) == sorted(batch)
        for k, v in batch.items():
            t = out[k]
            assert t.device.type == "cpu" and tuple(t.shape) == v.shape, k
            assert t.numpy().dtype == v.dtype, k
            np.testing.assert_array_equal(t.numpy().view(np.uint8),
                                          v.view(np.uint8), err_msg=k)


class _Boom(Exception):
    pass


def _failing(n_good):
    for i in range(n_good):
        yield i
    raise _Boom("producer failed")


@pytest.mark.parametrize("where", ["loader", "copy"])
def test_device_prefetch_raises_in_consumer(where):
    """Either thread's exception reaches the consumer after the batches
    made before it, and again on the next call: it neither vanishes nor
    ends the iteration early."""
    from wide_deep_tpu_torch.features.pipeline import (DevicePrefetchIterator,
                                                       PrefetchIterator)

    def to_device(b):
        if where == "copy" and b == 2:
            raise _Boom("copy failed")
        return b * 10

    source = _failing(3) if where == "loader" else iter(range(5))
    it = DevicePrefetchIterator(PrefetchIterator(source), to_device)
    got = []
    with pytest.raises(_Boom):
        for b in it:
            got.append(b)
    assert got == ([0, 10, 20] if where == "loader" else [0, 10])
    with pytest.raises(_Boom):
        next(it)
