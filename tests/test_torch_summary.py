"""The port's TensorBoard summaries against the JAX package's.

* The event file of the port's ``SummaryWriter`` equals the JAX writer's
  byte for byte for the same scalars and histograms (the clock and the
  host name patched on both sides), and its own crc32c is the JAX
  package's.
* The per-layer activation stats of a train step (zero fraction, mean,
  std of each hidden layer, over the whole batch) match the JAX step's
  within float32 round-off: rtol 1e-5, atol 1e-6.
* ``Trainer.train_file`` writes at ``save_summary_steps``: the same steps
  and the same tags as the JAX Trainer's event file, and the loss scalar
  within rtol 2e-5 (the loss tolerance of test_torch_trainer).
"""

import os
import socket
import struct
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from paths import TRAIN1  # noqa: E402
from test_torch_features import force_plans, write_conf  # noqa: E402

B = 16


def _fields(buf):
    """(field number, wire type, value) of a protobuf message: ints for
    varints, bytes for the rest."""
    out, i = [], 0
    while i < len(buf):
        key, i = _varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, i = _varint(buf, i)
        elif wire == 1:
            val, i = buf[i:i + 8], i + 8
        elif wire == 5:
            val, i = buf[i:i + 4], i + 4
        else:
            n, i = _varint(buf, i)
            val, i = buf[i:i + n], i + n
        out.append((field, wire, val))
    return out


def _varint(buf, i):
    shift = val = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return val, i


def _events(path):
    """[(step, {tag: simple value or 'histogram'})] of an event file's
    summary events."""
    from wide_deep_tpu_torch.training.summary import read_records
    out = []
    for rec in read_records(path):
        f = _fields(rec)
        step = [v for n, _, v in f if n == 2]
        for n, _, summary in f:
            if n != 5:
                continue
            tags = {}
            for _, _, value in _fields(summary):
                vf = {k: v for k, _, v in _fields(value)}
                tag = vf[1].decode()
                tags[tag] = (struct.unpack("<f", vf[2])[0] if 2 in vf
                             else "histogram")
            out.append((step[0], tags))
    return out


def test_event_file_bytes_match_jax(tmp_path, monkeypatch):
    from wide_deep_tpu.features.tfrecord import masked_crc as jcrc
    from wide_deep_tpu.training.summary import SummaryWriter as JWriter
    from wide_deep_tpu_torch.training.summary import (SummaryWriter,
                                                      masked_crc,
                                                      read_records)
    clock = iter(np.arange(1.7e9, 1.7e9 + 100, 0.25))
    monkeypatch.setattr(time, "time", lambda: float(next(clock)))
    monkeypatch.setattr(socket, "gethostname", lambda: "host-a")
    rng = np.random.default_rng(5)
    values = rng.normal(size=2000).astype(np.float32)
    values[7] = np.nan
    files = []
    for cls, sub in ((JWriter, "jax"), (SummaryWriter, "port")):
        clock = iter(np.arange(1.7e9, 1.7e9 + 100, 0.25))
        w = cls(str(tmp_path / sub))
        w.scalar("loss", 0.5, step=1)
        w.scalars({"a": 1.0, "dnn_0/hiddenlayer_0/zero_fraction": 0.25},
                  step=2)
        w.histogram("dnn/towers/0/hidden/0/kernel", values, step=3)
        w.histogram("empty", np.zeros(0), step=300)
        w.scalar("negative step", -1.5, step=-2)
        w.close()
        files.append(w.path)
    assert os.path.basename(files[0]) == os.path.basename(files[1])
    with open(files[0], "rb") as a, open(files[1], "rb") as b:
        want, got = a.read(), b.read()
    assert len(got) > 1000 and got == want
    assert len(list(read_records(files[1]))) == 6
    for data in (b"", b"a", bytes(range(256)), want[:999]):
        assert masked_crc(data) == jcrc(data)


def _trainers(tmp_path, monkeypatch, data, summary_steps):
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
    jtr.transformer = JT(jtr.plan, jtr.n_classes, jtr.pos_weight,
                         jtr.neg_weight)
    ttr.transformer = TT(ttr.plan, ttr.n_classes, ttr.pos_weight,
                         ttr.neg_weight)
    for tr in (jtr, ttr):
        tr.runconfig["save_summary_steps"] = summary_steps
    jtr.ensure_initialized(restore=False)
    ttr.params, ttr.mstate = from_jax(jax.device_get(jtr.params),
                                      jax.device_get(jtr.mstate),
                                      device="cpu")
    return jtr, ttr


def _data(tmp_path, n_rows):
    path = str(tmp_path / "train_head")
    with open(TRAIN1) as f, open(path, "w") as out:
        for _ in range(n_rows):
            out.write(f.readline())
    return path


def test_layer_stats_match_jax(tmp_path, monkeypatch):
    """One step from the same params and batch: the JAX step's stats (its
    jit outputs) and the port's ``train_step(with_summaries=True)``."""
    data = _data(tmp_path, B)
    jtr, ttr = _trainers(tmp_path, monkeypatch, data, 1)
    jstats = []
    step = jtr._train_step

    def record(*args):
        out = step(*args)
        jstats.append(jax.device_get(out[4]))
        return out

    jtr._train_step = record
    jtr.train_file(data)
    ttr.train_file(data)
    want, got = jstats[0], ttr.summary_stats
    assert sorted(got) == sorted(want)
    assert len(got) == 3 * 2                # 3 stats x 2 hidden layers
    assert "dnn_0/hiddenlayer_1/activation_std" in got
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert 0.0 <= float(got["dnn_0/hiddenlayer_0/zero_fraction"]) <= 1.0
    assert float(got["dnn_0/hiddenlayer_0/activation_std"]) > 0.0


def test_train_file_writes_at_save_summary_steps(tmp_path, monkeypatch):
    data = _data(tmp_path, 5 * B)
    jtr, ttr = _trainers(tmp_path, monkeypatch, data, 2)
    calls = []
    real = ttr.train_batch

    def spy(batch, with_summaries=False):
        calls.append(with_summaries)
        return real(batch, with_summaries=with_summaries)

    ttr.train_batch = spy
    for tr in (jtr, ttr):
        tr.train_file(data)
    # the stats are computed on the summary steps only
    assert calls == [False, True, False, True, False]
    found = []
    for tr in (jtr, ttr):
        sdir = os.path.join(tr.model_dir, "summaries")
        (name,) = os.listdir(sdir)
        found.append(_events(os.path.join(sdir, name)))
    want, got = found
    steps = [s for s, _ in got]
    assert steps == [s for s, _ in want] and set(steps) == {2, 4}
    for (_, g), (_, w) in zip(got, want):
        assert sorted(g) == sorted(w)
        if "loss" in w:
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=2e-5)
    tags = set().union(*(t for _, t in got))
    assert {"loss", "dnn_0/hiddenlayer_0/zero_fraction",
            "dnn/towers/0/hidden/0/kernel",
            "dnn/towers/0/logits/bias"} <= tags
