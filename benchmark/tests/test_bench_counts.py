"""The FLOP and byte counts against hand counts."""

from __future__ import annotations

import os

import numpy as np

from conftest import REPO


def _model(batch=25_600, fm=0, tmp_path=None):
    """The reference model of a cell's configuration at ``batch`` (one
    worker's 25,600 by default, where the hand counts are made; None: the
    configuration's own)."""
    from reference.config import Config
    from reference.model import Model
    from harness import confdir, spec
    import json
    name = "wide_deep_fm8_4x" if fm else "wide_deep_prod_4x"
    config = json.load(open(os.path.join(REPO, "benchmark", "configs",
                                         name + ".json")))
    cell = spec.Cell.from_parts(name, os.path.join(
        REPO, "benchmark", config["conf"]), config, {}, {})
    conf = Config(confdir.write_conf(cell, str(tmp_path), 1,
                                     str(tmp_path / "m")))
    return Model(conf, batch if batch is not None
                 else int(conf.train["batch_size"]))


def test_prod_step_flops(tmp_path):
    from harness import counts
    m = _model(tmp_path=tmp_path)
    macs = 734 * 1024 + 1024 * 512 + 512 * 256 + 256 * 1
    assert macs == 1_407_232
    assert counts.mlp_macs_per_example(734, (1024, 512, 256)) == macs
    assert counts.step_flops(m) == 2 * 3 * macs * 25_600
    assert round(counts.step_flops(m) / 1e9) == 216
    # the cell's step: the cluster's global batch, four workers' 25,600
    cell = _model(batch=None, tmp_path=tmp_path / "cell")
    assert cell.batch_size == 102_400
    assert counts.step_flops(cell) == 4 * counts.step_flops(m)


def test_fm8_step_flops(tmp_path):
    from harness import counts
    m = _model(fm=8, tmp_path=tmp_path)
    plan = m.plan
    fm = 2 * plan.wide_packed_len * 8 + 2 * plan.indicator_dim * 8
    assert counts.step_flops(m) == 6 * (1_407_232 + fm) * 25_600


def test_grad_work_bytes(tmp_path):
    """Two rows: the wide pool holds ids 7, 7, 9 (one entry padding); the
    d4 group ids 1, 1 and 2; the d32 (fused) group ids 5 and 6."""
    from harness import counts
    m = _model(batch=2, tmp_path=tmp_path)
    plan = m.plan
    batch = {"wide_ids": np.array([[7, 9], [7, 0]]),
             "wide_wts": np.array([[1.0, 1.0], [1.0, 0.0]])}
    for g in plan.groups:
        batch[f"emb_ids_d{g.dim}"] = np.zeros((2, 2), np.int32)
        batch[f"emb_wts_d{g.dim}"] = np.zeros((2, 2), np.float32)
    batch["emb_ids_d4"] = np.array([[1, 1], [2, 0]])
    batch["emb_wts_d4"] = np.array([[0.5, 0.5], [1.0, 0.0]])
    batch["emb_ids_d32"] = np.array([[5, 0], [6, 0]])
    batch["emb_wts_d32"] = np.array([[1.0, 0.0], [1.0, 0.0]])
    work = counts.grad_work(m, batch)
    wide = 3 * (4 + 4) + 2 * 2 * 4           # 3 live entries, 2 rows (f32)
    d4 = 3 * (4 + 5 * 2) + 2 * 2 * 5 * 2     # folded: 4 + 1 columns, bf16
    d32 = 2 * (4 + 32 * 2) + 2 * (4 + 2 * 64 * 4)   # param + accum rows
    assert work["bytes"] == wide + d4 + d32
    assert work["ops"] == 3 * 1 + 3 * 5 + 2 * 32
    assert counts.bound_s(work) == work["bytes"] / 3.35e12
