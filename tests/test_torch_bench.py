"""The port's bench tool (``wide_deep_tpu_torch.tools.bench``) on the CPU at
the small config: batch 64, 2 warm-up and 2 measured steps on the device
stage, 2 + 2 batches on the end-to-end stage.  Its JSON line must carry
every key the tool promises, with finite values and the loader's thread
curve at 1, 2 and 4 threads; a failed end-to-end stage raises.  No
tolerance: the checks are on keys, counts and finiteness."""

import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_features import force_plans, write_conf  # noqa: E402

KEYS = {"metric", "value", "unit", "vs_baseline", "step_ms", "warmup_s",
        "device", "batch_size", "train_steps",
        "loader_rows_per_sec_by_threads", "loader_examples_per_sec",
        "transfer_first_ms", "transfer_steady_ms_per_batch", "batch_mbytes",
        "e2e_wait_ms_per_step", "e2e_dispatch_ms_per_step",
        "end_to_end_examples_per_sec", "end_to_end_step_ms"}


@pytest.fixture
def prog(tmp_path, monkeypatch):
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.tools import bench
    force_plans(monkeypatch, "window")
    monkeypatch.setenv("BENCH_E2E_FILE", str(tmp_path / "e2e.tsv"))
    return bench.make_program(Config(write_conf(tmp_path / "conf")), 64,
                              "cpu")


def test_bench_gives_every_key(prog, tmp_path):
    from wide_deep_tpu_torch.tools import bench
    out = bench.run(prog, warmup=2, measure=2, e2e_batches=2, e2e_warm=2)
    assert set(out) == KEYS
    json.dumps(out)
    assert out["metric"] == "wide_deep_train_examples_per_sec_per_chip"
    assert out["device"] == "cpu" and out["batch_size"] == 64
    assert sorted(out["loader_rows_per_sec_by_threads"]) == ["1", "2", "4"]
    for k, v in out.items():
        if isinstance(v, float):
            assert math.isfinite(v) and v >= 0, k
    assert out["value"] == pytest.approx(64 / out["step_ms"] * 1e3)
    # device stage 2 + 2 steps, end-to-end 2 + 2
    assert out["train_steps"] == prog.trainer.global_step == 8
    assert np.all(np.isfinite([float(x) for x in prog.trainer.losses]))
    with open(tmp_path / "e2e.tsv") as f:
        assert sum(1 for _ in f) == (2 + 2 + 2) * 64
    assert out["batch_mbytes"] > 0


def test_bench_e2e_needs_the_native_loader(prog):
    """Where bench.py skips the stage, the port's tool fails."""
    from wide_deep_tpu_torch.features.pipeline import FeatureTransformer
    from wide_deep_tpu_torch.tools import bench
    tr = prog.trainer
    tr.transformer = FeatureTransformer(tr.plan)
    with pytest.raises(RuntimeError, match="native loader"):
        bench.bench_end_to_end(prog, 2, 2)
