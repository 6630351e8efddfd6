"""Shared set-up of the benchmark's CPU tests: the harness's packages and
the checkout's root on sys.path, and cells on a small configuration."""

from __future__ import annotations

import json
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
for _p in (REPO, BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)

# the cells' limits, held by the small runs too
with open(os.path.join(BENCH, "limits", "prod4x_train_packed.json")) as _f:
    TRAIN_LIMITS = json.load(_f)["train"]


def small_cell(tmp_path, traffic_name: str = "train_packed", fm: int = 0,
               **traffic_over):
    """A cell of ``traffic_name`` on conf/ shrunk by the port's test helper
    (hash spaces of 1,000 rows, a [32, 16] MLP, float32 tables), batch 64."""
    from harness import spec
    from wide_deep_tpu_torch.testing import write_small_conf
    d = str(tmp_path / "conf")
    write_small_conf(d, hidden_units="[32, 16]")
    with open(os.path.join(BENCH, "traffic", f"{traffic_name}.json")) as f:
        traffic = json.load(f)
    traffic.update(traffic_over)
    config = {"set": {"train.yaml": {"train": {"batch_size": 64,
                                               "pack_budget": 3}},
                      "model.yaml": {"linear_fm_factors": fm}},
              "peak_flops_per_s": 67e12}
    limits = {"train": dict(TRAIN_LIMITS)}
    return spec.Cell.from_parts(f"small_{traffic_name}_{fm}", d, config,
                                traffic, limits)


class Args:
    def __init__(self, seed: int, seconds: float = 1.0, trace: int = 0):
        self.seed = seed
        self.seconds = seconds
        self.trace = trace


@pytest.fixture
def scratch_tmpdir(tmp_path, monkeypatch):
    """The run's $TMPDIR inside the test's own directory."""
    d = tmp_path / "tmp"
    d.mkdir()
    monkeypatch.setenv("TMPDIR", str(d))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(d))
    return d
