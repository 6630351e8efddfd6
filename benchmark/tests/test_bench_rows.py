"""The row generator: the same rows for the same seed, whatever the number
of worker processes; other rows for another seed; schema-conformant."""

from __future__ import annotations

import json
import os

import pytest

from conftest import BENCH

TRAFFIC = json.load(open(os.path.join(BENCH, "traffic", "train_packed.json")))


@pytest.fixture(scope="module")
def config():
    from reference.config import Config
    return Config(os.path.join(BENCH, "sources", "wide_deep_conf"))


def _rows(config, tmp_path, seed, n, workers, name):
    from harness import rows
    path = str(tmp_path / name)
    rows.write_rows(config, path, n, seed, TRAFFIC, workers=workers)
    with open(path, "rb") as f:
        return f.read()


def test_same_seed_same_rows(config, tmp_path, monkeypatch):
    from harness import rows
    monkeypatch.setattr(rows, "BLOCK_ROWS", 300)
    a = _rows(config, tmp_path, 2 ** 31 + 7, 1000, 1, "a")
    b = _rows(config, tmp_path, 2 ** 31 + 7, 1000, 3, "b")
    c = _rows(config, tmp_path, 2 ** 31 + 8, 1000, 3, "c")
    assert a == b
    assert a != c


def test_rows_fit_the_schema(config, tmp_path):
    blob = _rows(config, tmp_path, 5, 500, 2, "d")
    lines = blob.decode().splitlines()
    assert len(lines) == 500
    width = len(config.schema_columns())
    assert all(len(ln.split("\t")) == width for ln in lines)
    labels = [int(ln.split("\t")[0]) for ln in lines]
    assert set(labels) <= {0, 1} and 0 < sum(labels) < 200
