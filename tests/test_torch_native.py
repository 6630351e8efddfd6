"""The port's binding of the C++ loader against the JAX package's.

``serialize_plan`` must give the JAX package's bytes (the blob format is
fastdata.cc's).  The port's ``NativeTransformer`` must give, bit for bit,
the JAX package's native batches and the port's Python transformer's, on
train batches with range, window and compact kernel plans, eval and pred
batches, pos/neg weights, edge values and malformed rows.  The port's
``CsvDataset`` must give the JAX package's batch stream, order included, on
the native fast path and on the native streaming path.  All comparisons
are exact (integer ids, plans, float32 values from the same arithmetic).
"""

import os

import numpy as np
import pytest

pytest.importorskip("torch")

from paths import PRED1, REPO, TRAIN1  # noqa: E402
from test_torch_features import (force_plans, plan_pair,  # noqa: E402
                                 train_rows, write_conf)


@pytest.fixture(scope="module")
def conf_dir(tmp_path_factory):
    return write_conf(tmp_path_factory.mktemp("native_conf"))


def assert_batches_equal(a, b, what=""):
    assert sorted(a) == sorted(b), what
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=f"{what} {k}")


@pytest.mark.parametrize("which", ["small", "production"])
def test_serialize_plan_matches_jax(conf_dir, which):
    from wide_deep_tpu.features.native import serialize_plan as jser
    from wide_deep_tpu_torch.features.native import serialize_plan as tser
    d = conf_dir if which == "small" else os.path.join(REPO, "conf")
    jp, tp = plan_pair(d, pallas_scatter=True, sparse_opt=True,
                       pack_budget=3)
    assert tser(tp) == jser(jp)


def _edge_row(plan, row):
    row = list(row)
    col = plan.column_index
    row[col["age"]] = "-"
    row[col["os"]] = "notavocab"
    row[col["idea_type"]] = "-7"
    row[col["ucomp"]] = "A,B,C,D,E,F,G,H,I,J,K"      # beyond max_len
    row[col["adplan_id"]] = ""
    row[col["hour"]] = "1e309"
    return row


def _lines(path, n):
    with open(path, encoding="utf-8") as f:
        return [line.rstrip("\n") for line in f if line.strip()][:n]


# (case, kernel plans forced, mode, batch size, weights)
CASES = [("train_range", "range", "train", 48, None),
         ("train_window", "window", "train", 48, None),
         ("eval", None, "eval", 64, None),
         ("pred_with_label", None, "pred", 48, None),
         ("pred_without_label", None, "pred", 48, None),
         ("weighted", "range", "train", 48, (0.9, 0.1)),
         ("edge_values", "window", "train", 16, None),
         ("malformed", None, "eval", 32, None)]


@pytest.mark.parametrize("case,plans,mode,batch,weights", CASES,
                         ids=[c[0] for c in CASES])
def test_native_transformer_bit_identical(conf_dir, monkeypatch, case, plans,
                                          mode, batch, weights):
    from wide_deep_tpu.features.native import NativeTransformer as JNT
    from wide_deep_tpu_torch.features.native import NativeTransformer as TNT
    from wide_deep_tpu_torch.features.pipeline import FeatureTransformer as TT
    if plans:
        force_plans(monkeypatch, plans)
    jp, tp = plan_pair(conf_dir, pallas_scatter=True, sparse_opt=True)
    pos, neg = weights or (None, None)
    n = batch - 8                          # 8 padding rows
    if case == "pred_without_label":
        lines = _lines(PRED1, n)
        rows = [[""] + line.split("\t") for line in lines]
    else:
        rows = train_rows(n)
        if case == "edge_values":
            rows = [_edge_row(tp, r) for r in rows]
        lines = ["\t".join(r) for r in rows]
    if case == "malformed":
        # short and long lines among the good ones are skipped
        bad = ["only\tthree\tcells", "\t".join(rows[0] + ["extra"]), "x"]
        lines = [x for pair in zip(lines, bad * len(lines)) for x in pair]
    text = "\n".join(lines).encode("utf-8")
    tnt = TNT(tp, pos_weight=pos, neg_weight=neg)
    got = tnt.transform_text(text, len(lines), batch, mode)
    want_jax = JNT(jp, pos_weight=pos, neg_weight=neg).transform_text(
        text, len(lines), batch, mode)
    want_py = TT(tp, pos_weight=pos, neg_weight=neg).transform(rows, batch,
                                                               mode)
    assert_batches_equal(got, want_jax, "jax native")
    assert_batches_equal(got, want_py, "python")
    assert got["mask"].sum() == n
    if mode == "train":
        prefix = "scat_" if plans == "range" else "wscat_"
        assert any(k.startswith(prefix) for k in got), sorted(got)
        assert any(k.startswith("sopt_") for k in got), sorted(got)
    # the row-list API joins back into the same text
    if case != "malformed":
        assert_batches_equal(tnt.transform(rows, batch, mode), got, "rows")


@pytest.mark.parametrize("path", ["fast", "streaming"])
@pytest.mark.parametrize("shuffle_buffer,num_shards", [
    (100, 1), (100000, 1), (0, 1), (300, 2)])
def test_csv_dataset_native_paths_match_jax(conf_dir, monkeypatch, path,
                                            shuffle_buffer, num_shards):
    """Same file, seed, epoch and shuffle buffer: the same batches in the
    same order, through the native loaders of both packages, over two
    epochs and both shards."""
    from wide_deep_tpu.features.native import NativeTransformer as JNT
    from wide_deep_tpu.features.pipeline import CsvDataset as JD
    from wide_deep_tpu_torch.features.native import NativeTransformer as TNT
    from wide_deep_tpu_torch.features.pipeline import CsvDataset as TD
    force_plans(monkeypatch, "range")
    if path == "streaming":
        monkeypatch.setattr(JD, "FAST_SLURP_MAX_BYTES", 0)
        monkeypatch.setattr(TD, "FAST_SLURP_MAX_BYTES", 0)
    jp, tp = plan_pair(conf_dir, pallas_scatter=True, sparse_opt=True)
    for shard in range(num_shards):
        kw = dict(shuffle_buffer=shuffle_buffer, seed=5,
                  num_shards=num_shards, shard_index=shard)
        jds = JD(jp, TRAIN1, "train", 64, transformer=JNT(jp), **kw)
        tds = TD(tp, TRAIN1, "train", 64, **kw)
        assert isinstance(tds.transformer, TNT)
        assert tds._fast_path_ok() == (path == "fast")
        for epoch in range(2):
            jb = list(jds.iter_with_indices())
            tb = list(tds.iter_with_indices())
            assert len(jb) == len(tb) > 1
            for i, ((j, ji), (t, ti)) in enumerate(zip(jb, tb)):
                np.testing.assert_array_equal(ji, ti)
                assert_batches_equal(j, t, f"epoch {epoch} batch {i}")


def test_csv_dataset_invalid_utf8(conf_dir, tmp_path):
    """Invalid UTF-8 reaches the C++ parser raw on the fast path and as
    U+FFFD on the streaming path, in both packages alike."""
    from wide_deep_tpu.features.native import NativeTransformer as JNT
    from wide_deep_tpu.features.pipeline import CsvDataset as JD
    from wide_deep_tpu_torch.features.pipeline import CsvDataset as TD
    jp, tp = plan_pair(conf_dir)
    raw = open(TRAIN1, "rb").read().splitlines()[:40]
    # a hashed value of each row gains an invalid byte
    raw = [line.replace(b"\tad", b"\tad\xff", 1) for line in raw]
    data = tmp_path / "bad_utf8.tsv"
    data.write_bytes(b"\n".join(raw) + b"\n")
    got = {}
    for fast in (True, False):
        limit = JD.FAST_SLURP_MAX_BYTES if fast else 0
        jds = JD(jp, str(data), "eval", 48, transformer=JNT(jp))
        tds = TD(tp, str(data), "eval", 48)
        jds.FAST_SLURP_MAX_BYTES = tds.FAST_SLURP_MAX_BYTES = limit
        got[fast] = next(iter(tds))
        assert_batches_equal(next(iter(jds)), got[fast], f"fast={fast}")
    # the raw byte and U+FFFD hash to other ids
    assert not np.array_equal(got[True]["wide_ids"], got[False]["wide_ids"])


def test_default_transformer_is_native(conf_dir):
    from wide_deep_tpu_torch.features import native
    from wide_deep_tpu_torch.features.pipeline import default_transformer
    _, tp = plan_pair(conf_dir)
    t = default_transformer(tp, num_parallel_calls=3)
    assert isinstance(t, native.NativeTransformer) and t.n_threads == 3


def test_default_transformer_without_compiler(conf_dir, monkeypatch, caplog):
    """No C++ compiler: the Python transformer, with a warning naming the
    compilers looked for."""
    from wide_deep_tpu_torch.features import native
    from wide_deep_tpu_torch.features.pipeline import (FeatureTransformer,
                                                       default_transformer)
    _, tp = plan_pair(conf_dir)
    monkeypatch.setenv("CXX", "no-such-compiler")
    monkeypatch.setenv("PATH", "")
    assert native.find_compiler() is None
    with caplog.at_level("WARNING", logger="wide_deep_tpu_torch"):
        t = default_transformer(tp)
    assert type(t) is FeatureTransformer
    assert "no-such-compiler" in caplog.text and "g++" in caplog.text


def test_failed_compile_raises(monkeypatch, tmp_path):
    """A compiler that fails raises with its output; nothing stands in."""
    from wide_deep_tpu_torch.features import native
    fake = tmp_path / "fakecxx"
    fake.write_text("#!/bin/sh\necho 'fake compiler refuses' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="fake compiler refuses"):
        native.build()
    assert not [f for f in os.listdir(tmp_path / "build")
                if f.endswith(".so")]


def test_sharded_plan_is_refused(conf_dir):
    """Per-shard range, window and compact plans are ported (tests/
    test_torch_parallel.py holds them to the JAX package's); a plan for
    the dedup exchange, which is not, is refused when a train batch would
    carry it."""
    from wide_deep_tpu_torch.features.native import NativeTransformer
    _, tp = plan_pair(conf_dir, scatter_shards=2, shard_threshold=1)
    tnt = NativeTransformer(tp)
    tp.shard_kind = "dedup"
    text = "\n".join("\t".join(r) for r in train_rows(8)).encode("utf-8")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tnt.transform_text(text, 8, 8, "train")
