"""The port's offline preprocessing (wide_deep_tpu_torch/offline/,
tools/data_process.py and tools/analyze_data.py) against the JAX
package's (tests/test_offline.py's cases).

Every ``ctr_features`` function gives JAX's result on the same seeded
inputs; the local job writes JAX's bytes, and regenerates the committed
golden ``data/spark/20180112`` byte for byte; the Spark driver, run on an
in-process stand-in for PySpark's RDD API (pyspark is not installed),
writes the same rows; the two CLIs print and write what JAX's tools do.
"""

import filecmp
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

pytest.importorskip("torch")

from paths import REPO, TRAIN1  # noqa: E402

GOLDEN = os.path.join(REPO, "data", "spark", "20180112")


def _rows(n_rows, seed, n_cols=6, n_values=7):
    rng = np.random.default_rng(seed)
    return [[str(int(rng.random() < 0.3))]
            + [f"v{int(rng.integers(0, n_values))}" for _ in range(n_cols)]
            for _ in range(n_rows)]


def _pkgs():
    from wide_deep_tpu.offline import ctr_features as jcf
    from wide_deep_tpu_torch.offline import ctr_features as tcf
    return jcf, tcf


# ------------------------------------------------------------ ctr_features
@pytest.mark.parametrize("fn", ["gen_dates", "list_dates", "ctr_rate_map",
                                "append_rate_columns", "keep_row",
                                "process_day"])
def test_ctr_features_match_jax(fn):
    jcf, tcf = _pkgs()
    rows = _rows(300, 1)
    rows[5][0] = "x"                  # a malformed label counts as 0
    if fn == "gen_dates":
        for start, days in (("20180220", 3), ("20180301", 30),
                            ("20161231", 1)):
            assert tcf.gen_dates(start, days) == jcf.gen_dates(start, days)
    elif fn == "list_dates":
        for a, b in (("20180228", "20180302"), ("20160227", "20160302"),
                     ("20180112", "20180112")):
            assert tcf.list_dates(a, b) == jcf.list_dates(a, b)
    elif fn == "ctr_rate_map":
        for col in (2, 4, 7):
            assert tcf.ctr_rate_map(rows, col) == jcf.ctr_rate_map(rows, col)
    elif fn == "append_rate_columns":
        maps = [(2, jcf.ctr_rate_map(rows[:50], 2)), (3, {}),
                (5, jcf.ctr_rate_map(rows, 5))]
        for row in rows[:40]:
            assert (tcf.append_rate_columns(row, maps)
                    == jcf.append_rate_columns(row, maps))
    elif fn == "keep_row":
        for keep, seed in ((0.01, 0), (0.3, 7), (1.0, 0)):
            assert ([tcf.keep_row(r, keep, seed) for r in rows]
                    == [jcf.keep_row(r, keep, seed) for r in rows])
    else:
        window = {1: rows[:100], 7: rows[:200], 30: rows}
        for feats, keep in (([2, 6], 0.2), ([], 1.0), ([3], 0.05)):
            assert (list(tcf.process_day(rows[:100], window, feats, keep, 3))
                    == list(jcf.process_day(rows[:100], window, feats, keep,
                                            3)))


def test_dataframe_flavor_matches_jax():
    from wide_deep_tpu.offline.local_job import dataframe_preprocess as jdf
    from wide_deep_tpu_torch.offline.local_job import (
        dataframe_preprocess as tdf)
    rows = _rows(400, 2, n_cols=3)
    for kw in (dict(feature_index_list=[2, 3], keep_prob=1.0,
                    schema=["clk", "site", "sex"]),
               dict(feature_index_list=[4], keep_prob=0.05)):
        assert tdf(rows, **kw) == jdf(rows, **kw)


# --------------------------------------------------------------- the jobs
def _window_input(root, n_days=9):
    """Date partitions of data/train/train1's rows: a day each, so the 7-
    and 30-day windows differ from the 1-day one."""
    with open(TRAIN1, encoding="utf-8") as f:
        lines = [line for line in f if line.strip()]
    from wide_deep_tpu_torch.offline.ctr_features import gen_dates
    per = len(lines) // n_days
    for i, day in enumerate(gen_dates("20180112", n_days)):
        d = os.path.join(root, day)
        os.makedirs(d)
        with open(os.path.join(d, "part-00000"), "w") as f:
            f.writelines(lines[i * per:(i + 1) * per])
    return root


def _same_tree(a, b):
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for part in os.listdir(a):
        assert filecmp.cmp(os.path.join(a, part), os.path.join(b, part),
                           shallow=False), part


def test_local_job_writes_jax_bytes(tmp_path):
    from wide_deep_tpu.offline.local_job import local_data_preprocess as jrun
    from wide_deep_tpu_torch.offline.local_job import (
        local_data_preprocess as trun)
    inroot = _window_input(str(tmp_path / "in"))
    for feats, keep in (([9, 12], 0.05), ([], 0.5)):
        kw = dict(feature_index_list=feats, keep_prob=keep, seed=1,
                  num_output_partitions=3)
        nj = jrun(inroot, str(tmp_path / "jax"), "20180112", **kw)
        nt = trun(inroot, str(tmp_path / "port"), "20180112", **kw)
        assert nt == nj > 0
        _same_tree(str(tmp_path / "jax" / "20180112"),
                   str(tmp_path / "port" / "20180112"))


def test_golden_fixture_regenerates_byte_identical(tmp_path):
    from wide_deep_tpu_torch.offline.local_job import local_data_preprocess
    inroot = tmp_path / "in"
    (inroot / "20180112").mkdir(parents=True)
    shutil.copy(TRAIN1, inroot / "20180112" / "part-00000")
    n = local_data_preprocess(str(inroot), str(tmp_path / "out"),
                              "20180112", feature_index_list=[9],
                              keep_prob=0.05)
    assert n > 0
    _same_tree(GOLDEN, str(tmp_path / "out" / "20180112"))


class _RDD:
    """The RDD calls spark_job makes, on a list of rows in order;
    ``repartition(n)`` deals rows round-robin, as the local job writes
    its parts."""

    def __init__(self, items, parts=1):
        self.items, self.parts = list(items), parts

    def map(self, f):
        return _RDD(map(f, self.items), self.parts)

    def filter(self, f):
        return _RDD(filter(f, self.items), self.parts)

    def mapValues(self, f):
        return self.map(lambda kv: (kv[0], f(kv[1])))

    def reduceByKey(self, f):
        acc = {}
        for k, v in self.items:
            acc[k] = f(acc[k], v) if k in acc else v
        return _RDD(acc.items(), self.parts)

    def collectAsMap(self):
        return dict(self.items)

    def repartition(self, n):
        return _RDD(self.items, n)

    def saveAsTextFile(self, path):
        os.makedirs(path)
        for p in range(self.parts):
            with open(os.path.join(path, f"part-{p:05d}"), "w",
                      encoding="utf-8") as f:
                f.writelines(x + "\n" for x in self.items[p::self.parts])


class _Context:
    shipped = []

    def __init__(self, conf=None):
        pass

    def textFile(self, paths):
        lines = []
        for p in paths.split(","):
            for name in sorted(os.listdir(p)):
                with open(os.path.join(p, name), encoding="utf-8") as f:
                    lines += [x.rstrip("\n") for x in f if x.strip()]
        return _RDD(lines)

    def broadcast(self, value):
        return types.SimpleNamespace(value=value)

    def addPyFile(self, path):
        _Context.shipped.append(path)

    def stop(self):
        pass


def _fake_pyspark(monkeypatch):
    mod = types.ModuleType("pyspark")
    mod.SparkContext = _Context
    mod.SparkConf = lambda: types.SimpleNamespace(setMaster=lambda m: None)
    monkeypatch.setitem(sys.modules, "pyspark", mod)


@pytest.mark.parametrize("which", ["port", "jax"])
def test_spark_driver_regenerates_the_golden(tmp_path, monkeypatch, which):
    """The Spark driver on the stand-in RDD API: the same rows in the same
    parts as the committed golden (the local job's output), with the port
    shipping its package to the executors in a zip (``--py-files``)."""
    import zipfile
    if which == "port":
        from wide_deep_tpu_torch.offline import spark_job
    else:
        from wide_deep_tpu.offline import spark_job
    _fake_pyspark(monkeypatch)
    monkeypatch.setattr(spark_job, "exist_hdfs_path", os.path.exists)
    monkeypatch.setattr(spark_job, "_clear_hdfs_path", shutil.rmtree)
    inroot = tmp_path / "in"
    (inroot / "20180112").mkdir(parents=True)
    shutil.copy(TRAIN1, inroot / "20180112" / "part-00000")
    out = str(tmp_path / "out" / "20180112")
    os.makedirs(out)                       # an earlier run's output: cleared
    from wide_deep_tpu_torch.offline.ctr_features import gen_dates
    inpath = [str(inroot / d) for d in gen_dates("20180112", 30)]
    _Context.shipped.clear()
    spark_job.hdfs_data_preprocess(inpath, out, [9], 0.05)
    _same_tree(GOLDEN, out)
    if which == "port":
        (zpath,) = _Context.shipped
        names = zipfile.ZipFile(zpath).namelist()
        assert "wide_deep_tpu_torch/offline/ctr_features.py" in names
        assert not any(n.startswith("wide_deep_tpu/") for n in names)
    with pytest.raises(IOError):
        spark_job.hdfs_data_preprocess([str(tmp_path / "none")], out, [9],
                                       0.05)


# -------------------------------------------------------------- the CLIs
def _run(args, cwd, env=None):
    r = subprocess.run([sys.executable] + args, capture_output=True,
                       text=True, cwd=cwd, timeout=600,
                       env=dict(os.environ, PYTHONPATH=REPO, **(env or {})))
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    return r.stdout


def test_data_process_cli_matches_jax(tmp_path):
    inroot = _window_input(str(tmp_path / "in"), n_days=3)
    flags = ["--engine", "local", "--input_dir", inroot, "--start_date",
             "20180111", "--end_date", "20180112", "--keep_ratio", "0.1",
             "--feature_index", "9", "12"]
    outs = {}
    for which, cmd in (("jax", [os.path.join(REPO, "tools",
                                             "data_process.py")]),
                       ("port", ["-m",
                                 "wide_deep_tpu_torch.tools.data_process"])):
        out = str(tmp_path / which)
        outs[which] = _run(cmd + flags + ["--output_dir", out], REPO)
    assert outs["port"] == outs["jax"]
    assert "20180112: wrote" in outs["port"]
    for day in ("20180111", "20180112"):
        _same_tree(str(tmp_path / "jax" / day), str(tmp_path / "port" / day))


def test_analyze_data_cli_matches_jax(tmp_path):
    flags = ["--data", os.path.join(REPO, "data", "train"), "--max_rows",
             "3000"]
    jax_out = _run([os.path.join(REPO, "tools", "analyze_data.py")] + flags,
                   str(tmp_path))
    port_out = _run(["-m", "wide_deep_tpu_torch.tools.analyze_data"] + flags,
                    str(tmp_path))
    assert port_out == jax_out
    assert "rows analyzed: 3000" in port_out
    assert "suggested train.yaml pack_budget" in port_out
