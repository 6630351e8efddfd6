"""The port's filesystem layer (features/fs.py) against the JAX package's:
one fake filesystem registered in both, the same answers from both, and
the port's ``list_files`` / ``CsvDataset`` reading through it the batches
they read from local files.  ``HadoopFs`` against a fake ``hadoop`` CLI in
both packages: one ``-ls`` per directory scan, and a failed ``-cat`` raises
instead of reading as a short file."""

import io
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paths import UNIT_FIXTURE  # noqa: E402


class MemFs:
    """A filesystem in a dict: full path -> text."""

    def __init__(self, files):
        self.files = files

    def isdir(self, path):
        return (not self.isfile(path)
                and any(p.startswith(path.rstrip("/") + "/")
                        for p in self.files))

    def isfile(self, path):
        return path in self.files

    def listdir(self, path):
        """The directory's own entries (files and subdirectories)."""
        base = path.rstrip("/") + "/"
        return sorted({base + p[len(base):].split("/")[0]
                       for p in self.files if p.startswith(base)})

    def open_text(self, path, errors="replace"):
        return io.StringIO(self.files[path])

    def open_bytes(self, path):
        return io.BytesIO(self.files[path].encode("utf-8"))


@pytest.fixture()
def memfs():
    from wide_deep_tpu.features import fs as jfs
    from wide_deep_tpu_torch.features import fs as tfs
    with open(UNIT_FIXTURE, encoding="utf-8") as f:
        text = f.read()
    mem = MemFs({"memfs://cluster/data/part-0": text,
                 "memfs://cluster/data/part-1": text,
                 "memfs://cluster/data/.hidden": text,
                 "memfs://cluster/data/sub/part-2": text})
    for mod in (jfs, tfs):
        mod.register_filesystem("memfs", mem)
    yield mem
    for mod in (jfs, tfs):
        mod._HANDLERS.pop("memfs", None)


def test_fs_functions_match_jax(memfs, tmp_path):
    from wide_deep_tpu.features import fs as jfs
    from wide_deep_tpu_torch.features import fs as tfs
    local = tmp_path / "d"
    os.makedirs(local / "sub")
    (local / "a").write_text("x\ty\n", encoding="utf-8")
    for path in ("memfs://cluster/data", "memfs://cluster/data/part-0",
                 "memfs://cluster/nope", str(local), str(local / "a"),
                 str(local / "missing")):
        for fn in ("isdir", "isfile", "scheme_of"):
            assert getattr(tfs, fn)(path) == getattr(jfs, fn)(path), (fn,
                                                                      path)
    for path in ("memfs://cluster/data", str(local)):
        assert sorted(tfs.listdir(path)) == sorted(jfs.listdir(path))
        assert (sorted(tfs.listdir_entries(path))
                == sorted(jfs.listdir_entries(path)))
    for path in ("memfs://cluster/data/part-0", str(local / "a")):
        with tfs.open_text(path) as a, jfs.open_text(path) as b:
            assert a.read() == b.read()
        with tfs.open_bytes(path) as a, jfs.open_bytes(path) as b:
            assert a.read() == b.read()
    assert tfs.scheme_of("hdfs://nn/x") == "hdfs"
    with pytest.raises(ValueError, match="no filesystem registered"):
        tfs.isdir("unknownfs://x/y")


def test_list_files_local_and_remote(memfs, tmp_path):
    from wide_deep_tpu.features.pipeline import list_files as jlist
    from wide_deep_tpu_torch.features.pipeline import list_files
    local = tmp_path / "d"
    os.makedirs(local / "sub")
    for name in ("b", "a", ".hidden"):
        (local / name).write_text("x\n")
    assert list_files(str(local)) == [str(local / "a"), str(local / "b")]
    assert list_files(str(local / "a")) == [str(local / "a")]
    remote = "memfs://cluster/data"
    assert list_files(remote) == [f"{remote}/part-0", f"{remote}/part-1"]
    assert list_files(f"{remote}/part-0") == [f"{remote}/part-0"]
    for path in (str(local), remote, f"{remote}/part-1"):
        assert list_files(path) == jlist(path)
    for path in (str(local / "missing"), "memfs://cluster/nope"):
        with pytest.raises(FileNotFoundError):
            list_files(path)
    with pytest.raises(ValueError, match="no filesystem registered"):
        list_files("unknownfs://x/y")


@pytest.mark.parametrize("native", [False, True])
def test_dataset_reads_remote(memfs, tmp_path, native):
    """CsvDataset over the fake remote dir gives the batches it gives over
    the same two files on local disk: the streaming path (Python or C++
    loader), since a remote file has no local size for the fast path."""
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.features.pipeline import (CsvDataset,
                                                       FeatureTransformer,
                                                       default_transformer)
    from wide_deep_tpu_torch.features.plan import FeaturePlan
    from wide_deep_tpu_torch.testing import write_small_conf
    plan = FeaturePlan(Config(write_small_conf(str(tmp_path / "conf"))),
                       pack_budget=3)
    local = tmp_path / "data"
    os.makedirs(local)
    for name in ("part-0", "part-1"):
        (local / name).write_text(memfs.files["memfs://cluster/data/" + name],
                                  encoding="utf-8")
    tr = default_transformer(plan) if native else FeatureTransformer(plan)

    def batches(path, fast):
        ds = CsvDataset(plan, path, "eval", 8, transformer=tr)
        if not fast:
            ds.FAST_SLURP_MAX_BYTES = -1
        return list(ds)

    got = batches("memfs://cluster/data", fast=True)
    assert sum(int(b["mask"].sum()) for b in got) == 20
    for want in (batches(str(local), fast=False),
                 batches(str(local), fast=True)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.fixture()
def fake_hadoop(tmp_path, monkeypatch):
    """tests/test_features.py's fake ``hadoop`` CLI: -test, -ls, -cat."""
    log = tmp_path / "calls.log"
    script = tmp_path / "hadoop"
    script.write_text(
        '#!/bin/sh\n'
        'echo "$@" >> "$FAKE_LOG"\n'
        'shift\n'
        'cmd=$1; shift\n'
        'case "$cmd" in\n'
        '  -test)\n'
        '    flag=$1; path=$2\n'
        '    case "$path" in\n'
        '      *dir) [ "$flag" = "-d" ]; exit $? ;;\n'
        '      *)    [ "$flag" = "-f" ]; exit $? ;;\n'
        '    esac ;;\n'
        '  -ls)\n'
        '    path=$1\n'
        '    echo "Found 3 items"\n'
        '    echo "-rw-r--r--   3 u g   12 2026-08-19 12:00 $path/part-0"\n'
        '    echo "-rw-r--r--   3 u g   12 2026-08-19 12:00 $path/part-1"\n'
        '    echo "drwxr-xr-x   - u g    0 2026-08-19 12:00 $path/subdir"\n'
        '    ;;\n'
        '  -cat)\n'
        '    printf "r1\\nr2\\n"\n'
        '    exit "${FAKE_CAT_RC:-0}"\n'
        '    ;;\n'
        'esac\n')
    script.chmod(0o755)
    monkeypatch.setenv("FAKE_LOG", str(log))
    return str(script), log


def test_hadoop_fs_matches_jax(fake_hadoop, monkeypatch):
    from wide_deep_tpu.features import fs as jfs
    from wide_deep_tpu_torch.features import fs as tfs
    from wide_deep_tpu_torch.features.pipeline import list_files
    script, log = fake_hadoop
    hfs = tfs.HadoopFs(hadoop=script)
    want = jfs.HadoopFs(hadoop=script).listdir_entries("fakehdfs://nn/datadir")
    assert hfs.listdir_entries("fakehdfs://nn/datadir") == want == [
        ("fakehdfs://nn/datadir/part-0", True),
        ("fakehdfs://nn/datadir/part-1", True),
        ("fakehdfs://nn/datadir/subdir", False)]
    tfs.register_filesystem("fakehdfs", hfs)
    try:
        log.write_text("")
        assert list_files("fakehdfs://nn/datadir") == [
            "fakehdfs://nn/datadir/part-0", "fakehdfs://nn/datadir/part-1"]
        calls = log.read_text().splitlines()
        assert sum("-ls" in c for c in calls) == 1
        assert not any("-test -f" in c for c in calls)
        with hfs.open_text("fakehdfs://nn/datadir/part-0") as f:
            assert f.read() == "r1\nr2\n"
        monkeypatch.setenv("FAKE_CAT_RC", "3")
        with pytest.raises(IOError, match="exited 3"):
            hfs.open_bytes("fakehdfs://nn/datadir/part-0").read()
    finally:
        tfs._HANDLERS.pop("fakehdfs", None)
