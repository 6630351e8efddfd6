"""Pluggable filesystem access for data paths (local + hdfs:// + custom):
the port's copy of the JAX package's ``features/fs.py``.

The reference read ``hdfs://`` paths transparently wherever file lists were
resolved, via tf.gfile (the reference's python/lib/dataset.py:30-37 using
``tf.gfile.Glob`` / ``ListDirectory``; classpath from conf/hdfs.path).  Here
the same transparency comes from a small scheme registry:

* local paths (no ``scheme://``) use plain os/open — behavior unchanged;
* ``hdfs://`` / ``viewfs://`` shell out to the ``hadoop fs`` CLI (streamed,
  no staging copy), honoring the environment prepared by conf/hdfs.env;
* tests and sites can ``register_filesystem("myfs", fs)`` with any object
  implementing ``listdir/isdir/isfile/open_text``.

Consumers: features/pipeline.list_files and CsvDataset's file reads.
"""

from __future__ import annotations

import io
import os
import subprocess
from typing import Dict, IO, List, Optional

_HANDLERS: Dict[str, "object"] = {}


def register_filesystem(scheme: str, fs) -> None:
    """Register a filesystem for ``scheme://`` paths.

    ``fs`` must provide: ``isdir(path) -> bool``, ``isfile(path) -> bool``,
    ``listdir(path) -> List[str]`` (full paths of directory entries), and
    ``open_text(path) -> TextIO`` (line-iterable).  Optional:
    ``open_bytes(path)`` (record readers fall back to reading open_text
    raw) and ``listdir_entries(path) -> [(path, is_file)]`` (directory
    scans then need one call instead of a per-entry isfile)."""
    _HANDLERS[scheme] = fs


def scheme_of(path: str) -> Optional[str]:
    """'hdfs://nn/x' -> 'hdfs'; local paths -> None."""
    i = path.find("://")
    return path[:i] if i > 0 else None


def _handler(path: str):
    scheme = scheme_of(path)
    if scheme is None:
        return None
    fs = _HANDLERS.get(scheme)
    if fs is None and scheme in ("hdfs", "viewfs", "webhdfs"):
        fs = HadoopFs()
        _HANDLERS[scheme] = fs
    if fs is None:
        raise ValueError(
            f"no filesystem registered for scheme {scheme!r} "
            f"(register_filesystem) — path: {path}")
    return fs


def isdir(path: str) -> bool:
    fs = _handler(path)
    return os.path.isdir(path) if fs is None else fs.isdir(path)


def isfile(path: str) -> bool:
    fs = _handler(path)
    return os.path.isfile(path) if fs is None else fs.isfile(path)


def listdir(path: str) -> List[str]:
    """Full paths of entries under a directory."""
    fs = _handler(path)
    if fs is None:
        return [os.path.join(path, f) for f in os.listdir(path)]
    return list(fs.listdir(path))


def listdir_entries(path: str):
    """[(full path, is_file)] per directory entry.

    One remote call when the handler implements ``listdir_entries``
    (HadoopFs does — the -ls long form carries the file/dir bit);
    otherwise falls back to a per-entry isfile."""
    fs = _handler(path)
    if fs is None:
        return [(p, os.path.isfile(p)) for p in
                (os.path.join(path, f) for f in os.listdir(path))]
    if hasattr(fs, "listdir_entries"):
        return list(fs.listdir_entries(path))
    return [(p, fs.isfile(p)) for p in fs.listdir(path)]


def open_text(path: str, errors: str = "replace") -> IO[str]:
    fs = _handler(path)
    if fs is None:
        # explicit utf-8: locale-dependent decoding (LANG=C hosts)
        # would U+FFFD-mangle non-ASCII feature values, hashing
        # them to different ids than on a utf-8 host
        return open(path, "r", encoding="utf-8", errors=errors)
    return fs.open_text(path)


def open_bytes(path: str) -> IO[bytes]:
    fs = _handler(path)
    if fs is None:
        return open(path, "rb")
    if hasattr(fs, "open_bytes"):
        return fs.open_bytes(path)
    raise ValueError(f"{type(fs).__name__} has no open_bytes for {path}")


class HadoopFs:
    """``hadoop fs`` CLI backend for hdfs:// (and viewfs://) paths.

    Streams file contents through ``hadoop fs -cat`` (no local staging —
    the scripts/load_*.sh getmerge flow remains available for bulk copies).
    Requires the hadoop client on PATH; conf/hdfs.env prepares a bare host.
    """

    def __init__(self, hadoop: str = "hadoop"):
        self.hadoop = hadoop

    def _run(self, *args) -> subprocess.CompletedProcess:
        return subprocess.run([self.hadoop, "fs", *args],
                              capture_output=True, text=True)

    def isdir(self, path: str) -> bool:
        return self._run("-test", "-d", path).returncode == 0

    def isfile(self, path: str) -> bool:
        return self._run("-test", "-f", path).returncode == 0

    def listdir(self, path: str) -> List[str]:
        return [p for p, _ in self.listdir_entries(path)]

    def listdir_entries(self, path: str):
        """[(full path, is_file)] from ONE ``-ls`` call.

        The long listing already distinguishes files from directories
        (permission column), so directory scans avoid a per-entry
        ``-test -f`` JVM launch (~1-3 s each on a 200-shard date dir)."""
        res = self._run("-ls", path)
        if res.returncode != 0:
            raise FileNotFoundError(
                f"hadoop fs -ls {path} failed: {res.stderr.strip()}")
        out = []
        for line in res.stdout.splitlines():
            parts = line.split(None, 7)  # perms repl owner group size d t name
            if len(parts) == 8 and parts[0][:1] in "-d":
                out.append((parts[7], not parts[0].startswith("d")))
        return out

    def open_bytes(self, path: str) -> IO[bytes]:
        proc = subprocess.Popen([self.hadoop, "fs", "-cat", path],
                                stdout=subprocess.PIPE)
        assert proc.stdout is not None
        return io.BufferedReader(_CatStream(proc, path))

    def open_text(self, path: str) -> IO[str]:
        return io.TextIOWrapper(self.open_bytes(path), encoding="utf-8",
                                errors="replace")


class _CatStream(io.RawIOBase):
    """``hadoop fs -cat`` stdout with exit-status checking at EOF.

    A bare pipe would read a failed or mid-stream-aborted -cat (deleted
    file, transient HDFS error) as a legitimately short file — silently
    dropping rows — and leave an un-reaped child per open.  Here EOF
    waits on the child and raises on a non-zero exit; close() reaps it."""

    def __init__(self, proc: subprocess.Popen, path: str):
        super().__init__()
        self._proc = proc
        self._path = path

    def readable(self) -> bool:
        return True

    def readinto(self, b) -> int:
        n = self._proc.stdout.readinto(b)
        if n:
            return n
        rc = self._proc.wait()  # reaps the child
        if rc != 0:
            raise IOError(
                f"hadoop fs -cat {self._path} exited {rc} — treating the "
                f"stream as truncated, not as end of file")
        return 0

    def close(self) -> None:
        if self.closed:
            return
        try:
            if self._proc.poll() is None:  # abandoned early: stop the cat
                self._proc.kill()
            self._proc.wait()
            self._proc.stdout.close()
        finally:
            super().close()
