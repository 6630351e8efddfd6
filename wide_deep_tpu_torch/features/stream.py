"""Streaming ingestion: train on a live TSV stream (the port's copy of
wide_deep_tpu/features/stream.py).

A newline-delimited TSV stream over TCP feeds the same transformer as the
file pipeline (``default_transformer``: the C++ loader), so a model can
train continuously on live events (``Trainer.train_stream``), or an
operator can replay a file through ``serve_file`` /
``python -m wide_deep_tpu_torch.tools.stream_server`` to drive the path end
to end.

Semantics:

* rows are consumed in arrival order (no shuffle: a stream is already
  ordered in time);
* a batch is emitted every ``batch_size`` rows, or after
  ``flush_timeout_s`` of idleness with whatever has arrived (padded and
  masked, as a file's tail is);
* by default a closed connection ends the stream; with ``reconnect=True``
  the dataset retries with exponential backoff, and the stream ends only
  after ``max_retries`` consecutive failed connects;
* a connection reset in the middle of a row discards the partial tail (a
  clean close still flushes an unterminated last row);
* with the Python transformer, rows of the wrong arity are skipped (the
  native parser drops them itself); a chunk of nothing but junk gives an
  all-masked batch.
"""

from __future__ import annotations

import logging
import socket
import threading
import time
from typing import Iterator, Optional

from wide_deep_tpu_torch.features.pipeline import Batch, default_transformer
from wide_deep_tpu_torch.features.plan import FeaturePlan

log = logging.getLogger("wide_deep_tpu_torch.stream")


class StreamDataset:
    """TCP newline-TSV stream -> packed Batch iterator (one-shot)."""

    def __init__(self, plan: FeaturePlan, host: str, port: int,
                 mode: str = "train", batch_size: int = 1024,
                 n_classes: int = 2,
                 pos_weight: Optional[float] = None,
                 neg_weight: Optional[float] = None,
                 flush_timeout_s: float = 1.0,
                 max_batches: Optional[int] = None,
                 transformer=None,
                 connect_timeout_s: float = 10.0,
                 reconnect: bool = False,
                 max_retries: int = 30,
                 backoff_s: float = 0.5,
                 backoff_max_s: float = 30.0):
        if mode not in ("train", "eval", "pred"):
            raise ValueError(f"bad mode {mode}")
        self.plan = plan
        self.mode = mode
        self.batch_size = batch_size
        self.flush_timeout_s = flush_timeout_s
        self.max_batches = max_batches
        self.host, self.port = host, port
        self.connect_timeout_s = connect_timeout_s
        self.reconnect = bool(reconnect)
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        self.transformer = transformer or default_transformer(
            plan, n_classes, pos_weight, neg_weight)
        self._native = hasattr(self.transformer, "transform_text")
        self.rows_seen = 0
        self.reconnects = 0

    def _read_one_connection(self) -> Iterator[Optional[str]]:
        """Lines from one connection, and None on each idle tick; returns
        on close or reset."""
        sock = socket.create_connection((self.host, self.port),
                                        timeout=self.connect_timeout_s)
        sock.settimeout(self.flush_timeout_s)
        buf = b""
        clean_close = False
        try:
            while True:
                try:
                    chunk = sock.recv(1 << 16)
                except socket.timeout:
                    yield None          # idle: the flush signal
                    continue
                except OSError:
                    break               # reset: a buffered tail is partial
                if not chunk:
                    clean_close = True
                    break
                buf += chunk
                while True:
                    nl = buf.find(b"\n")
                    if nl < 0:
                        break
                    line = buf[:nl].decode("utf-8", errors="replace")
                    buf = buf[nl + 1:]
                    if line.strip():
                        yield line
            # only a clean close may flush an unterminated tail (a producer
            # that wrote its last row without "\n"); after a reset the tail
            # is a truncated row, which must not be trained on
            if clean_close:
                tail = buf.decode("utf-8", errors="replace")
                if tail.strip():
                    yield tail
            elif buf.strip():
                log.warning("discarding %d bytes of a partial row after a "
                            "connection reset", len(buf))
        finally:
            sock.close()

    def _lines(self) -> Iterator[Optional[str]]:
        failures = 0
        while True:
            got_data = False
            try:
                for line in self._read_one_connection():
                    if line is not None:
                        got_data = True
                        failures = 0
                    yield line
            except OSError as e:
                if not self.reconnect:
                    raise
                log.warning("stream connect to %s:%d failed: %s",
                            self.host, self.port, e)
            if not self.reconnect:
                return
            if not got_data:
                failures += 1
                if failures > self.max_retries:
                    log.warning("stream ended: %d consecutive failed "
                                "connects to %s:%d", failures - 1,
                                self.host, self.port)
                    return
            yield None                  # flush what is buffered first
            self.reconnects += 1
            time.sleep(min(self.backoff_s * (2 ** max(failures - 1, 0)),
                           self.backoff_max_s))

    def _emit(self, chunk) -> Batch:
        if self._native:
            text = "\n".join(chunk).encode("utf-8", errors="replace")
            return self.transformer.transform_text(
                text, len(chunk), self.batch_size, self.mode)
        # the Python transformer indexes cells by schema position: a short
        # junk line would raise and end a continuous run, so it is skipped
        expect = len(self.plan.columns)
        rows = [cells for line in chunk
                if len(cells := line.split("\t")) == expect]
        if not rows:
            batch = self.transformer.transform([[""] * expect],
                                               self.batch_size, self.mode)
            batch["mask"] = batch["mask"] * 0.0
            batch["weight"] = batch["weight"] * 0.0
            return batch
        return self.transformer.transform(rows, self.batch_size, self.mode)

    def __iter__(self) -> Iterator[Batch]:
        chunk = []
        emitted = 0
        for line in self._lines():
            if line is None:            # idle flush
                if chunk:
                    yield self._emit(chunk)
                    emitted += 1
                    chunk = []
                    if self.max_batches and emitted >= self.max_batches:
                        return
                continue
            chunk.append(line)
            self.rows_seen += 1
            if len(chunk) == self.batch_size:
                yield self._emit(chunk)
                emitted += 1
                chunk = []
                if self.max_batches and emitted >= self.max_batches:
                    return
        if chunk:
            yield self._emit(chunk)


def serve_file(path: str, host: str = "127.0.0.1", port: int = 0,
               rows_per_s: Optional[float] = None, loop: bool = False):
    """Replay a TSV file as a line stream to one client.  -> (server
    socket, thread); the bound port is ``server_socket.getsockname()[1]``.
    Closing the server socket ends a thread still waiting for its
    client."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(1)

    def run():
        try:
            conn, _ = srv.accept()
        except OSError:
            return
        try:
            with conn:
                while True:
                    with open(path, "rb") as f:
                        for line in f:
                            conn.sendall(line)
                            if rows_per_s:
                                time.sleep(1.0 / rows_per_s)
                    if not loop:
                        break
        except OSError:
            pass
        finally:
            srv.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return srv, t
