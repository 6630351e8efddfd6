"""Scoring server: gRPC + raw-TCP transports over loaded bundles (the
port's counterpart of the JAX package's ``serving/server.py``).

Replaces ``tensorflow_model_server`` (the reference's
scripts/run_serving.sh:60-70): export bundles are loaded once onto the card,
requests (TSV rows) run through the same native feature transformer as
training, and concurrent requests are coalesced into one forward a
micro-batch, padded to one of a few fixed batch buckets.  Multiple named
models serve side by side (requests route by ``model_name``;
``tools/serve.py --model_config`` is the TF-Serving ``--model_config_file``
analog), each with its own version hot-reload.

Transports (see serving/protocol.py): the gRPC generic method for the
Python client and the load harness, and a length-prefixed TCP endpoint for
the native C++ client (cpp/serving_client.cc).  gRPC needs the ``grpc``
package; a server asked for it without the package raises, and serving TCP
alone is the caller's explicit choice (``port=None``).
"""

from __future__ import annotations

import concurrent.futures as futures
import contextlib
import hmac
import logging
import os
import queue
import socket
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from wide_deep_tpu_torch.features.pipeline import default_transformer
from wide_deep_tpu_torch.models.joint import resolve_device
from wide_deep_tpu_torch.serving import protocol
from wide_deep_tpu_torch.serving.export import (latest_version_dir,
                                                load_bundle)
from wide_deep_tpu_torch.training.loop import to_device
from wide_deep_tpu_torch.training.step import predict_step

log = logging.getLogger("wide_deep_tpu_torch.serving")


class MicroBatcher:
    """Coalesces concurrent scoring requests into one device call.

    The reference delegated serving to ``tensorflow_model_server`` whose
    ``--enable_batching`` queues concurrent requests and runs them as one
    session step (the reference's scripts/run_serving.sh:60-70,
    conf/serving.yaml).  Here: request threads enqueue ``(rows, future)``;
    one batcher thread drains the queue for up to ``batch_timeout_micros``
    (or until ``max_batch_size`` rows are pending), scores everything in one
    bucketed forward, and hands each request its window of the results.
    The device has a single owner thread, so no per-request lock serializes
    transports.
    """

    def __init__(self, score_fn, max_batch_size: int, timeout_micros: int):
        # List[str] -> (probs [N, C], ids [N], done event or None)
        self._score = score_fn
        self.max_batch_size = max(int(max_batch_size), 1)
        self.timeout_s = max(int(timeout_micros), 0) / 1e6
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        # serializes the stop-check-and-enqueue in submit against close()'s
        # stop/drain: without it a request thread could pass the stop check,
        # lose the CPU while close() sets stop + joins + drains, then enqueue
        # into a dead queue — its future would never resolve
        self._stop_lock = threading.Lock()
        self.device_calls = 0           # instrumentation (tests/bench)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, rows: List[str]) -> "futures.Future":
        """-> Future of (probs_all, ids_all, done, offset, n): the caller's
        window into the micro-batch results, readable once ``done`` (a CUDA
        event, None on the host) has completed."""
        fut: "futures.Future" = futures.Future()
        if not rows:
            fut.set_result((torch.zeros((0, 1)),
                            torch.zeros((0,), dtype=torch.int32), None, 0, 0))
            return fut
        with self._stop_lock:
            if not self._stop.is_set():
                self._q.put((rows, fut))
                return fut
        # a request that grabbed this model just before a hot-reload close()
        # must still complete — score synchronously in the caller thread
        # instead of enqueueing into a drained loop.  FIRST wait for the
        # batcher thread to finish its final drain: scoring inline while
        # it still runs would break the single-owner-device invariant
        # (two threads in _score concurrently) that close() itself
        # refuses to violate.
        self._thread.join()
        self._run([(rows, fut)])
        return fut

    def close(self):
        """Stop accepting work and drain: every already-submitted future
        resolves before close returns (hot-reload swaps rely on this)."""
        with self._stop_lock:
            self._stop.set()
        self._thread.join(timeout=10.0)
        if self._thread.is_alive():
            # a device call outlived the timed join; draining now would
            # break the single-owner-device invariant by scoring from two
            # threads — wait it out instead
            log.warning("batcher thread still scoring after 10s; waiting")
            self._thread.join()
        # resolve anything that raced the stop flag into the queue
        while True:
            try:
                self._run([self._q.get_nowait()])
            except queue.Empty:
                break

    def _loop(self):
        while True:
            try:
                items = [self._q.get(timeout=0.2)]
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            total = len(items[0][0])
            deadline = time.monotonic() + self.timeout_s
            while total < self.max_batch_size:
                wait = deadline - time.monotonic()
                try:
                    nxt = (self._q.get(timeout=wait) if wait > 0
                           else self._q.get_nowait())
                except queue.Empty:
                    break
                items.append(nxt)
                total += len(nxt[0])
            self._run(items)

    def _run(self, items: List[Tuple[List[str], "futures.Future"]]):
        rows = [r for rws, _ in items for r in rws]
        try:
            probs, ids, done = self._score(rows)
            self.device_calls += 1
        except Exception as e:  # noqa: BLE001 — propagate to every waiter
            for _, fut in items:
                if not fut.done():
                    fut.set_exception(e)
            return
        # every waiter gets the whole micro-batch's host tensors, the event
        # that says they are written, and its window: the batcher thread
        # goes on to the next micro-batch without waiting for the card; the
        # waiter thread waits on the event
        off = 0
        for rws, fut in items:
            n = len(rws)
            fut.set_result((probs, ids, done, off, n))
            off += n


class ServingModel:
    """A loaded bundle on a device, scoring TSV rows through a
    MicroBatcher; the card unless the caller passes ``device="cpu"``."""

    def __init__(self, version_dir: str, max_batch_size: int = 1024,
                 model_name: str = "wide_deep",
                 batch_timeout_micros: int = 2000, device=None):
        self.device = resolve_device(device)
        self.model, self.params, self.mstate, self.bundle = load_bundle(
            version_dir, device=self.device)
        self.version = os.path.basename(version_dir.rstrip("/"))
        self.model_name = model_name
        self.max_batch_size = max_batch_size
        # small requests run in the smallest fitting bucket instead of paying
        # a full max-batch forward
        self.batch_buckets = sorted({b for b in (16, 128, max_batch_size)
                                     if b <= max_batch_size})
        self.transformer = default_transformer(
            self.model.plan, self.bundle["n_classes"])
        self._native = hasattr(self.transformer, "transform_text")
        self._copy_stream = self._stream = None
        if self.device.type == "cuda":
            # the batch's copy and the forward each on a stream of the
            # model's own; the forward waits on the copy's event
            self._copy_stream = torch.cuda.Stream(self.device)
            self._stream = torch.cuda.Stream(self.device)
        self.batcher = MicroBatcher(self._score_texts, max_batch_size,
                                    batch_timeout_micros)

    def _bucket_for(self, n: int) -> int:
        for b in self.batch_buckets:
            if n <= b:
                return b
        return self.max_batch_size

    def close(self):
        self.batcher.close()

    def transform(self, rows: List[str], bucket: int) -> Dict[str, np.ndarray]:
        """Pre-validated TSV rows -> a host pred batch of ``bucket`` rows."""
        if self._native:
            text = "\n".join(rows).encode("utf-8", errors="replace")
            return self.transformer.transform_text(text, len(rows), bucket,
                                                   mode="pred")
        ncols = len(self.model.plan.columns)
        cells = [r.split("\t") for r in rows]
        cells = [([""] + c) if len(c) == ncols - 1 else c for c in cells]
        return self.transformer.transform(cells, bucket, mode="pred")

    def forward(self, batch: Dict[str, np.ndarray]
                ) -> Dict[str, torch.Tensor]:
        """One host batch through the model on the current stream: on the
        card, one pinned copy on the copy stream that the current stream
        waits for (training/loop.to_device, DeviceBatch.claim)."""
        if self.device.type == "cuda":
            dbatch = to_device(batch, self.device, self._copy_stream).claim()
        else:
            dbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
        with torch.inference_mode():
            return predict_step(self.model, self.params, self.mstate, dbatch)

    def _on_stream(self):
        return (torch.cuda.stream(self._stream) if self._stream is not None
                else contextlib.nullcontext())

    def warmup(self):
        """Run each bucket once on zero rows (the allocator's and the
        libraries' first-call costs)."""
        with self._on_stream():
            for bucket in self.batch_buckets:
                spec = self.model.plan.batch_spec(
                    bucket, self.bundle["n_classes"], mode="pred")
                self.forward({k: np.zeros(shape, dt)
                              for k, (shape, dt) in spec.items()})
        if self._stream is not None:
            self._stream.synchronize()

    def _score_texts(self, rows: List[str]):
        """Pre-validated TSV rows -> (probs [N, n_classes], class_ids [N],
        done): host tensors that are complete once ``done`` (a CUDA event;
        None on the host) has completed.

        Single-owner device path (called only from the MicroBatcher thread):
        chunks of up to max_batch_size run in the smallest fitting bucket.
        On the card every chunk's results are copied into pinned host
        tensors on the stream the forward ran on, so the copy follows the
        forward, and the batcher thread does not wait for either.
        """
        n_total = len(rows)
        pin = self.device.type == "cuda"
        probs = torch.empty((n_total, self.bundle["n_classes"]),
                            dtype=torch.float32, pin_memory=pin)
        ids = torch.empty((n_total,), dtype=torch.int32, pin_memory=pin)
        with self._on_stream():
            for start in range(0, n_total, self.max_batch_size):
                chunk = rows[start:start + self.max_batch_size]
                n = len(chunk)
                preds = self.forward(self.transform(
                    chunk, self._bucket_for(n)))
                probs[start:start + n].copy_(preds["probabilities"][:n],
                                             non_blocking=True)
                ids[start:start + n].copy_(preds["class_ids"][:n],
                                           non_blocking=True)
            done = None
            if self._stream is not None:
                done = torch.cuda.Event()
                done.record(self._stream)
        return probs, ids, done

    def score_rows(self, rows: List[str]) -> Dict:
        """TSV rows -> {"scores": [[...]], "class_ids": [...], "valid": [...]}.

        Rows are validated (column count) BEFORE batching so malformed rows
        can't shift the alignment of the packed batch; they come back with
        ``valid[i] = false`` and zero scores.  The device call goes through
        the MicroBatcher, which coalesces concurrent requests into one
        forward (tensorflow_model_server --enable_batching parity).
        """
        ncols = len(self.model.plan.columns)
        n_rows = len(rows)
        n_classes = self.bundle["n_classes"]
        scores: List[List[float]] = [[0.0] * n_classes
                                     for _ in range(n_rows)]
        class_ids: List[int] = [0] * n_rows
        valid: List[bool] = [False] * n_rows
        # embedded newlines are invalid too, not just wrong arity: the
        # native path joins the micro-batch with "\n" before the C++
        # line splitter, so a row containing its own "\n" would become
        # TWO rows, shifting every later row in the coalesced batch onto
        # another request's scores (cross-request corruption) while this
        # row's halves scored as valid
        keep = [(i, r) for i, r in enumerate(rows)
                if "\n" not in r and "\r" not in r
                and r.count("\t") + 1 in (ncols, ncols - 1)]
        if keep:
            probs, ids, done, off, n = self.batcher.submit(
                [r for _, r in keep]).result()
            if done is not None:
                done.synchronize()
            probs = probs[off:off + n].numpy()
            ids = ids[off:off + n].numpy()
            for j, (orig, _) in enumerate(keep):
                scores[orig] = list(map(float, probs[j]))
                class_ids[orig] = int(ids[j])
                valid[orig] = True
        return {"model_name": self.model_name, "scores": scores,
                "class_ids": class_ids, "valid": valid,
                "model_version": self.version}

    def handle_request(self, payload: bytes,
                       auth_token: Optional[str] = None,
                       req: Optional[Dict] = None) -> bytes:
        """``req``: the already-decoded request, when the router decoded
        it for model_name routing — JSON parse of a MAX_FRAME predict
        payload is the per-request CPU hot path, so it must not be paid
        twice."""
        try:
            if req is None:
                req = protocol.decode_request(payload)
            if auth_token:
                given = str(req.get("auth_token") or "")
                if not hmac.compare_digest(given, auth_token):
                    return protocol.encode_response(
                        {"error": "unauthorized"})
            if req.get("model_name") not in (None, "", self.model_name):
                return protocol.encode_response(
                    {"error": f"unknown model {req.get('model_name')!r}"})
            return protocol.encode_response(self.score_rows(req["rows"]))
        except Exception as e:  # noqa: BLE001 — serving boundary
            log.exception("request failed")
            return protocol.encode_response({"error": str(e)})


class PredictorServer:
    """Runs gRPC and TCP endpoints for one or more ServingModels.

    ``model`` may be a single ServingModel or a list — requests route by
    their ``model_name`` (the first model is the default for requests that
    omit it), the tensorflow_model_server ``--model_config_file`` analog.

    ``port``: the gRPC port, None for no gRPC endpoint; ``tcp_port``: the
    TCP port, default ``port + 1`` (with ``port`` 0 or None: any free one).
    Port 0 binds any free port; ``start`` stores the bound ones in
    ``self.port`` and ``self.tcp_port``.

    With ``model_base_path`` set (or ``model_base_paths``, a
    {model_name: base_path} map for multi-model), a background poller
    hot-reloads a model when a newer version directory appears (TF-Serving
    version-watch parity): the new bundle is loaded and warmed before the
    atomic swap, so in-flight requests never see a cold model."""

    def __init__(self, model, port: Optional[int] = 8500,
                 tcp_port: Optional[int] = None, workers: int = 8,
                 model_base_path: Optional[str] = None,
                 reload_interval_s: float = 10.0,
                 auth_token: Optional[str] = None,
                 tls_cert: Optional[str] = None,
                 tls_key: Optional[str] = None,
                 tls_ca: Optional[str] = None,
                 model_base_paths: Optional[Dict[str, str]] = None,
                 max_tcp_connections: Optional[int] = None,
                 tcp_idle_timeout_s: float = 300.0):
        # auth_token: shared-secret request auth on BOTH transports (the
        # reference's tensorflow_model_server shipped unauthenticated;
        # serving.yaml server.auth_token enables this)
        self.auth_token = auth_token or None
        # tls_cert/tls_key: PEM server certificate + key — enables TLS on
        # BOTH transports (gRPC secure port + an ssl-wrapped TCP endpoint
        # for the Python TcpPredictorClient; the native C++ client is
        # plaintext-only — front it with a TLS-terminating proxy when the
        # transport must be encrypted).  tls_ca: PEM CA bundle — when set,
        # clients must present a certificate it signed (mutual TLS).
        self.tls_cert = tls_cert or None
        self.tls_key = tls_key or None
        self.tls_ca = tls_ca or None
        if self.tls_cert and not self.tls_key:
            raise ValueError("tls_cert requires tls_key")
        self._ssl_ctx = None
        if self.tls_cert:
            import ssl
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(self.tls_cert, self.tls_key)
            if self.tls_ca:
                ctx.load_verify_locations(self.tls_ca)
                ctx.verify_mode = ssl.CERT_REQUIRED
            self._ssl_ctx = ctx
        ms = list(model) if isinstance(model, (list, tuple)) else [model]
        if not ms:
            raise ValueError("PredictorServer needs at least one model")
        self.models: Dict[str, ServingModel] = {m.model_name: m for m in ms}
        if len(self.models) != len(ms):
            raise ValueError(
                f"duplicate model names: {[m.model_name for m in ms]}")
        self._default_name = ms[0].model_name
        self.port = port
        self.tcp_port = (tcp_port if tcp_port is not None
                         else port + 1 if port else 0)
        self.workers = workers
        # concurrent TCP connection cap (threads + fds); over-limit
        # connects get an ERR frame and a close, not a silent timeout
        self.max_tcp_connections = (max_tcp_connections
                                    if max_tcp_connections is not None
                                    else max(32 * workers, 64))
        self.tcp_idle_timeout_s = tcp_idle_timeout_s
        self._tcp_live = 0
        self._tcp_count_lock = threading.Lock()
        self.model_base_path = model_base_path
        # name -> watched bundle root; single-model model_base_path folds in
        self._watch: Dict[str, str] = dict(model_base_paths or {})
        if model_base_path:
            self._watch[self._default_name] = model_base_path
        unknown = set(self._watch) - set(self.models)
        if unknown:
            raise ValueError(f"model_base_paths for unserved models: "
                             f"{sorted(unknown)}")
        self.reload_interval_s = reload_interval_s
        self._grpc_server = None
        self._tcp_sock = None
        self._tcp_thread = None
        self._reload_thread = None
        self._stop = threading.Event()

    @property
    def model(self) -> ServingModel:
        """The default model (single-model accessor)."""
        return self.models[self._default_name]

    # ----------------------------------------------------------------- route
    def _check_auth(self, req: Dict) -> bool:
        if not self.auth_token:
            return True
        given = str(req.get("auth_token") or "")
        return hmac.compare_digest(given, self.auth_token)

    def _handle(self, payload: bytes) -> bytes:
        """Route a request to its model by ``model_name`` (empty/omitted ->
        the default model), then defer to the model's handler (which also
        does the auth check).  ``{"op": "status"}`` requests (TF-Serving
        GetModelStatus analog) answer without scoring."""
        # status sniff: status requests are tiny, so large predict payloads
        # are never scanned or double-decoded; a small predict row that
        # happens to contain '"op"' just pays one extra JSON decode
        if len(payload) < 4096 and b'"op"' in payload:
            try:
                req = protocol.decode_request(payload)
            except Exception as e:  # noqa: BLE001 — serving boundary
                return protocol.encode_response({"error": str(e)})
            if req.get("op") == "status":
                return self._status(req)
        if len(self.models) == 1:
            return self.model.handle_request(payload, self.auth_token)
        try:
            req = protocol.decode_request(payload)
        except Exception as e:  # noqa: BLE001 — serving boundary
            return protocol.encode_response({"error": str(e)})
        name = req.get("model_name")
        m = self.models.get(name or self._default_name)
        if m is None:
            return protocol.encode_response(
                {"error": f"unknown model {name!r} (serving: "
                          f"{sorted(self.models)})"})
        # pass the decoded request along — the handler must not re-parse
        return m.handle_request(payload, self.auth_token, req=req)

    def _status(self, req: Dict) -> bytes:
        """Serve-state snapshot per model (name, version, batching limits,
        device-call count).  Auth applies like scoring."""
        if not self._check_auth(req):
            return protocol.encode_response({"error": "unauthorized"})
        return protocol.encode_response({"models": [
            {"name": m.model_name, "version": m.version,
             "state": "AVAILABLE", "max_batch_size": m.max_batch_size,
             "n_classes": m.bundle["n_classes"],
             "device_calls": m.batcher.device_calls}
            for m in self.models.values()]})

    # ------------------------------------------------------------ hot reload
    def reload_once(self):
        """One pass of the version watch: each watched model whose base
        path holds a newer version is replaced by it, loaded and warmed
        first, then swapped in, then the old one closed (its in-flight
        micro-batches finish first).  A load that fails keeps the old
        version and frees what the new one had started."""
        for name, base in self._watch.items():
            cur = self.models[name]
            try:
                latest = latest_version_dir(base)
            except OSError:
                continue
            if os.path.basename(latest.rstrip("/")) == cur.version:
                continue
            new_model = None
            try:
                log.info("loading new %s version from %s", name, latest)
                new_model = ServingModel(
                    latest, cur.max_batch_size, name,
                    batch_timeout_micros=cur.batcher.timeout_s * 1e6,
                    device=cur.device)
                new_model.warmup()
                self.models[name] = new_model  # atomic reference swap
                new_model = None  # ownership transferred
                log.info("now serving %s version %s", name,
                         self.models[name].version)
                cur.close()  # in-flight batches finish first
            except Exception:  # noqa: BLE001 — keep the old version
                log.exception("hot reload failed; keeping %s version %s",
                              name, cur.version)
                # a partially-built model already started its MicroBatcher
                # thread, which pins the bundle's tensors while it runs —
                # and this reload retries every interval, leaking one
                # bundle per attempt
                if new_model is not None:
                    try:
                        new_model.close()
                    except Exception:  # noqa: BLE001
                        log.exception("failed-reload cleanup error")

    def _reload_loop(self):
        while not self._stop.wait(self.reload_interval_s):
            self.reload_once()

    # ------------------------------------------------------------------ gRPC
    def _build_grpc(self):
        try:
            import grpc
        except ImportError as e:
            raise RuntimeError(
                "a gRPC endpoint needs the grpc package (grpcio), which "
                "cannot be imported here; serve TCP alone with port=None "
                "(tools/serve.py --transport tcp)") from e

        outer = self

        class Handler(grpc.GenericRpcHandler):
            def service(self, handler_call_details):
                if handler_call_details.method != protocol.GRPC_METHOD:
                    return None
                return grpc.unary_unary_rpc_method_handler(
                    lambda req, ctx: outer._handle(req),
                    request_deserializer=lambda b: b,
                    response_serializer=lambda b: b)

        server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=self.workers))
        server.add_generic_rpc_handlers((Handler(),))
        if self.tls_cert:
            with open(self.tls_key, "rb") as f:
                key = f.read()
            with open(self.tls_cert, "rb") as f:
                cert = f.read()
            ca = None
            if self.tls_ca:
                with open(self.tls_ca, "rb") as f:
                    ca = f.read()
            creds = grpc.ssl_server_credentials(
                [(key, cert)], root_certificates=ca,
                require_client_auth=ca is not None)
            self.port = server.add_secure_port(f"[::]:{self.port}", creds)
        else:
            self.port = server.add_insecure_port(f"[::]:{self.port}")
        return server

    # ------------------------------------------------------------------- TCP
    def _tcp_loop(self):
        # one thread per CONNECTION, not a bounded worker pool: _tcp_conn
        # holds its worker for the connection's whole lifetime, so a pool
        # of size N silently starves client N+1 (its requests time out
        # with zero server-side signal).  Device work stays bounded by the
        # MicroBatcher regardless of fan-in; CONNECTION count is still
        # bounded (max_tcp_connections, default 32x workers) so connection
        # churn or a runaway client exhausts neither threads nor fds —
        # over-limit connects are refused with an ERR frame instead of
        # queueing into a timeout.
        while not self._stop.is_set():
            try:
                conn, _ = self._tcp_sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            with self._tcp_count_lock:
                if self._tcp_live >= self.max_tcp_connections:
                    # the ERR frame is PLAINTEXT — under TLS the client is
                    # waiting for a ServerHello and raw frame bytes would
                    # surface as a cryptic handshake failure, so close
                    # silently there (the log line is the diagnostic)
                    log.warning("tcp connection refused: limit %d reached",
                                self.max_tcp_connections)
                    if self._ssl_ctx is None:
                        try:
                            protocol.send_frame(
                                conn, protocol.encode_response(
                                    {"error": "connection limit reached "
                                     f"({self.max_tcp_connections})"}))
                        except OSError:
                            pass
                    try:
                        conn.close()
                    except OSError:
                        pass
                    continue
                self._tcp_live += 1
            # idle read timeout: a dead/half-open client must not hold a
            # connection-cap slot (and its thread) forever — accepted
            # sockets are otherwise blocking regardless of the listener's
            # accept timeout
            conn.settimeout(self.tcp_idle_timeout_s)
            threading.Thread(target=self._tcp_conn, args=(conn,),
                             daemon=True).start()

    def _tcp_conn(self, conn: socket.socket):
        try:
            self._tcp_conn_inner(conn)
        finally:
            with self._tcp_count_lock:
                self._tcp_live -= 1

    def _tcp_conn_inner(self, conn: socket.socket):
        try:
            if self._ssl_ctx is not None:
                # handshake runs in this worker thread, never the accept loop
                try:
                    conn = self._ssl_ctx.wrap_socket(conn, server_side=True)
                except OSError as e:
                    log.warning("tls handshake failed: %s", e)
                    try:
                        conn.close()
                    except OSError:
                        pass
                    return
            with conn:
                while not self._stop.is_set():
                    try:
                        payload = protocol.recv_frame(conn)
                    except IOError:
                        return
                    protocol.send_frame(conn, self._handle(payload))
        except Exception:  # noqa: BLE001
            log.exception("tcp connection error")

    # ----------------------------------------------------------------- start
    def start(self):
        """Bind and start the endpoints (and the version watch); a port
        that cannot be bound, or gRPC without its package, raises here."""
        if self.port is not None:
            self._grpc_server = self._build_grpc()
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.bind(("0.0.0.0", self.tcp_port))
            sock.listen(64)
            sock.settimeout(0.5)
        except OSError:
            sock.close()
            raise
        self._tcp_sock = sock
        self.tcp_port = sock.getsockname()[1]
        if self._grpc_server is not None:
            self._grpc_server.start()
        self._tcp_thread = threading.Thread(target=self._tcp_loop,
                                            daemon=True)
        self._tcp_thread.start()
        if self._watch:
            self._reload_thread = threading.Thread(target=self._reload_loop,
                                                   daemon=True)
            self._reload_thread.start()
        log.info("serving %s: %s tcp :%d",
                 ", ".join(f"{m.model_name} (version {m.version})"
                           for m in self.models.values()),
                 f"grpc :{self.port}," if self._grpc_server else "no grpc,",
                 self.tcp_port)

    def wait(self):
        if self._grpc_server is not None:
            self._grpc_server.wait_for_termination()
        else:
            self._stop.wait()

    def stop(self, grace: float = 1.0):
        self._stop.set()
        if self._grpc_server:
            self._grpc_server.stop(grace)
        if self._tcp_sock:
            try:
                self._tcp_sock.close()
            except OSError:
                pass
        for t in (self._tcp_thread, self._reload_thread):
            if t is not None:
                t.join(timeout=2.0)
