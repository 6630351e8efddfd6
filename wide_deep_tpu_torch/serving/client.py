"""Python serving clients, the native C++ client's build, and the threaded
load-test harnesses (the port's counterpart of the JAX package's
``serving/client.py``).

Parity with the reference gRPC client (its
python/tensorflow_serving/client.py): sends TSV rows to the scoring service
and reads back per-row scores; includes the concurrency-throttled inference
benchmark the reference sketched at client.py:40-137 (built here without
the dead code paths).  ``build_cpp_client`` compiles the native client,
``cpp/serving_client.cc``, as ``features/native.py`` compiles the loader:
into ``build/native/`` at first use, never the binary committed in
``cpp/``, which was built with ``-march=native`` on another host.
"""

from __future__ import annotations

import os
import socket
import threading
import time
from typing import Dict, List

from wide_deep_tpu_torch.features import native
from wide_deep_tpu_torch.serving import protocol

CLIENT_SOURCE = os.path.join(native.REPO_ROOT, "cpp", "serving_client.cc")
# cpp/Makefile's serving_client rule: its CXXFLAGS, linked as a program
CLIENT_FLAGS = ("-O3", "-march=native", "-std=c++20", "-Wall", "-Wextra",
                "-fPIC")


def build_cpp_client() -> Dict[str, object]:
    """Compile ``cpp/serving_client.cc`` into
    ``build/native/serving_client_<digest>`` unless this host's build
    exists (``features/native.compile_cached``).  -> {"path", "built",
    "seconds"}; raises with the compiler's output when it fails, and when
    there is no C++ compiler."""
    return native.compile_cached(CLIENT_SOURCE, CLIENT_FLAGS,
                                 "serving_client")


class PredictorClient:
    """gRPC transport (uses the generic method, no generated stubs).

    ``tls_ca``: PEM root certificate(s) — switches to a secure channel
    (required against a TLS server).  ``tls_cert``/``tls_key``: client
    certificate + key for mutual TLS."""

    def __init__(self, host: str = "localhost", port: int = 8500,
                 model_name: str = "wide_deep", timeout: float = 30.0,
                 auth_token: str = None, tls_ca: str = None,
                 tls_cert: str = None, tls_key: str = None):
        import grpc
        self.model_name = model_name
        self.timeout = timeout
        self.auth_token = auth_token
        if tls_ca or tls_cert:
            def rd(path):
                if not path:
                    return None
                with open(path, "rb") as f:
                    return f.read()
            creds = grpc.ssl_channel_credentials(
                root_certificates=rd(tls_ca), private_key=rd(tls_key),
                certificate_chain=rd(tls_cert))
            self._channel = grpc.secure_channel(f"{host}:{port}", creds)
        else:
            self._channel = grpc.insecure_channel(f"{host}:{port}")
        self._call = self._channel.unary_unary(
            protocol.GRPC_METHOD,
            request_serializer=lambda b: b,
            response_deserializer=lambda b: b)

    def predict(self, rows: List[str]) -> Dict:
        payload = protocol.encode_request(rows, self.model_name,
                                          auth_token=self.auth_token)
        resp = protocol.decode_response(
            self._call(payload, timeout=self.timeout))
        if "error" in resp:
            raise RuntimeError(f"server error: {resp['error']}")
        return resp

    def status(self) -> Dict:
        """Served models + versions (TF-Serving GetModelStatus analog)."""
        resp = protocol.decode_response(self._call(
            protocol.encode_status_request(self.auth_token),
            timeout=self.timeout))
        if "error" in resp:
            raise RuntimeError(f"server error: {resp['error']}")
        return resp

    def close(self):
        self._channel.close()


class TcpPredictorClient:
    """Raw-TCP transport (same frames as the C++ client).

    ``tls_ca`` wraps the connection in TLS (server cert verified against
    it; hostname checked); ``tls_cert``/``tls_key`` add a client cert for
    mutual TLS.  The native C++ client has no TLS — pair it with a
    TLS-terminating proxy when the transport must be encrypted."""

    def __init__(self, host: str = "localhost", port: int = 8501,
                 model_name: str = "wide_deep", timeout: float = 30.0,
                 auth_token: str = None, tls_ca: str = None,
                 tls_cert: str = None, tls_key: str = None):
        self.model_name = model_name
        self.auth_token = auth_token
        self._host, self._port, self._timeout = host, port, timeout
        self._tls = (tls_ca, tls_cert, tls_key)
        # one connection PER THREAD: a request is a send+recv frame pair
        # on one socket, so two threads sharing a socket interleave frames
        # and corrupt both streams (the do_inference load harness fires
        # from worker threads; gRPC channels are thread-safe, raw sockets
        # are not — same family as the TLS-proxy SSLSocket lesson).
        # Each thread's socket lives in a holder whose finalizer closes
        # it when the THREAD dies (thread-local storage is destroyed at
        # thread exit) — without it, short-lived request threads would
        # leak one open connection each until client.close().
        self._local = threading.local()
        self._conns: Dict[int, socket.socket] = {}
        self._conns_lock = threading.Lock()
        self._connect()  # fail fast on a bad address/cert

    class _SockHolder:
        def __init__(self, sock, registry, lock):
            self.sock, self._registry, self._lock = sock, registry, lock
            with lock:
                registry[id(self)] = sock

        def discard(self):
            with self._lock:
                self._registry.pop(id(self), None)
            try:
                self.sock.close()
            except OSError:
                pass

        def __del__(self):  # thread exit drops its thread-local refs
            self.discard()

    def _connect(self) -> socket.socket:
        holder = getattr(self._local, "holder", None)
        if holder is not None:
            return holder.sock
        sock = socket.create_connection((self._host, self._port),
                                        timeout=self._timeout)
        tls_ca, tls_cert, tls_key = self._tls
        # TLS engages when EITHER flag is given (like the gRPC client):
        # gating on tls_ca alone meant --tls_cert without --tls_ca
        # silently connected in PLAINTEXT, never presenting the client
        # cert.  Without an explicit CA the system trust store verifies
        # the server.
        if tls_ca or tls_cert:
            import ssl
            if tls_ca:
                ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
                ctx.load_verify_locations(tls_ca)
            else:
                ctx = ssl.create_default_context()
            if tls_cert:
                ctx.load_cert_chain(tls_cert, tls_key)
            sock = ctx.wrap_socket(sock, server_hostname=self._host)
        self._local.holder = TcpPredictorClient._SockHolder(
            sock, self._conns, self._conns_lock)
        return sock

    def _drop(self):
        """A failed request leaves its socket mid-frame — discard it so
        this thread's next call reconnects cleanly."""
        holder = getattr(self._local, "holder", None)
        if holder is not None:
            self._local.holder = None
            holder.discard()

    def _roundtrip(self, payload: bytes) -> Dict:
        sock = self._connect()
        try:
            protocol.send_frame(sock, payload)
            resp = protocol.decode_response(protocol.recv_frame(sock))
        except Exception:
            self._drop()
            raise
        if "error" in resp:
            raise RuntimeError(f"server error: {resp['error']}")
        return resp

    def predict(self, rows: List[str]) -> Dict:
        return self._roundtrip(protocol.encode_request(
            rows, self.model_name, auth_token=self.auth_token))

    def status(self) -> Dict:
        """Served models + versions (TF-Serving GetModelStatus analog)."""
        return self._roundtrip(
            protocol.encode_status_request(self.auth_token))

    def close(self):
        with self._conns_lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for sock in conns:
            try:
                sock.close()
            except OSError:
                pass


# ------------------------------------------------------------- load testing
class _ResultCounter:
    """Concurrency throttle + latency stats (client.py:40-87 parity)."""

    def __init__(self, num_requests: int, concurrency: int):
        self._num_requests = num_requests
        self._concurrency = concurrency
        self._done = 0
        self._active = 0
        self._errors = 0
        self._latencies: List[float] = []
        self._cv = threading.Condition()

    def throttle(self):
        with self._cv:
            while self._active >= self._concurrency:
                self._cv.wait()
            self._active += 1

    def record(self, latency: float, error: bool):
        with self._cv:
            self._active -= 1
            self._done += 1
            self._errors += int(error)
            self._latencies.append(latency)
            self._cv.notify()

    def wait_all(self):
        with self._cv:
            while self._done < self._num_requests:
                self._cv.wait()

    def stats(self) -> Dict[str, float]:
        lat = sorted(self._latencies)
        n = len(lat)
        return {
            "requests": n,
            "errors": self._errors,
            "p50_ms": lat[n // 2] * 1e3 if n else 0.0,
            "p99_ms": lat[min(int(n * 0.99), n - 1)] * 1e3 if n else 0.0,
            "mean_ms": sum(lat) / n * 1e3 if n else 0.0,
        }


def _open_loop_worker(kind: str, host: str, port: int, model_name: str,
                      rows: List[str], rate: float, duration_s: float,
                      rows_per_request: int, out_q) -> None:
    """One load-generator process: fires requests on a FIXED schedule
    (open loop — sends do not wait for completions, so server latency
    cannot throttle the offered load the way the closed-loop harness's
    GIL-bound request threads do).  Results go back via out_q."""
    import concurrent.futures as futures

    cls = TcpPredictorClient if kind == "tcp" else PredictorClient
    # gRPC channels are thread-safe; the framed-TCP transport is
    # one-request-per-connection-at-a-time, so each pool THREAD gets its
    # own connection (a fixed modulo pool would let two in-flight requests
    # share — and corrupt — one socket under overload, exactly the regime
    # an open-loop harness exists to measure)
    client = cls(host=host, port=port, model_name=model_name)
    tls = threading.local()

    def _client():
        if kind != "tcp":
            return client
        c = getattr(tls, "client", None)
        if c is None:
            c = cls(host=host, port=port, model_name=model_name)
            tls.client = c
        return c

    pool = futures.ThreadPoolExecutor(max_workers=64)
    pending = []
    t0 = time.time()
    i = 0
    n_rows = max(len(rows) - rows_per_request, 1)
    while True:
        t_next = t0 + i / rate
        if t_next - t0 >= duration_s:
            break
        delay = t_next - time.time()
        if delay > 0:
            time.sleep(delay)

        def fire(idx=i):
            start = idx * rows_per_request % n_rows
            chunk = rows[start:start + rows_per_request]
            c = _client()
            t_send = time.time()
            try:
                c.predict(chunk)
                return time.time() - t_send, False
            except Exception:  # noqa: BLE001
                return time.time() - t_send, True

        pending.append(pool.submit(fire))
        i += 1
    results = [f.result() for f in pending]
    pool.shutdown()
    out_q.put({"sent": len(results),
               "errors": sum(int(e) for _, e in results),
               "latencies": [lat for lat, _ in results]})


def open_loop_inference(rows: List[str], rate: float, duration_s: float,
                        rows_per_request: int = 1, processes: int = 4,
                        host: str = "localhost", port: int = 8500,
                        model_name: str = "wide_deep",
                        kind: str = "grpc") -> Dict[str, float]:
    """Open-loop load: ``rate`` requests/s offered for ``duration_s``,
    split across ``processes`` generator processes (no shared GIL), each
    firing on its own fixed schedule.  Returns achieved throughput +
    latency percentiles at that offered load."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    procs = [
        ctx.Process(target=_open_loop_worker,
                    args=(kind, host, port, model_name, rows,
                          rate / processes, duration_s, rows_per_request,
                          out_q), daemon=True)
        for _ in range(processes)]
    t0 = time.time()
    for p in procs:
        p.start()
    parts = [out_q.get() for _ in procs]
    for p in procs:
        p.join()
    wall = time.time() - t0
    lat = sorted(x for part in parts for x in part["latencies"])
    n = len(lat)
    sent = sum(p["sent"] for p in parts)
    errors = sum(p["errors"] for p in parts)
    return {
        "offered_rps": rate,
        "sent": sent,
        "errors": errors,
        "achieved_rows_per_s": (sent - errors) * rows_per_request
                               / max(duration_s, 1e-9),
        "wall_s": wall,
        "p50_ms": lat[n // 2] * 1e3 if n else 0.0,
        "p99_ms": lat[min(int(n * 0.99), n - 1)] * 1e3 if n else 0.0,
        "mean_ms": sum(lat) / n * 1e3 if n else 0.0,
    }


def do_inference(client: PredictorClient, rows: List[str],
                 num_requests: int, concurrency: int,
                 rows_per_request: int = 1) -> Dict[str, float]:
    """Fire num_requests predictions with bounded concurrency; returns
    latency stats + throughput."""
    counter = _ResultCounter(num_requests, concurrency)
    t_start = time.time()

    def one(i: int):
        start = i * rows_per_request % max(len(rows) - rows_per_request, 1)
        chunk = rows[start:start + rows_per_request]
        t0 = time.time()
        err = False
        try:
            client.predict(chunk)
        except Exception:  # noqa: BLE001
            err = True
        counter.record(time.time() - t0, err)

    for i in range(num_requests):
        counter.throttle()
        threading.Thread(target=one, args=(i,), daemon=True).start()
    counter.wait_all()
    stats = counter.stats()
    wall = time.time() - t_start
    stats["rows_per_s"] = num_requests * rows_per_request / wall
    return stats
