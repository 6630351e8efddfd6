#!/usr/bin/env python
"""Client-side TLS-terminating proxy for plaintext clients (the port's own
copy of tools/tls_proxy.py; standard library only).

The C++ serving client (cpp/serving_client.cc, built by
``wide_deep_tpu_torch.serving.client.build_cpp_client``) speaks the framed-
TCP protocol in plaintext.  This proxy listens on a local plaintext port
and forwards each connection over TLS (with optional mutual TLS) to the
scoring server's TLS TCP port (``PredictorServer(tls_cert=..., tls_key=...)``,
``tools.serve --tls_cert/--tls_key``), so

    build/native/serving_client_<digest> --server_port=<local> ...

scores against a TLS-only deployment.  A protocol-agnostic byte pump: it
fronts the gRPC port as well.

Usage:
    python -m wide_deep_tpu_torch.tools.tls_proxy --listen_port 18601 \
        --target_host scoring.prod --target_port 18501 \
        --tls_ca ca.pem [--tls_cert client.pem --tls_key client.key]

TLS termination in a sidecar is the standard pairing for clients without
TLS support.
"""

from __future__ import annotations

import argparse
import logging
import selectors
import socket
import ssl
import sys
import threading

log = logging.getLogger("wide_deep_tpu_torch.tls_proxy")


def make_client_context(tls_ca: str | None, tls_cert: str | None = None,
                        tls_key: str | None = None) -> ssl.SSLContext:
    # create_default_context already loads the system store when cafile
    # is None — no explicit load_default_certs needed
    ctx = ssl.create_default_context(ssl.Purpose.SERVER_AUTH, cafile=tls_ca)
    if tls_cert:
        ctx.load_cert_chain(tls_cert, tls_key)
    return ctx


def _pump_bidirectional(conn: socket.socket, up: ssl.SSLSocket) -> None:
    """Single-threaded bidirectional byte pump.

    Both directions MUST run in one thread: Python SSL sockets are not
    thread-safe for concurrent use (the GIL is released inside OpenSSL, so
    a recv in one thread racing a send in another corrupts the connection
    state — seen as intermittently lost request bytes and spurious
    SSLEOFError under load).  Non-blocking sockets + a selector alternate
    the two directions; a closed side shuts the other's write half so
    in-flight responses still drain.

    Backpressure: a side whose peer has >= _MAX_PENDING undelivered bytes
    stops being read until the backlog drains (the old blocking sendall's
    throttling, re-expressed for the selector loop).  A send that raises
    SSLWantReadError parks its WRITE interest until the next successful
    read on that socket (no busy-spin on an always-writable fd).
    """
    conn.setblocking(False)
    up.setblocking(False)
    sel = selectors.DefaultSelector()
    other = {conn: up, up: conn}
    pending = {conn: b"", up: b""}    # bytes waiting to be SENT to key
    read_open = {conn: True, up: True}
    stalled = {conn: False, up: False}   # send wants a TLS read first

    def _interest(s) -> int:
        ev = 0
        if read_open[s] and len(pending[other[s]]) < _MAX_PENDING:
            ev |= selectors.EVENT_READ
        if pending[s] and not stalled[s]:
            ev |= selectors.EVENT_WRITE
        return ev

    def _update(s):
        ev = _interest(s)
        try:
            if ev:
                try:
                    sel.modify(s, ev, None)
                except KeyError:
                    sel.register(s, ev, None)
            else:
                sel.unregister(s)
        except (KeyError, ValueError):
            pass

    def _recv_into(src) -> None:
        """Drain readable/SSL-buffered bytes from src into pending[dst]."""
        dst = other[src]
        while read_open[src] and len(pending[dst]) < _MAX_PENDING:
            try:
                data = src.recv(65536)
            except (ssl.SSLWantReadError, ssl.SSLWantWriteError,
                    BlockingIOError):
                # a recv ATTEMPT happened: even when it yields no app
                # data (e.g. it consumed a renegotiation/KeyUpdate
                # record), a send parked on SSLWantReadError may now
                # proceed — leaving it stalled here deadlocks the
                # connection when the peer only ever sends handshake
                # records
                stalled[src] = False
                break
            except OSError:
                data = b""
            if not data:
                read_open[src] = False
                try:
                    if not pending[dst]:
                        dst.shutdown(socket.SHUT_WR)
                except OSError:
                    pass
                break
            stalled[src] = False  # a read happened; parked sends may retry
            pending[dst] += data
            # an SSLSocket can hold decrypted bytes beyond the last fd
            # readiness — drain them now or they wait for the NEXT record
            if not (isinstance(src, ssl.SSLSocket) and src.pending()):
                break
        _update(src)  # clearing stalled[src] re-adds WRITE interest, so
        _update(dst)  # the next select retries the parked send

    def _send_from(s) -> bool:
        """Flush pending[s]; False = fatal error, close everything."""
        try:
            n = s.send(pending[s])
        except ssl.SSLWantReadError:
            stalled[s] = True
            n = 0
        except (ssl.SSLWantWriteError, BlockingIOError):
            n = 0
        except OSError:
            return False
        if n:
            pending[s] = pending[s][n:]
        if not pending[s] and not read_open[other[s]]:
            try:
                s.shutdown(socket.SHUT_WR)
            except OSError:
                pass
        _update(s)
        _update(other[s])  # draining may resume the peer's read interest
        return True

    sel.register(conn, selectors.EVENT_READ, None)
    sel.register(up, selectors.EVENT_READ, None)
    try:
        # app data decrypted during the blocking handshake (a
        # server-speaks-first protocol) never makes the fd readable —
        # drain the SSL buffer before the first select
        if up.pending():
            _recv_into(up)
        while (read_open[conn] or read_open[up]
               or pending[conn] or pending[up]):
            if not sel.get_map():
                return  # nothing can make progress (e.g. stalled send
                        # whose peer already hit EOF)
            for key, mask in sel.select(timeout=1.0):
                s = key.fileobj
                if mask & selectors.EVENT_WRITE and pending[s]:
                    if not _send_from(s):
                        return
                if mask & selectors.EVENT_READ:
                    _recv_into(s)
    finally:
        sel.close()


_MAX_PENDING = 1 << 20   # per-direction buffered-bytes cap (backpressure)


class TlsProxy:
    """Plaintext listener -> TLS upstream, one pump thread per connection."""

    def __init__(self, target_host: str, target_port: int,
                 listen_port: int = 0, listen_host: str = "127.0.0.1",
                 tls_ca: str | None = None, tls_cert: str | None = None,
                 tls_key: str | None = None, server_hostname: str | None = None):
        self.target = (target_host, int(target_port))
        self.server_hostname = server_hostname or target_host
        self.ctx = make_client_context(tls_ca, tls_cert, tls_key)
        self._stop = threading.Event()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((listen_host, int(listen_port)))
        self.port = self._sock.getsockname()[1]
        self._sock.listen(64)
        self._sock.settimeout(0.5)
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()
        log.info("tls proxy: plaintext :%d -> tls %s:%d", self.port,
                 self.target[0], self.target[1])

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        if self._thread:
            self._thread.join(timeout=2.0)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, peer = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn, peer),
                             daemon=True).start()

    def _serve(self, conn: socket.socket, peer) -> None:
        try:
            raw = socket.create_connection(self.target, timeout=30.0)
            up = self.ctx.wrap_socket(raw,
                                      server_hostname=self.server_hostname)
            # the 30 s covers connect + TLS handshake only.  It must NOT
            # ride on the established tunnel: create_connection leaves the
            # timeout on the socket, so a server response slower than 30 s
            # (a first request that loads a model) would time out the
            # upstream pump, which closes the CLIENT mid-frame with no log
            up.settimeout(None)
        except (OSError, ssl.SSLError) as e:
            log.warning("upstream connect failed for %s: %s", peer, e)
            conn.close()
            return
        try:
            _pump_bidirectional(conn, up)
        finally:
            for s in (conn, up):
                try:
                    s.close()
                except OSError:
                    pass


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--listen_port", type=int, default=18601)
    p.add_argument("--listen_host", default="127.0.0.1",
                   help="bind address for the PLAINTEXT side (keep it "
                        "loopback: traffic to this port is unencrypted)")
    p.add_argument("--target_host", required=True)
    p.add_argument("--target_port", type=int, required=True)
    p.add_argument("--tls_ca", help="CA bundle to verify the server "
                                    "(default: system store)")
    p.add_argument("--tls_cert", help="client certificate (mutual TLS)")
    p.add_argument("--tls_key", help="client private key (mutual TLS)")
    p.add_argument("--server_hostname",
                   help="SNI/verification name if it differs from "
                        "--target_host")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    proxy = TlsProxy(args.target_host, args.target_port,
                     listen_port=args.listen_port,
                     listen_host=args.listen_host, tls_ca=args.tls_ca,
                     tls_cert=args.tls_cert, tls_key=args.tls_key,
                     server_hostname=args.server_hostname)
    proxy.start()
    print(f"tls proxy on :{proxy.port} -> "
          f"{args.target_host}:{args.target_port}", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        proxy.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
