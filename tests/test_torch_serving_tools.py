"""The port's TLS proxy and serving SLO tool on the CPU
(``wide_deep_tpu_torch/tools/tls_proxy.py``, ``.../serving_slo.py``).

The proxy cases are the port's copies of tests/test_serving.py's
``test_tls_proxy_fronts_plaintext_clients`` and
``test_proxy_tunnel_has_no_read_timeout``: through the proxy, the plaintext
Python TCP client gets the direct TLS client's scores exactly and the C++
client (built by the port into build/native/) prints them to its printed
digit; the established tunnel carries no read timeout.  The SLO cases hold
``check``'s pass and fail logic on a hand-written budget and drive
``measure`` and ``main`` over TCP at a handful of requests.  The bundle is
a freshly initialized small-conf model exported by the port (served with
``device="cpu"``); sockets bind port 0 and read the bound port back.
"""

import json
import os
import shutil
import socket
import ssl
import subprocess
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from paths import PRED1  # noqa: E402
from test_torch_features import write_conf  # noqa: E402

TIMEOUT = 30.0


def read_rows(path, n):
    with open(path) as f:
        return [line.rstrip("\n") for line in f if line.strip()][:n]


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """A small-conf wide_deep model, initialized, checkpointed and exported
    by the port -> (conf dir, the bundle's version dir)."""
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.serving.export import export_savedmodel
    from wide_deep_tpu_torch.training.loop import Trainer
    tmp = tmp_path_factory.mktemp("serving_tools")
    conf_dir = write_conf(tmp / "conf", bf16=True)
    tr = Trainer(Config(conf_dir), "wide_deep", model_dir=str(tmp / "m"),
                 device="cpu")
    tr.ensure_initialized(restore=False)
    tr.save()
    del tr
    return conf_dir, export_savedmodel(Config(conf_dir), str(tmp / "ex"),
                                       model_type="wide_deep",
                                       model_dir=str(tmp / "m"))


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    """A self-signed localhost certificate from the openssl CLI."""
    if shutil.which("openssl") is None:
        pytest.skip("needs the openssl CLI")
    d = tmp_path_factory.mktemp("tls")
    cert, key = str(d / "cert.pem"), str(d / "key.pem")
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", key, "-out", cert, "-days", "2", "-subj", "/CN=localhost",
         "-addext", "subjectAltName=DNS:localhost,IP:127.0.0.1"],
        check=True, capture_output=True, timeout=TIMEOUT)
    return cert, key


def test_tls_proxy_fronts_plaintext_clients(bundle, certs):
    """Plaintext clients score against the port's TLS-only server through
    the port's proxy: the Python TCP client gets the direct TLS client's
    scores exactly, and the C++ client prints them."""
    from wide_deep_tpu_torch.serving.client import (TcpPredictorClient,
                                                    build_cpp_client)
    from wide_deep_tpu_torch.serving.server import (PredictorServer,
                                                    ServingModel)
    from wide_deep_tpu_torch.tools.tls_proxy import TlsProxy
    cert, key = certs
    model = ServingModel(bundle[1], 16, device="cpu")
    srv = PredictorServer(model, port=None, tcp_port=0, tls_cert=cert,
                          tls_key=key)
    srv.start()
    proxy = TlsProxy("localhost", srv.tcp_port, listen_port=0, tls_ca=cert)
    proxy.start()
    try:
        rows = read_rows(PRED1, 5)
        plain = TcpPredictorClient(port=proxy.port, timeout=TIMEOUT)
        via_proxy = plain.predict(rows)
        plain.close()
        assert all(via_proxy["valid"])
        direct = TcpPredictorClient(port=srv.tcp_port, tls_ca=cert,
                                    timeout=TIMEOUT)
        want = direct.predict(rows)
        direct.close()
        assert via_proxy["scores"] == want["scores"]
        # the TLS port refuses the plaintext client without the proxy
        refused = TcpPredictorClient(port=srv.tcp_port, timeout=5.0)
        with pytest.raises((IOError, RuntimeError)):
            refused.predict(rows[:1])
        refused.close()
        out = subprocess.run(
            [build_cpp_client()["path"], f"--data_file={PRED1}",
             "--num_rows=5", "--server_host=localhost",
             f"--server_port={proxy.port}"],
            capture_output=True, text=True, timeout=TIMEOUT)
        assert out.returncode == 0, out.stderr
        assert out.stdout.splitlines() == [
            f"{i}\tclass: {cid}\tprobability: {s[cid]:.6f}"
            for i, (s, cid) in enumerate(zip(want["scores"],
                                             want["class_ids"]))]
    finally:
        proxy.stop()
        srv.stop()
        model.close()


def test_proxy_tunnel_has_no_read_timeout(certs):
    """The proxy's 30 s connect timeout covers connect and handshake only:
    an upstream that answers after 2 s still reaches the client, and no
    positive timeout rides on the established tunnel's sockets."""
    from wide_deep_tpu_torch.tools.tls_proxy import TlsProxy
    cert, key = certs
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert, key)
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(4)

    def slow_server():
        c, _ = lsock.accept()
        c = ctx.wrap_socket(c, server_side=True)
        c.recv(5)
        time.sleep(2.0)
        c.sendall(b"WORLD")
        c.close()

    threading.Thread(target=slow_server, daemon=True).start()
    proxy = TlsProxy("localhost", lsock.getsockname()[1], listen_port=0,
                     tls_ca=cert)

    class CtxSpy:
        """Records the upstream sockets the proxy wraps."""

        def __init__(self, inner):
            self._inner = inner
            self.sockets = []

        def wrap_socket(self, *a, **kw):
            s = self._inner.wrap_socket(*a, **kw)
            self.sockets.append(s)
            return s

    spy = CtxSpy(proxy.ctx)
    proxy.ctx = spy
    proxy.start()
    try:
        cl = socket.create_connection(("127.0.0.1", proxy.port),
                                      timeout=TIMEOUT)
        cl.settimeout(TIMEOUT)
        cl.sendall(b"HELLO")
        assert cl.recv(5) == b"WORLD", "the slow upstream was cut"
        cl.close()
        # the selector pump runs the sockets non-blocking (0.0); blocking
        # without a timeout (None) is equally fine
        assert spy.sockets and all(s.gettimeout() in (None, 0.0)
                                   for s in spy.sockets)
    finally:
        proxy.stop()
        lsock.close()


def _entry(transport, rpr, p99, rows_s):
    return {"transport": transport, "rows_per_request": rpr, "p50_ms": 1.0,
            "p99_ms": p99, "rows_per_s": rows_s, "errors": 0}


BUDGET = {"device": "hand-written", "results": [
    _entry("grpc", 1, 10.0, 100.0), _entry("grpc", 64, 20.0, 5000.0),
    _entry("tcp", 1, 10.0, 100.0), _entry("tcp", 64, 20.0, 5000.0)]}


@pytest.mark.parametrize("case,results,failures,unmeasured", [
    ("within", [_entry("tcp", 1, 13.9, 71.0), _entry("tcp", 64, 26.9, 3501.0),
                _entry("grpc", 1, 5.0, 200.0),
                _entry("grpc", 64, 20.0, 5000.0)], [], []),
    ("p99", [_entry("tcp", 1, 14.1, 100.0)], ["tcp/rows1: p99"],
     ["grpc/rows1", "grpc/rows64", "tcp/rows64"]),
    ("rows/s", [_entry("tcp", 64, 20.0, 3499.0),
                _entry("tcp", 1, 10.0, 100.0)], ["tcp/rows64: 3,499"],
     ["grpc/rows1", "grpc/rows64"]),
    ("both", [_entry("grpc", 1, 40.0, 10.0)],
     ["grpc/rows1: p99", "grpc/rows1: 10"],
     ["grpc/rows64", "tcp/rows1", "tcp/rows64"]),
])
def test_slo_check_pass_and_fail(case, results, failures, unmeasured):
    """p99 may exceed the budget's by 30% + 1 ms and rows/s fall 30% below
    it; a cell this run did not measure is listed, not failed."""
    from wide_deep_tpu_torch.tools.serving_slo import check
    got = check(results, BUDGET, tolerance=0.30)
    assert len(got["failures"]) == len(failures), got
    for msg, want in zip(got["failures"], failures):
        assert msg.startswith(want), (msg, want)
    assert got["unmeasured"] == unmeasured


def test_slo_measure_and_gate_over_tcp(bundle, tmp_path, monkeypatch,
                                       capsys):
    """``measure`` over TCP (gRPC taken away) at 6 requests a shape, then
    ``main``'s capture and check round trip on the same bundle: the
    capture names the device and the transport it measured, and the
    check against it passes at a tolerance above the CPU's jitter."""
    from wide_deep_tpu_torch.tools import serving_slo
    monkeypatch.setattr(serving_slo, "transports", lambda: ["tcp"])
    res = serving_slo.measure(bundle[1], num_requests=6, concurrency=2,
                              device="cpu")
    assert [(r["transport"], r["rows_per_request"]) for r in res] == [
        ("tcp", 1), ("tcp", 64)]
    for r in res:
        assert r["errors"] == 0 and r["concurrency"] == 2
        assert r["rows_per_s"] > 0 and r["p99_ms"] >= r["p50_ms"] > 0
        assert r["requests_per_s"] * r["rows_per_request"] == pytest.approx(
            r["rows_per_s"])
    budget = str(tmp_path / "slo.json")
    common = ["--device", "cpu", "--bundle_dir", bundle[1], "--budget",
              budget]
    cap = serving_slo.main(["capture", "--num_requests", "6"] + common)
    with open(budget) as f:
        assert json.load(f) == cap
    assert cap["device"] == "cpu" and cap["transports"] == ["tcp"]
    assert cap["concurrency"] == 8
    line = serving_slo.main(["check", "--tolerance", "100"] + common)
    assert line["failures"] == [] and line["unmeasured"] == []
    assert line["num_requests"] == 6        # the budget's own count
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert printed[-1] == line and line["budget_device"] == "cpu"


def test_slo_tool_needs_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    from wide_deep_tpu_torch.tools import serving_slo
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serving_slo.main(["capture", "--budget", str(tmp_path / "b.json")])
    assert not os.path.exists(tmp_path / "b.json")
