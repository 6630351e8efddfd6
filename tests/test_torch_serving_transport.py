"""The port's serving transports and tools on the CPU: both packages'
clients against both packages' servers over gRPC and TCP, TLS and mutual
TLS, the C++ client the port builds (``serving/client.build_cpp_client``),
the load harnesses, and the serve / client / bench_serving /
microbench_serving_latency tools.

Scores that cross packages are held to rtol 1e-5 (atol 1e-7) of the other
package's (float32 forwards summed in another order); within the port,
every transport returns the in-process ServingModel's scores exactly, and
the C++ client prints the Python TCP client's probabilities character for
character.

Sockets bind port 0 and read the bound port back (the JAX server's too:
its gRPC port through a recording ``grpc.server``, its TCP port from its
listening socket); every socket, subprocess and wait has a timeout.
"""

import contextlib
import io
import os
import selectors
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paths import PRED1, REPO, UNIT_FIXTURE  # noqa: E402
from test_torch_serving_export import build_bundles, read_rows  # noqa: E402

TIMEOUT = 30.0


def _wait_for(cond, what, timeout=TIMEOUT):
    deadline = time.time() + timeout
    while not cond():
        if time.time() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.05)


def _tcp_port_of(srv):
    """The JAX server binds its TCP socket in its accept thread: wait until
    it is bound, then until it accepts a connection."""
    def bound():
        sock = srv._tcp_sock
        try:
            return sock is not None and sock.getsockname()[1] != 0
        except OSError:
            return False

    _wait_for(bound, "the JAX server's TCP socket")
    port = srv._tcp_sock.getsockname()[1]

    def accepts():
        try:
            socket.create_connection(("localhost", port), timeout=1).close()
            return True
        except OSError:
            return False

    _wait_for(accepts, "the JAX server's TCP listener")
    return port


def start_jax_server(model, **kw):
    """The JAX PredictorServer on free ports, read back."""
    import grpc

    from wide_deep_tpu.serving.server import PredictorServer
    bound = []
    real = grpc.server

    def recording(*a, **k):
        server = real(*a, **k)
        for name in ("add_insecure_port", "add_secure_port"):
            add = getattr(server, name)
            setattr(server, name, lambda *args, _add=add: bound.append(
                _add(*args)) or bound[-1])
        return server

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(grpc, "server", recording)
        srv = PredictorServer(model, port=0, tcp_port=0, **kw)
        srv.start()
    srv.port = bound[0]
    srv.tcp_port = _tcp_port_of(srv)
    return srv


def start_port_server(model, **kw):
    from wide_deep_tpu_torch.serving.server import PredictorServer
    srv = PredictorServer(model, port=0, tcp_port=0, **kw)
    srv.start()
    return srv


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    return build_bundles(tmp_path_factory.mktemp("serving_transport"))


@pytest.fixture(scope="module")
def servers(bundles):
    """{"jax": (server, in-process model), "port": ...}, each on its own
    package's bundle of the same weights."""
    from wide_deep_tpu.serving.server import ServingModel as JServingModel
    from wide_deep_tpu_torch.serving.server import ServingModel
    jm = JServingModel(bundles.jax_bundle, max_batch_size=32)
    pm = ServingModel(bundles.port_bundle, 32, device="cpu")
    out = {"jax": (start_jax_server(jm), jm),
           "port": (start_port_server(pm), pm)}
    yield out
    for srv, m in out.values():
        srv.stop()
        m.close()


def _client(pkg, transport, srv, **kw):
    if pkg == "jax":
        from wide_deep_tpu.serving import client as mod
    else:
        from wide_deep_tpu_torch.serving import client as mod
    if transport == "grpc":
        return mod.PredictorClient(port=srv.port, timeout=TIMEOUT, **kw)
    return mod.TcpPredictorClient(port=srv.tcp_port, timeout=TIMEOUT, **kw)


@pytest.mark.parametrize("transport", ["grpc", "tcp"])
@pytest.mark.parametrize("client_pkg", ["jax", "port"])
@pytest.mark.parametrize("server_pkg", ["jax", "port"])
def test_clients_against_servers(servers, server_pkg, client_pkg,
                                 transport):
    """Every client against every server on both transports: the server's
    own scores (exact), the other package's within rtol 1e-5, a malformed
    row flagged in place, the status answer, and an unknown model
    refused."""
    srv, model = servers[server_pkg]
    other = servers["jax" if server_pkg == "port" else "port"][1]
    rows = read_rows(PRED1, 6)
    c = _client(client_pkg, transport, srv)
    try:
        resp = c.predict(rows[:3] + ["bad\trow"] + rows[3:])
        assert resp["valid"] == [True] * 3 + [False] + [True] * 3
        got = [s for i, s in enumerate(resp["scores"]) if i != 3]
        assert got == model.score_rows(rows)["scores"]
        np.testing.assert_allclose(got, other.score_rows(rows)["scores"],
                                   rtol=1e-5, atol=1e-7)
        st = c.status()["models"]
        assert [m["name"] for m in st] == ["wide_deep"]
        assert st[0]["version"] == "1" and st[0]["n_classes"] == 2
    finally:
        c.close()
    bad = _client(client_pkg, transport, srv)
    bad.model_name = "nope"
    try:
        with pytest.raises(RuntimeError, match="unknown model"):
            bad.predict(rows[:1])
    finally:
        bad.close()


def test_cpp_client_matches_python_tcp(servers):
    """The C++ client, built by the port into build/native/ (not the binary
    committed in cpp/), prints the probabilities the Python TCP client
    gets, to the printed digit; with and without the auth token the
    server's answer decides."""
    from wide_deep_tpu_torch.serving.client import (TcpPredictorClient,
                                                    build_cpp_client)
    built = build_cpp_client()
    path = built["path"]
    assert os.path.dirname(path) == os.path.join(REPO, "build", "native")
    assert os.path.basename(path).startswith("serving_client_")
    assert build_cpp_client()["built"] is False
    srv, _ = servers["port"]
    proc = subprocess.run(
        [path, f"--data_file={PRED1}", "--num_rows=5",
         "--server_host=localhost", f"--server_port={srv.tcp_port}"],
        capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr
    c = TcpPredictorClient(port=srv.tcp_port, timeout=TIMEOUT)
    try:
        resp = c.predict(read_rows(PRED1, 5))
    finally:
        c.close()
    want = [f"{i}\tclass: {cid}\tprobability: {s[cid]:.6f}"
            for i, (s, cid) in enumerate(zip(resp["scores"],
                                             resp["class_ids"]))]
    assert proc.stdout.splitlines() == want


def test_cpp_client_build_failure_raises(monkeypatch, tmp_path):
    from wide_deep_tpu_torch.features import native
    from wide_deep_tpu_torch.serving.client import build_cpp_client
    fake = tmp_path / "fakecxx"
    fake.write_text("#!/bin/sh\necho 'client build refused' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="client build refused"):
        build_cpp_client()
    assert not [f for f in os.listdir(tmp_path / "build")
                if f.startswith("serving_client_")
                and not f.endswith(".tmp")]
    monkeypatch.setenv("CXX", "no-such-compiler")
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        build_cpp_client()


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


@pytest.mark.parametrize("client_pkg", ["jax", "port"])
def test_tls_both_transports(servers, certs, client_pkg):
    """TLS on both endpoints of the port's server: clients that verify the
    certificate score; plaintext clients are refused."""
    cert, key = certs
    model = servers["port"][1]
    srv = start_port_server(model, tls_cert=cert, tls_key=key)
    try:
        rows = read_rows(UNIT_FIXTURE, 2)
        want = model.score_rows(rows)["scores"]
        for transport in ("grpc", "tcp"):
            c = _client(client_pkg, transport, srv, tls_ca=cert)
            assert c.predict(rows)["scores"] == want
            c.close()
        plain = _client(client_pkg, "grpc", srv)
        plain.timeout = 5.0
        with pytest.raises(Exception):
            plain.predict(rows)
        plain.close()
        tp = _client(client_pkg, "tcp", srv)
        with pytest.raises((IOError, RuntimeError)):
            tp.predict(rows)
        tp.close()
    finally:
        srv.stop()


@pytest.mark.parametrize("client_pkg", ["jax", "port"])
def test_mutual_tls_requires_client_cert(servers, certs, client_pkg):
    cert, key = certs
    model = servers["port"][1]
    srv = start_port_server(model, tls_cert=cert, tls_key=key, tls_ca=cert)
    try:
        rows = read_rows(UNIT_FIXTURE, 2)
        for transport in ("grpc", "tcp"):
            c = _client(client_pkg, transport, srv, tls_ca=cert,
                        tls_cert=cert, tls_key=key)
            assert all(c.predict(rows)["valid"])
            c.close()
        bare = _client(client_pkg, "grpc", srv, tls_ca=cert)
        bare.timeout = 5.0
        with pytest.raises(Exception):
            bare.predict(rows)
        bare.close()
        with pytest.raises((IOError, RuntimeError, OSError)):
            tb = _client(client_pkg, "tcp", srv, tls_ca=cert)
            try:
                tb.predict(rows)
            finally:
                tb.close()
    finally:
        srv.stop()


@pytest.mark.parametrize("transport", ["grpc", "tcp"])
def test_load_harness(servers, transport):
    """do_inference over each transport: every request answered, more
    client threads than the gRPC server has workers."""
    from wide_deep_tpu_torch.serving.client import do_inference
    srv, _ = servers["port"]
    c = _client("port", transport, srv)
    try:
        stats = do_inference(c, read_rows(PRED1, 20), num_requests=36,
                             concurrency=12, rows_per_request=2)
    finally:
        c.close()
    assert stats["requests"] == 36 and stats["errors"] == 0, stats
    assert stats["rows_per_s"] > 0 and stats["p99_ms"] >= stats["p50_ms"]


def test_tcp_client_thread_death_closes_socket(servers):
    import gc

    from wide_deep_tpu_torch.serving.client import TcpPredictorClient
    srv, _ = servers["port"]
    client = TcpPredictorClient(port=srv.tcp_port, timeout=TIMEOUT)
    rows = read_rows(UNIT_FIXTURE, 1)
    try:
        client.predict(rows)
        for _ in range(4):
            t = threading.Thread(target=client.predict, args=(rows,))
            t.start()
            t.join(timeout=TIMEOUT)
            assert not t.is_alive()
        gc.collect()
        assert len(client._conns) == 1, len(client._conns)
    finally:
        client.close()


def test_open_loop_inference(servers):
    """The multi-process open-loop harness (spawned generators) against
    the port's server."""
    from wide_deep_tpu_torch.serving.client import open_loop_inference
    srv, _ = servers["port"]
    stats = open_loop_inference(read_rows(PRED1, 10), rate=20.0,
                                duration_s=1.0, rows_per_request=2,
                                processes=2, port=srv.tcp_port, kind="tcp")
    assert stats["errors"] == 0 and stats["sent"] >= 15, stats
    assert stats["achieved_rows_per_s"] > 0
    assert stats["p99_ms"] >= stats["p50_ms"] > 0


def _start_serve_tool(args):
    """``python -m wide_deep_tpu_torch.tools.serve`` in a subprocess ->
    (process, its "serving ..." line)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "wide_deep_tpu_torch.tools.serve", *args],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    sel = selectors.DefaultSelector()
    sel.register(proc.stdout, selectors.EVENT_READ)
    deadline = time.time() + 120
    try:
        while time.time() < deadline:
            if sel.select(timeout=1.0):
                line = proc.stdout.readline()
                if line.startswith("serving "):
                    return proc, line.strip()
                if not line and proc.poll() is not None:
                    break
        _stop(proc)
        raise AssertionError(f"serve tool gave no serving line: "
                             f"{proc.stderr.read()[-2000:]}")
    finally:
        sel.close()


def _stop(proc):
    proc.send_signal(signal.SIGINT)
    try:
        proc.wait(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=TIMEOUT)


def _ports(line):
    import re
    return {k: int(v) for k, v in re.findall(r"(grpc|tcp) :(\d+)", line)}


def test_serve_and_client_tools(bundles, tmp_path):
    """tools.serve (on free ports, --device cpu) with tools.client over
    both transports: the rows' lines, the status, the load test; then
    --transport tcp serves no gRPC; then --model_config serves two
    models by name."""
    from wide_deep_tpu_torch.tools import client as client_tool
    root = tmp_path / "versions"
    root.mkdir()
    os.symlink(bundles.port_bundle, root / "1")
    common = ["--conf_dir", bundles.conf_dir, "--device", "cpu",
              "--port", "0"]
    proc, line = _start_serve_tool(common + ["--model_base_path",
                                             str(root)])
    try:
        ports = _ports(line)
        assert sorted(ports) == ["grpc", "tcp"]
        outs = {}
        for transport in ("grpc", "tcp"):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                client_tool.main(["--server_port", str(ports[transport]),
                                  "--transport", transport,
                                  "--data_file", PRED1, "--num_rows", "3"])
            outs[transport] = buf.getvalue().splitlines()
        assert outs["grpc"] == outs["tcp"] and len(outs["tcp"]) == 3
        assert outs["tcp"][0].startswith("0\tclass: ")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            st = client_tool.main(["--server_port", str(ports["tcp"]),
                                   "--transport", "tcp", "--status"])
            stats = client_tool.main(["--server_port", str(ports["grpc"]),
                                      "--data_file", PRED1, "--load_test",
                                      "--num_requests", "8",
                                      "--concurrency", "4"])
        assert st["models"][0]["name"] == "wide_deep"
        assert "name: wide_deep" in buf.getvalue()
        assert stats["requests"] == 8 and stats["errors"] == 0
    finally:
        _stop(proc)
    assert proc.returncode == 0, proc.stderr.read()[-2000:]

    proc, line = _start_serve_tool(common + ["--model_base_path",
                                             str(root), "--transport",
                                             "tcp"])
    try:
        assert sorted(_ports(line)) == ["tcp"]
    finally:
        _stop(proc)

    spec = tmp_path / "models.yaml"
    spec.write_text(f"models:\n  - name: alpha\n    base_path: {root}\n"
                    f"  - name: beta\n    base_path: {root}\n"
                    f"    version: 1\n")
    proc, line = _start_serve_tool(common + ["--model_config", str(spec)])
    try:
        tcp = _ports(line)["tcp"]
        for name in ("alpha", "beta"):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                resp = client_tool.main(["--server_port", str(tcp),
                                         "--transport", "tcp",
                                         "--model_name", name,
                                         "--data_file", PRED1,
                                         "--num_rows", "2"])
            assert resp["model_name"] == name
            assert buf.getvalue().splitlines() == outs["tcp"][:2]
    finally:
        _stop(proc)


@pytest.mark.parametrize("transport", ["grpc", "tcp"])
def test_bench_serving_and_latency_tools(bundles, tmp_path, monkeypatch,
                                         capsys, transport):
    """bench_serving exports a fresh bundle from the conf's model (here the
    small conf) and prints one JSON line per concurrency level; the
    latency tool times each bucket on the same bundle (host clock on the
    CPU, device time not measured)."""
    import json
    import tempfile

    from wide_deep_tpu_torch.tools import (bench_serving,
                                           microbench_serving_latency)
    monkeypatch.setenv("WIDE_DEEP_CONF_DIR", bundles.conf_dir)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    lines = bench_serving.main(["--device", "cpu", "--port", "0",
                                "--num_requests", "16",
                                "--concurrency", "1,8",
                                "--rows_per_request", "2",
                                "--transport", transport])
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert printed == lines and [x["concurrency"] for x in lines] == [1, 8]
    for x in lines:
        assert x["errors"] == 0 and x["requests"] == 16
        assert x["transport"] == transport and x["device"] == "cpu"
        assert x["rows_per_s"] > 0 and x["p99_ms"] >= x["p50_ms"] > 0
    assert lines[0]["device_calls"] == 16
    assert 1 <= lines[1]["device_calls"] <= 16
    bundle = next(os.path.join(r, "1") for r, ds, _ in os.walk(tmp_path)
                  if r.endswith("export") and "1" in ds)
    out = microbench_serving_latency.main(["--device", "cpu", "--iters", "2",
                                           "--bundle_dir", bundle])
    assert [x["bucket"] for x in out] == [1, 16, 128, 1024]
    for x in out:
        assert x["device_ms"] is None and x["event_ms"] > 0
        assert x["host_ms"] > 0 and x["copy_ms"] >= 0
