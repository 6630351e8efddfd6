"""The port's scoring server (serving/server.py) on the CPU: ServingModel
against the JAX package's, the micro-batcher, hot reload, routing, auth,
status and the TCP endpoint's limits.

Tolerances: served scores within rtol 1e-5 (atol 1e-7) of the JAX
ServingModel's on the same bundle weights (float32 forwards that XLA fuses
and sums in another order); within the port, scores are bit for bit those of
``predict_step`` on the same transformed bucket, whatever the request was
coalesced with; a row scored in a bucket of another size is within rtol
1e-6 (the matrix products pick their blocking by shape, which changes the
order of float32 sums).

Sockets bind port 0 and read the bound port back; every socket, join and
wait has a timeout.
"""

import concurrent.futures as futures
import os
import shutil
import socket
import struct
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paths import PRED1, UNIT_FIXTURE  # noqa: E402
from test_torch_serving_export import build_bundles, read_rows  # noqa: E402

TIMEOUT = 30.0


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    return build_bundles(tmp_path_factory.mktemp("serving_server"))


@pytest.fixture(scope="module")
def model(bundles):
    from wide_deep_tpu_torch.serving.server import ServingModel
    m = ServingModel(bundles.port_bundle, 32, device="cpu")
    yield m
    m.close()


def _server(models, **kw):
    from wide_deep_tpu_torch.serving.server import PredictorServer
    kw.setdefault("port", None)
    kw.setdefault("tcp_port", 0)
    srv = PredictorServer(models, **kw)
    srv.start()
    return srv


def _wait_for(cond, what, timeout=TIMEOUT):
    deadline = time.time() + timeout
    while not cond():
        if time.time() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.05)


@pytest.mark.parametrize("path,n", [(UNIT_FIXTURE, 10), (PRED1, 40)],
                         ids=["labelled", "pred"])
def test_score_rows_match_jax(bundles, model, path, n):
    """Labelled rows and label-less pred rows: scores, class ids and valid
    flags as the JAX ServingModel gives them on the same weights."""
    from wide_deep_tpu.serving.server import ServingModel as JServingModel
    rows = read_rows(path, n)
    jm = JServingModel(bundles.jax_bundle, max_batch_size=32)
    try:
        want = jm.score_rows(rows)
    finally:
        jm.close()
    got = model.score_rows(rows)
    assert got["valid"] == want["valid"] == [True] * n
    assert got["class_ids"] == want["class_ids"]
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-5,
                               atol=1e-7)
    assert got["model_version"] == "1" and got["model_name"] == "wide_deep"
    for s in got["scores"]:
        assert abs(sum(s) - 1.0) < 1e-6


def test_scores_are_predict_step_bit_for_bit(model):
    """What a request gets back is predict_step's output on the transformed
    bucket, bit for bit, whatever the request is batched with."""
    from wide_deep_tpu_torch.training.step import predict_step
    rows = read_rows(PRED1, 20)
    batch = model.transform(rows, 32)
    assert "label" not in batch and "weight" not in batch
    assert not any(k.startswith(("scat_", "wscat_", "sopt_")) for k in batch)
    with torch.inference_mode():
        want = predict_step(model.model, model.params, model.mstate,
                            {k: torch.from_numpy(v) for k, v in
                             batch.items()})
    got = model.score_rows(rows)
    np.testing.assert_array_equal(
        np.asarray(got["scores"], np.float32),
        want["probabilities"][:20].numpy())
    assert got["class_ids"] == want["class_ids"][:20].tolist()
    # smaller requests: predict_step on their own bucket, bit for bit
    for sub in (rows[:3], rows[7:8]):
        bucket = model._bucket_for(len(sub))
        assert bucket == 16
        with torch.inference_mode():
            ref = predict_step(model.model, model.params, model.mstate,
                               {k: torch.from_numpy(v) for k, v in
                                model.transform(sub, bucket).items()})
        np.testing.assert_array_equal(
            np.asarray(model.score_rows(sub)["scores"], np.float32),
            ref["probabilities"][:len(sub)].numpy())


def test_python_transformer_path_matches_native(bundles, model):
    """Without a C++ compiler the server packs rows with the Python
    transformer (label-less rows get an empty label cell): the same
    scores."""
    from wide_deep_tpu_torch.features.pipeline import FeatureTransformer
    from wide_deep_tpu_torch.serving.server import ServingModel
    rows = read_rows(UNIT_FIXTURE, 5) + read_rows(PRED1, 5)
    py = ServingModel(bundles.port_bundle, 32, device="cpu")
    try:
        py.transformer = FeatureTransformer(py.model.plan, 2)
        py._native = False
        np.testing.assert_array_equal(py.score_rows(rows)["scores"],
                                      model.score_rows(rows)["scores"])
    finally:
        py.close()


def test_malformed_rows_flagged_and_alignment_kept(model):
    """A malformed row in the middle comes back valid: false with zero
    scores and does not shift later rows; a row with an embedded newline
    (the same tab count as a valid row) or carriage return is malformed
    too."""
    good = read_rows(UNIT_FIXTURE, 4)
    clean = model.score_rows(good)
    mixed = model.score_rows(good[:2] + ["bad\trow"] + good[2:])
    assert mixed["valid"] == [True, True, False, True, True]
    assert mixed["scores"][2] == [0.0, 0.0] and mixed["class_ids"][2] == 0
    assert [mixed["scores"][i] for i in (0, 1, 3, 4)] == clean["scores"]
    cells = good[0].split("\t")
    k = len(cells) // 2
    sneaky = "\t".join(cells[:k]) + "\t\n" + "\t".join(cells[k:])
    assert sneaky.count("\t") == good[0].count("\t")
    evil = model.score_rows([sneaky, good[0].replace("\t", "\r\t", 1)]
                            + good[2:4])
    assert evil["valid"] == [False, False, True, True]
    assert evil["scores"][2:] == clean["scores"][2:4]
    assert model.score_rows([])["scores"] == []


def test_concurrent_requests_coalesce(bundles):
    from wide_deep_tpu_torch.serving.server import ServingModel
    m = ServingModel(bundles.port_bundle, 64, batch_timeout_micros=50_000,
                     device="cpu")
    try:
        rows = read_rows(UNIT_FIXTURE, 4)
        serial = m.score_rows(rows)
        calls_before = m.batcher.device_calls
        with futures.ThreadPoolExecutor(max_workers=8) as pool:
            results = list(pool.map(lambda _: m.score_rows(rows), range(8),
                                    timeout=TIMEOUT))
        calls = m.batcher.device_calls - calls_before
        assert 1 <= calls < 8, f"no coalescing: {calls} device calls"
        for res in results:
            assert res == serial
    finally:
        m.close()


def test_oversized_request_chunks(bundles, model):
    """A request over max_batch_size runs in chunks of it, in one device
    call; each row's scores are those of a bucket of 32 within rtol
    1e-6."""
    from wide_deep_tpu_torch.serving.server import ServingModel
    small = ServingModel(bundles.port_bundle, 8, batch_timeout_micros=0,
                         device="cpu")
    try:
        rows = read_rows(PRED1, 21)
        calls = small.batcher.device_calls
        res = small.score_rows(rows)
        assert small.batcher.device_calls == calls + 1
        assert res["valid"] == [True] * 21
        np.testing.assert_allclose(res["scores"],
                                   model.score_rows(rows)["scores"],
                                   rtol=1e-6, atol=1e-7)
    finally:
        small.close()


def test_close_drains_pending_and_later_requests_score_inline(bundles):
    from wide_deep_tpu_torch.serving.server import ServingModel
    m = ServingModel(bundles.port_bundle, 16, batch_timeout_micros=10_000,
                     device="cpu")
    rows = read_rows(UNIT_FIXTURE, 2)
    results = []
    t = threading.Thread(target=lambda: results.append(m.score_rows(rows)))
    t.start()
    m.close()
    t.join(timeout=TIMEOUT)
    assert not t.is_alive()
    assert results and all(results[0]["valid"])
    # a request that still holds the closed model scores in its own thread
    late = m.score_rows(rows)
    assert late["scores"] == results[0]["scores"]
    assert not m.batcher._thread.is_alive()


def test_warmup_runs_each_bucket(model, monkeypatch):
    seen = []
    real = model.forward

    def spy(batch):
        seen.append(batch["mask"].shape[0])
        return real(batch)

    monkeypatch.setattr(model, "forward", spy)
    model.warmup()
    assert seen == model.batch_buckets == [16, 32]


def _export_version(bundles, root, version):
    """Export the port checkpoint as ``version`` under ``root``, renamed
    into place whole."""
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.serving.export import export_savedmodel
    return export_savedmodel(Config(bundles.conf_dir), root,
                             model_type="wide_deep",
                             model_dir=bundles.port_model,
                             model_version=version)


def test_hot_reload_swaps_after_warmup(bundles, tmp_path, monkeypatch):
    """reload_once loads and warms the newer version, swaps it in and
    closes the old one; requests in flight during the swap all complete;
    a version that fails to warm up keeps the served one and is closed."""
    from wide_deep_tpu_torch.serving.server import ServingModel
    root = str(tmp_path / "versions")
    _export_version(bundles, root, 1)
    old = ServingModel(os.path.join(root, "1"), 16, device="cpu")
    srv = _server(old, model_base_path=root, reload_interval_s=3600)
    try:
        rows = read_rows(UNIT_FIXTURE, 3)
        want = old.score_rows(rows)["scores"]
        stop = threading.Event()
        seen, errors = [], []

        def hammer():
            while not stop.is_set():
                try:
                    r = srv.model.score_rows(rows)
                    assert r["scores"] == want and all(r["valid"])
                    seen.append(r["model_version"])
                except Exception as e:  # noqa: BLE001
                    errors.append(e)

        threads = [threading.Thread(target=hammer) for _ in range(4)]
        for t in threads:
            t.start()
        _wait_for(lambda: len(seen) > 8, "requests before the swap")
        _export_version(bundles, root, 2)
        srv.reload_once()
        n_after = len(seen)
        _wait_for(lambda: len(seen) > n_after + 8, "requests after the swap")
        stop.set()
        for t in threads:
            t.join(timeout=TIMEOUT)
            assert not t.is_alive()
        assert not errors, errors[:3]
        assert srv.model.version == "2" and srv.model is not old
        assert set(seen) == {"1", "2"} and seen[-1] == "2"
        assert not old.batcher._thread.is_alive()
        # version 3 loads but fails its warmup: version 2 stays, and the
        # half-built model's batcher thread is stopped
        _export_version(bundles, root, 3)
        started = []

        def failing_warmup(self):
            started.append(self)
            raise RuntimeError("warmup failed")

        monkeypatch.setattr(ServingModel, "warmup", failing_warmup)
        srv.reload_once()
        assert [m.version for m in started] == ["3"]
        assert not started[0].batcher._thread.is_alive()
        assert srv.model.version == "2"
        assert srv.model.score_rows(rows)["scores"] == want
    finally:
        srv.stop()
        srv.model.close()


def test_version_watch_picks_up_a_new_version(bundles, tmp_path):
    """The background poller finds a version renamed into place and serves
    it over TCP."""
    from wide_deep_tpu_torch.serving.client import TcpPredictorClient
    from wide_deep_tpu_torch.serving.server import ServingModel
    root = str(tmp_path / "versions")
    _export_version(bundles, root, 1)
    m = ServingModel(os.path.join(root, "1"), 16, device="cpu")
    srv = _server(m, model_base_path=root, reload_interval_s=0.2)
    c = TcpPredictorClient(port=srv.tcp_port, timeout=TIMEOUT)
    try:
        rows = read_rows(UNIT_FIXTURE, 2)
        assert c.predict(rows)["model_version"] == "1"
        _export_version(bundles, str(tmp_path / "staging"), 5)
        os.rename(tmp_path / "staging" / "5", tmp_path / "versions" / "5")
        _wait_for(lambda: srv.model.version == "5", "version 5")
        assert c.predict(rows)["model_version"] == "5"
    finally:
        c.close()
        srv.stop()
        srv.model.close()


def test_routing_status_and_duplicate_names(bundles, tmp_path):
    from wide_deep_tpu_torch.serving.client import TcpPredictorClient
    from wide_deep_tpu_torch.serving.server import (PredictorServer,
                                                    ServingModel)
    base_a, base_b = tmp_path / "a", tmp_path / "b"
    base_a.mkdir()
    base_b.mkdir()
    os.symlink(bundles.port_bundle, base_a / "1")
    os.symlink(bundles.port_bundle, base_b / "1")
    alpha = ServingModel(str(base_a / "1"), 16, "alpha", device="cpu")
    beta = ServingModel(str(base_b / "1"), 16, "beta", device="cpu")
    srv = _server([alpha, beta], reload_interval_s=0.2,
                  model_base_paths={"alpha": str(base_a),
                                    "beta": str(base_b)})
    clients = []

    def client(name):
        c = TcpPredictorClient(port=srv.tcp_port, model_name=name,
                               timeout=TIMEOUT)
        clients.append(c)
        return c

    try:
        rows = read_rows(UNIT_FIXTURE, 2)
        for name in ("alpha", "beta"):
            resp = client(name).predict(rows)
            assert resp["model_name"] == name and all(resp["valid"])
        assert client("").predict(rows)["model_name"] == "alpha"
        with pytest.raises(RuntimeError, match="unknown model 'gamma'"):
            client("gamma").predict(rows)
        st = client("alpha").status()["models"]
        assert sorted(m["name"] for m in st) == ["alpha", "beta"]
        assert all(m["state"] == "AVAILABLE" and m["n_classes"] == 2
                   and m["max_batch_size"] == 16 for m in st)
        # a new version under beta's base reloads beta alone
        os.symlink(bundles.port_bundle, base_b / "2")
        _wait_for(lambda: srv.models["beta"].version == "2", "beta v2")
        assert srv.models["alpha"].version == "1"
        assert client("beta").predict(rows)["model_version"] == "2"
        with pytest.raises(ValueError, match="duplicate model names"):
            PredictorServer([alpha, srv.models["alpha"]], port=None)
        with pytest.raises(ValueError, match="unserved models"):
            PredictorServer(alpha, port=None,
                            model_base_paths={"beta": str(base_b)})
    finally:
        for c in clients:
            c.close()
        srv.stop()
        for m in list(srv.models.values()) + [beta]:
            m.close()


def test_auth_token_gates_scoring_and_status(model):
    from wide_deep_tpu_torch.serving.client import TcpPredictorClient
    srv = _server(model, auth_token="s3cret")
    try:
        rows = read_rows(UNIT_FIXTURE, 2)
        for token in (None, "nope"):
            c = TcpPredictorClient(port=srv.tcp_port, auth_token=token,
                                   timeout=TIMEOUT)
            with pytest.raises(RuntimeError, match="unauthorized"):
                c.predict(rows)
            with pytest.raises(RuntimeError, match="unauthorized"):
                c.status()
            c.close()
        c = TcpPredictorClient(port=srv.tcp_port, auth_token="s3cret",
                               timeout=TIMEOUT)
        assert all(c.predict(rows)["valid"])
        assert c.status()["models"][0]["name"] == "wide_deep"
        c.close()
    finally:
        srv.stop()


def test_tcp_connection_cap_and_idle_timeout(model):
    """Over the cap, a connect gets an ERR frame and a close; a connection
    idle past the idle timeout is closed by the server and frees its
    slot."""
    from wide_deep_tpu_torch.serving import protocol
    from wide_deep_tpu_torch.serving.client import TcpPredictorClient
    srv = _server(model, max_tcp_connections=2, tcp_idle_timeout_s=1.0)
    socks = []
    try:
        for _ in range(2):
            socks.append(socket.create_connection(
                ("localhost", srv.tcp_port), timeout=TIMEOUT))
        _wait_for(lambda: srv._tcp_live == 2, "two live connections")
        over = socket.create_connection(("localhost", srv.tcp_port),
                                        timeout=TIMEOUT)
        resp = protocol.decode_response(protocol.recv_frame(over))
        assert "connection limit reached (2)" in resp["error"]
        over.close()
        # the idle connections time out and free their slots
        _wait_for(lambda: srv._tcp_live == 0, "idle connections closed")
        assert socks[0].recv(1) == b""
        c = TcpPredictorClient(port=srv.tcp_port, timeout=TIMEOUT)
        assert c.predict(read_rows(UNIT_FIXTURE, 1))["scores"]
        c.close()
    finally:
        for s in socks:
            s.close()
        srv.stop()


def test_tcp_survives_garbage_frames(model):
    """Garbage on the wire never wedges the server: after each abuse it
    still answers a clean request; bad JSON in a good frame gets an error
    frame."""
    from wide_deep_tpu_torch.serving import protocol
    from wide_deep_tpu_torch.serving.client import TcpPredictorClient
    srv = _server(model)
    try:
        abuses = [
            b"",
            b"GET / HTTP/1.1\r\n\r\n",
            b"\x00" * 8,
            protocol.MAGIC + struct.pack("<I", 0xFFFFFFFF),
            protocol.MAGIC + struct.pack("<I", 100) + b"short",
            protocol.MAGIC + struct.pack("<I", 4) + b"\xff\xfe\x00\x01",
        ]
        for payload in abuses:
            s = socket.create_connection(("localhost", srv.tcp_port),
                                         timeout=TIMEOUT)
            try:
                if payload:
                    s.sendall(payload)
                s.settimeout(1.0)
                try:
                    s.recv(64)
                except OSError:
                    pass
            finally:
                s.close()
        s = socket.create_connection(("localhost", srv.tcp_port),
                                     timeout=TIMEOUT)
        try:
            protocol.send_frame(s, b"this is not json{{{")
            assert "error" in protocol.decode_response(
                protocol.recv_frame(s))
            protocol.send_frame(s, protocol.encode_request([]))
            assert protocol.decode_response(
                protocol.recv_frame(s))["scores"] == []
        finally:
            s.close()
        c = TcpPredictorClient(port=srv.tcp_port, timeout=TIMEOUT)
        assert len(c.predict(read_rows(UNIT_FIXTURE, 2))["scores"]) == 2
        c.close()
        with pytest.raises(ValueError, match="MAX_FRAME"):
            protocol.send_frame(None, b"x" * (protocol.MAX_FRAME + 1))
    finally:
        srv.stop()


def test_grpc_without_its_package_raises(model, monkeypatch):
    """A server asked for gRPC where grpc cannot be imported raises naming
    the package; TCP alone is the caller's explicit choice."""
    import sys

    from wide_deep_tpu_torch.serving.client import TcpPredictorClient
    from wide_deep_tpu_torch.serving.server import PredictorServer
    monkeypatch.setitem(sys.modules, "grpc", None)
    srv = PredictorServer(model, port=0, tcp_port=0)
    with pytest.raises(RuntimeError, match="grpc package"):
        srv.start()
    assert srv._tcp_thread is None
    srv = _server(model, port=None)
    try:
        assert srv._grpc_server is None and srv.port is None
        c = TcpPredictorClient(port=srv.tcp_port, timeout=TIMEOUT)
        assert all(c.predict(read_rows(UNIT_FIXTURE, 2))["valid"])
        c.close()
    finally:
        srv.stop()
    assert not srv._tcp_thread.is_alive()


def test_ports_bind_and_read_back(model):
    """Port 0 binds free ports and start() reads them back; a busy TCP
    port raises from start()."""
    srv = _server(model, port=0, tcp_port=0)
    try:
        assert srv.port > 0 and srv.tcp_port > 0 and srv.port != srv.tcp_port
        from wide_deep_tpu_torch.serving.server import PredictorServer
        busy = PredictorServer(model, port=None, tcp_port=srv.tcp_port)
        with pytest.raises(OSError):
            busy.start()
    finally:
        srv.stop()


def test_a_copied_bundle_serves_the_same(bundles, tmp_path):
    """A copied bundle loads anywhere: load_bundle needs only the version
    dir (the conf files travel in bundle.json)."""
    from wide_deep_tpu_torch.serving.server import ServingModel
    dst = tmp_path / "elsewhere" / "7"
    shutil.copytree(bundles.port_bundle, dst)
    m = ServingModel(str(dst), 16, device="cpu")
    try:
        rows = read_rows(UNIT_FIXTURE, 3)
        ref = ServingModel(bundles.port_bundle, 16, device="cpu")
        try:
            assert m.score_rows(rows)["scores"] == \
                ref.score_rows(rows)["scores"]
        finally:
            ref.close()
        assert m.version == "7"
    finally:
        m.close()
