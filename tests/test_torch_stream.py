"""The port's streaming ingestion (features/stream.py) and
``Trainer.train_stream``: every case of tests/test_stream.py, plus the
stream's batches and train_stream's loss against the JAX package's.

Sockets: every server binds port 0 on 127.0.0.1, every consumer idles at
most 0.2 s before it flushes, and every case runs its consumer in a thread
joined within ``LIMIT`` seconds, so a hung connection fails one test in
seconds instead of stalling the run.
"""

import socket
import struct
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paths import UNIT_FIXTURE as FIXTURE  # noqa: E402

FLUSH_S = 0.2
LIMIT = 60.0


def bounded(fn, limit=LIMIT):
    """``fn()`` in a thread joined within ``limit`` seconds -> its
    result; raises what it raised, and fails if it is still running."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:      # re-raised in the test's thread
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(limit)
    assert not t.is_alive(), f"still running after {limit} s"
    if "error" in out:
        raise out["error"]
    return out["value"]


@pytest.fixture(scope="module")
def plan(tmp_path_factory):
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.features.plan import FeaturePlan
    from wide_deep_tpu_torch.testing import write_small_conf
    conf = write_small_conf(str(tmp_path_factory.mktemp("stream_conf")))
    return FeaturePlan(Config(conf))


def _fixture_lines():
    with open(FIXTURE) as f:
        return [line for line in f if line.strip()]


def _listener():
    srv = socket.socket()
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    srv.settimeout(LIMIT)
    return srv, srv.getsockname()[1]


def test_stream_matches_file_batches(plan):
    """Replaying a file through TCP gives the same eval batches as reading
    it directly (arrival order, no shuffle)."""
    from wide_deep_tpu_torch.features.pipeline import CsvDataset
    from wide_deep_tpu_torch.features.stream import StreamDataset, serve_file
    srv, _ = serve_file(FIXTURE)
    port = srv.getsockname()[1]
    stream = bounded(lambda: list(StreamDataset(
        plan, "127.0.0.1", port, mode="eval", batch_size=4,
        flush_timeout_s=FLUSH_S)))
    direct = list(CsvDataset(plan, FIXTURE, "eval", 4))
    assert len(stream) == len(direct) == 3
    for sb, db in zip(stream, direct):
        assert set(sb) == set(db)
        for k in sb:
            np.testing.assert_array_equal(sb[k], db[k], err_msg=k)


def test_stream_batches_match_jax(plan, tmp_path):
    """The port's stream gives the JAX package's stream batches, bit for
    bit, each through its own package's Python transformer."""
    from wide_deep_tpu.config import Config as JConfig
    from wide_deep_tpu.features.pipeline import FeatureTransformer as JT
    from wide_deep_tpu.features.plan import FeaturePlan as JPlan
    from wide_deep_tpu.features.stream import StreamDataset as JStream
    from wide_deep_tpu.features.stream import serve_file as jserve
    from wide_deep_tpu_torch.features.pipeline import FeatureTransformer
    from wide_deep_tpu_torch.features.stream import StreamDataset, serve_file
    from wide_deep_tpu_torch.testing import write_small_conf
    jplan = JPlan(JConfig(write_small_conf(str(tmp_path / "conf"))))
    srv, _ = serve_file(FIXTURE)
    ours = bounded(lambda: list(StreamDataset(
        plan, "127.0.0.1", srv.getsockname()[1], batch_size=4,
        flush_timeout_s=FLUSH_S, transformer=FeatureTransformer(plan))))
    jsrv, _ = jserve(FIXTURE)
    theirs = bounded(lambda: list(JStream(
        jplan, "127.0.0.1", jsrv.getsockname()[1], batch_size=4,
        flush_timeout_s=FLUSH_S, transformer=JT(jplan))))
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_idle_flush_emits_partial_batch(plan):
    """A trickling producer does not stall the consumer: idleness flushes
    whatever arrived, padded and masked."""
    from wide_deep_tpu_torch.features.stream import StreamDataset
    srv, port = _listener()
    rows = _fixture_lines()[:3]

    def producer():
        conn, _ = srv.accept()
        with conn:
            conn.sendall("".join(rows[:2]).encode())
            time.sleep(4 * FLUSH_S)      # past the flush timeout
            conn.sendall(rows[2].encode())
            time.sleep(0.1)
        srv.close()

    threading.Thread(target=producer, daemon=True).start()
    batches = bounded(lambda: list(StreamDataset(
        plan, "127.0.0.1", port, mode="eval", batch_size=8,
        flush_timeout_s=FLUSH_S)))
    assert len(batches) >= 2
    assert batches[0]["mask"].sum() == 2
    assert sum(int(b["mask"].sum()) for b in batches) == 3


def test_survives_producer_restart(plan):
    """With reconnect=True a producer drop does not end the stream: the
    dataset backs off, reconnects to the restarted producer and consumes
    both runs' rows."""
    from wide_deep_tpu_torch.features.stream import StreamDataset, serve_file
    srv1, _ = serve_file(FIXTURE)
    port = srv1.getsockname()[1]
    ds = StreamDataset(plan, "127.0.0.1", port, batch_size=4,
                       flush_timeout_s=FLUSH_S, reconnect=True,
                       max_retries=8, backoff_s=0.05, backoff_max_s=0.2,
                       connect_timeout_s=2.0)
    servers = []

    def consume():
        rows = 0
        for batch in ds:
            rows += int(batch["mask"].sum())
            if rows >= 10 and not servers:
                # the first producer sent the file and closed: restart one
                # on the same port while the consumer retries
                servers.append(serve_file(FIXTURE, port=port)[0])
        return rows

    assert bounded(consume) == 20
    assert servers and ds.reconnects >= 1


def test_no_reconnect_default_ends_on_close(plan):
    from wide_deep_tpu_torch.features.stream import StreamDataset, serve_file
    srv, _ = serve_file(FIXTURE)
    ds = StreamDataset(plan, "127.0.0.1", srv.getsockname()[1],
                       batch_size=4, flush_timeout_s=FLUSH_S)
    assert bounded(lambda: sum(int(b["mask"].sum()) for b in ds)) == 10


def test_retries_exhausted_ends_stream(plan):
    from wide_deep_tpu_torch.features.stream import StreamDataset
    s = socket.socket()                 # a port nothing listens on
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    ds = StreamDataset(plan, "127.0.0.1", port, batch_size=4,
                       reconnect=True, max_retries=2, backoff_s=0.01,
                       connect_timeout_s=0.2, flush_timeout_s=FLUSH_S)
    assert bounded(lambda: list(ds)) == []
    assert ds.rows_seen == 0


def test_midline_reset_discards_partial_tail(plan):
    """A connection reset halfway through a row discards the buffered
    prefix (training on it would train on a truncated row)."""
    from wide_deep_tpu_torch.features.stream import StreamDataset
    lines = [line.rstrip("\n") for line in _fixture_lines()]
    srv, port = _listener()

    def producer():
        conn, _ = srv.accept()
        conn.sendall((lines[0] + "\n" + lines[1] + "\n").encode())
        conn.sendall(lines[2][:20].encode())
        time.sleep(1.5 * FLUSH_S)
        # a hard reset (RST through SO_LINGER 0): the consumer sees an
        # OSError in the middle of a row
        conn.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                        struct.pack("ii", 1, 0))
        conn.close()

    threading.Thread(target=producer, daemon=True).start()
    ds = StreamDataset(plan, "127.0.0.1", port, batch_size=4,
                       flush_timeout_s=FLUSH_S)
    total = bounded(lambda: sum(int(b["mask"].sum()) for b in ds))
    srv.close()
    assert total == 2


def test_python_path_skips_short_rows(plan):
    """With the Python transformer a truncated junk line is skipped, not
    raised (the native parser drops such lines itself)."""
    from wide_deep_tpu_torch.features.pipeline import FeatureTransformer
    from wide_deep_tpu_torch.features.stream import StreamDataset, serve_file
    srv, _ = serve_file(FIXTURE)
    ds = StreamDataset(plan, "127.0.0.1", srv.getsockname()[1],
                       batch_size=4, flush_timeout_s=FLUSH_S,
                       transformer=FeatureTransformer(plan))
    assert int(np.asarray(ds._emit(["short\trow", "x"])["mask"]).sum()) == 0
    assert int(np.asarray(ds._emit(["a\tb\tc"])["mask"]).sum()) == 0
    assert bounded(lambda: sum(int(b["mask"].sum()) for b in ds)) == 10


def _trainers(tmp_path, jax_too=False):
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.testing import write_small_conf
    from wide_deep_tpu_torch.training.loop import Trainer
    conf = write_small_conf(str(tmp_path / "conf"))
    overrides = dict(train_data=FIXTURE, eval_data=FIXTURE,
                     test_data=FIXTURE, keep_train=True, batch_size=8)
    tr = Trainer(Config(conf), model_type="wide_deep",
                 model_dir=str(tmp_path / "m"), overrides=overrides,
                 device="cpu")
    if not jax_too:
        return tr
    import jax

    from wide_deep_tpu.config import Config as JConfig
    from wide_deep_tpu.parallel import mesh as mesh_lib
    from wide_deep_tpu.training.loop import Trainer as JTrainer
    jtr = JTrainer(JConfig(conf), model_type="wide_deep",
                   model_dir=str(tmp_path / "jax"),
                   mesh=mesh_lib.make_mesh(1, 1, jax.devices()[:1]),
                   overrides=overrides)
    return tr, jtr


def test_trainer_train_stream(tmp_path):
    """Trainer.train_stream consumes a replayed stream and advances the
    step; a checkpoint cadence of 2 steps saves step 2."""
    from wide_deep_tpu_torch.features.stream import serve_file
    tr = _trainers(tmp_path)
    tr.runconfig = dict(tr.runconfig, save_checkpoints_steps=2,
                        save_checkpoints_secs=None)
    tr.ensure_initialized(restore=False)
    srv, _ = serve_file(FIXTURE, loop=True)
    loss = bounded(lambda: tr.train_stream(
        "127.0.0.1", srv.getsockname()[1], max_batches=3,
        flush_timeout_s=FLUSH_S))
    srv.close()
    assert np.isfinite(loss)
    assert tr.global_step == 3 and len(tr.losses) == 3
    tr._ckpt.wait()
    assert 2 in tr._ckpt.all_steps()


def test_train_stream_matches_jax(tmp_path):
    """Both Trainers from the same params over the same stream (each
    replaying the fixture, 3 batches of 8 rows): the last loss within rtol
    2e-5 and the params within rtol 1e-4 / atol 1e-5, as the Trainer test
    holds them."""
    import jax

    from test_torch_features import assert_trees_close
    from wide_deep_tpu.features.stream import serve_file as jserve
    from wide_deep_tpu_torch.features.stream import serve_file
    from wide_deep_tpu_torch.interop import from_jax, to_numpy
    tr, jtr = _trainers(tmp_path, jax_too=True)
    jtr.ensure_initialized(restore=False)
    tr.params, tr.mstate = from_jax(jax.device_get(jtr.params),
                                    jax.device_get(jtr.mstate), device="cpu")
    tr.ensure_initialized(restore=False)
    jsrv, _ = jserve(FIXTURE, loop=True)
    jloss = bounded(lambda: jtr.train_stream(
        "127.0.0.1", jsrv.getsockname()[1], max_batches=3,
        flush_timeout_s=FLUSH_S))
    srv, _ = serve_file(FIXTURE, loop=True)
    loss = bounded(lambda: tr.train_stream(
        "127.0.0.1", srv.getsockname()[1], max_batches=3,
        flush_timeout_s=FLUSH_S))
    jsrv.close()
    srv.close()
    assert tr.global_step == jtr.global_step == 3
    np.testing.assert_allclose(loss, jloss, rtol=2e-5)
    assert_trees_close(jax.device_get(jtr.params), to_numpy(tr.params),
                       rtol=1e-4, atol=1e-5, what="params")


def test_stream_server_tool():
    """``python -m wide_deep_tpu_torch.tools.stream_server`` on port 0:
    prints the bound port and serves the file to one client, then
    exits."""
    import re
    import subprocess
    import sys

    from paths import REPO
    proc = subprocess.Popen(
        [sys.executable, "-m", "wide_deep_tpu_torch.tools.stream_server",
         "--data_file", FIXTURE, "--host", "127.0.0.1", "--port", "0"],
        cwd=REPO, stdout=subprocess.PIPE, text=True)
    try:
        line = bounded(proc.stdout.readline)
        port = int(re.search(r":(\d+)$", line.strip()).group(1))
        with socket.create_connection(("127.0.0.1", port),
                                      timeout=LIMIT) as c:
            got = b""
            while chunk := c.recv(1 << 16):
                got += chunk
        assert proc.wait(LIMIT) == 0
    finally:
        proc.kill()
        proc.wait()
    with open(FIXTURE, "rb") as f:
        assert got == f.read()
