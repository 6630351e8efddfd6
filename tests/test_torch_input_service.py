"""The port's input service (wide_deep_tpu_torch/features/input_service.py,
tools/input_server.py) against the JAX package's (tests/
test_input_service.py's cases): the slicing rules, the lockstep stream, the
handshake, and the wire format: each package's client reads each package's
server, and the slices reassemble the loader's global batches bit for bit,
per-shard plans included.
"""

import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paths import REPO, UNIT_FIXTURE as FIXTURE  # noqa: E402
from test_torch_features import write_conf  # noqa: E402


@pytest.fixture(scope="module")
def conf_dir(tmp_path_factory):
    return write_conf(tmp_path_factory.mktemp("service_conf"))


def _plans(conf_dir, shards):
    """(JAX plan, port plan) with per-shard range plans on every group
    whose rows divide (the JAX test's forcing)."""
    from test_torch_features import plan_pair
    return plan_pair(conf_dir, pallas_scatter=True, scatter_shards=shards,
                     shard_threshold=1)


@pytest.fixture
def forced(monkeypatch):
    import wide_deep_tpu.features.plan as jplan
    import wide_deep_tpu_torch.features.plan as tplan
    for mod in (jplan, tplan):
        monkeypatch.setattr(
            mod.FeaturePlan, "scatter_group",
            lambda self, g, b: bool(self.pallas_scatter
                                    and g.rows % self.scatter_shards == 0))


def _pkg(which):
    if which == "jax":
        from wide_deep_tpu.features import input_service as svc
        from wide_deep_tpu.features.pipeline import CsvDataset
    else:
        from wide_deep_tpu_torch.features import input_service as svc
        from wide_deep_tpu_torch.features.pipeline import CsvDataset
    return svc, CsvDataset


# ----------------------------------------------------------------- slicing
def test_key_axis_and_slices_match_jax():
    from wide_deep_tpu.features import input_service as j
    from wide_deep_tpu_torch.features import input_service as t
    for key in ("label", "emb_ids_d8", "scat_ids_d8", "wscat_live_d16",
                "sopt_uids_d32", "dscat_uids_d8", "dscat_slots_d8"):
        for s in (1, 2, 8):
            assert t.key_axis(key, s) == j.key_axis(key, s), (key, s)
    arr = np.arange(8 * 3).reshape(8, 3)
    parts = [t.slice_for_proc("scat_ids_d8", arr, p, 2, 8) for p in range(2)]
    np.testing.assert_array_equal(np.concatenate(parts), arr)
    with pytest.raises(ValueError, match="n_procs"):
        t.slice_for_proc("x", np.zeros((9, 2)), 0, 2, 8)


def test_local_batch_spec_divides_leading_axes(conf_dir, forced):
    from wide_deep_tpu.features.input_service import local_batch_spec as jl
    from wide_deep_tpu_torch.features.input_service import local_batch_spec
    jp, tp = _plans(conf_dir, 2)
    local = local_batch_spec(tp, 16, 2)
    spec = tp.batch_spec(16)
    assert set(local) == set(spec)
    for k, (shape, _) in spec.items():
        assert local[k][0] == (shape[0] // 2,) + tuple(shape[1:]), k
    want = jl(jp, 16, 2)
    assert {k: v[0] for k, v in local.items()} == {
        k: tuple(v[0]) for k, v in want.items()}


def test_routing_matches_jax():
    from wide_deep_tpu.features import input_service as j
    from wide_deep_tpu_torch.features import input_service as t
    addrs = ["a:1", "b:2"]
    for p in range(4):
        assert t.loader_for_proc(addrs, p, 4) == j.loader_for_proc(addrs, p, 4)
        assert t.group_range_for_proc(2, p, 4) == \
            j.group_range_for_proc(2, p, 4)
    with pytest.raises(ValueError, match="evenly"):
        t.loader_for_proc(addrs, 0, 3)


def test_stream_identity_matches_jax():
    """The handshake's digests are the JAX package's: a port client passes
    a JAX loader's fingerprint check and the other way round."""
    from wide_deep_tpu.features import input_service as j
    from wide_deep_tpu_torch.features import input_service as t
    args = (123, 25600, 2, 2, 2)
    kw = dict(pos_weight=0.9, neg_weight=None, model_type="wide_deep",
              shuffle_buffer=1000, data_files=[("a", 3)])
    assert t.stream_fingerprint(*args, **kw) == j.stream_fingerprint(*args,
                                                                     **kw)
    assert t.data_digest(FIXTURE) == j.data_digest(FIXTURE)


# ------------------------------------------------------------------ stream
def test_lockstep_and_eviction():
    from wide_deep_tpu_torch.features.input_service import _Stream
    st = _Stream(iter([{"a": np.arange(4)}, {"a": np.arange(4) + 10}]),
                 n_procs=2)
    assert st.get(0, 0)["a"][0] == 0
    assert 0 in st.cache
    assert st.get(1, 0)["a"][0] == 0
    assert 0 not in st.cache
    assert st.get(0, 1)["a"][0] == 10 and st.get(1, 1)["a"][0] == 10
    assert st.get(0, 2) is None and st.get(1, 2) is None


def test_out_of_lockstep_rejected():
    from wide_deep_tpu_torch.features.input_service import _Stream
    st = _Stream(iter([{"a": np.zeros(1)}]), n_procs=1)
    st.get(0, 0)
    with pytest.raises(ValueError, match="lockstep"):
        st.get(0, 0)


def test_producer_exception_surfaces():
    from wide_deep_tpu_torch.features.input_service import _Stream

    def boom():
        yield {"a": np.zeros(1)}
        raise RuntimeError("disk on fire")

    st = _Stream(boom(), n_procs=1)
    assert st.get(0, 0)["a"].shape == (1,)
    with pytest.raises(ValueError, match="disk on fire"):
        st.get(0, 1)


# --------------------------------------------------------- wire, both ways
@pytest.mark.parametrize("server_pkg,client_pkg", [
    ("torch", "torch"), ("jax", "torch"), ("torch", "jax")])
def test_two_proc_roundtrip_reassembles(conf_dir, forced, server_pkg,
                                        client_pkg):
    """Two clients' slices concatenate back to the loader's global
    batches, per-shard plans included, whichever package serves and
    whichever reads."""
    jp, tp = _plans(conf_dir, 2)
    ssvc, SD = _pkg(server_pkg)
    csvc, _ = _pkg(client_pkg)
    splan = jp if server_pkg == "jax" else tp
    cplan = jp if client_pkg == "jax" else tp
    B = 16

    def factory(path, mode, epoch_seed):
        return SD(splan, path, mode, B, seed=7 + epoch_seed)

    direct = list(SD(splan, FIXTURE, "train", B, seed=7))
    assert any(k.startswith("scat_ok_") for k in direct[0])
    server = ssvc.InputServer(factory, n_procs=2, scatter_shards=2, port=0)
    server.start()
    try:
        results = {}

        def run(proc):
            results[proc] = list(csvc.RemoteInputDataset(
                cplan, f"127.0.0.1:{server.port}", FIXTURE, "train",
                global_batch=B, proc=proc, n_procs=2, epoch_seed=0))

        ts = [threading.Thread(target=run, args=(p,)) for p in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert len(results[0]) == len(results[1]) == len(direct)
        for b0, b1, ref in zip(results[0], results[1], direct):
            assert set(b0) == set(ref)
            for k in ref:
                np.testing.assert_array_equal(
                    np.concatenate([b0[k], b1[k]]), ref[k], err_msg=k)
            assert b0["scat_ids_d8"].shape[0] == 1   # one plan row a rank
    finally:
        server.stop()


def test_run_token_reopens_fresh_stream(conf_dir):
    from wide_deep_tpu_torch.features.input_service import (
        InputServer, RemoteInputDataset)
    from wide_deep_tpu_torch.features.pipeline import CsvDataset
    from wide_deep_tpu_torch.features.plan import FeaturePlan
    from wide_deep_tpu_torch.config import Config
    plan = FeaturePlan(Config(conf_dir))
    server = InputServer(lambda p, m, e: CsvDataset(plan, p, m, 16,
                                                    seed=11 + e),
                         n_procs=1, scatter_shards=1, port=0)
    server.start()
    try:
        def fetch(token):
            return list(RemoteInputDataset(
                plan, f"127.0.0.1:{server.port}", FIXTURE, "train",
                global_batch=16, proc=0, n_procs=1, run_token=token))

        first = fetch(0)
        again = fetch(100)
        assert first and len(again) == len(first)
        for a, b in zip(first, again):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        with pytest.raises(IOError, match="evicted|end of data"):
            fetch(0)
    finally:
        server.stop()


def test_fingerprint_mismatch_rejected(conf_dir):
    from wide_deep_tpu_torch.features.input_service import (
        InputServer, RemoteInputDataset)
    from wide_deep_tpu_torch.features.pipeline import CsvDataset
    from wide_deep_tpu_torch.features.plan import FeaturePlan
    from wide_deep_tpu_torch.config import Config
    plan = FeaturePlan(Config(conf_dir))
    server = InputServer(lambda p, m, e: CsvDataset(plan, p, m, 16),
                         n_procs=1, scatter_shards=1, port=0,
                         fingerprint="aaaa")
    server.start()
    try:
        ds = RemoteInputDataset(plan, f"127.0.0.1:{server.port}", FIXTURE,
                                "train", global_batch=16, proc=0, n_procs=1,
                                fingerprint="bbbb")
        with pytest.raises(IOError, match="rejected"):
            next(iter(ds))
    finally:
        server.stop()


def test_loader_failure_reaches_client_as_err(conf_dir):
    from wide_deep_tpu_torch.features.input_service import (
        InputServer, RemoteInputDataset)
    from wide_deep_tpu_torch.features.plan import FeaturePlan
    from wide_deep_tpu_torch.config import Config
    plan = FeaturePlan(Config(conf_dir))
    spec = plan.batch_spec(16)

    def factory(path, mode, epoch_seed):
        def gen():
            yield {k: np.zeros(s, d) for k, (s, d) in spec.items()}
            raise RuntimeError("loader host lost the data volume")
        return gen()

    server = InputServer(factory, n_procs=1, scatter_shards=1, port=0)
    server.start()
    try:
        it = iter(RemoteInputDataset(plan, f"127.0.0.1:{server.port}",
                                     FIXTURE, "train", global_batch=16,
                                     proc=0, n_procs=1))
        next(it)
        with pytest.raises(IOError, match="lost the data volume"):
            next(it)
    finally:
        server.stop()


def test_input_server_cli_serves_the_ranks_plan(conf_dir, tmp_path):
    """tools.input_server from a conf dir: its batches carry the plan the
    ranks build (build_training_plan with global_batch_input), one plan row
    a rank."""
    import shutil
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.features.input_service import RemoteInputDataset
    from wide_deep_tpu_torch.training.loop import build_training_plan
    d = str(tmp_path / "conf")
    shutil.copytree(conf_dir, d)
    with open(os.path.join(d, "train.yaml")) as f:
        text = f.read()
    with open(os.path.join(d, "train.yaml"), "w") as f:
        f.write(text.replace("sharded_lookup: gspmd",
                             "sharded_lookup: explicit"))
    env = dict(os.environ, WIDE_DEEP_CONF_DIR=d,
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "wide_deep_tpu_torch.tools.input_server",
         "--port", "0", "--n_devices", "2", "--n_procs", "2",
         "--batch_size", "16", "--train_data", FIXTURE, "--pack_budget",
         "3"], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=str(tmp_path))
    try:
        deadline, line = time.time() + 120, ""
        while time.time() < deadline:
            line = proc.stdout.readline()
            if "table shards)" in line:
                break
            assert proc.poll() is None, proc.stdout.read()
        assert "2 table shards" in line, line
        port = int(re.search(r"input service on :(\d+)", line).group(1))
        cfg = Config(d)
        conf = dict(cfg.train, batch_size=16, train_data=FIXTURE,
                    pack_budget=3)
        plan = build_training_plan(cfg, conf, "wide_deep", 2, n_procs=2,
                                   global_batch_input=True)
        assert plan.scatter_shards == 2
        got = {}

        def run(p):
            got[p] = list(RemoteInputDataset(
                plan, f"127.0.0.1:{port}", FIXTURE, "train",
                global_batch=16, proc=p, n_procs=2))

        ts = [threading.Thread(target=run, args=(p,)) for p in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert got[0] and len(got[0]) == len(got[1])
        assert got[0][0]["label"].shape == (8,)
    finally:
        proc.kill()
        proc.wait(timeout=10)
