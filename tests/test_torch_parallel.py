"""The port's mesh rules and sharded plans against the JAX package's
(tests/test_parallel.py's concerns): the rank-to-card rule, the row-sharding
rule, a batch cut to a rank, the training plan's topology gate, per-shard
plans through both loaders, and the sharded fused optimizer on 4 ranks
against JAX's ``apply_fused_sharded_update`` on 4 virtual devices.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from paths import REPO  # noqa: E402
from test_torch_features import (force_plans, plan_pair,  # noqa: E402
                                 train_rows, write_conf)
from torch_rank_cases import run_ranks  # noqa: E402


@pytest.fixture(scope="module")
def conf_dir(tmp_path_factory):
    return write_conf(tmp_path_factory.mktemp("parallel_conf"))


# ------------------------------------------------------------- placement
@pytest.mark.parametrize("world,cards,want", [
    (2, 1, [("cuda:0", "gloo", 2), ("cuda:0", "gloo", 2)]),
    (2, 2, [("cuda:0", "nccl", 1), ("cuda:1", "nccl", 1)]),
    (4, 2, [("cuda:0", "gloo", 2), ("cuda:1", "gloo", 2),
            ("cuda:0", "gloo", 2), ("cuda:1", "gloo", 2)]),
    (2, 8, [("cuda:0", "nccl", 1), ("cuda:1", "nccl", 1)])])
def test_placement_rule(world, cards, want):
    """As many cards as ranks: a card each over NCCL; fewer: ranks share
    cards over gloo (NCCL refuses two ranks on one GPU)."""
    from wide_deep_tpu_torch.parallel.mesh import placement
    got = [placement(r, world, n_cards=cards) for r in range(world)]
    assert [(str(d), b, n) for d, b, n in got] == want


def test_placement_never_falls_back_to_the_cpu():
    from wide_deep_tpu_torch.parallel.mesh import placement
    with pytest.raises(RuntimeError, match="device='cpu'"):
        placement(0, 2, n_cards=0)
    dev, backend, _ = placement(1, 2, "cpu", n_cards=0)
    assert (dev.type, backend) == ("cpu", "gloo")


# ------------------------------------------------------------ sharding
def test_param_sharding_rule_matches_jax(conf_dir):
    """The row-sharded leaves are the ones JAX's param_shardings row-shards
    (a fold table follows its group's embedding table, which agrees here)."""
    from wide_deep_tpu.models.joint import build_model as jbuild
    from wide_deep_tpu.parallel import mesh as jmesh
    from wide_deep_tpu_torch.models.joint import build_model as tbuild
    from wide_deep_tpu_torch.parallel.mesh import param_shardings
    jp, tp = plan_pair(conf_dir)
    from wide_deep_tpu.config import Config as JConfig
    from wide_deep_tpu_torch.config import Config as TConfig
    jm = jbuild(JConfig(conf_dir), plan=jp, model_type="wide_deep")
    tm = tbuild(TConfig(conf_dir), plan=tp, model_type="wide_deep")
    jparams = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), {
            k: np.zeros(s, d) for k, (s, d) in jp.batch_spec(1).items()})[0])
    tparams, _ = tm.init(0, tm.sample_batch("meta"), "meta")
    for n, thr in ((2, 64), (4, 64), (8, 1 << 10)):
        mesh = jmesh.make_mesh(n, 1, jax.devices()[:n])
        sh = jmesh.param_shardings(mesh, jparams, size_threshold=thr)
        flat = jax.tree_util.tree_flatten_with_path(sh)[0]
        want = {tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in p)
                for p, s in flat if any(ax for ax in s.spec)}
        got = {tuple(map(str, p))
               for p in param_shardings(tparams, n, thr)}
        assert got == want, (n, got ^ want)
        assert ("linear", "w") in got and any("embed" in p for p in got)


def test_shard_batch_and_key_axis():
    """A global batch cut to a rank: its data slice's rows of each batch
    key, its shard's row of each plan array; the input service's slicing
    (key_axis, slice_for_proc) agrees with the JAX package's."""
    from wide_deep_tpu.features import input_service as jis
    from wide_deep_tpu_torch.features import input_service as tis
    from wide_deep_tpu_torch.parallel.mesh import Mesh, shard_batch
    batch = {"label": np.arange(8.0),
             "emb_ids_d8": np.arange(24).reshape(8, 3),
             "scat_ids_d8": np.arange(8).reshape(4, 2),
             "sopt_ok_d32": np.arange(4)}
    for rank in range(4):
        m = Mesh(2, 2, rank, torch.device("cpu"), "gloo")
        got = shard_batch(batch, m, 4)
        np.testing.assert_array_equal(
            got["label"], batch["label"][m.data_idx * 4:(m.data_idx + 1) * 4])
        np.testing.assert_array_equal(got["scat_ids_d8"],
                                      batch["scat_ids_d8"][rank:rank + 1])
        np.testing.assert_array_equal(got["sopt_ok_d32"], [rank])
    for k in batch:
        for s in (1, 4):
            assert tis.key_axis(k, s) == jis.key_axis(k, s)
    arr = np.arange(24).reshape(8, 3)
    for p in range(2):
        np.testing.assert_array_equal(tis.slice_for_proc("x", arr, p, 2, 2),
                                      jis.slice_for_proc("x", arr, p, 2, 2))


# -------------------------------------------------------- topology gate
TOPOLOGIES = [(1, 1, False), (2, 2, True), (4, 4, True), (2, 2, False),
              (2, 1, False)]


@pytest.mark.parametrize("n_dev,n_procs,service", TOPOLOGIES)
@pytest.mark.parametrize("which", ["production", "small"])
def test_build_training_plan_matches_jax(conf_dir, which, n_dev, n_procs,
                                         service):
    """The same groups, scatter_shards, sparse_opt and batch spec as the
    JAX package's build_training_plan for the topology."""
    from wide_deep_tpu.config import Config as JConfig
    from wide_deep_tpu.training.loop import build_training_plan as jbuild
    from wide_deep_tpu_torch.config import Config as TConfig
    from wide_deep_tpu_torch.training.loop import build_training_plan as tb
    d = os.path.join(REPO, "conf") if which == "production" else conf_dir
    jc, tc = JConfig(d), TConfig(d)
    conf = dict(jc.train, pack_budget=3, batch_size=25600
                if which == "production" else 64, scatter_mode="pallas",
                sparse_optimizer=True)
    if which == "small":
        conf["shard_threshold"] = 1
    jp, _, _ = jbuild(jc, conf, "wide_deep", n_dev, n_procs=n_procs,
                      global_batch_input=service)
    tp = tb(tc, dict(conf), "wide_deep", n_dev, n_procs=n_procs,
            global_batch_input=service)
    assert tp.to_dict() == jp.to_dict()
    for attr in ("scatter_shards", "pallas_scatter", "sparse_opt",
                 "shard_threshold"):
        assert getattr(tp, attr) == getattr(jp, attr), attr
    B = conf["batch_size"]
    js, ts = jp.batch_spec(B), tp.batch_spec(B)
    assert sorted(js) == sorted(ts)
    for k in js:
        assert tuple(js[k][0]) == tuple(ts[k][0]), k
        assert np.dtype(js[k][1]) == np.dtype(ts[k][1]), k
    if which == "production" and (n_dev, service) == (2, True):
        assert tp.scatter_shards == 2 and tp.sparse_opt
        assert ts["scat_ids_d8"][0] == (2, 1024000)
        assert ts["wscat_tiles_d16"][0][:2] == (2, 3)
        assert ts["sopt_uids_d32"][0] == (2, 25600)


def test_dedup_lookup_refuses_naming_roadmap(conf_dir, tmp_path):
    """``sharded_lookup: dedup``: build_training_plan gives the JAX
    package's plan fields for each topology (the dedup plans on a mesh fed
    with the global batch, no kernel plans, the fused optimizer's compact
    plans kept; the explicit exchange's gate where no host sees the global
    batch), and the same batch spec."""
    from wide_deep_tpu.config import Config as JConfig
    from wide_deep_tpu.training.loop import build_training_plan as jbuild
    from wide_deep_tpu_torch.config import Config as TConfig
    from wide_deep_tpu_torch.training.loop import build_training_plan as tb
    import shutil
    d = str(tmp_path / "conf")
    shutil.copytree(conf_dir, d)
    p = os.path.join(d, "train.yaml")
    with open(p) as f:
        text = f.read()
    with open(p, "w") as f:
        f.write(text.replace("sharded_lookup: gspmd", "sharded_lookup: dedup"))
    jc, tc = JConfig(d), TConfig(d)
    conf = dict(jc.train, pack_budget=3, batch_size=64, shard_threshold=1,
                scatter_mode="pallas", sparse_optimizer=True)
    for n_dev, n_procs, service in TOPOLOGIES:
        jp, explicit, dedup = jbuild(jc, conf, "wide_deep", n_dev,
                                     n_procs=n_procs,
                                     global_batch_input=service)
        tp = tb(tc, dict(conf), "wide_deep", n_dev, n_procs=n_procs,
                global_batch_input=service)
        for attr in ("scatter_shards", "pallas_scatter", "sparse_opt",
                     "shard_kind", "shard_threshold"):
            assert getattr(tp, attr) == getattr(jp, attr), (attr, n_dev)
        js, ts = jp.batch_spec(64), tp.batch_spec(64)
        assert {k: (tuple(v[0]), np.dtype(v[1])) for k, v in ts.items()} \
            == {k: (tuple(v[0]), np.dtype(v[1])) for k, v in js.items()}
        assert dedup == (n_dev > 1 and (n_procs == 1 or service))
        assert tp.shard_kind == ("dedup" if dedup else "scatter")
        if dedup:
            assert tp.scatter_shards == n_dev and not tp.pallas_scatter
            assert any(k.startswith("dscat_uids_") for k in ts)


# ----------------------------------------------- per-shard plans, loaders
@pytest.mark.parametrize("plans", ["range", "window"])
@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_plans_through_both_loaders(conf_dir, monkeypatch, plans,
                                            shards):
    """Per-shard plans (range or window, and the compact plans of the
    fused sparse optimizer) from the port's C++ binding and its Python
    transformer equal the JAX package's native batch bit for bit; the C++
    loader's caps agree with shard_cap."""
    from wide_deep_tpu.features.native import NativeTransformer as JNT
    from wide_deep_tpu_torch.features.native import NativeTransformer as TNT
    from wide_deep_tpu_torch.features.pipeline import FeatureTransformer as TT
    from wide_deep_tpu_torch.ops.scatter import shard_cap
    force_plans(monkeypatch, plans)
    kw = dict(pallas_scatter=True, sparse_opt=True, scatter_shards=shards,
              shard_threshold=1)
    jp, tp = plan_pair(conf_dir, **kw)
    rows = train_rows(40)
    text = "\n".join("\t".join(r) for r in rows).encode("utf-8")
    B = 48
    got = TNT(tp).transform_text(text, len(rows), B, "train")
    want = JNT(jp).transform_text(text, len(rows), B, "train")
    py = TT(tp).transform(rows, B, "train")
    for other in (want, py):
        assert sorted(got) == sorted(other)
        for k in got:
            np.testing.assert_array_equal(got[k], other[k], err_msg=k)
    prefix = "scat" if plans == "range" else "wscat"
    keys = [k for k in got if k.startswith(prefix + "_ok_")]
    assert keys and any(k.startswith("sopt_ok_") for k in got)
    for k in keys + [k for k in got if k.startswith("sopt_ok_")]:
        dim = int(k.rsplit("_d", 1)[1])
        n = B * tp.group_packed_len[dim]
        pre = k.split("_ok_")[0]
        assert got[k].shape == (shards,)
        assert got[f"{pre}_ids_d{dim}"].shape == (shards, shard_cap(n, shards))


# --------------------------------------------- the sharded fused update
def _sparse_case(mesh, seed, hot=False, spec=None):
    from wide_deep_tpu.ops.scatter import make_sharded_compact_plan
    rng = np.random.default_rng(seed)
    rows, dim, B, Pw = 1024, 8, (256 if hot else 32), 4
    fused = np.zeros((rows, 128), np.float32)
    fused[:, :dim] = rng.normal(size=(rows, dim)) * 0.1
    fused[:, dim:2 * dim] = 0.1
    if spec and spec["name"] == "Ftrl":
        fused[:, 2 * dim:3 * dim] = rng.normal(size=(rows, dim)) * 0.01
    ids = rng.integers(0, rows, (B, Pw)).astype(np.int32)
    if hot:
        ids = rng.integers(0, rows // 4, (B, Pw)).astype(np.int32)
    ids[:4] = ids[4:8]
    rg = rng.normal(size=(B * Pw, dim)).astype(np.float32)
    plan = make_sharded_compact_plan(ids.reshape(-1), rows, 4)
    return {"mesh": mesh, "fused": fused, "ids": ids, "row_grads": rg,
            "plan": plan, "dim": dim, "lr": 0.05,
            "spec": spec or {"name": "Adagrad",
                             "initial_accumulator_value": 0.1}}


SPARSE_CASES = [
    ("adagrad_4x1", _sparse_case((4, 1), 1)),
    ("adagrad_2x2", _sparse_case((2, 2), 2)),
    ("adagrad_ok0", _sparse_case((4, 1), 3, hot=True)),
    ("ftrl", _sparse_case((4, 1), 4, spec={
        "name": "Ftrl", "l1_regularization_strength": 0.5,
        "l2_regularization_strength": 1.0,
        "initial_accumulator_value": 0.1})),
]


@pytest.fixture(scope="module")
def sparse_ranks(tmp_path_factory):
    res = run_ranks("sparse", 4, tmp_path_factory.mktemp("sparse"),
                    [c for _, c in SPARSE_CASES])
    return {name: [r[i] for r in res]
            for i, (name, _) in enumerate(SPARSE_CASES)}


def _jax_sparse(case):
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from wide_deep_tpu.optim.sparse import (SparseTable,
                                            apply_fused_sharded_update)
    from wide_deep_tpu.parallel import mesh as jmesh
    mesh = jmesh.make_mesh(*case["mesh"], jax.devices()[:4])
    sall = P(("data", "model"))
    t = SparseTable(name="t", path=("t",), ids_key="ids", spec=case["spec"],
                    lr=case["lr"], dim=case["dim"], fused=True)
    fused = jax.device_put(jnp.asarray(case["fused"]),
                           NamedSharding(mesh, P(("data", "model"), None)))
    plan = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, sall))
            for k, v in case["plan"].items()}
    rg = jax.device_put(jnp.asarray(case["row_grads"]),
                        NamedSharding(mesh, P("data", None)))
    ids = jax.device_put(jnp.asarray(case["ids"]),
                         NamedSharding(mesh, P("data", None)))
    out, _ = apply_fused_sharded_update(t, fused, rg, ids, plan,
                                        {"count": 0}, mesh, interpret=True)
    return np.asarray(out)


@pytest.mark.parametrize("name", [n for n, _ in SPARSE_CASES])
def test_fused_sharded_update_matches_jax(sparse_ranks, name):
    """Per rank: K1 over the shard's live entries (rows = cap), the row
    formula, K3 into the local shard; an overflowing shard (ok=0) takes the
    exact branch.  Touched rows within rtol 1e-5 / atol 1e-6 of JAX's
    (tests/test_torch_sparse_optim.py's tolerance: float32 sums in another
    order, and the port's FTRL roots rounded once from float64), untouched
    rows bit for bit."""
    case = dict(SPARSE_CASES)[name]
    want = _jax_sparse(case)
    got = np.concatenate([r["shard"] for r in sparse_ranks[name]])
    touched = np.zeros(want.shape[0], bool)
    touched[case["ids"].reshape(-1)] = True
    np.testing.assert_array_equal(got[~touched], want[~touched])
    np.testing.assert_allclose(got[touched], want[touched], rtol=1e-5,
                               atol=1e-6)
    if name == "adagrad_ok0":
        assert case["plan"]["ok"][0] == 0 and case["plan"]["ok"][1:].all()


def test_fused_update_bytes_scale_with_the_cotangent(sparse_ranks):
    """The update all-gathers the [N, D] cotangent and the ids over 'data'
    and nothing else: bytes scale with the entries, not the table."""
    case = dict(SPARSE_CASES)["adagrad_4x1"]
    n_local = case["ids"].size // 4
    want = n_local * case["dim"] * 4 + n_local * 4
    for r in sparse_ranks["adagrad_4x1"]:
        assert r["bytes"] == {"sparse_update": want}
        assert r["max_bytes"]["sparse_update"] < case["fused"].nbytes // 4
    # on 2x2 the data axis has 2 ranks: each moves half the entries' bytes
    c2 = dict(SPARSE_CASES)["adagrad_2x2"]
    n2 = c2["ids"].size // 2
    for r in sparse_ranks["adagrad_2x2"]:
        assert r["bytes"] == {"sparse_update": n2 * c2["dim"] * 4 + n2 * 4}
