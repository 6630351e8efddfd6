"""The port's dedup exchange (``sharded_lookup: dedup``) against the JAX
package's: the host plans (ops/scatter.dedup_cap / make_dedup_plan), both
loaders' ``dscat_*`` arrays, ``DedupGather`` (parallel/exchange.py) and
the train step on 2 gloo ranks (tests/torch_rank_cases.py, spawned once
for the file).

Plans and loader arrays must equal JAX's bit for bit.  The gather's
forward must equal ``index_select`` bit for bit and its table gradient lie
within 1e-6 of each row's sum of |g| of JAX's ``dedup_sharded_gather``
(float32 sums in another order).  The step's losses must lie within 1e-5 of
the JAX package's dedup step on a 2-device mesh (tests/test_exchange.py's
``test_dedup_step_matches_gspmd`` is the model), be the same bits on both
ranks, and lie within 1e-5 of the port's explicit exchange on the same
batches, on ``{data: 1, model: 2}`` and on ``{data: 2, model: 1}`` behind
the input service.
"""

import argparse
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from paths import TRAIN1  # noqa: E402
from test_torch_features import (force_plans, plan_pair,  # noqa: E402
                                 train_rows, write_conf)
from torch_rank_cases import run_ranks  # noqa: E402

B = 16
STEPS = 3


# ------------------------------------------------------------ host plans
def _ids(kind, n_rows, shape, seed):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.integers(0, n_rows, shape).astype(np.int32)
    # hot keys: most entries on a few ids, the rest uniform
    ids = rng.integers(0, n_rows, shape).astype(np.int32)
    hot = rng.random(shape) < 0.8
    ids[hot] = rng.integers(0, 16, int(hot.sum()))
    return ids


CAP_SHAPES = [(1024000, 1203200, 2), (1024000, 1203200, 4),
              (102400, 1500160, 2), (25600, 10000128, 2),
              (25600, 10000128, 8), (64, 17408, 2), (1000, 128, 4),
              (5, 1024, 8)]


@pytest.mark.parametrize("n,rows,shards", CAP_SHAPES)
def test_dedup_cap_matches_jax(n, rows, shards):
    from wide_deep_tpu.ops import scatter as jsc
    from wide_deep_tpu_torch.ops import scatter as tsc
    assert tsc.DEDUP_SLACK == jsc.DEDUP_SLACK
    assert tsc.dedup_cap(n, rows, shards) == jsc.dedup_cap(n, rows, shards)
    assert (tsc.dedup_batch_spec(n, rows, shards, (n, 1))
            == jsc.dedup_batch_spec(n, rows, shards, (n, 1)))


@pytest.mark.parametrize("kind", ["uniform", "hot"])
@pytest.mark.parametrize("shards", [2, 4, 8])
def test_make_dedup_plan_matches_jax(shards, kind):
    from wide_deep_tpu.ops.scatter import make_dedup_plan as jmake
    from wide_deep_tpu_torch.ops.scatter import make_dedup_plan as tmake
    rows = 4096
    ids = _ids(kind, rows, (64, 6), shards)
    got, want = tmake(ids, rows, shards), jmake(ids, rows, shards)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the plan's meaning: slot -> the unique row of the entry's id
    cap = got["uids"].shape[1]
    s, j = np.divmod(got["slots"], cap)
    np.testing.assert_array_equal(got["uids"][s, j] + s * (rows // shards),
                                  ids)


@pytest.mark.parametrize("fault", ["overflow", "out_of_range"])
def test_dedup_plan_errors_match_jax(fault):
    from wide_deep_tpu.ops.scatter import make_dedup_plan as jmake
    from wide_deep_tpu_torch.ops.scatter import make_dedup_plan as tmake
    rows = 1 << 16
    if fault == "overflow":
        # every id distinct and on shard 0: past the cap sized for
        # uniform draws over the whole table
        ids = np.arange(4096, dtype=np.int32).reshape(64, 64)
    else:
        ids = np.array([[0, 5, rows]], np.int32)
    with pytest.raises(ValueError) as je:
        jmake(ids, rows, 2)
    with pytest.raises(ValueError) as te:
        tmake(ids, rows, 2)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("shards", [2, 4])
def test_loaders_dscat_match_jax_native(tmp_path, monkeypatch, shards):
    """The port's C++ binding and Python transformer give the JAX
    package's native train batch bit for bit, ``dscat_*`` and the fused
    optimizer's per-shard compact plans included."""
    from wide_deep_tpu.features.native import NativeTransformer as JNT
    from wide_deep_tpu_torch.features.native import NativeTransformer as TNT
    from wide_deep_tpu_torch.features.pipeline import FeatureTransformer as TT
    force_plans(monkeypatch, "range")
    jp, tp = plan_pair(write_conf(tmp_path / "conf"), sparse_opt=True,
                       scatter_shards=shards, shard_threshold=1,
                       shard_kind="dedup")
    rows = train_rows(40)
    text = "\n".join("\t".join(r) for r in rows).encode("utf-8")
    got = TNT(tp).transform_text(text, len(rows), 48, "train")
    want = JNT(jp).transform_text(text, len(rows), 48, "train")
    py = TT(tp).transform(rows, 48, "train")
    for other in (want, py):
        assert sorted(got) == sorted(other)
        for k in got:
            np.testing.assert_array_equal(got[k], other[k], err_msg=k)
    keys = [k for k in got if k.startswith("dscat_uids_")]
    assert keys and any(k.startswith("sopt_ok_") for k in got)
    assert not any(k.startswith(("scat_", "wscat_")) for k in got)
    for k in keys:
        assert got[k].shape[0] == shards


# --------------------------------------------------------- the exchange
def _gather_case(name, mesh, rows, D, Bc, Pw, seed, pad=0.0):
    from wide_deep_tpu.ops.scatter import make_dedup_plan
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(rows, D)).astype(np.float32)
    ids = rng.integers(0, rows, (Bc, Pw)).astype(np.int32)
    ids[:Bc // 4] = ids[Bc // 4:Bc // 2]             # duplicates
    wts = np.ones((Bc, Pw), np.float32)
    if pad:
        m = rng.random((Bc, Pw)) < pad
        ids[m], wts[m] = 0, 0.0
    cot = rng.normal(size=(Bc, Pw, D)).astype(np.float32)
    if pad:
        cot[m] = 0.0          # a padding entry's cotangent is zero
    return {"name": name, "mesh": mesh, "kind": "dedup", "table": table,
            "ids": ids, "cot": cot, "wts": wts if pad else None,
            "plan": make_dedup_plan(ids, rows, 2), "dtype": "float32"}


GATHERS = [_gather_case("model_axis", (1, 2), 512, 8, 16, 6, 1),
           _gather_case("data_axis", (2, 1), 512, 9, 16, 6, 2),
           _gather_case("padding", (2, 1), 1024, 5, 32, 8, 3, pad=0.4)]
# duplication-heavy ids (4,096 entries over 1,024 rows), through both
# exchanges (tests/test_hlo_collectives.py's
# test_dedup_volume_is_unique_scaled is the model)
HEAVY = _gather_case("heavy", (2, 1), 1024, 16, 512, 8, 4)
HEAVY_EXPLICIT = dict(HEAVY, name="heavy_explicit", kind="explicit",
                      plan=None)


def _jax_dedup(case):
    """JAX's dedup_sharded_gather on a 2-device mesh of the case's shape:
    (rows, table gradient)."""
    from wide_deep_tpu.parallel import mesh as jmesh
    from wide_deep_tpu.parallel.exchange import dedup_sharded_gather
    mesh = jmesh.make_mesh(case["mesh"][0], case["mesh"][1],
                           jax.devices()[:2])
    sall = P(("data", "model"))
    tbl = jax.device_put(jnp.asarray(case["table"]),
                         NamedSharding(mesh, sall))
    uids = jax.device_put(jnp.asarray(case["plan"]["uids"]),
                          NamedSharding(mesh, sall))
    slots = jnp.asarray(case["plan"]["slots"])
    cot = jnp.asarray(case["cot"])

    def loss(t):
        out = dedup_sharded_gather(t, slots, uids, mesh)
        return jnp.vdot(out, cot), out

    g, out = jax.jit(jax.grad(loss, has_aux=True))(tbl)
    return np.asarray(out), np.asarray(g)


def _conf(dst, lookup, service=None):
    d = write_conf(dst)
    p = os.path.join(d, "train.yaml")
    with open(p) as f:
        text = f.read()
    text = text.replace("sharded_lookup: gspmd", f"sharded_lookup: {lookup}")
    if service:
        text = text.replace('input_service: ""',
                            f'input_service: "{service}"')
    with open(p, "w") as f:
        f.write(text)
    return d


def _overrides(data):
    return dict(train_data=data, eval_data=data, test_data=data,
                keep_train=True, batch_size=B, pack_budget=3,
                sparse_optimizer=True, scatter_mode="pallas",
                shard_threshold=1)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        yield _run_all(tmp_path_factory.mktemp("dedup"), mp)
    finally:
        mp.undo()


def _run_all(tmp, mp):
    from wide_deep_tpu.config import Config as JConfig
    from wide_deep_tpu.parallel import mesh as jmesh
    from wide_deep_tpu.training.loop import Trainer as JTrainer
    from wide_deep_tpu_torch.config import Config as TConfig
    from wide_deep_tpu_torch.interop import from_jax
    from wide_deep_tpu_torch.tools.input_server import build_server

    force_plans(mp, "range")
    data = str(tmp / "train")
    with open(TRAIN1) as f, open(data, "w") as out:
        out.writelines(line for i, line in enumerate(f) if i < STEPS * B)
    ov = _overrides(data)
    confs = {lk: _conf(tmp / f"conf_{lk}", lk)
             for lk in ("dedup", "explicit")}

    # JAX's dedup step on a 2-device mesh
    jtr = JTrainer(JConfig(confs["dedup"]), model_type="wide_deep",
                   model_dir=str(tmp / "jax"), overrides=ov,
                   mesh=jmesh.make_mesh(2, 1, jax.devices()[:2]))
    assert jtr.plan.shard_kind == "dedup"
    jtr.ensure_initialized(restore=False)
    params, mstate = from_jax(jax.device_get(jtr.params),
                              jax.device_get(jtr.mstate), device="cpu")
    jlosses, step = [], jtr._train_step

    def record(*a):
        r = step(*a)
        jlosses.append(float(r[3]))
        return r
    jtr._train_step = record
    jtr.train_file(data)
    out = {"jax_losses": jlosses}

    # the port: an input service a lookup, then every rank case at once
    servers = {}
    for lk in confs:
        cfg = TConfig(confs[lk])
        srv, _ = build_server(cfg, dict(cfg.train, **ov), argparse.Namespace(
            model_type="wide_deep", n_devices=2, n_procs=2, n_classes=2,
            batch_size=B, port=0, proc_start=0, proc_count=None,
            image_train_data=None))
        srv.start()
        servers[lk] = srv
    try:
        base = dict(force_plans="range", overrides=ov, data=data,
                    params=params, mstate=mstate)
        runs = []
        for lk in confs:
            runs.append((f"{lk}_model_axis", dict(
                base, mesh=(1, 2), conf_dir=confs[lk],
                model_dir=str(tmp / f"{lk}_1x2"))))
            svc = _conf(tmp / f"conf_{lk}_svc", lk,
                        f"127.0.0.1:{servers[lk].port}")
            runs.append((f"{lk}_svc", dict(
                base, mesh=(2, 1), conf_dir=svc,
                model_dir=str(tmp / f"{lk}_2x1"))))
        gathers = GATHERS + [HEAVY, HEAVY_EXPLICIT]
        res = run_ranks("many", 2, tmp, [("exchange", gathers)] + [
            ("trainer", a) for _, a in runs])
    finally:
        for srv in servers.values():
            srv.stop()
    out["gathers"] = {c["name"]: [r[0][i] for r in res]
                      for i, c in enumerate(gathers)}
    for i, (name, a) in enumerate(runs):
        out[name] = [r[1 + i] for r in res]
        out[name + "_conf"] = a["conf_dir"]
    out["ov"] = ov
    return out


@pytest.mark.parametrize("name", [c["name"] for c in GATHERS])
def test_dedup_gather_matches_jax(world, name):
    case = next(c for c in GATHERS if c["name"] == name)
    ranks = world["gathers"][name]
    mesh = case["mesh"]
    want_rows = case["table"][case["ids"].reshape(-1)]
    got = np.concatenate([r["out"] for r in ranks[::mesh[1]]])
    np.testing.assert_array_equal(got, want_rows)
    out_jax, g_jax = _jax_dedup(case)
    np.testing.assert_array_equal(out_jax.reshape(-1, case["table"].shape[1]),
                                  want_rows)
    g = np.concatenate([r["grad"] for r in ranks])
    d = case["table"].shape[1]
    bound = np.zeros_like(g, np.float64)
    np.add.at(bound, case["ids"].reshape(-1),
              np.abs(case["cot"].reshape(-1, d)))
    assert (np.abs(g - g_jax) <= 1e-6 * bound + 1e-30).all(), (
        name, float(np.abs(g - g_jax).max()))
    # one all-gather of S x cap rows forward, one reduce-scatter back
    cap = case["plan"]["uids"].shape[1]
    for r in ranks:
        assert r["bytes"] == {"dedup_rows": cap * d * 4,
                              "dedup_rows_bwd": 2 * cap * d * 4}


@pytest.mark.parametrize("run", ["model_axis", "svc"])
def test_dedup_step_matches_jax_and_explicit(world, run):
    r0, r1 = world[f"dedup_{run}"]
    e0, e1 = world[f"explicit_{run}"]
    assert r0["losses"] == r1["losses"] and len(r0["losses"]) == STEPS
    np.testing.assert_allclose(r0["losses"], world["jax_losses"], rtol=1e-5)
    np.testing.assert_allclose(r0["losses"], e0["losses"], rtol=1e-5)
    assert e0["losses"] == e1["losses"]
    # the ranks ran the dedup exchange: unique-id plans in the batch, rows
    # moved by the dedup collectives, the fused optimizer's compact plans
    assert any(k.startswith("dscat_uids_") for k in r0["plan_keys"])
    assert any(k.startswith("sopt_ok_") for k in r0["plan_keys"])
    assert not any(k.startswith(("scat_", "wscat_"))
                   for k in r0["plan_keys"])
    for sb in r0["step_bytes"]:
        assert sb["dedup_rows"] > 0 and sb["dedup_rows_bwd"] > 0
    assert all("dedup_rows" not in sb for sb in e0["step_bytes"])


@pytest.mark.parametrize("run", ["model_axis", "svc"])
@pytest.mark.parametrize("lookup", ["dedup", "explicit"])
def test_collective_stats_equal_counted_bytes(world, monkeypatch, lookup,
                                              run):
    """parallel/collective_stats predicts, from shapes alone, every step's
    counted bytes by tag on both ranks, exactly."""
    import wide_deep_tpu_torch.features.plan as tplan
    import wide_deep_tpu_torch.optim.sparse as tsparse
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.parallel.collective_stats import step_collectives
    # the ranks' plan forcing (torch_rank_cases._force_plans("range"))
    monkeypatch.setattr(tsparse, "SPARSE_MIN_ROWS", 1)
    monkeypatch.setattr(
        tplan.FeaturePlan, "scatter_group",
        lambda self, g, b: self.pallas_scatter and g.folded and (
            self.scatter_shards == 1 or (
                g.rows % self.scatter_shards == 0
                and g.rows * g.dim
                >= self.shard_threshold * self.scatter_shards)))
    cfg = Config(world[f"{lookup}_{run}_conf"])
    mesh = (1, 2) if run == "model_axis" else (2, 1)
    want = step_collectives(cfg, dict(cfg.train, **world["ov"]), *mesh)
    assert want["plan"]["shard_kind"] == (
        "dedup" if lookup == "dedup" else "scatter")
    for r in world[f"{lookup}_{run}"]:
        assert len(r["step_bytes"]) == STEPS
        for sb in r["step_bytes"]:
            assert sb == want["by_tag"]


def test_dedup_moves_fewer_lookup_bytes(world):
    """On duplicated ids the dedup exchange moves the S x cap unique-row
    block both ways, far below the explicit exchange's ids x D."""
    from wide_deep_tpu_torch.ops.scatter import dedup_cap
    Bc, Pw = HEAVY["ids"].shape
    d = HEAVY["table"].shape[1]
    cap = dedup_cap(Bc * Pw, HEAVY["table"].shape[0], 2)
    assert 2 * cap < Bc * Pw // 2, "the fixture must be duplication-heavy"
    for r in world["gathers"]["heavy"]:
        assert r["bytes"] == {"dedup_rows": cap * d * 4,
                              "dedup_rows_bwd": 2 * cap * d * 4}
    for r, e in zip(world["gathers"]["heavy"],
                    world["gathers"]["heavy_explicit"]):
        assert sum(r["bytes"].values()) < sum(e["bytes"].values()) / 2
        np.testing.assert_array_equal(r["out"], e["out"])
        np.testing.assert_allclose(r["grad"], e["grad"], rtol=1e-6,
                                   atol=1e-6)
