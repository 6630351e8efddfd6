"""The port's sharded-embedding exchange (wide_deep_tpu_torch/parallel/
exchange.py) and per-shard plan builders against the JAX package's
(tests/test_exchange.py's cases).

Four ranks of the port (gloo processes, tests/torch_rank_cases.py) run every
case once, on meshes of 4x1 and 2x2; JAX runs the same numpy inputs on a
mesh of 4 of conftest's 8 virtual CPU devices.  Forward rows must equal
``index_select`` bit for bit; a shard's gradient must lie within 1e-6 of
each row's sum of |g| of JAX's ``planned_sharded_gather`` (float32 sums
taken in another order).  The collective byte counter is held to the
exchange's contract (the counterpart of tests/test_hlo_collectives.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from torch_rank_cases import run_ranks  # noqa: E402

S = 4


def _jax_mesh(shape):
    from wide_deep_tpu.parallel import mesh as mesh_lib
    return mesh_lib.make_mesh(shape[0], shape[1], jax.devices()[:S])


def _case(name, mesh, kind, rows, D, B, Pw, seed, plan=None, hot=None,
          pad=0.0, dtype="float32", wts=False):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(rows, D)).astype(np.float32)
    if dtype == "bfloat16":
        table = np.asarray(jnp.asarray(table, jnp.bfloat16).astype(
            jnp.float32))
    ids = rng.integers(0, rows, (B, Pw)).astype(np.int32)
    ids[:B // 4] = ids[B // 4:B // 2]            # duplicates across rows
    if hot == "shard0":
        ids = rng.integers(0, rows // S, (B, Pw)).astype(np.int32)
    elif hot == "window0":
        ids = rng.integers(0, 8, (B, Pw)).astype(np.int32)
    elif hot == "live":
        from wide_deep_tpu.ops.scatter import shard_cap, shard_live_cap
        n = B * Pw
        small, cap = shard_live_cap(n, S), shard_cap(n, S)
        h = (small + cap) // 2
        flat = rng.integers(rows // S, rows, n).astype(np.int32)
        flat[:h] = rng.integers(0, rows // S, h)
        ids = rng.permutation(flat).reshape(B, Pw).astype(np.int32)
    weights = np.ones((B, Pw), np.float32)
    if pad:
        m = rng.random((B, Pw)) < pad
        ids[m], weights[m] = 0, 0.0
    cot = rng.normal(size=(B, Pw, D)).astype(np.float32)
    if pad:
        cot[m] = 0.0
    sp = None
    if plan is not None:
        from wide_deep_tpu.ops import scatter as jsc
        make = (jsc.make_sharded_window_plan if plan == "window"
                else jsc.make_sharded_scatter_plan)
        sp = make(ids.reshape(-1), rows, S,
                  weights.reshape(-1) if (pad or wts) else None)
    return {"name": name, "mesh": mesh, "kind": kind, "table": table,
            "ids": ids, "cot": cot, "plan": sp, "dtype": dtype}


CASES = [
    _case("explicit", (4, 1), "explicit", 256, 8, 16, 5, 0),
    _case("explicit_2x2", (2, 2), "explicit", 512, 4, 8, 3, 1),
    _case("planned", (4, 1), "planned", 512, 8, 16, 6, 3, plan="range"),
    _case("planned_2x2", (2, 2), "planned", 512, 8, 16, 6, 3, plan="range"),
    _case("planned_ok0", (4, 1), "planned", 512, 4, 32, 8, 4, plan="range",
          hot="shard0"),
    _case("window", (4, 1), "planned", 512, 16, 16, 6, 21, plan="window"),
    _case("window_padding", (4, 1), "planned", 512, 8, 16, 8, 22,
          plan="window", pad=0.4),
    _case("window_hot", (4, 1), "planned", 512, 8, 32, 8, 23,
          plan="window", hot="window0"),
    _case("live_cap", (4, 1), "planned", 512, 8, 512, 8, 31, plan="range",
          pad=0.25),
    _case("live_overflow", (4, 1), "planned", 512, 8, 512, 8, 32,
          plan="range", hot="live"),
    _case("window_live_cap", (4, 1), "planned", 512, 16, 512, 8, 33,
          plan="window", pad=0.25),
    _case("bf16", (4, 1), "planned", 512, 8, 16, 6, 41, plan="range",
          dtype="bfloat16"),
    _case("bf16_explicit", (2, 2), "explicit", 256, 8, 16, 5, 42,
          dtype="bfloat16"),
    _case("big_table", (4, 1), "explicit", 4096, 8, 16, 5, 51),
]
STATIC = {"name": "static", "mesh": (2, 2), "kind": "static",
          "table": np.random.default_rng(61).normal(
              size=(512, 1)).astype(np.float32),
          "ids": np.array([3, 200, 511, 3, 130], np.int32),
          "cot": np.random.default_rng(62).normal(
              size=(5, 1)).astype(np.float32)}
NAMES = [c["name"] for c in CASES]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    res = run_ranks("exchange", S, tmp_path_factory.mktemp("exchange"),
                    CASES + [STATIC])
    return {c["name"]: [r[i] for r in res]
            for i, c in enumerate(CASES + [STATIC])}


def _jax_grads(case):
    """JAX's planned / explicit gather on the same mesh shape: (rows,
    table gradient)."""
    from wide_deep_tpu.parallel.exchange import (explicit_sharded_gather,
                                                 planned_sharded_gather)
    mesh = _jax_mesh(case["mesh"])
    dt = jnp.bfloat16 if case["dtype"] == "bfloat16" else jnp.float32
    sall = P(("data", "model"))
    tbl = jax.device_put(jnp.asarray(case["table"], dt),
                         NamedSharding(mesh, sall))
    ids, cot = jnp.asarray(case["ids"]), jnp.asarray(case["cot"])
    sp = case["plan"]
    if sp is not None:
        args = [jax.device_put(jnp.asarray(sp[k]), NamedSharding(mesh, sall))
                for k in ("ids", "perm", "tiles", "ok", "live")]

    def loss(t):
        if sp is None:
            out = explicit_sharded_gather(t, ids, mesh)
        else:
            out = planned_sharded_gather(t, ids, *args[:4], mesh=mesh,
                                         interpret=True, plan_live=args[4])
        return jnp.vdot(out.astype(jnp.float32), cot), out

    g, out = jax.jit(jax.grad(loss, has_aux=True))(tbl)
    return np.asarray(out, np.float32), np.asarray(g, np.float32)


def _row_abs_sum(case):
    """Each table row's sum of |g| over its entries (the gradient bound's
    scale)."""
    rows, d = case["table"].shape
    out = np.zeros((rows, d), np.float64)
    np.add.at(out, case["ids"].reshape(-1),
              np.abs(case["cot"].reshape(-1, d)))
    return out


def _whole(results, key):
    return np.concatenate([r[key] for r in results])


@pytest.mark.parametrize("name", NAMES)
def test_forward_equals_index_select(ranks, name):
    case = CASES[NAMES.index(name)]
    mesh = case["mesh"]
    got = _whole(ranks[name][::mesh[1]], "out")   # one rank per data slice
    want = case["table"][case["ids"].reshape(-1)]
    np.testing.assert_array_equal(got, want)
    for d in range(mesh[0]):   # the model ranks of a data slice agree
        outs = [ranks[name][d * mesh[1] + m]["out"] for m in range(mesh[1])]
        for o in outs[1:]:
            np.testing.assert_array_equal(o, outs[0])


@pytest.mark.parametrize("name", NAMES)
def test_grads_match_jax(ranks, name):
    case = CASES[NAMES.index(name)]
    out, g_jax = _jax_grads(case)
    np.testing.assert_array_equal(out, case["table"][case["ids"]])
    g = _whole(ranks[name], "grad")
    bound = 1e-6 * _row_abs_sum(case)
    if case["dtype"] == "bfloat16":
        # both sum in float32 and round each row once to bfloat16: within
        # one bfloat16 ulp of the row
        bound = np.maximum(bound, np.abs(g_jax) * 2.0 ** -7)
    assert (np.abs(g - g_jax) <= bound + 1e-30).all(), (
        name, float(np.abs(g - g_jax).max()))


def test_branches_taken(ranks):
    """The plan branches the cases were built for: ok=0 shards sum exactly
    without the plan, the live-cap prefix runs where every live count fits,
    and a live overflow takes the full stream."""
    assert ranks["planned_ok0"][0]["branches"] == {"exact": 1}
    assert all("exact" not in r["branches"]
               for r in ranks["planned_ok0"][1:])
    assert ranks["window_hot"][0]["branches"] == {"exact": 1}
    assert all(r["branches"] == {"live_cap": 1}
               for r in ranks["live_cap"])
    assert all(r["branches"] == {"live_cap": 1}
               for r in ranks["window_live_cap"])
    assert ranks["live_overflow"][0]["branches"] == {"full": 1}
    assert all(r["branches"] == {} for r in ranks["explicit"])


def test_static_rows_gather(ranks):
    """The wide table's indicator rows: every rank gets the rows; the
    gradient is each data slice's cotangent once, on the owning shard."""
    want = STATIC["table"][STATIC["ids"]]
    for r in ranks["static"]:
        np.testing.assert_array_equal(r["out"], want)
    g = _whole(ranks["static"], "grad")
    ref = np.zeros_like(STATIC["table"])
    np.add.at(ref, STATIC["ids"], STATIC["cot"] * 2)   # 2 data slices
    np.testing.assert_allclose(g, ref, rtol=1e-6, atol=1e-7)


# -------------------------------------------------- byte-counter contract
def test_lookup_bytes_scale_with_ids_times_d(ranks):
    """The exchange moves ids x D: the ids (int32) all-gathered, then the
    [B, P, D] rows reduce-scattered (and all-reduced over 'model')."""
    for name in ("explicit", "planned", "big_table"):
        case = CASES[NAMES.index(name)]
        B, Pw = case["ids"].shape
        D = case["table"].shape[1]
        b_local = B // case["mesh"][0]
        want = b_local * Pw * 4 + B * Pw * D * 4
        for r in ranks[name]:
            assert r["bytes"]["lookup"] == want, (name, r["bytes"])
            assert r["bytes"]["lookup_bwd"] == b_local * Pw * D * 4


def test_no_collective_carries_the_table(ranks):
    """Growing the table 16x (256 -> 4096 rows) leaves every collective's
    bytes as they were: nothing table-sized crosses."""
    small, big = ranks["explicit"][0], ranks["big_table"][0]
    assert small["bytes"] == big["bytes"]
    rows_bytes = CASES[NAMES.index("big_table")]["table"].nbytes // S
    assert max(big["max_bytes"].values()) < rows_bytes


def test_model_axis_bytes(ranks):
    """On the 2x2 mesh the rows are all-reduced over 'model' too."""
    case = CASES[NAMES.index("explicit_2x2")]
    B, Pw = case["ids"].shape
    D = case["table"].shape[1]
    want = (B // 2) * Pw * 4 + 2 * B * Pw * D * 4
    assert all(r["bytes"]["lookup"] == want for r in ranks["explicit_2x2"])


# ----------------------------------------------------------- plan builders
PLAN_SHAPES = [(16 * 6, 512, 4, 0.0), (512 * 8, 512, 4, 0.25),
               (4096, 4096, 2, 0.3), (2048, 1 << 14, 8, 0.0)]


@pytest.mark.parametrize("n,rows,shards,pad", PLAN_SHAPES)
@pytest.mark.parametrize("kind", ["scatter", "window", "compact"])
def test_sharded_plans_equal_jax(kind, n, rows, shards, pad):
    from wide_deep_tpu.ops import scatter as jsc
    from wide_deep_tpu_torch.ops import scatter as tsc
    rng = np.random.default_rng(n + rows)
    ids = rng.integers(0, rows, n).astype(np.int32)
    w = (rng.random(n) >= pad).astype(np.float32)
    if kind == "compact":
        j = jsc.make_sharded_compact_plan(ids, rows, shards)
        t = tsc.make_sharded_compact_plan(ids, rows, shards)
        assert tsc.sharded_compact_plan_spec(n, shards) == \
            jsc.sharded_compact_plan_spec(n, shards)
    else:
        name = f"make_sharded_{kind}_plan"
        j = getattr(jsc, name)(ids, rows, shards, w)
        t = getattr(tsc, name)(ids, rows, shards, w)
        spec = f"sharded_{kind}_batch_spec"
        assert getattr(tsc, spec)(n, rows, shards) == \
            getattr(jsc, spec)(n, rows, shards)
    assert sorted(j) == sorted(t)
    for k in j:
        assert j[k].dtype == t[k].dtype, k
        np.testing.assert_array_equal(j[k], t[k], err_msg=k)


def test_live_cap_engages_at_production_shapes():
    """At batch 25600 and the production pool widths the port's compact cap
    lies strictly under the full shard cap (and equals JAX's) for 2-64
    shards."""
    from wide_deep_tpu.ops import scatter as jsc
    from wide_deep_tpu_torch.ops import scatter as tsc
    for pool in (1, 4, 26, 40):
        n = 25600 * pool
        for s in (2, 4, 8, 16, 32, 64):
            small, cap = tsc.shard_live_cap(n, s), tsc.shard_cap(n, s)
            assert (small, cap) == (jsc.shard_live_cap(n, s),
                                    jsc.shard_cap(n, s))
            assert small < cap and small <= 0.7 * cap, (pool, s)


def test_production_shard_caps():
    """The caps the production plan gives each shard at 2 ranks (the
    figures PERF.md quotes): d8 stream 1,024,000 (live 640,000), d16
    102,400 (64,000), d32 compact 25,600 (16,000)."""
    from wide_deep_tpu_torch.ops.scatter import shard_cap, shard_live_cap
    for pool, cap, live in ((40, 1024000, 640000), (4, 102400, 64000),
                            (1, 25600, 16000)):
        assert shard_cap(25600 * pool, 2) == cap
        assert shard_live_cap(25600 * pool, 2) == live
