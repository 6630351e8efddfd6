"""The port's scatter plans and kernels against the JAX package's.

* Plan builders: bit-identical arrays for skewed ids, weight-0 padding,
  empty tiles and ok=0 windows.
* Plain K1 / K2 (the kernels' CPU path) against the Pallas kernels in
  interpret mode on the same plan arrays: float32 within 1e-5 (sums in
  another order); bfloat16 within one bf16 ulp of the float64 sum (both
  round float32 sums; the TPU kernel rounds once per tile it touches).
* Plain K3 against rowdma_scatter_rows(interpret=True): exact.
The CUDA kernels against their plain versions: tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import wide_deep_tpu.ops.scatter as jsc  # noqa: E402
import wide_deep_tpu_torch.ops.scatter as tsc  # noqa: E402
from wide_deep_tpu.ops.rowdma import rowdma_scatter_rows as j_rowdma  # noqa: E402
from wide_deep_tpu_torch.ops import rowdma as trowdma  # noqa: E402
from test_torch_cuda import (BF16_ULP, CASES, _ids, _range_case,  # noqa: E402
                             _weights)

@pytest.mark.parametrize("kind,n,rows", CASES)
@pytest.mark.parametrize("with_weights", [False, True])
def test_plan_builders_bit_identical(kind, n, rows, with_weights):
    rng = np.random.default_rng(hash(kind) % 1000)
    ids = _ids(kind, n, rows, rng)
    w = _weights(n, rng) if with_weights else None
    for name in ("make_scatter_plan", "make_window_plan"):
        jp = getattr(jsc, name)(ids, rows, w)
        tp = getattr(tsc, name)(ids, rows, w)
        assert sorted(jp) == sorted(tp)
        for k in jp:
            assert jp[k].dtype == tp[k].dtype, (name, k)
            np.testing.assert_array_equal(jp[k], tp[k], err_msg=f"{name} {k}")
    jc, tc = jsc.make_compact_plan(ids, rows), tsc.make_compact_plan(ids, rows)
    for k in jc:
        np.testing.assert_array_equal(jc[k], tc[k], err_msg=f"compact {k}")
    for fn in ("n_tiles_for", "window_cap", "live_cap"):
        args = (n,) if fn == "live_cap" else (n, rows)
        assert getattr(jsc, fn)(*args) == getattr(tsc, fn)(*args), fn
    for fn in ("scatter_batch_spec", "window_batch_spec"):
        assert getattr(jsc, fn)(n, rows) == getattr(tsc, fn)(n, rows), fn
    assert jsc.compact_plan_spec(n) == tsc.compact_plan_spec(n)
    if kind == "hot_window":
        assert tsc.make_window_plan(ids, rows, w)["ok"][0] == 0
    if kind == "clustered":
        tiles = tsc.make_scatter_plan(ids, rows, w)["tiles"]
        assert (tiles[2] == 0).any()   # empty (padding) tiles present


def _jax_array(t):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _check_bf16(out, ref):
    """Within one bf16 ulp of the float64 sum (relative 2^-7 of the
    value's magnitude, plus float32 round-off of the sum)."""
    out = np.asarray(out, np.float64)
    tol = BF16_ULP * np.abs(ref) + 1e-5
    assert np.all(np.abs(out - ref) <= tol), float(np.max(np.abs(out - ref)))


def _check_pallas_bf16(jout, ref, abs_sum, ids, tiles):
    """The TPU kernel adds each tile's float32 partial into a bfloat16
    slab, so a row that k tiles touch is rounded k times: within k bf16
    ulps of the sum of |g| (k = 1 for windows)."""
    k = np.ones(ref.shape[0])
    if tiles is not None:
        k[:] = 0
        for s, o, c in zip(tiles[0], tiles[1], tiles[2]):
            if c:
                k[np.unique(ids[s + o:s + o + c])] += 1
        k = np.maximum(k, 1)
    tol = BF16_ULP * k[:, None] * abs_sum + 1e-5
    err = np.abs(np.asarray(jout, np.float64) - ref)
    assert np.all(err <= tol), float(np.max(err - tol))


@pytest.mark.parametrize("kind,n,rows", CASES[:3])
@pytest.mark.parametrize("d,dtype", [(9, torch.bfloat16), (5, torch.bfloat16),
                                     (32, torch.float32),
                                     (17, torch.float32)])
def test_plain_range_matches_pallas(kind, n, rows, d, dtype):
    plan, g, ref, abs_sum = _range_case(kind, n, rows, d, dtype, seed=d)
    tp = {k: torch.from_numpy(v) for k, v in plan.items()}
    out = tsc.range_scatter_add(tp["ids"], tp["perm"], g, tp["tiles"], rows)
    assert out.dtype == dtype and out.shape == (rows, d)
    g_sorted = jnp.take(_jax_array(g), jnp.asarray(plan["perm"]), axis=0)
    t = plan["tiles"]
    jout = jsc.range_scatter_add(jnp.asarray(plan["ids"]), g_sorted,
                                 *(jnp.asarray(t[i]) for i in range(4)),
                                 rows, interpret=True)
    jout = np.asarray(jout.astype(jnp.float32))
    if dtype == torch.float32:
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out.numpy(), jout, rtol=1e-5, atol=1e-5)
    else:
        _check_bf16(out.float().numpy(), ref)
        _check_pallas_bf16(jout, ref, abs_sum, plan["ids"], plan["tiles"])


@pytest.mark.parametrize("kind,n,rows", [CASES[0], ("two_ranges", 200, 31000)])
@pytest.mark.parametrize("d,dtype", [(17, torch.bfloat16),
                                     (8, torch.float32)])
def test_plain_window_matches_pallas(kind, n, rows, d, dtype):
    rng = np.random.default_rng(d)
    ids = _ids(kind, n, rows, rng)
    plan = tsc.make_window_plan(ids, rows, _weights(n, rng))
    assert plan["ok"][0] == 1
    if kind == "two_ranges":
        assert (plan["tiles"][2] == 0).any()   # empty windows written as 0
    g = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(dtype)
    keep = plan["ids"] < rows
    g64 = g.double().numpy()[plan["perm"][keep]]
    ref = np.zeros((rows, d), np.float64)
    np.add.at(ref, plan["ids"][keep], g64)
    abs_sum = np.zeros((rows, d), np.float64)
    np.add.at(abs_sum, plan["ids"][keep], np.abs(g64))
    tp = {k: torch.from_numpy(v) for k, v in plan.items()}
    wcap = tsc.window_cap(n, rows)
    out = tsc.window_scatter_add(tp["ids"], tp["perm"], g, tp["tiles"], rows,
                                 wcap)
    via_plan = tsc.apply_window_plan(tp, g, rows)
    assert torch.equal(out, via_plan)
    g_sorted = jnp.take(_jax_array(g), jnp.asarray(plan["perm"]), axis=0)
    t = plan["tiles"]
    jout = np.asarray(jsc.window_scatter_add(
        jnp.asarray(plan["ids"]), g_sorted, jnp.asarray(t[0]),
        jnp.asarray(t[1]), jnp.asarray(t[2]), rows, wcap,
        interpret=True).astype(jnp.float32))
    if dtype == torch.float32:
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out.numpy(), jout, rtol=1e-5, atol=1e-5)
    else:
        _check_bf16(out.float().numpy(), ref)
        _check_pallas_bf16(jout, ref, abs_sum, None, None)


def test_window_plan_ok0_takes_plain_sum():
    """ok=0 is the plan's own contract: the plain sum in the output dtype,
    matching the JAX package's fallback branch."""
    rng = np.random.default_rng(3)
    n, rows, d = 3000, 30000, 8
    ids = _ids("hot_window", n, rows, rng)
    plan = tsc.make_window_plan(ids, rows)
    assert plan["ok"][0] == 0
    g = rng.normal(size=(n, d)).astype(np.float32)
    out = tsc.apply_window_plan({k: torch.from_numpy(v)
                                 for k, v in plan.items()},
                                torch.from_numpy(g), rows)
    jout = jsc.apply_window_plan({k: jnp.asarray(v) for k, v in plan.items()},
                                 jnp.asarray(g), rows, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)


def test_compact_sum_matches_pallas():
    """The fused optimizer's K1 call: compact ranks, float32."""
    rng = np.random.default_rng(4)
    n, d = 3000, 32
    ids = (rng.zipf(1.5, n) % 700).astype(np.int32)
    cp = tsc.make_compact_plan(ids, 1 << 22)
    g = rng.normal(size=(n, d)).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in cp.items()}
    out = tsc.range_scatter_add(tp["ids"], tp["perm"], torch.from_numpy(g),
                                tp["tiles"], n, torch.float32)
    t = cp["tiles"]
    jout = jsc.range_scatter_add(
        jnp.asarray(cp["ids"]), jnp.take(jnp.asarray(g),
                                         jnp.asarray(cp["perm"]), axis=0),
        *(jnp.asarray(t[i]) for i in range(4)), n,
        out_dtype=jnp.float32, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)


def test_plain_rowdma_matches_jax_exactly():
    rng = np.random.default_rng(5)
    R, n = 5000, 700
    uids = np.sort(rng.choice(R, 600, replace=False)).astype(np.int32)
    uids = np.concatenate([uids, R + np.arange(n - 600)]).astype(np.int32)
    table = rng.normal(size=(R, 128)).astype(np.float32)
    rows = rng.normal(size=(n, 128)).astype(np.float32)
    out = trowdma.rowdma_scatter_rows(torch.from_numpy(table.copy()),
                                      torch.from_numpy(uids),
                                      torch.from_numpy(rows))
    jout = j_rowdma(jnp.asarray(table), jnp.asarray(uids), jnp.asarray(rows),
                    interpret=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "tiles",
                                 "out_dtype", "device"])
def test_range_wrapper_rejects_bad_inputs(bad):
    n, d, rows = 64, 4, 300
    ids = torch.zeros(n, dtype=torch.int32)
    perm = torch.arange(n, dtype=torch.int32)
    g = torch.zeros((n, d))
    tiles = torch.zeros((4, 3), dtype=torch.int32)
    out_dtype = None
    if bad == "dtype":
        ids = ids.long()
    elif bad == "shape":
        perm = perm[:-1]
    elif bad == "contiguity":
        g = torch.zeros((d, n)).t()
    elif bad == "tiles":
        tiles = tiles[:3]
    elif bad == "out_dtype":
        out_dtype = torch.float16
    else:   # neither the CPU (plain) nor a CUDA device: raise, no fallback
        ids, perm, g, tiles = (x.to("meta") for x in (ids, perm, g, tiles))
    with pytest.raises(ValueError):
        tsc.range_scatter_add(ids, perm, g, tiles, rows, out_dtype)


@pytest.mark.parametrize("bad", ["width", "dtype", "uids"])
def test_rowdma_wrapper_rejects_bad_inputs(bad):
    table = torch.zeros((10, 128))
    rows = torch.zeros((4, 128))
    uids = torch.arange(4, dtype=torch.int32)
    if bad == "width":
        table = torch.zeros((10, 64))
    elif bad == "dtype":
        rows = rows.double()
    else:
        uids = uids.long()
    with pytest.raises(ValueError):
        trowdma.rowdma_scatter_rows(table, uids, rows)
