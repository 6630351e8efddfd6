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

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import wide_deep_tpu.ops.scatter as jsc  # noqa: E402
import wide_deep_tpu_torch.ops.scatter as tsc  # noqa: E402
from wide_deep_tpu.ops.rowdma import rowdma_scatter_rows as j_rowdma  # noqa: E402
from wide_deep_tpu_torch.ops import rowdma as trowdma  # noqa: E402
from test_torch_cuda import (BF16_ULP, CASES, _ids, _k1_case,  # noqa: E402
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
    plan, rows, g, ref, abs_sum = _k1_case(kind, n, rows, d, dtype, seed=d)
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


@pytest.mark.parametrize("kind,n,rows", [("repeated", 3000, 300),
                                         ("sentinels", 3000, 900)])
@pytest.mark.parametrize("d,dtype", [(9, torch.bfloat16), (32, torch.float32)])
def test_plain_range_edge_streams_match_pallas(kind, n, rows, d, dtype):
    """K1's edge streams (tests/test_torch_cuda.py runs the kernel on them):
    one run over 2/3 of the stream, 70% weight-0 sentinels.  Float32 round-off grows with the magnitudes a long run sums, so
    the tolerances are relative to each row's sum of magnitudes."""
    plan, rows, g, ref, abs_sum = _k1_case(kind, n, rows, d, dtype, seed=d)
    tp = {k: torch.from_numpy(v) for k, v in plan.items()}
    out = tsc.range_scatter_add(tp["ids"], tp["perm"], g, tp["tiles"], rows)
    assert out.dtype == dtype and out.shape == (rows, d)
    g_sorted = jnp.take(_jax_array(g), jnp.asarray(plan["perm"]), axis=0)
    t = plan["tiles"]
    jout = np.asarray(jsc.range_scatter_add(
        jnp.asarray(plan["ids"]), g_sorted,
        *(jnp.asarray(t[i]) for i in range(4)), rows,
        interpret=True).astype(jnp.float32))
    err = np.abs(out.double().numpy() - ref)
    if dtype == torch.float32:
        assert (err <= 1e-6 * abs_sum + 1e-6).all()
        assert (np.abs(jout - ref) <= 1e-6 * abs_sum + 1e-6).all()
    else:
        assert (err <= BF16_ULP * np.abs(ref) + 1e-6 * abs_sum + 1e-5).all()
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


def _ok0_case(d, dtype, seed=3):
    """A hot_window stream whose window plan overflows (ok=0) -> (plan, g,
    float64 sum, float64 sum of magnitudes, live ids per row)."""
    rng = np.random.default_rng(seed)
    n, rows = 3000, 30000
    ids = _ids("hot_window", n, rows, rng)
    plan = tsc.make_window_plan(ids, rows)
    assert plan["ok"][0] == 0
    g = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(dtype)
    g64 = g.double().numpy()[plan["perm"]]
    ref = np.zeros((rows, d), np.float64)
    np.add.at(ref, plan["ids"], g64)
    abs_sum = np.zeros((rows, d), np.float64)
    np.add.at(abs_sum, plan["ids"], np.abs(g64))
    return plan, g, ref, abs_sum, np.bincount(plan["ids"], minlength=rows)


@pytest.mark.parametrize("d", [8, 17])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_plan_ok0_takes_plain_sum(d, dtype):
    """ok=0 is summed by K1's function over the plan's sorted stream (its
    plain version here): float32 summed, rounded once.  float32: within
    1e-5 of the JAX package's fallback branch.  bfloat16: within one bf16
    ulp of the float64 sum (K1's tolerance), and the JAX fallback, which
    accumulates in bfloat16 and so rounds once per add, within k bf16 ulps
    of each row's sum of magnitudes, k the row's count of ids."""
    plan, g, ref, abs_sum, per_row = _ok0_case(d, dtype)
    rows = ref.shape[0]
    out = tsc.apply_window_plan({k: torch.from_numpy(v)
                                 for k, v in plan.items()}, g, rows)
    assert out.dtype == dtype and out.shape == (rows, d)
    jout = jsc.apply_window_plan({k: jnp.asarray(v) for k, v in plan.items()},
                                 _jax_array(g), rows, interpret=True)
    jout = np.asarray(jout.astype(jnp.float32), np.float64)
    if dtype == torch.float32:
        np.testing.assert_allclose(out.numpy(), jout, rtol=1e-5, atol=1e-5)
    else:
        _check_bf16(out.float().numpy(), ref)
        tol = BF16_ULP * np.maximum(per_row, 1)[:, None] * abs_sum + 1e-5
        assert np.all(np.abs(jout - ref) <= tol)


def test_window_plan_ok0_goes_through_k1(monkeypatch):
    """The ok=0 branch calls K1's tile-free entry (a float32 sum rounded
    once), so its bits are K1's plain version's."""
    plan, g, ref, _, _ = _ok0_case(17, torch.bfloat16)
    calls = []
    k1 = tsc.sorted_stream_sum

    def spy_k1(*args):
        calls.append(args[3:])
        return k1(*args)

    monkeypatch.setattr(tsc, "sorted_stream_sum", spy_k1)
    tp = {k: torch.from_numpy(v) for k, v in plan.items()}
    rows = ref.shape[0]
    out = tsc.apply_window_plan(tp, g, rows)
    assert calls == [(rows, torch.bfloat16)]
    want = tsc.range_scatter_add_plain(tp["ids"], tp["perm"], g, rows)
    assert torch.equal(out.view(torch.int16), want.view(torch.int16))


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


@pytest.mark.parametrize("n,d,floats", [
    (0, 9, 0), (1, 9, 20), (32, 9, 20), (33, 9, (2 + 1) * 20),
    (25600, 32, (800 + 50 + 4 + 1) * 66),
    (1024000, 9, (32000 + 2000 + 125 + 8 + 1) * 20)])
def test_range_scratch_counts_chunks(n, d, floats):
    """K1's scratch: per chunk of the chunk pass (32 stream positions) and
    of each carry level (32 slots), two int keys and two float32 partial
    rows (tests/test_torch_cuda.py holds it against the kernel's own
    count)."""
    assert tsc.range_scratch_floats(n, d) == floats


@pytest.mark.parametrize("n,chunks", [
    (0, []), (1, [1]), (32, [1]), (33, [2, 1]), (32 ** 2, [32, 2, 1]),
    (32 ** 2 + 1, [33, 3, 1]),
    (7577600, [236800, 14800, 925, 58, 4, 1])])
def test_range_carry_levels_at_the_edges(n, chunks):
    """K1's passes over n stream positions: the chunk pass, then a carry
    level over the pass before's 2 slots a chunk while that pass had more
    than one chunk.  The host's level count and scratch follow from n and
    the kernel's chunk, which is the source's own (tests/test_torch_cuda.py
    holds both counts against the kernel's)."""
    src = os.path.join(os.path.dirname(tsc.__file__), os.pardir, "csrc",
                       "range_scatter.cu")
    with open(src) as f:
        k_chunk = re.search(r"constexpr int kChunk = (\d+);", f.read())
    assert int(k_chunk.group(1)) == tsc.RANGE_CHUNK == 32
    assert tsc.range_carry_levels(n) == max(len(chunks) - 1, 0)
    for d in (1, 8, 9):
        assert tsc.range_scratch_floats(n, d) == sum(chunks) * (2 + 2 * d)


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


@pytest.mark.parametrize("d,dtype,sub", [
    (5, torch.bfloat16, 2048), (9, torch.bfloat16, 1024),
    (17, torch.bfloat16, 512), (33, torch.bfloat16, 256),
    (5, torch.float32, 1024), (17, torch.float32, 256),
    (33, torch.float32, 128), (1024, torch.bfloat16, 16),
    (512, torch.float32, 16)])
def test_window_sub_rows_fit_the_slab(d, dtype, sub):
    """K2's sub-window: the largest power of two <= MAXR rows whose slab
    fits WINDOW_SLAB_BYTES (tests/test_torch_cuda.py holds it against the
    kernel's own choice)."""
    assert tsc.window_sub_rows(d, dtype) == sub


@pytest.mark.parametrize("bad", ["wide_bf16", "wide_f32", "wcap", "windows",
                                 "device"])
def test_window_wrapper_rejects_bad_inputs(bad):
    """Rows wider than K2's narrowest slab, a cap above T_IDS, too few
    windows and a device that is neither the CPU nor CUDA raise ValueError
    on any device; the CPU path still takes the plain version."""
    n, d, rows = 64, 4, 3000
    ids = torch.zeros(n, dtype=torch.int32)
    perm = torch.arange(n, dtype=torch.int32)
    g = torch.zeros((n, d))
    tiles = torch.zeros((3, 2), dtype=torch.int32)
    wcap, out_dtype = tsc.ALIGN_IDS, None
    assert tsc.window_scatter_add(ids, perm, g, tiles, rows, wcap).shape == (
        rows, d)
    if bad == "wide_bf16":
        g, out_dtype = torch.zeros((n, 1025)), torch.bfloat16
    elif bad == "wide_f32":
        g = torch.zeros((n, 513))
    elif bad == "wcap":
        wcap = tsc.T_IDS + 1
    elif bad == "windows":
        rows = 2 * tsc.MAXR + 1
    else:
        ids, perm, g, tiles = (x.to("meta") for x in (ids, perm, g, tiles))
    with pytest.raises(ValueError):
        tsc.window_scatter_add(ids, perm, g, tiles, rows, wcap, out_dtype)
