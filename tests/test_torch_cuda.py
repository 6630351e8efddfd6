"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device (marker ``cuda``) and skips without
one; the file imports no JAX, so it runs on a machine with only PyTorch:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Tolerances: bfloat16 outputs within one bf16 ulp (both versions round a
float32 sum once); float32 outputs, kernel and plain version alike, within
1e-6 of each row's sum of magnitudes from the float64 sum of the same
inputs (float32 round-off grows with the magnitudes summed, not with what
is left after they cancel, and the plain version's atomic adds on the card
sum in a different order on every call); K1 and K2 bitwise equal to
themselves from call to call; K3, P1 and P2 exact.
The case generators are shared with tests/test_torch_scatter.py and
tests/test_torch_probes.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import wide_deep_tpu_torch.ops.scatter as tsc  # noqa: E402
from wide_deep_tpu_torch.ops import gather as tgather  # noqa: E402
from wide_deep_tpu_torch.ops import rowdma as trowdma  # noqa: E402

BF16_ULP = 2.0 ** -7


def _ids(kind, n, rows, rng):
    if kind == "uniform":
        return rng.integers(0, rows, n).astype(np.int32)
    if kind == "skewed":      # zipf: long runs of one id, like hot features
        return (rng.zipf(1.3, n) % rows).astype(np.int32)
    if kind == "clustered":   # dense ids in a few row ranges -> empty tiles
        return (rng.integers(0, 300, n) + rng.choice([0, 9000], n)
                ).astype(np.int32)
    if kind == "two_ranges":  # windows between the ranges stay empty
        return (rng.integers(0, 1000, n) + rng.choice([0, 30000], n)
                ).astype(np.int32)
    if kind == "hot_window":  # one window far over its cap -> ok=0
        return np.where(rng.random(n) < 0.7, rng.integers(0, 50, n),
                        rng.integers(0, rows, n)).astype(np.int32)
    raise ValueError(kind)


CASES = [("uniform", 3000, 20000), ("skewed", 4000, 5000),
         ("clustered", 2500, 12000), ("hot_window", 3000, 30000)]


def _weights(n, rng):
    w = np.ones(n, np.float32)
    w[rng.random(n) < 0.2] = 0.0   # pool padding
    return w


def _k1_case(kind, n, rows, d, dtype, seed):
    """-> (stream arrays {ids, perm, tiles}, output rows, g, float64 sum,
    float64 sum of magnitudes) for one of RANGE_CASES."""
    rng = np.random.default_rng(seed)
    if kind in ("uniform", "skewed", "clustered"):
        plan = tsc.make_scatter_plan(_ids(kind, n, rows, rng), rows,
                                     _weights(n, rng))
    elif kind == "compact":   # the fused optimizer's dedup ranks, all live
        ids = (rng.zipf(1.5, n) % 7000).astype(np.int32)
        plan = tsc.make_compact_plan(ids, 1 << 22)
        rows = n
    else:
        if kind == "repeated":   # one id in 2/3 of the stream: a run over
            hot = 2 * n // 3     # many chunks (20,000 ids: ~625 of them)
            ids = np.concatenate([np.full(hot, rows // 4),
                                  rng.integers(0, rows, n - hot)])
            ids = rng.permutation(ids).astype(np.int32)
            w = None
        else:                    # "sentinels": 70% weight-0 padding
            ids = rng.integers(0, rows, n).astype(np.int32)
            w = (rng.random(n) < 0.3).astype(np.float32)
        plan = tsc.make_scatter_plan(ids, rows, w)
    plan = {k: plan[k] for k in ("ids", "perm", "tiles")}
    return (plan, rows) + _grads(plan, n, rows, d, dtype, rng)


# K1 cases: (kind, n, rows); n is far above the kernel's 32-position chunk
RANGE_CASES = [("skewed", 20000, 5000), ("uniform", 20000, 30000),
               ("clustered", 20000, 12000), ("repeated", 30000, 5000),
               ("sentinels", 20000, 8000), ("compact", 20000, None)]


# K2 cases: odd rows, so with an odd D the last, partial sub-window's byte
# length is never a multiple of 16
WINDOW_CASES = [("uniform", 6000, 40001), ("skewed", 1000, 5001),
                ("two_ranges", 200, 31001), ("full_window", 2048, 4097)]


def _window_case(kind, n, rows, d, dtype, seed):
    rng = np.random.default_rng(seed)
    if kind == "full_window":   # window 0 holds exactly T_IDS ids
        ids = np.concatenate([rng.integers(0, tsc.MAXR, tsc.T_IDS),
                              rng.integers(tsc.MAXR, rows, n - tsc.T_IDS)])
        plan = tsc.make_window_plan(rng.permutation(ids).astype(np.int32),
                                    rows)
        assert plan["tiles"][2, 0] == tsc.T_IDS
    else:
        plan = tsc.make_window_plan(_ids(kind, n, rows, rng), rows,
                                    _weights(n, rng))
    assert plan["ok"][0] == 1
    return (plan,) + _grads(plan, n, rows, d, dtype, rng)


def _grads(plan, n, rows, d, dtype, rng):
    """-> (g as ``dtype``, float64 sum, float64 sum of magnitudes)."""
    g = rng.normal(size=(n, d)).astype(np.float32)
    g_t = torch.from_numpy(g).to(dtype)
    g64 = g_t.double().numpy()          # the grads as the kernels see them
    keep = plan["ids"] < rows
    ref = np.zeros((rows, d), np.float64)
    np.add.at(ref, plan["ids"][keep], g64[plan["perm"][keep]])
    abs_sum = np.zeros((rows, d), np.float64)
    np.add.at(abs_sum, plan["ids"][keep], np.abs(g64[plan["perm"][keep]]))
    return g_t, ref, abs_sum


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _check_k1(out, want, ref, abs_sum):
    """bfloat16: within one bf16 ulp of the plain version and of the float64
    sum (plus float32 round-off); float32: kernel and plain version within
    1e-6 of each row's sum of magnitudes from the float64 sum."""
    got = out.double().cpu().numpy()
    if out.dtype == torch.bfloat16:
        tol = BF16_ULP * want.float().abs() + 1e-5
        assert bool(((out.float() - want.float()).abs() <= tol).all())
        err = np.abs(got - ref)
        assert (err <= BF16_ULP * np.abs(ref) + 1e-6 * abs_sum + 1e-5).all()
    else:
        tol = 1e-6 * abs_sum + 1e-6
        for x in (got, want.double().cpu().numpy()):
            err = np.abs(x - ref)
            assert (err <= tol).all(), float((err / (abs_sum + 1e-30)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [5, 9, 32, 33])
@pytest.mark.parametrize("kind,n,rows", RANGE_CASES)
def test_cuda_range_kernel_matches_plain(cuda_device, kind, n, rows, d,
                                         dtype):
    """K1 on streams whose runs cross chunk edges (skewed; one id 20,000
    times), leave rows untouched (uniform, clustered), end in a long tail
    of sentinels, or come from a compact plan; g and out in ``dtype``.  Two
    calls give the same bits and add one launch each."""
    plan, rows, g, ref, abs_sum = _k1_case(kind, n, rows, d, dtype, seed=1)
    tp = {k: torch.from_numpy(v).to(cuda_device) for k, v in plan.items()}
    g = g.to(cuda_device)
    before = tsc.range_launches
    before_d = tsc.range_launches_by_width().get(d, 0)
    out = tsc.range_scatter_add(tp["ids"], tp["perm"], g, tp["tiles"], rows)
    again = tsc.range_scatter_add(tp["ids"], tp["perm"], g, tp["tiles"],
                                  rows)
    want = tsc.range_scatter_add_plain(tp["ids"], tp["perm"], g, rows)
    torch.cuda.synchronize()
    assert tsc.range_launches == before + 2
    assert tsc.range_launches_by_width()[d] == before_d + 2
    assert out.dtype == dtype and out.shape == (rows, d)
    assert torch.equal(_bits(out), _bits(again))
    _check_k1(out, want, ref, abs_sum)


@pytest.mark.cuda
@pytest.mark.parametrize("g_dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)])
def test_cuda_range_kernel_takes_every_width(cuda_device, g_dtype,
                                             out_dtype):
    """K1 at every width 1-70 (one, two and three column passes) in each
    pair of gradient and output types."""
    for d in range(1, 71):
        plan, rows, g, ref, abs_sum = _k1_case("skewed", 3000, 400, d,
                                               g_dtype, seed=d)
        tp = {k: torch.from_numpy(v).to(cuda_device) for k, v in plan.items()}
        g = g.to(cuda_device)
        out = tsc.range_scatter_add(tp["ids"], tp["perm"], g, tp["tiles"],
                                    rows, out_dtype)
        want = tsc.range_scatter_add_plain(tp["ids"], tp["perm"], g, rows,
                                           out_dtype)
        assert out.dtype == out_dtype and out.shape == (rows, d)
        _check_k1(out, want, ref, abs_sum)


@pytest.mark.cuda
def test_cuda_range_scratch_matches_the_kernel(cuda_device):
    """The wrapper sizes K1's scratch, and counts its carry levels, as the
    kernel does."""
    for n in (0, 1, 31, 32, 33, 1024, 1025, 25600, 1024000, 7577600):
        assert tsc.kernel_range_carry_levels(n) == \
            tsc.range_carry_levels(n), n
        for d in (1, 5, 9, 32, 33, 64):
            assert tsc.kernel_range_scratch_floats(n, d) == \
                tsc.range_scratch_floats(n, d), (n, d)


def _run_sums(ids, rows_of):
    """The runs of the sorted ``ids`` -> (each run's id, its float64 sum
    of ``rows_of`` [n, d])."""
    starts = np.flatnonzero(np.r_[True, ids[1:] != ids[:-1]])
    return ids[starts], np.add.reduceat(rows_of, starts, axis=0)


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype", [(1, torch.float32), (8, torch.float32),
                                     (9, torch.bfloat16)])
def test_cuda_range_kernel_long_padding_run(cuda_device, d, dtype):
    """K1 on a stream shaped like the FM factors' gather backward at a
    global batch of 102,400 rows: 7,577,600 entries, the pool's padding
    one run of 2,457,600 on row 0 (76,800 chunks), then zipf ids whose hot
    rows run over thousands of chunks; g and out in ``dtype``.  Against the
    plain version and the float64 sum, the same bits twice, and each call
    adds the host's carry levels (5) to ``range_carry_launches``.  The
    entries have mean 0 in float32 and 0.5 in bfloat16, where each
    tolerance holds for the plain version's float32 atomics over 2.4M
    adds: a biased run's running sum grows, and its round-off with it,
    beyond 1e-6 of the magnitudes; an unbiased hot row's sum can cancel to
    near zero, where two orders of the adds round to bf16 values many ulps
    apart."""
    rng = np.random.default_rng(19)
    n, hot, rows = 7577600, 2457600, 200000
    ids = np.sort(np.concatenate([np.zeros(hot, np.int64),
                                  rng.zipf(1.3, n - hot) % rows]))
    ids = ids.astype(np.int32)
    perm = rng.permutation(n).astype(np.int32)
    mean = 0.5 if dtype == torch.bfloat16 else 0.0
    g = torch.from_numpy(rng.normal(mean, 1.0, (n, d)).astype(np.float32)
                         ).to(dtype)
    g64 = g.double().numpy()[perm]
    ref = np.zeros((rows, d))
    abs_sum = np.zeros((rows, d))
    at, sums = _run_sums(ids, g64)
    ref[at] = sums
    abs_sum[at] = _run_sums(ids, np.abs(g64))[1]
    ids_t, perm_t = (torch.from_numpy(x).to(cuda_device) for x in (ids, perm))
    g = g.to(cuda_device)
    levels = tsc.range_carry_levels(n)
    assert levels == 5
    before = tsc.range_carry_launches
    out = tsc.sorted_stream_sum(ids_t, perm_t, g, rows, dtype)
    again = tsc.sorted_stream_sum(ids_t, perm_t, g, rows, dtype)
    want = tsc.range_scatter_add_plain(ids_t, perm_t, g, rows, dtype)
    torch.cuda.synchronize()
    assert tsc.range_carry_launches == before + 2 * levels
    assert out.dtype == dtype and out.shape == (rows, d)
    assert torch.equal(_bits(out), _bits(again))
    _check_k1(out, want, ref, abs_sum)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [5, 9, 17, 33])
@pytest.mark.parametrize("kind,n,rows", WINDOW_CASES)
def test_cuda_window_kernel_matches_plain(cuda_device, kind, n, rows, d,
                                          dtype):
    """K2 at its edges: long runs, empty windows, a window of exactly T_IDS
    ids, a partial last sub-window with a 2-byte tail, every folded width;
    g and out in ``dtype``.  Two calls give the same bits."""
    plan, g, ref, abs_sum = _window_case(kind, n, rows, d, dtype, seed=d)
    es = torch.finfo(dtype).bits // 8
    assert (rows % tsc.window_sub_rows(d, dtype)) * d * es % 16
    tp = {k: torch.from_numpy(v).to(cuda_device) for k, v in plan.items()}
    g = g.to(cuda_device)
    wcap = tsc.window_cap(n, rows)
    before = tsc.window_launches
    out = tsc.window_scatter_add(tp["ids"], tp["perm"], g, tp["tiles"], rows,
                                 wcap)
    again = tsc.window_scatter_add(tp["ids"], tp["perm"], g, tp["tiles"],
                                   rows, wcap)
    want = tsc.window_scatter_add_plain(tp["ids"], tp["perm"], g, rows)
    torch.cuda.synchronize()
    assert tsc.window_launches == before + 2
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(out.view(bits), again.view(bits))
    if dtype == torch.bfloat16:
        tol = BF16_ULP * want.float().abs() + 1e-5
        assert bool(((out.float() - want.float()).abs() <= tol).all())
    else:
        tol = 1e-6 * abs_sum + 1e-6
        for got in (out, want):
            err = np.abs(got.double().cpu().numpy() - ref)
            assert (err <= tol).all(), float((err / (abs_sum + 1e-30)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_window_sub_rows_match_the_kernel(cuda_device, dtype):
    """The wrapper's sub-window and its refusals are the kernel's own, at
    every row width up to past the widest it takes."""
    for d in range(1, 1100):
        try:
            want = tsc.window_sub_rows(d, dtype)
        except ValueError:
            want = 0
        assert tsc.kernel_window_sub_rows(d, dtype) == want, d


@pytest.mark.cuda
def test_cuda_rowdma_kernel_matches_plain(cuda_device):
    table = torch.randn((5000, 128), device=cuda_device)
    uids = torch.cat([torch.randperm(5000, device=cuda_device)[:900].sort()
                      .values, 5000 + torch.arange(100, device=cuda_device)]
                     ).to(torch.int32)
    new = torch.randn((1000, 128), device=cuda_device)
    got = trowdma.rowdma_scatter_rows(table.clone(), uids, new)
    ref = trowdma.rowdma_scatter_rows_plain(table.clone(), uids, new)
    assert torch.equal(got, ref)


def _p1_case(n, b, d, seed):
    """seg with negative and >= b ids mixed in (wrap once, then clamp)."""
    rng = np.random.default_rng(seed)
    seg = rng.integers(-2 * b, 2 * b, n).astype(np.int32)
    seg[:4] = [-1, -b, b, -3 * b]
    return (seg, rng.random(n).astype(np.float32),
            rng.standard_normal((b, d)).astype(np.float32))


def _p2_case(r, n, d, dtype, seed):
    """n sorted unique uids in [0, r) followed by sentinels >= r."""
    rng = np.random.default_rng(seed)
    live = np.sort(rng.choice(r, n, replace=False))
    uids = np.concatenate([live, r + np.arange(20), [2 ** 31 - 1]]
                          ).astype(np.int32)
    rows = torch.from_numpy(rng.standard_normal((uids.size, d)).astype(
        np.float32)).to(dtype)
    table = torch.from_numpy(rng.standard_normal((r, d)).astype(
        np.float32)).to(dtype)
    return uids, rows, table


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 9])
def test_cuda_resident_gather_matches_plain(cuda_device, d):
    seg, w, dpool = (torch.from_numpy(a).to(cuda_device)
                     for a in _p1_case(3000, 512, d, seed=d))
    before = tgather.resident_gather_launches
    got = tgather.resident_gather(seg, w, dpool)
    torch.cuda.synchronize()
    assert tgather.resident_gather_launches == before + 1
    assert torch.equal(got, tgather.resident_gather_plain(seg, w, dpool))


@pytest.mark.cuda
@pytest.mark.parametrize("r,n,d,dtype", [
    (4096, 300, 128, torch.float32), (4096, 300, 64, torch.float32),
    (4096, 300, 128, torch.bfloat16), (10000, 3000, 128, torch.bfloat16),
    (10000, 3000, 8, torch.bfloat16)])
def test_cuda_bulk_scatter_rows_matches_plain(cuda_device, r, n, d, dtype):
    uids, rows, table = _p2_case(r, n, d, dtype, seed=d)
    uids = torch.from_numpy(uids).to(cuda_device)
    rows, table = rows.to(cuda_device), table.to(cuda_device)
    want = trowdma.rowdma_scatter_rows_plain(table.clone(), uids, rows)
    before = trowdma.bulk_scatter_launches
    got = trowdma.bulk_scatter_rows(table, uids, rows)
    torch.cuda.synchronize()
    assert trowdma.bulk_scatter_launches == before + 1
    assert torch.equal(got, want)


def _p2_edge(case, rng):
    """-> (table rows R, D, dtype, sorted uids) of one P2 edge case."""
    if case == "row of 7168 bytes":        # the widest row: 2 a round
        return 3000, 1792, torch.float32, np.sort(rng.choice(3000, 300, False))
    if case == "one uid":
        return 500, 128, torch.float32, np.array([7])
    if case == "n not a multiple of 32":
        return 5000, 128, torch.float32, np.sort(rng.choice(5000, 77, False))
    if case == "a chunk of sentinels":     # chunk 2 (uids 64-95) all >= R,
        return 5000, 128, torch.float32, np.concatenate([  # negatives first
            [-9, -2], np.sort(rng.choice(5000, 62, False)),
            5000 + np.arange(40)])
    if case == "uid R-1":
        return 5000, 64, torch.bfloat16, np.concatenate([
            np.sort(rng.choice(4999, 40, False)), [4999]])
    if case == "bf16 rows of 16 bytes":
        return 5000, 8, torch.bfloat16, np.concatenate([
            np.sort(rng.choice(5000, 100, False)), 5000 + np.arange(3)])
    raise ValueError(case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    "row of 7168 bytes", "one uid", "n not a multiple of 32",
    "a chunk of sentinels", "uid R-1", "bf16 rows of 16 bytes"])
def test_cuda_bulk_scatter_rows_edges(cuda_device, case):
    """P2 at its edges: exact against the plain version, rows outside the
    uids untouched."""
    rng = np.random.default_rng(11)
    r, d, dtype, uids = _p2_edge(case, rng)
    uids = torch.from_numpy(uids.astype(np.int32)).to(cuda_device)
    table = torch.randn((r, d), device=cuda_device).to(dtype)
    rows = torch.randn((uids.shape[0], d), device=cuda_device).to(dtype)
    want = trowdma.rowdma_scatter_rows_plain(table.clone(), uids, rows)
    got = trowdma.bulk_scatter_rows(table, uids, rows)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_bulk_max_row_bytes_matches_the_kernel(cuda_device):
    """The wrapper refuses rows above the widest the kernel takes."""
    assert trowdma.kernel_bulk_max_row_bytes() == trowdma.BULK_MAX_ROW_BYTES


@pytest.mark.cuda
def test_cuda_window_plan_ok0_runs_k1(cuda_device):
    """A window plan with ok=0 (bf16, D=17, the d16 fold's width) is summed
    by K1: two calls give the same bits, each launches K1 once at D=17 and
    counts in window_ok0_launches, and both match K1's plain version within
    one bf16 ulp."""
    rng = np.random.default_rng(3)
    n, rows, d = 3000, 30000, 17
    plan = tsc.make_window_plan(_ids("hot_window", n, rows, rng), rows,
                                _weights(n, rng))
    assert plan["ok"][0] == 0
    g = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(
        torch.bfloat16).to(cuda_device)
    tp = {k: torch.from_numpy(v).to(cuda_device) for k, v in plan.items()
          if k != "ok"}
    tp["ok"] = torch.from_numpy(plan["ok"])          # stays on the host
    before = (tsc.window_ok0_launches, tsc.window_launches,
              tsc.range_launches_by_width().get(d, 0))
    out = tsc.apply_window_plan(tp, g, rows)
    again = tsc.apply_window_plan(tp, g, rows)
    want = tsc.range_scatter_add_plain(tp["ids"], tp["perm"], g, rows)
    torch.cuda.synchronize()
    assert (tsc.window_ok0_launches, tsc.window_launches,
            tsc.range_launches_by_width()[d]) == (
        before[0] + 2, before[1], before[2] + 2)
    assert out.dtype == torch.bfloat16 and out.shape == (rows, d)
    assert torch.equal(_bits(out), _bits(again))
    tol = BF16_ULP * want.float().abs() + 1e-5
    assert bool(((out.float() - want.float()).abs() <= tol).all())


@pytest.mark.cuda
def test_cuda_train_file_is_deterministic(cuda_device, tmp_path,
                                          monkeypatch):
    """Two Trainer.train_file runs over one generated TSV, with bfloat16
    embeddings and window plans on the folded group, give the same losses,
    params and optimizer state bit for bit (the wide table's FTRL n and z
    too: its gather's backward sums repeated ids in one order).  At batch
    384 window 0 of d4 holds more than T_IDS ids, so every step's plan says
    ok=0 and takes K1."""
    import os

    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.features.plan import FeaturePlan
    from wide_deep_tpu_torch.optim import sparse as tsparse
    from wide_deep_tpu_torch.optim import tree_items
    from wide_deep_tpu_torch.testing import (generate_ctr_tsv,
                                             write_small_conf)
    from wide_deep_tpu_torch.training.loop import Trainer

    conf_dir = write_small_conf(str(tmp_path / "conf"))
    path = os.path.join(conf_dir, "model.yaml")
    with open(path) as f:
        text = f.read().replace("embedding_dtype: float32",
                                "embedding_dtype: bfloat16")
    with open(path, "w") as f:
        f.write(text + "\nwide_fold_max_rows: 20000\n")  # d4 folded
    monkeypatch.setattr(tsparse, "SPARSE_MIN_ROWS", 1)
    monkeypatch.setattr(FeaturePlan, "scatter_group", lambda self, g, b: False)
    monkeypatch.setattr(FeaturePlan, "window_group",
                        lambda self, g, b: g.folded)
    batch, steps = 384, 3
    tsv = str(tmp_path / "train.tsv")
    generate_ctr_tsv(Config(conf_dir), tsv, batch * steps, seed=0,
                     hash_spread=None)
    runs = []
    for _ in range(2):
        trainer = Trainer(Config(conf_dir), "wide_deep",
                          model_dir=str(tmp_path), device="cuda",
                          overrides=dict(batch_size=batch, pack_budget=3))
        before = (tsc.window_ok0_launches, tsc.window_launches)
        trainer.train_file(tsv, max_steps=steps)
        torch.cuda.synchronize()
        assert (tsc.window_ok0_launches - before[0],
                tsc.window_launches - before[1]) == (steps, 0)
        runs.append(([float(x) for x in trainer.losses],
                     {(what,) + p: v.detach().cpu()
                      for what in ("params", "opt_state")
                      for p, v in tree_items(getattr(trainer, what))
                      if isinstance(v, torch.Tensor)}))
    (losses_a, params_a), (losses_b, params_b) = runs
    assert len(losses_a) == steps and losses_a == losses_b
    assert sorted(map(str, params_a)) == sorted(map(str, params_b))
    for p, v in params_a.items():
        w = params_b[p]
        assert v.dtype == w.dtype and torch.equal(
            v.reshape(-1).view(torch.uint8), w.reshape(-1).view(torch.uint8)), p


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["range", "window"])
def test_cuda_trainer_matches_cpu(cuda_device, tmp_path, monkeypatch, mode):
    """Three small-config steps on the card (kernels) and on the CPU (plain
    versions) from the same params: losses and params agree to float32
    round-off (TF32 off), and every step launched its kernels."""
    import os

    from paths import TRAIN1
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.features.plan import FeaturePlan
    from wide_deep_tpu_torch.optim import sparse as tsparse
    from wide_deep_tpu_torch.optim import tree_items
    from wide_deep_tpu_torch.testing import write_small_conf
    from wide_deep_tpu_torch.training.loop import Trainer

    conf_dir = write_small_conf(str(tmp_path / "conf"))
    with open(os.path.join(conf_dir, "model.yaml"), "a") as f:
        f.write("\nwide_fold_max_rows: 20000\n")   # d4 folded, d8 sparse
    monkeypatch.setattr(tsparse, "SPARSE_MIN_ROWS", 1)
    monkeypatch.setattr(FeaturePlan, "scatter_group",
                        lambda self, g, b: mode == "range" and g.folded)
    monkeypatch.setattr(FeaturePlan, "window_group",
                        lambda self, g, b: mode == "window" and g.folded)
    over = dict(batch_size=16, pack_budget=3, train_data=TRAIN1)
    cpu = Trainer(Config(conf_dir), "wide_deep", overrides=over,
                  model_dir=str(tmp_path / "cpu"), device="cpu",
                  dtype=torch.float32)
    gpu = Trainer(Config(conf_dir), "wide_deep", overrides=over,
                  model_dir=str(tmp_path / "gpu"), device="cuda",
                  dtype=torch.float32)
    cpu.ensure_initialized()
    gpu.params = {k: _to(v, cuda_device) for k, v in cpu.params.items()}
    gpu.mstate = {k: _to(v, cuda_device) for k, v in cpu.mstate.items()}
    before = (tsc.range_launches, tsc.window_launches,
              trowdma.rowdma_launches)
    cpu.train_file(TRAIN1, max_steps=3)
    gpu.train_file(TRAIN1, max_steps=3)
    torch.cuda.synchronize()
    k1, k2, k3 = (tsc.range_launches - before[0],
                  tsc.window_launches - before[1],
                  trowdma.rowdma_launches - before[2])
    # K1 a step: the d4 fold (range mode), the d8 compact sum, the wide
    # gather's backward
    assert k3 == 3 and k1 == (9 if mode == "range" else 6)
    assert k2 == (0 if mode == "range" else 3)
    np.testing.assert_allclose([float(x) for x in gpu.losses],
                               [float(x) for x in cpu.losses], rtol=1e-4)
    cpu_leaves = dict(tree_items(cpu.params))
    for path, leaf in tree_items(gpu.params):
        np.testing.assert_allclose(leaf.detach().float().cpu().numpy(),
                                   cpu_leaves[path].detach().float().numpy(),
                                   rtol=1e-3, atol=1e-4, err_msg=str(path))


@pytest.mark.cuda
def test_cuda_evaluate_matches_cpu(cuda_device, tmp_path, monkeypatch):
    """Trainer.evaluate and predict on the card against the CPU from the
    same params, over the sample file at the small config: every metric
    within rtol 1e-4 (auc and auc_precision_recall within 1e-4 absolute),
    predictions within rtol 1e-4 / atol 1e-5; no kernel launches."""
    import os

    from paths import TRAIN1
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.optim import sparse as tsparse
    from wide_deep_tpu_torch.testing import write_small_conf
    from wide_deep_tpu_torch.training.loop import Trainer

    conf_dir = write_small_conf(str(tmp_path / "conf"))
    with open(os.path.join(conf_dir, "model.yaml"), "a") as f:
        f.write("\nwide_fold_max_rows: 20000\n")   # d4 folded, d8 sparse
    monkeypatch.setattr(tsparse, "SPARSE_MIN_ROWS", 1)
    over = dict(batch_size=64, pack_budget=3, train_data=TRAIN1)
    cpu = Trainer(Config(conf_dir), "wide_deep", overrides=over,
                  model_dir=str(tmp_path / "cpu"), device="cpu",
                  dtype=torch.float32)
    gpu = Trainer(Config(conf_dir), "wide_deep", overrides=over,
                  model_dir=str(tmp_path / "gpu"), device="cuda",
                  dtype=torch.float32)
    cpu.ensure_initialized()
    gpu.params = {k: _to(v, cuda_device) for k, v in cpu.params.items()}
    gpu.mstate = {k: _to(v, cuda_device) for k, v in cpu.mstate.items()}
    before = (tsc.range_launches, tsc.window_launches,
              trowdma.rowdma_launches)
    got, want = gpu.evaluate(TRAIN1), cpu.evaluate(TRAIN1)
    preds = list(gpu.predict(TRAIN1))
    torch.cuda.synchronize()
    assert (tsc.range_launches, tsc.window_launches,
            trowdma.rowdma_launches) == before
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if k in ("auc", "auc_precision_recall"):
            assert abs(got[k] - v) <= 1e-4, (k, got[k], v)
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-4, err_msg=k)
    cpu_preds = list(cpu.predict(TRAIN1))
    assert len(preds) == len(cpu_preds) == sum(1 for _ in open(TRAIN1))
    for i in range(0, len(preds), 97):
        for k, v in cpu_preds[i].items():
            np.testing.assert_allclose(preds[i][k], v, rtol=1e-4, atol=1e-5,
                                       err_msg=f"row {i} {k}")


@pytest.mark.cuda
def test_cuda_to_device_one_copy_bit_for_bit(cuda_device, tmp_path):
    """_to_device on the card: every key lands bit for bit in its 256-byte
    aligned slice of one device buffer, the ok flags stay on the host, and
    the consumer's stream sees the copy after claim()."""
    import os

    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.testing import synthetic_batch, write_small_conf
    from wide_deep_tpu_torch.training.loop import DeviceBatch, Trainer

    conf_dir = write_small_conf(str(tmp_path / "conf"))
    with open(os.path.join(conf_dir, "model.yaml"), "a") as f:
        f.write("\nwide_fold_max_rows: 20000\n")
    tr = Trainer(Config(conf_dir), "wide_deep", device="cuda",
                 model_dir=str(tmp_path / "m"),
                 overrides=dict(batch_size=512, pack_budget=3))
    batch = synthetic_batch(tr.plan, 512, np.random.default_rng(0))
    batch["wscat_ok_d4"] = np.ones(1, np.int32)
    out = tr._to_device(batch).claim()
    assert isinstance(out, DeviceBatch) and sorted(out) == sorted(batch)
    base = out.buffer.data_ptr()
    for k, v in batch.items():
        t = out[k]
        if "_ok_" in k:
            assert t.device.type == "cpu"
        else:
            assert t.device.type == "cuda"
            assert (t.data_ptr() - base) % 256 == 0 and t.data_ptr() % 256 == 0
            assert t.untyped_storage().data_ptr() == \
                out.buffer.untyped_storage().data_ptr()
        np.testing.assert_array_equal(t.cpu().numpy().view(np.uint8),
                                      v.view(np.uint8), err_msg=k)


@pytest.mark.cuda
def test_cuda_wide_gather_backward_is_deterministic(cuda_device):
    """The wide arm's gather (models/linear.GatherRows): its backward on the
    card runs K1 once over the stably sorted ids and gives the same bits on
    every call for ids repeated thousands of times, within 1e-6 of each
    row's sum of magnitudes of the float64 sum."""
    from wide_deep_tpu_torch.models.linear import GatherRows
    rng = np.random.default_rng(3)
    ids = torch.from_numpy((rng.zipf(1.3, 102400) % 5000).astype(np.int32))
    ct = torch.from_numpy(rng.normal(size=(ids.shape[0], 1)).astype(
        np.float32))
    grads = []
    before = (tsc.range_launches, tsc.range_launches_by_width().get(1, 0))
    for _ in range(3):
        w = torch.zeros((5000, 1), device=cuda_device, requires_grad=True)
        GatherRows.apply(w, ids.to(cuda_device)).backward(ct.to(cuda_device))
        grads.append(w.grad.cpu())
    assert (tsc.range_launches - before[0],
            tsc.range_launches_by_width()[1] - before[1]) == (3, 3)
    assert all(torch.equal(_bits(grads[0]), _bits(g)) for g in grads[1:])
    ref = np.zeros((5000, 1))
    mag = np.zeros((5000, 1))
    np.add.at(ref, ids.numpy(), ct.numpy().astype(np.float64))
    np.add.at(mag, ids.numpy(), np.abs(ct.numpy().astype(np.float64)))
    assert np.all(np.abs(grads[0].numpy() - ref) <= 1e-6 * mag + 1e-7)


def _small_trainer(tmp_path, monkeypatch, model_dir, data, dropout=0.5):
    """A small-config Trainer on the card with d4 folded under a range
    plan and d8 under the fused sparse optimizer (K1, K3 each step), and
    dropout on: its masks come from the Trainer's CUDA generator."""
    import os

    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.features.plan import FeaturePlan
    from wide_deep_tpu_torch.optim import sparse as tsparse
    from wide_deep_tpu_torch.testing import write_small_conf
    from wide_deep_tpu_torch.training.loop import Trainer
    conf_dir = str(tmp_path / "conf")
    if not os.path.isdir(conf_dir):
        write_small_conf(conf_dir)
        path = os.path.join(conf_dir, "model.yaml")
        with open(path) as f:
            text = f.read().replace("dnn_dropout:",
                                    f"dnn_dropout: {dropout}")
        with open(path, "w") as f:
            f.write(text + "\nwide_fold_max_rows: 20000\n")
    monkeypatch.setattr(tsparse, "SPARSE_MIN_ROWS", 1)
    monkeypatch.setattr(FeaturePlan, "scatter_group",
                        lambda self, g, b: g.folded)
    monkeypatch.setattr(FeaturePlan, "window_group", lambda self, g, b: False)
    return Trainer(Config(conf_dir), "wide_deep", device="cuda",
                   model_dir=str(tmp_path / model_dir),
                   overrides=dict(batch_size=16, pack_budget=3,
                                  train_data=data, keep_train=True))


def _assert_same_state(a, b):
    """params, BN state and optimizer state bit for bit, counts and the
    step equal."""
    from wide_deep_tpu_torch.optim import tree_items
    for what in ("params", "mstate", "opt_state"):
        la = dict(tree_items(getattr(a, what)))
        lb = dict(tree_items(getattr(b, what)))
        assert sorted(map(str, la)) == sorted(map(str, lb)), what
        for path, va in la.items():
            vb = lb[path]
            if isinstance(va, torch.Tensor):
                assert va.dtype == vb.dtype and va.device == vb.device
                assert torch.equal(va.detach().reshape(-1).view(torch.uint8),
                                   vb.detach().reshape(-1).view(torch.uint8)
                                   ), (what, path)
            else:
                assert va == vb, (what, path)
    assert a.global_step == b.global_step


@pytest.mark.cuda
def test_cuda_checkpoint_round_trip(cuda_device, tmp_path, monkeypatch):
    """Two steps on the card, save; a new Trainer on the card restores
    every leaf bit for bit, the counts, the step and the CUDA generator's
    state; the fused d8 table is 16 of its 128 columns on disk and its
    padding is zero after restore."""
    from paths import TRAIN1
    from wide_deep_tpu_torch.training.checkpoint import inspect_checkpoint
    a = _small_trainer(tmp_path, monkeypatch, "m", TRAIN1)
    a.train_file(TRAIN1, max_steps=2)
    a.save()
    assert inspect_checkpoint(a.model_dir)["params/dnn/embed/d8"].shape \
        == (123136, 16)
    b = _small_trainer(tmp_path, monkeypatch, "m", TRAIN1)
    b.ensure_initialized()
    torch.cuda.synchronize()
    _assert_same_state(a, b)
    assert torch.equal(a._gen.get_state(), b._gen.get_state())
    live = b.params["dnn"]["embed"]["d8"]
    assert live.device.type == "cuda" and live.shape[1] == 128
    assert not live[:, 16:].any()


@pytest.mark.cuda
def test_cuda_resume_is_bit_exact(cuda_device, tmp_path, monkeypatch):
    """On the card: 2 steps, save, a new Trainer restores, 1 more step ==
    3 steps in one Trainer, losses and state bit for bit (dropout on), and
    every step launched K1 three times (d4 fold, d8 compact, the wide
    gather's backward) and K3 once."""
    from paths import TRAIN1
    whole = _small_trainer(tmp_path, monkeypatch, "whole", TRAIN1)
    batches = []
    for b in whole._dataset(TRAIN1, "train"):
        batches.append(b)
        if len(batches) == 3:
            break
    before = (tsc.range_launches, trowdma.rowdma_launches)
    for b in batches:
        whole.train_batch(b)
    first = _small_trainer(tmp_path, monkeypatch, "resumed", TRAIN1)
    for b in batches[:2]:
        first.train_batch(b)
    first.save()
    second = _small_trainer(tmp_path, monkeypatch, "resumed", TRAIN1)
    second.ensure_initialized()
    assert second.global_step == 2
    second.train_batch(batches[2])
    torch.cuda.synchronize()
    assert (tsc.range_launches - before[0],
            trowdma.rowdma_launches - before[1]) == (3 * 6, 6)
    assert float(list(second.losses)[-1]) == float(list(whole.losses)[-1])
    _assert_same_state(whole, second)
    assert torch.equal(whole._gen.get_state(), second._gen.get_state())


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.detach().clone().to(device)


def _launches():
    return (tsc.range_launches, tsc.window_launches, tsc.window_ok0_launches,
            trowdma.rowdma_launches, trowdma.bulk_scatter_launches,
            tgather.resident_gather_launches)


@pytest.fixture
def card_bundle(cuda_device, tmp_path, monkeypatch):
    """Two steps of the small Trainer on the card (d8 under the fused
    sparse optimizer), saved and exported -> (trainer, version dir)."""
    import os

    from paths import TRAIN1
    from wide_deep_tpu_torch.serving.export import export_savedmodel
    tr = _small_trainer(tmp_path, monkeypatch, "m", TRAIN1)
    tr.train_file(TRAIN1, max_steps=2)
    tr.save()
    path = export_savedmodel(tr.config, str(tmp_path / "export"),
                             model_type="wide_deep",
                             model_dir=os.path.dirname(tr.model_dir))
    return tr, path


@pytest.mark.cuda
def test_cuda_serving_bundle_round_trip(card_bundle):
    """The bundle of a Trainer trained on the card loads onto the card
    leaf for leaf as it loads on the host, bit for bit; the fused d8 table
    is its [rows, 8] embedding block, the live table's first 8 columns."""
    from wide_deep_tpu_torch.serving.export import load_bundle
    tr, path = card_bundle
    _, params, mstate, meta = load_bundle(path, device="cuda")
    _, hparams, hmstate, _ = load_bundle(path, device="cpu")
    assert meta["global_step"] == 2
    from wide_deep_tpu_torch.optim import tree_items
    on_card = dict(tree_items({"p": params, "m": mstate}))
    on_host = dict(tree_items({"p": hparams, "m": hmstate}))
    assert sorted(map(str, on_card)) == sorted(map(str, on_host))
    for k, v in on_card.items():
        assert v.device.type == "cuda"
        assert torch.equal(v.cpu().reshape(-1).view(torch.uint8),
                           on_host[k].reshape(-1).view(torch.uint8)), k
    d8 = params["dnn"]["embed"]["d8"]
    live = tr.params["dnn"]["embed"]["d8"]
    assert live.shape[1] == 128 and d8.shape == (live.shape[0], 8)
    assert torch.equal(d8, live[:, :8].to(d8.dtype))


@pytest.mark.cuda
def test_cuda_served_scores_are_predict_step_without_kernels(card_bundle):
    """Scores served from the card equal predict_step on the same
    transformed bucket bit for bit; 8 concurrent requests, coalesced into
    buckets of other sizes, within rtol 1e-6 of them (cuBLAS picks its
    kernel by shape); the TCP endpoint returns them; serving launches none
    of the port's kernels."""
    import concurrent.futures as futures

    from paths import PRED1
    from wide_deep_tpu_torch.serving.client import TcpPredictorClient
    from wide_deep_tpu_torch.serving.server import (PredictorServer,
                                                    ServingModel)
    from wide_deep_tpu_torch.training.loop import to_device
    from wide_deep_tpu_torch.training.step import predict_step
    _, path = card_bundle
    with open(PRED1) as f:
        rows = [line.rstrip("\n") for line in f if line.strip()][:100]
    m = ServingModel(path, 128, batch_timeout_micros=20_000, device="cuda")
    srv = PredictorServer(m, port=None, tcp_port=0)
    srv.start()
    try:
        m.warmup()
        before = _launches()
        got = m.score_rows(rows)
        stream = torch.cuda.Stream()
        with torch.inference_mode():
            want = predict_step(m.model, m.params, m.mstate, to_device(
                m.transform(rows, 128), m.device, stream).claim())
        np.testing.assert_array_equal(np.asarray(got["scores"], np.float32),
                                      want["probabilities"][:100].cpu()
                                      .numpy())
        with futures.ThreadPoolExecutor(8) as pool:
            parts = list(pool.map(lambda i: m.score_rows(rows[i:i + 5]),
                                  range(0, 40, 5), timeout=60))
        for i, part in zip(range(0, 40, 5), parts):
            np.testing.assert_allclose(part["scores"],
                                       got["scores"][i:i + 5], rtol=1e-6,
                                       atol=1e-7)
        c = TcpPredictorClient(port=srv.tcp_port, timeout=60)
        try:
            assert c.predict(rows)["scores"] == got["scores"]
        finally:
            c.close()
        torch.cuda.synchronize()
        assert _launches() == before
    finally:
        srv.stop()
        m.close()


# -------------------------------------------------------- optimizers, FM
@pytest.mark.cuda
def test_cuda_fm_gather_backward_is_deterministic(cuda_device):
    """The FM term's gradient of ``v`` on the card: K1 at width k over the
    stably sorted pooled wide ids, the same bits on every call, and within
    1e-5 of the host's (float32 sums in another order)."""
    from wide_deep_tpu_torch.models.linear import _fm_term
    rng = np.random.default_rng(7)
    rows, k, b, pool = 20000, 8, 512, 40
    ids = (rng.zipf(1.3, (b, pool)) % rows).astype(np.int32)
    wts = rng.random((b, pool)).astype(np.float32)
    v0 = (0.01 * rng.normal(size=(rows, k))).astype(np.float32)
    grads = []
    for dev in (cuda_device, cuda_device, cuda_device, "cpu"):
        v = torch.from_numpy(v0).to(dev).requires_grad_(True)
        before = tsc.range_launches_by_width().get(k, 0)
        _fm_term(v, {"wide_ids": torch.from_numpy(ids).to(dev),
                     "wide_wts": torch.from_numpy(wts).to(dev)},
                 None).sum().backward()
        if dev != "cpu":
            torch.cuda.synchronize()
            assert tsc.range_launches_by_width()[k] - before == 1
        grads.append(v.grad.cpu())
    assert all(torch.equal(_bits(grads[0]), _bits(x)) for x in grads[1:3])
    np.testing.assert_allclose(grads[0].numpy(), grads[3].numpy(),
                               rtol=1e-5, atol=1e-7)


def _optimizer_trainer(tmp_path, monkeypatch, name, device, edits=()):
    """A small-config Trainer whose deep arm takes optimizer ``name``, d8
    unfolded under the fused sparse optimizer where ``name`` is sparse-
    capable (SPARSE_MIN_ROWS 1), d4 folded under a range plan."""
    import os

    from paths import TRAIN1
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.features.plan import FeaturePlan
    from wide_deep_tpu_torch.optim import sparse as tsparse
    from wide_deep_tpu_torch.testing import write_small_conf
    from wide_deep_tpu_torch.training.loop import Trainer
    conf_dir = str(tmp_path / f"conf_{name}")
    if not os.path.isdir(conf_dir):
        write_small_conf(conf_dir)
        path = os.path.join(conf_dir, "model.yaml")
        with open(path) as f:
            text = f.read().replace("dnn_optimizer: Adagrad",
                                    f"dnn_optimizer: {name}")
        for old, new in edits:
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text + "\nwide_fold_max_rows: 20000\n")
    monkeypatch.setattr(tsparse, "SPARSE_MIN_ROWS", 1)
    monkeypatch.setattr(FeaturePlan, "scatter_group",
                        lambda self, g, b: g.folded)
    monkeypatch.setattr(FeaturePlan, "window_group", lambda self, g, b: False)
    return Trainer(Config(conf_dir), "wide_deep", device=device,
                   model_dir=str(tmp_path / f"m_{name}_{device}"),
                   dtype=torch.float32,
                   overrides=dict(batch_size=16, pack_budget=3,
                                  train_data=TRAIN1, keep_train=False))


@pytest.mark.cuda
def test_cuda_sgd_fused_table_matches_cpu(cuda_device, tmp_path,
                                          monkeypatch):
    """dnn_optimizer: SGD keeps the fused table, with no slots: each step
    launches K3 once and the d8 compact K1; 3 steps on the card against
    the host from the same params, float32 round-off apart."""
    from paths import TRAIN1
    from wide_deep_tpu_torch.optim import tree_items
    cpu = _optimizer_trainer(tmp_path, monkeypatch, "SGD", "cpu")
    gpu = _optimizer_trainer(tmp_path, monkeypatch, "SGD", "cuda")
    assert [t.spec["name"] for t in gpu.sparse_tables.values()] == ["SGD"]
    cpu.ensure_initialized(restore=False)
    gpu.params = {k: _to(v, cuda_device) for k, v in cpu.params.items()}
    gpu.mstate = {k: _to(v, cuda_device) for k, v in cpu.mstate.items()}
    before = (tsc.range_launches_by_width().get(8, 0), trowdma.rowdma_launches)
    cpu.train_file(TRAIN1, max_steps=3)
    gpu.train_file(TRAIN1, max_steps=3)
    torch.cuda.synchronize()
    assert (tsc.range_launches_by_width()[8] - before[0],
            trowdma.rowdma_launches - before[1]) == (3, 3)
    np.testing.assert_allclose([float(x) for x in gpu.losses],
                               [float(x) for x in cpu.losses], rtol=1e-4)
    cpu_leaves = dict(tree_items(cpu.params))
    for path, leaf in tree_items(gpu.params):
        np.testing.assert_allclose(leaf.detach().cpu().numpy(),
                                   cpu_leaves[path].detach().numpy(),
                                   rtol=1e-3, atol=1e-4, err_msg=str(path))
    assert not gpu.params["dnn"]["embed"]["d8"][:, 8:].any()


# ------------------------------ optimizer numerics, card against host (PR 11)
def _ulp(a, b):
    """Elementwise distance in units in the last place (+0 and -0 one
    value) of two host tensors of one dtype."""
    ints, mask = {torch.bfloat16: (torch.int16, 0x7FFF),
                  torch.float32: (torch.int32, 0x7FFFFFFF)}[a.dtype]

    def ordered(t):
        i = t.contiguous().view(ints).long()
        return torch.where(i < 0, -(i & mask), i & mask)
    return (ordered(a) - ordered(b)).abs()


SPEC_L1_L2 = {"l1_regularization_strength": 0.5,
              "l2_regularization_strength": 1.0}


def _sweep_launches():
    from wide_deep_tpu_torch.ops import optim_sweep
    return {"Ftrl": optim_sweep.ftrl_launches,
            "Adagrad": optim_sweep.adagrad_launches}


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset"])
@pytest.mark.parametrize("n", [1, 7, (1 << 20) + 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["Ftrl", "ProximalAdagrad", "Adagrad"])
def test_cuda_optimizer_leaf_matches_host_bits(cuda_device, name, dtype, n,
                                               offset):
    """``leaf_update_`` on the card gives the host's bits (0 ulp) for the
    param and every slot over three steps (FTRL's first step takes its
    root in the param's dtype), on ``n`` elements with zero gradients
    among them and conf/'s decaying learning rate.  Ftrl and Adagrad run
    the sweep kernel (csrc/optim_sweep.cu), one launch a step, on leaves
    16-byte aligned and (``offset``) one element past that, as a view into
    a flat buffer is (its scalar loop); ProximalAdagrad runs the eager
    chain (roots in float64 and divisions by device-held scalars:
    optim/__init__.py ``_sqrt``, ``_rsqrt``, ``_on``)."""
    from wide_deep_tpu_torch.optim import (exponential_decay, leaf_update_,
                                           slot_inits)
    spec = dict({"name": name, "learning_rate": 0.05}, **SPEC_L1_L2)
    schedule = exponential_decay(0.05, 0.8, 7.0)
    rng = np.random.default_rng(11)
    w0 = torch.from_numpy(rng.normal(0, 0.05, n).astype(np.float32))
    grads = []
    for _ in range(3):
        g = rng.normal(0, 1e-2, n).astype(np.float32)
        g[rng.random(n) < 0.3] = 0.0
        g[0] = 0.0
        grads.append(torch.from_numpy(g).to(dtype))

    def placed(t, dev):
        # ``t`` on ``dev`` at ``offset`` elements into a buffer of its own
        buf = torch.empty(offset + t.numel(), dtype=t.dtype, device=dev)
        out = buf[offset:]
        out.copy_(t)
        return out

    out = {}
    for dev in ("cpu", cuda_device):
        w = placed(w0.to(dtype), dev)
        slots = {k: placed(torch.full_like(w0, v).to(dt or dtype), dev)
                 for k, (v, dt) in slot_inits(spec).items()}
        steps = []
        for count, g in enumerate(grads):
            before = _sweep_launches()
            leaf_update_(spec, schedule(count), count, w,
                         placed(g, dev), slots)
            rose = {k: v - before[k] for k, v in _sweep_launches().items()}
            on_card = str(dev) != "cpu"
            assert rose == {k: int(on_card and k == name) for k in rose}, (
                dev, rose)
            steps.append([t.to("cpu", copy=True)
                          for t in [w, *slots.values()]])
        out[str(dev)] = steps
    for count, (host, card) in enumerate(zip(out["cpu"], out["cuda"])):
        for i, (a, b) in enumerate(zip(host, card)):
            assert int(_ulp(a, b).max()) == 0, (name, count, i)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["Ftrl", "Adagrad"])
def test_cuda_optimizer_sweep_refuses_what_it_cannot_take(cuda_device,
                                                          name):
    """A CUDA leaf under Ftrl or Adagrad that the sweep kernel cannot take
    raises rather than falling back: a strided param, a strided slot, a
    float16 param; nothing is launched or written.  A strided gradient is
    taken (made contiguous first)."""
    from wide_deep_tpu_torch.optim import leaf_update_, slot_inits
    spec = dict({"name": name, "learning_rate": 0.05}, **SPEC_L1_L2)
    lr = torch.tensor(0.05)

    def leaf(dtype=torch.float32, strided=()):
        w = torch.ones(64, 4, dtype=dtype, device=cuda_device)
        slots = {k: torch.full_like(w, v).to(dt or dtype)
                 for k, (v, dt) in slot_inits(spec).items()}
        g = torch.full_like(w, 0.5)
        if "w" in strided:
            w = torch.ones(4, 64, dtype=dtype, device=cuda_device).t()
        if "slot" in strided:
            k = next(iter(slots))
            slots[k] = slots[k].t().contiguous().t()
        return w, g, slots

    for args in (leaf(strided=("w",)), leaf(strided=("slot",)),
                 leaf(dtype=torch.float16)):
        w, g, slots = args
        before = _sweep_launches()
        w0 = w.clone()
        with pytest.raises(ValueError):
            leaf_update_(spec, lr, 0, w, g, slots)
        assert _sweep_launches() == before
        assert torch.equal(w, w0)
    # a strided gradient is taken, as its contiguous copy
    w, g, slots = leaf()
    w2, slots2 = w.clone(), {k: v.clone() for k, v in slots.items()}
    leaf_update_(spec, lr, 0, w, g.t().contiguous().t(), slots)
    leaf_update_(spec, lr, 0, w2, g, slots2)
    for a, b in zip([w, *slots.values()], [w2, *slots2.values()]):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["Adagrad", "Ftrl", "ProximalAdagrad"])
def test_cuda_fused_row_update_matches_host_bits(cuda_device, name):
    """The fused table's row formula (``optim.sparse._row_update``) on the
    card gives the host's bits (0 ulp) for the rows and their slots, at the
    production step's shape (25,600 touched d32 rows), over three steps."""
    from wide_deep_tpu_torch.optim import exponential_decay
    from wide_deep_tpu_torch.optim.sparse import _row_update, fused_layout
    spec = dict({"name": name, "learning_rate": 0.05}, **SPEC_L1_L2)
    schedule = exponential_decay(0.05, 0.8, 7.0)
    rng = np.random.default_rng(12)
    rows, d = 25600, 32
    w0 = rng.normal(0, 0.05, (rows, d)).astype(np.float32)
    grads = []
    for _ in range(3):
        g = rng.normal(0, 1e-2, (rows, d)).astype(np.float32)
        g[rng.random(rows) < 0.2] = 0.0          # pool padding rows
        grads.append(torch.from_numpy(g))
    out = {}
    for dev in ("cpu", cuda_device):
        w = torch.from_numpy(w0).to(dev)
        slots = {k: torch.full_like(w, 0.1 if k == "accum" else 0.0)
                 for k in fused_layout(spec, d)}
        steps = []
        for count, g in enumerate(grads):
            w, slots = _row_update(spec, schedule(count), w, g.to(dev),
                                   slots)
            steps.append([w.cpu()] + [slots[k].cpu() for k in sorted(slots)])
        out[str(dev)] = steps
    for count, (host, card) in enumerate(zip(out["cpu"], out["cuda"])):
        for i, (a, b) in enumerate(zip(host, card)):
            assert int(_ulp(a, b).max()) == 0, (name, count, i)


# ------------------------------------------------------------- the CNN arm
def _cnn_case(model, size, batch, seed=0):
    """(spec, params, BN state after one training forward, images, cot) on
    the host: the port's own random init (seeded), 224 x 224 images."""
    from wide_deep_tpu_torch.models.cnn import (CnnSpec, cnn_logits,
                                                init_cnn_params)
    spec = CnnSpec(model=model, resnet_size=size)
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(
        (rng.random((batch, 224, 224, 3)) * 255 - 120).astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal((batch, 1)).astype(
        np.float32))
    params, state = init_cnn_params(torch.Generator().manual_seed(seed),
                                    spec, 1, images[:1], torch.device("cpu"))
    with torch.no_grad():
        _, state = cnn_logits(params, spec, images, 1, True, state)
    return spec, params, state, images, cot


@pytest.mark.cuda
@pytest.mark.parametrize("model,size", [("vgg16", 50), ("resnet", 50)])
def test_cuda_cnn_matches_cpu(cuda_device, model, size):
    """The CNN arm on the card against the port on the host at batch 2,
    from the same weights: float32 logits and BN state (and VGG's
    gradients), float64 logits, gradients and BN state, with the CPU
    tests' tolerances (wide_deep_tpu_torch.testing.cnn_disagreement)."""
    from wide_deep_tpu_torch.models.deep import set_parity_precision
    from wide_deep_tpu_torch.testing import (cnn_disagreement,
                                             cnn_forward_backward)
    set_parity_precision()
    spec, params, state, images, cot = _cnn_case(model, size, 2)
    for dt in (torch.float32, torch.float64):
        for training in (True, False):
            host = cnn_forward_backward(spec, params, state, images.to(dt),
                                        cot.to(dt), training)
            card = cnn_forward_backward(spec, params, state,
                                        images.to(cuda_device, dt),
                                        cot.to(dt), training)
            d = cnn_disagreement(
                spec, host, card,
                with_grads=dt == torch.float64 or model == "vgg16")
            assert d["ok"], (dt, training, d)


@pytest.mark.cuda
@pytest.mark.parametrize("model,size", [("vgg16", 50), ("resnet", 50)])
def test_cuda_cnn_forward_backward_is_deterministic(cuda_device, model,
                                                    size):
    """Two forward + backward passes of the CNN arm on one batch of 8 give
    the same bits: logits, BN state and every gradient (deterministic
    cuDNN algorithms, models/deep.set_parity_precision)."""
    from wide_deep_tpu_torch.models.deep import set_parity_precision
    from wide_deep_tpu_torch.testing import cnn_forward_backward
    set_parity_precision()
    assert torch.backends.cudnn.deterministic
    assert not torch.backends.cudnn.benchmark
    spec, params, state, images, cot = _cnn_case(model, size, 8)
    images = images.to(cuda_device)
    runs = [cnn_forward_backward(spec, params, state, images, cot)
            for _ in range(2)]
    (l0, s0, g0), (l1, s1, g1) = runs
    assert torch.equal(l0, l1)
    for k in s0:
        for s in s0[k]:
            assert torch.equal(_bits(s0[k][s]), _bits(s1[k][s])), (k, s)
    for p in g0:
        assert torch.equal(_bits(g0[p]), _bits(g1[p])), p


# ------------------------------------------------ per-shard plans (ranks)
SHARD_CASES = [("range", "uniform", 20000, 9, torch.bfloat16),
               ("range", "skewed", 20000, 9, torch.float32),
               ("window", "uniform", 60000, 17, torch.bfloat16),
               ("window", "hot_window", 60000, 17, torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("mode,kind,rows,d,dtype", SHARD_CASES)
def test_cuda_per_shard_plans_match_plain(cuda_device, mode, kind, rows, d,
                                          dtype, shards):
    """Each shard's row of a per-shard range or window plan, summed on the
    card as a rank sums it (parallel/exchange.planned_shard_sum: K1 over
    the live prefix, K2 under the windows, K1 over the masked local ids
    sorted on the card when the row says ok=0) against the plain version
    of the same inputs on the host."""
    from wide_deep_tpu_torch.parallel.exchange import planned_shard_sum
    rng = np.random.default_rng(rows + d + shards)
    n = 6000
    ids = _ids(kind, n, rows, rng)
    w = _weights(n, rng)
    make = (tsc.make_sharded_window_plan if mode == "window"
            else tsc.make_sharded_scatter_plan)
    plan = make(ids, rows, shards, w)
    g = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    g[torch.from_numpy(w == 0)] = 0.0
    g = g.to(dtype)
    shard_rows = rows // shards
    for s in range(shards):
        row = {k: (int(v[s]) if k in ("ok", "live")
                   else torch.from_numpy(v[s]))
               for k, v in plan.items()}
        local = torch.from_numpy(ids.astype(np.int64) - s * shard_rows)
        want = planned_shard_sum(row, g, local, shard_rows, n, shards,
                                 dtype).float()
        mag = planned_shard_sum(row, g.abs(), local, shard_rows, n, shards,
                                torch.float32)
        card = {k: (v.to(cuda_device) if torch.is_tensor(v) else v)
                for k, v in row.items()}
        got = planned_shard_sum(card, g.to(cuda_device),
                                local.to(cuda_device), shard_rows, n,
                                shards, dtype)
        again = planned_shard_sum(card, g.to(cuda_device),
                                  local.to(cuda_device), shard_rows, n,
                                  shards, dtype)
        assert torch.equal(got, again)
        tol = 1e-6 * mag + 1e-6
        if dtype == torch.bfloat16:
            tol = tol + BF16_ULP * want.abs()
        assert ((got.float().cpu() - want).abs() <= tol).all(), (mode, kind,
                                                                 s)
    if kind == "hot_window":
        assert plan["ok"][0] == 0


class _Shard:
    """A rank's place for apply_fused_sharded_update without collectives:
    shard ``shard`` of ``world``, its cotangent already whole."""

    def __init__(self, shard, world):
        self.shard, self.world, self.data_group = shard, world, None


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [2, 4])
def test_cuda_fused_sharded_update_matches_cpu(cuda_device, shards):
    """A shard's fused update on the card (K1 into the compact space with
    rows = cap over the live entries, the row formula, K3 into the shard)
    against the same update on the host, bit for bit: the gradients are
    multiples of 1/64 (their float32 sums exact in any order) and the row
    formula gives the host's bits on the card (PR 11)."""
    from wide_deep_tpu_torch.optim import sparse as sp
    rng = np.random.default_rng(shards)
    rows, dim, n = 40000, 32, 5000
    ids = (rng.zipf(1.2, n) % rows).astype(np.int32)
    plan = tsc.make_sharded_compact_plan(ids, rows, shards)
    fused = np.zeros((rows, 128), np.float32)
    fused[:, :dim] = rng.normal(size=(rows, dim)) * 0.1
    fused[:, dim:2 * dim] = 0.1
    g = (rng.integers(-64, 64, (n, dim)) / 64.0).astype(np.float32)
    table = sp.SparseTable(name="t", path=("t",), ids_key="ids",
                           spec={"name": "Adagrad"}, lr=0.05, dim=dim)
    per = rows // shards

    def update(s, row, dev):
        shard = torch.from_numpy(fused[s * per:(s + 1) * per].copy()).to(dev)
        sp.apply_fused_sharded_update(
            table, shard, torch.from_numpy(g).to(dev),
            torch.from_numpy(ids).to(dev),
            {k: (v.to(dev) if torch.is_tensor(v) else v)
             for k, v in row.items()}, {"count": 0}, _Shard(s, shards))
        return shard.cpu()

    for s in range(shards):
        row = {k: (int(v[s]) if k in ("ok", "live")
                   else torch.from_numpy(v[s]))
               for k, v in plan.items()}
        host, card = update(s, row, "cpu"), update(s, row, cuda_device)
        assert torch.equal(card, host), s


@pytest.mark.cuda
def test_cuda_two_ranks_on_one_card(cuda_device, tmp_path):
    """Two gloo ranks sharing the card run the exchange's cases (tests/
    test_torch_exchange.py) with K1 / K2 on their own shards: the same
    rows and, within the CPU tests' bound, the same gradients as two ranks
    on the host."""
    from torch_rank_cases import run_ranks
    cases = []
    for i, (mode, dtype) in enumerate((("range", "float32"),
                                       ("window", "bfloat16"),
                                       (None, "float32"))):
        rng = np.random.default_rng(i)
        rows, d, b, p = 8192, 16, 256, 8
        ids = rng.integers(0, rows, (b, p)).astype(np.int32)
        plan = None
        if mode:
            make = (tsc.make_sharded_window_plan if mode == "window"
                    else tsc.make_sharded_scatter_plan)
            plan = make(ids.reshape(-1), rows, 2)
        table = torch.from_numpy(rng.normal(size=(rows, d)).astype(
            np.float32)).to(getattr(torch, dtype)).float().numpy()
        cases.append({"name": f"{mode}_{dtype}", "mesh": (2, 1),
                      "kind": "planned" if mode else "explicit",
                      "table": table, "ids": ids, "dtype": dtype,
                      "cot": rng.normal(size=(b, p, d)).astype(np.float32),
                      "plan": plan})
    host = run_ranks("exchange", 2, tmp_path, cases)
    card = run_ranks("exchange", 2, tmp_path, cases, device="cuda")
    for i, c in enumerate(cases):
        for h, k in zip(host, card):
            np.testing.assert_array_equal(k[i]["out"], h[i]["out"])
            bound = 1e-6 * np.abs(h[i]["grad"]) + 1e-5
            if c.get("dtype") == "bfloat16":
                bound = bound + BF16_ULP * np.abs(h[i]["grad"])
            assert (np.abs(k[i]["grad"] - h[i]["grad"]) <= bound).all(), (
                c["name"])


# the dedup exchange's slot sums at the production per-shard shapes
# (2 ranks, batch 25,600, {data: 1, model: 2}): the d8 group's
# 1,024,000-entry pool (870,400 live) into 1,203,200 rows and the d16
# group's 102,400 entries (76,800 live) into 1,500,160 rows, each with its
# folded wide column
DEDUP_SITES = [("d8", 1024000, 870400, 1203200, 9),
               ("d16", 102400, 76800, 1500160, 17)]


@pytest.mark.cuda
@pytest.mark.parametrize("site,n,live,rows,d", DEDUP_SITES,
                         ids=[s[0] for s in DEDUP_SITES])
def test_cuda_dedup_slot_sum_matches_plain(cuda_device, site, n, live, rows,
                                           d):
    """``exchange.slot_sum`` on the card (K1 over the slots sorted on the
    card, weight-0 entries routed out) against its plain version on the
    host, within 1e-6 of each row's sum of |g|; the same bits twice, and
    the same as without the routing (their cotangent rows are zero)."""
    from wide_deep_tpu_torch.parallel.exchange import slot_sum
    rng = np.random.default_rng(n)
    ids = rng.integers(0, rows, n).astype(np.int32)
    wts = np.ones(n, np.float32)
    pad = rng.permutation(n)[:n - live]
    ids[pad], wts[pad] = 0, 0.0
    plan = tsc.make_dedup_plan(ids.reshape(-1, 1), rows, 2)
    n_slots = 2 * plan["uids"].shape[1]
    g = rng.normal(size=(n, d)).astype(np.float32)
    g[pad] = 0.0
    host = [torch.from_numpy(a) for a in (plan["slots"].reshape(-1), g,
                                          wts != 0)]
    want = slot_sum(host[0], host[1], n_slots, host[2])
    mag = slot_sum(host[0], host[1].abs(), n_slots, host[2])
    card = [t.to(cuda_device) for t in host]
    k1 = tsc.range_launches
    got = slot_sum(card[0], card[1], n_slots, card[2])
    again = slot_sum(card[0], card[1], n_slots, card[2])
    unrouted = slot_sum(card[0], card[1], n_slots)
    assert tsc.range_launches == k1 + 3
    assert torch.equal(got, again)
    assert got.dtype == torch.float32 and got.shape == (n_slots, d)
    assert ((got.cpu() - want).abs() <= 1e-6 * mag + 1e-6).all()
    assert ((unrouted - got).abs().cpu() <= 1e-6 * mag + 1e-6).all()


@pytest.mark.cuda
def test_cuda_dedup_two_ranks_on_one_card(cuda_device, tmp_path):
    """Two gloo ranks sharing the card run the dedup exchange (tests/
    test_torch_dedup.py's gathers): the same rows as two ranks on the
    host, and their gradients within 1e-6 of each row's sum of |g|."""
    from torch_rank_cases import run_ranks
    cases = []
    for i, mesh in enumerate(((1, 2), (2, 1))):
        rng = np.random.default_rng(i)
        rows, d, b, p = 8192, 17, 256, 8
        ids = rng.integers(0, rows, (b, p)).astype(np.int32)
        wts = np.ones((b, p), np.float32)
        m = rng.random((b, p)) < 0.3
        ids[m], wts[m] = 0, 0.0
        cot = rng.normal(size=(b, p, d)).astype(np.float32)
        cot[m] = 0.0
        cases.append({"name": f"dedup_{mesh}", "mesh": mesh, "kind": "dedup",
                      "table": rng.normal(size=(rows, d)).astype(np.float32),
                      "ids": ids, "wts": wts, "cot": cot, "dtype": "float32",
                      "plan": tsc.make_dedup_plan(ids, rows, 2)})
    host = run_ranks("exchange", 2, tmp_path, cases)
    card = run_ranks("exchange", 2, tmp_path, cases, device="cuda")
    for i, c in enumerate(cases):
        mag = np.zeros_like(c["table"], np.float64)
        np.add.at(mag, c["ids"].reshape(-1),
                  np.abs(c["cot"].reshape(-1, c["table"].shape[1])))
        g_host = np.concatenate([h[i]["grad"] for h in host])
        g_card = np.concatenate([k[i]["grad"] for k in card])
        for h, k in zip(host, card):
            np.testing.assert_array_equal(k[i]["out"], h[i]["out"])
            assert k[i]["bytes"] == h[i]["bytes"]
        assert (np.abs(g_card - g_host) <= 1e-6 * mag + 1e-6).all(), c["name"]
