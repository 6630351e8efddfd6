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
    before_d = tsc.range_launches_by_width.get(d, 0)
    out = tsc.range_scatter_add(tp["ids"], tp["perm"], g, tp["tiles"], rows)
    again = tsc.range_scatter_add(tp["ids"], tp["perm"], g, tp["tiles"],
                                  rows)
    want = tsc.range_scatter_add_plain(tp["ids"], tp["perm"], g, rows)
    torch.cuda.synchronize()
    assert tsc.range_launches == before + 2
    assert tsc.range_launches_by_width[d] == before_d + 2
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
    """The wrapper sizes K1's scratch as the kernel counts it."""
    for n in (0, 1, 31, 32, 33, 25600, 1024000):
        for d in (1, 5, 9, 32, 33, 64):
            assert tsc.kernel_range_scratch_floats(n, d) == \
                tsc.range_scratch_floats(n, d), (n, d)


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
              tsc.range_launches_by_width.get(d, 0))
    out = tsc.apply_window_plan(tp, g, rows)
    again = tsc.apply_window_plan(tp, g, rows)
    want = tsc.range_scatter_add_plain(tp["ids"], tp["perm"], g, rows)
    torch.cuda.synchronize()
    assert (tsc.window_ok0_launches, tsc.window_launches,
            tsc.range_launches_by_width[d]) == (
        before[0] + 2, before[1], before[2] + 2)
    assert out.dtype == torch.bfloat16 and out.shape == (rows, d)
    assert torch.equal(_bits(out), _bits(again))
    tol = BF16_ULP * want.float().abs() + 1e-5
    assert bool(((out.float() - want.float()).abs() <= tol).all())


@pytest.mark.cuda
def test_cuda_train_file_is_deterministic(cuda_device, tmp_path,
                                          monkeypatch):
    """Two Trainer.train_file runs over one generated TSV, with bfloat16
    embeddings and window plans on the folded group, give the same losses
    and params bit for bit.  At batch 384 window 0 of d4 holds more than
    T_IDS ids, so every step's plan says ok=0 and takes K1."""
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
                     {p: v.detach().cpu() for p, v in
                      tree_items(trainer.params)}))
    (losses_a, params_a), (losses_b, params_b) = runs
    assert len(losses_a) == steps and losses_a == losses_b
    assert sorted(params_a) == sorted(params_b)
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
                  device="cpu", dtype=torch.float32)
    gpu = Trainer(Config(conf_dir), "wide_deep", overrides=over,
                  device="cuda", dtype=torch.float32)
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
    assert k3 == 3 and k1 == (6 if mode == "range" else 3)
    assert k2 == (0 if mode == "range" else 3)
    np.testing.assert_allclose([float(x) for x in gpu.losses],
                               [float(x) for x in cpu.losses], rtol=1e-4)
    cpu_leaves = dict(tree_items(cpu.params))
    for path, leaf in tree_items(gpu.params):
        np.testing.assert_allclose(leaf.detach().float().cpu().numpy(),
                                   cpu_leaves[path].detach().float().numpy(),
                                   rtol=1e-3, atol=1e-4, err_msg=str(path))


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.detach().clone().to(device)
