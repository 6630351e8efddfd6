"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device (marker ``cuda``) and skips without
one; the file imports no JAX, so it runs on a machine with only PyTorch:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Tolerances: bfloat16 outputs within one bf16 ulp (both versions round a
float32 sum once); float32 outputs, kernel and plain version alike, within
1e-6 of each row's sum of magnitudes from the float64 sum of the same
inputs (float32 round-off grows with the magnitudes summed, not with what
is left after they cancel, and the plain version's atomic adds on the card
sum in a different order on every call); K3, P1 and P2 exact.
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


def _range_case(kind, n, rows, d, dtype, seed):
    rng = np.random.default_rng(seed)
    ids = _ids(kind, n, rows, rng)
    plan = tsc.make_scatter_plan(ids, rows, _weights(n, rng))
    g = rng.normal(size=(n, d)).astype(np.float32)
    g_t = torch.from_numpy(g).to(dtype)
    g64 = g_t.double().numpy()          # the grads as the kernels see them
    keep = plan["ids"] < rows
    ref = np.zeros((rows, d), np.float64)
    np.add.at(ref, plan["ids"][keep], g64[plan["perm"][keep]])
    abs_sum = np.zeros((rows, d), np.float64)
    np.add.at(abs_sum, plan["ids"][keep], np.abs(g64[plan["perm"][keep]]))
    return plan, g_t, ref, abs_sum


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype", [(9, torch.bfloat16), (32, torch.float32)])
def test_cuda_range_kernel_matches_plain(cuda_device, d, dtype):
    plan, g, ref, abs_sum = _range_case("skewed", 20000, 5000, d, dtype,
                                        seed=1)
    tp = {k: torch.from_numpy(v).to(cuda_device) for k, v in plan.items()}
    g = g.to(cuda_device)
    before = tsc.range_launches
    before_d = tsc.range_launches_by_width.get(d, 0)
    out = tsc.range_scatter_add(tp["ids"], tp["perm"], g, tp["tiles"], 5000)
    want = tsc.range_scatter_add_plain(tp["ids"], tp["perm"], g, 5000)
    torch.cuda.synchronize()
    assert tsc.range_launches == before + 1
    assert tsc.range_launches_by_width[d] == before_d + 1
    if dtype == torch.bfloat16:
        tol = BF16_ULP * want.float().abs() + 1e-5
        assert bool(((out.float() - want.float()).abs() <= tol).all())
    else:
        tol = 1e-6 * abs_sum + 1e-6
        for got in (out, want):
            err = np.abs(got.double().cpu().numpy() - ref)
            assert (err <= tol).all(), float((err / (abs_sum + 1e-30)).max())


@pytest.mark.cuda
def test_cuda_window_and_rowdma_kernels_match_plain(cuda_device):
    rng = np.random.default_rng(2)
    rows, n = 40000, 6000
    plan = tsc.make_window_plan(_ids("uniform", n, rows, rng), rows)
    tp = {k: torch.from_numpy(v).to(cuda_device) for k, v in plan.items()}
    g = torch.randn((n, 17), device=cuda_device).to(torch.bfloat16)
    out = tsc.window_scatter_add(tp["ids"], tp["perm"], g, tp["tiles"], rows,
                                 tsc.window_cap(n, rows))
    want = tsc.window_scatter_add_plain(tp["ids"], tp["perm"], g, rows)
    assert bool(((out.float() - want.float()).abs()
                 <= BF16_ULP * want.float().abs() + 1e-5).all())
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
