"""The port's probe kernels (P1 resident gather, P2 bulk row scatter) and
their tools against the JAX package's probe tools.

The Pallas probe kernels do not run on the CPU (P1 never lowered even on a
TPU), so the port is held against each JAX tool's own reference,
``xla_gather`` and ``xla_scatter``, loaded from tools/ by path, on the same
numpy inputs from a seed.  Both are exact: one float32 multiply per element
on both sides for P1, a copy of rows for P2.  The CUDA kernels against
their plain versions: tests/test_torch_cuda.py.
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from paths import REPO  # noqa: E402
from test_torch_cuda import _p1_case, _p2_case  # noqa: E402
from wide_deep_tpu_torch.ops import gather as tgather  # noqa: E402
from wide_deep_tpu_torch.ops import rowdma as trowdma  # noqa: E402
from wide_deep_tpu_torch.tools import microbench_rowdma_scatter as t_p2  # noqa: E402
from wide_deep_tpu_torch.tools import microbench_vmem_gather as t_p1  # noqa: E402


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J_P1 = _jax_tool("microbench_vmem_gather")
J_P2 = _jax_tool("microbench_rowdma_scatter")


def _bf16_np(t):
    """A bfloat16 tensor as JAX's bfloat16 numpy array, bit for bit."""
    return np.asarray(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16))


@pytest.mark.parametrize("d", [8, 9])
def test_resident_gather_matches_jax_tool(d):
    seg, w, dpool = _p1_case(3000, 512, d, seed=d)
    want = np.asarray(J_P1.xla_gather(jnp.asarray(seg), jnp.asarray(w),
                                      jnp.asarray(dpool)))
    ts, tw, tp = map(torch.from_numpy, (seg, w, dpool))
    before = tgather.resident_gather_launches
    got = tgather.resident_gather(ts, tw, tp)
    assert got.shape == (3000, d) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tgather.resident_gather_plain(ts, tw, tp).numpy(), want)
    assert tgather.resident_gather_launches == before   # CPU: plain version


@pytest.mark.parametrize("d,dtype", [(128, torch.float32),
                                     (64, torch.float32),
                                     (128, torch.bfloat16)])
def test_bulk_scatter_rows_matches_jax_tool(d, dtype):
    uids, rows, table = _p2_case(4096, 300, d, dtype, seed=d)
    if dtype == torch.bfloat16:
        jt, jr = jnp.asarray(_bf16_np(table)), jnp.asarray(_bf16_np(rows))
    else:
        jt, jr = jnp.asarray(table.numpy()), jnp.asarray(rows.numpy())
    want = np.asarray(J_P2.xla_scatter(jt, jnp.asarray(uids), jr)
                      .astype(jnp.float32))
    before = trowdma.bulk_scatter_launches
    got = trowdma.bulk_scatter_rows(table, torch.from_numpy(uids), rows)
    assert got is table and got.dtype == dtype
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert trowdma.bulk_scatter_launches == before       # CPU: plain version


def _meta(t):
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _p1_args():
    seg, w, dpool = _p1_case(64, 16, 8, seed=0)
    return torch.from_numpy(seg), torch.from_numpy(w), torch.from_numpy(dpool)


def _p2_args(d=128, dtype=torch.float32):
    uids, rows, table = _p2_case(256, 30, d, dtype, seed=0)
    return table, torch.from_numpy(uids), rows


@pytest.mark.parametrize("case", [
    "p2 row of 36 bytes", "p2 bf16 row of 18 bytes", "p2 mixed dtypes",
    "p2 mixed devices", "p2 row of 7184 bytes", "p2 int64 uids",
    "p1 mixed dtypes", "p1 mixed devices"])
def test_probe_wrappers_refuse(case):
    if case == "p2 row of 7184 bytes":     # a multiple of 16, above a slot
        fn, args = trowdma.bulk_scatter_rows, _p2_args(1796)
    elif case == "p2 int64 uids":
        table, uids, rows = _p2_args()
        fn, args = trowdma.bulk_scatter_rows, (table, uids.long(), rows)
    elif case == "p2 row of 36 bytes":
        fn, args = trowdma.bulk_scatter_rows, _p2_args(9)
    elif case == "p2 bf16 row of 18 bytes":
        fn, args = trowdma.bulk_scatter_rows, _p2_args(9, torch.bfloat16)
    elif case == "p2 mixed dtypes":
        table, uids, rows = _p2_args()
        fn, args = trowdma.bulk_scatter_rows, (table, uids,
                                               rows.to(torch.bfloat16))
    elif case == "p2 mixed devices":
        table, uids, rows = _p2_args()
        fn, args = trowdma.bulk_scatter_rows, (table, uids, _meta(rows))
    elif case == "p1 mixed dtypes":
        seg, w, dpool = _p1_args()
        fn, args = tgather.resident_gather, (seg, w.double(), dpool)
    else:
        seg, w, dpool = _p1_args()
        fn, args = tgather.resident_gather, (_meta(seg), w, dpool)
    with pytest.raises(ValueError):
        fn(*args)


@pytest.mark.parametrize("module,env,argv", [
    ("microbench_vmem_gather", {}, []),
    ("microbench_rowdma_scatter", {"BENCH_R": "100000"}, []),
    ("microbench_rowdma_scatter", {"BENCH_R": "100000"}, ["bf16"]),
    ("microbench_rowdma_scatter", {"BENCH_R": "100000", "BENCH_D": "64"},
     [])])
def test_tool_runs_on_cpu(module, env, argv):
    """``python -m`` with --device cpu: the devices line, the "matches"
    line, both times; exit 0."""
    proc = subprocess.run(
        [sys.executable, "-m", f"wide_deep_tpu_torch.tools.{module}",
         "--device", "cpu", *argv],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=dict(os.environ, **env))
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("devices: [cpu]")
    assert "matches the plain version" in lines[1]
    assert len(lines) == 4 and all("ns/row" in x for x in lines[2:])


@pytest.mark.parametrize("tool", [t_p1, t_p2])
def test_tool_needs_cuda_unless_cpu_is_asked(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tool.main([])


@pytest.mark.parametrize("tool,name", [(t_p1, "kernel_gather"),
                                       (t_p2, "kernel_scatter")])
def test_tool_exits_nonzero_on_mismatch(tool, name, monkeypatch, capsys):
    """A kernel that disagrees with the plain version stops the tool before
    any time is printed, with a non-zero exit."""
    real = getattr(tool, name)

    def off_by_one(*args):
        out = real(*args)
        out.view(-1)[-1] += 1
        return out

    monkeypatch.setattr(tool, name, off_by_one)
    monkeypatch.setenv("BENCH_R", "30000")
    with pytest.raises(SystemExit) as exc:
        tool.main(["--device", "cpu"])
    assert exc.value.code not in (None, 0)
    assert "MISMATCH" in str(exc.value.code)
    assert "ns/row" not in capsys.readouterr().out
