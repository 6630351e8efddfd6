"""The port's speed gates on the card, opted into as
tests/test_chip_gates.py's gates are:

    WDT_RUN_CHIP_GATES=1 python -m pytest tests/test_torch_chip_gates.py -q

The serving SLO gate runs ``python -m wide_deep_tpu_torch.tools.serving_slo
check`` against the card's committed budget, serving_slo_torch.json (p99
within 30% + 1 ms of the budget's, rows/s within 30% of it, both
transports where the grpc package imports).  The perf gate profiles 3
steps of the bench tool's device stage and runs
``python -m wide_deep_tpu_torch.tools.perf_regression check`` against
perf_budget_torch.json (each bucket within 8% + 0.2 ms a step).  Event
times spread up to 2x between runs on a shared host, so chip_smoke.py
measures and prints and does not gate.
"""

import os
import subprocess
import sys
import tempfile

import pytest

torch = pytest.importorskip("torch")

from paths import REPO  # noqa: E402

pytestmark = [pytest.mark.slow, pytest.mark.cuda]


def test_torch_serving_slo_gate():
    if os.environ.get("WDT_RUN_CHIP_GATES") != "1":
        pytest.skip("the serving SLO gate needs the card; set "
                    "WDT_RUN_CHIP_GATES=1 on a host with one")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "-m", "wide_deep_tpu_torch.tools.serving_slo",
         "check"],
        capture_output=True, text=True, timeout=1800, cwd=REPO)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]


def test_torch_perf_gate():
    if os.environ.get("WDT_RUN_CHIP_GATES") != "1":
        pytest.skip("the perf gate needs the card; set "
                    "WDT_RUN_CHIP_GATES=1 on a host with one")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as d:
        bench = subprocess.run(
            [sys.executable, "-m", "wide_deep_tpu_torch.tools.bench"],
            capture_output=True, text=True, timeout=1800, cwd=REPO,
            env=dict(os.environ, BENCH_PROFILE=d, BENCH_E2E="0"))
        assert bench.returncode == 0, bench.stderr[-3000:]
        out = subprocess.run(
            [sys.executable, "-m", "wide_deep_tpu_torch.tools.perf_regression",
             "check", "--profile_dir", d, "--steps", "3", "--budget",
             os.path.join(REPO, "perf_budget_torch.json")],
            capture_output=True, text=True, timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
