"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program: top-level module names compared
whole (the port's name begins with the JAX package's)."""

from __future__ import annotations

import ast
import os
import sys

import pytest

from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "wide_deep_tpu"}


def _modules():
    for root, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def imported_tops(path):
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".", 1)[0])
    return out


@pytest.mark.parametrize("path", sorted(_modules()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(
    p for p in _modules() if os.sep + "reference" + os.sep in p),
    ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_stands_alone(path):
    tops = imported_tops(path)
    assert "wide_deep_tpu_torch" not in tops
    assert tops <= {"__future__", "dataclasses", "math", "os", "re",
                    "typing", "numpy", "torch", "yaml"}, tops


def test_loaded_check_compares_whole_names(monkeypatch):
    from harness import env
    for name in ("wide_deep_tpu_torch", "jaxtyping", "flax_like"):
        monkeypatch.setitem(sys.modules, name, object())
    assert env.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "wide_deep_tpu.config", object())
    assert env.forbidden_loaded() == ["wide_deep_tpu"]


def test_run_without_a_card_prints_no_result(tmp_path):
    """On a machine without CUDA the command exits non-zero and prints no
    result line."""
    import subprocess
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    import json
    with open(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json")) as f:
        cell = json.load(f)["workloads"][0]["name"]
    r = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"),
                        "--workload", cell, "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, TMPDIR=str(tmp_path)))
    assert r.returncode != 0
    assert "no CUDA card" in r.stderr, r.stderr[-2000:]
    assert "correct" not in r.stdout
