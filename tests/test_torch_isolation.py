"""The port stands alone: no module of wide_deep_tpu_torch/ and not
chip_smoke.py imports JAX or the JAX package; entry points run on the card
unless the caller asks for the CPU; no undefined names; chip_smoke.py fails
without a card and without the rest of the repo."""

import ast
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paths import REPO  # noqa: E402
from test_lint import _undefined  # noqa: E402

PKG = os.path.join(REPO, "wide_deep_tpu_torch")
SMOKE = os.path.join(REPO, "chip_smoke.py")


def _port_files():
    out = [SMOKE]
    for dirpath, _, filenames in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in filenames
                if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    files = _port_files()
    assert len(files) > 15
    bad = []
    for path in files:
        for mod in _imported_modules(path):
            root = mod.split(".")[0]
            if root in ("jax", "jaxlib", "optax", "chex", "flax",
                        "wide_deep_tpu"):
                bad.append(f"{os.path.relpath(path, REPO)}: {mod}")
    assert not bad, bad


def test_port_has_no_undefined_names():
    problems = []
    for path in _port_files():
        problems += _undefined(path)
    assert not problems, "\n".join(problems)


def test_trainer_needs_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.interop import from_jax
    from wide_deep_tpu_torch.models.joint import resolve_device
    from wide_deep_tpu_torch.testing import write_small_conf
    from wide_deep_tpu_torch.training.loop import Trainer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = Config(write_small_conf(str(tmp_path)))
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(conf, "wide_deep")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        from_jax({"w": np.zeros(2, np.float32)}, {})
    assert from_jax({"w": np.zeros(2, np.float32)}, {},
                    device="cpu")[0]["w"].device.type == "cpu"
    tr = Trainer(conf, "wide_deep", device="cpu")
    assert tr.device.type == "cpu"


def test_chip_smoke_refuses_without_a_card():
    """No CUDA device: exit non-zero and print no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, SMOKE], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_chip_smoke_needs_the_repo(tmp_path):
    """Alone in a directory, the script fails even where a card is present
    (here pretended, so that it gets past its CUDA check): it cannot import
    the port, and prints no result."""
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    code = ("import runpy, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "runpy.run_path('chip_smoke.py', run_name='__main__')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=tmp_path, env=env, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "No module named 'wide_deep_tpu_torch'" in proc.stderr


def test_port_builds_its_own_loader():
    """The port never names the loader library committed in cpp/; it
    compiles its own copy, csrc/fastdata.cc, and loads the result from
    build/."""
    from wide_deep_tpu_torch.features import native
    committed = "libwdtfastdata" + ".so"
    for path in _port_files():
        with open(path) as f:
            assert committed not in f.read(), path
    assert native.SOURCE == os.path.join(REPO, "wide_deep_tpu_torch", "csrc",
                                         "fastdata.cc")
    lib = native.library()
    assert os.path.dirname(lib._name) == os.path.join(REPO, "build", "native")
    assert os.path.basename(lib._name).startswith("libwdtfastdata_")


def test_serving_needs_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    """The serving entry points run on the card unless the caller asks for
    the CPU: without one they raise naming CUDA before reading anything."""
    from wide_deep_tpu_torch.serving.export import load_bundle
    from wide_deep_tpu_torch.serving.server import ServingModel
    from wide_deep_tpu_torch.tools import (bench_serving,
                                           microbench_serving_latency, serve)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    missing = str(tmp_path / "no_bundle" / "1")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingModel(missing)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_bundle(missing)
    (tmp_path / "versions" / "1").mkdir(parents=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--model_base_path", str(tmp_path / "versions"),
                    "--port", "0"])
    for tool in (bench_serving, microbench_serving_latency):
        with pytest.raises(RuntimeError, match="CUDA"):
            tool.main(["--bundle_dir", missing])


def test_port_builds_its_own_serving_client():
    """The C++ client is compiled from cpp/serving_client.cc with
    cpp/Makefile's CXXFLAGS (a program: no -shared) into build/native/; the
    binary committed in cpp/ is never run."""
    import re

    from wide_deep_tpu_torch.serving import client
    assert client.CLIENT_SOURCE == os.path.join(REPO, "cpp",
                                                "serving_client.cc")
    with open(os.path.join(REPO, "cpp", "Makefile")) as f:
        flags = re.search(r"^CXXFLAGS \?= (.*)$", f.read(), re.M).group(1)
    assert client.CLIENT_FLAGS == tuple(flags.split())
    assert "-shared" not in client.CLIENT_FLAGS
    committed = os.path.join("cpp", "serving_client") + "'"
    for path in _port_files():
        with open(path) as f:
            text = f.read()
        assert committed not in text and '"cpp", "serving_client")' \
            not in text, path


NEW_MODULES = ("wide_deep_tpu_torch.features.stream",
               "wide_deep_tpu_torch.tools.stream_server",
               "wide_deep_tpu_torch.optim.sparse",
               "wide_deep_tpu_torch.training.step")


def test_stream_and_defer_modules_stand_alone():
    """The stream and the stream server are scanned by the tests above,
    and importing them (with the optimizers and the step) loads neither
    JAX nor the JAX package."""
    files = {os.path.relpath(p, REPO) for p in _port_files()}
    for mod in NEW_MODULES:
        assert mod.replace(".", "/") + ".py" in files, mod
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in NEW_MODULES)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'optax', 'wide_deep_tpu')]\n"
              "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr


TOOL_MODULES = ("wide_deep_tpu_torch.tools.tls_proxy",
                "wide_deep_tpu_torch.tools.serving_slo",
                "wide_deep_tpu_torch.tools.quality_onchip",
                "wide_deep_tpu_torch.tools.quality_matrix",
                "wide_deep_tpu_torch.tools.pack_budget_curve")


def test_quality_and_serving_tools_stand_alone():
    """The TLS proxy, the SLO tool and the three quality tools are the
    port's own files (scanned by the tests above; the proxy is a copy of
    tools/tls_proxy.py, not an import of it), and importing them loads
    neither JAX nor the JAX package nor tools/."""
    files = {os.path.relpath(p, REPO) for p in _port_files()}
    for mod in TOOL_MODULES:
        assert mod.replace(".", "/") + ".py" in files, mod
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in TOOL_MODULES)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'optax', 'wide_deep_tpu', 'tools', "
              "'tls_proxy', 'serving_slo', 'quality_matrix')]\n"
              "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("tool,argv", [
    ("serving_slo", ["check"]),
    ("quality_onchip", ["--part", "B"]),
    ("quality_matrix", ["--only", "wide"]),
    ("pack_budget_curve", ["--budgets", "1"]),
    ("microbench_cudnn_determinism", ["--models", "vgg16"]),
])
def test_quality_and_slo_tools_need_cuda_unless_cpu_is_asked(
        monkeypatch, tmp_path, tool, argv):
    """Without a card the tools raise naming CUDA before they read,
    generate or train anything."""
    import importlib
    mod = importlib.import_module(f"wide_deep_tpu_torch.tools.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    extra = (["--work_dir", str(tmp_path / "w")]
             if tool == "quality_matrix" else [])
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(argv + extra)
    assert os.listdir(tmp_path) == []


CNN_MODULES = ("wide_deep_tpu_torch.features.tfrecord",
               "wide_deep_tpu_torch.features.image",
               "wide_deep_tpu_torch.models.cnn",
               "wide_deep_tpu_torch.models.cnn.vgg",
               "wide_deep_tpu_torch.models.cnn.resnet",
               "wide_deep_tpu_torch.tools.create_record",
               "wide_deep_tpu_torch.tools.microbench_cudnn_determinism")


def test_cnn_modules_stand_alone():
    """The CNN arm, its TFRecord and image pipeline, create_record and the
    deterministic-cuDNN probe are the port's own files (scanned by the tests above), and importing them
    loads neither JAX, the JAX package (not even its JAX-free tfrecord and
    image modules) nor PIL, which only create_record's main needs."""
    files = {os.path.relpath(p, REPO) for p in _port_files()}
    for mod in CNN_MODULES:
        path = mod.replace(".", "/")
        assert path + ".py" in files or path + "/__init__.py" in files, mod
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in CNN_MODULES)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'optax', 'wide_deep_tpu', 'PIL')]\n"
              "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
