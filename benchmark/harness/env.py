"""The run's surroundings: when the process started, the card, where
caches and scratch files go, and the check that the measured process
never loaded JAX or the JAX package."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import time
from typing import Dict, List, Optional

from .spec import REPO_ROOT

# top-level module names the measured process may not hold, compared whole:
# the port's own name begins with the JAX package's
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "wide_deep_tpu")


def process_start_time() -> float:
    """The wall-clock time at which this process started (Linux:
    /proc/self/stat's start time after boot plus /proc/stat's boot time),
    else now."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        ticks = int(fields[19])
        with open("/proc/stat") as f:
            btime = next(int(ln.split()[1]) for ln in f
                         if ln.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def forbidden_loaded() -> List[str]:
    """The forbidden top-level names present in ``sys.modules``."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (build/ is not committed): the program's own builds already go to
    build/kernels and build/native; torch and Triton are pointed there
    too.  JAX is kept out of libraries that would load it."""
    base = os.path.join(REPO_ROOT, "build", "bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    # torch.cuda.is_available() by NVML, without creating a CUDA context:
    # the row generator forks its workers after the look for a card
    os.environ.setdefault("PYTORCH_NVML_BASED_CUDA_CHECK", "1")


def scratch_dir(cell: str) -> str:
    """A directory for this run's generated files under ``$TMPDIR``
    (fixed name per cell, emptied first)."""
    import tempfile
    path = os.path.join(tempfile.gettempdir(), f"wdt_bench_{cell}")
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def card(device_index: int = 0) -> Dict[str, object]:
    """The card's name as torch gives it and its power limit as nvidia-smi
    gives it ("not measured" without nvidia-smi)."""
    import torch
    out: Dict[str, object] = {
        "platform": "gpu", "kind": torch.cuda.get_device_name(device_index)}
    limit: Optional[str] = None
    exe = shutil.which("nvidia-smi")
    if exe:
        r = subprocess.run([exe, "--query-gpu=power.limit",
                            "--format=csv,noheader", "-i", str(device_index)],
                           capture_output=True, text=True, timeout=60)
        if r.returncode == 0 and r.stdout.strip():
            limit = r.stdout.strip().splitlines()[0].strip()
    out["power_limit"] = limit or "not measured"
    return out


def require_cards(n: int) -> None:
    """Exit 1 unless torch sees at least ``n`` CUDA cards."""
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures the card and never "
              "falls back to the CPU", file=sys.stderr)
        sys.exit(1)
    if torch.cuda.device_count() < n:
        print(f"the cell needs {n} cards, torch sees "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        sys.exit(1)
