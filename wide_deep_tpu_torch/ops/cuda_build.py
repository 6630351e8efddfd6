"""Build and load the port's hand-written CUDA kernels at first use.

Every kernel lives in one ``csrc/<name>.cu`` with a plain C interface
(pointers, ints and the stream; each entry returns ``cudaGetLastError()``).
``nvcc`` compiles each source into its own shared library under
``build/kernels/`` at the repo root (listed in ``.gitignore``), named by a
digest of the sources and flags, so an edited kernel is rebuilt and an
unchanged one is reused.  Libraries are loaded with ``ctypes``; nothing here
runs at import time, so the CPU tests import every module without a
compiler.  Building needs ``nvcc`` from the CUDA toolkit: ``$NVCC``, ``nvcc``
on ``PATH`` or ``/usr/local/cuda/bin/nvcc``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "kernels")
SOURCES = ("range_scatter", "window_scatter", "rowdma", "resident_gather",
           "bulk_row_scatter", "optim_sweep")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are compiled from "
                       f"{CSRC_DIR} at first use (set $NVCC)")


def library_path(name: str) -> str:
    """build/kernels/lib<name>_<digest>.so for the current sources."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))) + [
            os.path.join(CSRC_DIR, f"{name}.cu")]:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:12]}.so")


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every listed kernel whose library is missing: one ``nvcc``
    per source, all started together.  -> {name: compiler output}."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp,
               os.path.join(CSRC_DIR, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        logs[name] = text
        if proc.returncode:
            failed.append(f"nvcc failed for {name}.cu:\n{text}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(library_path(name))
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a kernel's C entry."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_handle(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
