"""P1: row gather from a resident pool, scaled per row.

Replaces tools/microbench_vmem_gather.py::kernel_gather, the Pallas probe
that holds a pooled gradient ``dpool`` [B, D] whole in VMEM and gathers
1024 of its rows per grid step: ``out[i] = w[i] * dpool[seg[i]]``.  It asks
whether a scatter kernel could build its id-sorted gradient from the small
pooled one instead of reading a gradient written out in full; Mosaic could
not lower the gather.  The port's kernel (csrc/resident_gather.cu) keeps
``dpool`` in the card's L2 cache instead and is bound by bytes: seg, w and
out stream through once.

Out-of-range ``seg`` follows jnp's ``x[idx]``, in the kernel and in the
plain version alike: a negative index wraps once, then it is clamped to
[0, B).  Every one of the n rows is written.

``resident_gather_launches`` counts kernel launches; CPU tensors take the
plain version and count nothing.
"""

from __future__ import annotations

import ctypes

import torch

from wide_deep_tpu_torch.ops import cuda_build

resident_gather_launches = 0


def resident_gather_plain(seg: torch.Tensor, w: torch.Tensor,
                          dpool: torch.Tensor) -> torch.Tensor:
    """P1's plain version: ``dpool[seg] * w[:, None]`` with jnp's index
    rules (wrap a negative index once, then clamp)."""
    b = dpool.shape[0]
    idx = seg.long()
    idx = torch.where(idx < 0, idx + b, idx).clamp_(0, b - 1)
    return dpool[idx] * w[:, None]


def _lib():
    fn = cuda_build.library("resident_gather").wdt_resident_gather
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_int, p, p]
        fn.restype = ctypes.c_int
    return fn


def resident_gather(seg: torch.Tensor, w: torch.Tensor,
                    dpool: torch.Tensor) -> torch.Tensor:
    """``out[i] = w[i] * dpool[seg[i]]`` -> a new float32 [n, D] tensor, for
    seg int32 [n], w float32 [n], dpool float32 [B, D], all contiguous on
    one device.  CPU tensors take the plain version; CUDA tensors launch
    csrc/resident_gather.cu on the current stream."""
    global resident_gather_launches
    dev = dpool.device
    if (dpool.dim() != 2 or dpool.dtype != torch.float32
            or not dpool.is_contiguous()):
        raise ValueError("dpool must be a contiguous float32 [B, D] tensor")
    if (seg.dim() != 1 or seg.dtype != torch.int32
            or not seg.is_contiguous() or seg.device != dev):
        raise ValueError(f"seg must be a contiguous int32 [n] tensor on {dev}")
    n = seg.shape[0]
    if (w.shape != (n,) or w.dtype != torch.float32
            or not w.is_contiguous() or w.device != dev):
        raise ValueError(f"w must be a contiguous float32 [{n}] tensor on "
                         f"{dev}")
    b, d = dpool.shape
    if n and not b:
        raise ValueError("dpool has no rows to gather from")
    if dev.type == "cpu":
        return resident_gather_plain(seg, w, dpool)
    if dev.type != "cuda":
        raise ValueError(f"resident_gather: unsupported device {dev}")
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    if n and d:
        vec4 = d % 4 == 0 and dpool.data_ptr() % 16 == 0
        err = _lib()(seg.data_ptr(), w.data_ptr(), dpool.data_ptr(), b, d, n,
                     int(vec4), out.data_ptr(), cuda_build.stream_handle(dev))
        cuda_build.check(err, "resident_gather")
        resident_gather_launches += 1
    return out
