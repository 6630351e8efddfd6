"""K3: in-place scatter-assign of sorted-unique rows into a fused table.

Replaces wide_deep_tpu/ops/rowdma.py::rowdma_scatter_rows, the Pallas
kernel that writes the fused sparse optimizer's updated rows back with one
DMA per row.  The port's kernel (csrc/rowdma.cu) gives each uid one warp
whose 32 lanes move one float4 each: one 512-byte row per warp, read and
written coalesced.  It is bound by bytes on the card (each touched row read
once and written once).

The [rows, 128] float32 layout (param + optimizer slots side by side, zero
padding after them) is the JAX package's, forced there by the TPU's DMA
engine; the port keeps it so the parameter trees of the two packages match
leaf by leaf.

``rowdma_launches`` counts kernel launches; CPU tensors take the plain
version (masked index assignment) and count nothing.
"""

from __future__ import annotations

import ctypes

import torch

from wide_deep_tpu_torch.ops import cuda_build

FUSED_WIDTH = 128   # float32 columns of a fused sparse-optimizer table

rowdma_launches = 0


def rowdma_scatter_rows_plain(table: torch.Tensor, uids: torch.Tensor,
                              new_rows: torch.Tensor) -> torch.Tensor:
    """K3's plain version: ``table[uids] = new_rows`` for uids in
    [0, rows); other uids (sentinel padding) are skipped.  In place."""
    keep = (uids >= 0) & (uids < table.shape[0])
    table[uids[keep].long()] = new_rows[keep]
    return table


def _lib():
    fn = cuda_build.library("rowdma").wdt_rowdma_scatter_rows
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, ctypes.c_longlong, p, p, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def rowdma_scatter_rows(table: torch.Tensor, uids: torch.Tensor,
                        new_rows: torch.Tensor) -> torch.Tensor:
    """Write ``new_rows`` [N, 128] float32 into ``table`` [R, 128] float32
    at ``uids`` [N] int32 (sorted unique; out-of-range entries skipped), in
    place; returns ``table``.  CUDA tensors launch csrc/rowdma.cu on the
    current stream."""
    global rowdma_launches
    dev = table.device
    for name, t in (("table", table), ("new_rows", new_rows)):
        if (t.dim() != 2 or t.shape[1] != FUSED_WIDTH
                or t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != dev):
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"[*, {FUSED_WIDTH}] tensor on {dev}")
    n = new_rows.shape[0]
    if (uids.dtype != torch.int32 or uids.shape != (n,)
            or not uids.is_contiguous() or uids.device != dev):
        raise ValueError(f"uids must be contiguous int32 [{n}] on {dev}")
    if dev.type == "cpu":
        return rowdma_scatter_rows_plain(table, uids, new_rows)
    if dev.type != "cuda":
        raise ValueError(f"rowdma_scatter_rows: unsupported device {dev}")
    err = _lib()(table.data_ptr(), table.shape[0], uids.data_ptr(),
                 new_rows.data_ptr(), n, cuda_build.stream_handle(dev))
    cuda_build.check(err, "rowdma_scatter_rows")
    rowdma_launches += 1
    return table
