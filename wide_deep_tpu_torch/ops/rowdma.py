"""K3 and P2: in-place scatter-assign of sorted-unique rows into a table.

**K3** ``rowdma_scatter_rows`` replaces
wide_deep_tpu/ops/rowdma.py::rowdma_scatter_rows, the Pallas
kernel that writes the fused sparse optimizer's updated rows back with one
DMA per row.  The port's kernel (csrc/rowdma.cu) gives each float4 of the
rows one thread, in row order: a 128-wide row is one warp whose 32 lanes
move one float4 each, one 512-byte row per warp, read and written
coalesced.  It is bound by bytes on the card (each touched row read once
and written once).

The [rows, 128] float32 layout (param + optimizer slots side by side, zero
padding after them) is the JAX package's, forced there by the TPU's DMA
engine; the port keeps it for every table whose live columns fit 128, so
the parameter trees of the two packages match leaf by leaf.  A
RowwiseAdagrad table, which the JAX package has not, takes its own width,
its live columns rounded up to whole float4s (optim/sparse.fused_width);
K3 takes any width that is a multiple of 4.

**P2** ``bulk_scatter_rows`` replaces the Pallas probe
tools/microbench_rowdma_scatter.py::kernel_scatter (one HBM->HBM row DMA
per uid, ring of 32 semaphores), which measures the other design K3 can
take: csrc/bulk_row_scatter.cu stages the rows through shared memory with
Hopper's bulk-copy unit (``cp.async.bulk``).  A warp owns 32 uids, one lane
per row: one bulk load brings the chunk's live rows (contiguous, since the
uids are sorted) into the warp's slab on its mbarrier, and after one wait
every lane stores its own row to the table with a bulk copy of its own.
It takes any width whose row is a multiple of 16 bytes, up to
BULK_MAX_ROW_BYTES, in float32 or bfloat16.  K3 stays the train step's
write-back.

Both share the plain version (masked index assignment, any width and
dtype).  ``rowdma_launches`` and ``bulk_scatter_launches`` count kernel
launches; CPU tensors take the plain version and count nothing.
"""

from __future__ import annotations

import ctypes

import torch

from wide_deep_tpu_torch.ops import cuda_build

FUSED_WIDTH = 128   # float32 columns of a fused sparse-optimizer table
                    # whose live columns fit it (optim/sparse.fused_width)
BULK_ROW_ALIGN = 16         # bytes: the bulk-copy unit's size and address unit
BULK_MAX_ROW_BYTES = 7168   # two rows in a warp's 16 KB slab
                            # (csrc/bulk_row_scatter.cu kMaxRowBytes, which
                            # kernel_bulk_max_row_bytes reads)

rowdma_launches = 0
rowdma_launches_by_width: dict = {}     # K3's launches by row width
bulk_scatter_launches = 0


def rowdma_scatter_rows_plain(table: torch.Tensor, uids: torch.Tensor,
                              new_rows: torch.Tensor) -> torch.Tensor:
    """K3's and P2's plain version: ``table[uids] = new_rows`` for uids in
    [0, rows); other uids (sentinel padding) are skipped.  In place."""
    keep = (uids >= 0) & (uids < table.shape[0])
    table[uids[keep].long()] = new_rows[keep]
    return table


def _lib():
    fn = cuda_build.library("rowdma").wdt_rowdma_scatter_rows
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, ctypes.c_longlong, p, p, ctypes.c_int,
                       ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def rowdma_scatter_rows(table: torch.Tensor, uids: torch.Tensor,
                        new_rows: torch.Tensor) -> torch.Tensor:
    """Write ``new_rows`` [N, W] float32 into ``table`` [R, W] float32 at
    ``uids`` [N] int32 (sorted unique; out-of-range entries skipped), in
    place, for a width W that is a multiple of 4 (128 for every table but
    a RowwiseAdagrad one); returns ``table``.  CUDA tensors launch
    csrc/rowdma.cu on the current stream."""
    global rowdma_launches
    dev = table.device
    width = table.shape[1] if table.dim() == 2 else 0
    if width <= 0 or width % 4:
        raise ValueError(f"table must be [R, W] with W a positive multiple "
                         f"of 4, got {tuple(table.shape)}")
    for name, t in (("table", table), ("new_rows", new_rows)):
        if (t.dim() != 2 or t.shape[1] != width
                or t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != dev):
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"[*, {width}] tensor on {dev}")
    n = new_rows.shape[0]
    if (uids.dtype != torch.int32 or uids.shape != (n,)
            or not uids.is_contiguous() or uids.device != dev):
        raise ValueError(f"uids must be contiguous int32 [{n}] on {dev}")
    if dev.type == "cpu":
        return rowdma_scatter_rows_plain(table, uids, new_rows)
    if dev.type != "cuda":
        raise ValueError(f"rowdma_scatter_rows: unsupported device {dev}")
    err = _lib()(table.data_ptr(), table.shape[0], uids.data_ptr(),
                 new_rows.data_ptr(), n, width,
                 cuda_build.stream_handle(dev))
    cuda_build.check(err, "rowdma_scatter_rows")
    rowdma_launches += 1
    rowdma_launches_by_width[width] = (
        rowdma_launches_by_width.get(width, 0) + 1)
    return table


def _lib_bulk():
    fn = cuda_build.library("bulk_row_scatter").wdt_bulk_row_scatter
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, ctypes.c_longlong, p, p, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def kernel_bulk_max_row_bytes() -> int:
    """The widest row csrc/bulk_row_scatter.cu takes (BULK_MAX_ROW_BYTES
    must agree with it); builds the kernel library."""
    fn = cuda_build.library("bulk_row_scatter").wdt_bulk_max_row_bytes
    fn.restype = ctypes.c_int
    return fn()


def bulk_scatter_rows(table: torch.Tensor, uids: torch.Tensor,
                      rows: torch.Tensor) -> torch.Tensor:
    """P2: write ``rows`` [N, D] into ``table`` [R, D] at ``uids`` [N] int32
    (sorted unique; uids outside [0, R) skipped, as ``mode="drop"`` skips
    them -- a negative uid too, which jnp's ``.at[]`` would wrap), in place;
    returns ``table``.  Both float32 or both bfloat16, contiguous, on one
    device, with D x element size a multiple of 16 bytes.  CUDA tensors
    launch csrc/bulk_row_scatter.cu on the current stream: a warp per 32
    uids, one bulk load of their rows, a bulk store per row."""
    global bulk_scatter_launches
    dev = table.device
    if (table.dim() != 2 or table.dtype not in (torch.float32, torch.bfloat16)
            or not table.is_contiguous()):
        raise ValueError("table must be a contiguous float32 or bfloat16 "
                         "[R, D] tensor")
    d = table.shape[1]
    if (rows.dim() != 2 or rows.shape[1] != d or rows.dtype != table.dtype
            or not rows.is_contiguous() or rows.device != dev):
        raise ValueError(f"rows must be a contiguous {table.dtype} [N, {d}] "
                         f"tensor on {dev}, as table")
    n = rows.shape[0]
    if (uids.dtype != torch.int32 or uids.shape != (n,)
            or not uids.is_contiguous() or uids.device != dev):
        raise ValueError(f"uids must be contiguous int32 [{n}] on {dev}")
    row_bytes = d * table.element_size()
    if row_bytes % BULK_ROW_ALIGN or not 0 < row_bytes <= BULK_MAX_ROW_BYTES:
        raise ValueError(f"a row of {row_bytes} bytes: the bulk-copy unit "
                         f"moves multiples of {BULK_ROW_ALIGN} bytes, at most "
                         f"{BULK_MAX_ROW_BYTES} here")
    if dev.type == "cpu":
        return rowdma_scatter_rows_plain(table, uids, rows)
    if dev.type != "cuda":
        raise ValueError(f"bulk_scatter_rows: unsupported device {dev}")
    if table.data_ptr() % BULK_ROW_ALIGN or rows.data_ptr() % BULK_ROW_ALIGN:
        raise ValueError(f"table and rows must start on {BULK_ROW_ALIGN}-byte "
                         f"boundaries")
    if n:
        err = _lib_bulk()(table.data_ptr(), table.shape[0], uids.data_ptr(),
                          rows.data_ptr(), n, row_bytes,
                          cuda_build.stream_handle(dev))
        cuda_build.check(err, "bulk_scatter_rows")
        bulk_scatter_launches += 1
    return table
