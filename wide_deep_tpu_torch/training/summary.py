"""TensorBoard event-file writer (no TensorFlow dependency): the port's copy
of the JAX package's ``training/summary.py``, with its own crc32c.

Parity target: the reference's per-layer summaries + scalar logging via
``add_layer_summary`` (its python/lib/utils/model_util.py:15-17, called from
dnn.py/joint.py) with cadence ``save_summary_steps`` (conf/train.yaml:93),
viewable with ``tensorboard --logdir``.

Event files are TFRecord streams of ``Event`` protos: <u64 length> <u32
masked-crc(length)> <payload> <u32 masked-crc(payload)>, crc32c with the TF
mask rotation.  The writer encodes the subset TensorBoard's scalar and
histogram dashboards read; ``read_records`` reads the framing back.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np

# ------------------------------------------------------------------- crc32c
_CRC_TABLE: List[int] = []


def _crc_table() -> List[int]:
    if not _CRC_TABLE:
        poly = 0x82F63B78
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def read_records(path: str) -> Iterator[bytes]:
    """The payloads of a TFRecord file, every crc checked."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if not header:
                return
            if len(header) != 8:
                raise IOError(f"{path}: truncated record header")
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            if hcrc != masked_crc(header):
                raise IOError(f"{path}: bad length crc")
            payload = f.read(length)
            (pcrc,) = struct.unpack("<I", f.read(4))
            if len(payload) != length or pcrc != masked_crc(payload):
                raise IOError(f"{path}: bad or truncated record")
            yield payload


# -------------------------------------------------------------- proto wire
def _varint(value: int) -> bytes:
    # negative ints encode as 64-bit two's complement — Python's
    # arithmetic right shift never zeroes a negative value, so the raw
    # loop would hang and grow the buffer unboundedly
    if value < 0:
        value &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f64(field: int, value: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", value)


def _f32(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


def _i64(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value)


def _bytes(field: int, value: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(value)) + value


def _packed_f64(field: int, values: Iterable[float]) -> bytes:
    payload = b"".join(struct.pack("<d", v) for v in values)
    return _bytes(field, payload)


def _histogram_proto(values: np.ndarray) -> bytes:
    """HistogramProto with TF's exponential bucket ladder."""
    v = np.asarray(values, np.float64).reshape(-1)
    # drop non-finite values: a diverged tensor's NaNs would make the
    # proto's min/max/sum nan and its count-sum inconsistent, and
    # TensorBoard renders that tag blank for the rest of the run —
    # exactly when the histogram is most needed
    v = v[np.isfinite(v)]
    if v.size == 0:
        v = np.zeros(1)
    limits: List[float] = []
    lim = 1e-12
    while lim < 1e20:
        limits.append(lim)
        lim *= 1.1
    limits = [-l for l in reversed(limits)] + limits + [float("inf")]
    counts, _ = np.histogram(v, bins=[-np.inf] + limits[:-1] + [np.inf])
    # trim empty tails to keep events small
    nz = np.nonzero(counts)[0]
    if nz.size:
        lo, hi = nz[0], nz[-1] + 1
    else:
        lo, hi = 0, 1
    out = (_f64(1, float(v.min())) + _f64(2, float(v.max()))
           + _f64(3, float(v.size)) + _f64(4, float(v.sum()))
           + _f64(5, float(np.square(v).sum()))
           + _packed_f64(6, limits[lo:hi])
           + _packed_f64(7, counts[lo:hi].astype(np.float64)))
    return out


class SummaryWriter:
    """Append-only TensorBoard event file under ``logdir``."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}")
        self._path = os.path.join(logdir, fname)
        self._f = open(self._path, "ab")
        self._write_event(_bytes(3, b"brain.Event:2"))  # file_version

    def _write_event(self, body: bytes, step: Optional[int] = None):
        event = _f64(1, time.time())
        if step is not None:
            event += _i64(2, step)
        event += body
        header = struct.pack("<Q", len(event))
        self._f.write(header)
        self._f.write(struct.pack("<I", masked_crc(header)))
        self._f.write(event)
        self._f.write(struct.pack("<I", masked_crc(event)))

    def scalar(self, tag: str, value: float, step: int):
        val = _bytes(1, tag.encode()) + _f32(2, float(value))
        self._write_event(_bytes(5, _bytes(1, val)), step)

    def scalars(self, values: Dict[str, float], step: int):
        body = b"".join(
            _bytes(1, _bytes(1, tag.encode()) + _f32(2, float(v)))
            for tag, v in values.items())
        self._write_event(_bytes(5, body), step)

    def histogram(self, tag: str, values: np.ndarray, step: int):
        val = _bytes(1, tag.encode()) + _bytes(5, _histogram_proto(values))
        self._write_event(_bytes(5, _bytes(1, val)), step)

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()

    @property
    def path(self) -> str:
        return self._path
