"""Deterministic feature hashing for wide_deep_tpu_torch.

The port's own copy of ``wide_deep_tpu/features/hashing.py``; the two must
stay bit-identical (the loaders of both packages emit the same ids).

The reference relies on TensorFlow's FarmHash-based ``Fingerprint64`` for
``categorical_column_with_hash_bucket`` and ``FingerprintCat64`` chaining for
``crossed_column`` (reference python/lib/build_estimator.py:83-92,158).  We
deliberately target *metric-level* parity (AUC/logloss), not bucket-level
parity, so this module defines its own fully documented hash stack:

* ``fingerprint64(bytes)`` — XXH64 (public xxHash spec, seed 0).  Implemented
  in pure Python here and identically in C++ (csrc/fastdata.cc); the test suite
  pins both to the published xxHash test vectors.
* ``combine64(a, b)`` — an order-sensitive 64-bit mixing chain used to fold
  member fingerprints of a crossed feature into one fingerprint.  Expressible
  in vectorized numpy uint64 arithmetic (wrap-around semantics) so crosses of
  already-hashed members cost no per-string work.

Bucketing is ``fingerprint % bucket_size`` in all cases, matching the
reference's modulo scheme.
"""

from __future__ import annotations

from typing import Iterable, List

import numpy as np

_M = (1 << 64) - 1
_P1 = 0x9E3779B185EBCA87
_P2 = 0xC2B2AE3D27D4EB4F
_P3 = 0x165667B19E3779F9
_P4 = 0x85EBCA77C2B2AE63
_P5 = 0x27D4EB2F165667C5


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & _M
    acc = _rotl(acc, 31)
    return (acc * _P1) & _M


def _merge_round(acc: int, val: int) -> int:
    acc ^= _round(0, val)
    return (acc * _P1 + _P4) & _M


def fingerprint64(data: bytes, seed: int = 0) -> int:
    """XXH64 of ``data`` (xxHash 64-bit, reference spec, default seed 0)."""
    n = len(data)
    pos = 0
    if n >= 32:
        v1 = (seed + _P1 + _P2) & _M
        v2 = (seed + _P2) & _M
        v3 = seed & _M
        v4 = (seed - _P1) & _M
        while pos + 32 <= n:
            v1 = _round(v1, int.from_bytes(data[pos:pos + 8], "little"))
            v2 = _round(v2, int.from_bytes(data[pos + 8:pos + 16], "little"))
            v3 = _round(v3, int.from_bytes(data[pos + 16:pos + 24], "little"))
            v4 = _round(v4, int.from_bytes(data[pos + 24:pos + 32], "little"))
            pos += 32
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M
        h = _merge_round(h, v1)
        h = _merge_round(h, v2)
        h = _merge_round(h, v3)
        h = _merge_round(h, v4)
    else:
        h = (seed + _P5) & _M
    h = (h + n) & _M
    while pos + 8 <= n:
        k1 = _round(0, int.from_bytes(data[pos:pos + 8], "little"))
        h ^= k1
        h = (_rotl(h, 27) * _P1 + _P4) & _M
        pos += 8
    if pos + 4 <= n:
        h ^= (int.from_bytes(data[pos:pos + 4], "little") * _P1) & _M
        h = (_rotl(h, 23) * _P2 + _P3) & _M
        pos += 4
    while pos < n:
        h ^= (data[pos] * _P5) & _M
        h = (_rotl(h, 11) * _P1) & _M
        pos += 1
    h ^= h >> 33
    h = (h * _P2) & _M
    h ^= h >> 29
    h = (h * _P3) & _M
    h ^= h >> 32
    return h


def fingerprint64_str(value: str, seed: int = 0) -> int:
    return fingerprint64(value.encode("utf-8"), seed)


def hash_bucket(value: str, bucket_size: int) -> int:
    """String -> bucket id, the hash_bucket categorical transform."""
    return fingerprint64_str(value) % bucket_size


def combine64(acc, val):
    """Fold ``val`` into running cross fingerprint ``acc`` (order-sensitive).

    Defined over Python ints *and* numpy uint64 arrays (wrap-around math).
    mix(a, b) = rotl64(a ^ (b * P2), 31) * P1
    """
    if isinstance(acc, np.ndarray) or isinstance(val, np.ndarray):
        acc = np.asarray(acc, dtype=np.uint64)
        val = np.asarray(val, dtype=np.uint64)
        with np.errstate(over="ignore"):
            x = acc ^ (val * np.uint64(_P2))
            x = (x << np.uint64(31)) | (x >> np.uint64(33))
            return x * np.uint64(_P1)
    x = (acc ^ ((val * _P2) & _M)) & _M
    return (_rotl(x, 31) * _P1) & _M


def cross_fingerprint(member_fps: Iterable[int]) -> int:
    """Chain member fingerprints into the crossed-feature fingerprint."""
    acc = _P5
    for fp in member_fps:
        acc = combine64(acc, fp)
    return acc


def cross_bucket(member_fps: Iterable[int], bucket_size: int) -> int:
    return cross_fingerprint(member_fps) % bucket_size


# ----------------------------------------------------------- batch helpers
_CROSS_SEED = np.uint64(_P5)


def cross_fingerprint_np(member_fp_columns: List[np.ndarray]) -> np.ndarray:
    """Vectorized cross fingerprints.

    ``member_fp_columns``: list of equal-shape uint64 arrays (one per member,
    already expanded to the cartesian-product layout). Returns uint64 array.
    """
    acc = np.full_like(member_fp_columns[0], _CROSS_SEED, dtype=np.uint64)
    for col in member_fp_columns:
        acc = combine64(acc, col)
    return acc
