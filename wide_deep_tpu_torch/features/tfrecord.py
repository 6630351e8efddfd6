"""Minimal TFRecord + tf.train.Example codec with no TensorFlow (the port's
copy of the JAX package's ``features/tfrecord.py``; pure Python and numpy,
the same bytes read and written).

The reference stores images as TFRecord files of serialized Examples with a
single bytes feature ``image`` holding raw uint8 pixels (its
python/lib/utils/create_record.py:14-27, read back at dataset.py:215-245).
This module reads and writes that wire format:

* TFRecord framing: <u64 length> <u32 masked-crc(length)> <payload>
  <u32 masked-crc(payload)>, crc32c with the TF mask rotation.
* protobuf Example: field 1 = Features; Features field 1 = map<string,
  Feature>; Feature field 1/2/3 = bytes_list/float_list/int64_list.

Only the subset the framework needs is implemented; unknown fields are
skipped per proto wire rules.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Union

import numpy as np

from wide_deep_tpu_torch.features import fs

FeatureValue = Union[List[bytes], List[float], List[int]]

# ------------------------------------------------------------------- crc32c
_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE:
        return _CRC_TABLE
    poly = 0x82F63B78
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    _CRC_TABLE = table
    return table


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------ TFRecord frame
def read_records(path: str, verify: bool = False) -> Iterator[bytes]:
    with fs.open_bytes(path) as f:
        while True:
            header = f.read(12)
            if not header:
                return  # clean EOF on a record boundary
            if len(header) < 12:
                raise IOError(
                    f"{path}: truncated record header ({len(header)} of "
                    f"12 bytes) — file cut mid-record")
            (length,) = struct.unpack("<Q", header[:8])
            payload = f.read(length)
            crc = f.read(4)
            if len(payload) < length or len(crc) < 4:
                # the reference reader raised DataLossError here; silently
                # treating it as EOF would drop the dataset's tail with no
                # signal (partial copy, disk-full write)
                raise IOError(
                    f"{path}: truncated record payload "
                    f"({len(payload)}/{length} bytes) — file cut "
                    f"mid-record")
            if verify:
                (want,) = struct.unpack("<I", header[8:12])
                if masked_crc(header[:8]) != want:
                    raise IOError(f"{path}: bad length crc")
                (want,) = struct.unpack("<I", crc)
                if masked_crc(payload) != want:
                    raise IOError(f"{path}: bad payload crc")
            yield payload


def write_records(path: str, payloads: Iterator[bytes]) -> int:
    n = 0
    with open(path, "wb") as f:
        for payload in payloads:
            header = struct.pack("<Q", len(payload))
            f.write(header)
            f.write(struct.pack("<I", masked_crc(header)))
            f.write(payload)
            f.write(struct.pack("<I", masked_crc(payload)))
            n += 1
    return n


def record_offsets(path: str):
    """One header-only pass -> [(payload_offset, length), ...] enabling
    RANDOM ACCESS into a TFRecord file (features/image.ImageCsvDataset
    pairs image k with csv row k by index instead of praying two
    independent shuffles agree)."""
    out = []
    with fs.open_bytes(path) as f:
        pos = 0
        while True:
            header = f.read(12)
            if not header:
                return out
            if len(header) < 12:
                raise IOError(f"{path}: truncated record header")
            (length,) = struct.unpack("<Q", header[:8])
            out.append((pos + 12, length))
            pos += 12 + length + 4
            f.seek(pos)


def read_record_at(f, offset: int, length: int) -> bytes:
    """Read one record payload from an open binary file by
    record_offsets() coordinates."""
    f.seek(offset)
    payload = f.read(length)
    if len(payload) < length:
        raise IOError("truncated record payload")
    return payload


# --------------------------------------------------------------- proto codec
def _to_signed64(v: int) -> int:
    """Varints are unsigned on the wire; Int64List values are SIGNED —
    without this, -1 decodes as 2**64-1 (np.int64 conversion overflows)."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _read_varint(buf: bytes, pos: int):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(out: bytearray, value: int):
    # negative ints encode as 64-bit two's complement (the 10-byte proto
    # varint) — Python's arithmetic right shift on a negative value never
    # reaches 0, so the raw loop would spin forever on e.g. label -1
    if value < 0:
        value &= (1 << 64) - 1
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _skip_field(buf: bytes, pos: int, wire: int) -> int:
    if wire == 0:
        _, pos = _read_varint(buf, pos)
    elif wire == 1:
        pos += 8
    elif wire == 2:
        n, pos = _read_varint(buf, pos)
        pos += n
    elif wire == 5:
        pos += 4
    else:
        raise IOError(f"unsupported wire type {wire}")
    return pos


def _parse_feature(buf: bytes) -> FeatureValue:
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:  # BytesList
            n, pos = _read_varint(buf, pos)
            sub, out = buf[pos:pos + n], []
            pos += n
            sp = 0
            while sp < len(sub):
                t, sp = _read_varint(sub, sp)
                if t >> 3 == 1 and t & 7 == 2:
                    ln, sp = _read_varint(sub, sp)
                    out.append(sub[sp:sp + ln])
                    sp += ln
                else:
                    sp = _skip_field(sub, sp, t & 7)
            return out
        if field == 2 and wire == 2:  # FloatList (packed)
            n, pos = _read_varint(buf, pos)
            sub = buf[pos:pos + n]
            pos += n
            vals: List[float] = []
            sp = 0
            while sp < len(sub):
                t, sp = _read_varint(sub, sp)
                if t >> 3 == 1 and t & 7 == 2:
                    ln, sp = _read_varint(sub, sp)
                    vals += list(struct.unpack(f"<{ln // 4}f",
                                               sub[sp:sp + ln]))
                    sp += ln
                elif t >> 3 == 1 and t & 7 == 5:
                    vals.append(struct.unpack("<f", sub[sp:sp + 4])[0])
                    sp += 4
                else:
                    sp = _skip_field(sub, sp, t & 7)
            return vals
        if field == 3 and wire == 2:  # Int64List (packed)
            n, pos = _read_varint(buf, pos)
            sub = buf[pos:pos + n]
            pos += n
            vals_i: List[int] = []
            sp = 0
            while sp < len(sub):
                t, sp = _read_varint(sub, sp)
                if t >> 3 == 1 and t & 7 == 2:
                    ln, sp = _read_varint(sub, sp)
                    end = sp + ln
                    while sp < end:
                        v, sp = _read_varint(sub, sp)
                        vals_i.append(_to_signed64(v))
                elif t >> 3 == 1 and t & 7 == 0:
                    v, sp = _read_varint(sub, sp)
                    vals_i.append(_to_signed64(v))
                else:
                    sp = _skip_field(sub, sp, t & 7)
            return vals_i
        pos = _skip_field(buf, pos, wire)
    return []


def parse_example(payload: bytes) -> Dict[str, FeatureValue]:
    """Serialized tf.train.Example -> {name: bytes/float/int list}."""
    out: Dict[str, FeatureValue] = {}
    pos = 0
    while pos < len(payload):
        tag, pos = _read_varint(payload, pos)
        if tag >> 3 == 1 and tag & 7 == 2:  # Features
            n, pos = _read_varint(payload, pos)
            feats = payload[pos:pos + n]
            pos += n
            fp = 0
            while fp < len(feats):
                t, fp = _read_varint(feats, fp)
                if t >> 3 == 1 and t & 7 == 2:  # map entry
                    ln, fp = _read_varint(feats, fp)
                    entry = feats[fp:fp + ln]
                    fp += ln
                    key, val = None, []
                    ep = 0
                    while ep < len(entry):
                        et, ep = _read_varint(entry, ep)
                        if et >> 3 == 1 and et & 7 == 2:
                            kl, ep = _read_varint(entry, ep)
                            key = entry[ep:ep + kl].decode("utf-8")
                            ep += kl
                        elif et >> 3 == 2 and et & 7 == 2:
                            vl, ep = _read_varint(entry, ep)
                            val = _parse_feature(entry[ep:ep + vl])
                            ep += vl
                        else:
                            ep = _skip_field(entry, ep, et & 7)
                    if key is not None:
                        out[key] = val
                else:
                    fp = _skip_field(feats, fp, t & 7)
        else:
            pos = _skip_field(payload, pos, tag & 7)
    return out


def _encode_feature(value: FeatureValue) -> bytes:
    body = bytearray()
    if value and isinstance(value[0], bytes):
        sub = bytearray()
        for b in value:
            sub.append(0x0A)
            _write_varint(sub, len(b))
            sub += b
        body.append(0x0A)
    elif value and isinstance(value[0], (float, np.floating)):
        # np.floating matters: np.float32 is NOT a subclass of float, and
        # the int fallthrough would silently truncate 0.7 -> 0
        sub = bytearray()
        sub.append(0x0A)
        packed = struct.pack(f"<{len(value)}f", *value)
        _write_varint(sub, len(packed))
        sub += packed
        body.append(0x12)
    else:
        sub = bytearray()
        sub.append(0x0A)
        ints = bytearray()
        for v in value:
            _write_varint(ints, int(v))
        _write_varint(sub, len(ints))
        sub += ints
        body.append(0x1A)
    _write_varint(body, len(sub))
    body += sub
    return bytes(body)


def serialize_example(features: Dict[str, FeatureValue]) -> bytes:
    feats = bytearray()
    for key, value in features.items():
        kb = key.encode("utf-8")
        fv = _encode_feature(value)
        entry = bytearray()
        entry.append(0x0A)
        _write_varint(entry, len(kb))
        entry += kb
        entry.append(0x12)
        _write_varint(entry, len(fv))
        entry += fv
        feats.append(0x0A)
        _write_varint(feats, len(entry))
        feats += entry
    out = bytearray()
    out.append(0x0A)
    _write_varint(out, len(feats))
    out += feats
    return bytes(out)
