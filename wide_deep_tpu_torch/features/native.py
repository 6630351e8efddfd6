"""The port's binding of the C++ loader (``cpp/fastdata.cc``).

The port's own copy of the JAX package's ``features/native.py``:
``serialize_plan`` turns a FeaturePlan into the binary blob that
``fastdata.cc::parse_plan`` reads (format v12, the two must change
together), and ``NativeTransformer`` packs raw TSV text into a Batch that is
bit-identical to ``pipeline.FeatureTransformer``'s (same xxHash64, same cross
chain, same packing, the same kernel plans) in multithreaded C++.

The library is compiled here from ``cpp/fastdata.cc`` at first use, with the
flags of ``cpp/Makefile``, into ``build/native/libwdtfastdata_<digest>.so``
at the repo root; the committed build in ``cpp/`` is never loaded.  It is
compiled with ``-march=native``, so a library built on one host could stop
another host's process with an illegal instruction: the digest covers the
source, the flags and what ``-march=native`` means to the compiler on this
host.  ``$CXX`` names the compiler (default ``g++``, then ``c++``).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import struct
import subprocess
import threading
import time
import weakref
from typing import Dict, List, Optional, Sequence

import numpy as np

from wide_deep_tpu_torch.features.plan import FeaturePlan

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(REPO_ROOT, "cpp", "fastdata.cc")
BUILD_DIR = os.path.join(REPO_ROOT, "build", "native")
CXX_FLAGS = ("-O3", "-march=native", "-std=c++20", "-fPIC", "-shared",
             "-pthread")

_KIND = {"hash_bucket": 0, "vocab": 1, "identity": 2, "continuous": 3}
_TRAN = {None: 0, "min_max": 1, "standard": 2, "log": 3}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def find_compiler() -> Optional[str]:
    """The C++ compiler: ``$CXX``, else ``g++``, else ``c++`` on PATH;
    None when none is found."""
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    return None


def compiler_names() -> str:
    cxx = os.environ.get("CXX")
    return (f"$CXX={cxx!r}, " if cxx else "") + "g++, c++"


def output_path(cxx: str, source: str, flags: Sequence[str], stem: str,
                ext: str = "") -> str:
    """build/native/<stem>_<digest><ext>: the digest covers the compiler,
    ``flags``, ``source`` and what ``-march=native`` means on this host."""
    h = hashlib.sha1(" ".join((cxx, *flags)).encode())
    with open(source, "rb") as f:
        h.update(f.read())
    # what -march=native resolves to on this host
    target = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True)
    h.update((target.stdout + target.stderr).encode())
    return os.path.join(BUILD_DIR, f"{stem}_{h.hexdigest()[:12]}{ext}")


def compile_cached(source: str, flags: Sequence[str], stem: str,
                   ext: str = "") -> Dict[str, object]:
    """Compile ``source`` with ``flags`` into ``output_path``'s file
    unless this host's build exists.  -> {"path", "built" (False: found),
    "seconds"}.  Processes that build at once take turns on a lock file;
    the output appears under its name only when complete.  Raises with the
    compiler's output when it fails."""
    cxx = find_compiler()
    if cxx is None:
        raise RuntimeError(f"no C++ compiler found ({compiler_names()}): "
                           f"{os.path.basename(source)} is compiled from "
                           f"{source}")
    t0 = time.perf_counter()
    out = output_path(cxx, source, flags, stem, ext)
    os.makedirs(BUILD_DIR, exist_ok=True)
    built = False
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(out):
            tmp = f"{out}.{os.getpid()}.tmp"
            proc = subprocess.run([cxx, *flags, "-o", tmp, source],
                                  capture_output=True, text=True)
            if proc.returncode:
                raise RuntimeError(f"{cxx} failed on {source}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
            built = True
    return {"path": out, "built": built,
            "seconds": time.perf_counter() - t0}


def build() -> Dict[str, object]:
    """Compile ``cpp/fastdata.cc`` unless this host's library exists
    (``compile_cached``)."""
    return compile_cached(SOURCE, CXX_FLAGS, "libwdtfastdata", ".so")


def library() -> ctypes.CDLL:
    """The loaded loader library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build()["path"])
            lib.wdt_plan_create.restype = ctypes.c_void_p
            lib.wdt_plan_create.argtypes = [ctypes.c_char_p, ctypes.c_int64]
            lib.wdt_plan_free.restype = None
            lib.wdt_plan_free.argtypes = [ctypes.c_void_p]
            lib.wdt_transform.restype = ctypes.c_int64
            lib.wdt_transform.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                ctypes.c_double, ctypes.c_double,
                ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_void_p)]
            _lib = lib
        return _lib


def serialize_plan(plan: FeaturePlan) -> bytes:
    """FeaturePlan -> binary blob for wdt_plan_create (format v12).

    All ints int64 LE, floats f64 LE, strings length-prefixed.  Must stay in
    lockstep with cpp/fastdata.cc::parse_plan (the JAX package's
    ``serialize_plan`` gives the same bytes; tests/test_torch_native.py
    holds them equal)."""
    out = bytearray()
    w = out.extend

    def i64(*vals):
        w(struct.pack("<" + "q" * len(vals), *vals))

    def f64(*vals):
        w(struct.pack("<" + "d" * len(vals), *vals))

    def s(text: str):
        b = text.encode("utf-8")
        i64(len(b))
        w(b)

    w(b"WDTP")
    i64(12)
    group_index = {g.dim: gi for gi, g in enumerate(plan.groups)}
    i64(int(plan.scatter_shards))
    i64(len(plan.columns), int(plan.multivalue), int(plan.pack_budget),
        plan.wide_packed_len,
        plan.indicator_total_len, len(plan.continuous_slots),
        len(plan.groups))
    for g in plan.groups:
        i64(g.dim, plan.group_packed_len[g.dim], g.rows)

    feats = plan.feature_order
    feat_index = {name: i for i, name in enumerate(feats)}
    i64(len(feats))
    for name in feats:
        conf = plan.feature_conf[name]
        kind = _KIND[conf["transform"] or "continuous"] \
            if conf["type"] == "category" else 3
        s(name)
        i64(plan.column_index[name], kind)
        if kind == 0:  # hash
            ws = plan.wide_slot_by_name[name]
            _, es = plan.embed_slot_by_name[name]
            i64(ws.max_len, ws.size, ws.offset,
                group_index[es.dim], es.row_offset, es.index,
                int(ws.folded))
        elif kind in (1, 2):  # vocab / identity
            ws = plan.wide_slot_by_name[name]
            isl = next(x for x in plan.indicator_slots if x.name == name)
            i64(ws.max_len, ws.size, ws.offset,
                isl.offset, isl.col_offset)
            if kind == 1:
                for v in isl.vocab:
                    s(v)
        else:  # continuous
            slot = next(x for x in plan.continuous_slots if x.name == name)
            i64(1, _TRAN[slot.transform])
            f64(slot.a, slot.b)
            i64(slot.index, len(slot.boundaries))
            if slot.boundaries:
                f64(*slot.boundaries)
                i64(1, plan.wide_slot_by_name[name].offset)
            else:
                i64(0, 0)

    i64(len(plan.crosses))
    for cs in plan.crosses:
        i64(len(cs.members))
        for m in cs.members:
            i64(feat_index[m.name])
        ws = plan.wide_slot_by_name[cs.name]
        es = plan.embed_slot_by_name.get(cs.name)
        if es is not None:
            _, slot = es
            i64(cs.bucket_size, cs.max_len, ws.offset, 1,
                group_index[slot.dim], slot.row_offset, slot.index,
                int(ws.folded))
        else:
            i64(cs.bucket_size, cs.max_len, ws.offset, 0, 0, 0, 0, 0)
    return bytes(out)


class NativeTransformer:
    """The C++ loader behind FeatureTransformer's ``transform``, plus
    ``transform_text`` over raw TSV lines (the CsvDataset native paths).
    ``n_threads`` 0: one per core, at most 16."""

    def __init__(self, plan: FeaturePlan, n_classes: int = 2,
                 pos_weight: Optional[float] = None,
                 neg_weight: Optional[float] = None,
                 n_threads: int = 0):
        self.plan = plan
        self.n_classes = n_classes
        self.pos_weight = pos_weight
        self.neg_weight = neg_weight
        self.weighted = pos_weight is not None and neg_weight is not None
        self.n_threads = n_threads or min(os.cpu_count() or 1, 16)
        self._lib = library()
        blob = serialize_plan(plan)
        self._plan_handle = self._lib.wdt_plan_create(blob, len(blob))
        if not self._plan_handle:
            raise RuntimeError("wdt_plan_create failed (plan blob rejected)")
        weakref.finalize(self, self._lib.wdt_plan_free, self._plan_handle)

    def transform_text(self, text: bytes, n_rows_hint: int, batch_size: int,
                       mode: str = "train") -> Dict[str, np.ndarray]:
        """Pack a buffer of raw TSV lines into a Batch of ``batch_size``
        rows.  Lines with the wrong number of cells are skipped (pred mode
        also takes lines without the label column).  ``n_rows_hint`` is
        unused: it keeps the JAX package's signature."""
        plan = self.plan
        B = batch_size
        out: Dict[str, np.ndarray] = {
            "label": np.zeros(B, np.float32),
            "weight": np.zeros(B, np.float32),
            "mask": np.zeros(B, np.float32),
            "wide_ids": np.zeros((B, plan.wide_packed_len), np.int32),
            "wide_wts": np.zeros((B, plan.wide_packed_len), np.float32),
        }
        ptr_order: List[np.ndarray] = [
            out["label"], out["weight"], out["mask"],
            out["wide_ids"], out["wide_wts"]]
        for g in plan.groups:
            P = plan.group_packed_len[g.dim]
            ids = np.zeros((B, P), np.int32)
            wts = np.zeros((B, P), np.float32)
            seg = np.zeros((B, P), np.int32)
            out[f"emb_ids_d{g.dim}"], out[f"emb_wts_d{g.dim}"] = ids, wts
            out[f"emb_seg_d{g.dim}"] = seg
            ptr_order += [ids, wts, seg]
        ind_ids = np.zeros((B, max(plan.indicator_total_len, 1)), np.int32)
        ind_wts = np.zeros((B, max(plan.indicator_total_len, 1)), np.float32)
        ptr_order += [ind_ids, ind_wts]
        cont = np.zeros((B, max(len(plan.continuous_slots), 1)), np.float32)
        ptr_order.append(cont)
        if plan.indicator_total_len:
            out["ind_ids"], out["ind_wts"] = ind_ids, ind_wts
        if plan.continuous_slots:
            out["cont"] = cont

        # train mode: the kernel plans of the big groups (ops/scatter.py),
        # range, window and compact, in the order fastdata.cc fills them;
        # per table shard (a leading [n_shards] axis, plus ``ok`` / ``live``
        # flags) when the plan has scatter_shards > 1 (format v12, the JAX
        # package's features/native.py:39-73)
        masks = {"scat": 0, "wscat": 0, "sopt": 0}
        if mode == "train":
            if any(plan.dedup_group(g, B) for g in plan.groups):
                raise NotImplementedError(
                    "dedup-exchange plans are not ported yet (ROADMAP.md "
                    "Queue 1)")
            per_kind: Dict[str, list] = {k: [] for k in masks}
            for gi, g in enumerate(plan.groups):
                n_ids = B * plan.group_packed_len[g.dim]
                for prefix, spec in plan._plan_specs(g, n_ids, B):
                    masks[prefix] |= 1 << gi
                    per_kind[prefix].append((g, spec))
            for prefix, entries in per_kind.items():
                for g, spec in entries:
                    for key in ("uids", "ids", "perm", "tiles", "ok",
                                "live"):
                        if key in spec:
                            shape, dt = spec[key]
                            arr = np.zeros(shape, dt)
                            out[f"{prefix}_{key}_d{g.dim}"] = arr
                            ptr_order.append(arr)

        ptrs = (ctypes.c_void_p * len(ptr_order))(
            *[a.ctypes.data_as(ctypes.c_void_p).value for a in ptr_order])
        caps = (ctypes.c_int64 * len(plan.groups))()
        n = self._lib.wdt_transform(
            self._plan_handle, text, len(text), B,
            0 if mode == "pred" else 1,
            1 if self.n_classes > 2 else 0,
            # an explicit None check: a weight of 0 is a legal setting
            float(1.0 if self.pos_weight is None else self.pos_weight),
            float(1.0 if self.neg_weight is None else self.neg_weight),
            1 if self.weighted else 0, self.n_threads, masks["scat"],
            masks["wscat"], masks["sopt"], 0, caps, ptrs)
        if n < 0:
            raise RuntimeError(f"wdt_transform failed: {n}")
        if mode == "pred":
            out.pop("label")
            out.pop("weight")
        return out

    def transform(self, rows: Sequence[Sequence[str]], batch_size: int,
                  mode: str = "train") -> Dict[str, np.ndarray]:
        """FeatureTransformer's row-list API (joined back into text)."""
        text = "\n".join("\t".join(cells) for cells in rows).encode("utf-8")
        return self.transform_text(text, len(rows), batch_size, mode)
