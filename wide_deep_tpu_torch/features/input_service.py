"""Multi-host input service: one loader process sees the GLOBAL batch.

The port's copy of wide_deep_tpu/features/input_service.py, with the same
wire format: the port's RemoteInputDataset reads from the JAX package's
InputServer and the other way round (tests/test_torch_input_service.py).
Its training processes are the port's ranks (parallel/mesh.py, one table
shard each); tools/input_server.py builds the ranks' plan through
training/loop.build_training_plan(..., global_batch_input=True).

The per-shard kernel plans (``scat_*``/``wscat_*``/``sopt_*``/``dscat_*``,
ops/scatter.py) are built from the global batch's id stream, so a
multi-process mesh whose hosts row-shard the input (pipeline.CsvDataset
round-robin) could never emit them — training/loop.py gated every kernel
path off and multi-host runs fell back to GSPMD's serial-scatter
collectives, losing the 2.6x the kernel family buys.

This service restores the single-host data path at multi-host scale:

    loader host                         training processes (ranks)
    ───────────                         ─────────────────────────────────
    tools/input_server.py               Trainer (train.yaml
      CsvDataset @ GLOBAL batch           distribution.input_service:
      C++ plan emission (all kinds)       "loader:port")
      InputServer ──── framed TCP ────▶ RemoteInputDataset (one per proc)
        per-proc slices:                  yields per-host batches;
        batch axis rows [b*i, b*(i+1))    _to_device assembles the global
        plan shard rows its devices own   arrays per key sharding

Every process requests batch ``seq`` 0, 1, 2, ... in lockstep (training is
synchronous SPMD); the server materializes each global batch once, serves
each process its slice, and evicts the batch when all processes took it.
Batches are deterministic in (seed, epoch_seed): the loader's shuffle is
the same epoch-seeded stream a single-process run would see, which also
gives multi-host training a deterministic GLOBAL data order across epochs
— per-host round-robin sharding cannot (rows interleave by arrival).

The reference's analog was ``tf.data`` + per-worker ``dataset.shard``
(/root/reference/python/lib/dataset.py:173-174) — workers never shared a
batch, which its async parameter servers tolerated; synchronous SPMD with
host-built plans needs exactly-one-loader semantics instead.

Wire format: serving/protocol.py frames (magic + u32 length); JSON control
messages; batches as uncompressed ``.npz``.

Pod scale: one loader saturates at the C++ parser's ~300k rows/s per 2
cores, so production pods run one loader per HOST GROUP.  Each
``InputServer`` serves a contiguous proc range (``proc_start`` /
``proc_count`` of the GLOBAL ``n_procs``); every loader runs the same
deterministic factory (same file list + seed), so each materializes the
identical global batch stream and serves only its group's slices —
trainers stay bit-identical to the single-loader run
(tests/test_input_service.py::TestShardedLoaders).  A batch is evicted
once the server's OWN consumers took it (waiting on the global proc
count would deadlock at the prefetch limit — the other groups' requests
go to their own loader).
"""

from __future__ import annotations

import io
import json
import logging
import socket
import threading
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np

from wide_deep_tpu_torch.serving.protocol import recv_frame, send_frame

log = logging.getLogger("wide_deep_tpu_torch.input_service")

KIND_BATCH = b"BTCH"
KIND_END = b"END!"
KIND_ERR = b"ERR!"

# keys with a leading [n_shards] axis (per-table-shard plan arrays); every
# other key has a leading batch axis.  With scatter_shards > 1 EVERY key
# under these prefixes is shard-layout except dscat_slots (per-entry slot
# matrix, batch axis).
_SHARD_PREFIXES = ("scat_", "wscat_", "sopt_", "dscat_uids_")


def stream_fingerprint(seed: int, global_batch: int, n_classes: int,
                       scatter_shards: int, n_procs: int,
                       pos_weight=None, neg_weight=None,
                       model_type: str = "",
                       shuffle_buffer=None,
                       data_files=None) -> str:
    """Digest of the deterministic-stream identity.

    Sharded-loader correctness requires every loader to materialize the
    bit-identical global stream (same seed, config, file list) — the
    group-range handshake alone cannot see a loader started with a
    different seed or conf, which would serve divergent slices that pass
    every shape check and silently corrupt the reassembled global batch.
    Both sides compute this digest over the fields they share (the
    config-derived stream identity); the loader additionally folds in its
    resolved ``data_files`` [(basename, size), ...] so trainers can
    cross-verify that all loader groups read the same dataset
    (RemoteInputDataset.server_stream_id after the hello ack)."""
    import hashlib
    ident = {
        "seed": int(seed), "batch": int(global_batch),
        "n_classes": int(n_classes), "shards": int(scatter_shards),
        "n_procs": int(n_procs),
        "pos_w": None if pos_weight is None else float(pos_weight),
        "neg_w": None if neg_weight is None else float(neg_weight),
        "model_type": str(model_type),
        # the shuffle-buffer size (train.yaml num_examples) changes the
        # deterministic ORDER of the stream — loaders differing only in
        # it would serve divergent slices (review finding, round 5)
        "shuffle": None if shuffle_buffer is None else int(shuffle_buffer),
    }
    if data_files is not None:
        ident["files"] = sorted(
            [str(name), int(size)] for name, size in data_files)
    payload = json.dumps(ident, sort_keys=True).encode("utf-8")
    return hashlib.sha256(payload).hexdigest()[:16]


def data_digest(path: str) -> str:
    """Digest of the resolved file list under ``path`` — the loader-host
    half of the stream identity (only loaders resolve file lists;
    trainers cross-verify the digests agree across loader groups).

    Hashes (basename, size, head-64KB, tail-64KB) per file: name+size
    alone cannot see a stale mirror whose regenerated part files kept
    their names and byte counts (fixed-width rows), and hashing whole
    multi-GB files at every hello is too slow — the sampled content
    catches content drift in practice at O(128 KB) per file."""
    import hashlib
    import os
    from wide_deep_tpu_torch.features.pipeline import list_files
    h = hashlib.sha256()
    for p in sorted(list_files(path)):
        h.update(os.path.basename(p).encode("utf-8") + b"\0")
        try:
            size = os.path.getsize(p)
            h.update(str(size).encode())
            with open(p, "rb") as f:
                h.update(f.read(65536))
                if size > 131072:
                    f.seek(-65536, os.SEEK_END)
                    h.update(f.read(65536))
        except OSError:
            h.update(b"<unreadable>")
    return h.hexdigest()[:16]


def loader_for_proc(addrs, proc: int, n_procs: int) -> str:
    """Which loader address serves ``proc``: contiguous even groups,
    group g = proc * L // P gets addrs[g].  Loaders must be started with
    the matching --proc_start/--proc_count (P/L each).  Shared by the
    trainer's routing (training/loop.py) and its tests."""
    if n_procs % len(addrs):
        raise ValueError(
            f"{n_procs} procs cannot split evenly over "
            f"{len(addrs)} input-service loaders")
    return addrs[proc * len(addrs) // n_procs]


def group_range_for_proc(n_addrs: int, proc: int,
                         n_procs: int) -> Tuple[int, int]:
    """The [lo, hi) proc range of ``proc``'s loader group — sent in the
    hello so a loader started with the WRONG range (e.g. left at the
    serve-all default) rejects immediately instead of deadlocking its
    stream at the prefetch limit waiting for procs that connect
    elsewhere."""
    if n_procs % n_addrs:
        raise ValueError(
            f"{n_procs} procs cannot split evenly over "
            f"{n_addrs} input-service loaders")
    per = n_procs // n_addrs
    g = proc * n_addrs // n_procs
    return g * per, (g + 1) * per


def key_axis(key: str, scatter_shards: int) -> str:
    """'shard' | 'batch' — which axis of a batch entry is partitioned."""
    if scatter_shards > 1 and key.startswith(_SHARD_PREFIXES):
        return "shard"
    return "batch"


def slice_for_proc(key: str, arr: np.ndarray, proc: int, n_procs: int,
                   scatter_shards: int) -> np.ndarray:
    """Process ``proc``'s slice of one global batch entry.

    Batch-axis keys split rows evenly; shard-axis keys split the leading
    n_shards axis into the contiguous block proc's devices own (one row
    per rank in the port: rank r holds table shard r)."""
    n = arr.shape[0]
    if n % n_procs:
        raise ValueError(f"{key}: leading dim {n} % n_procs {n_procs} != 0")
    per = n // n_procs
    return arr[proc * per:(proc + 1) * per]


def local_batch_spec(plan, global_batch: int, n_procs: int,
                     n_classes: int = 2, mode: str = "train",
                     with_image: bool = False,
                     image_shape: Tuple[int, int, int] = (224, 224, 3)):
    """Per-process shape/dtype contract of a served batch: the global
    plan.batch_spec with each entry's leading axis divided by n_procs.
    ``with_image``: joint-CNN batches carry an [B, H, W, C] ``image``
    entry — batch axis, so it slices per process like any feature."""
    spec = plan.batch_spec(global_batch, n_classes, mode=mode,
                           with_image=with_image, image_shape=image_shape)
    out = {}
    for key, (shape, dt) in spec.items():
        lead = shape[0] // n_procs
        out[key] = ((lead,) + tuple(shape[1:]), dt)
    return out


def _encode_batch(batch: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **batch)
    return buf.getvalue()


def _decode_batch(payload: bytes) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(payload), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


class _Stream:
    """One (path, mode, epoch_seed) batch stream shared by ``n_procs``
    consumer clients (the procs THIS server serves — a subset of the
    global mesh under pod-scale sharded loaders): background production
    (the parse runs OFF every client's critical path, up to ``prefetch``
    batches ahead of the slowest consumer), per-seq caching, eviction
    when all consumers took the seq."""

    def __init__(self, it: Iterator[Dict[str, np.ndarray]], n_procs: int,
                 prefetch: int = 2):
        self.it = it
        self.n_procs = n_procs
        self.prefetch = max(int(prefetch), 0)
        self.cv = threading.Condition()
        self.cache: Dict[int, Optional[Dict[str, np.ndarray]]] = {}
        self.taken: Dict[int, set] = {}
        self.next_seq = 0       # next seq the producer will publish
        self.evicted = 0        # seqs [0, evicted) fully served + dropped
        self.end_seq: Optional[int] = None
        self.stopped = False
        self.error: Optional[str] = None   # producer failure, for consumers
        self._producer = threading.Thread(target=self._produce, daemon=True)
        self._producer.start()

    def _produce(self):
        while True:
            with self.cv:
                while (not self.stopped
                       and self.next_seq - self.evicted > self.prefetch):
                    self.cv.wait()
                if self.stopped:
                    return
                seq = self.next_seq
            try:
                batch = next(self.it, None)  # the slow part — off the lock
            except Exception as e:  # noqa: BLE001 — any loader-side failure
                # must reach every blocked consumer as an ERR, not a silent
                # dead thread they wait on until their socket timeout
                log.exception("input-service stream producer failed")
                with self.cv:
                    self.error = f"loader stream failed: {e!r}"
                    self.stopped = True
                    self.cv.notify_all()
                return
            with self.cv:
                self.cache[seq] = batch
                self.taken[seq] = set()
                self.next_seq = seq + 1
                if batch is None:
                    self.end_seq = seq  # stays cached for every consumer
                self.cv.notify_all()
                if batch is None:
                    return

    def stop(self):
        with self.cv:
            self.stopped = True
            self.cv.notify_all()

    def get(self, proc: int, seq: int) -> Optional[Dict[str, np.ndarray]]:
        """-> the GLOBAL batch for ``seq`` (None = end of data)."""
        with self.cv:
            if seq < self.evicted:
                raise ValueError(
                    f"seq {seq} already evicted (procs out of lockstep)")
            while seq not in self.cache:
                if self.stopped:
                    raise ValueError(self.error or "stream stopped")
                if self.end_seq is not None and seq > self.end_seq:
                    raise ValueError(f"seq {seq} past end of data "
                                     f"({self.end_seq})")
                self.cv.wait(timeout=1.0)
            batch = self.cache[seq]
            self.taken[seq].add(proc)
            if batch is not None and len(self.taken[seq]) >= self.n_procs:
                del self.cache[seq], self.taken[seq]
                self.evicted = seq + 1
                self.cv.notify_all()  # production space freed
            return batch


class InputServer:
    """Serves GLOBAL-batch slices to n_procs training processes.

    ``dataset_factory(path, mode, epoch_seed)`` must yield batches at the
    GLOBAL batch size with every plan the training step consumes —
    tools/input_server.py builds it from the same config + topology the
    trainers use (training/loop.build_training_plan keeps the plans
    bit-identical)."""

    def __init__(self, dataset_factory: Callable[[str, str, int], Any],
                 n_procs: int, scatter_shards: int, port: int = 0,
                 host: str = "0.0.0.0", proc_start: int = 0,
                 proc_count: Optional[int] = None,
                 fingerprint: Optional[str] = None,
                 data_digest_fn: Optional[Callable[[str], str]] = None):
        self.dataset_factory = dataset_factory
        # stream-identity handshake (see stream_fingerprint): clients send
        # their config-derived digest in the hello; a loader started with
        # a different seed/config rejects instead of serving divergent
        # slices.  data_digest_fn(path) -> digest of the resolved file
        # list rides the ack so trainers can cross-verify loader GROUPS
        # read the same dataset.
        self.fingerprint = fingerprint
        self.data_digest_fn = data_digest_fn
        self.n_procs = int(n_procs)
        # the contiguous proc range THIS loader serves (pod-scale sharded
        # loaders; defaults to all procs — the single-loader rig)
        self.proc_start = int(proc_start)
        self.proc_count = self.n_procs if proc_count is None else int(
            proc_count)
        if not (0 <= self.proc_start
                and self.proc_start + self.proc_count <= self.n_procs
                and self.proc_count > 0):
            raise ValueError(
                f"proc range [{self.proc_start}, "
                f"{self.proc_start + self.proc_count}) outside "
                f"n_procs {self.n_procs}")
        self.scatter_shards = int(scatter_shards)
        self._streams: Dict[Tuple[str, str, int], _Stream] = {}
        self._streams_lock = threading.Lock()
        self._stop = threading.Event()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self.port = self._sock.getsockname()[1]
        self._sock.listen(max(16, 2 * self.n_procs))
        self._sock.settimeout(0.5)
        self._threads = []
        self._accept_thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- lifecycle
    def start(self):
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()
        log.info("input service on :%d for procs [%d, %d) of %d "
                 "(%d table shards)", self.port, self.proc_start,
                 self.proc_start + self.proc_count, self.n_procs,
                 self.scatter_shards)

    def stop(self):
        self._stop.set()
        with self._streams_lock:
            for st in self._streams.values():
                st.stop()
        try:
            self._sock.close()
        except OSError:
            pass
        for t in self._threads:
            t.join(timeout=2.0)

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    # ------------------------------------------------------------- serving
    def _stream_for(self, path: str, mode: str, epoch_seed: int,
                    run: int) -> _Stream:
        # ``run`` distinguishes training RUNS that replay the same
        # (path, mode, epoch_seed) — e.g. a checkpoint-resumed restart —
        # so the restarted run gets a FRESH deterministic stream instead
        # of the consumed one.  The Trainer sends its global_step at
        # dataset-open time, which every process agrees on after restore.
        key = (path, mode, int(epoch_seed), int(run))
        with self._streams_lock:
            st = self._streams.get(key)
            if st is None:
                st = _Stream(iter(self.dataset_factory(path, mode,
                                                       epoch_seed)),
                             self.proc_count)
                self._streams[key] = st
            return st

    def _serve_conn(self, conn: socket.socket):
        try:
            with conn:
                hello = json.loads(recv_frame(conn).decode("utf-8"))
                if hello.get("op") != "hello":
                    send_frame(conn, KIND_ERR + b"expected hello")
                    return
                proc = int(hello["proc"])
                n_procs = int(hello["n_procs"])
                if n_procs != self.n_procs or not 0 <= proc < n_procs:
                    send_frame(conn, KIND_ERR + (
                        f"topology mismatch: server runs {self.n_procs} "
                        f"procs, hello said proc {proc}/{n_procs}"
                    ).encode())
                    return
                if not (self.proc_start <= proc
                        < self.proc_start + self.proc_count):
                    send_frame(conn, KIND_ERR + (
                        f"proc {proc} outside this loader's range "
                        f"[{self.proc_start}, "
                        f"{self.proc_start + self.proc_count}) — point "
                        f"this host group at its own loader"
                    ).encode())
                    return
                # group-range handshake: the client states which proc
                # range it believes this loader serves.  A loader left at
                # the serve-all default while the trainers split over
                # several loaders would otherwise pass the checks above
                # and DEADLOCK at the prefetch limit (its stream waits
                # for takers that connect to other loaders).
                want = hello.get("group_range")
                have = [self.proc_start, self.proc_start + self.proc_count]
                if want is not None and list(want) != have:
                    send_frame(conn, KIND_ERR + (
                        f"loader serves procs [{have[0]}, {have[1]}) but "
                        f"the trainer's loader list implies "
                        f"[{want[0]}, {want[1]}) — start this loader "
                        f"with --proc_start {want[0]} --proc_count "
                        f"{want[1] - want[0]}"
                    ).encode())
                    return
                # stream-identity handshake: same shape as the group-range
                # check — both sides computed stream_fingerprint from
                # their own (seed, config); mismatch means this loader
                # would serve slices of a DIFFERENT deterministic stream,
                # which no later shape check could catch.
                want_fp = hello.get("fingerprint")
                if (want_fp is not None and self.fingerprint is not None
                        and want_fp != self.fingerprint):
                    send_frame(conn, KIND_ERR + (
                        f"stream identity mismatch: loader built its "
                        f"stream from config fingerprint "
                        f"{self.fingerprint} but the trainer expects "
                        f"{want_fp} — the loader was started with a "
                        f"different seed/conf/batch than the trainers"
                    ).encode())
                    return
                st = self._stream_for(hello["path"], hello["mode"],
                                      hello.get("epoch_seed", 0),
                                      hello.get("run", 0))
                # ack carries the loader's full stream id (config
                # fingerprint + resolved-file-list digest) so trainers can
                # cross-verify that every loader GROUP reads the same
                # dataset (the config digest alone cannot see file lists,
                # which only the loader hosts resolve)
                data_digest = ""
                if self.data_digest_fn is not None:
                    try:
                        data_digest = self.data_digest_fn(hello["path"])
                    except Exception as e:  # noqa: BLE001 — advisory id
                        log.warning("data digest failed for %r: %s",
                                    hello["path"], e)
                ack = {"stream_id":
                       f"{self.fingerprint or ''}:{data_digest}"}
                send_frame(conn, KIND_BATCH + json.dumps(ack).encode())
                while not self._stop.is_set():
                    req = json.loads(recv_frame(conn).decode("utf-8"))
                    if req.get("op") == "close":
                        return
                    seq = int(req["seq"])
                    try:
                        batch = st.get(proc, seq)
                        if batch is None:
                            send_frame(conn, KIND_END)
                            continue  # client may re-ask (idempotent end)
                        sliced = {
                            k: slice_for_proc(k, v, proc, n_procs,
                                              self.scatter_shards)
                            for k, v in batch.items()}
                    except ValueError as e:
                        # lockstep/shape violations must reach the client
                        # as an ERR frame while the socket is still open
                        log.warning("input-service request failed: %s", e)
                        send_frame(conn, KIND_ERR + str(e).encode())
                        return
                    send_frame(conn, KIND_BATCH + _encode_batch(sliced))
        except (IOError, json.JSONDecodeError, ValueError) as e:
            if not self._stop.is_set():
                log.warning("input-service connection ended: %s", e)


class RemoteInputDataset:
    """Client side: iterate this process's slices of the service's global
    batches.  Drop-in for pipeline.CsvDataset in the Trainer's train loop
    (same per-host batch shapes; ``local_spec`` gives the pad-batch
    contract for the synced-batch protocol).

    Failure model: a dropped loader connection ends the training run (the
    server evicts a batch once every process took it, so a mid-stream
    reconnect could not replay it consistently).  Recovery is the
    checkpoint-resume path: the restarted run's ``run_token`` (its
    restored global step, identical on every process) keys a FRESH
    deterministic stream on the still-running loader, so it re-reads the
    same epoch-seeded global order and resumes from the last checkpoint —
    the same guarantee the reference's PS workers had (SURVEY.md §2.16
    elasticity row), minus the silent async drift."""

    def __init__(self, plan, address: str, path: str, mode: str,
                 global_batch: int, proc: int, n_procs: int,
                 epoch_seed: int = 0, n_classes: int = 2,
                 timeout: float = 300.0, run_token: int = 0,
                 with_image: bool = False,
                 image_shape: Tuple[int, int, int] = (224, 224, 3),
                 group_range: Optional[Tuple[int, int]] = None,
                 fingerprint: Optional[str] = None):
        host, _, port = address.rpartition(":")
        self.plan = plan
        self.mode = mode
        self.address = (host or "localhost", int(port))
        self.path = path
        self.proc = int(proc)
        self.n_procs = int(n_procs)
        self.epoch_seed = int(epoch_seed)
        self.timeout = timeout
        # distinguishes replays of the same (path, epoch_seed) across
        # training runs; every process must send the same value (the
        # Trainer uses its restored global_step)
        self.run_token = int(run_token)
        # the loader-group range this client expects its server to serve
        # (group_range_for_proc); validated in the hello so a misranged
        # loader fails fast instead of deadlocking its stream
        self.group_range = (None if group_range is None
                            else (int(group_range[0]), int(group_range[1])))
        # config-derived stream identity (stream_fingerprint) — validated
        # in the hello so a loader running a different seed/conf rejects
        # instead of silently serving slices of a divergent stream
        self.fingerprint = fingerprint
        # the loader's full stream id (config fingerprint + file-list
        # digest), captured from the hello ack; trainers cross-verify it
        # across processes so all loader GROUPS provably read the same
        # dataset (training/loop.py)
        self.server_stream_id: Optional[str] = None
        self.with_image = bool(with_image)
        self.local_spec = local_batch_spec(plan, global_batch, n_procs,
                                           n_classes, mode=mode,
                                           with_image=with_image,
                                           image_shape=image_shape)

    def _hello(self, sock: socket.socket) -> Optional[str]:
        """Send the hello handshake and parse the ack — ONE code path for
        __iter__ and probe_stream_id, so the pre-flight probe always
        validates exactly the handshake training uses.  Returns (and
        stores) the loader's full stream id from the ack payload."""
        hello = {"op": "hello", "proc": self.proc,
                 "n_procs": self.n_procs, "path": self.path,
                 "mode": self.mode, "epoch_seed": self.epoch_seed,
                 "run": self.run_token}
        if self.group_range is not None:
            hello["group_range"] = list(self.group_range)
        if self.fingerprint is not None:
            hello["fingerprint"] = self.fingerprint
        send_frame(sock, json.dumps(hello).encode("utf-8"))
        ack = recv_frame(sock)
        if ack[:4] != KIND_BATCH:
            raise IOError(f"input service rejected hello: "
                          f"{ack[4:].decode('utf-8', 'replace')}")
        if len(ack) > 4:  # ack payload: the loader's full stream id
            try:
                self.server_stream_id = json.loads(
                    ack[4:].decode("utf-8")).get("stream_id")
            except (json.JSONDecodeError, UnicodeDecodeError):
                self.server_stream_id = None
        return self.server_stream_id

    def probe_stream_id(self) -> Optional[str]:
        """Connect, run the hello handshake (all identity checks), read
        the loader's full stream id from the ack, disconnect.  Used by the
        trainer to verify — BEFORE training starts — that every loader
        group serves the identical stream (same config fingerprint AND
        same resolved file list)."""
        sock = socket.create_connection(self.address, timeout=self.timeout)
        try:
            return self._hello(sock)
        finally:
            try:
                send_frame(sock, json.dumps({"op": "close"}).encode())
            except OSError:
                pass
            sock.close()

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        sock = socket.create_connection(self.address, timeout=self.timeout)
        try:
            self._hello(sock)
            seq = 0
            while True:
                send_frame(sock, json.dumps({"op": "next",
                                             "seq": seq}).encode("utf-8"))
                resp = recv_frame(sock)
                kind, payload = resp[:4], resp[4:]
                if kind == KIND_END:
                    return
                if kind != KIND_BATCH:
                    raise IOError(f"input service error: "
                                  f"{payload.decode('utf-8', 'replace')}")
                batch = _decode_batch(payload)
                if self.with_image and "image" not in batch:
                    # fail the contract loudly here instead of a bare
                    # KeyError deep in the step (or an uneven multi-host
                    # hang): the loader was started without its image side
                    raise ValueError(
                        "trainer expects joint-CNN batches but the input "
                        "service served no 'image' entry — start "
                        "tools/input_server.py with --image_train_data "
                        "(or restart a stale loader)")
                for k, v in batch.items():
                    want = self.local_spec.get(k)
                    if want is not None and tuple(v.shape) != want[0]:
                        raise ValueError(
                            f"{k}: served shape {v.shape} != expected "
                            f"{want[0]} — loader plan/topology mismatch")
                yield batch
                seq += 1
        finally:
            try:
                send_frame(sock, json.dumps({"op": "close"}).encode())
            except OSError:
                pass
            sock.close()
