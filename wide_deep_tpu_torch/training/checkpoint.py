"""Checkpoint save / resume / inspect in a torch format of the port's own
(the JAX package's checkpoints are orbax's, which the port does not read).

Layout: one directory per step, ``<model_dir>/<step>/``, holding

* ``tensors.pt``: ``torch.save`` of a flat {name: tensor} dict, each tensor a
  contiguous host copy of its own (a view would write its whole storage);
  read back with ``torch.load(weights_only=True, mmap=True)``, so restoring
  runs no pickled code;
* ``index.json``: the format, the step, the save time, every tensor's shape
  and torch dtype, and the tree's Python ints (the optimizers' step counts,
  the global step), which the learning-rate schedules read.

A name is its leaf's key path joined by "/", the parts of a tuple key
included: ``params/dnn/towers/0/hidden/0/kernel``,
``opt_state/dense/linear/accum/linear/w``.  A step is written into a hidden
temporary directory and renamed to ``<step>`` once complete, so a run that
dies mid-write leaves nothing ``latest_step`` / ``all_steps`` count.

The semantics are the JAX package's (training/checkpoint.py there, after the
reference's RunConfig, conf/train.yaml:91-98): step- or time-based cadence,
retention of the newest ``keep_checkpoint_max`` committed steps plus one
every ``keep_checkpoint_every_n_hours`` (when under 10000), and
asynchronous writes: ``save`` returns once its host copy is made, one write
is in flight at a time, and a forced save, ``wait``, ``latest_step``,
``all_steps``, ``restore`` and ``close`` wait for it.  An exception in the
writer is raised by the next call that waits.

A run on a mesh of ranks writes the files one device writes (the JAX
package saves global arrays, checkpoint.py:135 there): each row-sharded
leaf is gathered whole onto rank 0, which alone writes (``gather_sharded``);
a restore gives each rank its own rows of such a leaf (``restore``'s
``row_ranges``), so a checkpoint moves between any numbers of ranks.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

FORMAT = 1
TENSORS_FILE = "tensors.pt"
INDEX_FILE = "index.json"


def _flatten(tree, prefix: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    if isinstance(tree, dict):
        for k in tree:
            yield from _flatten(tree[k], prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + (i,))
    else:
        yield prefix, tree


def leaf_name(path: Tuple) -> str:
    parts: List[str] = []
    for k in path:
        parts.extend(map(str, k) if isinstance(k, tuple) else [str(k)])
    return "/".join(parts)


def named_leaves(tree) -> Iterator[Tuple[str, Any]]:
    """(``leaf_name`` of its path, leaf) for every leaf of ``tree``."""
    for path, leaf in _flatten(tree):
        yield leaf_name(path), leaf


def _is_int(x) -> bool:
    return isinstance(x, int) and not isinstance(x, bool)


def snapshot(tree) -> Tuple[Dict[str, torch.Tensor], Dict[str, int]]:
    """A tree of tensors and Python ints -> ({name: a contiguous host copy
    of each tensor}, {name: int}).  Every copy is complete on return."""
    tensors: Dict[str, torch.Tensor] = {}
    ints: Dict[str, int] = {}
    for path, leaf in _flatten(tree):
        name = leaf_name(path)
        if name in tensors or name in ints:
            raise ValueError(f"two leaves are named {name!r}")
        if isinstance(leaf, torch.Tensor):
            host = torch.empty(leaf.shape, dtype=leaf.dtype)
            host.copy_(leaf.detach())
            tensors[name] = host
        elif _is_int(leaf):
            ints[name] = leaf
        else:
            raise TypeError(f"{name}: cannot checkpoint a "
                            f"{type(leaf).__name__}")
    return tensors, ints


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def step_dir(model_dir: str, step: int) -> str:
    return os.path.join(model_dir, str(step))


def committed_steps(model_dir: str) -> List[int]:
    """Steps under ``model_dir`` whose write completed, ascending."""
    if not os.path.isdir(model_dir):
        return []
    return sorted(int(d) for d in os.listdir(model_dir)
                  if d.isdigit() and os.path.isfile(
                      os.path.join(model_dir, d, INDEX_FILE)))


def read_index(model_dir: str, step: int) -> Dict[str, Any]:
    with open(os.path.join(step_dir(model_dir, step), INDEX_FILE)) as f:
        return json.load(f)


def write_flat(dst_dir: str, tensors: Dict[str, torch.Tensor],
               ints: Dict[str, int], **fields) -> None:
    """Write ``tensors`` ({name: host tensor}) as ``tensors.pt`` and their
    index as ``index.json`` into ``dst_dir`` (made if missing): the format,
    ``fields``, every tensor's shape and torch dtype, and ``ints``."""
    os.makedirs(dst_dir, exist_ok=True)
    torch.save(tensors, os.path.join(dst_dir, TENSORS_FILE))
    index = {"format": FORMAT, **fields,
             "tensors": {n: {"shape": list(t.shape),
                             "dtype": _dtype_name(t.dtype)}
                         for n, t in tensors.items()},
             "ints": ints}
    with open(os.path.join(dst_dir, INDEX_FILE), "w") as f:
        json.dump(index, f, indent=1)


def load_flat(src_dir: str) -> Dict[str, torch.Tensor]:
    """The tensors ``write_flat`` wrote into ``src_dir``, memory-mapped on
    the host."""
    return torch.load(os.path.join(src_dir, TENSORS_FILE),
                      map_location="cpu", weights_only=True, mmap=True)


def load_tensors(model_dir: str, step: int) -> Dict[str, torch.Tensor]:
    """The step's tensors, memory-mapped on the host."""
    return load_flat(step_dir(model_dir, step))


class CheckpointManager:
    """Cadenced, asynchronous checkpoints of one model directory."""

    def __init__(self, model_dir: str, runconfig: Dict[str, Any]):
        self.model_dir = os.path.abspath(model_dir)
        os.makedirs(self.model_dir, exist_ok=True)
        self.save_secs = runconfig.get("save_checkpoints_secs")
        self.save_steps = runconfig.get("save_checkpoints_steps")
        self.max_to_keep = runconfig.get("keep_checkpoint_max", 5) or None
        keep_hours = runconfig.get("keep_checkpoint_every_n_hours")
        self.keep_secs = (keep_hours * 3600.0
                          if keep_hours and keep_hours < 10000 else None)
        self._last_save_time = time.time()
        self._last_save_step = -1
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # the last save's step, bytes written, and seconds: the host copy
        # (inside save) and the write (in the writer thread)
        self.last_save: Dict[str, Any] = {}

    def should_save(self, step: int) -> bool:
        if step == self._last_save_step:
            return False
        if self.save_steps:
            return step % self.save_steps == 0
        if self.save_secs:
            return time.time() - self._last_save_time >= self.save_secs
        return False

    def save(self, step: int, tree: Dict[str, Any], force: bool = False):
        """Checkpoint ``tree`` (tensors and Python ints) as ``step``: the
        host copy is made here, the write runs in a thread; a forced save
        returns once the step is committed.  A step already on disk is not
        written again."""
        self.wait()
        if step in committed_steps(self.model_dir):
            return
        t0 = time.perf_counter()
        saved_at = time.time()
        tensors, ints = snapshot(tree)
        self.last_save = {"step": step,
                          "copy_s": time.perf_counter() - t0}
        self._thread = threading.Thread(
            target=self._write_guarded, args=(step, tensors, ints, saved_at),
            name=f"checkpoint-{step}")
        self._thread.start()
        if force:
            self.wait()
        self._last_save_time = time.time()
        self._last_save_step = step

    def _write_guarded(self, step, tensors, ints, saved_at):
        try:
            self._write(step, tensors, ints, saved_at)
        except Exception as e:  # noqa: BLE001 — raised by the next wait()
            self._error = e

    def _write(self, step: int, tensors: Dict[str, torch.Tensor],
               ints: Dict[str, int], saved_at: float):
        t0 = time.perf_counter()
        tmp = os.path.join(self.model_dir, f".{step}.tmp-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        write_flat(tmp, tensors, ints, step=step, time=saved_at)
        os.replace(tmp, step_dir(self.model_dir, step))
        self._retain()
        self.last_save.update(
            bytes=os.path.getsize(os.path.join(
                step_dir(self.model_dir, step), TENSORS_FILE)),
            write_s=time.perf_counter() - t0)

    def _retain(self):
        """Delete committed steps beyond the newest ``max_to_keep``, except
        those kept by the hours rule: the oldest step, and each step saved
        at least ``keep_secs`` after the last one so kept."""
        steps = committed_steps(self.model_dir)
        if self.max_to_keep is None or len(steps) <= self.max_to_keep:
            return
        keep = set(steps[-self.max_to_keep:])
        if self.keep_secs:
            last = None
            for s in steps:
                t = read_index(self.model_dir, s)["time"]
                if last is None or t >= last + self.keep_secs:
                    keep.add(s)
                    last = t
        for s in steps:
            if s not in keep:
                shutil.rmtree(step_dir(self.model_dir, s))

    def wait(self):
        """Block until the write in flight has committed; raise what it
        raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        self.wait()
        return committed_steps(self.model_dir)

    @torch.no_grad()
    def restore(self, tree: Dict[str, Any],
                step: Optional[int] = None,
                row_ranges: Optional[Dict[str, Tuple[int, int]]] = None
                ) -> Optional[Dict[str, Any]]:
        """Restore ``step`` (default: the latest) into ``tree`` in place:
        every tensor leaf is ``copy_``-ed from the checkpoint, every int
        leaf replaced in its container; returns ``tree``, or None when
        there is no checkpoint.  ``row_ranges`` {name: (lo, hi)}: those
        leaves take rows [lo, hi) of the saved tensor (a rank's shard).
        The names, shapes and dtypes must match the checkpoint's, or it
        raises naming the leaf before writing anything."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        self.wait()
        ints = read_index(self.model_dir, step)["ints"]
        tensors = dict(load_tensors(self.model_dir, step))
        for name, (lo, hi) in (row_ranges or {}).items():
            if name in tensors:
                tensors[name] = tensors[name][lo:hi]
        leaves = list(_flatten(tree))
        names = {leaf_name(p) for p, _ in leaves}
        extra = sorted((set(tensors) | set(ints)) - names)
        if extra:
            raise ValueError(f"checkpoint step {step} in {self.model_dir} "
                             f"holds leaves the target lacks: {extra}")
        for path, leaf in leaves:
            name = leaf_name(path)
            if isinstance(leaf, torch.Tensor):
                src = tensors.get(name)
                if src is None:
                    raise ValueError(f"checkpoint step {step} has no tensor "
                                     f"{name}")
                if src.shape != leaf.shape or src.dtype != leaf.dtype:
                    raise ValueError(
                        f"{name}: the checkpoint holds {tuple(src.shape)} "
                        f"{src.dtype}, the target {tuple(leaf.shape)} "
                        f"{leaf.dtype}")
            elif name not in ints:
                raise ValueError(f"checkpoint step {step} has no int {name}")
        for path, leaf in leaves:
            name = leaf_name(path)
            if isinstance(leaf, torch.Tensor):
                leaf.copy_(tensors[name])
            else:
                parent = tree
                for k in path[:-1]:
                    parent = parent[k]
                parent[path[-1]] = ints[name]
        return tree

    def close(self):
        self.wait()


def sharded_names(tree, sharded_paths) -> Dict[str, Tuple]:
    """{leaf name: param path} of the leaves of a checkpoint tree that are
    row shards: the params at ``sharded_paths`` and the optimizer slots
    keyed by those paths."""
    out: Dict[str, Tuple] = {}
    for path, _ in _flatten(tree):
        for p in sharded_paths:
            if (path == ("params",) + tuple(p)
                    or (path[:2] == ("opt_state", "dense")
                        and path[-1] == tuple(p))):
                out[leaf_name(path)] = tuple(p)
    return out


def gather_sharded(tree, names) -> Optional[Dict[str, Any]]:
    """``tree`` with each leaf named in ``names`` gathered whole (every
    rank's rows in rank order) onto rank 0's host; None on the other ranks.
    Every rank must call it with the same tree structure."""
    from wide_deep_tpu_torch.parallel import mesh as mesh_lib

    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, prefix + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, prefix + (i,)) for i, v in enumerate(node)]
        if leaf_name(prefix) in names:
            return mesh_lib.gather_rows(node)
        return node

    out = walk(tree, ())
    import torch.distributed as dist
    return out if dist.get_rank() == 0 else None


def inspect_checkpoint(model_dir: str, step: Optional[int] = None,
                       tensor_name: Optional[str] = None,
                       print_values: bool = False) -> Dict[str, Any]:
    """List (and optionally print) the leaves of a checkpoint: one line of
    name, shape and dtype each, sorted by name; ``tensor_name`` keeps the
    names that contain it.  bfloat16 values print through ``.float()``.
    -> {name: tensor (memory-mapped) or int}."""
    model_dir = os.path.abspath(model_dir)
    steps = committed_steps(model_dir)
    step = step if step is not None else (steps[-1] if steps else None)
    if step is None or step not in steps:
        raise FileNotFoundError(
            f"no checkpoint {'' if step is None else step} under "
            f"{model_dir} (steps: {steps})")
    flat: Dict[str, Any] = dict(load_tensors(model_dir, step))
    flat.update(read_index(model_dir, step)["ints"])
    out = {}
    for name in sorted(flat):
        if tensor_name and tensor_name not in name:
            continue
        leaf = out[name] = flat[name]
        if isinstance(leaf, torch.Tensor):
            print(f"{name}  shape={tuple(leaf.shape)} "
                  f"dtype={_dtype_name(leaf.dtype)}")
            if print_values:
                print(leaf.float().numpy() if leaf.dtype == torch.bfloat16
                      else leaf.numpy())
        else:
            print(f"{name}  shape=() dtype=int")
            if print_values:
                print(leaf)
    return out
