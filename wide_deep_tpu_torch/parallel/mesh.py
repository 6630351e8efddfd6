"""The ranks' mesh, its sharding rules and its collectives (port of
wide_deep_tpu/parallel/mesh.py).

A sharded run is N processes, one rank each (PyTorch's own idiom), laid out
as the JAX package's ``('data', 'model')`` mesh (mesh.py:51-73 there):

* rank ``r`` sits at ``data_idx = r // model``, ``model_idx = r % model``,
  and holds table shard ``data_idx * model + model_idx`` = ``r``
  (exchange.py:74-75 there: row shards in data-major order);
* ``data_group`` joins the ranks of one ``model_idx`` (batch rows are split
  over it), ``model_group`` the ranks of one ``data_idx``;
* every leaf ``param_shardings`` row-shards (embedding, fold and wide
  tables above ``SHARD_THRESHOLD`` elements per rank, mesh.py:136-154 there)
  is held as the rank's ``rows / N`` rows; every other leaf is replicated,
  the same bits on every rank.

``placement`` is the one rule for ranks to cards and the transport: as many
cards as ranks puts rank r on ``cuda:r`` over NCCL; fewer cards puts several
ranks on one card over gloo (NCCL refuses two ranks on one GPU); the CPU
only when the caller asks for it.  The collectives below go through the
group's backend; gloo takes host tensors, so a card's tensor is staged
through the host on its way.  Each collective adds the bytes this rank
puts into it to ``collective_bytes[tag]`` (and its largest single call to
``collective_max_bytes[tag]``): the port's counterpart of the HLO byte
counts the JAX package pins in tests/test_hlo_collectives.py.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from wide_deep_tpu_torch.features.plan import SHARD_THRESHOLD

collective_bytes: Dict[str, int] = {}
collective_max_bytes: Dict[str, int] = {}


def reset_counters() -> None:
    collective_bytes.clear()
    collective_max_bytes.clear()


def _count(tag: str, nbytes: int) -> None:
    collective_bytes[tag] = collective_bytes.get(tag, 0) + nbytes
    collective_max_bytes[tag] = max(collective_max_bytes.get(tag, 0), nbytes)


# ------------------------------------------------------------- placement
def placement(rank: int, world: int, device=None,
              n_cards: Optional[int] = None) -> Tuple[torch.device, str, int]:
    """-> (device, backend, ranks per card) of ``rank`` of ``world`` ranks
    on this host.  ``device="cpu"``: the host, gloo.  Otherwise the card:
    ``cuda:rank`` over NCCL when there are at least as many cards as
    ranks, else ``cuda:rank % n_cards`` over gloo (NCCL refuses two ranks
    on one GPU).  Raises when there is no card: a rank never falls back to
    the CPU on its own."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu"), "gloo", world
    n = torch.cuda.device_count() if n_cards is None else n_cards
    if n < 1:
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the ranks on the CPU")
    if n >= world:
        return torch.device("cuda", rank), "nccl", 1
    return torch.device("cuda", rank % n), "gloo", -(-world // n)


def init_distributed(rank: int, world: int, init_method: str,
                     device=None, timeout_s: float = 1800.0
                     ) -> Tuple[torch.device, str]:
    """``torch.distributed.init_process_group`` for this rank with the
    backend ``placement`` picks -> (device, backend).  ``init_method``:
    ``tcp://host:port`` or ``file://path``."""
    import datetime
    if not 0 <= rank < world:
        raise ValueError(f"process index {rank} is not one of the {world} "
                         f"processes")
    dev, backend, _ = placement(rank, world, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(
            backend, init_method=init_method, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return dev, backend


# ------------------------------------------------------------------ mesh
@dataclasses.dataclass
class Mesh:
    """This rank's place on the ('data', 'model') mesh and its groups."""

    data: int
    model: int
    rank: int
    device: torch.device
    backend: str
    data_group: Any = None
    model_group: Any = None
    # gloo groups over every rank for host-side agreement: ``host_group``
    # for the main thread's (checkpoint cadence, barriers), one per loader
    # mode for the batch counts, agreed in a loader thread beside the
    # step's collectives (a group's calls must come in one order)
    host_group: Any = None
    loader_groups: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def data_idx(self) -> int:
        return self.rank // self.model

    @property
    def model_idx(self) -> int:
        return self.rank % self.model

    @property
    def shard(self) -> int:
        """The table shard this rank holds (data-major)."""
        return self.data_idx * self.model + self.model_idx


def make_mesh(data: int = -1, model: int = 1, device=None) -> Mesh:
    """The ('data', 'model') mesh over the initialized process group; -1 =
    all remaining ranks.  Every rank must call it (it makes the groups)."""
    n = dist.get_world_size()
    if data == -1 and model == -1:
        raise ValueError("only one mesh axis may be -1")
    if model == -1:
        model = n // max(data, 1)
    if data == -1:
        data = n // max(model, 1)
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} ranks")
    rank = dist.get_rank()
    backend = dist.get_backend()
    if device is None:
        device, _, _ = placement(rank, n)
    mesh = Mesh(data, model, rank, torch.device(device), backend)
    # every rank makes every group, in one order
    for m in range(model):
        g = dist.new_group([d * model + m for d in range(data)])
        if mesh.model_idx == m:
            mesh.data_group = g
    for d in range(data):
        g = dist.new_group([d * model + m for m in range(model)])
        if mesh.data_idx == d:
            mesh.model_group = g
    mesh.host_group = dist.new_group(backend="gloo")
    for mode in ("train", "eval", "pred"):
        mesh.loader_groups[mode] = dist.new_group(backend="gloo")
    return mesh


def host_any(flag: bool, mesh: Mesh, group=None) -> bool:
    """Whether ``flag`` holds on any rank (over ``group``, default
    ``host_group``); also a barrier."""
    t = torch.tensor([int(flag)], dtype=torch.int32)
    dist.all_reduce(t, group=group or mesh.host_group)
    return bool(t.item())


def host_broadcast(obj, mesh: Mesh, src: int = 0):
    """``obj`` of rank ``src`` on every rank (over ``host_group``)."""
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=mesh.host_group)
    return box[0]


def mesh_from_config(config, device=None) -> Mesh:
    mesh_conf = config.distribution.get("mesh") or {"data": -1, "model": 1}
    return make_mesh(mesh_conf.get("data", -1), mesh_conf.get("model", 1),
                     device)


# -------------------------------------------------------- sharding rules
def is_row_sharded(path, shape, n_shards: int,
                   size_threshold: Optional[int] = None) -> bool:
    """``param_shardings``' rule for one leaf of global ``shape``: 2-D
    embedding ('embed'), fold and wide ('w') tables of at least
    ``size_threshold`` elements per shard, whose rows divide evenly."""
    thr = SHARD_THRESHOLD if size_threshold is None else size_threshold
    keys = set(map(str, path))
    return (n_shards > 1 and len(shape) == 2
            and int(np.prod(shape)) >= thr * n_shards
            and shape[0] % n_shards == 0
            and bool(keys & {"embed", "w", "fold"}))


def param_shardings(params, n_shards: int,
                    size_threshold: Optional[int] = None) -> frozenset:
    """The paths of the row-sharded leaves of a (global) param tree; every
    other leaf is replicated.  An optimizer slot follows its param (the
    port's slots are keyed by the param's path)."""
    from wide_deep_tpu_torch.optim import tree_items
    leaves = dict(tree_items(params))
    out = {p for p, t in leaves.items()
           if is_row_sharded(p, tuple(t.shape), n_shards, size_threshold)}
    # a fold table ([rows, n_logits]) follows its group's embedding table:
    # the two are read by one exchange, each rank concatenating its own
    # rows of both (the JAX package concatenates the two sharded arrays)
    for p in list(leaves):
        if len(p) == 3 and p[:2] == ("linear", "fold"):
            out.discard(p)
            if ("dnn", "embed", p[2]) in out:
                out.add(p)
    return frozenset(out)


def row_range(rows: int, mesh: Mesh) -> Tuple[int, int]:
    """The global rows [lo, hi) of this rank's shard of a ``rows``-row
    table."""
    per = rows // mesh.world
    return mesh.shard * per, (mesh.shard + 1) * per


def shard_params(params, paths: frozenset, mesh: Mesh):
    """In place: each leaf at ``paths`` replaced by a contiguous copy of
    this rank's rows (the full leaf is released)."""
    from wide_deep_tpu_torch.optim import tree_get
    for p in paths:
        parent = tree_get(params, p[:-1])
        full = parent[p[-1]]
        lo, hi = row_range(full.shape[0], mesh)
        parent[p[-1]] = full[lo:hi].clone()
        del full
    return params


def shard_batch(batch: Dict[str, np.ndarray], mesh: Mesh,
                scatter_shards: int) -> Dict[str, np.ndarray]:
    """A global host batch -> this rank's part: batch rows
    ``[data_idx * b, (data_idx + 1) * b)`` of each batch key (b = B /
    data), row ``shard`` of each per-shard plan array (the input
    service's ``key_axis``), kept ``[1, ...]``."""
    from wide_deep_tpu_torch.features.input_service import key_axis
    out = {}
    for k, v in batch.items():
        if key_axis(k, scatter_shards) == "shard":
            out[k] = v[mesh.shard:mesh.shard + 1]
        else:
            b = v.shape[0] // mesh.data
            out[k] = v[mesh.data_idx * b:(mesh.data_idx + 1) * b]
    return out


# ------------------------------------------------------------ collectives
def group_size(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def _staged(t: torch.Tensor, group) -> Tuple[torch.Tensor, bool]:
    """gloo takes host tensors: a card's tensor goes through the host."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return t.cpu(), True
    return t, False


def all_gather(t: torch.Tensor, group, tag: str) -> torch.Tensor:
    """Concatenation of every group member's ``t`` along dim 0, in group
    rank order."""
    n = group_size(group)
    if n == 1:
        return t
    _count(tag, t.nbytes)
    x, staged = _staged(t.contiguous(), group)
    if dist.get_backend(group) == "nccl":
        out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=group)
    else:
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        out = torch.cat(parts)
    return out.to(t.device, non_blocking=False) if staged else out


def all_reduce(t: torch.Tensor, group, tag: str) -> torch.Tensor:
    """The sum over the group of ``t`` (a new tensor)."""
    if group_size(group) == 1:
        return t
    _count(tag, t.nbytes)
    x, staged = _staged(t.contiguous(), group)
    x = x.clone() if not staged else x
    dist.all_reduce(x, group=group)
    return x.to(t.device) if staged else x


def reduce_scatter(t: torch.Tensor, group, tag: str) -> torch.Tensor:
    """This member's block (dim 0 split evenly, group rank order) of the
    group's sum of ``t``."""
    n = group_size(group)
    if n == 1:
        return t
    _count(tag, t.nbytes)
    x, staged = _staged(t.contiguous(), group)
    b = x.shape[0] // n
    i = dist.get_rank(group)
    if dist.get_backend(group) == "nccl":
        out = torch.empty((b,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.reduce_scatter_tensor(out, x, group=group)
    else:
        x = x.clone() if not staged else x
        dist.all_reduce(x, group=group)
        out = x[i * b:(i + 1) * b].contiguous()
    return out.to(t.device) if staged else out


def gather_rows(t: torch.Tensor, dst: int = 0, tag: str = "checkpoint"
                ) -> Optional[torch.Tensor]:
    """Every rank's ``t`` stacked along dim 0 in rank order, on the host of
    rank ``dst`` (None on the others): a row-sharded leaf made whole for a
    checkpoint."""
    n = dist.get_world_size()
    _count(tag, t.nbytes)
    x = t.detach().cpu().contiguous() if dist.get_backend() == "gloo" \
        else t.detach().contiguous()
    if dist.get_backend() == "nccl":
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x)
        return torch.cat(parts).cpu() if dist.get_rank() == dst else None
    parts = ([torch.empty_like(x) for _ in range(n)]
             if dist.get_rank() == dst else None)
    dist.gather(x, parts, dst=dst)
    return torch.cat(parts) if parts is not None else None


