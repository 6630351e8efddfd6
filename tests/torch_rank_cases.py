"""Rank side of the port's multi-rank CPU tests (tests/test_torch_exchange,
test_torch_parallel, test_torch_distributed).

``run_ranks(case, world, tmp_path, args)`` starts ``world`` processes of
this file, which join one gloo process group through a FileStore under
``tmp_path`` (no TCP port, so parallel test workers never collide), run
``CASES[case](mesh_factory, args)`` on the port's CPU paths and each write
their result; the parent gets the results in rank order.  The ranks import
neither jax nor the JAX package (each asserts so before it writes): the
tests compute the JAX references in the pytest process.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def run_ranks(case: str, world: int, tmp_path, args, timeout: float = 600,
              device: str = "cpu"):
    """Run ``case`` on ``world`` ranks (on the host, or with ``device``
    "cuda" on the cards by parallel/mesh.placement) -> their results, rank
    order."""
    d = os.path.join(str(tmp_path), f"ranks_{case}_{os.getpid()}_"
                     f"{len(os.listdir(str(tmp_path)))}")
    os.makedirs(d)
    inp = os.path.join(d, "args.pt")
    torch.save(args, inp)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [REPO, HERE, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), case, str(r), str(world),
         os.path.join(d, "store"), inp, d, device],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=d) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {case} failed:\n{out[-4000:]}"
    return [torch.load(os.path.join(d, f"r{r}.pt"), weights_only=False)
            for r in range(world)]


# ----------------------------------------------------------------- cases
def _meshes(device):
    from wide_deep_tpu_torch.parallel import mesh as mesh_lib
    cache = {}

    def get(shape):
        if shape not in cache:
            cache[shape] = mesh_lib.make_mesh(shape[0], shape[1], device)
        return cache[shape]
    return get


def _local(arr: np.ndarray, mesh) -> np.ndarray:
    b = arr.shape[0] // mesh.data
    return arr[mesh.data_idx * b:(mesh.data_idx + 1) * b]


def _shard(arr: np.ndarray, mesh) -> np.ndarray:
    per = arr.shape[0] // mesh.world
    return arr[mesh.shard * per:(mesh.shard + 1) * per]


def case_exchange(mesh_of, args):
    """Each entry: a row-sharded table's gather (explicit, planned or the
    static-rows gather) forward and backward against a cotangent -> the
    rank's output rows, its shard's gradient, and the bytes by tag."""
    from wide_deep_tpu_torch.parallel import exchange
    from wide_deep_tpu_torch.parallel import mesh as mesh_lib
    results = []
    for c in args:
        mesh = mesh_of(tuple(c["mesh"]))
        dev = mesh.device
        dtype = getattr(torch, c.get("dtype", "float32"))
        table = torch.from_numpy(_shard(c["table"], mesh)).to(dev, dtype)
        table.requires_grad_(True)
        mesh_lib.reset_counters()
        exchange.branch_counts.clear()
        if c["kind"] == "static":
            ids = torch.from_numpy(c["ids"].reshape(-1)).long().to(dev)
            cot = torch.from_numpy(c["cot"]).to(dev)
            out = exchange.StaticRowsGather.apply(mesh, ids, table)
        else:
            ids = torch.from_numpy(_local(c["ids"], mesh).reshape(-1)).to(dev)
            cot = torch.from_numpy(_local(c["cot"], mesh)).reshape(
                ids.shape[0], -1).to(dev)
            plan = None
            if c.get("plan") is not None:
                plan = {k: (int(v[mesh.shard]) if k in ("ok", "live")
                            else torch.from_numpy(v[mesh.shard]).to(dev))
                        for k, v in c["plan"].items()}
            out = exchange.ExchangeGather.apply(mesh, ids, plan, table)
        torch.sum(out.float() * cot.float()).backward()
        results.append({"out": out.detach().float().cpu().numpy(),
                        "grad": table.grad.float().cpu().numpy(),
                        "branches": dict(exchange.branch_counts),
                        "bytes": dict(mesh_lib.collective_bytes),
                        "max_bytes": dict(mesh_lib.collective_max_bytes)})
    return results


def case_sparse(mesh_of, args):
    """Each entry: apply_fused_sharded_update on the rank's shard of a
    fused table -> the updated shard and the bytes by tag."""
    from wide_deep_tpu_torch.optim import sparse as sparse_lib
    from wide_deep_tpu_torch.parallel import mesh as mesh_lib
    results = []
    for c in args:
        mesh = mesh_of(tuple(c["mesh"]))
        fused = torch.from_numpy(_shard(c["fused"], mesh).copy())
        table = sparse_lib.SparseTable(
            name="t", path=("t",), ids_key="ids", spec=c["spec"],
            lr=c["lr"], dim=c["dim"], fused=True)
        plan = {k: (int(v[mesh.shard]) if k in ("ok", "live")
                    else torch.from_numpy(v[mesh.shard]))
                for k, v in c["plan"].items()}
        rg = torch.from_numpy(_local(c["row_grads"].reshape(
            c["ids"].shape[0], -1, c["dim"]), mesh).reshape(-1, c["dim"]))
        ids = torch.from_numpy(_local(c["ids"], mesh))
        mesh_lib.reset_counters()
        st = {"count": 0}
        sparse_lib.apply_fused_sharded_update(table, fused, rg, ids, plan,
                                              st, mesh)
        results.append({"shard": fused.numpy(),
                        "bytes": dict(mesh_lib.collective_bytes),
                        "max_bytes": dict(mesh_lib.collective_max_bytes)})
    return results


def case_trainer(mesh_of, args):
    """A Trainer on the ranks: optional starting params (whole, as one
    device holds them), ``steps`` batches of ``data`` (a full pass when
    None), an evaluation, and a checkpoint written (``save``) or the
    latest restored first (``restore``) -> losses, metrics, the whole state
    (on rank 0)."""
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.parallel import mesh as mesh_lib
    from wide_deep_tpu_torch.training import checkpoint as ckpt_lib
    from wide_deep_tpu_torch.training.loop import Trainer
    import torch.distributed as dist
    mesh = mesh_of(tuple(args["mesh"]))
    if args.get("force_plans"):
        _force_plans(args["force_plans"])
    tr = Trainer(Config(args["conf_dir"]), model_type="wide_deep",
                 model_dir=args["model_dir"], overrides=args["overrides"],
                 device="cpu", mesh=mesh)
    if args.get("params") is not None:
        tr.params = {k: v for k, v in args["params"].items()}
        tr.mstate = args["mstate"]
    tr.ensure_initialized(restore=bool(args.get("restore")))
    out = {"rank": mesh.rank, "step0": tr.global_step,
           "paths": sorted(tr.sharded_paths),
           "plan_keys": None}
    if args.get("train", True):
        seen = []
        orig = tr.train_batch

        def record(b, **kw):
            seen.append(sorted(k for k in b))
            return orig(b, **kw)
        tr.train_batch = record
        tr.train_file(args["data"], max_steps=args.get("steps"))
        out["plan_keys"] = seen[0] if seen else None
    out["losses"] = [float(x) for x in tr.losses]
    out["eval"] = tr.evaluate(args["eval_data"]) if args.get(
        "eval_data") else None
    if args.get("save"):
        tr.save()
    tree = {"params": tr.params, "mstate": tr.mstate,
            "opt_state": tr.opt_state}
    names = ckpt_lib.sharded_names(tree, tr.sharded_paths)
    whole = ckpt_lib.gather_sharded(tree, names)
    if whole is not None:
        out["state"] = {n: t.detach().clone() for n, t in
                        ckpt_lib.named_leaves(whole)
                        if isinstance(t, torch.Tensor)}
    out["bytes"] = dict(mesh_lib.collective_bytes)
    out["global_step"] = tr.global_step
    dist.barrier()
    return out


def _force_plans(mode: str):
    """Kernel plans at test batch sizes (tests/test_torch_features
    .force_plans' rule, with the sharded gate): folded groups take a range
    ('range') or window ('window') plan when they row-shard; unfolded ones
    the fused sparse optimizer."""
    import wide_deep_tpu_torch.features.plan as tplan
    import wide_deep_tpu_torch.optim.sparse as tsparse
    tsparse.SPARSE_MIN_ROWS = 1
    want_range = mode == "range"

    def sharded_ok(self, g):
        s = self.scatter_shards
        return s == 1 or (g.rows % s == 0
                          and g.rows * g.dim >= self.shard_threshold * s)

    tplan.FeaturePlan.scatter_group = (
        lambda self, g, b: want_range and self.pallas_scatter and g.folded
        and sharded_ok(self, g))
    tplan.FeaturePlan.window_group = (
        lambda self, g, b: not want_range and self.pallas_scatter
        and g.folded and sharded_ok(self, g))


CASES = {"exchange": case_exchange, "sparse": case_sparse,
         "trainer": case_trainer}


def main(argv):
    case, rank, world, store, inp, out, device = argv
    torch.set_num_threads(1)
    import torch.distributed as dist
    from wide_deep_tpu_torch.parallel import mesh as mesh_lib
    dev, _ = mesh_lib.init_distributed(int(rank), int(world),
                                       "file://" + store, device)
    args = torch.load(inp, weights_only=False)
    result = CASES[case](_meshes(dev), args)
    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith(("jax.", "wide_deep_tpu.")))
    assert not leaked, f"a rank imported {leaked[:5]}"
    torch.save(result, os.path.join(out, f"r{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
