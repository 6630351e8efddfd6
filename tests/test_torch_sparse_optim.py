"""The port's touched-rows updates of tables that are not fused
(``apply_sparse_update``, ``apply_compact_update``), its hand-built sparse
step routing, and the deferred fused update with its flush, against the
JAX package's (tests/test_sparse_optim.py builds the same steps there).

Tolerances: the row formulas run in float32 on both sides, from sums taken
in another order (K1's plain version against the Pallas kernel in
interpret mode): rtol 1e-5 / atol 1e-6 on params and slots, as JAX's own
test holds apply_compact_update against apply_sparse_update.  End to end,
the JAX test's own rtol 5e-4 on losses and rtol 2e-3 / atol 1e-5 on
tables.  Deferred + flush against immediate within the port: bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paths import UNIT_FIXTURE  # noqa: E402
from test_torch_features import leaves  # noqa: E402

R, D, N = 64, 4, 12
NAMES = ["Adagrad", "Ftrl", "ProximalAdagrad", "SGD"]


def _spec(name):
    return {"name": name, "learning_rate": 0.1,
            "initial_accumulator_value": 0.1,
            "l1_regularization_strength": 0.1,
            "l2_regularization_strength": 0.2}


def _tables(spec):
    from wide_deep_tpu.optim.sparse import SparseTable as JTable
    from wide_deep_tpu_torch.optim.sparse import SparseTable as TTable
    kw = dict(name="t", path=("t",), ids_key="ids", spec=spec,
              lr=spec["learning_rate"])
    jt, tt = JTable(**kw), TTable(**kw)
    assert not jt.fused and not tt.fused
    return jt, tt


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    param = rng.normal(size=(R, D)).astype(np.float32)
    ids = np.array([3, 7, 7, 11, 3, 20, 63, 0, 5, 9, 9, 9], np.int32)
    g_rows = rng.normal(size=(N, D)).astype(np.float32)
    grad = np.zeros((R, D), np.float32)
    np.add.at(grad, ids, g_rows)
    return param, ids, g_rows, grad


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=1e-5,
                               atol=1e-6, err_msg=what)


@pytest.mark.parametrize("name", NAMES)
def test_init_table_state_matches_jax(name):
    from wide_deep_tpu.optim.sparse import init_table_state as jinit
    from wide_deep_tpu_torch.optim.sparse import init_table_state as tinit
    jt, tt = _tables(_spec(name))
    param = _inputs()[0]
    js = jinit(jt, jnp.asarray(param))
    ts = tinit(tt, torch.from_numpy(param))
    assert sorted(js) == sorted(ts)
    for k in js:
        if k == "count":
            assert int(js[k]) == ts[k] == 0
        else:
            assert ts[k].dtype == torch.float32
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))


@pytest.mark.parametrize("name", NAMES)
def test_apply_sparse_update_matches_jax(name):
    from wide_deep_tpu.optim.sparse import apply_sparse_update as japply
    from wide_deep_tpu.optim.sparse import init_table_state as jinit
    from wide_deep_tpu_torch.optim.sparse import (apply_sparse_update,
                                                  init_table_state)
    jt, tt = _tables(_spec(name))
    param, ids, _, grad = _inputs()
    jp, js = jnp.asarray(param), jinit(jt, jnp.asarray(param))
    tp = torch.from_numpy(param.copy())
    ts = init_table_state(tt, tp)
    for step in range(2):
        jp, js = japply(jt, jp, jnp.asarray(grad), jnp.asarray(ids), js)
        apply_sparse_update(tt, tp, torch.from_numpy(grad),
                            torch.from_numpy(ids), ts)
        _close(tp.numpy(), np.asarray(jp), f"step {step} param")
        for k in js:
            if k != "count":
                _close(ts[k].numpy(), np.asarray(js[k]), f"step {step} {k}")
        assert ts["count"] == int(js["count"]) == step + 1
    untouched = np.setdiff1d(np.arange(R), ids)
    np.testing.assert_array_equal(tp.numpy()[untouched], param[untouched])


@pytest.mark.parametrize("name", NAMES)
def test_apply_compact_update_matches_jax(name):
    from wide_deep_tpu.optim.sparse import apply_compact_update as japply
    from wide_deep_tpu.optim.sparse import init_table_state as jinit
    from wide_deep_tpu_torch.ops.scatter import make_compact_plan
    from wide_deep_tpu_torch.optim.sparse import (apply_compact_update,
                                                  apply_sparse_update,
                                                  init_table_state)
    jt, tt = _tables(_spec(name))
    param, ids, g_rows, grad = _inputs(3)
    plan = make_compact_plan(ids, R)
    assert (plan["uids"] >= R).any()        # sentinels in the plan
    jp, js = jnp.asarray(param), jinit(jt, jnp.asarray(param))
    jp, js = japply(jt, jp, jnp.asarray(g_rows),
                    {k: jnp.asarray(v) for k, v in plan.items()}, js,
                    interpret=True)
    tp = torch.from_numpy(param.copy())
    ts = init_table_state(tt, tp)
    apply_compact_update(tt, tp, torch.from_numpy(g_rows),
                         {k: torch.from_numpy(v) for k, v in plan.items()},
                         ts)
    _close(tp.numpy(), np.asarray(jp), "param")
    for k in js:
        if k != "count":
            _close(ts[k].numpy(), np.asarray(js[k]), k)
    assert ts["count"] == int(js["count"]) == 1
    # and the same as the dense-gradient path in the port
    tp2 = torch.from_numpy(param.copy())
    ts2 = init_table_state(tt, tp2)
    apply_sparse_update(tt, tp2, torch.from_numpy(grad),
                        torch.from_numpy(ids), ts2)
    _close(tp.numpy(), tp2.numpy(), "compact vs dense-gradient path")


def _small(tmp_path, fold, sparse_opt):
    """Both packages' config, plan and model on the small float32 conf, and
    one batch of the unit fixture through the port's transformer."""
    from wide_deep_tpu.config import Config as JConfig
    from wide_deep_tpu.features.plan import FeaturePlan as JPlan
    from wide_deep_tpu.models.joint import build_model as jbuild
    from wide_deep_tpu_torch.config import Config as TConfig
    from wide_deep_tpu_torch.features.pipeline import FeatureTransformer
    from wide_deep_tpu_torch.features.plan import FeaturePlan as TPlan
    from wide_deep_tpu_torch.models.joint import build_model as tbuild
    from test_torch_features import write_conf
    conf_dir = write_conf(tmp_path / "conf")
    jconf, tconf = JConfig(conf_dir), TConfig(conf_dir)
    jplan = JPlan(jconf, fold=fold, sparse_opt=sparse_opt)
    tplan = TPlan(tconf, fold=fold, sparse_opt=sparse_opt)
    with open(UNIT_FIXTURE) as f:
        rows = [line.rstrip("\n").split("\t") for line in f if line.strip()]
    batch = FeatureTransformer(tplan).transform(rows, 16, "train")
    return (jconf, tconf, jbuild(jconf, plan=jplan, model_type="wide_deep"),
            tbuild(tconf, plan=tplan, model_type="wide_deep"), tplan, batch)


@pytest.mark.parametrize("route", ["compact", "dense_grad"])
def test_hand_built_sparse_step_matches_jax(tmp_path, route):
    """A table the plan leaves dense, made sparse by hand (unfused), as
    JAX's TestEndToEnd does: with its compact plan in the batch the step
    takes apply_compact_update, without it apply_sparse_update on the
    table's dense gradient; 3 steps against JAX's step on the same
    route."""
    from wide_deep_tpu.optim import build_joint_optimizer as jtx
    from wide_deep_tpu.optim.sparse import SparseTable as JTable
    from wide_deep_tpu.training.step import init_opt_state as jinit_opt
    from wide_deep_tpu.training.step import make_train_step
    from wide_deep_tpu_torch.interop import from_jax, to_numpy
    from wide_deep_tpu_torch.ops.scatter import make_compact_plan
    from wide_deep_tpu_torch.optim import build_joint_optimizer as ttx
    from wide_deep_tpu_torch.optim.sparse import SparseTable as TTable
    from wide_deep_tpu_torch.training.step import init_opt_state, train_step
    from test_torch_features import assert_trees_close, jax_init
    jconf, tconf, jmodel, tmodel, plan, batch = _small(tmp_path, False,
                                                       False)
    g = plan.groups[-1]
    assert not g.folded
    if route == "compact":
        for k, v in make_compact_plan(
                batch[f"emb_ids_d{g.dim}"].reshape(-1), g.rows).items():
            batch[f"sopt_{k}_d{g.dim}"] = v
    spec = tconf.model["dnn_optimizer"]
    lr0 = spec.get("learning_rate", tconf.model["dnn_initial_learning_rate"])
    kw = dict(name=f"dnn.embed.d{g.dim}", path=("dnn", "embed", f"d{g.dim}"),
              ids_key=f"emb_ids_d{g.dim}", spec=spec, lr=lr0, dim=g.dim)
    jtables, ttables = {kw["name"]: JTable(**kw)}, {kw["name"]: TTable(**kw)}
    paths = frozenset([kw["path"]])
    arms = {"linear": True, "dnn": True}
    params_np, mstate_np = jax_init(jmodel, batch)
    jt = jtx(jconf.model, 100.0, arms, sparse_paths=paths)
    jstep = make_train_step(jmodel, jt, donate=False, sparse_tables=jtables)
    jparams = jax.tree.map(jnp.asarray, params_np)
    jmstate = jax.tree.map(jnp.asarray, mstate_np)
    jopt = jinit_opt(jt, jparams, jtables)
    tt = ttx(tconf.model, 100.0, arms, sparse_paths=paths)
    tparams, tmstate = from_jax(params_np, mstate_np, device="cpu")
    topt = init_opt_state(tt, tparams, ttables)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for i in range(3):
        jparams, jmstate, jopt, jloss = jstep(jparams, jmstate, jopt, jb,
                                              jax.random.PRNGKey(7), i)
        tmstate, tloss = train_step(tmodel, tt, tparams, tmstate, topt, tb,
                                    ttables)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=5e-4)
    assert_trees_close(jax.device_get(jparams), to_numpy(tparams),
                       rtol=2e-3, atol=1e-5, what="params")
    jslots = jopt["sparse"][kw["name"]]
    tslots = topt["sparse"][kw["name"]]
    assert int(jslots["count"]) == tslots["count"] == 3
    np.testing.assert_allclose(tslots["accum"].numpy(),
                               np.asarray(jslots["accum"]), rtol=2e-3,
                               atol=1e-5)


def _fused_setup(tmp_path, monkeypatch):
    """The small conf unfolded with the fused sparse optimizer forced onto
    its groups (SPARSE_MIN_ROWS 1 in both packages)."""
    import wide_deep_tpu.optim.sparse as jsparse
    import wide_deep_tpu_torch.optim.sparse as tsparse
    monkeypatch.setattr(jsparse, "SPARSE_MIN_ROWS", 1)
    monkeypatch.setattr(tsparse, "SPARSE_MIN_ROWS", 1)
    jconf, tconf, jmodel, tmodel, plan, batch = _small(tmp_path, False, True)
    assert any(k.startswith("sopt_uids_") for k in batch)
    return jconf, tconf, jmodel, tmodel, plan, batch


def _port_run(tconf, tmodel, plan, batch, params_np, mstate_np, defer,
              steps=3):
    import copy

    from wide_deep_tpu_torch.interop import from_jax
    from wide_deep_tpu_torch.optim import build_joint_optimizer
    from wide_deep_tpu_torch.optim import sparse as sparse_lib
    from wide_deep_tpu_torch.training.step import (flush_step,
                                                   init_opt_state,
                                                   seed_pending, train_step)
    tables, paths = sparse_lib.plan_sparse_tables(plan, tconf.model, 100.0,
                                                  16)
    assert tables and all(t.fused for t in tables.values())
    tx = build_joint_optimizer(tconf.model, 100.0,
                               {"linear": True, "dnn": True},
                               sparse_paths=paths)
    params, mstate = from_jax(copy.deepcopy(params_np),
                              copy.deepcopy(mstate_np), device="cpu")
    opt = init_opt_state(tx, params, tables)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    if defer:
        seed_pending(tables, opt, b)
    losses = []
    for _ in range(steps):
        mstate, loss = train_step(tmodel, tx, params, mstate, opt, b,
                                  tables, defer_sparse=defer)
        losses.append(loss)
    if defer:
        flush_step(tables, params, opt)
    return tables, params, mstate, opt, losses


def _bits_equal(a, b, what):
    la, lb = leaves(a), leaves(b)
    assert sorted(map(str, la)) == sorted(map(str, lb)), what
    for path, va in la.items():
        vb = lb[path]
        if isinstance(va, torch.Tensor):
            assert va.dtype == vb.dtype and torch.equal(
                va.reshape(-1).view(torch.uint8),
                vb.reshape(-1).view(torch.uint8)), f"{what} {path}"
        else:
            assert va == vb, f"{what} {path}"


def test_deferred_flush_is_immediate_bit_for_bit(tmp_path, monkeypatch):
    """3 deferred steps + flush_step against 3 immediate steps from the same
    init and batch: the same losses, params and optimizer state (every
    count included), bit for bit; a second flush is a weight no-op."""
    from test_torch_features import jax_init
    from wide_deep_tpu_torch.training.step import flush_step
    _, tconf, jmodel, tmodel, plan, batch = _fused_setup(tmp_path,
                                                         monkeypatch)
    import wide_deep_tpu.optim.sparse as jsparse
    jtables, _ = jsparse.plan_sparse_tables(jmodel.plan, tconf.model, 100.0,
                                            16)
    params_np, mstate_np = jax_init(jmodel, batch, jtables)
    _, ip, im, iopt, il = _port_run(tconf, tmodel, plan, batch, params_np,
                                    mstate_np, defer=False)
    tables, dp, dm, dopt, dl = _port_run(tconf, tmodel, plan, batch,
                                         params_np, mstate_np, defer=True)
    assert [float(x) for x in il] == [float(x) for x in dl]
    _bits_equal(ip, dp, "params")
    _bits_equal(im, dm, "bn")
    pending = dopt.pop("sparse_pending")
    _bits_equal(iopt, dopt, "opt_state")
    assert all(s["count"] == 3 for s in dopt["sparse"].values())
    before = {k: v.clone() for k, v in leaves(dp).items()}
    dopt["sparse_pending"] = pending
    flush_step(tables, dp, dopt)
    for path, v in leaves(dp).items():
        assert torch.equal(v, before[path]), path


def test_deferred_matches_jax_deferred(tmp_path, monkeypatch):
    """The port's deferred run (3 steps + flush) against the JAX package's
    (make_train_step(defer_sparse=True) + make_flush_step) from the same
    params, with the same count -1 seed: losses within rtol 5e-4, the fused
    tables within rtol 2e-3 / atol 1e-5 (the JAX test's own tolerances)."""
    import wide_deep_tpu.optim.sparse as jsparse
    from wide_deep_tpu.optim import build_joint_optimizer as jtx
    from wide_deep_tpu.training.step import (init_opt_state,
                                             make_flush_step,
                                             make_train_step)
    from test_torch_features import jax_init
    jconf, tconf, jmodel, tmodel, plan, batch = _fused_setup(tmp_path,
                                                             monkeypatch)
    jtables, jpaths = jsparse.plan_sparse_tables(jmodel.plan, jconf.model,
                                                 100.0, 16)
    params_np, mstate_np = jax_init(jmodel, batch, jtables)
    tx = jtx(jconf.model, 100.0, {"linear": True, "dnn": True},
             sparse_paths=jpaths)
    step = make_train_step(jmodel, tx, donate=False, sparse_tables=jtables,
                           defer_sparse=True)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    p = jax.tree.map(jnp.asarray, params_np)
    ms = jax.tree.map(jnp.asarray, mstate_np)
    st = init_opt_state(tx, p, jtables)
    st["sparse_pending"] = {
        name: {"rg": jnp.zeros((batch[t.ids_key].size, t.dim), t.sink_dtype),
               **{k: jb[f"sopt_{k}_{t.path[-1]}"]
                  for k in ("uids", "ids", "perm", "tiles")}}
        for name, t in jtables.items()}
    for name in jtables:
        st["sparse"][name]["count"] = jnp.asarray(-1, jnp.int32)
    jlosses = []
    for i in range(3):
        p, ms, st, loss = step(p, ms, st, jb, jax.random.PRNGKey(7), i)
        jlosses.append(float(loss))
    p, st = make_flush_step(jtables)(p, st)
    _, tp, _, topt, tl = _port_run(tconf, tmodel, plan, batch, params_np,
                                   mstate_np, defer=True)
    np.testing.assert_allclose([float(x) for x in tl], jlosses, rtol=5e-4)
    for name, t in jtables.items():
        key = t.path[-1]
        np.testing.assert_allclose(
            tp["dnn"]["embed"][key].numpy(),
            np.asarray(p["dnn"]["embed"][key]), rtol=2e-3, atol=1e-5,
            err_msg=key)
        assert topt["sparse"][name]["count"] == int(st["sparse"][name]
                                                    ["count"]) == 3


def test_defer_needs_fused_tables_and_plans(tmp_path, monkeypatch):
    """A deferred step refuses a batch without its tables' compact plans,
    before it applies anything."""
    from wide_deep_tpu_torch.optim import build_joint_optimizer
    from wide_deep_tpu_torch.optim import sparse as sparse_lib
    from wide_deep_tpu_torch.training.step import (init_opt_state,
                                                   seed_pending, train_step)
    _, tconf, _, tmodel, plan, batch = _fused_setup(tmp_path, monkeypatch)
    tables, paths = sparse_lib.plan_sparse_tables(plan, tconf.model, 100.0,
                                                  16)
    tx = build_joint_optimizer(tconf.model, 100.0,
                               {"linear": True, "dnn": True},
                               sparse_paths=paths)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    params, mstate = tmodel.init(0, b, device="cpu")
    sparse_lib.init_fused_params(params, tables)
    opt = init_opt_state(tx, params, tables)
    seed_pending(tables, opt, b)
    before = {k: v.clone() for k, v in leaves(params).items()}
    no_plan = {k: v for k, v in b.items() if not k.startswith("sopt_")}
    with pytest.raises(ValueError, match="compact plan"):
        train_step(tmodel, tx, params, mstate, opt, no_plan, tables,
                   defer_sparse=True)
    for path, v in leaves(params).items():
        assert torch.equal(v, before[path]), path
