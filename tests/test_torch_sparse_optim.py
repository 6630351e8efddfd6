"""The port's fused touched-rows update of a sparse table
(``apply_fused_update``), the fused tables' slot initialisation, and the
sparse train step on ``plan_sparse_tables``' tables, against the JAX
package's (tests/test_sparse_optim.py builds the same updates there).

Tolerances: the row formulas run in float32 on both sides, from sums taken
in another order (K1's plain version against the Pallas kernel in
interpret mode), and the port's FTRL roots are rounded once from float64:
rtol 1e-5 / atol 1e-6 on the touched rows, as JAX's own test holds its
sparse updates against each other; untouched rows and padding columns bit
for bit.  End to end, the JAX test's own rtol 5e-4 on losses and rtol
2e-3 / atol 1e-5 on params.
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paths import UNIT_FIXTURE  # noqa: E402
from test_torch_features import leaves  # noqa: E402

R, D = 64, 32
NAMES = ["Adagrad", "Ftrl", "ProximalAdagrad", "SGD"]
L1_L2 = {"l1_regularization_strength": 0.1,
         "l2_regularization_strength": 0.2}


def _spec(name):
    return dict({"name": name, "learning_rate": 0.1,
                 "initial_accumulator_value": 0.3}, **L1_L2)


def _tables(spec, path=("t",)):
    """The JAX package's fused table and the port's, one spec."""
    from wide_deep_tpu.optim.sparse import SparseTable as JTable
    from wide_deep_tpu_torch.optim.sparse import SparseTable as TTable
    kw = dict(name="t", path=path, ids_key="ids", spec=spec,
              lr=spec["learning_rate"], dim=D)
    return JTable(fused=True, **kw), TTable(**kw)


def _fused_inputs(spec, seed=0):
    """A float32 [R, 128] fused table (param columns random, accumulators
    positive, FTRL's linear slot random, the padding columns random so a
    write to them shows), a d32 batch's ids with duplicates, and two
    steps' per-entry gradients."""
    from wide_deep_tpu_torch.ops.rowdma import FUSED_WIDTH
    from wide_deep_tpu_torch.optim.sparse import fused_layout
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(R, FUSED_WIDTH)).astype(np.float32)
    if "accum" in fused_layout(spec, D):
        off = fused_layout(spec, D)["accum"]
        table[:, off:off + D] = rng.uniform(0.1, 2.0, (R, D))
    ids = rng.integers(0, R // 2, 48).astype(np.int32)
    ids[:6] = ids[6:12]
    grads = [rng.normal(size=(ids.size, D)).astype(np.float32)
             for _ in range(2)]
    return table, ids, grads


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=1e-5,
                               atol=1e-6, err_msg=what)


@pytest.mark.parametrize("name", NAMES)
def test_apply_fused_update_matches_jax(name):
    """Two fused updates of a d32 table from one compact plan (duplicate
    ids, sentinel uids past the table's rows): the touched rows' param
    and slot columns within rtol 1e-5 / atol 1e-6 of JAX's, the untouched
    rows and every padding column bit for bit as they were."""
    from wide_deep_tpu.optim.sparse import apply_fused_update as japply
    from wide_deep_tpu.optim.sparse import fused_layout as jlayout
    from wide_deep_tpu_torch.ops.scatter import make_compact_plan
    from wide_deep_tpu_torch.optim import sparse as sparse_lib
    spec = _spec(name)
    jt, tt = _tables(spec)
    assert sparse_lib.fused_layout(spec, D) == jlayout(spec, D)
    table, ids, grads = _fused_inputs(spec)
    plan = make_compact_plan(ids, R)
    assert (plan["uids"] >= R).any()        # sentinels in the plan
    tplan = {k: torch.from_numpy(v) for k, v in plan.items()}
    tplan["live"] = sparse_lib.compact_live({"sopt_ids_d32": plan["ids"]}
                                            )["d32"]
    assert tplan["live"] == np.unique(ids).size
    jp, js = jnp.asarray(table), {"count": jnp.zeros([], jnp.int32)}
    tp, ts = torch.from_numpy(table.copy()), {"count": 0}
    for g in grads:
        jp, js = japply(jt, jp, jnp.asarray(g),
                        {k: jnp.asarray(v) for k, v in plan.items()}, js,
                        interpret=True)
        sparse_lib.apply_fused_update(tt, tp, torch.from_numpy(g), tplan,
                                      ts)
    assert ts["count"] == int(js["count"]) == 2
    got, want = tp.numpy(), np.asarray(jp)
    used = sparse_lib.fused_live_width(spec, D)
    touched = np.zeros(R, bool)
    touched[ids] = True
    _close(got[touched, :used], want[touched, :used], "touched rows")
    assert not np.array_equal(got[touched, :D], table[touched, :D])
    np.testing.assert_array_equal(got[~touched], table[~touched])
    np.testing.assert_array_equal(want[~touched], table[~touched])
    np.testing.assert_array_equal(got[:, used:], table[:, used:])


@pytest.mark.parametrize("name", NAMES)
def test_init_fused_params_matches_jax(name):
    """The slot columns of a fused table the model made (param columns
    set, the rest zero) set as JAX's init sets them: the accumulator at
    its initial value, FTRL's linear slot and the padding zero, the param
    columns as they were; bit for bit."""
    from wide_deep_tpu.optim.sparse import init_fused_params as jinit
    from wide_deep_tpu_torch.ops.rowdma import FUSED_WIDTH
    from wide_deep_tpu_torch.optim.sparse import (fused_layout,
                                                  fused_live_width,
                                                  init_fused_params)
    spec = _spec(name)
    path = ("dnn", "embed", f"d{D}")
    jt, tt = _tables(spec, path)
    made = np.zeros((R, FUSED_WIDTH), np.float32)
    made[:, :D] = np.random.default_rng(1).normal(size=(R, D))
    want = np.asarray(jinit({"dnn": {"embed": {path[-1]: jnp.asarray(
        made)}}}, {"t": jt})["dnn"]["embed"][path[-1]])
    got = init_fused_params({"dnn": {"embed": {path[-1]: torch.from_numpy(
        made.copy())}}}, {"t": tt})["dnn"]["embed"][path[-1]].numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, :D], made[:, :D])
    layout = fused_layout(spec, D)
    for key, off in layout.items():
        np.testing.assert_array_equal(
            got[:, off:off + D],
            np.float32(0.3 if key == "accum" else 0.0), err_msg=key)
    assert not got[:, fused_live_width(spec, D):].any()


def _small(tmp_path, rule=None):
    """Both packages' config, plan and model on the small float32 conf
    unfolded with the sparse optimizer on (``rule``: the dnn arm's
    optimizer, l1/l2 set, in place of the conf's Adagrad), and one batch
    of the unit fixture through the port's transformer."""
    from wide_deep_tpu.config import Config as JConfig
    from wide_deep_tpu.features.plan import FeaturePlan as JPlan
    from wide_deep_tpu.models.joint import build_model as jbuild
    from wide_deep_tpu_torch.config import Config as TConfig
    from wide_deep_tpu_torch.features.pipeline import FeatureTransformer
    from wide_deep_tpu_torch.features.plan import FeaturePlan as TPlan
    from wide_deep_tpu_torch.models.joint import build_model as tbuild
    from test_torch_features import write_conf
    conf_dir = write_conf(tmp_path / "conf")
    if rule is not None:
        path = tmp_path / "conf" / "model.yaml"
        text = path.read_text()
        assert "dnn_optimizer: Adagrad\n" in text
        path.write_text(text.replace(
            "dnn_optimizer: Adagrad\n",
            f"dnn_optimizer: {{name: {rule}, l1_regularization_strength: "
            f"0.1, l2_regularization_strength: 0.2}}\n"))
    jconf, tconf = JConfig(conf_dir), TConfig(conf_dir)
    jplan = JPlan(jconf, fold=False, sparse_opt=True)
    tplan = TPlan(tconf, fold=False, sparse_opt=True)
    with open(UNIT_FIXTURE) as f:
        rows = [line.rstrip("\n").split("\t") for line in f if line.strip()]
    batch = FeatureTransformer(tplan).transform(rows, 16, "train")
    return (jconf, tconf, jbuild(jconf, plan=jplan, model_type="wide_deep"),
            tbuild(tconf, plan=tplan, model_type="wide_deep"), tplan, batch)


def _fused_setup(tmp_path, monkeypatch, rule=None):
    """``_small`` with the fused sparse optimizer forced onto its groups
    (SPARSE_MIN_ROWS 1 in both packages)."""
    import wide_deep_tpu.optim.sparse as jsparse
    import wide_deep_tpu_torch.optim.sparse as tsparse
    monkeypatch.setattr(jsparse, "SPARSE_MIN_ROWS", 1)
    monkeypatch.setattr(tsparse, "SPARSE_MIN_ROWS", 1)
    jconf, tconf, jmodel, tmodel, plan, batch = _small(tmp_path, rule)
    assert any(k.startswith("sopt_uids_") for k in batch)
    return jconf, tconf, jmodel, tmodel, plan, batch


def _port_setup(tconf, tmodel, plan, params_np, mstate_np):
    """The port's sparse tables, optimizer, params, BN state and optimizer
    state from the JAX package's initial params."""
    from wide_deep_tpu_torch.interop import from_jax
    from wide_deep_tpu_torch.optim import build_joint_optimizer
    from wide_deep_tpu_torch.optim import sparse as sparse_lib
    from wide_deep_tpu_torch.training.step import init_opt_state
    tables, paths = sparse_lib.plan_sparse_tables(plan, tconf.model, 100.0,
                                                  16)
    assert tables
    tx = build_joint_optimizer(tconf.model, 100.0,
                               {"linear": True, "dnn": True},
                               sparse_paths=paths)
    params, mstate = from_jax(copy.deepcopy(params_np),
                              copy.deepcopy(mstate_np), device="cpu")
    return tables, tx, params, mstate, init_opt_state(tx, params, tables)


@pytest.mark.parametrize("name", NAMES)
def test_fused_sparse_step_matches_jax(tmp_path, monkeypatch, name):
    """3 train_step calls on plan_sparse_tables' fused tables under each
    sparse-capable rule against JAX's make_train_step from the same
    params: losses within rtol 5e-4, every param (the fused tables' slot
    columns included) within rtol 2e-3 / atol 1e-5, each table's count 3
    in both."""
    import wide_deep_tpu.optim.sparse as jsparse
    from wide_deep_tpu.optim import build_joint_optimizer as jtx
    from wide_deep_tpu.training.step import init_opt_state as jinit_opt
    from wide_deep_tpu.training.step import make_train_step
    from wide_deep_tpu_torch.interop import to_numpy
    from wide_deep_tpu_torch.training.step import train_step
    from test_torch_features import assert_trees_close, jax_init
    jconf, tconf, jmodel, tmodel, plan, batch = _fused_setup(
        tmp_path, monkeypatch, name)
    jtables, jpaths = jsparse.plan_sparse_tables(jmodel.plan, jconf.model,
                                                 100.0, 16)
    assert {t.spec["name"] for t in jtables.values()} == {name}
    params_np, mstate_np = jax_init(jmodel, batch, jtables)
    jt = jtx(jconf.model, 100.0, {"linear": True, "dnn": True},
             sparse_paths=jpaths)
    jstep = make_train_step(jmodel, jt, donate=False, sparse_tables=jtables)
    jparams = jax.tree.map(jnp.asarray, params_np)
    jmstate = jax.tree.map(jnp.asarray, mstate_np)
    jopt = jinit_opt(jt, jparams, jtables)
    tables, tx, tparams, tmstate, topt = _port_setup(
        tconf, tmodel, plan, params_np, mstate_np)
    assert sorted(tables) == sorted(jtables)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for i in range(3):
        jparams, jmstate, jopt, jloss = jstep(jparams, jmstate, jopt, jb,
                                              jax.random.PRNGKey(7), i)
        tmstate, tloss = train_step(tmodel, tx, tparams, tmstate, topt, tb,
                                    tables)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=5e-4,
                                   err_msg=f"step {i}")
    assert_trees_close(jax.device_get(jparams), to_numpy(tparams),
                       rtol=2e-3, atol=1e-5, what="params")
    for n in tables:
        assert topt["sparse"][n] == {"count": 3}
        assert int(jopt["sparse"][n]["count"]) == 3


@pytest.mark.parametrize("missing", ["every", "one"])
def test_sparse_table_without_plan_is_refused(tmp_path, monkeypatch,
                                              missing):
    """A step whose batch lacks a sparse table's compact plan (every
    table's, or one table's of several) raises ValueError before it
    changes a param or a count."""
    from test_torch_features import jax_init
    from wide_deep_tpu_torch.training.step import train_step
    _, tconf, jmodel, tmodel, plan, batch = _fused_setup(tmp_path,
                                                         monkeypatch)
    params_np, mstate_np = jax_init(jmodel, batch)
    tables, tx, params, mstate, opt = _port_setup(tconf, tmodel, plan,
                                                  params_np, mstate_np)
    keys = sorted(t.path[-1] for t in tables.values())
    assert len(keys) > 1
    drop = keys if missing == "every" else keys[-1:]
    b = {k: torch.from_numpy(v) for k, v in batch.items()
         if not (k.startswith("sopt_") and k.rsplit("_", 1)[-1] in drop)}
    before = {k: v.clone() for k, v in leaves(params).items()}
    with pytest.raises(ValueError, match=r"compact plan \(sopt_\*_("
                       + "|".join(drop) + r")\)"):
        train_step(tmodel, tx, params, mstate, opt, b, tables)
    for path, v in leaves(params).items():
        assert torch.equal(v, before[path]), path
    assert all(s == {"count": 0} for s in opt["sparse"].values())
