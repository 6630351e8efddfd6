"""One and three train steps of the port against the JAX package's step,
from the same params and batches, with every kernel plan in the batches
(a folded group with a range or a window plan, an unfolded group under the
fused sparse optimizer).

Compared: the loss of each step, every param (the fused sparse-optimizer
table with its accumulator columns, the fold columns, the wide table, the
towers), the BN state, FTRL's n and z and Adagrad's accumulators.

Tolerances (float32 model): the two packages sum in other orders (segment
contraction, matmuls, scatter-adds), so values agree to float32 round-off
amplified by the optimizers' rsqrt over small accumulators: rtol 1e-4,
atol 1e-5 on params and state, rtol 2e-5 on losses.

With the production bfloat16 embeddings and dense layers (three steps) the
absolute values say little, since one step moves a bfloat16 leaf by a few
ulps; so each step's change of every param (after minus before) is held
against JAX's change: elementwise within 4 bfloat16 ulps of the change plus
one ulp of the weight (a rounding may fall the other way) plus 1e-7, and as
a whole within 1% of the change's norm plus 1e-6 of (the weight's norm
plus one), float32 round-off where the first step's gradient is near zero.
A missing, scaled or sign-flipped update fails that.  Optimizer slots keep
each param's dtype in both packages (optax gives a bfloat16 leaf a bfloat16
accumulator); they agree within one bfloat16 ulp where bfloat16, within
1e-3 where float32.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_features import (as_f64, assert_trees_close,  # noqa: E402
                                 batch_pair, force_plans, jax_init,
                                 leaves, plan_pair, to_torch, train_rows,
                                 write_conf)

B = 48
DECAY_STEPS = 2.0     # short, so the decay schedules move within 3 steps


def _jax_slots(opt_state):
    """{('linear'|'dnn', 'accum'|'linear', path): array} of the JAX dense
    optimizer's per-leaf slots (masked leaves skipped)."""
    import optax
    out = {}
    inner = opt_state["dense"].inner_states
    ftrl = inner["linear"].inner_state
    for name, tree in (("accum", ftrl.accum), ("linear", ftrl.linear)):
        for path, v in leaves(jax.device_get(tree)).items():
            if path[0] == "linear" and not isinstance(v, optax.MaskedNode):
                out[("linear", name, path)] = v
    rss = [s for s in jax.tree_util.tree_leaves(
        inner["dnn"].inner_state,
        is_leaf=lambda x: isinstance(x, optax.ScaleByRssState))
        if isinstance(s, optax.ScaleByRssState)][0]
    for path, v in leaves(jax.device_get(rss.sum_of_squares)).items():
        if path[0] == "dnn" and not isinstance(v, optax.MaskedNode):
            out[("dnn", "accum", path)] = v
    return out


def _port_slots(opt_state):
    """Copies of the port's dense optimizer slots, in their own dtypes."""
    out = {}
    for arm, st in opt_state["dense"].items():
        for name in ("accum", "linear"):
            for path, v in st.get(name, {}).items():
                out[(arm, name, path)] = v.detach().clone()
    return out


def _dtype_name(x):
    return str(x.dtype).replace("torch.", "")


def _assert_changes_match(before, after, what):
    """Each leaf's change in the port against JAX's (module docstring);
    ``before``/``after``: (JAX tree, port tree) snapshots."""
    ulp = 2.0 ** -8
    (jb, tb), (ja, ta) = ([leaves(x) for x in pair]
                          for pair in (before, after))
    assert sorted(map(str, ja)) == sorted(map(str, ta)), what
    for path in ja:
        dj = as_f64(ja[path]) - as_f64(jb[path])
        dt = as_f64(ta[path]) - as_f64(tb[path])
        w = np.maximum(np.abs(as_f64(ja[path])), np.abs(as_f64(jb[path])))
        bad = np.abs(dt - dj) > 4 * ulp * np.abs(dj) + ulp * w + 1e-7
        assert not bad.any(), (
            f"{what} {path}: {int(bad.sum())} entries, port change "
            f"{dt[bad][:4]} vs JAX {dj[bad][:4]}")
        norm = np.linalg.norm(dj)
        floor = 1e-6 * (np.linalg.norm(w) + 1.0)
        assert np.linalg.norm(dt - dj) <= 1e-2 * norm + floor, (
            f"{what} {path}: |port - JAX change| "
            f"{np.linalg.norm(dt - dj):.3g} vs |JAX change| {norm:.3g}")


def _run(tmp_path_factory, monkeypatch_ctx, mode, bf16, n_steps):
    """Both packages through ``n_steps`` steps; -> per-step snapshots."""
    from wide_deep_tpu.config import Config as JConfig
    from wide_deep_tpu.models.joint import build_model as jbuild
    from wide_deep_tpu.optim import build_joint_optimizer as jtx
    from wide_deep_tpu.optim import sparse as jsparse
    from wide_deep_tpu.training.step import init_opt_state as jinit_opt
    from wide_deep_tpu.training.step import make_train_step
    from wide_deep_tpu_torch.config import Config as TConfig
    from wide_deep_tpu_torch.interop import from_jax, to_numpy
    from wide_deep_tpu_torch.models.joint import build_model as tbuild
    from wide_deep_tpu_torch.optim import build_joint_optimizer as ttx
    from wide_deep_tpu_torch.optim import sparse as tsparse
    from wide_deep_tpu_torch.training.step import init_opt_state as tinit_opt
    from wide_deep_tpu_torch.training.step import train_step

    force_plans(monkeypatch_ctx, mode)
    conf_dir = write_conf(tmp_path_factory.mktemp(f"step_{mode}"), bf16=bf16)
    jconf, tconf = JConfig(conf_dir), TConfig(conf_dir)
    jp, tp = plan_pair(conf_dir, pallas_scatter=True, sparse_opt=True)
    batches = [batch_pair(jp, tp, train_rows(40, start=40 * i), B)
               for i in range(n_steps)]
    prefix = "scat_" if mode == "range" else "wscat_"
    for b in batches:
        assert any(k.startswith(prefix) for k in b)
        assert any(k.startswith("sopt_") for k in b)
    arms = {"linear": True, "dnn": True}

    jmodel = jbuild(jconf, plan=jp, model_type="wide_deep")
    jtables, jpaths = jsparse.plan_sparse_tables(jp, jconf.model,
                                                 DECAY_STEPS, B)
    assert jtables and all(t.fused for t in jtables.values())
    params_np, mstate_np = jax_init(jmodel, batches[0], jtables)
    tx = jtx(jconf.model, DECAY_STEPS, arms, sparse_paths=jpaths)
    jstep = make_train_step(jmodel, tx, donate=False, sparse_tables=jtables)
    jparams = jax.tree.map(jnp.asarray, params_np)
    jmstate = jax.tree.map(jnp.asarray, mstate_np)
    jopt = jinit_opt(tx, jparams, jtables)

    tmodel = tbuild(tconf, plan=tp, model_type="wide_deep")
    ttables, tpaths = tsparse.plan_sparse_tables(tp, tconf.model,
                                                 DECAY_STEPS, B)
    assert sorted(ttables) == sorted(jtables)
    tparams, tmstate = from_jax(params_np, mstate_np, device="cpu")
    ttxo = ttx(tconf.model, DECAY_STEPS, arms, sparse_paths=tpaths)
    topt = tinit_opt(ttxo, tparams, ttables)

    snaps = [{"params": (params_np, to_numpy(tparams)), "batch": None}]
    for i, b in enumerate(batches):
        jparams, jmstate, jopt, jloss = jstep(
            jparams, jmstate, jopt, {k: jnp.asarray(v) for k, v in b.items()},
            jax.random.PRNGKey(7), i)
        tmstate, tloss = train_step(tmodel, ttxo, tparams, tmstate, topt,
                                    to_torch(b), ttables)
        jp_np = jax.device_get(jparams)
        snaps.append({
            "batch": b,
            "loss": (float(jloss), float(tloss)),
            "params": (jp_np, to_numpy(tparams)),
            "dtypes": ({p: v.dtype.name for p, v in leaves(jp_np).items()},
                       {p: _dtype_name(v) for p, v in leaves(tparams).items()}),
            "bn": (jax.device_get(jmstate), to_numpy(tmstate)),
            "slots": (_jax_slots(jopt), _port_slots(topt)),
            "counts": ([int(s["count"]) for s in jopt["sparse"].values()],
                       [s["count"] for s in topt["sparse"].values()])})
    return snaps[0], snaps[1:]


@pytest.fixture(scope="module", params=["range", "window"])
def trajectory(request, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        yield request.param, _run(tmp_path_factory, mp, request.param,
                                  bf16=False, n_steps=3)
    finally:
        mp.undo()


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_steps_match_jax(trajectory, n_steps):
    mode, (_, snaps) = trajectory
    for i in range(n_steps):
        jl, tl = snaps[i]["loss"]
        assert np.isfinite(tl)
        np.testing.assert_allclose(tl, jl, rtol=2e-5, err_msg=f"step {i}")
    s = snaps[n_steps - 1]
    assert_trees_close(*s["params"], rtol=1e-4, atol=1e-5, what="params")
    assert_trees_close(*s["bn"], rtol=1e-4, atol=1e-5, what="bn")
    jslots, tslots = s["slots"]
    assert sorted(map(str, jslots)) == sorted(map(str, tslots))
    for key, jv in jslots.items():
        np.testing.assert_allclose(as_f64(tslots[key]), as_f64(jv),
                                   rtol=1e-4, atol=1e-5, err_msg=str(key))
    assert s["counts"][0] == s["counts"][1] == [n_steps]


def test_fused_table_moves_only_touched_rows(trajectory):
    """The sparse optimizer writes back exactly the touched rows: rows no
    batch touched equal their init, padding columns stay zero and the
    accumulator columns never fall below their 0.1 init."""
    _, (init, snaps) = trajectory
    _, t0 = init["params"]
    _, t3 = snaps[-1]["params"]
    for key, table in t3["dnn"]["embed"].items():
        if table.shape[1] != 128:
            continue
        dim = int(key[1:])
        touched = np.zeros(table.shape[0], bool)
        for s in snaps:
            uids = s["batch"][f"sopt_uids_{key}"]
            touched[uids[uids < table.shape[0]]] = True
        np.testing.assert_array_equal(table[~touched],
                                      t0["dnn"]["embed"][key][~touched])
        assert np.all(table[:, 2 * dim:] == 0)
        assert table[:, dim:2 * dim].min() >= np.float32(0.1)
        assert np.any(table[touched, :dim]
                      != t0["dnn"]["embed"][key][touched, :dim])


def test_bf16_step_matches_jax(tmp_path_factory):
    """Three steps with the production bfloat16 dtypes: each step's change
    of every param, the optimizer slots with their dtypes, the BN state."""
    mp = pytest.MonkeyPatch()
    try:
        init, snaps = _run(tmp_path_factory, mp, "range", bf16=True,
                           n_steps=3)
    finally:
        mp.undo()
    jdt, tdt = snaps[-1]["dtypes"]
    assert jdt == tdt
    bf16_leaves = [p for p, d in jdt.items() if d == "bfloat16"]
    assert ("dnn", "embed", "d4") in bf16_leaves
    prev = init
    for i, s in enumerate(snaps):
        np.testing.assert_allclose(s["loss"][1], s["loss"][0], rtol=1e-4,
                                   err_msg=f"step {i}")
        _assert_changes_match(prev["params"], s["params"], f"step {i}")
        prev = s
        jslots, tslots = s["slots"]
        assert sorted(map(str, jslots)) == sorted(map(str, tslots))
        for key, jv in jslots.items():
            tv = tslots[key]
            assert _dtype_name(tv) == jv.dtype.name, key
            rtol = 2.0 ** -8 if jv.dtype.name == "bfloat16" else 1e-3
            np.testing.assert_allclose(as_f64(tv), as_f64(jv), rtol=rtol,
                                       atol=1e-6, err_msg=f"step {i} {key}")
        assert_trees_close(*s["bn"], rtol=1e-3, atol=1e-5, what="bn")
    # the bfloat16 tables really moved, so the comparisons above bite
    j0, j3 = leaves(init["params"][0]), leaves(snaps[-1]["params"][0])
    for path in bf16_leaves:
        assert np.any(as_f64(j3[path]) != as_f64(j0[path])), path
