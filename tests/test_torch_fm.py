"""The FM second-order term of the port's wide arm (``linear_fm_factors``)
against the JAX package's.

* ``_fm_term`` on a toy case and on a plan with an indicator block: rtol
  1e-5 (float32 sums in another order);
* ``v``'s shape, and the two refusals of a folded plan;
* 3 train steps of ``wide`` and ``wide_deep`` FM models against the JAX
  step from the same params (``v`` carried across by ``interop.from_jax``,
  the port cannot draw JAX's): losses within rtol 2e-5, params and
  optimizer slots within rtol 1e-4 / atol 1e-5, as the step test holds
  them;
* a wide + FM Trainer trains and improves on the unit fixture, as
  tests/test_fm.py asks of the JAX package.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paths import UNIT_FIXTURE, TRAIN1  # noqa: E402
from test_torch_features import (assert_trees_close, batch_pair,  # noqa: E402
                                 jax_init, leaves, plan_pair, to_torch,
                                 train_rows, write_conf)

K = 4
B = 24


def fm_conf(dst, k=K) -> str:
    conf_dir = write_conf(dst)
    path = os.path.join(conf_dir, "model.yaml")
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text.replace("linear_fm_factors: 0",
                             f"linear_fm_factors: {k}"))
    return conf_dir


def test_fm_term_matches_manual_and_jax():
    """0.5 * sum((sum x_i v_i)^2 - sum x_i^2 v_i^2) on a toy case."""
    from wide_deep_tpu.models.linear import _fm_term as jfm
    from wide_deep_tpu_torch.models.linear import _fm_term as tfm
    rng = np.random.default_rng(0)
    v = rng.normal(size=(100, 3)).astype(np.float32)
    ids = np.asarray([[2, 7, 7, 0], [1, 1, 5, 99]], np.int32)
    wts = np.asarray([[1.0, 1.0, 0.5, 0.0], [0.3, 2.0, 1.0, 1.0]],
                     np.float32)
    got = tfm(torch.from_numpy(v), {"wide_ids": torch.from_numpy(ids),
                                    "wide_wts": torch.from_numpy(wts)},
              None).numpy()
    want = np.asarray(jfm(jnp.asarray(v), {"wide_ids": jnp.asarray(ids),
                                           "wide_wts": jnp.asarray(wts)},
                          None))
    active = [(2, 1.0), (7, 1.0), (7, 0.5)]
    s1 = sum(w * v[i] for i, w in active)
    s2 = sum((w ** 2) * v[i] ** 2 for i, w in active)
    np.testing.assert_allclose(got[0], 0.5 * float(np.sum(s1 ** 2 - s2)),
                               rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.fixture(scope="module")
def fm_pair(tmp_path_factory):
    """(JAX plan, port plan, numpy batch) of an FM config (fold off)."""
    conf_dir = fm_conf(tmp_path_factory.mktemp("fm_conf"))
    jp, tp = plan_pair(conf_dir, fold=False)
    batch = batch_pair(jp, tp, train_rows(20), B)
    return conf_dir, jp, tp, batch


def test_fm_term_with_indicator_block_matches_jax(fm_pair):
    from wide_deep_tpu.models.deep import PlanConstants as JConsts
    from wide_deep_tpu.models.linear import _fm_term as jfm
    from wide_deep_tpu_torch.models.deep import PlanConstants as TConsts
    from wide_deep_tpu_torch.models.linear import _fm_term as tfm
    _, jp, tp, batch = fm_pair
    assert tp.indicator_dim > 0
    v = np.random.default_rng(1).normal(
        size=(tp.wide_dim, K)).astype(np.float32) * 0.1
    got = tfm(torch.from_numpy(v), to_torch(batch), TConsts(tp)).numpy()
    want = np.asarray(jfm(jnp.asarray(v), {k: jnp.asarray(x)
                                           for k, x in batch.items()},
                          JConsts(jp)))
    assert got.shape == (B,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_params_include_factors(fm_pair):
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.models.joint import build_model
    conf_dir, _, tp, batch = fm_pair
    model = build_model(Config(conf_dir), plan=tp, model_type="wide")
    assert model.fm_factors == K
    params, _ = model.init(0, to_torch(batch), device="cpu")
    v = params["linear"]["v"]
    assert v.shape == (tp.wide_dim, K) and v.dtype == torch.float32
    assert 0.005 < float(v.std()) < 0.02
    # the deep arm draws the same weights with and without the factors
    nofm = build_model(Config(conf_dir), plan=tp, model_type="wide_deep")
    nofm.fm_factors = 0
    fm = build_model(Config(conf_dir), plan=tp, model_type="wide_deep")
    p0, _ = nofm.init(0, to_torch(batch), device="cpu")
    p1, _ = fm.init(0, to_torch(batch), device="cpu")
    assert "v" not in p0["linear"] and "v" in p1["linear"]
    for path, t in leaves(p0["dnn"]).items():
        assert torch.equal(t, leaves(p1["dnn"])[path]), path


def test_folded_plan_refusals(tmp_path):
    """A folded plan with model_type 'wide', and a folded plan with FM, are
    refused as the JAX package refuses them."""
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.features.plan import FeaturePlan
    from wide_deep_tpu_torch.models.joint import WideDeep, build_model
    conf_dir = write_conf(tmp_path / "conf")
    config = Config(conf_dir)
    folded = FeaturePlan(config, fold=True)
    assert folded.fold
    with pytest.raises(ValueError, match="model_type 'wide'"):
        build_model(config, plan=folded, model_type="wide")
    spec = build_model(config, plan=folded, model_type="wide_deep").deep_spec
    with pytest.raises(ValueError, match="fold=False"):
        WideDeep(plan=folded, deep_spec=spec, model_type="wide_deep",
                 fm_factors=K)
    # FM turns the fold off by itself
    fm = Config(fm_conf(tmp_path / "fm"))
    model = build_model(fm, model_type="wide_deep")
    assert not model.plan.fold and model.fm_factors == K


@pytest.mark.parametrize("model_type", ["wide", "wide_deep"])
def test_fm_train_steps_match_jax(fm_pair, model_type):
    from wide_deep_tpu.config import Config as JConfig
    from wide_deep_tpu.models.joint import build_model as jbuild
    from wide_deep_tpu.optim import build_joint_optimizer as jtx
    from wide_deep_tpu.training.step import init_opt_state as jinit_opt
    from wide_deep_tpu.training.step import make_train_step
    from wide_deep_tpu_torch.config import Config as TConfig
    from wide_deep_tpu_torch.interop import from_jax, to_numpy
    from wide_deep_tpu_torch.models.joint import build_model as tbuild
    from wide_deep_tpu_torch.optim import build_joint_optimizer as ttx
    from wide_deep_tpu_torch.training.step import init_opt_state as tinit
    from wide_deep_tpu_torch.training.step import train_step
    conf_dir, jp, tp, _ = fm_pair
    batches = [batch_pair(jp, tp, train_rows(20, start=20 * i), B)
               for i in range(3)]
    arms = {"linear": True, "dnn": model_type == "wide_deep"}
    jconf, tconf = JConfig(conf_dir), TConfig(conf_dir)
    jmodel = jbuild(jconf, plan=jp, model_type=model_type)
    assert jmodel.fm_factors == K
    params_np, mstate_np = jax_init(jmodel, batches[0])
    assert params_np["linear"]["v"].shape == (jp.wide_dim, K)
    jt = jtx(jconf.model, 2.0, arms)
    jstep = make_train_step(jmodel, jt, donate=False)
    jparams = jax.tree.map(jnp.asarray, params_np)
    jmstate = jax.tree.map(jnp.asarray, mstate_np)
    jopt = jinit_opt(jt, jparams)
    tmodel = tbuild(tconf, plan=tp, model_type=model_type)
    tparams, tmstate = from_jax(params_np, mstate_np, device="cpu")
    tt = ttx(tconf.model, 2.0, arms)
    topt = tinit(tt, tparams)
    for i, b in enumerate(batches):
        jparams, jmstate, jopt, jloss = jstep(
            jparams, jmstate, jopt, {k: jnp.asarray(v) for k, v in b.items()},
            jax.random.PRNGKey(7), i)
        tmstate, tloss = train_step(tmodel, tt, tparams, tmstate, topt,
                                    to_torch(b))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-5,
                                   err_msg=f"step {i}")
    jp_np = jax.device_get(jparams)
    assert_trees_close(jp_np, to_numpy(tparams), rtol=1e-4, atol=1e-5,
                       what="params")
    # v really moved, and FTRL's slots for it agree
    assert not np.allclose(jp_np["linear"]["v"], params_np["linear"]["v"])
    ftrl = jopt.inner_states["linear"].inner_state
    for slot, tree in (("accum", ftrl.accum), ("linear", ftrl.linear)):
        np.testing.assert_allclose(
            topt["dense"]["linear"][slot][("linear", "v")].numpy(),
            np.asarray(tree["linear"]["v"]), rtol=1e-4, atol=1e-5,
            err_msg=slot)


def test_fm_trains_and_improves(tmp_path):
    """wide + FM passes the trains-and-improves bar on the unit fixture."""
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.training.loop import Trainer
    conf_dir = fm_conf(tmp_path / "conf")
    tr = Trainer(Config(conf_dir), model_type="wide",
                 model_dir=str(tmp_path / "m"), device="cpu",
                 overrides=dict(train_data=UNIT_FIXTURE,
                                eval_data=UNIT_FIXTURE,
                                test_data=UNIT_FIXTURE, keep_train=True,
                                batch_size=16))
    tr.ensure_initialized(restore=False)
    assert "v" in tr.params["linear"]
    tr.train_file(UNIT_FIXTURE)
    first = tr.evaluate(UNIT_FIXTURE)
    for _ in range(10):
        tr.train_file(UNIT_FIXTURE)
    final = tr.evaluate(UNIT_FIXTURE)
    assert final["loss"] < first["loss"]


def test_fm_wide_deep_trains_on_train_file(tmp_path):
    """The production model type with FM: the plan unfolds, every group's
    backward runs, losses stay finite."""
    from wide_deep_tpu_torch.config import Config
    from wide_deep_tpu_torch.training.loop import Trainer
    conf_dir = fm_conf(tmp_path / "conf")
    data = str(tmp_path / "head")
    with open(TRAIN1) as f, open(data, "w") as out:
        for _ in range(48):
            out.write(f.readline())
    tr = Trainer(Config(conf_dir), model_type="wide_deep",
                 model_dir=str(tmp_path / "m"), device="cpu",
                 overrides=dict(train_data=data, keep_train=True,
                                batch_size=16))
    assert not tr.plan.fold
    tr.train_file(data)
    assert tr.global_step == 3
    assert all(np.isfinite(float(x)) for x in tr.losses)
