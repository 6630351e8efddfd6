"""The port's WideDeep forward against the JAX package's, from the same
params (carried across by interop.from_jax) and the same batch.

Compared: logits and the prediction dict (inference BN, moving stats), the
training loss and the BN state it produces.  The plan includes a folded
group (wide weights in trailing columns) and a fused sparse-optimizer table.

Tolerances: float32 — rtol 2e-5 / atol 2e-6, float32 round-off of sums
taken in another order (segment contraction, matmuls).  Production bfloat16
embeddings and dense layers — atol/rtol 2e-2: bfloat16 keeps 8 significant
bits, and the two frameworks round to it at different places (products,
bias adds, BN), so activations differ by a few bfloat16 ulps.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_features import (as_f64, assert_trees_close,  # noqa: E402
                                 batch_pair, force_plans, jax_init, leaves,
                                 plan_pair, to_torch, train_rows, write_conf)

B = 48


def _models(conf_dir, n_classes):
    from wide_deep_tpu.config import Config as JConfig
    from wide_deep_tpu.models.joint import build_model as jbuild
    from wide_deep_tpu.optim import sparse as jsparse
    from wide_deep_tpu_torch.config import Config as TConfig
    from wide_deep_tpu_torch.models.joint import build_model as tbuild
    jp, tp = plan_pair(conf_dir, pallas_scatter=True, sparse_opt=True)
    jm = jbuild(JConfig(conf_dir), plan=jp, model_type="wide_deep",
                n_classes=n_classes)
    tm = tbuild(TConfig(conf_dir), plan=tp, model_type="wide_deep",
                n_classes=n_classes)
    tables, _ = jsparse.plan_sparse_tables(jp, JConfig(conf_dir).model,
                                           100.0, B)
    return jp, tp, jm, tm, tables


@pytest.mark.parametrize("bf16,n_classes", [(False, 2), (False, 3),
                                            (True, 2)])
def test_forward_matches_jax(tmp_path, monkeypatch, bf16, n_classes):
    from wide_deep_tpu_torch.interop import from_jax, to_numpy
    force_plans(monkeypatch, "range")
    conf_dir = write_conf(tmp_path, bf16=bf16)
    jp, tp, jm, tm, tables = _models(conf_dir, n_classes)
    batch = batch_pair(jp, tp, train_rows(40), B)
    if n_classes > 2:
        batch["label"] = (np.arange(B) % n_classes).astype(np.float32)
    params_np, mstate_np = jax_init(jm, batch, tables)
    # moving statistics away from their (0, 1) init, so inference BN is
    # exercised with non-trivial state
    rng = np.random.default_rng(0)
    for st in mstate_np["bn"].values():
        st["mean"] = rng.normal(size=st["mean"].shape).astype(np.float32)
        st["var"] = rng.uniform(0.5, 2, st["var"].shape).astype(np.float32)
    tparams, tstate = from_jax(params_np, mstate_np, device="cpu")
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = to_torch(batch)
    tol = dict(rtol=2e-2, atol=2e-2) if bf16 else dict(rtol=2e-5, atol=2e-6)

    jpred = jax.device_get(jm.predict(params_np, mstate_np, jbatch))
    with torch.no_grad():
        tpred = tm.predict(tparams, tstate, tbatch)
    assert sorted(jpred) == sorted(tpred)
    for k in jpred:
        if k == "class_ids":   # may flip only where p sits at 0.5 +- tol
            agree = np.mean(np.asarray(jpred[k]) == tpred[k].numpy())
            assert agree >= (0.95 if bf16 else 1.0), k
        else:
            np.testing.assert_allclose(as_f64(tpred[k]), as_f64(jpred[k]),
                                       err_msg=k, **tol)

    jloss, (jstate, jper, _) = jm.loss_fn(params_np, mstate_np, jbatch,
                                          training=True)
    with torch.no_grad():
        tloss, (tnew, tper, _) = tm.loss_fn(tparams, tstate, tbatch, True)
    np.testing.assert_allclose(float(tloss), float(jloss), **tol)
    np.testing.assert_allclose(as_f64(tper), as_f64(jper), **tol)
    assert_trees_close(jax.device_get(jstate), to_numpy(tnew), what="bn",
                       **tol)


def test_port_init_matches_jax_layout(tmp_path, monkeypatch):
    """The port's own init (torch.Generator) gives the JAX package's tree:
    the same keys, shapes and dtypes, zeros for the wide arm and the fold
    columns, 0.1 accumulator columns and zero padding in fused tables,
    embeddings inside the truncated-normal bounds 2 / sqrt(dim)."""
    from wide_deep_tpu_torch.interop import to_numpy
    from wide_deep_tpu_torch.optim import sparse as tsparse
    force_plans(monkeypatch, "range")
    conf_dir = write_conf(tmp_path, bf16=True)
    jp, tp, jm, tm, tables = _models(conf_dir, 2)
    batch = batch_pair(jp, tp, train_rows(8), 16)
    params_np, mstate_np = jax_init(jm, batch, tables)
    tparams, tstate = tm.init(123, to_torch(batch), "cpu")
    ttables, _ = tsparse.plan_sparse_tables(tp, tm.plan.config.model, 100.0,
                                            16)
    tsparse.init_fused_params(tparams, ttables)
    jl, tl = leaves(params_np), leaves(tparams)
    assert sorted(map(str, jl)) == sorted(map(str, tl))
    for path, jv in jl.items():
        tv = tl[path]
        assert tuple(tv.shape) == jv.shape, path
        assert str(tv.dtype).replace("torch.", "") == jv.dtype.name, path
    assert sorted(leaves(mstate_np)) == sorted(leaves(to_numpy(tstate)))
    tp_np = to_numpy(tparams)
    assert not np.any(tp_np["linear"]["w"]) and not np.any(
        tp_np["linear"]["b"])
    for v in tp_np["linear"]["fold"].values():
        assert not np.any(v)
    for key, table in tp_np["dnn"]["embed"].items():
        dim = int(key[1:])
        emb = table[:, :dim]
        assert np.abs(emb).max() <= 2.0 / np.sqrt(dim) + 1e-6
        assert 0.3 < emb.std() * np.sqrt(dim) < 1.0   # truncated N(0, 1)
        if table.shape[1] == 128:
            assert np.all(table[:, dim:2 * dim] == np.float32(0.1))
            assert not np.any(table[:, 2 * dim:])
