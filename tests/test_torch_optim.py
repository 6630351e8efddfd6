"""The port's seven optimizers against the JAX package's (optax 0.2.6 for
Adagrad, Adam, RMSProp, SGD and Momentum; the package's own FTRL and
ProximalAdagrad), through ``build_joint_optimizer`` on both sides.

Each case runs 3 steps with exponential decay on a two-arm tree (a float32
[64, 3] leaf and a bfloat16 or float32 [32, 5] leaf per arm), the same
seeded numpy gradients through both packages, and compares every param and
every optimizer slot after each step.  Tolerances: float32 within 1e-6
relative (plus 1e-7 absolute, for values that cancel to near zero);
bfloat16 within one bfloat16 ulp elementwise (XLA may keep an intermediate
of a fused bfloat16 expression in float32 where the port rounds each
operation) and within 1% of the leaf's norm, as the bfloat16 step test
holds them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

DECAY_STEPS = 2.0
BF16_ULP = 2.0 ** -7
SPECS = {
    "Adagrad": {"name": "Adagrad", "initial_accumulator_value": 0.1},
    "Adam": {"name": "Adam"},
    "Ftrl": {"name": "Ftrl", "learning_rate": 0.1,
             "l1_regularization_strength": 0.01,
             "l2_regularization_strength": 0.1},
    "RMSProp": {"name": "RMSProp"},
    "RMSPropMomentum": {"name": "RMSProp", "momentum": 0.5},
    "SGD": {"name": "SGD"},
    "Momentum": {"name": "Momentum", "momentum": 0.9},
    "ProximalAdagrad": {"name": "ProximalAdagrad",
                        "l1_regularization_strength": 0.001,
                        "l2_regularization_strength": 0.01},
}


def model_conf(linear_spec, dnn_spec):
    return {"linear_optimizer": dict(linear_spec),
            "linear_initial_learning_rate": 0.05, "linear_decay_rate": 0.8,
            "dnn_optimizer": dict(dnn_spec),
            "dnn_initial_learning_rate": 0.05, "dnn_decay_rate": 0.8}


def _np_tree(rng, bf16):
    import ml_dtypes
    second = ml_dtypes.bfloat16 if bf16 else np.float32
    return {"linear": {"w": rng.normal(size=(64, 3)).astype(np.float32),
                       "v": rng.normal(size=(32, 5)).astype(second)},
            "dnn": {"k": rng.normal(size=(64, 3)).astype(np.float32),
                    "b": rng.normal(size=(32, 5)).astype(second)}}


def _to_torch(tree):
    from wide_deep_tpu_torch.interop import from_jax
    return from_jax(tree, {}, device="cpu")[0]


def _close(got, want, what):
    got = torch.as_tensor(got).float().numpy().astype(np.float64) \
        if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    if getattr(_close, "bf16", False):
        err = np.abs(got - want)
        tol = BF16_ULP * np.maximum(np.abs(got), np.abs(want)) + 1e-30
        assert (err <= tol).all(), (
            f"{what}: {int((err > tol).sum())} entries over one bf16 ulp, "
            f"max err {err.max():.3g}")
        assert np.linalg.norm(got - want) <= 0.01 * np.linalg.norm(want) \
            + 1e-12, what
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                   err_msg=what)


def _jax_slots(opt_state):
    """{(arm, slot, leaf): array} of the JAX optimizer's per-leaf slots,
    named as the port names them (optax's state tuples by their fields:
    ``sum_of_squares`` is Adagrad's accumulator)."""
    names = {"accum": "accum", "linear": "linear",
             "sum_of_squares": "accum", "mu": "mu", "nu": "nu",
             "trace": "trace"}
    out = {}
    for arm, inner in opt_state.inner_states.items():
        for s in jax.tree_util.tree_leaves(
                inner.inner_state, is_leaf=lambda x: hasattr(x, "_fields")):
            for field in getattr(s, "_fields", ()):
                if field not in names:
                    continue
                for k, v in getattr(s, field)[arm].items():
                    out[(arm, names[field], k)] = np.asarray(
                        jax.device_get(v), np.float64)
    return out


def _run(linear, dnn, bf16, steps=3):
    import optax

    from wide_deep_tpu.optim import build_joint_optimizer as jbuild
    from wide_deep_tpu_torch.optim import build_joint_optimizer as tbuild
    conf = model_conf(SPECS[linear], SPECS[dnn])
    arms = {"linear": True, "dnn": True}
    rng = np.random.default_rng(0)
    params_np = _np_tree(rng, bf16)
    jtx = jbuild(conf, DECAY_STEPS, arms)
    jparams = jax.tree.map(jnp.asarray, params_np)
    jstate = jtx.init(jparams)
    ttx = tbuild(conf, DECAY_STEPS, arms)
    tparams = _to_torch(params_np)
    tstate = ttx.init(tparams)
    _close.bf16 = False
    for step in range(steps):
        grads_np = jax.tree.map(
            lambda p: rng.normal(size=p.shape).astype(p.dtype), params_np)
        grads_np["dnn"]["b"][:2] = 0      # zero rows: a fixed point or not
        updates, jstate = jtx.update(jax.tree.map(jnp.asarray, grads_np),
                                     jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tgrads = _to_torch(grads_np)
        ttx.update_(tparams, {(a, k): tgrads[a][k] for a in tgrads
                              for k in tgrads[a]}, tstate)
        for arm in ("linear", "dnn"):
            assert tstate[arm]["count"] == step + 1
            for k, want in jparams[arm].items():
                _close.bf16 = want.dtype == jnp.bfloat16
                _close(tparams[arm][k], np.asarray(want, np.float64),
                       f"step {step} {arm}/{k}")
        # optax keeps RMSProp's trace at momentum 0, where it is the
        # identity; the port keeps none
        jslots = {k: v for k, v in _jax_slots(jstate).items()
                  if not (k[1] == "trace" and SPECS[
                      linear if k[0] == "linear" else dnn]["name"]
                      == "RMSProp" and not SPECS[
                      linear if k[0] == "linear" else dnn].get("momentum"))}
        tslots = {(arm, slot, path[1]): v
                  for arm, st in tstate.items()
                  for slot, leaves in st.items() if slot != "count"
                  for path, v in leaves.items()}
        assert sorted(map(str, jslots)) == sorted(map(str, tslots))
        for key, want in jslots.items():
            _close.bf16 = tslots[key].dtype == torch.bfloat16
            _close(tslots[key], want, f"step {step} slot {key}")


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_optimizer_matches_jax(name, bf16):
    """Each optimizer on both arms, 3 steps with decay."""
    _run(name, name, bf16)


@pytest.mark.parametrize("linear,dnn", [
    ("Ftrl", "Adam"), ("Adam", "RMSPropMomentum"), ("SGD", "Momentum"),
    ("ProximalAdagrad", "Adagrad")])
def test_mixed_arms_match_jax(linear, dnn):
    """``build_joint_optimizer`` with another optimizer on each arm."""
    _run(linear, dnn, bf16=True)


def test_slot_dtypes_follow_the_param():
    """Adam's moments, RMSProp's nu and the traces keep each param's dtype
    (optax's rule); ProximalAdagrad's accumulator is float32."""
    from wide_deep_tpu_torch.optim import build_joint_optimizer
    params = {"linear": {"w": torch.zeros(4, 2)},
              "dnn": {"b": torch.zeros(3, dtype=torch.bfloat16)}}
    for name, slots in (("Adam", ("mu", "nu")), ("RMSPropMomentum",
                                                 ("nu", "trace")),
                        ("Momentum", ("trace",)), ("SGD", ())):
        tx = build_joint_optimizer(model_conf(SPECS[name], SPECS[name]), 1.0,
                                   {"linear": True, "dnn": True})
        st = tx.init(params)
        assert sorted(k for k in st["dnn"] if k != "count") == sorted(slots)
        for slot in slots:
            assert st["dnn"][slot][("dnn", "b")].dtype == torch.bfloat16
            assert st["linear"][slot][("linear", "w")].dtype == torch.float32
    tx = build_joint_optimizer(model_conf(SPECS["ProximalAdagrad"],
                                          SPECS["ProximalAdagrad"]), 1.0,
                               {"linear": True, "dnn": True})
    assert tx.init(params)["dnn"]["accum"][("dnn", "b")].dtype == \
        torch.float32


def test_unknown_optimizer_raises():
    from wide_deep_tpu_torch.optim import build_joint_optimizer
    with pytest.raises(ValueError, match="Lamb"):
        build_joint_optimizer(model_conf({"name": "Lamb"}, SPECS["SGD"]),
                              1.0, {"linear": True, "dnn": True})
