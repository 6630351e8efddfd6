"""The port's CNN arm (wide_deep_tpu_torch/models/cnn) against the JAX
package's (wide_deep_tpu/models/cnn): VGG16 at full width, VGG19's shapes,
every ResNet variant, the npy weight bridge.  The port starts from the JAX
weights (interop.from_jax); inputs are seeded numpy arrays.

Tolerances:
- float64 (both packages run in float64, JAX under ``jax.enable_x64``):
  logits, every gradient leaf and the BN state within 1e-10 relative.  This
  is where the ResNets' gradients are held: in float32 a ReLU input or a
  max-pool window's runner-up within round-off of the winner routes the
  gradient by its last bit, in JAX against its own float64 gradient as in
  the port, and a ResNet-50 at batch 2 (BN over 8 values a channel in its
  last stage) amplifies the round-off further;
- float32 forward: max |port - ref| <= 1e-4 * max |ref| (sums of up to
  25,088 products taken in another order), ref JAX's float32 result for
  VGG16 and the float64 one for the ResNets, where the port may also be
  as far as twice JAX's own float32 distance from it;
- float32 BN state: ||port - float64|| <= 1e-4 ||float64||, or twice
  JAX's own float32 distance;
- VGG16 at 224 x 224 is held to JAX in float64 too (logits and every
  gradient leaf within 1e-10), in a test marked ``slow``: JAX's float64
  forward + backward takes ~85 s on the CPU;
- float32 gradients of VGG16: each leaf within 1e-2 by norm.  A max-pool
  or ReLU near-tie routes a gradient by its last bit, so its leaves before
  the near-tie move as a whole: on this test's inputs the port's worst
  leaf lies 4.0e-3 from JAX's (conv1_1/bias); on an H100 one leaf lay
  3.8e-3 from the host's on random images (tests/test_torch_cuda.py).
  The test prints its worst leaf.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

FWD_TOL = 1e-4
STATE_TOL = 1e-4
F64_TOL = 1e-10
VGG_GRAD_TOL = 1e-2


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


class _F64:
    """``jnp`` with ``float32`` meaning float64: the JAX CNN casts to
    float32 by name."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@contextlib.contextmanager
def jax_float64(monkeypatch):
    """Run the JAX CNN in float64 inside the block."""
    from wide_deep_tpu.models import cnn as jcnn
    from wide_deep_tpu.models.cnn import resnet as jres
    from wide_deep_tpu.models.cnn import vgg as jvgg
    with monkeypatch.context() as m:
        for mod in (jcnn, jres, jvgg):
            m.setattr(mod, "jnp", _F64())
        with jax.enable_x64(True):
            yield


def _nest(pairs):
    """{path: value} pairs -> nested dicts."""
    out = {}
    for path, v in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def jax_run(spec, params, state, images, cot, training, grads=True):
    """JAX's (logits, new BN state, gradients of sum(logits * cot) or None
    without ``grads``)."""
    from wide_deep_tpu.models.cnn import cnn_logits

    def f(p):
        logits, new_state = cnn_logits(p, spec, jnp.asarray(images), 1,
                                       training, state)
        return jnp.sum(logits * cot), (logits, new_state)
    if not grads:
        return jax.device_get(jax.jit(f)(params)[1]) + (None,)
    (_, (logits, new_state)), g = jax.jit(
        jax.value_and_grad(f, has_aux=True))(params)
    return jax.device_get((logits, new_state, g))


def port_run(spec, params_np, state_np, images, cot, training,
             dtype=torch.float32):
    """The port's (logits, new BN state, gradients) from the JAX weights,
    computed in ``dtype``; numpy out."""
    from wide_deep_tpu_torch.interop import from_jax, to_numpy
    from wide_deep_tpu_torch.models.cnn import cnn_logits
    from wide_deep_tpu_torch.optim import tree_items
    params, state = from_jax(params_np, state_np, device="cpu")
    params = _nest((p, t.to(dtype).requires_grad_(True))
                   for p, t in tree_items(params))
    state = {k: {s: v.to(dtype) for s, v in st.items()}
             for k, st in state.items()}
    leaves = list(tree_items(params))
    logits, new_state = cnn_logits(params, spec,
                                   torch.from_numpy(images).to(dtype), 1,
                                   training, state or None)
    grads = torch.autograd.grad(
        (logits * torch.from_numpy(cot).to(dtype)).sum(),
        [t for _, t in leaves])
    return (to_numpy(logits), to_numpy(new_state),
            to_numpy(_nest((p, g) for (p, _), g in zip(leaves, grads))))


def _specs(model, size, hw):
    from wide_deep_tpu.models.cnn import CnnSpec as JSpec
    from wide_deep_tpu_torch.models.cnn import CnnSpec as TSpec
    return (JSpec(model=model, resnet_size=size, height=hw, width=hw),
            TSpec(model=model, resnet_size=size, height=hw, width=hw))


def _inputs(B, hw, seed=0):
    rng = np.random.default_rng(seed)
    images = (rng.random((B, hw, hw, 3)) * 2 - 1).astype(np.float32)
    cot = rng.standard_normal((B, 1)).astype(np.float32)
    return images, cot


def _jax_init(spec, images):
    """The JAX package's (params, BN state) tree for ``spec``: its names and
    shapes from its init (traced, not run), the values from a seeded numpy
    generator (He-normal kernels, unit BN scales, zero biases, BN state
    mean 0 and var 1, as its init makes them)."""
    from wide_deep_tpu.models.cnn import init_cnn_params
    shapes = jax.eval_shape(
        lambda r: init_cnn_params(r, spec, 1, jnp.asarray(images)),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape)
                    * np.sqrt(2.0 / fan_in)).astype(np.float32)
        if name in ("scale", "var"):
            return np.ones(leaf.shape, np.float32)
        return np.zeros(leaf.shape, np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _vgg16_against_jax(dtype, tol, monkeypatch):
    """VGG16 at 224 x 224, batch 1, JAX and the port both in ``dtype``:
    logits within ``tol`` (float64: by norm; float32: FWD_TOL of JAX's
    largest) and every gradient leaf within ``tol`` by norm; prints the
    readings."""
    from wide_deep_tpu.models.cnn import CnnSpec as JSpec
    jspec, tspec = _specs("vgg16", 50, 224)
    images, cot = _inputs(1, 224)
    params, state = _jax_init(jspec, images)
    assert state == {}
    if dtype == torch.float64:
        as64 = lambda tree: jax.tree.map(  # noqa: E731
            lambda a: np.asarray(a, np.float64), tree)
        with jax_float64(monkeypatch):
            jl, _, jg = jax_run(
                JSpec(model="vgg16", dtype=jnp.float64), as64(params), None,
                images.astype(np.float64), cot.astype(np.float64), True)
        logits_err = _rel
    else:
        jl, _, jg = jax_run(jspec, params, None, images, cot, True)
        logits_err = lambda a, b: np.abs(a - b).max() / np.abs(b).max()  # noqa
    tl, tstate, tg = port_run(tspec, params, {}, images, cot, True,
                              dtype=dtype)
    assert tstate == {} and jl.dtype == tl.dtype
    names = [p for p, _ in _leaves(jg)]
    assert names == [p for p, _ in _leaves(tg)]
    assert len(names) == 2 * (13 + 3) + 2
    errs = {"/".join(p): _rel(_leaf(tg, p), _leaf(jg, p)) for p in names}
    worst = max(errs, key=errs.get)
    fwd = logits_err(tl, jl)
    print(f"VGG16 224x224 {tl.dtype}: logits {fwd:.3g}, worst gradient leaf "
          f"{worst} {errs[worst]:.3g}")
    assert fwd <= (tol if dtype == torch.float64 else FWD_TOL)
    for name, err in errs.items():
        assert err <= tol, name


def test_vgg16_full_width_matches_jax(monkeypatch):
    """VGG16 at 224 x 224, batch 1, float32: logits and every gradient
    leaf."""
    _vgg16_against_jax(torch.float32, VGG_GRAD_TOL, monkeypatch)


@pytest.mark.slow
def test_vgg16_full_width_matches_jax_float64(monkeypatch):
    """VGG16 at 224 x 224, batch 1, float64: logits and every gradient
    leaf within 1e-10 of JAX's (slow: JAX's float64 convolutions)."""
    _vgg16_against_jax(torch.float64, F64_TOL, monkeypatch)


def test_vgg19_shapes_on_meta():
    """VGG19's param tree on the ``meta`` device (nothing allocated) has
    the JAX tree's names and shapes: 16 convs and 3 dense layers, fc6
    [25088, 4096]."""
    from wide_deep_tpu.models.cnn import init_cnn_params as jinit
    from wide_deep_tpu_torch.models.cnn import init_cnn_params
    jspec, tspec = _specs("vgg19", 50, 224)
    meta = torch.device("meta")
    params, state = init_cnn_params(
        torch.Generator().manual_seed(0), tspec, 1,
        torch.zeros((1, 224, 224, 3), device=meta), meta)
    jparams, _ = jax.eval_shape(
        lambda r: jinit(r, jspec, 1, jnp.zeros((1, 224, 224, 3))),
        jax.random.PRNGKey(0))
    assert state == {}
    assert len(params["vgg"]) == 19
    assert tuple(params["vgg"]["fc6"]["kernel"].shape) == (25088, 4096)
    got = {p: tuple(t.shape) for p, t in _leaves(params)}
    want = {p: tuple(t.shape) for p, t in _leaves(jparams)}
    assert got == want
    assert all(t.device.type == "meta" for _, t in _leaves(params))
    with pytest.raises(ValueError, match="224x224"):
        init_cnn_params(torch.Generator().manual_seed(0), tspec, 1,
                        torch.zeros((1, 32, 32, 3), device=meta), meta)


def test_imagenet_sizes_and_bad_sizes():
    from wide_deep_tpu.models.cnn import resnet as jres
    from wide_deep_tpu_torch.models.cnn import init_cnn_params
    from wide_deep_tpu_torch.models.cnn import resnet as tres
    assert tres.IMAGENET_SIZES == jres.IMAGENET_SIZES
    assert set(tres.IMAGENET_SIZES) == {18, 34, 50, 101, 152, 200}
    for model, size, msg in (("resnet", 17, "resnet_size"),
                             ("resnet_cifar", 9, "6n\\+2"),
                             ("resnet_cifar_v1", 10, "6n\\+2")):
        jspec, tspec = _specs(model, size, 32)
        with pytest.raises(ValueError, match=msg):
            _jax_init(jspec, np.zeros((1, 32, 32, 3), np.float32))
        with pytest.raises(ValueError, match=msg):
            init_cnn_params(torch.Generator().manual_seed(0), tspec, 1,
                            torch.zeros((1, 32, 32, 3)), torch.device("cpu"))


RESNETS = [("resnet", 18, 64), ("resnet", 50, 64),
           ("resnet_cifar", 8, 32), ("resnet_cifar", 20, 32),
           ("resnet_cifar_v1", 8, 32), ("resnet_cifar_v1", 20, 32)]


def _f32_close(port, jax32, jax64, tol):
    """The port's float32 result within ``tol`` of the float64 one (max
    abs error over its largest for logits, by norm for state), or at
    least half as close as the JAX package's own float32 result."""
    port, jax32, jax64 = (np.asarray(a, np.float64)
                          for a in (port, jax32, jax64))
    if port.ndim == 2:
        err = lambda a: np.abs(a - jax64).max() / np.abs(jax64).max()  # noqa
    else:
        err = lambda a: _rel(a, jax64)  # noqa: E731
    return err(port) <= max(tol, 2 * err(jax32))


@pytest.mark.parametrize("model,size,hw", RESNETS)
def test_resnet_matches_jax(model, size, hw, monkeypatch):
    """Batch 2 from JAX-shaped weights.  float64: the training forward,
    its new BN state (the JAX running-stat update, population variance),
    every gradient leaf, and an eval forward from those running stats.
    float32: the training forward, its BN state and the eval forward, each
    within 1e-4 of the float64 result or at least half as close as JAX's
    own float32 result (a ResNet-50's batch-2 BN over 8 values a channel
    can leave JAX's own float32 logits farther than 1e-4 from exact)."""
    from wide_deep_tpu.models.cnn import CnnSpec as JSpec
    jspec, tspec = _specs(model, size, hw)
    jspec64 = JSpec(model=model, resnet_size=size, height=hw, width=hw,
                    dtype=jnp.float64)
    images, cot = _inputs(2, hw)
    params, state = _jax_init(jspec, images)
    as64 = lambda tree: jax.tree.map(  # noqa: E731
        lambda a: np.asarray(a, np.float64), tree)
    with jax_float64(monkeypatch):
        jl64, js64, jg = jax_run(jspec64, as64(params), as64(state),
                                 images.astype(np.float64),
                                 cot.astype(np.float64), True)
    tl, ts, tg = port_run(tspec, params, state, images, cot, True,
                          dtype=torch.float64)
    assert jl64.dtype == tl.dtype == np.float64
    assert _rel(tl, jl64) <= F64_TOL
    grads = list(_leaves(jg))
    assert [p for p, _ in grads] == [p for p, _ in _leaves(tg)]
    for path, g in grads:
        assert _rel(_leaf(tg, path), g) <= F64_TOL, path
    names = [p for p, _ in _leaves(js64)]
    assert names == [p for p, _ in _leaves(ts)] and len(names) > 0
    for path in names:
        assert _rel(_leaf(ts, path), _leaf(js64, path)) <= F64_TOL, path

    jl, js, _ = jax_run(jspec, params, state, images, cot, True, grads=False)
    tl, ts, _ = port_run(tspec, params, state, images, cot, True)
    assert _f32_close(tl, jl, jl64, FWD_TOL)
    for path in names:
        assert _f32_close(_leaf(ts, path), _leaf(js, path),
                          _leaf(js64, path), STATE_TOL), path

    # eval reads the running stats the training forward left
    with jax_float64(monkeypatch):
        jle64, _, _ = jax_run(jspec64, as64(params), as64(js64),
                              images.astype(np.float64),
                              cot.astype(np.float64), False, grads=False)
    tle64, _, _ = port_run(tspec, params, js64, images, cot, False,
                           dtype=torch.float64)
    assert _rel(tle64, jle64) <= F64_TOL
    assert np.abs(jle64 - jl64).max() > 10 * FWD_TOL * np.abs(jl64).max()
    jle, _, _ = jax_run(jspec, params, js, images, cot, False, grads=False)
    tle, _, _ = port_run(tspec, params, js, images, cot, False)
    assert _f32_close(tle, jle, jle64, FWD_TOL)


def test_npy_bridge_round_trip(tmp_path):
    """The reference's {name: [kernel, bias]} npy format both ways between
    the packages, and var_count."""
    from wide_deep_tpu.models.cnn import vgg as jvgg
    from wide_deep_tpu_torch.models.cnn import vgg as tvgg
    rng = np.random.default_rng(0)
    jparams = {"vgg": {
        "conv1_1": {"kernel": jnp.asarray(rng.random((3, 3, 3, 4)),
                                          jnp.float32),
                    "bias": jnp.asarray(rng.random(4), jnp.float32)},
        "fc8": {"kernel": jnp.asarray(rng.random((6, 5)), jnp.float32),
                "bias": jnp.asarray(rng.random(5), jnp.float32)}}}
    tparams = {"vgg": {n: {k: torch.zeros(tuple(v.shape))
                           for k, v in layer.items()}
                       for n, layer in jparams["vgg"].items()}}
    jvgg.save_npy_weights(jparams, str(tmp_path / "j.npy"))
    tvgg.load_npy_weights(tparams, str(tmp_path / "j.npy"))
    for path, v in _leaves(jparams):
        got = _leaf(tparams, path)
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(v))
    tvgg.save_npy_weights(tparams, str(tmp_path / "t.npy"))
    back = {"vgg": {n: {k: jnp.zeros(v.shape) for k, v in layer.items()}
                    for n, layer in jparams["vgg"].items()}}
    jvgg.load_npy_weights(back, str(tmp_path / "t.npy"))
    for path, v in _leaves(jparams):
        np.testing.assert_array_equal(np.asarray(_leaf(back, path)),
                                      np.asarray(v))
    assert tvgg.var_count(tparams) == jvgg.var_count(jparams) == (
        3 * 3 * 3 * 4 + 4 + 6 * 5 + 5)
