"""The rounding helpers the port's optimizers share between the card and
the host (``wide_deep_tpu_torch/optim/__init__.py``): ``_sqrt`` is the
correctly rounded root (numpy's, bit for bit), ``_rsqrt`` keeps the host's
float32 ``torch.rsqrt`` bits, and a division by ``_on``'s device-held
scalar is the host's division.  The card's side of each is held in
tests/test_torch_cuda.py (``-k host_bits``) and chip_smoke.py phase 8b.

The sweep kernel (csrc/optim_sweep.cu), which runs FTRL and Adagrad on CUDA
leaves, runs only on the card, where tests/test_torch_cuda.py holds it to
the host's bits; here CPU leaves are shown to take the eager versions, and
the wrapper's refusals that need no card are checked."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")


def _values(n=1 << 20, seed=3):
    rng = np.random.default_rng(seed)
    x = np.exp(rng.uniform(-40, 40, n)).astype(np.float32)
    return np.concatenate([x, rng.random(n).astype(np.float32),
                           np.float32([0.0, 1e-38, 1.0, 4.0, 2.0 ** 126])])


def test_sqrt_is_correctly_rounded():
    from wide_deep_tpu_torch.optim import _sqrt
    x = _values()
    got = _sqrt(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  np.sqrt(x).view(np.int32))
    xb = torch.from_numpy(x).bfloat16()
    want = torch.from_numpy(np.sqrt(xb.double().numpy())).bfloat16()
    assert torch.equal(_sqrt(xb).view(torch.int16), want.view(torch.int16))


def test_rsqrt_keeps_the_hosts_float32_bits():
    from wide_deep_tpu_torch.optim import _rsqrt
    x = torch.from_numpy(_values()[:-5])       # positive, as accumulators
    assert torch.equal(_rsqrt(x).view(torch.int32),
                       torch.rsqrt(x).view(torch.int32))
    # the root correctly rounded, then its reciprocal
    want = 1.0 / np.sqrt(x.numpy())
    np.testing.assert_array_equal(_rsqrt(x).numpy().view(np.int32),
                                  want.view(np.int32))


def test_division_by_a_device_held_scalar_is_the_hosts():
    from wide_deep_tpu_torch.optim import _on, exponential_decay
    x = torch.from_numpy(_values())
    lr = exponential_decay(0.05, 0.8, 7.0)(3)
    held = _on(lr, x)
    assert held.device == x.device and held.dtype == lr.dtype
    assert held.dim() == 0 and float(held) == float(lr)
    assert torch.equal((x / held).view(torch.int32),
                       (x / lr).view(torch.int32))


# ------------------------------------------------------ the sweep kernel
F32 = np.float32


def _int_bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["Ftrl", "Adagrad"])
def test_cpu_leaves_take_the_eager_update(name, dtype):
    """A CPU leaf under Ftrl or Adagrad takes ``_ftrl_`` / ``_adagrad_``
    (their bits) and launches no sweep."""
    from wide_deep_tpu_torch.ops import optim_sweep
    from wide_deep_tpu_torch.optim import (_adagrad_, _ftrl_, leaf_update_,
                                           slot_inits)
    spec = {"name": name, "l1_regularization_strength": 0.5,
            "l2_regularization_strength": 1.0}
    rng = np.random.default_rng(9)
    w0 = torch.from_numpy(rng.normal(0, 0.05, (37, 3)).astype(F32)).to(dtype)
    slots0 = {k: torch.full_like(w0, v).to(dt or dtype)
              for k, (v, dt) in slot_inits(spec).items()}
    before = (optim_sweep.ftrl_launches, optim_sweep.adagrad_launches)
    for count in range(2):
        lr = torch.tensor(0.05 - 0.01 * count)
        g = torch.from_numpy(rng.normal(0, 0.01, (37, 3)).astype(F32)).to(
            dtype)
        w, slots = w0.clone(), {k: v.clone() for k, v in slots0.items()}
        leaf_update_(spec, lr, count, w, g, slots)
        if name == "Ftrl":
            _ftrl_(spec, lr, w0, g, slots0["accum"], slots0["linear"],
                   first=count == 0)
        else:
            _adagrad_(lr, w0, g, slots0["accum"])
        for got, want in zip([w, *slots.values()], [w0, *slots0.values()]):
            assert torch.equal(_int_bits(got), _int_bits(want))
    assert (optim_sweep.ftrl_launches, optim_sweep.adagrad_launches) == before


def _sweep_leaf(dtype=torch.float32, slot_dtype=torch.float32, **change):
    t = {"w": torch.zeros(8, 4, dtype=dtype),
         "g": torch.zeros(8, 4, dtype=dtype),
         "s": torch.zeros(8, 4, dtype=slot_dtype),
         "z": torch.zeros(8, 4, dtype=torch.float32)}
    t.update(change)
    return t


@pytest.mark.parametrize("case", ["cpu", "g_dtype", "slot_dtype", "shape"])
@pytest.mark.parametrize("rule", ["ftrl_", "adagrad_"])
def test_sweep_refuses_what_it_cannot_take(rule, case):
    """The sweep's wrapper takes contiguous CUDA leaves of float32 or
    bfloat16 alone, every slot of the dtype its rule keeps and of the
    param's shape; anything else raises before a launch, here before
    the kernel is built."""
    from wide_deep_tpu_torch.ops import optim_sweep
    t = {"cpu": _sweep_leaf(),
         "g_dtype": _sweep_leaf(g=torch.zeros(8, 4, dtype=torch.bfloat16)),
         "slot_dtype": _sweep_leaf(s=torch.zeros(8, 4, dtype=torch.float64)),
         "shape": _sweep_leaf(s=torch.zeros(32))}[case]
    lr = torch.tensor(0.05)
    before = (optim_sweep.ftrl_launches, optim_sweep.adagrad_launches)
    with pytest.raises(ValueError, match="CUDA" if case == "cpu" else
                       "must be|float32 or bfloat16"):
        if rule == "ftrl_":
            optim_sweep.ftrl_(lr, t["w"], t["g"], t["s"], t["z"], 0.5, 1.0)
        else:
            optim_sweep.adagrad_(lr, t["w"], t["g"], t["s"])
    assert (optim_sweep.ftrl_launches, optim_sweep.adagrad_launches) == before
