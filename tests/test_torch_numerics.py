"""The rounding helpers the port's optimizers share between the card and
the host (``wide_deep_tpu_torch/optim/__init__.py``): ``_sqrt`` is the
correctly rounded root (numpy's, bit for bit), ``_rsqrt`` keeps the host's
float32 ``torch.rsqrt`` bits, and a division by ``_on``'s device-held
scalar is the host's division.  The card's side of each is held in
tests/test_torch_cuda.py (``-k host_bits``) and chip_smoke.py phase 8b."""

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
