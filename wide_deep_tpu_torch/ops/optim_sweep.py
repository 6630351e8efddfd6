"""The dense optimizer sweeps: one FTRL or Adagrad step over a whole leaf
in one launch of csrc/optim_sweep.cu.

Replaces no Pallas kernel: the JAX package leaves these updates to XLA,
which fuses each into one loop.  The port's eager versions
(``optim._ftrl_``, ``optim._adagrad_``) run as a chain of about 25 and 15
elementwise launches, each over whole tensors; the kernel reads the param,
the gradient and the slots once and writes the param and the slots once
(FTRL 28 bytes an element in float32; Adagrad 20 in float32, 10 in
bfloat16), with the eager versions' bits on the host: every rounding they
make, in the same order (the kernel's header says how).

``optim.leaf_update_`` sends a CUDA leaf under Ftrl or Adagrad here and a
CPU leaf to the eager version, which stays the plain one.  These wrappers
take CUDA tensors only: a leaf the kernel cannot take (another dtype, a
param or slot that is not contiguous, on another device) raises; a
strided gradient (autograd's layout, as a permuted weight's) is made
contiguous first.  ``ftrl_launches`` and ``adagrad_launches`` count the
launches.
"""

from __future__ import annotations

import ctypes

import torch

from wide_deep_tpu_torch.ops import cuda_build

DTYPES = (torch.float32, torch.bfloat16)

ftrl_launches = 0
adagrad_launches = 0


_p, _i, _f, _n = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_longlong)
# each C entry's arguments (csrc/optim_sweep.cu)
ARGTYPES = {"wdt_ftrl_sweep": [_p, _p, _p, _p, _n, _i, _i, _f, _f, _f, _i, _p],
            "wdt_adagrad_sweep": [_p, _p, _p, _n, _i, _i, _f, _f, _p]}


def _fn(name):
    fn = getattr(cuda_build.library("optim_sweep"), name)
    if fn.argtypes is None:
        fn.argtypes = ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _checked(w: torch.Tensor, others) -> bool:
    """Refuse what the kernel cannot take -> whether every pointer is
    16-byte aligned (the kernel's vector loop)."""
    if w.dtype not in DTYPES:
        raise ValueError(f"the sweep takes float32 or bfloat16 params, got "
                         f"{w.dtype}")
    for name, t, dtype in ((("w", w, w.dtype),) + tuple(others)):
        if (t.dtype != dtype or t.shape != w.shape
                or not t.is_contiguous() or t.device != w.device):
            raise ValueError(f"{name} must be a contiguous {dtype} tensor "
                             f"of shape {tuple(w.shape)} on {w.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}"
                             f"{'' if t.is_contiguous() else ', strided'}")
    if w.device.type != "cuda":
        raise ValueError(f"the sweep runs on CUDA tensors, not {w.device}")
    return all(t.data_ptr() % 16 == 0
               for t in (w,) + tuple(t for _, t, _ in others))


def ftrl_(lr: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
          n: torch.Tensor, z: torch.Tensor, l1: float, l2: float,
          first: bool = False) -> None:
    """``optim._ftrl_`` in one launch, in place on (w, n, z): w and g in the
    param's dtype, n and z float32; ``lr`` a host float32 scalar tensor."""
    global ftrl_launches
    g = g.contiguous()
    aligned = _checked(w, (("g", g, w.dtype), ("n", n, torch.float32),
                           ("z", z, torch.float32)))
    if not w.numel():
        return
    err = _fn("wdt_ftrl_sweep")(
        w.data_ptr(), g.data_ptr(), n.data_ptr(), z.data_ptr(), w.numel(),
        int(w.dtype == torch.bfloat16), int(aligned), float(lr), l1, 2 * l2,
        int(first), cuda_build.stream_handle(w.device))
    cuda_build.check(err, "ftrl_")
    ftrl_launches += 1


def adagrad_(lr: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
             s: torch.Tensor, eps: float = 1e-7) -> None:
    """``optim._adagrad_`` in one launch, in place on (w, s), all three in
    the param's dtype; ``lr`` a host float32 scalar tensor."""
    global adagrad_launches
    g = g.contiguous()
    aligned = _checked(w, (("g", g, w.dtype), ("s", s, w.dtype)))
    if not w.numel():
        return
    # the scalars as the eager version meets them: -lr cast to the dtype,
    # eps (a Python float) rounded to it
    neg_lr = float((-lr).to(w.dtype))
    eps = float(torch.tensor(eps, dtype=torch.float64).to(w.dtype))
    err = _fn("wdt_adagrad_sweep")(
        w.data_ptr(), g.data_ptr(), s.data_ptr(), w.numel(),
        int(w.dtype == torch.bfloat16), int(aligned), neg_lr, eps,
        cuda_build.stream_handle(w.device))
    cuda_build.check(err, "adagrad_")
    adagrad_launches += 1
