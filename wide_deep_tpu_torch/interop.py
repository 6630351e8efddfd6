"""Carry weights between the JAX package and the port.

Both packages keep the same param tree: ``linear/{w,b,fold/d<dim>}``,
``dnn/embed/d<dim>`` (the fused sparse-optimizer tables as float32
[rows, 128] with their slot columns), ``dnn/towers/<i>/{hidden,bn,logits}``,
BN state ``bn/t<i>_l<j>_bn/{mean,var}``, and with the CNN arm
``cnn/{vgg,resnet}/<layer>/...`` + ``cnn/head/{kernel,bias}`` (HWIO conv
kernels) and ``cnn_bn/<layer>/{mean,var}``.  The caller hands over nested
dicts and lists of numpy arrays (``jax.device_get`` of the JAX trees); the
port never imports JAX.  bfloat16 arrays (numpy's ml_dtypes ``bfloat16``)
travel bit for bit.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from wide_deep_tpu_torch.models.joint import resolve_device


def _to_tensor(arr, device) -> torch.Tensor:
    arr = np.array(arr)                       # a writable, contiguous copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def from_jax(params_np, mstate_np, device=None) -> Tuple[Any, Any]:
    """JAX param tree and model state (numpy leaves) -> the port's (params,
    state) on ``device``, same keys and dtypes: the card unless the caller
    passes ``device="cpu"``."""
    device = resolve_device(device)
    return (_map(params_np, lambda a: _to_tensor(a, device)),
            _map(mstate_np, lambda a: _to_tensor(a, device)))


def to_numpy(tree):
    """The port's tensors -> numpy copies (bfloat16 as float32, exact)."""
    def conv(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy().copy()
    return _map(tree, conv)
