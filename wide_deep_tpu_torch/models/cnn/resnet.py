"""Functional pre-activation ResNet v2 (+ the CIFAR v1 variant) for the image
arm (the port of the JAX package's ``models/cnn/resnet.py``).

NHWC activations, HWIO kernels (the JAX tree's shapes), explicit BN state as
the deep arm keeps it; computed in the dtype of the images and params
(float32 as the model builds them; float64 where a test asks).  BatchNorm
is the JAX package's own formula, not ``F.batch_norm``'s: population
variance (ddof 0) both to normalise and in the running update
``0.99 * old + 0.01 * batch``, eps 1e-3, no padding-row mask; evaluation
reads the running statistics where the state holds them.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from wide_deep_tpu_torch.models.cnn.vgg import conv_nhwc
from wide_deep_tpu_torch.models.deep import (BN_EPS, BN_MOMENTUM, ParamStore,
                                             ones_init, zeros_init)

# imagenet size table: block kind and blocks per stage
IMAGENET_SIZES = {
    18: ("building", [2, 2, 2, 2]),
    34: ("building", [3, 4, 6, 3]),
    50: ("bottleneck", [3, 4, 6, 3]),
    101: ("bottleneck", [3, 4, 23, 3]),
    152: ("bottleneck", [3, 8, 36, 3]),
    200: ("bottleneck", [3, 24, 36, 3]),
}


def _he_normal(gen, shape, device):
    fan_in = shape[0] * shape[1] * shape[2]
    return torch.empty(shape, dtype=torch.float32, device=device).normal_(
        generator=gen) * float(np.sqrt(2.0 / fan_in))


def _conv(store: ParamStore, name: str, x, out_ch: int, ksize: int,
          strides: int) -> torch.Tensor:
    """conv2d with the JAX package's fixed padding: (k-1)//2 before and the
    rest after, then a VALID conv for strides > 1 and "SAME" for 1.  Both
    are symmetric (k-1)//2 padding for the odd kernels the arm uses (1, 3,
    7); unlike "SAME" at stride 2, which pads 0 before and 1 after an even
    size."""
    kernel = store.get(("resnet", name, "kernel"),
                       (ksize, ksize, x.shape[-1], out_ch), _he_normal)
    return conv_nhwc(x, kernel, strides, (ksize - 1) // 2)


def _bn_relu(store: ParamStore, state: Optional[Dict], new_state: Dict,
             name: str, x, training: bool, relu: bool = True):
    scale = store.get(("resnet", name, "scale"), (x.shape[-1],), ones_init)
    bias = store.get(("resnet", name, "bias"), (x.shape[-1],), zeros_init)
    if training or state is None or name not in state:
        mean = x.mean(dim=(0, 1, 2))
        var = x.var(dim=(0, 1, 2), unbiased=False)
    else:
        mean, var = state[name]["mean"], state[name]["var"]
    if training:
        old = state.get(name) if state else None
        om = old["mean"] if old else torch.zeros_like(mean)
        ov = old["var"] if old else torch.ones_like(var)
        new_state[name] = {
            "mean": (BN_MOMENTUM * om + (1 - BN_MOMENTUM) * mean).detach(),
            "var": (BN_MOMENTUM * ov + (1 - BN_MOMENTUM) * var).detach()}
    elif state is not None and name in state:
        new_state[name] = state[name]
    y = (x - mean) * torch.rsqrt(var + BN_EPS) * scale + bias
    return F.relu(y) if relu else y


def _building_block_v2(store, state, new_state, name, x, filters, strides,
                       training):
    """Pre-activation basic block."""
    pre = _bn_relu(store, state, new_state, f"{name}_bn1", x, training)
    if strides > 1 or x.shape[-1] != filters:
        shortcut = _conv(store, f"{name}_proj", pre, filters, 1, strides)
    else:
        shortcut = x
    y = _conv(store, f"{name}_conv1", pre, filters, 3, strides)
    y = _bn_relu(store, state, new_state, f"{name}_bn2", y, training)
    y = _conv(store, f"{name}_conv2", y, filters, 3, 1)
    return y + shortcut


def _bottleneck_block_v2(store, state, new_state, name, x, filters, strides,
                         training):
    """Pre-activation bottleneck block; output channels are 4*filters."""
    pre = _bn_relu(store, state, new_state, f"{name}_bn1", x, training)
    out_ch = 4 * filters
    if strides > 1 or x.shape[-1] != out_ch:
        shortcut = _conv(store, f"{name}_proj", pre, out_ch, 1, strides)
    else:
        shortcut = x
    y = _conv(store, f"{name}_conv1", pre, filters, 1, 1)
    y = _bn_relu(store, state, new_state, f"{name}_bn2", y, training)
    y = _conv(store, f"{name}_conv2", y, filters, 3, strides)
    y = _bn_relu(store, state, new_state, f"{name}_bn3", y, training)
    y = _conv(store, f"{name}_conv3", y, out_ch, 1, 1)
    return y + shortcut


def _block_layer(store, state, new_state, name, x, block_fn, filters, blocks,
                 strides, training):
    x = block_fn(store, state, new_state, f"{name}_0", x, filters, strides,
                 training)
    for i in range(1, blocks):
        x = block_fn(store, state, new_state, f"{name}_{i}", x, filters, 1,
                     training)
    return x


def imagenet_resnet_v2(store: ParamStore, images: torch.Tensor,
                       resnet_size: int, training: bool,
                       state: Optional[Dict], new_state: Dict) -> torch.Tensor:
    """ImageNet-style ResNet v2 feature extractor -> [B, features]."""
    if resnet_size not in IMAGENET_SIZES:
        raise ValueError(
            f"resnet_size must be one of {sorted(IMAGENET_SIZES)}")
    kind, layers = IMAGENET_SIZES[resnet_size]
    block_fn = (_building_block_v2 if kind == "building"
                else _bottleneck_block_v2)
    x = _conv(store, "init", images, 64, 7, 2)
    # 3x3/2 max pool over a -inf padding of 1 (max_pool2d's own padding)
    x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, padding=1).permute(
        0, 2, 3, 1)
    for i, (filters, blocks, strides) in enumerate(
            zip([64, 128, 256, 512], layers, [1, 2, 2, 2])):
        x = _block_layer(store, state, new_state, f"layer{i}", x, block_fn,
                         filters, blocks, strides, training)
    x = _bn_relu(store, state, new_state, "final_bn", x, training)
    return x.mean(dim=(1, 2))               # global average pool


def _residual_v1(store, state, new_state, name, x, filters, strides,
                 training):
    """Post-activation residual block: conv-bn-relu, conv-bn, add the
    shortcut, relu."""
    if strides > 1 or x.shape[-1] != filters:
        shortcut = _conv(store, f"{name}_proj", x, filters, 1, strides)
        shortcut = _bn_relu(store, state, new_state, f"{name}_proj_bn",
                            shortcut, training, relu=False)
    else:
        shortcut = x
    y = _conv(store, f"{name}_conv1", x, filters, 3, strides)
    y = _bn_relu(store, state, new_state, f"{name}_bn1", y, training)
    y = _conv(store, f"{name}_conv2", y, filters, 3, 1)
    y = _bn_relu(store, state, new_state, f"{name}_bn2", y, training,
                 relu=False)
    return F.relu(y + shortcut)


def cifar10_resnet_v1(store: ParamStore, images: torch.Tensor,
                      resnet_size: int, training: bool,
                      state: Optional[Dict], new_state: Dict) -> torch.Tensor:
    """CIFAR-style 6n+2 ResNet v1."""
    if resnet_size % 6 != 2:
        raise ValueError("cifar resnet_size must be 6n+2")
    n = (resnet_size - 2) // 6
    x = _conv(store, "init", images, 16, 3, 1)
    x = _bn_relu(store, state, new_state, "init_bn", x, training)
    for i, (filters, strides) in enumerate(zip([16, 32, 64], [1, 2, 2])):
        for b in range(n):
            x = _residual_v1(store, state, new_state, f"layer{i}_{b}", x,
                             filters, strides if b == 0 else 1, training)
    return x.mean(dim=(1, 2))


def cifar10_resnet_v2(store: ParamStore, images: torch.Tensor,
                      resnet_size: int, training: bool,
                      state: Optional[Dict], new_state: Dict) -> torch.Tensor:
    """CIFAR-style 6n+2 ResNet v2."""
    if resnet_size % 6 != 2:
        raise ValueError("cifar resnet_size must be 6n+2")
    n = (resnet_size - 2) // 6
    x = _conv(store, "init", images, 16, 3, 1)
    for i, (filters, strides) in enumerate(zip([16, 32, 64], [1, 2, 2])):
        x = _block_layer(store, state, new_state, f"layer{i}", x,
                         _building_block_v2, filters, n, strides, training)
    x = _bn_relu(store, state, new_state, "final_bn", x, training)
    return x.mean(dim=(1, 2))
