"""Functional VGG16/VGG19 for the image arm (the port of the JAX package's
``models/cnn/vgg.py``).

Params keep the JAX tree's layout: HWIO conv kernels and [in, out] dense
kernels (fc6 is [25088, 4096]), so ``interop.from_jax`` and the checkpoint's
leaf list are plain maps.  Activations are NHWC tensors; each convolution
and pool permutes its input to an NCHW view, which is stored channels-last,
so the permutes move no bytes.  The flatten before fc6 is in H, W, C order,
as the JAX package's NHWC reshape is.  Also the npy bridge to the
reference's weight-dict format ({layer_name: [kernel, bias]}).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from wide_deep_tpu_torch.models.deep import (ParamStore, glorot_uniform,
                                             zeros_init)

VGG16_LAYERS = {
    "conv": [("conv1_1", 64), ("conv1_2", 64), ("pool",),
             ("conv2_1", 128), ("conv2_2", 128), ("pool",),
             ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), ("pool",),
             ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), ("pool",),
             ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512), ("pool",)],
}
VGG19_LAYERS = {
    "conv": [("conv1_1", 64), ("conv1_2", 64), ("pool",),
             ("conv2_1", 128), ("conv2_2", 128), ("pool",),
             ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256),
             ("conv3_4", 256), ("pool",),
             ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512),
             ("conv4_4", 512), ("pool",),
             ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512),
             ("conv5_4", 512), ("pool",)],
}
FC_LAYERS = [("fc6", 4096), ("fc7", 4096), ("fc8", 1000)]


def conv_nhwc(x: torch.Tensor, kernel: torch.Tensor, stride: int,
              padding: int) -> torch.Tensor:
    """An NHWC input convolved with an HWIO kernel, ``padding`` zeros on
    every side -> NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1),
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def _conv(store: ParamStore, name: str, x: torch.Tensor,
          out_ch: int) -> torch.Tensor:
    kernel = store.get(("vgg", name, "kernel"), (3, 3, x.shape[-1], out_ch),
                       _conv_glorot)
    bias = store.get(("vgg", name, "bias"), (out_ch,), zeros_init)
    return F.relu(conv_nhwc(x, kernel, 1, 1) + bias)     # 3x3 "SAME"


def _conv_glorot(gen, shape, device):
    fan_in = shape[0] * shape[1] * shape[2]
    fan_out = shape[0] * shape[1] * shape[3]
    limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
    return torch.empty(shape, dtype=torch.float32, device=device).uniform_(
        -limit, limit, generator=gen)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 "SAME" max pool (an odd edge's window holds what is there)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2,
                        ceil_mode=True).permute(0, 2, 3, 1)


def vgg_features(store: ParamStore, images: torch.Tensor,
                 depth: int = 16) -> torch.Tensor:
    """[B, 224, 224, 3] -> fc8 [B, 1000], in the images' dtype."""
    if images.shape[1] != 224 or images.shape[2] != 224:
        raise ValueError("VGG expects 224x224 input")
    layers = VGG16_LAYERS if depth == 16 else VGG19_LAYERS
    x = images
    for layer in layers["conv"]:
        if layer[0] == "pool":
            x = _max_pool(x)
        else:
            x = _conv(store, layer[0], x, layer[1])
    x = x.reshape(x.shape[0], -1)           # H, W, C order
    for name, units in FC_LAYERS:
        kernel = store.get(("vgg", name, "kernel"), (x.shape[-1], units),
                           glorot_uniform)
        bias = store.get(("vgg", name, "bias"), (units,), zeros_init)
        x = x @ kernel + bias
        if name != "fc8":
            x = F.relu(x)
    return x


# --------------------------------------------------------- npy weight bridge
def load_npy_weights(params: Dict[str, Any], npy_path: str) -> Dict[str, Any]:
    """Merge a reference-format npy weight dict ({name: [kernel, bias]})
    into a params tree made by the VGG init; each leaf lands on the device
    of the one it replaces.  The file is a pickle: load only trusted
    files."""
    data = np.load(npy_path, encoding="latin1", allow_pickle=True).item()
    vgg = params.get("vgg", {})
    for name, (kernel, bias) in data.items():
        if name in vgg:
            dev = vgg[name]["kernel"].device
            vgg[name]["kernel"] = torch.as_tensor(np.asarray(kernel),
                                                  device=dev)
            vgg[name]["bias"] = torch.as_tensor(np.asarray(bias), device=dev)
    return params


def save_npy_weights(params: Dict[str, Any], npy_path: str) -> None:
    """Export the vgg arm to the reference npy dict format."""
    out = {name: [p["kernel"].detach().cpu().numpy(),
                  p["bias"].detach().cpu().numpy()]
           for name, p in params.get("vgg", {}).items()}
    np.save(npy_path, out)


def var_count(params: Dict[str, Any]) -> int:
    """Total parameter count of the vgg arm."""
    return sum(int(t.numel()) for layer in params.get("vgg", {}).values()
               for t in layer.values())
