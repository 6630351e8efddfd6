"""CNN image arm: VGG16/19 and ResNet variants behind one interface (the
port of the JAX package's ``models/cnn/__init__.py``).

The joint model (models/joint.py) calls ``init_cnn_params`` /
``cnn_logits``; the logits are summed into the wide + deep total as the
reference summed its CNN logits (python/lib/joint.py:197-222 there).  The
arm computes in float32 whatever ``dense_dtype`` says, as the JAX package's
does (its ``build_model`` builds the spec without a dtype), so the spec has
no dtype: the arm computes in the dtype of its params and images, float32
as the model builds them (the tests also run it in float64).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from wide_deep_tpu_torch.models.cnn import resnet as resnet_lib
from wide_deep_tpu_torch.models.cnn import vgg as vgg_lib
from wide_deep_tpu_torch.models.deep import (ParamStore, glorot_uniform,
                                             zeros_init)

CNN_MODELS = ("vgg16", "vgg19", "resnet", "resnet_cifar",
              "resnet_cifar_v1")


@dataclasses.dataclass(frozen=True)
class CnnSpec:
    model: str = "vgg16"
    resnet_size: int = 50
    height: int = 224
    width: int = 224
    channels: int = 3

    @staticmethod
    def from_model_conf(model_conf: Dict[str, Any]) -> "CnnSpec":
        model = model_conf.get("cnn_model", "vgg16")
        if model not in CNN_MODELS:
            raise ValueError(f"cnn_model must be one of {CNN_MODELS}")
        return CnnSpec(model=model,
                       resnet_size=int(model_conf.get("cnn_resnet_size", 50)),
                       height=int(model_conf.get("cnn_height", 224)),
                       width=int(model_conf.get("cnn_width", 224)),
                       channels=int(model_conf.get("cnn_num_channels", 3)))

    @property
    def image_shape(self) -> Tuple[int, int, int]:
        return (self.height, self.width, self.channels)


def _features(store: ParamStore, spec: CnnSpec, images: torch.Tensor,
              training: bool, state: Optional[Dict],
              new_state: Dict) -> torch.Tensor:
    if spec.model == "vgg16":
        return vgg_lib.vgg_features(store, images, 16)
    if spec.model == "vgg19":
        return vgg_lib.vgg_features(store, images, 19)
    if spec.model == "resnet":
        return resnet_lib.imagenet_resnet_v2(
            store, images, spec.resnet_size, training, state, new_state)
    if spec.model == "resnet_cifar_v1":
        return resnet_lib.cifar10_resnet_v1(
            store, images, spec.resnet_size, training, state, new_state)
    return resnet_lib.cifar10_resnet_v2(
        store, images, spec.resnet_size, training, state, new_state)


def cnn_logits(params: Dict[str, Any], spec: CnnSpec, images: torch.Tensor,
               n_logits: int, training: bool,
               state: Optional[Dict]) -> Tuple[torch.Tensor, Dict]:
    """[B, H, W, C] float images -> (logits [B, n_logits], new BN state),
    in the dtype of the images and params (float32 as built)."""
    store = ParamStore(params)
    new_state: Dict = {}
    feats = _features(store, spec, images, training, state, new_state)
    kernel = store.get(("head", "kernel"), (feats.shape[-1], n_logits),
                       glorot_uniform)
    bias = store.get(("head", "bias"), (n_logits,), zeros_init)
    return feats @ kernel + bias, new_state


def init_cnn_params(gen: torch.Generator, spec: CnnSpec, n_logits: int,
                    sample_images: torch.Tensor,
                    device: torch.device) -> Tuple[Dict, Dict]:
    """Create the arm's params from ``gen`` by one forward over
    ``sample_images`` in create mode, and its BN state (mean 0, var 1)."""
    params: Dict[str, Any] = {}
    store = ParamStore(params, create=True, gen=gen, device=device)
    new_state: Dict = {}
    with torch.no_grad():
        feats = _features(store, spec, sample_images, True, None, new_state)
        store.get(("head", "kernel"), (feats.shape[-1], n_logits),
                  glorot_uniform)
        store.get(("head", "bias"), (n_logits,), zeros_init)
    init_state = {k: {"mean": torch.zeros_like(v["mean"]),
                      "var": torch.ones_like(v["var"])}
                  for k, v in new_state.items()}
    return params, init_state
