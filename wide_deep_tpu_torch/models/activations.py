"""Activation registry — the reference's 10-name table (model_util.py:28-59),
the port of wide_deep_tpu/models/activations.py."""

import torch
import torch.nn.functional as F


def _crelu(x):
    """Concatenated ReLU — doubles the feature dimension."""
    return torch.cat([F.relu(x), F.relu(-x)], dim=-1)


ACTIVATIONS = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": F.relu,
    "relu6": F.relu6,
    "leaky_relu": F.leaky_relu,   # slope 0.01, as jax.nn.leaky_relu
    "crelu": _crelu,
    "elu": F.elu,
    "selu": F.selu,
    "softplus": F.softplus,
    "softsign": F.softsign,
}


def activation_fn(name: str):
    try:
        return ACTIVATIONS[name.lower()]
    except KeyError:
        raise ValueError(
            f"unsupported activation `{name}`; expected one of "
            f"{sorted(ACTIVATIONS)}") from None
