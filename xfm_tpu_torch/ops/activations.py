"""Activations (`xfm_tpu/models/text_encoder.py` `ACT`).

`gelu` is the exact erf form; the JAX package's default fast erf
approximation (`ops/activations.py` `gelu_erf_fast`) is a TPU VPU trick and
is matched by `XFM_EXACT_ERF=1` on the JAX side.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


ACT = {
    "gelu": gelu,
    "gelu_tanh": gelu_tanh,
    "gelu_new": gelu_tanh,
    "quick_gelu": quick_gelu,
    "relu": F.relu,
}
