"""Activations (`xfm_tpu/models/text_encoder.py` `ACT`) and the pairs
(act, act') that the fused MLP kernel K5 computes (`xfm_tpu/ops/
fused_mlp.py` `_act_fns`).

`ACT["gelu"]` is the exact erf form, the torch reference's. Here the port
departs from the JAX package on purpose: that package's default is the fast
approximation x·Φ̂(clip(x, −6, 6)) (`ops/activations.py` `gelu_erf_fast`, a
TPU VPU trick), and it gives exact erf only under `XFM_EXACT_ERF=1`. Φ̂ is
within 1 bf16 ulp of erf for every finite bf16 input
(`tests/test_torch_gelu_default.py` pins the port's `gelu` against the JAX
default at that bound), and in eager PyTorch it would cost some ten
elementwise launches at every GELU site. The port's parity tests set
`XFM_EXACT_ERF=1` on the JAX side. K5's `gelu` is Φ̂ whatever the flag: the
fused route takes it from `FUSED_ACT`, never from `ACT`.
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

# ---------------------------------------------------------------------------
# K5's activations, f32 in and out, each with its analytic derivative

_SQRT_2_OVER_PI = 0.7978845608028654
# The tanh-form Φ̂ of `xfm_tpu/ops/activations.py` (k = 4, minimax-fitted by
# `scripts/fit_gelu_poly.py`): Φ̂(x) = ½(1 + tanh(x·q(x²))), q(u) = Σ C[i]·uⁱ.
# A copy: the port reads nothing of the JAX package.
PHI_HAT_COEFFS = (0.7978764176368713, 0.03637675940990448,
                  -7.985177944647148e-05, -3.7987665564287454e-05,
                  1.48881406403234e-06)
_INV_SQRT_2PI = 0.3989422804014327


def phi_hat(xc: torch.Tensor) -> torch.Tensor:
    """The approximate standard-normal CDF on a clamped argument."""
    u = xc * xc
    q = torch.full_like(xc, PHI_HAT_COEFFS[-1])
    for c in PHI_HAT_COEFFS[-2::-1]:
        q = q * u + c
    return 0.5 * (1.0 + torch.tanh(xc * q))


def _gelu_tanh_f(x):
    return 0.5 * x * (1.0 + torch.tanh(
        _SQRT_2_OVER_PI * (x + 0.044715 * x * x * x)))


def _gelu_tanh_df(x):
    t = torch.tanh(_SQRT_2_OVER_PI * (x + 0.044715 * x * x * x))
    dt = (1.0 - t * t) * _SQRT_2_OVER_PI * (1.0 + 3 * 0.044715 * x * x)
    return 0.5 * (1.0 + t) + 0.5 * x * dt


def _gelu_phi_f(x):
    return x * phi_hat(x.clamp(-6.0, 6.0))


def _gelu_phi_df(x):
    xc = x.clamp(-6.0, 6.0)
    d = phi_hat(xc) + x * (torch.exp(-0.5 * xc * xc) * _INV_SQRT_2PI)
    # beyond the clamp the function is exactly x (or −0): slope 1 (or 0)
    return torch.where(x >= 6.0, torch.ones_like(d),
                       torch.where(x <= -6.0, torch.zeros_like(d), d))


def _relu_f(x):
    return torch.clamp_min(x, 0.0)


def _relu_df(x):
    return (x > 0).to(x.dtype)


# name -> (act, act'), and the integer id the kernel takes (csrc/fused_mlp.cu
# `Act`); `gelu_new` is `gelu_tanh`
FUSED_ACT = {"gelu_tanh": (_gelu_tanh_f, _gelu_tanh_df),
             "gelu_new": (_gelu_tanh_f, _gelu_tanh_df),
             "gelu": (_gelu_phi_f, _gelu_phi_df),
             "relu": (_relu_f, _relu_df)}
FUSED_ACT_ID = {"gelu_tanh": 0, "gelu_new": 0, "gelu": 1, "relu": 2}
