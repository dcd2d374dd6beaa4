"""4-group HF-AdamW (`xfm_tpu/train/optim.py` `create_optimizer`) and
LARS (`lars`, the linear probe's).

Its own step, not `torch.optim.AdamW`, whose eps placement and decay differ.
Per step, in this order, as the JAX package's optax chain does:
  1. clip the gradients to global norm `clip_grad_norm`;
  2. HF-Adam: m, v moments; update = m·√(1−b2ᵗ)/(1−b1ᵗ) / (√v + eps);
  3. decoupled decay on the PRE-update parameter (optax
     `add_decayed_weights`), on the decay set only;
  4. ×lr_mult on the boosted heads;
  5. ×lr(count), with count read before it is incremented.
Parameters without a gradient are stepped with a zero gradient, as JAX does
(so they still decay). Updates are in place, with `torch._foreach_*` ops.
Both optimizers take the parameters that require a gradient: a frozen
tower (a linear probe's) holds no optimizer state and never moves, where
the JAX package's optimizers step it with a zero gradient, so that a
weight decay above 0 moves it.
"""
from __future__ import annotations

import re
from typing import Callable, Sequence

import torch

# fresh heads boosted by lr_mult, on torch parameter names
DEFAULT_BOOST_PATTERNS = (
    r".*vision_proj.*", r".*text_proj.*", r"(^|.*\.)temp$",
    r".*itm_head.*", r".*bbox_head.*", r".*cls_head.*", r".*mim_lm_head.*",
)


def decays(name: str) -> bool:
    """The reference's name-list rule: no decay for any name whose last part
    contains 'bias' (biases, q/v biases, rel-pos tables) or for a weight
    under a module whose name contains 'norm' (every LayerNorm except the
    numbered MLP-head ones, which the reference decays)."""
    parts = [s.lower() for s in name.split(".")]
    if "bias" in parts[-1]:
        return False
    if parts[-1] == "weight" and any("norm" in s for s in parts[:-1]):
        return False
    return True


def boosted(name: str,
            patterns: Sequence[str] = DEFAULT_BOOST_PATTERNS) -> bool:
    return any(re.match(p, name) for p in patterns)


class HFAdamW:
    def __init__(self, named_params, learning_rate: Callable[[int], float]
                 | float, weight_decay: float = 0.01, lr_mult: float = 1.0,
                 b1: float = 0.9, b2: float = 0.98, eps: float = 1e-8,
                 clip_grad_norm: float | None = 1.0,
                 boost_patterns: Sequence[str] = DEFAULT_BOOST_PATTERNS):
        self.names, self.params = zip(*named_params)
        self.lr = (learning_rate if callable(learning_rate)
                   else (lambda _step, v=learning_rate: v))
        self.weight_decay = weight_decay
        self.lr_mult = lr_mult
        self.b1, self.b2, self.eps = b1, b2, eps
        self.clip_grad_norm = clip_grad_norm
        self.decay_idx = [i for i, n in enumerate(self.names) if decays(n)]
        self.boost_idx = [i for i, n in enumerate(self.names)
                          if boosted(n, boost_patterns)]
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update from the parameters' `.grad`; returns the global norm
        of the gradients before clipping (a device tensor)."""
        grads = [p.grad.float() if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        g_norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        if self.clip_grad_norm:
            m = self.clip_grad_norm
            scale = torch.where(g_norm < m, torch.ones_like(g_norm),
                                m / g_norm)
            grads = torch._foreach_mul(grads, scale)
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - b2)
        lr = self.lr(self.count)
        self.count += 1
        c = self.count
        step_size = (1.0 - b2 ** c) ** 0.5 / (1.0 - b1 ** c)
        denom = torch._foreach_sqrt(self.nu)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(self.mu, denom)
        torch._foreach_mul_(upd, step_size)
        if self.weight_decay and self.decay_idx:
            torch._foreach_add_([upd[i] for i in self.decay_idx],
                                [self.params[i] for i in self.decay_idx],
                                alpha=self.weight_decay)
        if self.lr_mult != 1.0 and self.boost_idx:
            torch._foreach_mul_([upd[i] for i in self.boost_idx],
                                self.lr_mult)
        torch._foreach_add_(list(self.params), upd, alpha=-lr)
        return g_norm

    def state_dict(self) -> dict:
        """The moments by parameter name and the count (the tensors are the
        live ones, not copies)."""
        return {"mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu)), "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy `state_dict()`'s moments in place, bit for bit, and its
        count."""
        for key in ("mu", "nu"):
            saved = state[key]
            if set(saved) != set(self.names):
                raise KeyError(f"optimizer {key}: names differ from the "
                               "model's")
            for name, t in zip(self.names, getattr(self, key)):
                t.copy_(saved[name])
        self.count = int(state["count"])


class LARS:
    """LARS (`xfm_tpu/train/optim.py` `lars`, reference optim.py:53-87):
    for a parameter of rank > 1, g + wd·p scaled by the trust ratio
    `trust_coefficient`·‖p‖/‖g‖ (1 where either norm is 0); rank ≤ 1 takes
    its gradient as it is, with no decay; then heavy-ball momentum
    mu = momentum·mu + g and p -= lr(count + 1)·mu, the count incremented
    first, as optax's `lars` reads the schedule."""

    def __init__(self, named_params, learning_rate: Callable[[int], float]
                 | float, weight_decay: float = 0.0, momentum: float = 0.9,
                 trust_coefficient: float = 0.001):
        self.names, self.params = zip(*named_params)
        self.lr = (learning_rate if callable(learning_rate)
                   else (lambda _step, v=learning_rate: v))
        self.weight_decay = weight_decay
        self.momentum = momentum
        self.trust_coefficient = trust_coefficient
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update from the parameters' `.grad`; returns the global norm
        of the gradients (a device tensor)."""
        grads = [p.grad.float() if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        g_norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        for i, (p, g) in enumerate(zip(self.params, grads)):
            if p.dim() > 1:
                if self.weight_decay:
                    g = g + self.weight_decay * p
                pn = torch.linalg.vector_norm(p)
                gn = torch.linalg.vector_norm(g)
                one = torch.ones_like(pn)
                q = torch.where(pn > 0, torch.where(
                    gn > 0, self.trust_coefficient * pn / gn, one), one)
                grads[i] = g * q
        torch._foreach_mul_(self.mu, self.momentum)
        torch._foreach_add_(self.mu, grads)
        self.count += 1
        torch._foreach_add_(list(self.params), self.mu,
                            alpha=-self.lr(self.count))
        return g_norm

    def state_dict(self) -> dict:
        """The momenta by parameter name and the count (the tensors are the
        live ones, not copies)."""
        return {"mu": dict(zip(self.names, self.mu)), "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy `state_dict()`'s momenta in place, bit for bit, and its
        count."""
        if set(state["mu"]) != set(self.names):
            raise KeyError("optimizer mu: names differ from the model's")
        for name, t in zip(self.names, self.mu):
            t.copy_(state["mu"][name])
        self.count = int(state["count"])


def trained_parameters(model: torch.nn.Module) -> list:
    """(name, parameter) of the model's (deduplicated, tied-once)
    parameters that require a gradient."""
    return [(n, p) for n, p in model.named_parameters() if p.requires_grad]


def create_optimizer(model: torch.nn.Module, learning_rate,
                     weight_decay: float = 0.01, lr_mult: float = 1.0,
                     **kw) -> HFAdamW:
    """HF-AdamW over the model's `trained_parameters`."""
    return HFAdamW(trained_parameters(model), learning_rate,
                   weight_decay=weight_decay, lr_mult=lr_mult, **kw)


def create_optimizer_from_config(model: torch.nn.Module, config: dict,
                                 learning_rate) -> HFAdamW:
    """HF-AdamW from the YAML: `optimizer.weight_decay` (0.01) and
    `optimizer.lr_mult` (1), and a clip to global norm only where
    `accelerator.CLIP_GRAD_NORM` is set (the fine-tune recipes set none)."""
    opt = config.get("optimizer", {}) or {}
    acc = config.get("accelerator", {}) or {}
    return create_optimizer(model, learning_rate,
                            weight_decay=opt.get("weight_decay", 0.01),
                            lr_mult=opt.get("lr_mult", 1.0),
                            clip_grad_norm=acc.get("CLIP_GRAD_NORM"))
