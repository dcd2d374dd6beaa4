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

`with_master_weights` (`bf16_params`): the live parameters are bf16, the
optimizer steps f32 master copies from their gradients, and each live
parameter is then set to its rounded master. The JAX package adds the bf16
difference (rounded master − live) to the live parameter instead, which
lands within 1 bf16 ulp of the rounded master.

On a model that `core/partitioning.shard_model` sharded, the parameters
are DTensors and each rank steps its local shards: the moments are shards
too, the global norm of the clip is the norm of the whole gradient (each
rank's sum of squares summed over the `fsdp` group, equal on every rank),
LARS's trust ratio takes the norms of whole parameters the same way, and
`state_dict` / `load_state_dict` carry whole tensors, as one process holds
them. Under `bf16_params` there FSDP2's f32 shards are `MasterWeights`'
masters. A weight that `core/partitioning.cut_model` cut over the tensor
group is one rank's cut too (its moments with it): its sum of squares is
summed over the tensor group as well, and a whole one counts once
(`_Cuts`).
"""
from __future__ import annotations

import re
from typing import Callable, Sequence

import torch

from ..core import partitioning

# fresh heads boosted by lr_mult, on torch parameter names
DEFAULT_BOOST_PATTERNS = (
    r".*vision_proj.*", r".*text_proj.*", r"(^|.*\.)temp$",
    r".*itm_head.*", r".*bbox_head.*", r".*cls_head.*",
    r"lm_head\.",  # the MIM code head (JAX `mim_lm_head`), top level only
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
        self.cuts = _Cuts(self.params)
        self.mu = [torch.zeros_like(partitioning.local(p))
                   for p in self.params]
        self.nu = [torch.zeros_like(partitioning.local(p))
                   for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update from the parameters' `.grad`; returns the global norm
        of the gradients before clipping (a device tensor)."""
        params, grads = _locals(self.params)
        g_norm = _global_norm(grads, self.cuts)
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
                                [params[i] for i in self.decay_idx],
                                alpha=self.weight_decay)
        if self.lr_mult != 1.0 and self.boost_idx:
            torch._foreach_mul_([upd[i] for i in self.boost_idx],
                                self.lr_mult)
        torch._foreach_add_(params, upd, alpha=-lr)
        return g_norm

    def state_dict(self) -> dict:
        """The moments by parameter name and the count (the tensors are the
        live ones, not copies; whole tensors gathered from the shards on a
        sharded model, where every rank must call it)."""
        return {"mu": _whole(self.names, self.mu, self.params),
                "nu": _whole(self.names, self.nu, self.params),
                "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy `state_dict()`'s moments in place, bit for bit (each rank
        its shard of them on a sharded model), and its count."""
        for key in ("mu", "nu"):
            _load_whole(state[key], self.names, getattr(self, key),
                        self.params, f"optimizer {key}")
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
        self.cuts = _Cuts(self.params)
        self.mu = [torch.zeros_like(partitioning.local(p))
                   for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update from the parameters' `.grad`; returns the global norm
        of the gradients (a device tensor)."""
        params, grads = _locals(self.params)
        g_norm = _global_norm(grads, self.cuts)
        big = [i for i, p in enumerate(self.params) if p.dim() > 1]
        if self.weight_decay:
            for i in big:
                grads[i] = grads[i] + self.weight_decay * params[i]
        norms = []
        if self.cuts.whole_here:
            norms = [(torch.linalg.vector_norm(params[i]),
                      torch.linalg.vector_norm(grads[i])) for i in big]
        elif big:
            # the norms of whole parameters: squares summed over the shards
            # and the tensor cuts
            sq = torch.stack([torch.stack([params[i].float().square().sum(),
                                           grads[i].square().sum()])
                              for i in big])
            norms = self.cuts.whole(sq, big).sqrt()
        for i, (pn, gn) in zip(big, norms):
            one = torch.ones_like(pn)
            q = torch.where(pn > 0, torch.where(
                gn > 0, self.trust_coefficient * pn / gn, one), one)
            grads[i] = grads[i] * q
        torch._foreach_mul_(self.mu, self.momentum)
        torch._foreach_add_(self.mu, grads)
        self.count += 1
        torch._foreach_add_(params, self.mu, alpha=-self.lr(self.count))
        return g_norm

    def state_dict(self) -> dict:
        """The momenta by parameter name and the count (the tensors are the
        live ones, not copies; whole tensors on a sharded model)."""
        return {"mu": _whole(self.names, self.mu, self.params),
                "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy `state_dict()`'s momenta in place, bit for bit, and its
        count."""
        _load_whole(state["mu"], self.names, self.mu, self.params,
                    "optimizer mu")
        self.count = int(state["count"])


def _locals(params) -> tuple:
    """(each parameter's local tensor, its gradient's in f32: zeros where
    it has none)."""
    local = [partitioning.local(p) for p in params]
    grads = [partitioning.local(p.grad).float() if p.grad is not None
             else torch.zeros_like(lp) for p, lp in zip(params, local)]
    return local, grads


class _Cuts:
    """How the parameters are laid out over the ranks: FSDP2 shards over
    `group` (`sharded` marks them) and tensor cuts over `tgroup` (`cut`
    marks them), each a bool tensor on the parameters' device, or None
    where no parameter is so."""

    def __init__(self, params):
        dev = partitioning.local(params[0]).device
        self.group = partitioning.shard_group(params)
        self.sharded = (None if self.group is None else torch.tensor(
            [partitioning.is_dtensor(p) for p in params], device=dev))
        cut = [partitioning.tensor_cut_of(p) is not None for p in params]
        tcut = partitioning.model_cut() if any(cut) else None
        self.tgroup = None if tcut is None else tcut.group
        self.cut = (None if self.tgroup is None
                    else torch.tensor(cut, device=dev))

    @property
    def whole_here(self) -> bool:
        """Every parameter whole on this rank."""
        return self.group is None and self.tgroup is None

    def whole(self, sq: torch.Tensor, idx=None) -> torch.Tensor:
        """Sums of squares over a rank's tensors ([n] or [n, k], rows the
        parameters `idx`, all by default) → over the whole tensors."""
        for group, mask in ((self.group, self.sharded),
                            (self.tgroup, self.cut)):
            if group is not None:
                m = mask if idx is None else mask[idx]
                sq = _over_shards(sq, m.reshape(m.shape + (1,) * (
                    sq.dim() - 1)), group)
        return sq


def _over_shards(sq: torch.Tensor, sharded, group) -> torch.Tensor:
    """Sums of squares over a rank's shards → over the whole tensors: the
    sharded entries summed over `group`, the replicated ones as they
    are."""
    zero = torch.zeros_like(sq)
    return (partitioning.sum_over_shards(torch.where(sharded, sq, zero),
                                         group)
            + torch.where(sharded, zero, sq))


def _global_norm(grads, cuts: _Cuts) -> torch.Tensor:
    """The norm of the whole gradient: summed over the shards and the
    tensor cuts where the parameters are so, so that every rank clips by
    the same norm."""
    norms = torch.stack(torch._foreach_norm(grads))
    if cuts.whole_here:
        return torch.linalg.vector_norm(norms)
    return cuts.whole(norms.square()).sum().sqrt()


def _whole(names, tensors, params) -> dict:
    """name → the whole tensor of each of `tensors` (shards laid out as
    the parameter of the same place where it is sharded)."""
    return {n: partitioning.full_tensor(t, like=p)
            for n, t, p in zip(names, tensors, params)}


def _load_whole(saved: dict, names, tensors, params, what: str) -> None:
    if set(saved) != set(names):
        raise KeyError(f"{what}: names differ from the model's")
    for name, t, p in zip(names, tensors, params):
        t.copy_(partitioning.shard_of(saved[name], p))


def trained_parameters(model: torch.nn.Module) -> list:
    """(name, parameter) of the model's (deduplicated, tied-once)
    parameters that require a gradient."""
    return [(n, p) for n, p in model.named_parameters() if p.requires_grad]


def create_optimizer(model: torch.nn.Module, learning_rate,
                     weight_decay: float = 0.01, lr_mult: float = 1.0,
                     named_params=None, **kw) -> HFAdamW:
    """HF-AdamW over `named_params` where given (master copies), else over
    the model's `trained_parameters`."""
    return HFAdamW(named_params or trained_parameters(model), learning_rate,
                   weight_decay=weight_decay, lr_mult=lr_mult, **kw)


def create_optimizer_from_config(model: torch.nn.Module, config: dict,
                                 learning_rate, named_params=None) -> HFAdamW:
    """HF-AdamW from the YAML: `optimizer.weight_decay` (0.01) and
    `optimizer.lr_mult` (1), and a clip to global norm only where
    `accelerator.CLIP_GRAD_NORM` is set (the fine-tune recipes set none);
    over `named_params` where given (master copies), else over the model's
    `trained_parameters`."""
    opt = config.get("optimizer", {}) or {}
    acc = config.get("accelerator", {}) or {}
    return HFAdamW(named_params or trained_parameters(model), learning_rate,
                   weight_decay=opt.get("weight_decay", 0.01),
                   lr_mult=opt.get("lr_mult", 1.0),
                   clip_grad_norm=acc.get("CLIP_GRAD_NORM"))


class MasterWeights:
    """An optimizer (`HFAdamW`, `LARS`) over f32 master copies of the live
    parameters (bf16 under `bf16_params`): `step` hands each live
    parameter's gradient to its master, steps the masters and sets each
    live parameter to its master rounded to the live dtype. `state_dict`
    holds the masters beside the inner optimizer's state, so a restore is
    bit-equal. `names`, `params` (the live ones), `count` and `lr` are the
    inner optimizer's view. On a model sharded under FSDP2's bf16 policy
    (`core/partitioning.shard_model`) an f32 shard is its own master,
    which the next gather rounds to the bf16 weight the model computes
    with; only a parameter left whole there (`temp`) is copied."""

    def __init__(self, named_params, make_inner: Callable):
        self.names, self.params = zip(*named_params)
        self.masters = [p if partitioning.is_dtensor(p)
                        else p.detach().float().clone() for p in self.params]
        for m, p in zip(self.masters, self.params):
            if partitioning.tensor_cut_of(p) is not None:
                m._xfm_tensor_cut = partitioning.tensor_cut_of(p)
        self.copied = [i for i, p in enumerate(self.params)
                       if not partitioning.is_dtensor(p)]
        self.inner = make_inner(list(zip(self.names, self.masters)))
        self.lr = self.inner.lr

    @property
    def count(self) -> int:
        return self.inner.count

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        params = [self.params[i] for i in self.copied]
        masters = [self.masters[i] for i in self.copied]
        for p, m in zip(params, masters):
            # widened here, where the inner step would widen it anyway
            m.grad = None if p.grad is None else p.grad.float()
        try:
            g_norm = self.inner.step()
        finally:
            for m in masters:
                m.grad = None
        torch._foreach_copy_(params, masters)
        return g_norm

    def state_dict(self) -> dict:
        return {"master": _whole(self.names, self.masters, self.params),
                "inner": self.inner.state_dict()}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        _load_whole(state["master"], self.names,
                    [partitioning.local(m) for m in self.masters],
                    self.params, "optimizer master")
        self.inner.load_state_dict(state["inner"])


# the JAX package's name: `make_inner(named masters)` (an HF-AdamW or LARS)
# stepping f32 copies of `named_params`, taken when it is called, so call
# it while the parameters are still f32 (`tasks/common.maybe_bf16_params`)
with_master_weights = MasterWeights
