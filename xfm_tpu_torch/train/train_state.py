"""Train state and train step (`xfm_tpu/train/train_state.py`)."""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .optim import HFAdamW


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: HFAdamW
    step: int = 0

    def apply_gradients(self) -> torch.Tensor:
        g_norm = self.optimizer.step()
        self.step += 1
        return g_norm

    @classmethod
    def create(cls, model: torch.nn.Module, optimizer: HFAdamW):
        return cls(model=model, optimizer=optimizer)


def make_train_step(loss_fn: Callable):
    """loss_fn(model, batch, generator) -> (scalar loss, aux dict).

    Returns step(state, batch, generator=None) -> (state, loss): forward,
    backward and one optimizer update, in place. Nothing waits for the
    device; the loss is a device tensor."""

    def step(state: TrainState, batch, generator=None):
        for p in state.model.parameters():
            p.grad = None
        loss, _ = loss_fn(state.model, batch, generator)
        loss.backward()
        state.apply_gradients()
        return state, loss.detach()

    return step


def pretrain_loss_fn(model, batch, generator=None):
    """Sum of the four pretrain losses of `XFMForPretrain.loss` (the JAX
    package's `__graft_entry__._loss_fn`), deterministic."""
    out = model.loss(**batch, generator=generator, deterministic=True)
    total = (out["loss_itc"] + out["loss_itm"] + out["loss_mlm"]
             + out["loss_mim"])
    return total, out


def retrieval_loss_fn(model, batch, generator=None):
    """ITC + ITM of `XFMForRetrieval.loss` (the JAX package's
    `scripts/bench_finetune.py` retrieval loss), deterministic."""
    loss_itc, loss_itm = model.loss(**batch, generator=generator,
                                    deterministic=True)
    return loss_itc + loss_itm, {"loss_itc": loss_itc, "loss_itm": loss_itm}
