"""Train state and train step (`xfm_tpu/train/train_state.py`)."""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

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


def _zero_grads(model: torch.nn.Module) -> None:
    for p in model.parameters():
        p.grad = None


def make_train_step(loss_fn: Callable):
    """loss_fn(model, batch, generator) -> (scalar loss, aux dict).

    Returns step(state, batch, generator=None) -> (state, metrics): forward,
    backward and one optimizer update, in place. metrics = {loss,
    grad_norm (of the gradients before any clip), **aux}, detached device
    tensors: nothing waits for the device."""

    def step(state: TrainState, batch, generator=None):
        _zero_grads(state.model)
        loss, aux = loss_fn(state.model, batch, generator)
        loss.backward()
        g_norm = state.apply_gradients()
        return state, dict(loss=loss.detach(), grad_norm=g_norm,
                           **{k: v.detach() for k, v in aux.items()})

    return step


def make_accum_train_step(loss_fn: Callable, accumulate_steps: int):
    """Gradient accumulation: step(state, batches, generator=None) takes a
    sequence of `accumulate_steps` micro-batches, sums their gradients,
    divides by their number and takes ONE optimizer update. loss and aux
    are the means over the micro-batches; grad_norm is the norm of the
    averaged gradient, the one a clip would see."""
    k = int(accumulate_steps)

    def step(state: TrainState, batches: Sequence, generator=None):
        if len(batches) != k:
            raise ValueError(f"{len(batches)} micro-batches, expected {k}")
        _zero_grads(state.model)
        sums = {}
        for batch in batches:
            loss, aux = loss_fn(state.model, batch, generator)
            loss.backward()
            for name, v in dict(loss=loss, **aux).items():
                v = v.detach()
                sums[name] = v if name not in sums else sums[name] + v
        grads = [p.grad for p in state.model.parameters()
                 if p.grad is not None]
        torch._foreach_div_(grads, k)
        g_norm = state.apply_gradients()
        metrics = {name: v / k for name, v in sums.items()}
        metrics["grad_norm"] = g_norm
        return state, metrics

    return step


def make_stream_step(loss_fn: Callable):
    """The multi-stream pretrain step. loss_fn(model, name, batch,
    generator) -> (the stream's weighted scalar loss, aux dict).

    Returns step(state, batches, generators) -> (state, metrics): for each
    stream of `batches` ({name: batch}) in the order of its name, the
    forward and at once the backward of its loss with its generator
    (`generators[name]`), the gradients summing in `.grad`, so that one
    stream's activations are freed before the next stream runs; then one
    optimizer update (the clip sees the summed gradient). This is the
    gradient of the summed loss that the JAX package differentiates in
    one pass. metrics = {loss (the sum), grad_norm, **each stream's
    aux}, detached device tensors."""

    def step(state: TrainState, batches, generators):
        _zero_grads(state.model)
        total, metrics = None, {}
        for name in sorted(batches):
            loss, aux = loss_fn(state.model, name, batches[name],
                                generators[name])
            loss.backward()
            loss = loss.detach()
            total = loss if total is None else total + loss
            metrics.update({k: v.detach() for k, v in aux.items()})
        g_norm = state.apply_gradients()
        return state, dict(loss=total, grad_norm=g_norm, **metrics)

    return step


def pretrain_loss_fn(model, batch, generator=None):
    """Sum of the four pretrain losses of `XFMForPretrain.loss` with MIM on
    (the JAX package's `__graft_entry__._loss_fn`), deterministic."""
    out = model.loss(**batch, ret_mim=True, generator=generator,
                     deterministic=True)
    total = (out["loss_itc"] + out["loss_itm"] + out["loss_mlm"]
             + out["loss_mim"])
    return total, out


def retrieval_loss_fn(model, batch, generator=None,
                      deterministic: bool = True):
    """ITC + ITM of `XFMForRetrieval.loss` (the JAX package's
    `scripts/bench_finetune.py` retrieval loss, deterministic by default;
    the fine-tune's `loss_fn` with `deterministic=False`, its dropouts and
    hard negatives drawn from `generator`)."""
    loss_itc, loss_itm = model.loss(**batch, generator=generator,
                                    deterministic=deterministic)
    return loss_itc + loss_itm, {"loss_itc": loss_itc, "loss_itm": loss_itm}


def vqa_loss_fn(model, batch, generator=None, deterministic: bool = True):
    """`XFMForVQA.loss` on a batch of `VQAData`'s train layout (the
    fine-tune's `loss_fn` with `deterministic=False`, its dropouts drawn
    from `generator`)."""
    keys = ("images", "q_ids", "q_atts", "answer_ids", "answer_atts",
            "ques_idx", "weights")
    loss = model.loss(**{k: batch[k] for k in keys}, generator=generator,
                      deterministic=deterministic)
    return loss, {}


def caption_loss_fn(model, batch, generator=None,
                    deterministic: bool = True):
    """`XFMForCaptioning.loss` on a batch of images, text_ids and text_atts
    (the fine-tune's and the caption-domain pretrain's `loss_fn` with
    `deterministic=False`, its dropouts drawn from `generator`)."""
    loss = model.loss(batch["images"], batch["text_ids"], batch["text_atts"],
                      generator=generator, deterministic=deterministic)
    return loss, {}


def nlvr_loss_fn(model, batch, generator=None, deterministic: bool = True):
    """`XFMForNLVR.loss` on a batch of `NLVRData` (the fine-tune's `loss_fn`
    with `deterministic=False`, its dropouts drawn from `generator`)."""
    loss = model.loss(batch["images"], batch["text_ids"], batch["text_atts"],
                      batch["targets"], generator=generator,
                      deterministic=deterministic)
    return loss, {}


def grounding_loss_fn(model, batch, generator=None,
                      deterministic: bool = True):
    """L1 + GIoU of `XFMForGrounding.loss` on a batch of `GroundingData`
    (the fine-tune's `loss_fn` with `deterministic=False`)."""
    lb, lg = model.loss(batch["images"], batch["text_ids"],
                        batch["text_atts"], batch["target_bbox"],
                        generator=generator, deterministic=deterministic)
    return lb + lg, {"loss_bbox": lb, "loss_giou": lg}
