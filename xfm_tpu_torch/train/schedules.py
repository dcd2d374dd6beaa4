"""LR schedules (`xfm_tpu/train/schedules.py`): step → learning rate, the
step being the optimizer's count before it is incremented."""
from __future__ import annotations

import math
from typing import Callable, Optional


def linear_warmup_decay(lr: float, num_training_steps: int,
                        num_warmup_steps: int | float):
    """Per-step linear warmup → linear decay; a float warmup is a fraction
    of the total steps. Returns step → learning rate."""
    if isinstance(num_warmup_steps, float):
        if not 0 <= num_warmup_steps < 1:
            raise ValueError(f"warmup fraction {num_warmup_steps} not in "
                             "[0, 1)")
        num_warmup_steps = int(num_training_steps * num_warmup_steps)
    warm = max(1, num_warmup_steps)

    def schedule(step: int) -> float:
        if step < num_warmup_steps:
            frac = step / warm
        else:
            frac = (num_training_steps - step) / max(
                1, num_training_steps - num_warmup_steps)
        return lr * min(max(frac, 0.0), 1.0)

    return schedule


def half_cosine(lr: float, min_lr: float, epochs: int, warmup_epochs: int,
                steps_per_epoch: int):
    """Per-step half-cosine from lr to min_lr after a linear warmup of
    `warmup_epochs` whole epochs."""
    total = epochs * steps_per_epoch
    warm = warmup_epochs * steps_per_epoch

    def schedule(step: int) -> float:
        if step < warm:
            return lr * step / max(1, warm)
        progress = (step - warm) / max(1, total - warm)
        return min_lr + (lr - min_lr) * 0.5 * (1.0 + math.cos(
            math.pi * progress))

    return schedule


def schedule_from_config(config: dict, steps_per_epoch: Optional[int] = None
                         ) -> Callable[[int], float]:
    """The YAML's `schedular` (or `scheduler`) block: `sched` linear (the
    default) or cosine, `lr`; `num_training_steps` defaults to epochs ×
    `steps_per_epoch` (optimizer steps), a float `num_warmup_steps` is a
    fraction of it."""
    sch = dict(config.get("schedular", config.get("scheduler", {})) or {})
    lr = sch.get("lr", 1e-4)
    if "num_training_steps" not in sch:
        if steps_per_epoch is None:
            raise ValueError("need steps_per_epoch to derive "
                             "num_training_steps")
        sch["num_training_steps"] = sch.get("epochs", 1) * steps_per_epoch
    kind = sch.get("sched", "linear")
    if kind == "linear":
        return linear_warmup_decay(lr, sch["num_training_steps"],
                                   sch.get("num_warmup_steps", 0))
    if kind == "cosine":
        return half_cosine(lr, sch.get("min_lr", 0.0), sch.get("epochs", 1),
                           sch.get("warmup_epochs", 0), steps_per_epoch)
    raise NotImplementedError(kind)
