"""LR schedules (`xfm_tpu/train/schedules.py`)."""
from __future__ import annotations


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
