"""Learning-rate schedule of the trainers, as in the JAX package's
train/schedule.py: MultiStepLR(gamma 0.5) stepped per epoch, and a linear
warm-up over the first 1500 optimizer steps, applied only when a scheduler
is configured.

The optimizer is `torch.optim.Adam(weight_decay=5e-5)` itself: its L2 decay
is added to the gradient before the moments (coupled), which is what the
JAX package rebuilt from optax (`add_decayed_weights` before
`scale_by_adam`). The trainer writes the learning rate of `current_lr`
into the optimizer's param_groups before every step.
"""

from __future__ import annotations

import torch

WEIGHT_DECAY = 5e-5  # the trainers' Adam(weight_decay=...)


def multistep_lr(base_lr: float, milestones: list[int] | None, gamma: float, epoch: int) -> float:
    if not milestones:
        return base_lr
    return base_lr * (gamma ** sum(1 for m in milestones if epoch >= m))


def current_lr(base_lr: float, milestones: list[int] | None, global_step: int, epoch: int,
               warmup_steps: int = 1500, gamma: float = 0.5) -> float:
    lr = multistep_lr(base_lr, milestones, gamma, epoch)
    if milestones and global_step < warmup_steps:
        lr = lr * min(1.0, float(global_step + 1) / warmup_steps)
    return lr


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Write `lr` into every param group (before each optimizer step)."""
    for group in optimizer.param_groups:
        group["lr"] = lr
