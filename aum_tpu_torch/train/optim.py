"""Adam and the lr schedule with the reference's semantics.

Counterpart of ``aum_tpu/train/optim.py``: ``TrainHyperParams`` and
``lr_at_step`` are the same rules in plain Python on ints (read there for
the reasons behind each branch):

- Adam with batch-size-scaled hyperparameters: betas 1 - (1 - b) * s for
  b in (0.95, 0.999), eps 1e-8 / sqrt(s); weight decay is added to the grad
  before the moments, which is what ``torch.optim.Adam`` does;
- MultiStepLR per-epoch decay: epoch e (1-based) uses
  decay ** #(milestones <= e - 1), milestones start, start + step, ...;
- the step warmup staircase: the lr is written at multiples of q = 50 // s
  up to (w // q) * q, w = 1000 // s, and the last write (warm or epoch
  boundary) wins;
- EPIC: linear warmup over ``epic_warmup_epochs`` from 0.01 lr, then the
  full lr (the decay applies only without warmup).

The train step sets each step's lr from ``lr_at_step`` before ``step()``.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class TrainHyperParams:
    lr: float = 1e-5
    weight_decay: float = 5e-7
    bs_scale_factor: int = 1
    warmup: bool = True
    # MultiStepLR params (non-epic datasets)
    lrscheduler_start: int = 2
    lrscheduler_step: int = 1
    lrscheduler_decay: float = 0.5
    # loss: "BCE" | "CE"
    loss: str = "BCE"
    n_epochs: int = 5
    epic: bool = False
    epic_warmup_epochs: int = 2


def _multistep_factor(epoch: int, start: int, step: int, decay: float) -> float:
    e = epoch - 1  # the torch scheduler's last_epoch while epoch e runs
    count = (e - start) // step + 1 if e >= start else 0
    return decay ** count


def _epic_factor(epoch: int) -> float:
    return 1.0 if epoch < 11 else (0.05 if epoch < 21 else 0.01)


def lr_at_step(hp: TrainHyperParams, step: int, steps_per_epoch: int) -> float:
    """The learning rate at 0-based global step ``step``."""
    epoch = step // steps_per_epoch + 1  # 1-based
    if hp.epic:
        warm_steps = hp.epic_warmup_epochs * steps_per_epoch
        if hp.warmup:
            if step < warm_steps:
                return hp.lr * 0.01 + step * (hp.lr - hp.lr * 0.01) / warm_steps
            return hp.lr
        return hp.lr * _epic_factor(epoch)
    sched_lr = hp.lr * _multistep_factor(
        epoch, hp.lrscheduler_start, hp.lrscheduler_step, hp.lrscheduler_decay)
    if not hp.warmup:
        return sched_lr
    w = 1000 // hp.bs_scale_factor
    q = max(1, 50 // hp.bs_scale_factor)
    last_warm = min(step - step % q, (w // q) * q)
    epoch_start = (step // steps_per_epoch) * steps_per_epoch
    return last_warm / w * hp.lr if last_warm >= epoch_start else sched_lr


def make_optimizer(params, hp: TrainHyperParams) -> torch.optim.Adam:
    """``torch.optim.Adam`` with the batch-scaled betas and eps; its lr is
    set per step from ``lr_at_step`` by the train step."""
    s = hp.bs_scale_factor
    betas = tuple(1.0 - (1.0 - b) * s for b in (0.95, 0.999))
    return torch.optim.Adam(params, lr=hp.lr, betas=betas, eps=1e-8 / s ** 0.5,
                            weight_decay=hp.weight_decay)
