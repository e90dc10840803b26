"""The train and eval steps.

Counterpart of ``aum_tpu/train/loop.py`` (``make_train_step``,
``make_eval_step``, ``TrainState``, ``loss_fn_of``) on one device, without
the mesh. One step: the forward in train mode, the loss (BCE or soft-label
CE on fp32 logits), the backward, and the Adam update with the step's lr
from ``lr_at_step``. As in the JAX step:

- ``nan2num`` coerces a non-finite loss before the backward;
- ``accum_steps`` splits the batch into equal microbatches and averages
  their grads before one update: the full-batch mean-loss step;
- a non-finite loss skips the update: the params and the Adam moments and
  count stay as they were, while the lr schedule's step still advances
  (the reference's epoch scheduler steps regardless of skipped batches);
  ``nonfinite_count`` counts such steps and ``loss_sum`` sums the finite
  losses.

Unlike the JAX step, which returns a new state, the params (in the model)
and the Adam state (in the optimizer) are updated in place; the step reads
the loss on the host once, to decide whether to update. Dropout and drop
path draw from an explicit ``torch.Generator``. On-device augmentation
(SpecAugment, noise) is not ported yet and raises.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from aum_tpu_torch.train.optim import TrainHyperParams, lr_at_step


@dataclasses.dataclass
class TrainState:
    """What one train step reads and advances. ``model`` holds the params and
    ``optimizer`` the Adam moments and count; ``step`` drives the schedule."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    loss_sum: float = 0.0
    nonfinite_count: int = 0


def reset_loss_accum(state: TrainState) -> TrainState:
    """Zero the epoch-loss accumulators (start of each epoch)."""
    return dataclasses.replace(state, loss_sum=0.0, nonfinite_count=0)


def init_train_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer
                     ) -> TrainState:
    return TrainState(model=model, optimizer=optimizer)


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """On-device train-time augmentation (not ported yet: non-zero raises)."""

    freqm: int = 0
    timem: int = 0
    noise: bool = False


def loss_fn_of(loss_type: str) -> Callable:
    """Mean BCE-with-logits, or soft-label CE, on fp32 logits."""
    if loss_type == "BCE":
        def f(logits, labels):
            return F.binary_cross_entropy_with_logits(logits.float(), labels.float())
    elif loss_type == "CE":
        def f(logits, labels):
            return -(labels.float() * F.log_softmax(logits.float(), dim=-1)).sum(-1).mean()
    else:
        raise ValueError(loss_type)
    return f


def make_train_step(hp: TrainHyperParams, steps_per_epoch: int,
                    loss_type: str = "BCE", augment: AugmentConfig = AugmentConfig(),
                    nan2num: bool = False, accum_steps: int = 1,
                    generator: torch.Generator | None = None) -> Callable:
    """(state, batch) -> (state, loss) for batch {'x': (B, T, F), 'y': (B, C)}.

    ``loss`` is the step's mean loss, a 0-d fp32 tensor on the batch's
    device. ``generator`` feeds the model's dropout and drop path.
    """
    if augment.freqm or augment.timem or augment.noise:
        raise NotImplementedError(
            "SpecAugment and noise are not ported yet (frontend slice)")
    loss_of = loss_fn_of(loss_type)

    def step_fn(state: TrainState, batch) -> tuple[TrainState, torch.Tensor]:
        model, opt = state.model, state.optimizer
        x, y = batch["x"], batch["y"]
        if x.shape[0] % accum_steps:
            raise ValueError(f"batch {x.shape[0]} not divisible by accum_steps={accum_steps}")
        opt.zero_grad(set_to_none=True)
        loss = torch.zeros((), dtype=torch.float32, device=x.device)
        for xm, ym in zip(x.chunk(accum_steps), y.chunk(accum_steps)):
            micro = loss_of(model(xm, train=True, generator=generator), ym)
            if nan2num:
                micro = torch.nan_to_num(micro)
            (micro / accum_steps).backward()
            loss = loss + micro.detach()
        loss = loss / accum_steps
        value = loss.item()
        finite = value == value and abs(value) != float("inf")
        if finite:
            for group in opt.param_groups:
                group["lr"] = lr_at_step(hp, state.step, steps_per_epoch)
            opt.step()
        opt.zero_grad(set_to_none=True)
        state.step += 1
        state.loss_sum += value if finite else 0.0
        state.nonfinite_count += 0 if finite else 1
        return state, loss

    return step_fn


def make_eval_step(model: torch.nn.Module) -> Callable:
    """x -> logits, without autograd."""

    def eval_fn(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(x)

    return eval_fn
