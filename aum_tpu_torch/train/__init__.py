from aum_tpu_torch.train.loop import (
    AugmentConfig,
    TrainState,
    init_train_state,
    loss_fn_of,
    make_eval_step,
    make_train_step,
    reset_loss_accum,
)
from aum_tpu_torch.train.optim import TrainHyperParams, lr_at_step, make_optimizer

__all__ = [
    "AugmentConfig",
    "TrainHyperParams",
    "TrainState",
    "init_train_state",
    "loss_fn_of",
    "lr_at_step",
    "make_eval_step",
    "make_optimizer",
    "make_train_step",
    "reset_loss_accum",
]
