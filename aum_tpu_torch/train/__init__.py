from aum_tpu_torch.train.checkpoints import Checkpointer, average_params
from aum_tpu_torch.train.loop import (
    AugmentConfig,
    TrainState,
    average_ensemble_views,
    evaluate,
    evaluate_ensemble,
    flexible_patch_schedule,
    init_train_state,
    loss_fn_of,
    make_eval_step,
    make_train_step,
    reset_loss_accum,
    sigmoid_np,
    train_loop,
)
from aum_tpu_torch.train.metrics import calculate_stats, d_prime, mean_average_precision
from aum_tpu_torch.train.optim import TrainHyperParams, lr_at_step, make_optimizer

__all__ = [
    "AugmentConfig",
    "Checkpointer",
    "TrainHyperParams",
    "TrainState",
    "average_ensemble_views",
    "average_params",
    "calculate_stats",
    "d_prime",
    "evaluate",
    "evaluate_ensemble",
    "flexible_patch_schedule",
    "init_train_state",
    "loss_fn_of",
    "lr_at_step",
    "make_eval_step",
    "make_optimizer",
    "make_train_step",
    "mean_average_precision",
    "reset_loss_accum",
    "sigmoid_np",
    "train_loop",
]
