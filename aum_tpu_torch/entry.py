"""The port's flagship entry points.

- ``entry``: the eval forward, the counterpart of ``__graft_entry__.entry``:
  AuM-Base Fo-Bi (bimamba v1, width 768, depth 24), 527 classes, bf16
  compute with an fp32 residual stream, weights drawn from a fixed seed, on
  a (8, 1024, 128) log-mel input: 513 tokens with the middle cls token.
- ``train_entry``: one train step of the same model, the counterpart of
  ``scripts/bench_train_step.py``: B = 12 (the recipes' batch size), BCE,
  Adam with lr 5e-5 and weight decay 5e-7 over 1000 steps per epoch, one-hot
  labels ``arange(B) % 527``, no augmentation, ``remat_mode="split"``.

Both run on CUDA unless ``device`` is given, and raise without a card.
"""

from __future__ import annotations

import torch

from aum_tpu_torch.models import AudioMamba, AudioMambaConfig
from aum_tpu_torch.train import (
    TrainHyperParams,
    init_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from aum_tpu_torch.utils import resolve_device

TRAIN_BATCH = 12
TRAIN_HP = TrainHyperParams(lr=5e-5, weight_decay=5e-7)
STEPS_PER_EPOCH = 1000


def flagship_config(**overrides) -> AudioMambaConfig:
    kw = {"num_classes": 527, "dtype": "bfloat16", **overrides}
    return AudioMambaConfig.from_variant("base", "Fo-Bi", **kw)


def entry(device: str | torch.device | None = None):
    """(fn, args) for one eval forward; ``fn(*args)`` returns (8, 527) logits."""
    device = resolve_device(device)
    model = AudioMamba(flagship_config(), device=device, seed=0)
    x = torch.zeros((8, 1024, 128), dtype=torch.float32, device=device)
    return make_eval_step(model), (x,)


def train_entry(device: str | torch.device | None = None):
    """(step_fn, state, batch); ``step_fn(state, batch)`` takes one train step
    and returns (state, loss)."""
    device = resolve_device(device)
    cfg = flagship_config(remat=True, remat_mode="split")
    model = AudioMamba(cfg, device=device, seed=0)
    state = init_train_state(model, make_optimizer(model.parameters(), TRAIN_HP))
    step_fn = make_train_step(TRAIN_HP, STEPS_PER_EPOCH, loss_type="BCE",
                              generator=torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    x = torch.randn((TRAIN_BATCH, *reversed(cfg.spectrogram_size)), generator=g)
    y = torch.nn.functional.one_hot(torch.arange(TRAIN_BATCH) % cfg.num_classes,
                                    cfg.num_classes).float()
    return step_fn, state, {"x": x.to(device), "y": y.to(device)}
