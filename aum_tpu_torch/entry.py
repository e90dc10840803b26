"""The port's flagship forward, the counterpart of ``__graft_entry__.entry``.

AuM-Base Fo-Bi (bimamba v1, width 768, depth 24), 527 classes, bf16 compute
with an fp32 residual stream, weights drawn from a fixed seed, on a
(8, 1024, 128) log-mel input: 513 tokens with the middle cls token.
"""

from __future__ import annotations

import torch

from aum_tpu_torch.models import AudioMamba, AudioMambaConfig
from aum_tpu_torch.utils import resolve_device


def flagship_config(**overrides) -> AudioMambaConfig:
    kw = {"num_classes": 527, "dtype": "bfloat16", **overrides}
    return AudioMambaConfig.from_variant("base", "Fo-Bi", **kw)


def entry(device: str | torch.device | None = None):
    """(fn, args) for one eval forward; ``fn(*args)`` returns (8, 527) logits.

    Runs on CUDA unless ``device`` is given; raises without a card.
    """
    device = resolve_device(device)
    model = AudioMamba(flagship_config(), device=device, seed=0)
    x = torch.zeros((8, 1024, 128), dtype=torch.float32, device=device)

    def fn(x: torch.Tensor) -> torch.Tensor:
        return model(x)

    return fn, (x,)
