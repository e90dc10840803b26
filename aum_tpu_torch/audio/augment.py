"""Dataset normalization of log-mel features.

Counterpart of ``aum_tpu/audio/augment.py::normalize``. The train-time
augmentations of that module (``spec_augment``, ``mixup_waveforms``,
``noise_and_roll``) are not ported yet.
"""

from __future__ import annotations

import torch


def normalize(fb: torch.Tensor, mean: float, std: float) -> torch.Tensor:
    """Dataset normalization: (x - mean) / (2 * std), as the reference's
    data loader does."""
    return (fb - mean) / (2.0 * std)
