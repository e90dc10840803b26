"""The served forward: from waveforms, or from log-mels, to logits.

Counterpart of ``aum_tpu/serving.py::_forward_fn``, the function the JAX
package exports into a serving bundle. With the frontend it follows the
reference data loader: per-clip mean subtraction, the Kaldi fbank, zero-pad
or crop to ``audio_length`` frames, then ``(x - mean) / (2 * std)``. The
bundle itself (``export_bundle``, ``load_bundle``), int8 weight quantization
and the HTTP server are not ported yet.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from aum_tpu_torch.audio import FbankConfig, fbank, normalize


def frontend_fn(*, audio_length: int, melbins: int, mean: float, std: float,
                sample_rate: int) -> Callable:
    """(B, S) waveform -> (B, audio_length, melbins) normalized fp32 log-mel."""
    fcfg = FbankConfig(sample_frequency=sample_rate, num_mel_bins=melbins)

    def frontend(wav: torch.Tensor) -> torch.Tensor:
        wav = wav - wav.mean(dim=-1, keepdim=True)
        fb = fbank(wav, fcfg)  # (B, T, M)
        t = fb.shape[1]
        fb = F.pad(fb, (0, 0, 0, audio_length - t)) if t < audio_length else fb[:, :audio_length]
        return normalize(fb, mean, std)

    return frontend


def forward_fn(model: Callable, *, include_frontend: bool, audio_length: int,
               melbins: int, mean: float, std: float, sample_rate: int) -> Callable:
    """x -> logits: x is a (B, S) waveform with the frontend, else a (B, T,
    melbins) log-mel. The caller picks the autograd mode (eval callers wrap
    it in ``train.make_eval_step``)."""
    if not include_frontend:
        return model
    frontend = frontend_fn(audio_length=audio_length, melbins=melbins, mean=mean, std=std,
                           sample_rate=sample_rate)
    return lambda wav: model(frontend(wav))
