"""Plain reference of the served frontend: Kaldi's log-mel fbank, in float64.

What ``torchaudio.compliance.kaldi.fbank(htk_compat=True, window_type=
'hanning', dither=0.0, num_mel_bins=M)`` computes for one clip (the
upstream data loader's call), then the loader's zero-pad or crop to
``audio_length`` frames and ``(x - mean) / (2 * std)``:

- frames of 25 ms every 10 ms, snip-edges;
- per frame: the DC offset removed, pre-emphasis 0.97 (x[-1] := x[0]), the
  Hann window (Kaldi's "hanning": 0.5 - 0.5 cos(2 pi i / (n - 1)));
- the power spectrum at the padded length (a power of two), as a product
  with an explicit DFT matrix, Nyquist bin dropped;
- Kaldi's mel triangles on 1127 ln(1 + f / 700), from 20 Hz to Nyquist;
- the log, floored at float32's eps.

The clip's mean is removed first, as the loader does. Imports only torch
and numpy.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _mel(f):
    return 1127.0 * np.log(1.0 + f / 700.0)


def mel_matrix(num_bins: int, n_fft: int, sample_rate: float, low: float = 20.0) -> np.ndarray:
    """(num_bins, n_fft // 2) Kaldi mel triangles, float64."""
    nyquist = 0.5 * sample_rate
    lo, hi = _mel(low), _mel(nyquist)
    step = (hi - lo) / (num_bins + 1)
    freqs = _mel(sample_rate / n_fft * np.arange(n_fft // 2))
    out = np.zeros((num_bins, n_fft // 2))
    for b in range(num_bins):
        left, center, right = lo + b * step, lo + (b + 1) * step, lo + (b + 2) * step
        out[b] = np.clip(np.minimum((freqs - left) / (center - left),
                                    (right - freqs) / (right - center)), 0.0, None)
    return out


def dft_matrices(frame_len: int, n_fft: int):
    """cos and sin of the real DFT of a zero-padded frame: (frame_len, n_fft // 2)."""
    k = np.arange(n_fft // 2)
    i = np.arange(frame_len)[:, None]
    ang = 2.0 * math.pi * i * k / n_fft
    return np.cos(ang), np.sin(ang)


def log_mel(wav: torch.Tensor, *, sample_rate: int, melbins: int, audio_length: int,
            mean: float, std: float) -> torch.Tensor:
    """(Bt, S) waveforms -> (Bt, audio_length, melbins) normalized log-mel, float64."""
    x = wav.double()
    x = x - x.mean(dim=-1, keepdim=True)
    flen, shift = int(sample_rate * 0.025), int(sample_rate * 0.010)
    n_fft = 1 << (flen - 1).bit_length()
    n_frames = 1 + (x.shape[1] - flen) // shift
    idx = torch.arange(n_frames, device=x.device)[:, None] * shift + torch.arange(
        flen, device=x.device)
    frames = x[:, idx]                                                # (Bt, T, flen)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = frames - 0.97 * prev
    i = torch.arange(flen, dtype=torch.float64, device=x.device)
    frames = frames * (0.5 - 0.5 * torch.cos(2.0 * math.pi * i / (flen - 1)))
    cos, sin = (torch.from_numpy(m).to(x.device) for m in dft_matrices(flen, n_fft))
    power = (frames @ cos) ** 2 + (frames @ sin) ** 2
    mel = torch.from_numpy(mel_matrix(melbins, n_fft, sample_rate)).to(x.device)
    energies = power @ mel.t()
    feats = torch.log(torch.clamp_min(energies, float(np.finfo(np.float32).eps)))
    t = feats.shape[1]
    if t < audio_length:
        feats = torch.nn.functional.pad(feats, (0, 0, 0, audio_length - t))
    else:
        feats = feats[:, :audio_length]
    return (feats - mean) / (2.0 * std)
