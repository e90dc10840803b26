"""Kaldi-compatible log-mel filterbank frontend, batched in PyTorch.

Counterpart of ``aum_tpu/audio/fbank.py``, the batched form of
``torchaudio.compliance.kaldi.fbank(htk_compat=True, window_type='hanning',
num_mel_bins, dither=0.0, frame_shift=fshift)`` that the reference's data
loader runs per clip. The Kaldi algorithm for the parameter subset the
reference uses (dither=0, use_energy=False, use_power=True, raw_energy=True,
remove_dc_offset=True, snip_edges=True, round_to_power_of_two=True,
low_freq=20, high_freq=0 meaning Nyquist):

- snip-edges framing: frames of ``frame_length`` samples every
  ``frame_shift``, as a strided view (``unfold``), no gather;
- per-frame DC removal, then pre-emphasis ``x[i] -= 0.97 x[i-1]`` with
  ``x[-1] := x[0]``;
- the window (hanning, povey, hamming or rectangular);
- the power spectrum of the rfft at the padded size (512 for 400 samples),
  with the Nyquist bin dropped (Kaldi's N/2 fft bins);
- the mel-triangle bank on 1127 ln(1 + f / 700), as one matrix product;
- the log with the float32-eps floor.

The rfft and the mel product are library calls: the JAX package leaves them
to XLA too, outside any Pallas kernel. Everything runs in fp32 on the
waveform's device.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FbankConfig:
    sample_frequency: float = 16000.0
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    num_mel_bins: int = 128
    window_type: str = "hanning"   # hanning | povey | hamming | rectangular
    preemphasis_coefficient: float = 0.97
    remove_dc_offset: bool = True
    low_freq: float = 20.0
    high_freq: float = 0.0          # <=0 means offset from Nyquist
    use_power: bool = True

    @property
    def frame_length(self) -> int:
        return int(self.sample_frequency * self.frame_length_ms / 1000)

    @property
    def frame_shift(self) -> int:
        return int(self.sample_frequency * self.frame_shift_ms / 1000)

    @property
    def padded_window_size(self) -> int:
        # round_to_power_of_two=True
        n = 1
        while n < self.frame_length:
            n *= 2
        return n

    def num_frames(self, num_samples: int) -> int:
        # snip_edges=True
        if num_samples < self.frame_length:
            return 0
        return 1 + (num_samples - self.frame_length) // self.frame_shift


def _mel(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


# A copy of aum_tpu/audio/fbank.py::_mel_banks_np (the port imports nothing
# of the JAX package), computed in float64 with numpy.
@lru_cache(maxsize=16)
def _mel_banks_np(num_bins: int, window_length_padded: int, sample_freq: float,
                  low_freq: float, high_freq: float) -> np.ndarray:
    """Kaldi MelBanks weights: (num_bins, window_length_padded // 2).

    Triangles over fft bins k = 0 .. N/2 - 1 at frequencies k * fs / N
    (the Nyquist bin is excluded, matching Kaldi's num_fft_bins = N/2).
    """
    if high_freq <= 0.0:
        high_freq = 0.5 * sample_freq + high_freq
    num_fft_bins = window_length_padded // 2
    fft_bin_width = sample_freq / window_length_padded
    mel_low = _mel(low_freq)
    mel_high = _mel(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    bins = np.zeros((num_bins, num_fft_bins), dtype=np.float64)
    fft_freqs = _mel(fft_bin_width * np.arange(num_fft_bins))
    for b in range(num_bins):
        left = mel_low + b * mel_delta
        center = mel_low + (b + 1) * mel_delta
        right = mel_low + (b + 2) * mel_delta
        up = (fft_freqs - left) / (center - left)
        down = (right - fft_freqs) / (right - center)
        bins[b] = np.maximum(0.0, np.minimum(up, down))
    return bins.astype(np.float32)


def mel_banks(cfg: FbankConfig, device: str | torch.device = "cpu") -> torch.Tensor:
    """(num_mel_bins, padded_window_size // 2) fp32 mel triangles."""
    return torch.from_numpy(_mel_banks_np(
        cfg.num_mel_bins, cfg.padded_window_size, cfg.sample_frequency,
        cfg.low_freq, cfg.high_freq)).to(device)


# A copy of aum_tpu/audio/fbank.py::_window_np.
@lru_cache(maxsize=16)
def _window_np(window_type: str, n: int) -> np.ndarray:
    a = 2.0 * math.pi / (n - 1)
    i = np.arange(n, dtype=np.float64)
    if window_type == "hanning":
        w = 0.5 - 0.5 * np.cos(a * i)
    elif window_type == "hamming":
        w = 0.54 - 0.46 * np.cos(a * i)
    elif window_type == "povey":
        w = (0.5 - 0.5 * np.cos(a * i)) ** 0.85
    elif window_type == "rectangular":
        w = np.ones(n)
    else:
        raise ValueError(f"unknown window type {window_type}")
    return w.astype(np.float32)


def fbank(waveform: torch.Tensor, cfg: FbankConfig = FbankConfig()) -> torch.Tensor:
    """Batched log-mel fbank.

    waveform: (B, S) or (S,). Returns (B, T, num_mel_bins) (or (T,
    num_mel_bins)) fp32 log-mel features, T given by snip-edges framing.
    """
    squeeze = waveform.ndim == 1
    if squeeze:
        waveform = waveform[None]
    s = waveform.shape[1]
    flen = cfg.frame_length
    if cfg.num_frames(s) == 0:
        raise ValueError(f"waveform too short: {s} < frame length {flen}")

    frames = waveform.float().unfold(1, flen, cfg.frame_shift)  # (B, T, flen) view
    if cfg.remove_dc_offset:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if cfg.preemphasis_coefficient != 0.0:
        # Kaldi: x[i] -= coeff * x[i-1], with x[-1] := x[0] (edge duplicate).
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - cfg.preemphasis_coefficient * prev
    window = torch.from_numpy(_window_np(cfg.window_type, flen)).to(frames.device)
    frames = frames * window

    nfft = cfg.padded_window_size
    spec = torch.fft.rfft(frames, n=nfft, dim=-1)
    power = spec.abs() ** 2 if cfg.use_power else spec.abs()
    power = power[..., : nfft // 2]  # drop the Nyquist bin (Kaldi)

    energies = power @ mel_banks(cfg, frames.device).t()
    # use_log_fbank with Kaldi's epsilon floor.
    energies = torch.log(torch.clamp_min(energies, float(np.finfo(np.float32).eps)))
    return energies[0] if squeeze else energies
