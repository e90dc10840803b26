"""librosa-compatible STFT log-mel spectrogram, batched in PyTorch.

Counterpart of ``aum_tpu/audio/spectrogram.py``, the EPIC-SOUNDS frontend:
``librosa.stft(n_fft=2048, window='hann', pad_mode='constant')`` with the hop
and window from the config, ``librosa.filters.mel(htk=True, norm=None)``,
then ``log(mel + 1e-6)``. The conventions:

- centred frames: the input is zero-padded by n_fft // 2 on both sides
  (constant mode, not reflect); frame t covers samples [t * hop, t * hop +
  n_fft) of the padded signal, so there are 1 + len(audio) // hop frames;
- a periodic Hann window of win_length samples, zero-padded to n_fft with
  its centre at n_fft / 2 (librosa's ``pad_center``);
- HTK mel triangles (mel = 2595 log10(1 + f / 700)), n_mels + 2 edges uniform
  in mel from 0 to sr / 2, weights in Hz with peak 1 (norm=None).

Since the window is zero outside its win_length central samples, each frame
is taken as only those samples (a strided ``unfold`` view, no gather) and
``rfft(n=n_fft)`` zero-pads them at the end instead of around: the spectrum
then differs by a phase factor per bin, and its magnitude is the same. The
frame tensor is win_length / n_fft of the full frames' size (240 of 2048 at
EPIC's 10 ms window); the complex spectrum keeps its (B, T, 1 + n_fft // 2)
size and is dropped once its magnitude is taken. The rfft is cuFFT on the
card and the mel product a matrix product, as the JAX package leaves both to
XLA outside any Pallas kernel. Everything runs in fp32 on the audio's device.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


# A copy of aum_tpu/audio/spectrogram.py::mel_filterbank_htk (the port
# imports nothing of the JAX package), computed in float64 with numpy.
@lru_cache(maxsize=8)
def mel_filterbank_htk(sr: float, n_fft: int, n_mels: int,
                       fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """librosa.filters.mel(htk=True, norm=None): (n_mels, 1 + n_fft // 2)."""
    if fmax is None:
        fmax = sr / 2.0
    n_bins = 1 + n_fft // 2
    fft_freqs = np.linspace(0, sr / 2.0, n_bins)
    mel_pts = np.linspace(_hz_to_mel_htk(fmin), _hz_to_mel_htk(fmax), n_mels + 2)
    hz_pts = _mel_to_hz_htk(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    weights = np.zeros((n_mels, n_bins))
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0.0, np.minimum(lower, upper))
    return weights.astype(np.float32)


# A copy of aum_tpu/audio/spectrogram.py::_hann_padded.
@lru_cache(maxsize=8)
def _hann_padded(win_length: int, n_fft: int) -> np.ndarray:
    """Periodic hann of win_length, zero-pad-centered to n_fft."""
    n = np.arange(win_length)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    lpad = (n_fft - win_length) // 2
    out = np.zeros(n_fft)
    out[lpad:lpad + win_length] = w
    return out.astype(np.float32)


def stft_log_mel(audio: torch.Tensor, sr: float = 24000.0, n_fft: int = 2048,
                 window_ms: float = 10.0, hop_ms: float = 5.0, n_mels: int = 128,
                 eps: float = 1e-6, max_frames: int | None = None) -> torch.Tensor:
    """Batched log-mel: audio (B, S) or (S,) -> (B, T, n_mels) fp32 with
    T = 1 + S // hop (librosa's centred framing), or only the first
    ``max_frames`` of those frames (a caller that crops computes no more)."""
    squeeze = audio.ndim == 1
    if squeeze:
        audio = audio[None]
    win_length = int(round(window_ms * sr / 1e3))
    hop = int(round(hop_ms * sr / 1e3))
    if not 0 < win_length <= n_fft:
        raise ValueError(f"window of {win_length} samples must be in 1..n_fft={n_fft}")
    t = 1 + audio.shape[1] // hop
    if max_frames is not None:
        t = min(t, max_frames)
    lpad = (n_fft - win_length) // 2
    x = F.pad(audio.float(), (n_fft // 2, n_fft // 2))
    # The window's support of every frame: (B, T, win_length), a view.
    frames = x[:, lpad:].unfold(1, win_length, hop)[:, :t]
    window = torch.from_numpy(_hann_padded(win_length, n_fft)[lpad:lpad + win_length])
    spec = torch.fft.rfft(frames * window.to(x.device), n=n_fft, dim=-1)
    mag = spec.abs()  # (B, T, 1 + n_fft // 2)
    del spec
    mel = torch.from_numpy(mel_filterbank_htk(float(sr), n_fft, n_mels)).to(x.device)
    out = torch.log(mag @ mel.t() + eps)
    return out[0] if squeeze else out
