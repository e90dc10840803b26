"""Host-side dataset: JSON datafiles, a label CSV and a WAV decoder.

Counterpart of ``aum_tpu/data/datasets.py``, which rebuilds the reference's
``AudiosetDataset``: the host only decodes waveforms and assembles
fixed-shape batches; the fbank, the frame mask, mixup, SpecAugment and the
normalization run batched on the batch's device (``data/pipeline.py``).

Semantics kept from the JAX package:

- the datafile ``{"data": [{"wav": path, "labels": "mid1,mid2"}]}`` and the
  label CSV ``index,mid,display_name``;
- pad or crop to ``target_length`` frames: the reference zero-pads the
  *fbank*, not the waveform, so each clip carries its true frame count and
  the featurizer zeroes the frames past it;
- a failed decode is retried with a random replacement index, up to 20
  times.

WAV files decode here through the stdlib ``wave`` module and numpy (PCM
8/16/24/32-bit and float32), or in batches through the native WAV decoder;
every other format (flac, m4a, mp3, ogg) through the native ffmpeg-backed
decoder (``data/native.py``, ``csrc/audiodecode.cpp``), one file at a time
or in batches. A decoder that cannot be built raises; it is never retried.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import wave as wave_mod
from typing import Callable, Optional

import numpy as np


def make_index_dict(label_csv: str) -> dict:
    """mid -> class index."""
    lookup = {}
    with open(label_csv, "r") as f:
        for row in csv.DictReader(f):
            lookup[row["mid"]] = int(row["index"])
    return lookup


def make_name_dict(label_csv: str) -> dict:
    """class index -> display name."""
    lookup = {}
    with open(label_csv, "r") as f:
        for row in csv.DictReader(f):
            lookup[int(row["index"])] = row["display_name"]
    return lookup


def _read_float32_wav(path: str) -> tuple[np.ndarray, int]:
    """IEEE-float WAV (format tag 3), which the stdlib ``wave`` refuses:
    (float32 samples of the first channel, sample rate)."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError(f"not a RIFF/WAVE file: {path}")
    pos, fmt = 12, None
    while pos + 8 <= len(raw):
        cid, size = raw[pos:pos + 4], int.from_bytes(raw[pos + 4:pos + 8], "little")
        body = raw[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = (int.from_bytes(body[0:2], "little"), int.from_bytes(body[2:4], "little"),
                   int.from_bytes(body[4:8], "little"), int.from_bytes(body[14:16], "little"))
        elif cid == b"data":
            if fmt is None or fmt[0] != 3 or fmt[3] != 32:
                raise ValueError(f"unsupported WAV format {fmt} in {path}")
            ch = fmt[1]
            data = np.frombuffer(body[:len(body) // (4 * ch) * 4 * ch], dtype="<f4")
            return data.reshape(-1, ch)[:, 0].astype(np.float32), fmt[2]
        pos += 8 + size + (size & 1)
    raise ValueError(f"no data chunk in {path}")


def load_wav(path: str) -> tuple[np.ndarray, int]:
    """Decode a WAV file -> (float32 mono waveform in [-1, 1], sample_rate).
    PCM 8/16/24/32-bit and IEEE float32; the first channel of several."""
    try:
        w = wave_mod.open(path, "rb")
    except wave_mod.Error:  # the stdlib reads PCM only
        return _read_float32_wav(path)
    with w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        val = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
               | (b[:, 2].astype(np.int32) << 16))
        val = np.where(val >= 1 << 23, val - (1 << 24), val)
        data = val.astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"unsupported WAV sample width {width} in {path}")
    if ch > 1:
        data = data.reshape(-1, ch)[:, 0]  # first channel (torchaudio layout)
    return data, sr


@dataclasses.dataclass
class AudioConf:
    """Audio pipeline settings (the reference's audio_conf dict)."""

    num_mel_bins: int = 128
    target_length: int = 1024
    freqm: int = 0
    timem: int = 0
    mixup: float = 0.0
    dataset: str = "audioset"
    mean: float = -4.2677393
    std: float = 4.5689974
    noise: bool = False
    skip_norm: bool = False
    fshift: float = 10.0
    sample_frequency: float = 16000.0

    @property
    def frame_length_samples(self) -> int:
        return int(self.sample_frequency * 25.0 / 1000)

    @property
    def frame_shift_samples(self) -> int:
        return int(self.sample_frequency * self.fshift / 1000)

    @property
    def target_samples(self) -> int:
        """Samples that produce exactly target_length snip-edges frames."""
        return ((self.target_length - 1) * self.frame_shift_samples
                + self.frame_length_samples)

    def n_frames(self, n_samples):
        """Snip-edges frames of clips of ``n_samples`` (int or int array),
        capped at target_length."""
        n = np.maximum(1 + (np.asarray(n_samples) - self.frame_length_samples)
                       // self.frame_shift_samples, 0)
        return np.minimum(n, self.target_length)


class AudioJsonDataset:
    """JSON-datafile dataset returning fixed-length waveforms and labels."""

    def __init__(
        self,
        dataset_json_file: str,
        audio_conf: AudioConf,
        label_csv: str,
        decoder: Optional[Callable[[str], tuple[np.ndarray, int]]] = None,
        rev_audio: bool = False,
    ):
        with open(dataset_json_file, "r") as fp:
            self.data = json.load(fp)["data"]
        self.conf = audio_conf
        self.index_dict = make_index_dict(label_csv)
        self.label_num = len(self.index_dict)
        self.decoder = decoder or self._default_decode
        self.decoder_is_default = decoder is None
        self.rev_audio = rev_audio

    def _default_decode(self, path: str) -> tuple[np.ndarray, int]:
        """WAV through ``load_wav``; anything else through the native
        ffmpeg-backed decoder, capped at ``target_samples`` (``waveform``
        crops there anyway)."""
        if path.lower().endswith(".wav"):
            return load_wav(path)
        from aum_tpu_torch.data.native import decode_audio

        cap = self.conf.target_samples
        out, n_samples, sr = decode_audio(path, cap)
        return out[:min(n_samples, cap)], sr

    def __len__(self) -> int:
        return len(self.data)

    def labels(self, index: int) -> np.ndarray:
        y = np.zeros(self.label_num, dtype=np.float32)
        for s in self.data[index]["labels"].split(","):
            y[self.index_dict[s]] = 1.0
        return y

    def waveform(self, index: int) -> tuple[np.ndarray, int]:
        """(wave padded or cropped to target_samples, true frame count)."""
        conf = self.conf
        wave, _sr = self.decoder(self.data[index]["wav"])
        wave = wave - wave.mean()
        if self.rev_audio:
            wave = wave[::-1].copy()
        n_frames = int(conf.n_frames(len(wave)))
        tgt = conf.target_samples
        if len(wave) >= tgt:
            wave = wave[:tgt]
        else:
            wave = np.pad(wave, (0, tgt - len(wave)))
        return wave.astype(np.float32), n_frames

    def sample(self, index: int, rng: np.random.Generator):
        """One (wave, n_frames, label), retrying a failed decode with a random
        replacement index; a decoder that cannot be built raises at once."""
        from aum_tpu_torch.data.native import DecoderUnavailable

        for _ in range(20):
            try:
                wave, n_frames = self.waveform(index)
                return wave, n_frames, self.labels(index)
            except DecoderUnavailable:
                raise
            except Exception:
                index = int(rng.integers(0, len(self.data)))
        raise RuntimeError("too many consecutive decode failures")
