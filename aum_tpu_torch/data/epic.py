"""EPIC-SOUNDS dataset and batch pipelines: annotation records, an audio store,
the featurizer on the device.

Counterpart of ``aum_tpu/data/epic.py``, which rebuilds the reference's
``epic_data`` package. The host slices fixed-length sample windows out of
the audio store; the librosa-compatible log-mel (``audio/spectrogram.py``)
and the sparse-warp SpecAugment (``audio/spec_warp.py``) run batched on the
device. Semantics kept from the JAX package:

- records carry HH:MM:SS.fff start and stop timestamps, turned into sample
  indices at the sampling rate;
- clip sampling: train and val take a random window of the segment, test
  NUM_ENSEMBLE_VIEWS windows evenly spread over it (each view one dataset
  index); a segment shorter than the clip is taken whole and zero-padded;
- the log-mel is cropped to NUM_FRAMES, and the frames past a clip's true
  count repeat its last real frame ("edge" padding);
- in training, ``combined_transforms`` (time warp, two frequency and two
  time masks, mean fill), then ``(x - mean) / (2 std)``.

The record order and the windows come from the same numpy generators as in
the JAX package (``default_rng(seed + epoch)``), drawn in record order, so
the order, ``record_index``, ``n_frames`` and every window are equal index
for index (the JAX pipeline's with one worker, whose draws are then in
record order too). The augmentation draws come from a per-epoch
``torch.Generator`` on the device, seeded from ``default_rng([seed,
epoch])`` (the flexi pipeline ``[seed, epoch, 1]``). Under data
parallelism each rank takes ``order[data_rank::n_data]``, the JAX
pipeline's share for process i of n taken by the rank's 'data' coordinate
(the ranks of one 'model', 'seq' or 'pipe' group read the same records);
``steps_per_epoch`` divides by ``n_data`` and a train epoch stops there.

The dataset takes a list of records and any mapping ``video_id -> 1-D
samples``: an in-memory dict of arrays, or an open ``h5py.File``.
``EpicSoundsDataset.from_files`` reads the reference's files (a pandas
pickle of annotations and an HDF5 audio store) and needs pandas and h5py,
which it imports only there.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import time as _time
from datetime import timedelta
from typing import Iterator, Mapping, Optional, Sequence

import numpy as np
import torch

from aum_tpu_torch.audio.augment import normalize
from aum_tpu_torch.audio.spec_warp import apply_combined, draw_combined
from aum_tpu_torch.audio.spectrogram import stft_log_mel
from aum_tpu_torch.data.pipeline import epoch_generator, to_device
from aum_tpu_torch.utils import resolve_device

N_FFT = 2048


def timestamp_to_sec(timestamp: str) -> float:
    """HH:MM:SS.fff -> seconds."""
    x = _time.strptime(timestamp, "%H:%M:%S.%f")
    sec = float(timedelta(hours=x.tm_hour, minutes=x.tm_min,
                          seconds=x.tm_sec).total_seconds())
    return sec + float(timestamp.split(".")[-1]) / 1000


@dataclasses.dataclass(frozen=True)
class EpicAudioConfig:
    """The AUDIO_DATA and augmentation keys of the reference's
    config_default.yaml."""

    clip_secs: float = 10.0
    hop_length_ms: float = 5.0
    num_frames: int = 1024
    num_frequencies: int = 128
    sampling_rate: int = 24000
    window_length_ms: float = 10.0
    t_mask: int = 192
    f_mask: int = 48
    t_warp: int = 5
    num_ensemble_views: int = 5
    num_classes: int = 44
    mean: float = -6.627534
    std: float = 4.4917786

    @property
    def clip_samples(self) -> int:
        return int(round(self.sampling_rate * self.clip_secs))

    @property
    def hop_samples(self) -> int:
        return int(round(self.hop_length_ms * self.sampling_rate / 1e3))

    @staticmethod
    def from_yaml(path: str, **overrides) -> "EpicAudioConfig":
        import yaml

        with open(path) as f:
            cfg = yaml.safe_load(f)
        ad = cfg.get("AUDIO_DATA", {})
        kw = dict(
            clip_secs=ad.get("CLIP_SECS", 10),
            hop_length_ms=ad.get("HOP_LENGTH", 5),
            num_frames=ad.get("NUM_FRAMES", 1024),
            num_frequencies=ad.get("NUM_FREQUENCIES", 128),
            sampling_rate=ad.get("SAMPLING_RATE", 24000),
            window_length_ms=ad.get("WINDOW_LENGTH", 10),
            t_mask=cfg.get("T_MASK", 192),
            f_mask=cfg.get("F_MASK", 48),
            t_warp=cfg.get("T_WARP", 5),
            num_ensemble_views=cfg.get("TEST", {}).get("NUM_ENSEMBLE_VIEWS", 5),
        )
        kw.update(overrides)
        return EpicAudioConfig(**kw)


class EpicSoundsRecord:
    """One annotation: a mapping (a dict, or a pandas row) with 'video_id',
    'start_timestamp', 'stop_timestamp' and optionally 'class_id'."""

    def __init__(self, series, sampling_rate: int = 24000):
        self._series = series
        self.sampling_rate = sampling_rate

    @property
    def video_id(self):
        return self._series["video_id"]

    @property
    def start_audio_sample(self) -> int:
        return int(timestamp_to_sec(self._series["start_timestamp"]) * self.sampling_rate)

    @property
    def end_audio_sample(self) -> int:
        return int(timestamp_to_sec(self._series["stop_timestamp"]) * self.sampling_rate)

    @property
    def label(self) -> int:
        return int(self._series.get("class_id", 0))

    @property
    def num_audio_samples(self) -> int:
        return self.end_audio_sample - self.start_audio_sample


def get_start_end_idx(audio_size, clip_size, clip_idx, num_clips,
                      start_sample=0, rng: Optional[np.random.Generator] = None):
    """The clip's first and last sample: a uniform start over the segment
    (clip_idx -1) or view clip_idx of num_clips evenly spread."""
    delta = max(audio_size - clip_size, 0)
    if clip_idx == -1:
        start = (rng or np.random.default_rng()).uniform(0, delta)
    else:
        start = np.linspace(0, delta, num=num_clips)[clip_idx]
    return start_sample + start, start_sample + start + clip_size - 1


class EpicSoundsDataset:
    """EPIC-SOUNDS records over an audio store (train, val or test split).

    ``records``: ``EpicSoundsRecord``s, or mappings that become them;
    ``audio``: any mapping ``video_id -> 1-D samples`` at the config's rate.
    """

    def __init__(self, records: Sequence, audio: Mapping, cfg: EpicAudioConfig,
                 split: str = "train"):
        self.records = [r if isinstance(r, EpicSoundsRecord)
                        else EpicSoundsRecord(r, cfg.sampling_rate) for r in records]
        self.audio = audio
        self.cfg = cfg
        self.split = split

    @classmethod
    def from_files(cls, annotations_pkl: str, hdf5_path: str, cfg: EpicAudioConfig,
                   split: str = "train") -> "EpicSoundsDataset":
        """The reference's files: a pandas pickle of annotation rows and an
        HDF5 store with one dataset of samples per video."""
        try:
            import h5py
            import pandas as pd
        except ImportError as e:
            raise ImportError(
                "EpicSoundsDataset.from_files reads a pandas pickle and an HDF5 file and needs "
                "pandas and h5py; without them, build EpicSoundsDataset from records and a "
                "mapping video_id -> samples") from e
        df = pd.read_pickle(annotations_pkl)
        return cls([row for _, row in df.iterrows()], h5py.File(hdf5_path, "r"), cfg, split)

    def __len__(self):
        n = len(self.records)
        if self.split == "test":
            return n * self.cfg.num_ensemble_views
        return n

    def span(self, index: int, rng: np.random.Generator) -> tuple[int, int, int]:
        """(record index, first sample, end sample) of dataset item ``index``;
        a train or val window draws its start from ``rng``."""
        cfg = self.cfg
        if self.split == "test":
            rec_idx = index // cfg.num_ensemble_views
            clip_idx = index % cfg.num_ensemble_views
        else:
            rec_idx, clip_idx = index, -1
        rec = self.records[rec_idx]
        if rec.num_audio_samples < cfg.clip_samples:
            return rec_idx, rec.start_audio_sample, rec.end_audio_sample
        s, e = get_start_end_idx(rec.num_audio_samples, cfg.clip_samples, clip_idx,
                                 cfg.num_ensemble_views, rec.start_audio_sample, rng)
        return rec_idx, int(s), int(e)

    def read(self, span: tuple[int, int, int]):
        """-> (wave (clip_samples,) fp32, n_frames, one-hot label, record index)."""
        cfg = self.cfg
        rec_idx, start, end = span
        rec = self.records[rec_idx]
        wave = np.asarray(self.audio[rec.video_id][start:end], dtype=np.float32)
        n_frames = min(1 + len(wave) // cfg.hop_samples, cfg.num_frames)
        clip = cfg.clip_samples
        wave = np.pad(wave, (0, clip - len(wave))) if len(wave) < clip else wave[:clip]
        y = np.zeros(cfg.num_classes, np.float32)
        y[rec.label] = 1.0
        return wave, n_frames, y, rec_idx

    def sample(self, index: int, rng: np.random.Generator):
        """-> (wave (clip_samples,), n_frames, one-hot label, record index)."""
        return self.read(self.span(index, rng))


def draw_epic_featurize(generator: torch.Generator, cfg: EpicAudioConfig, train: bool,
                        shape: tuple, t_mask: Optional[int] = None,
                        t_warp: Optional[int] = None) -> dict:
    """The random values of one featurized (B, T, F) batch: in training the
    'augment' draws of ``combined_transforms`` with cfg's masks and warp (or
    the given time mask and warp), else none."""
    if not train:
        return {}
    return {"augment": draw_combined(generator, shape,
                                     cfg.t_mask if t_mask is None else t_mask, cfg.f_mask,
                                     cfg.t_warp if t_warp is None else t_warp)}


def make_epic_featurize(cfg: EpicAudioConfig, train: bool, num_frames: Optional[int] = None):
    """The device frontend: (waves (B, S), n_frames (B,), labels (B, C),
    draws) -> {'x': (B, num_frames, F), 'y': labels}: log-mel, crop to
    ``num_frames`` (cfg's by default; only those frames are computed),
    edge-pad past each clip's frame count, (train) the ``draws['augment']``
    transforms, normalize. ``draws`` come from ``draw_epic_featurize``."""
    t = cfg.num_frames if num_frames is None else num_frames

    def featurize(waves, n_frames, labels, draws: dict):
        fb = stft_log_mel(waves, sr=cfg.sampling_rate, n_fft=N_FFT,
                          window_ms=cfg.window_length_ms, hop_ms=cfg.hop_length_ms,
                          n_mels=cfg.num_frequencies, max_frames=t)
        pos = torch.arange(fb.shape[1], device=fb.device)[None]
        idx = torch.minimum(pos, n_frames[:, None] - 1)
        fb = torch.gather(fb, 1, idx[:, :, None].expand(-1, -1, fb.shape[2]))
        if train:
            fb = apply_combined(fb, draws["augment"])
        return {"x": normalize(fb, cfg.mean, cfg.std), "y": labels}

    return featurize


@dataclasses.dataclass
class EpicBatchPipeline:
    """Epoch iterator of featurized EPIC batches on ``device`` (CUDA unless
    the caller names another), each with its clips' 'record_index' (numpy)
    for the test split's view averaging."""

    dataset: EpicSoundsDataset
    batch_size: int
    train: bool = True
    seed: int = 0
    num_workers: int = 8
    device: Optional[str | torch.device] = None
    n_data: int = 1
    data_rank: int = 0

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.featurize = make_epic_featurize(self.dataset.cfg, self.train)

    def steps_per_epoch(self) -> int:
        n = len(self.dataset) // self.n_data
        if self.train:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def epoch_order(self, epoch: int) -> tuple[np.ndarray, np.random.Generator]:
        """The epoch's item order and the generator its windows draw from."""
        rng = np.random.default_rng(self.seed + epoch)
        n = len(self.dataset)
        order = rng.permutation(n) if self.train else np.arange(n)
        return order[self.data_rank::self.n_data], rng

    def generator(self, epoch: int) -> torch.Generator:
        return epoch_generator(self.device, self.seed, epoch)

    def host_batch(self, idxs, rng: np.random.Generator, pool: cf.Executor):
        """(waves (B, clip_samples), n_frames (B,) int64, labels (B, C),
        record_index (B,) int32): the windows drawn in order, read on
        ``pool``'s threads."""
        spans = [self.dataset.span(int(i), rng) for i in idxs]
        samples = list(pool.map(self.dataset.read, spans))
        return (np.stack([s[0] for s in samples]), np.array([s[1] for s in samples], np.int64),
                np.stack([s[2] for s in samples]), np.array([s[3] for s in samples], np.int32))

    def batches(self, epoch: int = 0) -> Iterator[dict]:
        order, rng = self.epoch_order(epoch)
        gen = self.generator(epoch)
        cfg = self.dataset.cfg
        bs = self.batch_size
        last = self.steps_per_epoch() * bs if self.train else len(order)
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            for start in range(0, last, bs):
                idxs = order[start:start + bs]
                if len(idxs) < bs and self.train:
                    break
                waves, n_frames, labels, rec = self.host_batch(idxs, rng, pool)
                waves, n_frames, labels = to_device(self.device, waves, n_frames, labels)
                draws = draw_epic_featurize(
                    gen, cfg, self.train, (len(idxs), cfg.num_frames, cfg.num_frequencies))
                yield {**self.featurize(waves, n_frames, labels, draws), "record_index": rec}


@dataclasses.dataclass
class EpicFlexiBatchPipeline:
    """Variable-length EPIC pipeline (the reference's flexi path): each record
    takes its whole segment (at most 3 clips long); its spectrogram length is
    rounded up to a multiple of 16 frames, clamped to [min_audio_length,
    num_frames], and edge-padded or cropped to it. Records are bucketed by
    that length, so each bucket is one fixed-shape batch; in training the
    time mask and warp scale with it (T_MASK * len // 1024, at least 1, and
    T_WARP * len // 1024)."""

    dataset: EpicSoundsDataset
    batch_size: int
    train: bool = True
    seed: int = 0
    num_workers: int = 4
    min_audio_length: int = 0
    device: Optional[str | torch.device] = None
    n_data: int = 1
    data_rank: int = 0

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._featurizers = {}

    def target_length(self, n_frames: int) -> int:
        cfg = self.dataset.cfg
        tgt = n_frames + 16 - (n_frames % 16)
        if tgt > cfg.num_frames:
            tgt = cfg.num_frames
        elif self.min_audio_length and tgt < self.min_audio_length:
            tgt = self.min_audio_length
        return tgt

    def featurize_for(self, tgt: int):
        if tgt not in self._featurizers:
            self._featurizers[tgt] = make_epic_featurize(self.dataset.cfg, self.train, tgt)
        return self._featurizers[tgt]

    def draws_for(self, generator: torch.Generator, tgt: int, batch: int) -> dict:
        cfg = self.dataset.cfg
        return draw_epic_featurize(generator, cfg, self.train, (batch, tgt, cfg.num_frequencies),
                                   t_mask=max(cfg.t_mask * tgt // 1024, 1),
                                   t_warp=cfg.t_warp * tgt // 1024)

    def fetch(self, i: int):
        """(whole segment, capped at 3 clips; n_frames; one-hot label)."""
        cfg = self.dataset.cfg
        rec = self.dataset.records[int(i)]
        wave = np.asarray(self.dataset.audio[rec.video_id]
                          [rec.start_audio_sample:rec.end_audio_sample], dtype=np.float32)
        wave = wave[:cfg.clip_samples * 3]
        n_frames = min(1 + len(wave) // cfg.hop_samples, cfg.num_frames)
        y = np.zeros(cfg.num_classes, np.float32)
        y[rec.label] = 1.0
        return wave, n_frames, y

    def _fetch_epoch(self, epoch: int) -> list[tuple[int, tuple]]:
        """The epoch's (record index, ``fetch``) pairs in its order."""
        n = len(self.dataset.records)
        order = np.random.default_rng(self.seed + epoch).permutation(n) if self.train \
            else np.arange(n)
        order = order[self.data_rank::self.n_data]
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            return list(zip(order.tolist(), pool.map(self.fetch, order)))

    @staticmethod
    def _bucket(fetched, target_length) -> list[tuple[int, list]]:
        buckets = {}
        for item in fetched:
            buckets.setdefault(target_length(item[1][1]), []).append(item)
        return sorted(buckets.items())

    def plan(self, epoch: int = 0) -> list[tuple[int, list[int]]]:
        """The epoch's buckets in order: (target length, record indices in
        the epoch's order)."""
        return [(tgt, [i for i, _ in items])
                for tgt, items in self._bucket(self._fetch_epoch(epoch), self.target_length)]

    def batches(self, epoch: int = 0) -> Iterator[dict]:
        cfg = self.dataset.cfg
        gen = epoch_generator(self.device, self.seed, epoch, 1)
        for tgt, items in self._bucket(self._fetch_epoch(epoch), self.target_length):
            feat = self.featurize_for(tgt)
            wave_len = (tgt - 1) * cfg.hop_samples + 1
            for start in range(0, len(items), self.batch_size):
                chunk = items[start:start + self.batch_size]
                waves = np.zeros((len(chunk), wave_len), np.float32)
                for j, (_, (w, _, _)) in enumerate(chunk):
                    m = min(len(w), wave_len)
                    waves[j, :m] = w[:m]
                n_frames = np.array([min(s[1], tgt) for _, s in chunk], np.int64)
                labels = np.stack([s[2] for _, s in chunk])
                waves, n_frames, labels = to_device(self.device, waves, n_frames, labels)
                batch = feat(waves, n_frames, labels, self.draws_for(gen, tgt, len(chunk)))
                yield {**batch, "record_index": np.array([i for i, _ in chunk], np.int32)}
