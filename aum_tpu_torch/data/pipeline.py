"""Host-to-device batch pipeline with the feature extraction on the device.

Counterpart of ``aum_tpu/data/pipeline.py``. The host decodes waveforms
(the native batch decoder, or a pool of Python threads) into fixed-shape
numpy batches; each batch is copied to the device from pinned memory, and
``make_featurize``'s function runs the whole frontend there, in the
reference's order: mixup -> fbank -> zero the frames past each clip's
length -> SpecAugment -> normalize -> noise and roll. ``Prefetcher`` runs
that in a background thread, one or two batches ahead of the train step.

Also the balanced-sampling weights (weight = sum over a clip's labels of
1000 / (count + 0.01)) and the weighted sampler with replacement.

Randomness: the epoch's order and the decode retries come from numpy
generators seeded as in the JAX package, so the order is the same index for
index; the featurizer draws from a per-epoch ``torch.Generator`` on the
batch's device, seeded from ``np.random.default_rng([seed, epoch])``.

Under data parallelism (``n_data`` > 1) each rank reads
``order[data_rank::n_data]``, JAX's per-process slice taken by the rank's
'data' coordinate, not its global rank: the ranks of one 'model', 'seq' or
'pipe' group read the same batches. ``steps_per_epoch`` divides by
``n_data``, and a train epoch stops there on every rank, so the ranks step
together.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from aum_tpu_torch.audio import FbankConfig, fbank, normalize
from aum_tpu_torch.audio.augment import (
    apply_mixup,
    apply_noise_and_roll,
    apply_spec_augment,
    draw_augment,
    draw_mixup,
)
from aum_tpu_torch.data.datasets import AudioConf, AudioJsonDataset
from aum_tpu_torch.utils import resolve_device


def balanced_sample_weights(dataset: AudioJsonDataset) -> np.ndarray:
    """Per-sample weights for class-balanced sampling."""
    counts = np.zeros(dataset.label_num, dtype=np.float64)
    label_idx = []
    for datum in dataset.data:
        idxs = [dataset.index_dict[s] for s in datum["labels"].split(",")]
        label_idx.append(idxs)
        for i in idxs:
            counts[i] += 1
    return np.array([sum(1000.0 / (counts[i] + 0.01) for i in idxs) for idxs in label_idx])


def to_device(device: torch.device, *arrays: np.ndarray) -> list[torch.Tensor]:
    """Copy host arrays to ``device``. On CUDA each goes through a fresh
    pinned buffer and an asynchronous copy; the caching host allocator
    reuses a pinned block only after the copy that read it has run."""
    if device.type != "cuda":
        return [torch.from_numpy(a).to(device) for a in arrays]
    return [torch.from_numpy(a).pin_memory().to(device, non_blocking=True) for a in arrays]


def epoch_generator(device: torch.device, *seed_words: int) -> torch.Generator:
    """A featurizer's generator on ``device``, seeded from
    ``np.random.default_rng(list(seed_words))``, as the JAX pipelines seed
    their epoch's PRNG key."""
    seed = int(np.random.default_rng(list(seed_words)).integers(2**31))
    return torch.Generator(device).manual_seed(seed)


def draw_featurize(generator: torch.Generator, conf: AudioConf, train: bool, batch: int,
                   pool: int) -> dict:
    """The random values of one featurized batch: 'mixup' (partners from a
    pool of ``pool`` clips), 'spec_augment' and 'noise', each only where
    ``conf`` turns it on for a train batch."""
    if not train:
        return {}
    draws = {"mixup": draw_mixup(generator, batch, pool)} if conf.mixup > 0 else {}
    shape = (batch, conf.target_length, conf.num_mel_bins)
    return {**draws, **draw_augment(generator, shape, conf.freqm, conf.timem, conf.noise)}


def make_featurize(conf: AudioConf, train: bool):
    """The device frontend: (waves (B, S), n_frames (B,), labels (B, C),
    draws, partner waves and labels or None) -> {'x': (B, T, M), 'y': labels},
    on the waves' device. ``draws`` come from ``draw_featurize``."""
    fb_cfg = FbankConfig(sample_frequency=conf.sample_frequency, frame_shift_ms=conf.fshift,
                         num_mel_bins=conf.num_mel_bins)

    def featurize(waves, n_frames, labels, draws: dict, p_waves=None, p_labels=None):
        if train and conf.mixup > 0:
            waves, labels = apply_mixup(waves, labels, draws["mixup"], conf.mixup,
                                        p_waves, p_labels)
        fb = fbank(waves, fb_cfg)  # (B, T, M)
        # Zero the frames past each clip's true frame count: the reference
        # zero-pads the fbank, not the waveform.
        mask = torch.arange(fb.shape[1], device=fb.device)[None] < n_frames[:, None]
        fb = fb.masked_fill(~mask[:, :, None], 0.0)
        if train and (conf.freqm or conf.timem):
            fb = apply_spec_augment(fb, draws["spec_augment"])
        if not conf.skip_norm:
            fb = normalize(fb, conf.mean, conf.std)
        if train and conf.noise:
            fb = apply_noise_and_roll(fb, draws["noise"])
        return {"x": fb, "y": labels}

    return featurize


@dataclasses.dataclass
class BatchPipeline:
    """Epoch iterator of featurized batches on ``device`` (CUDA unless the
    caller names another; see ``utils.resolve_device``)."""

    dataset: AudioJsonDataset
    batch_size: int
    train: bool = True
    weights: Optional[np.ndarray] = None  # balanced sampling (with replacement)
    seed: int = 0
    num_workers: int = 8
    drop_last: Optional[bool] = None
    use_native: bool = True
    device: Optional[str | torch.device] = None
    n_data: int = 1
    data_rank: int = 0

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.featurize = make_featurize(self.dataset.conf, self.train)
        self._drop_last = self.train if self.drop_last is None else self.drop_last
        # The native decoders cover batches on the default decoder without
        # reversal: all-WAV batches the WAV decoder (built here, so a failed
        # build raises now), any other batch the ffmpeg-backed one (built at
        # its first such batch).
        self._native = (self.use_native and self.dataset.decoder_is_default
                        and not self.dataset.rev_audio)
        if self._native:
            from aum_tpu_torch.data.native import native_available

            native_available()

    def steps_per_epoch(self) -> int:
        n = len(self.dataset) // self.n_data
        if self._drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_order(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed + epoch)
        n = len(self.dataset)
        if not self.train:
            order = np.arange(n)
        elif self.weights is not None:
            order = rng.choice(n, size=n, replace=True, p=self.weights / self.weights.sum())
        else:
            order = rng.permutation(n)
        return order[self.data_rank::self.n_data]

    def generator(self, epoch: int) -> torch.Generator:
        """The featurizer's generator for ``epoch``, on the device."""
        return epoch_generator(self.device, self.seed, epoch)

    def host_batch(self, idxs, rng: np.random.Generator, pool: cf.Executor
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(waves (B, S) float32, n_frames (B,) int64, labels (B, C) float32)
        of the clips ``idxs``: the native batch decode (the WAV decoder for
        all-WAV batches, the ffmpeg-backed one for any other), falling back
        to ``dataset.sample`` (with its retries) per failed clip; else
        ``dataset.sample`` on ``pool``'s threads."""
        conf = self.dataset.conf
        paths = [self.dataset.data[int(i)]["wav"] for i in idxs]
        if self._native:
            from aum_tpu_torch.data.native import decode_audio_batch, decode_wav_batch

            all_wav = all(p.lower().endswith(".wav") for p in paths)
            decode = decode_wav_batch if all_wav else decode_audio_batch
            waves, n_samples, _, statuses = decode(
                paths, conf.target_samples, threads=self.num_workers)
            n_frames = conf.n_frames(n_samples).astype(np.int64)
            labels = np.stack([self.dataset.labels(int(i)) for i in idxs])
            for j in np.flatnonzero(statuses):
                waves[j], n_frames[j], labels[j] = self.dataset.sample(int(idxs[j]), rng)
            return waves, n_frames, labels
        samples = list(pool.map(lambda i: self.dataset.sample(int(i), rng), idxs))
        return (np.stack([s[0] for s in samples]),
                np.array([s[1] for s in samples], np.int64),
                np.stack([s[2] for s in samples]))

    def batches(self, epoch: int = 0) -> Iterator[dict]:
        conf = self.dataset.conf
        order = self._epoch_order(epoch)
        rng = np.random.default_rng(self.seed * 7919 + epoch)
        gen = self.generator(epoch)
        bs = self.batch_size
        # The previous batch is an extra pool of mixup partners, at no
        # decode cost (see audio/augment.py).
        use_partners = self.train and conf.mixup > 0
        prev = None
        last = self.steps_per_epoch() * bs if self._drop_last else len(order)
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            for start in range(0, last, bs):
                idxs = order[start:start + bs]
                if len(idxs) < bs and self._drop_last:
                    break
                waves, n_frames, labels = to_device(self.device,
                                                    *self.host_batch(idxs, rng, pool))
                partners = (prev if use_partners and prev is not None
                            and prev[0].shape == waves.shape else (None, None))
                pool_size = len(idxs) + (0 if partners[0] is None else len(partners[0]))
                draws = draw_featurize(gen, conf, self.train, len(idxs), pool_size)
                yield self.featurize(waves, n_frames, labels, draws, *partners)
                if use_partners:
                    prev = (waves, labels)


class Prefetcher:
    """Background-thread batch prefetcher (depth-N buffering).

    The next host batch is decoded and its featurization enqueued on the
    device while the consumer runs on the current one. Wrap any batch
    iterator: ``for b in Prefetcher(pipe.batches(epoch)): ...``. An
    exception in the iterator is raised in the consumer.
    """

    def __init__(self, iterator, depth: int = 2):
        self._q = queue.Queue(maxsize=depth)
        self._sentinel = object()
        self._err = None

        def worker():
            try:
                for item in iterator:
                    self._q.put(item)
            except BaseException as e:  # propagated into the consumer
                self._err = e
            finally:
                self._q.put(self._sentinel)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._sentinel:
                if self._err is not None:
                    raise self._err
                return
            yield item
