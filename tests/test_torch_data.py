"""The PyTorch port's data pipeline (``aum_tpu_torch.data``) against the JAX package's, on the CPU.

- ``load_wav`` on PCM 8/16/24/32-bit files against ``aum_tpu``'s, and on an
  IEEE-float file against the samples written;
- ``AudioJsonDataset.waveform`` (pad, crop, the true frame count,
  ``rev_audio``) against ``aum_tpu``'s;
- ``balanced_sample_weights`` and the epoch orders of ``BatchPipeline``
  (weighted, shuffled, in order), which must be equal index for index;
- ``make_featurize`` at ``train=False``, and at ``train=True`` on the values
  the JAX featurizer draws (mixup with a partner pool, SpecAugment, noise
  and roll), at ``target_length`` 128;
- the native batch decoder (built here from ``csrc/wavloader.cpp``) against
  the Python decoder, its per-clip fallback, and the pipeline's batches with
  and without it;
- ``Prefetcher``'s order and its error propagation.

Audio is drawn with numpy from fixed seeds and written as WAV files. torch is
imported inside the tests, as in the other port test modules.
"""

import json
import struct
import wave as wave_mod

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from aum_tpu.data import AudioConf as JaxAudioConf
from aum_tpu.data import AudioJsonDataset as JaxDataset
from aum_tpu.data import BatchPipeline as JaxPipeline
from aum_tpu.data import balanced_sample_weights as jax_balanced_weights
from aum_tpu.data import load_wav as jax_load_wav
from aum_tpu.data.pipeline import make_featurize as jax_make_featurize
from test_torch_augment import jax_mixup_draws, jax_noise_draws, jax_spec_augment_draws

CONF = dict(target_length=128, mean=-5.0, std=4.0)
# target_samples at target_length 128: 127 * 160 + 400.
TARGET_SAMPLES = 20720


def write_pcm(path, wave, width=2, sr=16000):
    """PCM WAV of ``width`` bytes per sample (8-bit unsigned, else signed)."""
    q = np.clip(wave, -1.0, 1.0 - 2.0 ** -23)
    if width == 1:
        raw = (np.round(q * 127.0) + 128).astype(np.uint8).tobytes()
    elif width == 3:
        v = np.round(q * 8388607.0).astype(np.int32)
        raw = np.stack([v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF], -1).astype(np.uint8).tobytes()
    else:
        raw = np.round(q * (2.0 ** (8 * width - 1) - 1)).astype(f"<i{width}").tobytes()
    with wave_mod.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(raw)


def write_float(path, wave, sr=16000):
    data = np.asarray(wave, "<f4").tobytes()
    fmt = struct.pack("<HHIIHH", 3, 1, sr, sr * 4, 4, 32)
    body = b"fmt " + struct.pack("<I", 16) + fmt + b"data" + struct.pack("<I", len(data)) + data
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body)


def _clip(seed, n):
    return (0.2 * np.random.default_rng(seed).standard_normal(n) + 0.03).astype(np.float32)


@pytest.mark.parametrize("width", [1, 2, 3, 4], ids=["pcm8", "pcm16", "pcm24", "pcm32"])
def test_load_wav_matches_jax(tmp_path, width):
    from aum_tpu_torch.data import load_wav

    path = str(tmp_path / "x.wav")
    write_pcm(path, _clip(width, 3001), width)
    got, sr = load_wav(path)
    want, want_sr = jax_load_wav(path)
    assert sr == want_sr == 16000 and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_load_wav_float32(tmp_path):
    from aum_tpu_torch.data import load_wav

    path = str(tmp_path / "f.wav")
    wave = _clip(9, 2501)
    write_float(path, wave, sr=22050)
    got, sr = load_wav(path)
    assert sr == 22050
    np.testing.assert_array_equal(got, wave)


def _write_dataset(tmp_path, lengths, labels_of=lambda i: f"/m/{i % 3}", n_classes=3):
    entries = []
    for i, n in enumerate(lengths):
        path = str(tmp_path / f"clip{i}.wav")
        write_pcm(path, _clip(100 + i, n))
        entries.append({"wav": path, "labels": labels_of(i)})
    datafile = tmp_path / "data.json"
    datafile.write_text(json.dumps({"data": entries}))
    label_csv = tmp_path / "labels.csv"
    label_csv.write_text("index,mid,display_name\n" + "\n".join(
        f"{i},/m/{i},class{i}" for i in range(n_classes)))
    return str(datafile), str(label_csv)


# Under one frame, a few frames, exactly the target, past it.
LENGTHS = (300, 8000, 13337, TARGET_SAMPLES, 30000)


@pytest.mark.parametrize("rev_audio", [False, True], ids=["forward", "reversed"])
def test_dataset_waveform_matches_jax(tmp_path, rev_audio):
    from aum_tpu_torch.data import AudioConf, AudioJsonDataset

    datafile, label_csv = _write_dataset(tmp_path, LENGTHS)
    port = AudioJsonDataset(datafile, AudioConf(**CONF), label_csv, rev_audio=rev_audio)
    ref = JaxDataset(datafile, JaxAudioConf(**CONF), label_csv, rev_audio=rev_audio)
    assert port.conf.target_samples == TARGET_SAMPLES
    frames = []
    for i in range(len(LENGTHS)):
        wave, n_frames = port.waveform(i)
        want, want_frames = ref.waveform(i)
        assert wave.shape == (TARGET_SAMPLES,) and n_frames == want_frames
        np.testing.assert_array_equal(wave, want)
        np.testing.assert_array_equal(port.labels(i), ref.labels(i))
        frames.append(n_frames)
    assert frames == [0, 48, 81, 128, 128]


def test_balanced_weights_and_epoch_orders_match_jax(tmp_path):
    from aum_tpu_torch.data import AudioConf, AudioJsonDataset, BatchPipeline, \
        balanced_sample_weights

    labels = ["/m/0", "/m/0,/m/1", "/m/2", "/m/0", "/m/1,/m/2", "/m/0", "/m/0", "/m/2",
              "/m/0", "/m/1"]
    datafile, label_csv = _write_dataset(tmp_path, [500] * len(labels), lambda i: labels[i])
    port = AudioJsonDataset(datafile, AudioConf(**CONF), label_csv)
    ref = JaxDataset(datafile, JaxAudioConf(**CONF), label_csv)
    weights = balanced_sample_weights(port)
    np.testing.assert_array_equal(weights, jax_balanced_weights(ref))
    for train, w in [(True, weights), (True, None), (False, None)]:
        pp = BatchPipeline(port, 4, train=train, weights=w, seed=17, device="cpu",
                           use_native=False)
        jp = JaxPipeline(ref, 4, train=train, weights=w, seed=17, use_native=False)
        assert pp.steps_per_epoch() == jp.steps_per_epoch()
        for epoch in (0, 1, 2):
            np.testing.assert_array_equal(pp._epoch_order(epoch), jp._epoch_order(epoch))


def _featurize_inputs(tmp_path):
    from aum_tpu_torch.data import AudioConf, AudioJsonDataset

    datafile, label_csv = _write_dataset(tmp_path, (8000, 13337, TARGET_SAMPLES, 30000, 500, 9000))
    ds = AudioJsonDataset(datafile, AudioConf(**CONF), label_csv)
    waves, frames = zip(*(ds.waveform(i) for i in range(6)))
    labels = np.stack([ds.labels(i) for i in range(6)])
    return np.stack(waves), np.array(frames, np.int32), labels


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_featurize_matches_jax(tmp_path, train):
    import torch

    from aum_tpu_torch.data import AudioConf, make_featurize

    aug = dict(mixup=0.6, freqm=24, timem=40, noise=True)
    waves, frames, labels = _featurize_inputs(tmp_path)
    # Four clips, the other two the previous batch: the mixup partner pool.
    w, n, y, pw, py = waves[:4], frames[:4], labels[:4], waves[4:], labels[4:]
    key = jax.random.PRNGKey(5)
    jfeat = jax_make_featurize(JaxAudioConf(**CONF, **aug), train)
    want = jfeat(key, jnp.asarray(w), jnp.asarray(n), jnp.asarray(y), jnp.asarray(pw),
                 jnp.asarray(py))
    draws = {}
    if train:  # the featurizer's splits: mixup, then SpecAugment, then noise
        key, k_mix = jax.random.split(key)
        draws["mixup"] = jax_mixup_draws(k_mix, 4, 6)
        key, k_aug = jax.random.split(key)
        draws["spec_augment"] = jax_spec_augment_draws(k_aug, (4, 128, 128), 24, 40)
        key, k_noise = jax.random.split(key)
        draws["noise"] = jax_noise_draws(k_noise, (4, 128, 128))
    t = torch.from_numpy
    got = make_featurize(AudioConf(**CONF, **aug), train)(t(w), t(n).long(), t(y), draws, t(pw),
                                                          t(py))
    assert tuple(got["x"].shape) == (4, 128, 128) and got["x"].dtype == torch.float32
    # The fbank's bound in tests/test_torch_frontend.py (1e-4 on log-mels,
    # fp32, sums in other orders), here after the normalization's 1 / (2 std).
    np.testing.assert_allclose(got["x"].numpy(), np.asarray(want["x"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["y"].numpy(), np.asarray(want["y"]), rtol=0, atol=1e-6)
    if not train:  # frames past a clip's length are the normalized 0
        pad = (0.0 - CONF["mean"]) / (2 * CONF["std"])
        assert np.all(got["x"][0, 48:].numpy() == np.float32(pad))


def test_native_wav_batch_matches_python_decoder(tmp_path):
    from aum_tpu_torch.data import AudioConf, AudioJsonDataset
    from aum_tpu_torch.data.native import decode_wav_batch, native_available

    assert native_available()
    lengths = (300, 8000, 13337, TARGET_SAMPLES)
    datafile, label_csv = _write_dataset(tmp_path, lengths)
    ds = AudioJsonDataset(datafile, AudioConf(**CONF), label_csv)
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFF0000WAVEjunk")
    paths = [d["wav"] for d in ds.data] + [str(bad)]
    waves, n_samples, rates, statuses = decode_wav_batch(paths, TARGET_SAMPLES, threads=3)
    assert list(statuses[:4]) == [0] * 4 and statuses[4] != 0
    assert list(n_samples[:4]) == list(lengths) and list(rates[:4]) == [16000] * 4
    for i in range(4):
        want, n_frames = ds.waveform(i)
        # The same mean over the same samples, summed in fp64 (C++) and in
        # fp32 pairs (numpy): a few fp32 ulps of the mean.
        np.testing.assert_allclose(waves[i], want, rtol=0, atol=1e-7)
        assert ds.conf.n_frames(n_samples[i]) == n_frames


def test_pipeline_batches_native_and_python_agree(tmp_path):
    import torch

    from aum_tpu_torch.data import AudioConf, AudioJsonDataset, BatchPipeline

    datafile, label_csv = _write_dataset(tmp_path, (8000, 13337, TARGET_SAMPLES, 500, 9000))
    data = json.loads(open(datafile).read())
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFF0000WAVEjunk")
    data["data"].insert(2, {"wav": str(bad), "labels": "/m/1"})
    with open(datafile, "w") as f:
        json.dump(data, f)
    ds = AudioJsonDataset(datafile, AudioConf(**CONF), label_csv)
    out = {}
    for native in (True, False):
        pipe = BatchPipeline(ds, 4, train=False, seed=3, num_workers=2, device="cpu",
                             use_native=native)
        out[native] = list(pipe.batches())
    assert [tuple(b["x"].shape) for b in out[True]] == [(4, 128, 128), (2, 128, 128)]
    for a, b in zip(out[True], out[False]):
        # The decoders' means differ by a few fp32 ulps (see above).
        np.testing.assert_allclose(a["x"].numpy(), b["x"].numpy(), rtol=1e-4, atol=1e-4)
        assert torch.equal(a["y"], b["y"])
    # The clip that does not decode is replaced by another clip of the set.
    replaced = out[True][0]["x"][2]
    assert not torch.equal(replaced, out[True][0]["x"][1])


def test_prefetcher_keeps_order_and_raises_the_iterators_error():
    from aum_tpu_torch.data import Prefetcher

    def items():
        yield from range(5)
        raise ValueError("decode failed")

    got = []
    with pytest.raises(ValueError, match="decode failed"):
        for item in Prefetcher(items(), depth=2):
            got.append(item)
    assert got == [0, 1, 2, 3, 4]
    assert list(Prefetcher(iter(range(7)))) == list(range(7))
