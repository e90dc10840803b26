"""The PyTorch port's ffmpeg-backed decoder (``aum_tpu_torch.data.native``) against the JAX package's, on the CPU.

- the port's build of ``csrc/audiodecode.cpp`` (into ``build/aum_tpu_torch/``)
  decodes flac and m4a (aac) fixtures, one file and in batches, bit-equal to
  ``aum_tpu.data.native.decode_audio`` and ``decode_audio_batch``;
- ``AudioJsonDataset`` on flac and m4a files against ``aum_tpu``'s, and the
  pipeline's batch decode of a batch that is not all WAV;
- without the ffmpeg headers the decoder raises, and the dataset does not
  retry that;
- the slice as a whole: ``run.main(["--device", "cpu", ...])`` trains a
  depth-2 recipe from flac files with ``--set flexible_patch_sizes=8,16``.

The fixtures are written by the library's own ``aum_test_encode``. torch is
imported inside the tests, as in the other port test modules.
"""

import json

import numpy as np
import pytest

from aum_tpu.data import AudioConf as JaxAudioConf
from aum_tpu.data import AudioJsonDataset as JaxDataset
from aum_tpu.data import native as jnative

SR = 16000
CONF = dict(target_length=64, mean=-5.0, std=4.0)
# target_samples at target_length 64: 63 * 160 + 400.
TARGET_SAMPLES = 10480


def _clip(seed, n):
    return (0.2 * np.random.default_rng(seed).standard_normal(n) + 0.03).astype(np.float32)


def _write(path, seed, n):
    """A flac or m4a fixture of ``n`` samples, by the path's extension."""
    from aum_tpu_torch.data.native import encode_test_audio

    encode_test_audio(str(path), "flac" if str(path).endswith(".flac") else "aac",
                      _clip(seed, n), SR)
    return str(path)


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    root = tmp_path_factory.mktemp("decode")
    # Longer and shorter than TARGET_SAMPLES.
    return [_write(root / name, i, n) for i, (name, n) in enumerate(
        [("a.flac", 16000), ("b.m4a", 12000), ("c.flac", 7000), ("d.m4a", 5000)])]


def test_decoder_matches_jax_library(fixtures):
    from aum_tpu_torch.data import native

    assert native.audio_decoder_available() and jnative.audio_decoder_available()
    assert native.audio_library_path().exists()
    for path in fixtures:
        got, want = native.decode_audio(path, TARGET_SAMPLES), jnative.decode_audio(
            path, TARGET_SAMPLES)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:] and got[2] == SR
    for threads in (1, 3):
        got = native.decode_audio_batch(fixtures + ["missing.flac"], TARGET_SAMPLES, threads)
        want = jnative.decode_audio_batch(fixtures + ["missing.flac"], TARGET_SAMPLES, threads)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert (got[3][:-1] == 0).all() and got[3][-1] != 0
    # flac is lossless up to its 16-bit quantisation.
    ref = _clip(0, 16000)[:TARGET_SAMPLES]
    wave = native.decode_audio(fixtures[0], TARGET_SAMPLES)[0]
    np.testing.assert_allclose(wave, ref - ref.mean(), atol=2e-4)
    with pytest.raises(RuntimeError, match="decode failed"):
        native.decode_audio("missing.flac", TARGET_SAMPLES)


def _manifest(tmp_path, paths):
    entries = [{"wav": p, "labels": f"/m/{i % 2}"} for i, p in enumerate(paths)]
    data = tmp_path / "data.json"
    data.write_text(json.dumps({"data": entries}))
    labels = tmp_path / "labels.csv"
    labels.write_text("index,mid,display_name\n0,/m/0,a\n1,/m/1,b\n")
    return str(data), str(labels)


def test_dataset_and_pipeline_decode_compressed_files(fixtures, tmp_path):
    from aum_tpu_torch.data import AudioConf, AudioJsonDataset, BatchPipeline

    wav = tmp_path / "e.wav"
    _write_wav(wav, _clip(9, 9000))
    data, labels = _manifest(tmp_path, fixtures + [str(wav)])
    ds = AudioJsonDataset(data, AudioConf(**CONF), labels)
    jds = JaxDataset(data, JaxAudioConf(**CONF), labels)
    for i in range(len(fixtures) + 1):
        (w, n), (jw, jn) = ds.waveform(i), jds.waveform(i)
        np.testing.assert_array_equal(w, jw)
        assert n == jn
    pipe = BatchPipeline(ds, batch_size=5, train=False, num_workers=2, device="cpu")
    rng = np.random.default_rng(0)
    import concurrent.futures as cf

    with cf.ThreadPoolExecutor(2) as pool:
        waves, n_frames, y = pipe.host_batch(np.arange(5), rng, pool)
    # The native batch decode of the mixed batch, clip for clip the dataset's.
    for i in range(5):
        w, n = ds.waveform(i)
        np.testing.assert_allclose(waves[i], w, atol=1e-6)
        assert n_frames[i] == n
        np.testing.assert_array_equal(y[i], ds.labels(i))
    batch = next(iter(pipe.batches(0)))
    assert tuple(batch["x"].shape) == (5, 64, 128) and bool(batch["x"].isfinite().all())


def _write_wav(path, wave):
    import wave as wave_mod

    with wave_mod.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(np.round(np.clip(wave, -1, 1) * 32767).astype("<i2").tobytes())


def test_missing_headers_raise_and_are_not_retried(fixtures, tmp_path, monkeypatch):
    from aum_tpu_torch.data import AudioConf, AudioJsonDataset, native

    # A file that fails to decode is retried with another clip.
    data, labels = _manifest(tmp_path, [str(tmp_path / "missing.flac")] + fixtures)
    ds = AudioJsonDataset(data, AudioConf(**CONF), labels)
    wave, n_frames, _ = ds.sample(0, np.random.default_rng(0))
    assert n_frames > 0 and np.isfinite(wave).all()
    # A decoder that cannot be built raises at once.
    monkeypatch.setattr(native, "av_headers", lambda: None)
    monkeypatch.setattr(native, "audio_library_path", lambda: tmp_path / "none.so")
    native._audio_lib.cache_clear()
    try:
        with pytest.raises(native.DecoderUnavailable, match="ffmpeg headers"):
            native.audio_decoder_available()
        with pytest.raises(native.DecoderUnavailable):
            ds.sample(1, np.random.default_rng(0))
    finally:
        native._audio_lib.cache_clear()


def test_run_main_flexible_patch_sizes_from_flac(tmp_path, monkeypatch):
    """A depth-2 recipe from flac files with flexible patch sizes 8 and 16:
    2 train steps at the sizes ``train_loop`` draws, then validation."""
    from aum_tpu_torch.run import main
    from aum_tpu_torch.train import flexible_patch_schedule, loop

    paths = [_write(tmp_path / f"t{i}.flac", 20 + i, 10000 + 1500 * i) for i in range(6)]
    train, labels = _manifest(tmp_path, paths[:4])
    val = tmp_path / "val.json"
    val.write_text(json.dumps({"data": [{"wav": p, "labels": "/m/1"} for p in paths[4:]]}))
    seen = []
    make_step = loop.make_train_step

    def recording(*a, **k):
        step = make_step(*a, **k)
        return lambda state, batch: (seen.append(k.get("patch_size")), step(state, batch))[1]

    monkeypatch.setattr(loop, "make_train_step", recording)
    history = main(["--recipe", "as20k/aum-base_scratch", "--device", "cpu",
                    "--data-train", train, "--data-val", str(val), "--label-csv", labels,
                    "--exp-dir", str(tmp_path / "exp"), "--num-workers", "2",
                    "--set", "flexible_patch_sizes=8,16", "--set", "depth=2",
                    "--set", "model_type=tiny", "--set", "dtype=float32",
                    "--set", "audio_length=64", "--set", "batch_size=2",
                    "--set", "n_class=2", "--set", "n_epochs=1"])
    assert seen == flexible_patch_schedule((8, 16), 2)
    assert np.isfinite(history[0]["train_loss"]) and np.isfinite(history[0]["loss"])
