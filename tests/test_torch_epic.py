"""The PyTorch port's EPIC-SOUNDS branch against the JAX package's, on the CPU.

- ``stft_log_mel`` on 1 s clips at 24 kHz, and the HTK mel bank;
- the spline solve (``interpolate_spline_flow``), the singular one-point
  system of the time warp included, ``dense_image_warp`` on a random flow,
  and ``time_warp``, the masks and ``combined_transforms`` on the values the
  JAX functions draw;
- ``make_epic_featurize``, train (on the JAX featurizer's draws) and eval;
- ``EpicBatchPipeline`` (train, val, test with ensemble views) and
  ``EpicFlexiBatchPipeline``: the same order, ``record_index``, ``n_frames``,
  windows and buckets, and the same batches (train on JAX's draws);
- ``run.main(["--device", "cpu", ...])`` on an HDF5 + pandas fixture built
  in the test (``tests/test_epic.py``'s, with a third segment kind): a train
  epoch, then the test split evaluated on the views' average.

Inputs are drawn with numpy from fixed seeds, at small sizes (clips <= 1 s,
64 frames). Tolerances are stated per test: fp32 throughout, the FFTs are
pocketfft on both sides with the frames laid out differently.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from aum_tpu.audio import spec_warp as jwarp
from aum_tpu.audio.spectrogram import mel_filterbank_htk as jax_mel_bank
from aum_tpu.audio.spectrogram import stft_log_mel as jax_stft_log_mel
from aum_tpu.data import epic as jepic

# Log-mels of the same audio: pocketfft on both sides, but the port
# transforms each frame's window support zero-padded at the end, JAX the
# whole frame, so the spectra differ by fp32 rounding of the log.
STFT_TOL = dict(rtol=1e-4, atol=1e-4)
# The warp: the flow comes from an SVD solve (LAPACK in JAX, torch's here),
# then a bilinear gather: fp32 rounding, scaled by the image's slopes.
WARP_TOL = dict(rtol=1e-4, atol=1e-4)
# Featurized batches: the log-mel's tolerance after normalize's 1 / (2 std).
FEAT_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(x):
    import torch

    return torch.from_numpy(np.array(x))


def jax_warp_draws(key, shape, W):
    """``spec_warp.time_warp``'s draws: (point, dist)."""
    b, t, _ = shape
    k1, k2 = jax.random.split(key)
    return {"point": _t(jax.random.randint(k1, (b,), W, t - W)).long(),
            "dist": _t(jax.random.randint(k2, (b,), -W, W)).long()}


def jax_mask_draws(key, b, length, param, num_masks):
    """``spec_warp._masked``'s (start, end) per mask."""
    out = []
    for k in jax.random.split(key, num_masks):
        k1, k2, k3 = jax.random.split(k, 3)
        w = jax.random.randint(k1, (b,), 0, param)
        start = jax.random.randint(k2, (b,), 0, length - w)
        end = start + jnp.where(w > 0, jax.random.randint(k3, (b,), 0, jnp.maximum(w, 1)), 0)
        out.append((_t(start).long(), _t(end).long()))
    return out


def jax_combined_draws(key, shape, t_mask, f_mask, t_warp):
    b, t, f = shape
    k1, k2, k3 = jax.random.split(key, 3)
    return {"warp": jax_warp_draws(k1, shape, t_warp) if t_warp > 0 else None,
            "freq": jax_mask_draws(k2, b, f, f_mask, 2),
            "time": jax_mask_draws(k3, b, t, t_mask, 2)}


def _spec(seed, shape=(2, 96, 32)):
    return (np.random.default_rng(seed).standard_normal(shape) * 2.0 - 6.0).astype(np.float32)


def _log_mel_fp64(wave, sr=24000, n_fft=2048, hop=120, win=240):
    """The same log-mel in float64 numpy, frame by frame (librosa's
    centred constant-padded framing, the Hann window centred in n_fft)."""
    x = np.pad(wave.astype(np.float64), [(0, 0), (n_fft // 2, n_fft // 2)])
    t = 1 + wave.shape[1] // hop
    window = np.zeros(n_fft)
    window[(n_fft - win) // 2:(n_fft - win) // 2 + win] = (
        0.5 - 0.5 * np.cos(2 * np.pi * np.arange(win) / win))
    frames = x[:, np.arange(t)[:, None] * hop + np.arange(n_fft)[None]] * window
    mel = np.asarray(jax_mel_bank(float(sr), n_fft, 128), np.float64)
    return np.log(np.abs(np.fft.rfft(frames, axis=-1)) @ mel.T + 1e-6)


def test_stft_log_mel_matches_jax():
    """A noise clip within STFT_TOL of JAX. A pure tone is ill-conditioned
    for the log (its far bins hold leakage at 1e-5 of the peak, where fp32
    FFT rounding moves the log by 1e-2 in either package): there the port
    must be no farther from a float64 evaluation than JAX is."""
    from aum_tpu_torch.audio.spectrogram import mel_filterbank_htk, stft_log_mel

    np.testing.assert_array_equal(mel_filterbank_htk(24000.0, 2048, 128),
                                  np.asarray(jax_mel_bank(24000.0, 2048, 128)))
    rng = np.random.default_rng(0)
    sr = 24000
    t = np.arange(sr) / sr
    wave = np.stack([0.1 * rng.standard_normal(sr), np.sin(2 * np.pi * 2000.0 * t)])
    wave = wave.astype(np.float32)
    want = np.asarray(jax_stft_log_mel(jnp.asarray(wave), sr=sr))
    got = stft_log_mel(_t(wave), sr=sr).numpy()
    assert got.shape == want.shape == (2, 1 + sr // 120, 128)
    np.testing.assert_allclose(got[0], want[0], **STFT_TOL)
    exact = _log_mel_fp64(wave)
    assert np.abs(got[1] - exact[1]).max() <= np.abs(want[1] - exact[1]).max()
    # A single clip, and only the first frames.
    np.testing.assert_allclose(stft_log_mel(_t(wave[0]), sr=sr, max_frames=64).numpy(),
                               want[0, :64], **STFT_TOL)


@pytest.mark.parametrize("n_points", [1, 3], ids=["one_point_singular", "three_points"])
def test_spline_solve_matches_jax(n_points):
    from aum_tpu_torch.audio.spec_warp import interpolate_spline_flow

    rng = np.random.default_rng(n_points)
    b = 3
    pts = np.stack([np.full((b, n_points), 16.0), rng.uniform(-12, 60, (b, n_points))], -1)
    pts[:, :, 0] += np.arange(n_points) * 5.0
    flows = np.stack([np.zeros((b, n_points)), rng.integers(-5, 5, (b, n_points))], -1)
    pts, flows = pts.astype(np.float32), flows.astype(np.float32)
    gy, gx = np.meshgrid(np.arange(32.0), np.arange(48.0), indexing="ij")
    query = np.stack([gy.ravel(), gx.ravel()], 1).astype(np.float32)
    if n_points == 1:  # the time warp's (4, 4) system has rank 2
        lhs = np.block([[np.zeros((1, 1)), np.append(pts[0, 0], 1.0)[None]],
                        [np.append(pts[0, 0], 1.0)[:, None], np.zeros((3, 3))]])
        assert np.linalg.matrix_rank(lhs) == 2
    want = np.stack([np.asarray(jwarp.interpolate_spline_flow(
        jnp.asarray(pts[i]), jnp.asarray(flows[i]), jnp.asarray(query))) for i in range(b)])
    got = interpolate_spline_flow(_t(pts), _t(flows), _t(query)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # exact at the control points
    at = interpolate_spline_flow(_t(pts), _t(flows), _t(pts)).numpy()
    np.testing.assert_allclose(at, flows, atol=1e-3)


def test_dense_image_warp_matches_jax():
    from aum_tpu_torch.audio.spec_warp import dense_image_warp

    rng = np.random.default_rng(4)
    img = rng.standard_normal((2, 24, 40)).astype(np.float32)
    flow = (rng.standard_normal((2, 24, 40, 2)) * 3.0).astype(np.float32)
    want = np.stack([np.asarray(jwarp.dense_image_warp(jnp.asarray(img[i]),
                                                       jnp.asarray(flow[i])))
                     for i in range(2)])
    got = dense_image_warp(_t(img), _t(flow)).numpy()
    np.testing.assert_allclose(got, want, **WARP_TOL)


@pytest.mark.parametrize("transform", ["time_warp", "freq_mask", "time_mask", "combined"])
def test_spec_warp_transforms_match_jax_on_its_draws(transform):
    from aum_tpu_torch.audio import spec_warp as pwarp

    spec = _spec(7)
    key = jax.random.PRNGKey(3)
    b, t, f = spec.shape
    x = jnp.asarray(spec)
    if transform == "time_warp":
        want = jax.jit(lambda k, v: jwarp.time_warp(k, v, W=5))(key, x)
        got = pwarp.apply_time_warp(_t(spec), jax_warp_draws(key, spec.shape, 5))
    elif transform == "freq_mask":
        want = jax.jit(lambda k, v: jwarp.freq_mask(k, v, F=12, num_masks=2))(key, x)
        got = _t(spec)
        for start, end in jax_mask_draws(key, b, f, 12, 2):
            got = pwarp.apply_mean_mask(got, start, end, axis=2)
    elif transform == "time_mask":
        want = jax.jit(lambda k, v: jwarp.time_mask(k, v, T=40, num_masks=2))(key, x)
        got = _t(spec)
        for start, end in jax_mask_draws(key, b, t, 40, 2):
            got = pwarp.apply_mean_mask(got, start, end, axis=1)
    else:
        want = jax.jit(lambda k, v: jwarp.combined_transforms(k, v, 40, 12, 5))(key, x)
        got = pwarp.apply_combined(_t(spec), jax_combined_draws(key, spec.shape, 40, 12, 5))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **WARP_TOL)
    assert not np.array_equal(got.numpy(), spec)


def test_draws_and_combined_on_their_own_generator():
    """The port's own draws: in range, reproducible from the seed, and a
    width-0 mask masks nothing."""
    import torch

    from aum_tpu_torch.audio.spec_warp import (
        apply_mean_mask,
        combined_transforms,
        draw_combined,
        draw_mask,
    )

    shape = (64, 96, 32)
    d = draw_combined(torch.Generator().manual_seed(0), shape, 40, 12, 5)
    assert ((d["warp"]["point"] >= 5) & (d["warp"]["point"] < 91)).all()
    assert ((d["warp"]["dist"] >= -5) & (d["warp"]["dist"] < 5)).all()
    for (start, end), length in [(m, 32) for m in d["freq"]] + [(m, 96) for m in d["time"]]:
        assert (start >= 0).all() and (end >= start).all() and (end <= length).all()
    start, end = draw_mask(torch.Generator().manual_seed(1), 8, 96, 0)
    assert torch.equal(start, end)
    spec = _t(_spec(2))
    assert torch.equal(apply_mean_mask(spec, start[:2], end[:2], axis=1), spec)
    a = combined_transforms(torch.Generator().manual_seed(9), spec, 40, 12, 5)
    b = combined_transforms(torch.Generator().manual_seed(9), spec, 40, 12, 5)
    assert torch.equal(a, b) and torch.isfinite(a).all()


# --- data --------------------------------------------------------------------

JAX_CFG = dict(clip_secs=0.5, num_frames=64, sampling_rate=8000, num_classes=5,
               t_mask=24, f_mask=16)


@pytest.fixture(scope="module")
def epic_files(tmp_path_factory):
    """An HDF5 audio store and a pandas annotation pickle: segments longer
    than the clip (a random window), exactly one clip, and shorter (taken
    whole and edge-padded)."""
    import h5py
    import pandas as pd

    root = tmp_path_factory.mktemp("epic")
    rng = np.random.default_rng(0)
    with h5py.File(root / "audio.hdf5", "w") as f:
        for v, n in (("video1", 40000), ("video2", 24000), ("video3", 12000)):
            f.create_dataset(v, data=(0.3 * rng.standard_normal(n)).astype(np.float32))
    rows = [("video1", "00:00:00.500", "00:00:03.500", 2),
            ("video2", "00:00:00.100", "00:00:00.300", 4),
            ("video3", "00:00:00.250", "00:00:00.750", 1),
            ("video1", "00:00:01.000", "00:00:02.250", 0),
            ("video2", "00:00:01.000", "00:00:01.200", 3),
            ("video3", "00:00:00.000", "00:00:01.400", 2)]
    pd.DataFrame([{"participant_id": "P1", "video_id": v, "annotation_id": f"a{i}",
                   "start_timestamp": s, "stop_timestamp": e, "class_id": c}
                  for i, (v, s, e, c) in enumerate(rows)]).to_pickle(root / "ann.pkl")
    return str(root / "ann.pkl"), str(root / "audio.hdf5")


def _datasets(epic_files, split):
    """(JAX dataset, port dataset from the files, port dataset in memory)."""
    import h5py
    import pandas as pd

    from aum_tpu_torch.data.epic import EpicAudioConfig, EpicSoundsDataset

    ann, h5 = epic_files
    jds = jepic.EpicSoundsDataset(ann, h5, jepic.EpicAudioConfig(**JAX_CFG), split=split)
    cfg = EpicAudioConfig(**JAX_CFG)
    records = [row.to_dict() for _, row in pd.read_pickle(ann).iterrows()]
    with h5py.File(h5, "r") as f:
        audio = {k: f[k][()] for k in f}
    return (jds, EpicSoundsDataset.from_files(ann, h5, cfg, split=split),
            EpicSoundsDataset(records, audio, cfg, split=split))


# Every featurized batch of the tests below has BATCH clips, so each JAX
# featurizer (train and eval) compiles once for the module.
BATCH = 3


@pytest.fixture(scope="module")
def jax_featurize():
    cfg = jepic.EpicAudioConfig(**JAX_CFG)
    return {train: jepic.make_epic_featurize(cfg, train) for train in (True, False)}


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_make_epic_featurize_matches_jax(epic_files, jax_featurize, train):
    import torch

    from aum_tpu_torch.data.epic import make_epic_featurize

    jds, _, pds = _datasets(epic_files, "train")
    rng = np.random.default_rng(0)
    samples = [pds.sample(i, rng) for i in range(BATCH)]
    waves = np.stack([s[0] for s in samples])
    n_frames = np.array([s[1] for s in samples], np.int32)
    labels = np.stack([s[2] for s in samples])
    assert n_frames.min() < JAX_CFG["num_frames"] == n_frames.max()  # edge-padding acts
    key = jax.random.PRNGKey(5)
    want = jax_featurize[train](key, waves, n_frames, labels)
    draws = {}
    if train:
        _, k_aug = jax.random.split(key)
        shape = (len(waves), JAX_CFG["num_frames"], 128)
        draws = {"augment": jax_combined_draws(k_aug, shape, pds.cfg.t_mask, pds.cfg.f_mask,
                                               pds.cfg.t_warp)}
    got = make_epic_featurize(pds.cfg, train)(_t(waves), _t(n_frames).long(), _t(labels), draws)
    assert got["x"].shape == (BATCH, JAX_CFG["num_frames"], 128)
    np.testing.assert_allclose(got["x"].numpy(), np.asarray(want["x"]), **FEAT_TOL)
    assert torch.equal(got["y"], _t(labels))


def _jax_batch_keys(seed, epoch, n, flexi=False):
    words = [seed, epoch, 1] if flexi else [seed, epoch]
    key = jax.random.PRNGKey(np.random.default_rng(words).integers(2 ** 31))
    keys = []
    for _ in range(n):
        key, kb = jax.random.split(key)
        keys.append(kb)
    return keys


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_epic_batch_pipeline_matches_jax(epic_files, jax_featurize, split):
    import concurrent.futures as cf

    from aum_tpu_torch.data.epic import EpicBatchPipeline, make_epic_featurize

    jds, fds, pds = _datasets(epic_files, split)
    train, bs, epoch, seed = split == "train", BATCH, 2, 3
    jpipe = jepic.EpicBatchPipeline(jds, bs, train=train, seed=seed, num_workers=1)
    jpipe._featurize = jax_featurize[train]
    want = list(jpipe.batches(epoch))
    for ds in (fds, pds):
        pipe = EpicBatchPipeline(ds, bs, train=train, seed=seed, num_workers=2, device="cpu")
        assert pipe.steps_per_epoch() == jpipe.steps_per_epoch()
        got = list(pipe.batches(epoch))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["record_index"], np.asarray(w["record_index"]))
            np.testing.assert_array_equal(g["y"].numpy(), np.asarray(w["y"]))
            if not train:
                np.testing.assert_allclose(g["x"].numpy(), np.asarray(w["x"]), **FEAT_TOL)
    if split == "test":
        rec = np.concatenate([b["record_index"] for b in got])
        np.testing.assert_array_equal(rec, np.repeat(np.arange(6), 5))
    if not train:
        return
    # Train: the same windows (host batches), then the same batches on JAX's draws.
    rng = np.random.default_rng(seed + epoch)
    order = rng.permutation(len(jds))
    pipe = EpicBatchPipeline(pds, bs, train=True, seed=seed, device="cpu")
    prng = np.random.default_rng(seed + epoch)
    np.testing.assert_array_equal(pipe.epoch_order(epoch)[0], prng.permutation(len(pds)))
    feat = make_epic_featurize(pds.cfg, True)
    keys = _jax_batch_keys(seed, epoch, len(want))
    with cf.ThreadPoolExecutor(2) as pool:
        for b, w in enumerate(want):
            idxs = order[b * bs:(b + 1) * bs]
            jax_samples = [jds.sample(int(i), rng) for i in idxs]
            waves, n_frames, labels, rec = pipe.host_batch(idxs, prng, pool)
            np.testing.assert_array_equal(waves, np.stack([s[0] for s in jax_samples]))
            np.testing.assert_array_equal(n_frames, [s[1] for s in jax_samples])
            np.testing.assert_array_equal(rec, [s[3] for s in jax_samples])
            _, k_aug = jax.random.split(keys[b])
            shape = (bs, JAX_CFG["num_frames"], 128)
            draws = {"augment": jax_combined_draws(k_aug, shape, pds.cfg.t_mask,
                                                   pds.cfg.f_mask, pds.cfg.t_warp)}
            got_x = feat(_t(waves), _t(n_frames), _t(labels), draws)["x"]
            np.testing.assert_allclose(got_x.numpy(), np.asarray(w["x"]), **FEAT_TOL)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_epic_flexi_pipeline_matches_jax(epic_files, train):
    from aum_tpu_torch.audio.spec_warp import apply_combined
    from aum_tpu_torch.data.epic import EpicFlexiBatchPipeline

    jds, _, pds = _datasets(epic_files, "train")
    seed, epoch, bs = 1, 4, 2
    jpipe = jepic.EpicFlexiBatchPipeline(jds, bs, train=train, seed=seed, num_workers=1)
    want = list(jpipe.batches(epoch))
    pipe = EpicFlexiBatchPipeline(pds, bs, train=train, seed=seed, device="cpu")
    plan = pipe.plan(epoch)
    # JAX's buckets: its order, bucketed by the rounded length of each fetch.
    order = np.random.default_rng(seed + epoch).permutation(6) if train else np.arange(6)
    buckets = {}
    for i in order:
        w = jds._audio()[jds.records[i].video_id][
            jds.records[i].start_audio_sample:jds.records[i].end_audio_sample][:4000 * 3]
        n = min(1 + len(w) // jds.cfg.hop_samples, jds.cfg.num_frames)
        buckets.setdefault(jpipe._target_length(n), []).append(int(i))
    assert plan == sorted(buckets.items())
    assert len({t for t, _ in plan}) > 1
    got = list(pipe.batches(epoch))
    assert len(got) == len(want)
    keys = _jax_batch_keys(seed, epoch, len(want), flexi=True)
    for b, (g, w) in enumerate(zip(got, want)):
        assert g["x"].shape == tuple(w["x"].shape)
        np.testing.assert_array_equal(g["y"].numpy(), np.asarray(w["y"]))
        if not train:
            np.testing.assert_allclose(g["x"].numpy(), np.asarray(w["x"]), **FEAT_TOL)
            continue
        # Undo the port's own augmentation: rebuild the eval features of the
        # batch, apply JAX's draws, normalize, compare.
        tgt = g["x"].shape[1]
        _, k_aug = jax.random.split(keys[b])
        cfg = pds.cfg
        draws = jax_combined_draws(k_aug, tuple(g["x"].shape), max(cfg.t_mask * tgt // 1024, 1),
                                   cfg.f_mask, cfg.t_warp * tgt // 1024)
        plain = EpicFlexiBatchPipeline(pds, bs, train=False, seed=seed, device="cpu")
        fb = plain.featurize_for(tgt)
        idxs = g["record_index"]
        rows = [pipe.fetch(i) for i in idxs]
        wave_len = (tgt - 1) * cfg.hop_samples + 1
        waves = np.zeros((len(rows), wave_len), np.float32)
        for j, (wv, _, _) in enumerate(rows):
            waves[j, :min(len(wv), wave_len)] = wv[:wave_len]
        n_frames = np.array([min(r[1], tgt) for r in rows], np.int64)
        x = fb(_t(waves), _t(n_frames), g["y"], {})["x"] * (2 * cfg.std) + cfg.mean
        x = (apply_combined(x, draws) - cfg.mean) / (2 * cfg.std)
        np.testing.assert_allclose(x.numpy(), np.asarray(w["x"]), **FEAT_TOL)


def test_from_files_needs_pandas_and_h5py(monkeypatch, epic_files):
    import builtins

    from aum_tpu_torch.data.epic import EpicAudioConfig, EpicSoundsDataset

    real = builtins.__import__

    def no_h5py(name, *a, **k):
        if name == "h5py":
            raise ImportError("No module named 'h5py'")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    with pytest.raises(ImportError, match="records and a mapping"):
        EpicSoundsDataset.from_files(*epic_files, EpicAudioConfig(**JAX_CFG))


def test_run_main_epic_train_then_test_split_views(epic_files, tmp_path):
    import os

    from aum_tpu_torch.run import main

    ann, h5 = epic_files
    common = ["--recipe", "epic_sounds/aum-base_scratch", "--device", "cpu",
              "--epic-hdf5", h5, "--num-workers", "1",
              "--set", "depth=2", "--set", "model_type=tiny", "--set", "n_class=5",
              "--set", "batch_size=2", "--set", "dtype=float32", "--set", "audio_length=64",
              "--set", "timem=8", "--set", "freqm=8"]
    exp = str(tmp_path / "train")
    history = main(common + ["--epic-annotations-train", ann, "--epic-annotations-val", ann,
                             "--exp-dir", exp, "--set", "n_epochs=1"])
    assert len(history) == 1 and np.isfinite(history[0]["train_loss"])
    assert os.path.exists(os.path.join(exp, "result.csv"))
    ev = str(tmp_path / "eval")
    m = main(common + ["--epic-annotations-test", ann, "--exp-dir", ev, "--run-type", "eval",
                       "--ckpt", os.path.join(exp, "models")])
    assert 0.0 <= m["acc"] <= 1.0 and np.isnan(m["loss"])
    scores = np.loadtxt(os.path.join(ev, "predictions_eval.csv"), delimiter=",")
    assert scores.shape == (6, 5)  # one row per record: its 5 views averaged
    assert os.path.exists(os.path.join(ev, "result_eval.csv"))
