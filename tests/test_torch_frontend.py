"""The PyTorch port's frontend and served forward against the JAX package, on the CPU.

- ``aum_tpu_torch.audio.fbank`` against ``aum_tpu.audio.fbank`` (the Kaldi
  fbank), for two window types and an odd sample count;
- ``aum_tpu_torch.serving.forward_fn`` (waveforms -> mean subtraction ->
  fbank -> pad or crop -> normalize -> model) against
  ``aum_tpu.serving._forward_fn(include_frontend=True)`` on a small Fo-Fo
  model whose weights the JAX package's porter carries over;
- ``entry.wav_entry``: built on the CPU, raising without a card.

Waveforms are drawn with numpy from fixed seeds and handed to both
frameworks. torch is imported inside the tests, as in the other port test
modules.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from aum_tpu.audio import FbankConfig as JaxFbankConfig
from aum_tpu.audio import fbank as jax_fbank
from aum_tpu.convert.torch_port import port_aum_state_dict
from aum_tpu.serving import _forward_fn as jax_forward_fn
from scripts.record_goldens import build_flax


def _wave(seed, shape):
    # A speech-like level with a DC offset, which the frontend must remove.
    return (0.1 * np.random.default_rng(seed).standard_normal(shape) + 0.05).astype(np.float32)


@pytest.mark.parametrize("window_type", ["hanning", "povey"])
def test_fbank_matches_jax(window_type):
    import torch

    from aum_tpu_torch.audio import FbankConfig, fbank

    wav = _wave(1, (2, 16000 + 321))  # odd: the last frame ends short of the clip
    cfg = FbankConfig(window_type=window_type)
    got = fbank(torch.from_numpy(wav), cfg)
    jcfg = JaxFbankConfig(window_type=window_type)
    want = np.asarray(jax.jit(functools.partial(jax_fbank, cfg=jcfg))(jnp.asarray(wav)))
    assert tuple(got.shape) == want.shape == (2, cfg.num_frames(wav.shape[1]), 128)
    assert got.dtype == torch.float32
    # fp32 on both sides, sums (frame means, FFTs, mel products) in other
    # orders: the bound tests/test_fbank.py holds the JAX fbank to against its
    # numpy oracle. Measured: 1.6e-4 abs at most, on a few of the 25,600
    # log-mels (relative 1.4e-5).
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # One clip alone gives the same frames as in the batch.
    np.testing.assert_allclose(fbank(torch.from_numpy(wav[1]), cfg).numpy(), got[1].numpy(),
                               rtol=0, atol=1e-6)


# audio_length 64: 50 frames are zero-padded to it, 80 cropped.
@pytest.mark.parametrize("frames", [50, 80], ids=["pad", "crop"])
def test_forward_fn_matches_jax(frames):
    import torch

    from aum_tpu_torch.models import AudioMamba, AudioMambaConfig
    from aum_tpu_torch.serving import forward_fn
    from aum_tpu_torch.train import make_eval_step

    kw = dict(spectrogram_size=(32, 64), depth=2, embed_dim=32, num_classes=5,
              bimamba_type="none")
    model = AudioMamba(AudioMambaConfig(**kw), device="cpu", seed=12)
    jcfg, jmodel = build_flax(kw)
    params = port_aum_state_dict({k: v.numpy() for k, v in model.state_dict().items()}, jcfg)
    fcfg = JaxFbankConfig()
    wav = _wave(2, (2, fcfg.frame_length + (frames - 1) * fcfg.frame_shift))
    spec = dict(include_frontend=True, audio_length=64, melbins=32, mean=-4.2677393,
                std=4.5689974, sample_rate=16000)
    want = np.asarray(jax.jit(jax_forward_fn(jmodel, **spec))(params, jnp.asarray(wav)))
    got = make_eval_step(forward_fn(model, **spec))(torch.from_numpy(wav))
    assert tuple(got.shape) == want.shape == (2, 5)
    # fp32 on both sides; the frontend's 1e-4 on log-mels, scaled by
    # 1 / (2 std), then reduction orders through 2 layers.
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_wav_entry_on_cpu_builds_and_needs_a_card(monkeypatch):
    import torch

    from aum_tpu_torch.entry import CLIP_SAMPLES, WAV_BATCH, flagship_config, wav_entry

    fn, (wav,) = wav_entry(device="cpu")
    assert callable(fn) and (WAV_BATCH, CLIP_SAMPLES) == (8, 160000)
    assert tuple(wav.shape) == (8, 160000) and wav.dtype == torch.float32
    assert wav.device.type == "cpu" and 0.09 < float(wav.std()) < 0.11
    assert flagship_config("Fo-Fo").bimamba_type == "none"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wav_entry()
