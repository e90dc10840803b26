"""The port's flagship entry points.

- ``entry``: the eval forward, the counterpart of ``__graft_entry__.entry``:
  AuM-Base Fo-Bi (bimamba v1, width 768, depth 24), 527 classes, bf16
  compute with an fp32 residual stream, weights drawn from a fixed seed, on
  a (8, 1024, 128) log-mel input: 513 tokens with the middle cls token.
- ``train_entry``: one train step of the same model, the counterpart of
  ``scripts/bench_train_step.py``: B = 12 (the recipes' batch size), BCE,
  Adam with lr 5e-5 and weight decay 5e-7 over 1000 steps per epoch, one-hot
  labels ``arange(B) % 527``, no augmentation, the default
  ``remat_mode="auto"`` (which resolves to ``"split"`` there).
- ``wav_entry``: the eval forward of AuM-Base Fo-Fo (bimamba ``"none"``)
  served from raw waveforms, the counterpart of the JAX serving graph with
  ``include_frontend=True``: B = 8 clips of 10 s at 16 kHz (AudioSet's clip
  length), the Kaldi fbank with 128 mel bins, zero-padded to 1024 frames and
  normalized with AudioSet's statistics, then the model (bf16, 527 classes,
  middle cls token).

All run on CUDA unless ``device`` is given, and raise without a card.

- ``dryrun_multichip(n)``: the counterpart of ``__graft_entry__.
  dryrun_multichip``: spawns ``n`` ranks over gloo, sharing the card
  unless ``device`` names another device, and runs its legs with its
  conditions on n (``parallel/checks.py::dryrun_leg``), then prints its
  summary line.
"""

from __future__ import annotations

import torch

from aum_tpu_torch.models import AudioMamba, AudioMambaConfig
from aum_tpu_torch.serving import forward_fn, frontend_fn
from aum_tpu_torch.train import (
    TrainHyperParams,
    init_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from aum_tpu_torch.utils import resolve_device

TRAIN_BATCH = 12
TRAIN_HP = TrainHyperParams(lr=5e-5, weight_decay=5e-7)
STEPS_PER_EPOCH = 1000
WAV_BATCH = 8
SAMPLE_RATE = 16000
CLIP_SAMPLES = 10 * SAMPLE_RATE
# AudioSet's log-mel statistics: copies of aum_tpu/configs.py's
# dataset_mean / dataset_std (the audioset recipes).
AUDIOSET_MEAN = -4.2677393
AUDIOSET_STD = 4.5689974


def flagship_config(aum_type: str = "Fo-Bi", **overrides) -> AudioMambaConfig:
    kw = {"num_classes": 527, "dtype": "bfloat16", **overrides}
    return AudioMambaConfig.from_variant("base", aum_type, **kw)


def entry(device: str | torch.device | None = None):
    """(fn, args) for one eval forward; ``fn(*args)`` returns (8, 527) logits."""
    device = resolve_device(device)
    model = AudioMamba(flagship_config(), device=device, seed=0)
    x = torch.zeros((8, 1024, 128), dtype=torch.float32, device=device)
    return make_eval_step(model), (x,)


def train_entry(device: str | torch.device | None = None):
    """(step_fn, state, batch); ``step_fn(state, batch)`` takes one train step
    and returns (state, loss)."""
    device = resolve_device(device)
    cfg = flagship_config(remat=True)
    model = AudioMamba(cfg, device=device, seed=0)
    state = init_train_state(model, make_optimizer(model.parameters(), TRAIN_HP))
    step_fn = make_train_step(TRAIN_HP, STEPS_PER_EPOCH, loss_type="BCE",
                              generator=torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    x = torch.randn((TRAIN_BATCH, *reversed(cfg.spectrogram_size)), generator=g)
    y = torch.nn.functional.one_hot(torch.arange(TRAIN_BATCH) % cfg.num_classes,
                                    cfg.num_classes).float()
    return step_fn, state, {"x": x.to(device), "y": y.to(device)}


def _wav_spec(config: AudioMambaConfig) -> dict:
    melbins, audio_length = config.spectrogram_size
    return dict(audio_length=audio_length, melbins=melbins, mean=AUDIOSET_MEAN,
                std=AUDIOSET_STD, sample_rate=SAMPLE_RATE)


def wav_frontend_fn(config: AudioMambaConfig):
    """``wav_entry``'s frontend alone: (B, CLIP_SAMPLES) waveforms -> the
    normalized log-mel that ``config``'s model takes."""
    return frontend_fn(**_wav_spec(config))


def wav_forward_fn(model: AudioMamba):
    """The served forward of ``wav_entry``: (B, CLIP_SAMPLES) waveforms ->
    logits, with the frontend sized for ``model``'s spectrogram."""
    return forward_fn(model, include_frontend=True, **_wav_spec(model.config))


def wav_entry(device: str | torch.device | None = None):
    """(fn, args) for one eval forward from waveforms; ``fn(*args)`` returns
    (8, 527) logits."""
    device = resolve_device(device)
    model = AudioMamba(flagship_config("Fo-Fo"), device=device, seed=0)
    # A speech-like level: 0.1 * N(0, 1) samples.
    wav = 0.1 * torch.randn((WAV_BATCH, CLIP_SAMPLES), generator=torch.Generator().manual_seed(0))
    return make_eval_step(wav_forward_fn(model)), (wav.to(device),)


def dryrun_multichip(n: int, device: str | torch.device | None = None) -> dict:
    """One train step of AuM on an n-rank data x model mesh, the
    sequence-parallel scan against the oracle over n ranks and, for n a
    multiple of 8, the data x seq x model and data x pipe steps (losses
    equal to the 2D step's), each rank a process over gloo, all on the
    CUDA card unless ``device`` names another device. Prints the summary
    line and returns rank 0's results."""
    from aum_tpu_torch.ops import _build
    from aum_tpu_torch.parallel.launch import spawn

    device = resolve_device(device)
    if device.type == "cuda":
        _build.build_all()  # the ranks only load the kernels
    out = spawn("aum_tpu_torch.parallel.checks:dryrun_leg", n, {"n": n, "device": str(device)},
                backend="gloo", device=device)[0]
    print(f"dryrun_multichip({n}): mesh={out['mesh']}, loss={out['loss']:.4f}, "
          f"seq-parallel scan exact over {{'seq': {n}}}"
          + (f", data×seq×model train step loss={out['loss3']:.4f} (== 2D)"
             if "loss3" in out else "")
          + (f", data×pipe train step loss={out['loss_pp']:.4f} (== 2D)"
             if "loss_pp" in out else ""))
    return out
