from aum_tpu_torch.audio.augment import (
    mixup_waveforms,
    noise_and_roll,
    normalize,
    spec_augment,
)
from aum_tpu_torch.audio.fbank import FbankConfig, fbank, mel_banks
from aum_tpu_torch.audio.spec_warp import combined_transforms
from aum_tpu_torch.audio.spectrogram import mel_filterbank_htk, stft_log_mel

__all__ = ["FbankConfig", "combined_transforms", "fbank", "mel_banks", "mel_filterbank_htk",
           "mixup_waveforms", "noise_and_roll", "normalize", "spec_augment", "stft_log_mel"]
