from aum_tpu_torch.audio.augment import (
    mixup_waveforms,
    noise_and_roll,
    normalize,
    spec_augment,
)
from aum_tpu_torch.audio.fbank import FbankConfig, fbank, mel_banks

__all__ = ["FbankConfig", "fbank", "mel_banks", "mixup_waveforms", "noise_and_roll",
           "normalize", "spec_augment"]
