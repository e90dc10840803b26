from aum_tpu_torch.audio.augment import normalize
from aum_tpu_torch.audio.fbank import FbankConfig, fbank, mel_banks

__all__ = ["FbankConfig", "fbank", "mel_banks", "normalize"]
