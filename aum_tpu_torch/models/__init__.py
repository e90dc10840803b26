from aum_tpu_torch.models.audio_mamba import AudioMamba, AudioMambaConfig, TokenDraws, draw_tokens
from aum_tpu_torch.models.mamba import MambaBlock, MambaMixer

__all__ = ["AudioMamba", "AudioMambaConfig", "MambaBlock", "MambaMixer", "TokenDraws",
           "draw_tokens"]
