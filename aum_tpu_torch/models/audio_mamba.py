"""AudioMamba (AuM): bidirectional-Mamba audio classifier, eval and train forward.

Counterpart of ``aum_tpu/models/audio_mamba.py``:

- input (B, T, F) log-mel, swapped to (B, F, T), then the patch embedding
  -> (B, N, D) tokens, F-major;
- a static cls token (middle, end, front, or the double head/tail pair),
  then the absolute position embedding;
- optional F-major -> T-major token transpose (``transpose_token_sequence``);
- ``depth`` x [add -> RMSNorm -> bidirectional Mamba mixer] blocks, starting
  from a zero fp32 residual stream;
- final fused add+norm, cls readout (or mean/max/last pooling), linear head.

Parameters are drawn on the CPU from an explicit ``torch.Generator`` (so a
seed gives the same weights on every device), then moved to the model's
device. Entry points run on CUDA unless ``device`` is given; see
``aum_tpu_torch.utils.resolve_device``.

The forward is differentiable. ``train=True`` turns on the stochastic depth
(``drop_path_rate``) and the pos-embed dropout (``drop_rate``), with masks
drawn from the caller's ``torch.Generator`` outside every checkpointed region
and passed in, so a recompute reuses them (``torch.utils.checkpoint`` replays
only the default CUDA generator). Remat (``remat``, ``remat_mode``) applies
only when a grad is being taken: ``"block"`` checkpoints each whole block,
``"split"`` only each mixer's pre-scan compute.

Not ported yet (they raise ``NotImplementedError``): Fo-Fo (``"none"``),
``if_bidirectional``, random cls position, token shuffle, sequence flip,
RoPE, and ``remat_mode="auto"`` (its memory budget and per-element figure
are TPU calibrations; the card's are not measured yet); the JAX module's
``seq_axis`` / ``pipe_axis`` parallel modes have no counterpart yet.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from aum_tpu_torch.models.mamba import MambaBlock, _Weights
from aum_tpu_torch.models.tokenization import (
    PatchEmbed,
    PosEmbed,
    patch_grid_shape,
    to_2tuple,
    trunc_normal_02_,
)
from aum_tpu_torch.ops import fused_add_norm
from aum_tpu_torch.utils import resolve_device


@dataclasses.dataclass(frozen=True)
class AudioMambaConfig:
    """Static model configuration (the JAX package's defaults).

    The JAX config's fields that no configuration changes are constants
    here: RMSNorm with an fp32 residual stream, v2 outputs halved, no
    LayerScale. RoPE waits for its slice. ``remat_mode`` defaults to
    ``"split"``, what the JAX default ``"auto"`` resolves to on the train
    workload; ``"auto"`` itself raises.
    """

    spectrogram_size: Tuple[int, int] = (128, 1024)  # (F, T)
    patch_size: Tuple[int, int] = (16, 16)
    strides: Tuple[int, int] = (16, 16)
    depth: int = 24
    embed_dim: int = 768
    num_classes: int = 527
    d_state: int = 16
    norm_epsilon: float = 1e-5
    final_pool_type: str = "mean"
    if_abs_pos_embed: bool = True
    if_cls_token: bool = True
    use_middle_cls_token: bool = True
    use_end_cls_token: bool = False
    use_double_cls_token: bool = False
    bimamba_type: str = "v2"
    if_bidirectional: bool = False
    transpose_token_sequence: bool = False
    remat: bool = True
    remat_mode: str = "split"  # "none" | "block" | "split" ("auto" raises)
    drop_path_rate: float = 0.0
    drop_rate: float = 0.0
    dtype: str = "float32"

    @property
    def patch_grid(self) -> Tuple[int, int]:
        return patch_grid_shape(self.strides, self.patch_size,
                                self.spectrogram_size[0], self.spectrogram_size[1])

    @property
    def num_patches(self) -> int:
        f, t = self.patch_grid
        return f * t

    @property
    def num_prefix_tokens(self) -> int:
        if not self.if_cls_token:
            return 0
        return 2 if self.use_double_cls_token else 1

    @staticmethod
    def base(**kw) -> "AudioMambaConfig":
        return AudioMambaConfig(**{"depth": 24, "embed_dim": 768, **kw})

    @staticmethod
    def small(**kw) -> "AudioMambaConfig":
        return AudioMambaConfig(**{"depth": 24, "embed_dim": 384, **kw})

    @staticmethod
    def tiny(**kw) -> "AudioMambaConfig":
        return AudioMambaConfig(**{"depth": 24, "embed_dim": 192, **kw})

    @staticmethod
    def from_variant(model_type: str = "base", aum_type: str = "Fo-Bi",
                     **kw) -> "AudioMambaConfig":
        bimamba = {"Fo-Fo": "none", "Fo-Bi": "v1", "Bi-Bi": "v2"}[aum_type]
        ctor = {"base": AudioMambaConfig.base, "small": AudioMambaConfig.small,
                "tiny": AudioMambaConfig.tiny}[model_type]
        return ctor(bimamba_type=bimamba, **kw)


REMAT_MODES = ("none", "block", "split")


def drop_path_rates(rate: float, depth: int) -> np.ndarray:
    """Per-layer stochastic-depth rates: [0] + linspace(0, rate, depth)[:-1]
    (layer 0 drops nothing); the final add+norm drops at the full rate."""
    dpr = np.linspace(0.0, rate, depth)
    return np.concatenate([[0.0], dpr[:-1]]).astype(np.float32)


def keep_mask(shape, rate: float, generator: torch.Generator, device):
    """(mask, keep) for drop rate ``rate``: a keep mask of ``shape`` drawn on
    the CPU from ``generator`` (so a seed gives the same masks on every
    device), and the keep probability 1 - rate computed in fp32."""
    keep = float(np.float32(1.0) - np.float32(rate))
    mask = torch.rand(shape, generator=generator) < keep
    return mask.to(device), keep


def _drop(x: torch.Tensor, mask: torch.Tensor, keep: float) -> torch.Tensor:
    """where(mask, x / keep, 0), keep rounded to x's dtype as in the JAX op;
    keep 1 with an all-true mask is an exact identity."""
    scale = torch.tensor(keep, dtype=x.dtype, device=x.device)
    return torch.where(mask, x / scale, torch.zeros((), dtype=x.dtype, device=x.device))


class AudioMamba(nn.Module):
    """AuM classifier."""

    def __init__(self, config: AudioMambaConfig,
                 device: str | torch.device | None = None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        cfg = config
        if cfg.if_bidirectional:
            raise NotImplementedError("if_bidirectional is not ported yet")
        if cfg.remat and cfg.remat_mode == "auto":
            raise NotImplementedError(
                "remat_mode='auto' needs a memory budget measured on the card; "
                "pick 'split', 'block' or 'none'")
        if cfg.remat_mode not in REMAT_MODES + ("auto",):
            raise ValueError(f"unknown remat_mode: {cfg.remat_mode}")
        self.config = cfg
        self.dtype = getattr(torch, cfg.dtype, None)
        if not isinstance(self.dtype, torch.dtype):
            raise ValueError(f"unknown dtype: {cfg.dtype}")
        d = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.strides, d)
        if cfg.if_cls_token:
            if cfg.use_double_cls_token:
                self.cls_token_head = nn.Parameter(torch.empty((1, 1, d)))
                self.cls_token_tail = nn.Parameter(torch.empty((1, 1, d)))
            else:
                self.cls_token = nn.Parameter(torch.empty((1, 1, d)))
        self.pos_embed = (PosEmbed(cfg.patch_grid, d, cfg.num_prefix_tokens)
                          if cfg.if_abs_pos_embed else None)
        self.layers = nn.ModuleList([
            MambaBlock(d, norm_epsilon=cfg.norm_epsilon,
                       bimamba_type=cfg.bimamba_type, d_state=cfg.d_state,
                       n_layer=cfg.depth)
            for _ in range(cfg.depth)])
        self.norm_f = _Weights((d,))
        self.head = _Weights((cfg.num_classes, d), (cfg.num_classes,))
        self.reset_parameters(torch.Generator().manual_seed(seed))
        self.to(device)
        self.eval()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.patch_embed.reset_parameters(generator)
        for name in ("cls_token", "cls_token_head", "cls_token_tail"):
            if hasattr(self, name):
                trunc_normal_02_(getattr(self, name), generator)
        if self.pos_embed is not None:
            self.pos_embed.reset_parameters(generator)
        for layer in self.layers:
            layer.reset_parameters(generator)
        nn.init.ones_(self.norm_f.weight)
        trunc_normal_02_(self.head.weight, generator)
        nn.init.zeros_(self.head.bias)

    def _insert_cls(self, x: torch.Tensor):
        """Insert the cls token(s); returns (tokens, static position(s))."""
        cfg = self.config
        b, n = x.shape[:2]
        if not cfg.if_cls_token:
            return x, None
        if cfg.use_double_cls_token:
            head = self.cls_token_head.to(x.dtype).expand(b, -1, -1)
            tail = self.cls_token_tail.to(x.dtype).expand(b, -1, -1)
            return torch.cat([head, x, tail], dim=1), [0, n + 1]
        if cfg.use_middle_cls_token:
            tp = n // 2
        elif cfg.use_end_cls_token:
            tp = n
        else:
            tp = 0
        cls = self.cls_token.to(x.dtype).expand(b, -1, -1)
        return torch.cat([x[:, :tp], cls, x[:, tp:]], dim=1), tp

    def _block(self, layer, hidden, residual, drop, split_remat):
        if drop is not None:
            hidden = _drop(hidden, *drop)
        return layer(hidden, residual, self.dtype, split_remat=split_remat)

    def forward(self, x: torch.Tensor,
                train: bool = False, if_random_cls_token_position: bool = False,
                if_random_token_rank: bool = False,
                flip_sequence_prob: float = 0.0,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """x: (B, T, F) log-mel -> logits (B, num_classes) in the compute dtype.

        ``train`` turns on drop path and pos dropout (when their rates are
        not 0), with masks drawn from ``generator``. Eval callers run it
        under ``torch.inference_mode()``.
        """
        if if_random_cls_token_position or if_random_token_rank or flip_sequence_prob > 0:
            raise NotImplementedError(
                "random cls position, token shuffle and sequence flip are not ported")
        cfg = self.config
        dtype = self.dtype
        use_dp = train and cfg.drop_path_rate > 0
        use_pos_drop = train and cfg.drop_rate > 0 and self.pos_embed is not None
        if (use_dp or use_pos_drop) and generator is None:
            raise ValueError("train=True with a drop rate needs a torch.Generator")
        x = self.patch_embed(x.transpose(1, 2), dtype)
        x, token_position = self._insert_cls(x)
        if self.pos_embed is not None:
            x = self.pos_embed(x, token_position)
            if use_pos_drop:
                x = _drop(x, *keep_mask(x.shape, cfg.drop_rate, generator, x.device))
        if cfg.transpose_token_sequence:
            x = _transpose_tokens(x, cfg.patch_grid, token_position)

        # Every mask is drawn here, outside the checkpointed regions.
        bsz = x.shape[0]
        drops = [None] * cfg.depth
        if use_dp:
            drops = [keep_mask((bsz, 1, 1), r, generator, x.device)
                     for r in drop_path_rates(cfg.drop_path_rate, cfg.depth)]
            final_drop = keep_mask((bsz, 1, 1), cfg.drop_path_rate, generator, x.device)
        mode = cfg.remat_mode if cfg.remat and torch.is_grad_enabled() else "none"

        hidden = x
        residual = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        for layer, drop in zip(self.layers, drops):
            if mode == "block":
                hidden, residual = checkpoint(self._block, layer, hidden, residual, drop,
                                              False, use_reentrant=False)
            else:
                hidden, residual = self._block(layer, hidden, residual, drop,
                                               mode == "split")
        if use_dp:
            hidden = _drop(hidden, *final_drop)
        hidden = fused_add_norm(hidden, self.norm_f.weight.to(dtype),
                                residual=residual, prenorm=False,
                                eps=cfg.norm_epsilon)

        if cfg.if_cls_token:
            if cfg.use_double_cls_token:
                feats = (hidden[:, token_position[0]]
                         + hidden[:, token_position[1]]) / 2
            else:
                feats = hidden[:, token_position]
        elif cfg.final_pool_type == "none":
            feats = hidden[:, -1]
        elif cfg.final_pool_type == "mean":
            feats = hidden.mean(dim=1)
        elif cfg.final_pool_type in ("max", "all"):
            feats = hidden
        else:
            raise NotImplementedError(cfg.final_pool_type)
        logits = (feats.to(dtype) @ self.head.weight.to(dtype).t()
                  + self.head.bias.to(dtype))
        if cfg.final_pool_type == "max" and not cfg.if_cls_token:
            logits = logits.max(dim=1).values
        return logits


def _transpose_tokens(x: torch.Tensor, grid, token_position) -> torch.Tensor:
    """Reorder grid tokens from F-major to T-major, keeping the cls token(s)
    at their position(s)."""
    gh, gw = grid

    def flip_grid(body):
        b, n, d = body.shape
        return body.reshape(b, gh, gw, d).transpose(1, 2).reshape(b, n, d)

    if token_position is None:
        return flip_grid(x)
    if isinstance(token_position, (list, tuple)):
        return torch.cat([x[:, :1], flip_grid(x[:, 1:-1]), x[:, -1:]], dim=1)
    tp = int(token_position)
    body = flip_grid(torch.cat([x[:, :tp], x[:, tp + 1:]], dim=1))
    return torch.cat([body[:, :tp], x[:, tp:tp + 1], body[:, tp:]], dim=1)
