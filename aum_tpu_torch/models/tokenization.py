"""Spectrogram patch embedding + learnable absolute position embedding.

Counterpart of ``aum_tpu/models/tokenization.py`` for fixed patch sizes:

- ``patch_grid_shape``: the closed-form valid-conv output grid.
- ``PatchEmbed``: (B, F, T) in, (B, F'*T', D) tokens out, F-major then T
  (the reference's Conv2d(...).flatten(2) order). Written as unfold + one
  matrix product, which keeps it a plain product (no cuDNN, no TF32).
- ``PosEmbed``: stored as (1, n_prefix + F'*T', D) with the cls slot(s) in
  front; the forward adds it to a sequence whose cls token sits at a static
  position (middle, end, front, or the double head/tail pair).
- ``lecun_normal_truncated_`` / ``trunc_normal_02_``: the JAX package's
  initialisers, drawn from an explicit ``torch.Generator``.

Flexible patch sizes (PI-resize) and ``resample_abs_pos_embed`` are not
ported yet.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import nn


def to_2tuple(x) -> Tuple[int, int]:
    if isinstance(x, (tuple, list)):
        return (int(x[0]), int(x[1]))
    return (int(x), int(x))


def patch_grid_shape(strides, patch_size, input_fdim: int,
                     input_tdim: int) -> Tuple[int, int]:
    """Valid-conv output grid (f_dim, t_dim): floor((in - kernel) / stride) + 1."""
    strides = to_2tuple(strides)
    patch_size = to_2tuple(patch_size)
    f = (input_fdim - patch_size[0]) // strides[0] + 1
    t = (input_tdim - patch_size[1]) // strides[1] + 1
    return f, t


def lecun_normal_truncated_(t: torch.Tensor, fan_in: int,
                            generator: torch.Generator) -> torch.Tensor:
    """timm lecun_normal_: normal truncated at +-2 sigma, variance corrected."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator).mul_(std)


def trunc_normal_02_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """timm trunc_normal_(std=.02): N(0, .02) truncated at +-2 (absolute)."""
    return nn.init.trunc_normal_(t, 0.0, 1.0, -100.0, 100.0,
                                 generator=generator).mul_(0.02)


class PatchEmbed(nn.Module):
    """Conv patch projection with decoupled patch size / strides.

    ``proj.weight`` is (D, 1, ph, pw), ``proj.bias`` (D,): the reference's
    Conv2d layout. Parameters are fp32; the forward runs in ``dtype``.
    """

    def __init__(self, patch_size=(16, 16), strides=(16, 16), embed_dim: int = 768):
        super().__init__()
        self.patch_size = to_2tuple(patch_size)
        self.strides = to_2tuple(strides)
        self.proj = nn.Module()
        ph, pw = self.patch_size
        self.proj.weight = nn.Parameter(torch.empty((embed_dim, 1, ph, pw)))
        self.proj.bias = nn.Parameter(torch.empty((embed_dim,)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        ph, pw = self.patch_size
        lecun_normal_truncated_(self.proj.weight, ph * pw, generator)
        nn.init.zeros_(self.proj.bias)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """x: (B, F, T) -> (B, F'*T', D) in ``dtype``."""
        ph, pw = self.patch_size
        sh, sw = self.strides
        patches = x.to(dtype).unfold(1, ph, sh).unfold(2, pw, sw)  # (B, F', T', ph, pw)
        b, f, t = patches.shape[:3]
        w = self.proj.weight.to(dtype).reshape(self.proj.weight.shape[0], ph * pw)
        out = patches.reshape(b, f * t, ph * pw) @ w.t()
        return out + self.proj.bias.to(dtype)


class PosEmbed(nn.Module):
    """Learnable absolute position embedding with the prefix-token layout."""

    def __init__(self, pos_grid_size: Tuple[int, int], embed_dim: int = 768,
                 n_prefix_tokens: int = 1):
        super().__init__()
        gh, gw = pos_grid_size
        self.n_prefix_tokens = n_prefix_tokens
        self.pos_embed = nn.Parameter(
            torch.empty((1, n_prefix_tokens + gh * gw, embed_dim)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        trunc_normal_02_(self.pos_embed, generator)

    def forward(self, x: torch.Tensor,
                token_position: int | Sequence[int] | None = None) -> torch.Tensor:
        pos = self.pos_embed.to(x.dtype)
        npre = self.n_prefix_tokens
        if token_position is None or npre == 0:
            return x + pos
        prefix_pos, grid_pos = pos[:, :npre], pos[:, npre:]
        if isinstance(token_position, (list, tuple)):
            # Double cls: prefix embeddings go to those slots in order.
            parts, cursor, grid_cursor = [], 0, 0
            for i, tp in enumerate(token_position):
                if tp > cursor:
                    parts.append(x[:, cursor:tp]
                                 + grid_pos[:, grid_cursor:grid_cursor + tp - cursor])
                    grid_cursor += tp - cursor
                parts.append(x[:, tp:tp + 1] + prefix_pos[:, i:i + 1])
                cursor = tp + 1
            if cursor < x.shape[1]:
                parts.append(x[:, cursor:] + grid_pos[:, grid_cursor:])
            return torch.cat(parts, dim=1)
        tp = int(token_position)
        return torch.cat([x[:, :tp] + grid_pos[:, :tp],
                          x[:, tp:tp + 1] + prefix_pos,
                          x[:, tp + 1:] + grid_pos[:, tp:]], dim=1)
