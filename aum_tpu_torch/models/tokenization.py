"""Spectrogram patch embedding + learnable absolute position embedding,
with flexible patch sizes.

Counterpart of ``aum_tpu/models/tokenization.py``:

- ``patch_grid_shape``: the closed-form valid-conv output grid.
- ``resize_matrix`` / ``resize_matrix_pinv``: the bilinear resize
  (``F.interpolate``'s align_corners=False, no antialias) as a matrix in
  float64 numpy, and the pseudo-inverse of its transpose (big_vision's
  PI-resize); ``resample_patch_embed`` (PI-resize),
  ``vanilla_resample_patch_embed`` (plain bilinear) and
  ``resample_abs_pos_embed`` apply them in fp32 as one matrix product.
- ``PatchEmbed``: (B, F, T) in, (B, F'*T', D) tokens out, F-major then T
  (the reference's Conv2d(...).flatten(2) order). Written as unfold + one
  matrix product, which keeps it a plain product (no cuDNN, no TF32). A
  run-time ``patch_size`` PI-resizes the stored kernel, and ``strides``
  override the stored ones.
- ``PosEmbed``: stored as (1, n_prefix + F'*T', D) with the cls slot(s) in
  front; the forward adds it to a sequence whose cls token sits at a static
  position (middle, end, front, the double head/tail pair, or a drawn one),
  bilinearly resampled to a run-time grid.
- ``lecun_normal_truncated_`` / ``trunc_normal_02_``: the JAX package's
  initialisers, drawn from an explicit ``torch.Generator``.

The matrices are built once per (old, new) size and cached, with their
fp32 copy on each device they are used on.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np
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


def _bilinear_resize_matrix_1d(old: int, new: int) -> np.ndarray:
    """(new, old) matrix M with (M @ x) the bilinear resize of x:
    source coordinate s = (d + 0.5) * old/new - 0.5, clamped, a linear blend
    of floor and ceil."""
    m = np.zeros((new, old), dtype=np.float64)
    scale = old / new
    for d in range(new):
        s = (d + 0.5) * scale - 0.5
        s = min(max(s, 0.0), old - 1.0)
        lo = int(math.floor(s))
        hi = min(lo + 1, old - 1)
        w = s - lo
        m[d, lo] += 1.0 - w
        m[d, hi] += w
    return m


def resize_matrix(old_size: Sequence[int], new_size: Sequence[int]) -> np.ndarray:
    """(new_h*new_w, old_h*old_w) separable bilinear resize matrix, float64."""
    return _resize_matrix(to_2tuple(old_size), to_2tuple(new_size)).copy()


def resize_matrix_pinv(old_size: Sequence[int], new_size: Sequence[int]) -> np.ndarray:
    """pinv of the resize matrix's transpose, (new_h*new_w, old_h*old_w),
    float64: big_vision's PI-resize."""
    return _resize_matrix_pinv(to_2tuple(old_size), to_2tuple(new_size)).copy()


@functools.lru_cache(maxsize=32)
def _resize_matrix(old: Tuple[int, int], new: Tuple[int, int]) -> np.ndarray:
    return np.kron(_bilinear_resize_matrix_1d(old[0], new[0]),
                   _bilinear_resize_matrix_1d(old[1], new[1]))


@functools.lru_cache(maxsize=32)
def _resize_matrix_pinv(old: Tuple[int, int], new: Tuple[int, int]) -> np.ndarray:
    if old == new:
        return np.eye(old[0] * old[1])
    return np.linalg.pinv(_resize_matrix(old, new).T)


@functools.lru_cache(maxsize=64)
def _on_device(which: str, old: Tuple[int, int], new: Tuple[int, int],
               device: torch.device) -> torch.Tensor:
    """The fp32 copy of a cached matrix on ``device``."""
    mat = (_resize_matrix_pinv if which == "pinv" else _resize_matrix)(old, new)
    return torch.from_numpy(mat.astype(np.float32)).to(device)


def _resize_kernel(kernel: torch.Tensor, new_size, which: str) -> torch.Tensor:
    d, cin, kh, kw = kernel.shape
    new_size = to_2tuple(new_size)
    if (kh, kw) == new_size:
        return kernel
    mat = _on_device(which, (kh, kw), new_size, kernel.device)  # (new, old)
    flat = kernel.reshape(d * cin, kh * kw).float()
    out = flat @ mat.t()
    return out.reshape(d, cin, *new_size).to(kernel.dtype)


def resample_patch_embed(kernel: torch.Tensor, new_size) -> torch.Tensor:
    """PI-resize a patch-projection kernel (D, in_ch, kh, kw) -> (D, in_ch,
    nh, nw), in fp32, returned in the kernel's dtype."""
    return _resize_kernel(kernel, new_size, "pinv")


def vanilla_resample_patch_embed(kernel: torch.Tensor, new_size) -> torch.Tensor:
    """Plain bilinear resize of a patch-projection kernel (D, in_ch, kh, kw)."""
    return _resize_kernel(kernel, new_size, "resize")


def resample_abs_pos_embed(posemb: torch.Tensor, new_size, old_size,
                           num_prefix_tokens: int = 1) -> torch.Tensor:
    """Bilinearly resample a (1, prefix + oh*ow, D) pos embedding to the grid
    ``new_size``, in fp32; the prefix slots are kept as they are."""
    new_size, old_size = to_2tuple(new_size), to_2tuple(old_size)
    if new_size == old_size:
        return posemb
    prefix, grid = posemb[:, :num_prefix_tokens], posemb[:, num_prefix_tokens:]
    mat = _on_device("resize", old_size, new_size, posemb.device)
    out = (mat @ grid[0].float()).to(posemb.dtype)[None]
    return torch.cat([prefix, out], dim=1)


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

    def forward(self, x: torch.Tensor, dtype: torch.dtype, patch_size=None,
                strides=None) -> torch.Tensor:
        """x: (B, F, T) -> (B, F'*T', D) in ``dtype``. A run-time
        ``patch_size`` PI-resizes the kernel (in fp32, then cast);
        ``strides`` default to the stored ones."""
        weight = self.proj.weight
        ph, pw = self.patch_size
        if patch_size is not None and to_2tuple(patch_size) != (ph, pw):
            ph, pw = to_2tuple(patch_size)
            weight = resample_patch_embed(weight, (ph, pw))
        sh, sw = to_2tuple(strides) if strides is not None else self.strides
        patches = x.to(dtype).unfold(1, ph, sh).unfold(2, pw, sw)  # (B, F', T', ph, pw)
        b, f, t = patches.shape[:3]
        w = weight.to(dtype).reshape(weight.shape[0], ph * pw)
        out = patches.reshape(b, f * t, ph * pw) @ w.t()
        return out + self.proj.bias.to(dtype)


class PosEmbed(nn.Module):
    """Learnable absolute position embedding with the prefix-token layout."""

    def __init__(self, pos_grid_size: Tuple[int, int], embed_dim: int = 768,
                 n_prefix_tokens: int = 1):
        super().__init__()
        gh, gw = pos_grid_size
        self.grid_size = (gh, gw)
        self.n_prefix_tokens = n_prefix_tokens
        self.pos_embed = nn.Parameter(
            torch.empty((1, n_prefix_tokens + gh * gw, embed_dim)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        trunc_normal_02_(self.pos_embed, generator)

    def forward(self, x: torch.Tensor,
                token_position: int | Sequence[int] | None = None,
                run_grid_size: Tuple[int, int] | None = None) -> torch.Tensor:
        pos = self.pos_embed
        if run_grid_size is not None:
            pos = resample_abs_pos_embed(pos, run_grid_size, self.grid_size,
                                         self.n_prefix_tokens)
        pos = pos.to(x.dtype)
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
