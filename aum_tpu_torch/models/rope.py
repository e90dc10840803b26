"""2D axial rotary position embedding (an optional AuM feature, off in every
published configuration).

Counterpart of ``aum_tpu/models/rope.py``: per-axis rotary frequencies over
the (F', T') patch grid, concatenated to cover the embedding dim, applied as
x*cos + rotate_half(x)*sin to the tokens after the first ``n_prefix``.

As in the JAX package (and the reference it follows), the prefix is taken
to be the *first* ``n_prefix`` tokens whatever the cls position, and with a
sequence flip RoPE is applied to the flipped order.

``interp_to_grid`` resamples a rope buffer bilinearly to another grid (the
reference's interpolation on checkpoint load).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from aum_tpu_torch.models.tokenization import resize_matrix


@lru_cache(maxsize=8)
def rope_freqs_2d(dim: int, pt_seq_len: Tuple[int, int], ft_seq_len: Tuple[int, int],
                  theta: float = 10000.0) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) float32 buffers of shape (F'*T', 2 * dim rounded down to
    even). ``dim`` is the per-axis rotary dim (embed_dim // 2 in AuM)."""
    half = dim // 2
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2)[:half] / dim))
    th = np.arange(ft_seq_len[0]) / ft_seq_len[0] * pt_seq_len[0]
    tw = np.arange(ft_seq_len[1]) / ft_seq_len[1] * pt_seq_len[1]
    fh = np.repeat(th[:, None] * freqs[None, :], 2, axis=-1)  # (F', dim)
    fw = np.repeat(tw[:, None] * freqs[None, :], 2, axis=-1)  # (T', dim)
    full = np.concatenate([
        np.broadcast_to(fh[:, None, :], (len(th), len(tw), fh.shape[-1])),
        np.broadcast_to(fw[None, :, :], (len(th), len(tw), fw.shape[-1])),
    ], axis=-1).reshape(len(th) * len(tw), -1)
    return np.cos(full).astype(np.float32), np.sin(full).astype(np.float32)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """(..., 2k) -> interleaved (-x2, x1) pairs."""
    x = x.reshape(*x.shape[:-1], -1, 2)
    return torch.stack([-x[..., 1], x[..., 0]], dim=-1).flatten(-2)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               num_prefix_tokens: int = 1) -> torch.Tensor:
    """x: (B, P + N, D); rotates the last N tokens' first cos.shape[-1]
    channels, in x's dtype (cos and sin are cast to it)."""
    p = num_prefix_tokens
    spatial = x[:, p:]
    d = cos.shape[-1]
    cos, sin = cos.to(x.dtype), sin.to(x.dtype)
    rotated = spatial[..., :d] * cos + rotate_half(spatial[..., :d]) * sin
    if d < spatial.shape[-1]:
        rotated = torch.cat([rotated, spatial[..., d:]], dim=-1)
    return torch.cat([x[:, :p], rotated], dim=1)


def interp_to_grid(buf: np.ndarray, old_grid: Tuple[int, int],
                   new_grid: Tuple[int, int]) -> np.ndarray:
    """Bilinearly resample a (old_f*old_t, D) rope buffer to a new grid."""
    mat = resize_matrix(old_grid, new_grid)
    return (mat @ buf.reshape(old_grid[0] * old_grid[1], -1)).astype(buf.dtype)
