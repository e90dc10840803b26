"""AST (Audio Spectrogram Transformer), the baseline beside AuM.

Counterpart of ``aum_tpu/models/ast.py``, a rebuild of the reference's AST
wrapper around a timm DeiT: a pre-LN ViT encoder over spectrogram patches.

- The patch conv runs on the (B, F, T) spectrogram with decoupled strides
  (fstride, tstride), valid padding, flattened F-major (``PatchEmbed``: one
  matrix product over the unfolded patches).
- A cls token (and, ``distilled``, a dist token) goes in front, then the
  absolute position embedding is added.
- ``depth`` blocks: x + attn(LN(x)), then x + fc2(gelu(fc1(LN(x)))). The
  GELU is flax's default, the tanh approximation; every LayerNorm has
  flax's eps 1e-6 and takes its statistics in fp32.
- The readout is the cls token, or the mean of cls and dist, then the
  ``mlp_head``: LayerNorm, then Linear.

The module tree is the reference AST audio checkpoint's state-dict layout
(the DeiT under ``v.``, the head under ``mlp_head.``), so the checkpoint
porters (``convert/ast_port.py``) are key surgery. The attention's fused
``qkv`` (3D, D) computes what flax's per-head query, key and value kernels
compute; the query scale 1/sqrt(Dh) is ``F.scaled_dot_product_attention``'s
default. The JAX package computes attention with flax's
``MultiHeadDotProductAttention`` (XLA, no Pallas kernel), so there is no
hand-written kernel on this path. Parameters are fp32, drawn on the CPU from
an explicit ``torch.Generator`` with the JAX initialisers' distributions;
the compute runs in ``config.dtype``. The encoder is deterministic: the
reference's timm drop rates are all 0.

Sizes (``run.build_model``): deit_base is 12 layers, 768 wide, 12 heads;
deit_small 12 layers, 384 wide, 6 heads.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from aum_tpu_torch.models.mamba import _Weights
from aum_tpu_torch.models.tokenization import (
    PatchEmbed,
    lecun_normal_truncated_,
    patch_grid_shape,
    resize_matrix,
    trunc_normal_02_,
)
from aum_tpu_torch.utils import resolve_device

LN_EPS = 1e-6  # flax.linen.LayerNorm's default


@dataclasses.dataclass(frozen=True)
class ASTConfig:
    label_dim: int = 527
    fstride: int = 10
    tstride: int = 10
    input_fdim: int = 128
    input_tdim: int = 1024
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    distilled: bool = False
    dtype: str = "float32"

    @property
    def patch_grid(self) -> Tuple[int, int]:
        return patch_grid_shape((self.fstride, self.tstride),
                                (self.patch_size, self.patch_size),
                                self.input_fdim, self.input_tdim)

    @property
    def num_prefix(self) -> int:
        return 2 if self.distilled else 1

    @staticmethod
    def from_model_name(model_name: str, **kw) -> "ASTConfig":
        """deit_{base,small}[_distilled]_patch16_N -> its sizes."""
        if "small" in model_name:
            kw.setdefault("embed_dim", 384)
            kw.setdefault("num_heads", 6)
        kw.setdefault("distilled", "distilled" in model_name)
        return ASTConfig(**kw)


class _LayerNorm(_Weights):
    def __init__(self, dim: int):
        super().__init__((dim,), (dim,))

    def reset_parameters(self) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return F.layer_norm(x.float(), x.shape[-1:], self.weight, self.bias, LN_EPS).to(dtype)


def _linear(layer: _Weights, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x, layer.weight.to(dtype), layer.bias.to(dtype))


def _lecun_(layer: _Weights, fan_in: int, generator: torch.Generator) -> None:
    lecun_normal_truncated_(layer.weight, fan_in, generator)
    nn.init.zeros_(layer.bias)


class TransformerBlock(nn.Module):
    """Pre-LN encoder block: ``norm1``, ``attn`` (``qkv``, ``proj``),
    ``norm2``, ``mlp`` (``fc1``, ``fc2``)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"width {dim} is not a multiple of {num_heads} heads")
        self.num_heads = num_heads
        hidden = int(dim * mlp_ratio)
        self.norm1 = _LayerNorm(dim)
        self.attn = nn.Module()
        self.attn.qkv = _Weights((3 * dim, dim), (3 * dim,))
        self.attn.proj = _Weights((dim, dim), (dim,))
        self.norm2 = _LayerNorm(dim)
        self.mlp = nn.Module()
        self.mlp.fc1 = _Weights((hidden, dim), (hidden,))
        self.mlp.fc2 = _Weights((dim, hidden), (dim,))

    def reset_parameters(self, generator: torch.Generator) -> None:
        dim = self.attn.proj.weight.shape[0]
        self.norm1.reset_parameters()
        self.norm2.reset_parameters()
        _lecun_(self.attn.qkv, dim, generator)  # q, k and v: fan-in D each
        _lecun_(self.attn.proj, dim, generator)
        _lecun_(self.mlp.fc1, dim, generator)
        _lecun_(self.mlp.fc2, self.mlp.fc2.weight.shape[1], generator)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        b, n, d = x.shape
        h = self.norm1(x, dtype)
        q, k, v = _linear(self.attn.qkv, h, dtype).view(
            b, n, 3, self.num_heads, d // self.num_heads).permute(2, 0, 3, 1, 4)
        h = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(b, n, d)
        x = x + _linear(self.attn.proj, h, dtype)
        h = F.gelu(_linear(self.mlp.fc1, self.norm2(x, dtype), dtype), approximate="tanh")
        return x + _linear(self.mlp.fc2, h, dtype)


class ASTModel(nn.Module):
    """(B, T, F) log-mel -> (B, label_dim) logits."""

    def __init__(self, config: ASTConfig, device: str | torch.device | None = None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        cfg = self.config = config
        self.dtype = getattr(torch, cfg.dtype, None)
        if not isinstance(self.dtype, torch.dtype):
            raise ValueError(f"unknown dtype: {cfg.dtype}")
        d = cfg.embed_dim
        f, t = cfg.patch_grid
        self.v = nn.Module()
        self.v.patch_embed = PatchEmbed(cfg.patch_size, (cfg.fstride, cfg.tstride), d)
        self.v.cls_token = nn.Parameter(torch.empty((1, 1, d)))
        if cfg.distilled:
            self.v.dist_token = nn.Parameter(torch.empty((1, 1, d)))
        self.v.pos_embed = nn.Parameter(torch.empty((1, cfg.num_prefix + f * t, d)))
        self.v.blocks = nn.ModuleList([TransformerBlock(d, cfg.num_heads, cfg.mlp_ratio)
                                       for _ in range(cfg.depth)])
        self.v.norm = _LayerNorm(d)
        self.mlp_head = nn.ModuleList([_LayerNorm(d), _Weights((cfg.label_dim, d),
                                                               (cfg.label_dim,))])
        self.reset_parameters(torch.Generator().manual_seed(seed))
        self.to(device)
        self.eval()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        v = self.v
        trunc_normal_02_(v.patch_embed.proj.weight, generator)
        nn.init.zeros_(v.patch_embed.proj.bias)
        trunc_normal_02_(v.cls_token, generator)
        if self.config.distilled:
            trunc_normal_02_(v.dist_token, generator)
        trunc_normal_02_(v.pos_embed, generator)
        for block in v.blocks:
            block.reset_parameters(generator)
        v.norm.reset_parameters()
        self.mlp_head[0].reset_parameters()
        trunc_normal_02_(self.mlp_head[1].weight, generator)
        nn.init.zeros_(self.mlp_head[1].bias)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``train`` and ``generator`` are the train step's interface; the
        encoder draws nothing."""
        del train, generator
        cfg, dtype, v = self.config, self.dtype, self.v
        b = x.shape[0]
        tokens = v.patch_embed(x.transpose(1, 2), dtype)  # (B, F'*T', D), F-major
        prefix = [v.cls_token.to(dtype).expand(b, -1, -1)]
        if cfg.distilled:
            prefix.append(v.dist_token.to(dtype).expand(b, -1, -1))
        seq = torch.cat(prefix + [tokens], dim=1) + v.pos_embed.to(dtype)
        for block in v.blocks:
            seq = block(seq, dtype)
        seq = v.norm(seq, dtype)
        feats = (seq[:, 0] + seq[:, 1]) / 2 if cfg.distilled else seq[:, 0]
        return _linear(self.mlp_head[1], self.mlp_head[0](feats, dtype), dtype)


def retarget_pos_embed(pos: np.ndarray, old_grid: Tuple[int, int],
                       new_grid: Tuple[int, int], num_prefix: int) -> np.ndarray:
    """AST pos-embed retargeting, in numpy as the JAX package does it (the
    interpolated grid comes out in float64). Per axis: centre-crop when the
    new grid is smaller, bilinear interpolation when larger.
    pos: (1, prefix + oh*ow, D)."""
    prefix, grid = pos[:, :num_prefix], pos[:, num_prefix:]
    d = grid.shape[-1]
    g = grid.reshape(old_grid[0], old_grid[1], d)
    if new_grid[1] <= old_grid[1]:  # time axis
        start = old_grid[1] // 2 - new_grid[1] // 2
        g = g[:, start:start + new_grid[1]]
    else:
        m = resize_matrix((1, old_grid[1]), (1, new_grid[1]))
        g = np.einsum("to,fod->ftd", m.reshape(new_grid[1], old_grid[1]), g)
    if new_grid[0] <= old_grid[0]:  # frequency axis
        start = old_grid[0] // 2 - new_grid[0] // 2
        g = g[start:start + new_grid[0]]
    else:
        m = resize_matrix((old_grid[0], 1), (new_grid[0], 1))
        g = np.einsum("fo,otd->ftd", m.reshape(new_grid[0], old_grid[0]), g)
    out = g.reshape(1, new_grid[0] * new_grid[1], d)
    return np.concatenate([prefix, out], axis=1)
