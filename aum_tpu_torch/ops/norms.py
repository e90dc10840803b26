"""Fused residual-add + RMSNorm/LayerNorm with an fp32 residual stream.

Counterpart of ``aum_tpu/ops/norms.py``; plain PyTorch on every device, as
the JAX package leaves it to XLA. The numerics contract is kept:

- the residual is summed in fp32, always (the JAX op's default
  ``residual_in_fp32=True``; the port has no other setting),
- the norm is computed in fp32,
- the normalised output is cast to the weight's dtype.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in fp32, output cast to weight dtype. x: (..., D), weight: (D,)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(weight.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor | None, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in fp32, output cast to weight dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(weight.dtype)


def fused_add_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    residual: torch.Tensor | None = None,
    prenorm: bool = True,
    eps: float = 1e-5,
    norm_type: str = "rms",
):
    """residual' = residual + x (fp32); y = Norm(residual').

    Returns (y, residual') if prenorm else y.
    """
    res = (x if residual is None else residual + x).float()
    if norm_type == "rms":
        y = rms_norm(res, weight, eps)
    elif norm_type == "layer":
        y = layer_norm(res, weight, bias, eps)
    else:
        raise ValueError(f"unknown norm_type: {norm_type}")
    if prenorm:
        return y, res
    return y
