"""Where the reference rounds: nowhere (fp32), or to a lower precision.

The reference computes in fp32 with TF32 off. Its control computes the same
graph with every tensor that the configuration keeps in its compute dtype
(bf16 here: the weights at their use, every product's inputs and output, the
conv's and the scan's outputs) rounded to the next precision below, fp8
(e4m3, with one scale per tensor, as fp8 inference and training scale
them). In a backward the rounding also applies to the incoming gradient.
"""

from __future__ import annotations

import torch

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 under a per-tensor scale (amax to FP8_MAX), in fp32."""
    x = x.float()
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (x / scale).to(FP8).float() * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return fp8_round(x)

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g)


def rounding(precision: str):
    """The rounding applied at the compute dtype's points: 'fp32' none,
    'fp8' the control's."""
    if precision == "fp32":
        return lambda x: x.float()
    if precision == "fp8":
        return _Fp8.apply
    raise ValueError(f"unknown precision {precision!r}")


def set_exact_fp32() -> None:
    """Products in full fp32 on the card: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
