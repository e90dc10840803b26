"""Depthwise causal 1D convolution (the Mamba short conv) under autograd:
CUDA kernel + plain form.

Counterpart of ``aum_tpu/ops/conv1d.py::causal_conv1d``. The CUDA kernel
(``csrc/conv1d.cu``) replaces the TPU kernel
``aum_tpu/ops/conv1d.py:_conv_kernel`` at every width, as that takes any k:
widths 1 to ``UNROLLED_WIDTHS`` (8) have one instantiation each, wider ones
a general form with the width a run-time value; the source says what bounds
it on the card (bytes) and what its design does about that.

Semantics: weight (D, K), tap k multiplies ``x[t - (K-1) + k]``; zero halo;
``reverse=True`` is the anti-causal form with mirrored taps (flip -> causal
conv -> flip); then bias and an optional SiLU. Both the kernel and the plain
version sum the taps in fp32 and cast once, as ``_conv_kernel`` does with
``compute_f32``; the kernel's SiLU comes from the card's special-function
unit, a few ulp from the plain version's in fp32. (The JAX package's default
XLA form, ``causal_conv1d_xla``, sums in the input dtype, so in bf16 the two
differ by bf16 rounding.)

The backward mirrors the JAX op's custom VJP (``aum_tpu/ops/conv1d.py``,
``_get_conv_op.bwd``), which is plain ops there too: the cotangent is
chain-ruled through the SiLU at the recomputed pre-activation, dx is the
anti-causal conv of it (``reverse=not reverse``), dw is K shifted fp32
reductions and db an fp32 sum. No new kernel is needed: on CUDA the
pre-activation and dx are launches of the forward kernel (``activation=None``),
the rest plain torch.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises. ``causal_conv1d.launches`` counts launches,
those of the backward included, and ``causal_conv1d.general_launches``
those of them that took the general form (widths past 8).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from aum_tpu_torch.ops import _build


def causal_conv1d_plain(x: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor | None = None,
                        activation: str | None = "silu",
                        reverse: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch: x (B, L, D), weight (D, K)."""
    k = weight.shape[1]
    seqlen = x.shape[1]
    xf = x.float()
    w = weight.float()
    pad = (0, 0, k - 1, 0) if not reverse else (0, 0, 0, k - 1)
    xp = F.pad(xf, pad)
    out = None
    for i in range(k):
        tap = i if not reverse else k - 1 - i
        term = xp[:, i:i + seqlen] * w[:, tap]
        out = term if out is None else out + term
    if bias is not None:
        out = out + bias.float()
    if activation == "silu":
        out = F.silu(out)
    return out.to(x.dtype)


class _ConvArgs(ctypes.Structure):
    """Mirror of ``ConvArgs`` in csrc/conv1d.cu."""

    _fields_ = [("x", ctypes.c_void_p), ("weight", ctypes.c_void_p),
                ("bias", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("x_sb", ctypes.c_longlong), ("x_sl", ctypes.c_longlong),
                ("w_dtype", ctypes.c_int), ("b_dtype", ctypes.c_int)]


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The kernel's channels per thread and steps per tile (kVec, kTileL in
# csrc/conv1d.cu), checked against the library at load: the card's edge
# checks in chip_smoke.py are sized from them. Past UNROLLED_WIDTHS (kMaxK)
# the general form runs, and the wrapper counts its launches apart.
CHANNELS_PER_THREAD = 8
TILE_STEPS = 32
UNROLLED_WIDTHS = 8


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("conv1d")
    fn = lib.aum_causal_conv1d_fwd
    fn.argtypes = [ctypes.POINTER(_ConvArgs)] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.aum_conv_error_string.argtypes = [ctypes.c_int]
    lib.aum_conv_error_string.restype = ctypes.c_char_p
    for fn_name, value in (("aum_conv_channels_per_thread", CHANNELS_PER_THREAD),
                           ("aum_conv_tile_steps", TILE_STEPS),
                           ("aum_conv_unrolled_widths", UNROLLED_WIDTHS)):
        _build.check_constant(lib, fn_name, value)
    return lib


def causal_conv1d_cuda(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor | None = None,
                       activation: str | None = "silu",
                       reverse: bool = False) -> torch.Tensor:
    """Launch the conv kernel. x may be a column slice (channel stride 1)."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the conv kernel takes float32 or bfloat16, not {x.dtype}")
    bsz, seqlen, d = x.shape
    width = weight.shape[-1]
    if weight.dim() != 2 or weight.shape[0] != d or width < 1:
        raise ValueError(f"weight {tuple(weight.shape)} must be (D={d}, K) with K >= 1")
    if bias is not None and tuple(bias.shape) != (d,):
        raise ValueError(f"bias {tuple(bias.shape)} must be ({d},)")
    if x.stride(-1) != 1:
        x = x.contiguous()
    # Taps and bias go in as given, fp32 or bf16 (the kernel converts them
    # exactly); any other dtype as fp32. No launch for the model's own.
    w, b = (None if t is None else
            (t if t.dtype in _DTYPE_CODES else t.float()).to(x.device).contiguous()
            for t in (weight, bias))
    out = torch.empty((bsz, seqlen, d), dtype=x.dtype, device=x.device)
    args = _ConvArgs(x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
                     out.data_ptr(), x.stride(0), x.stride(1), _DTYPE_CODES[w.dtype],
                     _DTYPE_CODES[torch.float32 if b is None else b.dtype])
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = lib.aum_causal_conv1d_fwd(
            ctypes.byref(args), bsz, seqlen, d, width, int(reverse),
            int(activation == "silu"), _DTYPE_CODES[x.dtype], stream)
    _build.check_status(status, lib.aum_conv_error_string, "causal_conv1d kernel launch")
    causal_conv1d.launches += 1
    causal_conv1d.general_launches += width > UNROLLED_WIDTHS
    return out


def _dsilu(pre: torch.Tensor) -> torch.Tensor:
    """d/dp [p * sigmoid(p)] = sig + p*sig*(1-sig)."""
    sig = torch.sigmoid(pre)
    return sig + pre * sig * (1.0 - sig)


def _conv_bwd(conv, x, weight, bias, g, activation, reverse):
    """(dx, dweight, dbias) with ``conv`` computing the convolutions."""
    if activation == "silu":
        pre = conv(x, weight, bias, None, reverse)
        gp = g * _dsilu(pre.float()).to(g.dtype)
    else:
        gp = g
    # The transpose of a causal conv is the anti-causal one with the same
    # taps, and vice versa.
    dx = conv(gp, weight, None, None, not reverse)
    k, seqlen = weight.shape[1], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0) if not reverse else (0, 0, 0, k - 1))
    gpf = gp.float()
    # dw[:, tap(i)] = sum_{b,t} gp[b,t] * xp[b,t+i], fp32 sums of exact products.
    dw = torch.stack([(gpf * xp[:, i:i + seqlen].float()).sum(dim=(0, 1))
                      for i in range(k)], dim=1)
    if reverse:
        dw = dw.flip(1)
    db = None if bias is None else gpf.sum(dim=(0, 1)).to(bias.dtype)
    return dx.to(x.dtype), dw.to(weight.dtype), db


def causal_conv1d_bwd_plain(x, weight, bias, g, activation="silu", reverse=False):
    """The conv backward in plain PyTorch: (dx, dweight, dbias or None)."""
    return _conv_bwd(causal_conv1d_plain, x, weight, bias, g, activation, reverse)


def causal_conv1d_bwd_cuda(x, weight, bias, g, activation="silu", reverse=False):
    """The conv backward on the card: the pre-activation and dx are launches
    of the conv kernel, the SiLU chain rule, dw and db plain torch."""
    return _conv_bwd(causal_conv1d_cuda, x, weight, bias, g, activation, reverse)


def _dispatch(x: torch.Tensor, plain, cuda):
    if x.device.type == "cpu":
        return plain
    if x.device.type != "cuda":
        raise ValueError(f"causal_conv1d runs on cpu or cuda, not {x.device}")
    return cuda


class _CausalConv1d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, activation, reverse):
        ctx.save_for_backward(x, weight, bias)
        ctx.activation, ctx.reverse = activation, reverse
        return _dispatch(x, causal_conv1d_plain, causal_conv1d_cuda)(
            x, weight, bias, activation, reverse)

    @staticmethod
    def backward(ctx, g):
        x, weight, bias = ctx.saved_tensors
        bwd = _dispatch(x, causal_conv1d_bwd_plain, causal_conv1d_bwd_cuda)
        dx, dw, db = bwd(x, weight, bias, g, ctx.activation, ctx.reverse)
        return dx, dw, db, None, None


def causal_conv1d(x: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor | None = None,
                  activation: str | None = "silu",
                  reverse: bool = False) -> torch.Tensor:
    """Depthwise causal conv along the sequence axis (differentiable).

    x: (B, L, D); weight: (D, K); bias: (D,) or None; activation: None |
    "silu"; reverse: anti-causal. Returns (B, L, D) in x's dtype.
    """
    if activation not in (None, "silu"):
        raise ValueError(f"unsupported activation: {activation}")
    tensors = [t for t in (x, weight, bias) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _CausalConv1d.apply(x, weight, bias, activation, reverse)
    return _dispatch(x, causal_conv1d_plain, causal_conv1d_cuda)(
        x, weight, bias, activation, reverse)


causal_conv1d.launches = 0
causal_conv1d.general_launches = 0


def causal_conv1d_update(x: torch.Tensor, conv_state: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor | None = None,
                         activation: str | None = "silu") -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step of the causal conv, plain PyTorch on every device (the
    JAX package's ``causal_conv1d_update`` is no kernel either).

    x: (B, D) new token; conv_state: (B, D, K) the previous inputs, oldest
    first; weight: (D, K). The window rolls left by one and takes x last, then
    the taps, the bias and an optional SiLU. Returns (y (B, D), the new
    (B, D, K) state).
    """
    conv_state = torch.cat([conv_state[:, :, 1:], x[:, :, None]], dim=2)
    y = torch.einsum("bdk,dk->bd", conv_state, weight)
    if bias is not None:
        y = y + bias[None, :]
    if activation == "silu":
        y = F.silu(y)
    return y, conv_state
