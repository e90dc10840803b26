"""Fused bidirectional selective scan (eval forward): CUDA kernel + plain form.

Counterpart of ``aum_tpu/ops/selective_scan.py::selective_scan_dual``. The
CUDA kernel (``csrc/selective_scan.cu``) replaces the TPU kernel
``aum_tpu/ops/selective_scan.py:_fwd_kernel_dual`` in its default
configuration (fused y-readout, per-step decay, no saved chunk states); the
source says what bounds it on the card and what its design does about that.

The ``_prep`` contract of the JAX op is kept: ``dt = softplus(delta + bias)``
is computed outside the kernel in fp32 and cast to delta's dtype, and the
kernel streams that pre-activated, rounded dt. Layout stays (B, L, D).

On a CPU tensor the wrapper runs the plain PyTorch version, the sequential
oracle of ``ops/scan_ref.py`` per direction; on a CUDA tensor it launches the
kernel or raises. ``selective_scan_dual.launches`` counts kernel launches (it is
raised where the kernel is launched, in ``selective_scan_dual_cuda``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from aum_tpu_torch.ops import _build
from aum_tpu_torch.ops.scan_ref import selective_scan_ref

MAX_D_STATE = 16


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # The JAX op's primitives-only form, so dt rounds identically to bf16.
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _prep_dt(delta: torch.Tensor, delta_bias: torch.Tensor | None) -> torch.Tensor:
    dt = delta.float()
    if delta_bias is not None:
        dt = dt + delta_bias.float()
    return _softplus(dt).to(delta.dtype)


def selective_scan_dual_plain(fwd: tuple, rev: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: the sequential oracle per direction.

    fwd / rev: (u, dt, A, B, C, D, z) with dt already activated, as
    ``selective_scan_dual_cuda`` takes them. The oracle uses exp where the
    kernel uses exp2 with log2 e folded in: the two differ by fp32 rounding.
    """
    return (selective_scan_ref(*fwd[:6], z=fwd[6], reverse=False),
            selective_scan_ref(*rev[:6], z=rev[6], reverse=True))


class _ScanDir(ctypes.Structure):
    """Mirror of ``ScanDir`` in csrc/selective_scan.cu."""

    _fields_ = [(name, ctypes.c_void_p) for name in
                ("u", "dt", "z", "B", "C", "A", "Dskip", "out")] + [
        (name, ctypes.c_longlong) for name in
        ("u_sb", "u_sl", "dt_sb", "dt_sl", "z_sb", "z_sl",
         "B_sb", "B_sl", "C_sb", "C_sl")]


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _channel_contiguous(t: torch.Tensor) -> torch.Tensor:
    """The kernel takes any batch/length strides but needs channel stride 1;
    a tensor without it is copied."""
    return t if t.stride(-1) == 1 else t.contiguous()


def _scan_dir_args(u, dt, A, B, C, D, z):
    bsz, seqlen, d = u.shape
    n = A.shape[1]
    dtype = u.dtype
    for name, t, shape in (("dt", dt, (bsz, seqlen, d)), ("z", z, (bsz, seqlen, d)),
                           ("B", B, (bsz, seqlen, n)), ("C", C, (bsz, seqlen, n))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype} but u is {dtype}; the kernel "
                            "takes one stream dtype")
        if t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, u on {u.device}")
    if tuple(A.shape) != (d, n) or tuple(D.shape) != (d,):
        raise ValueError(f"A {tuple(A.shape)} / D {tuple(D.shape)} do not match "
                         f"D={d}, N={n}")
    if n > MAX_D_STATE:
        raise ValueError(f"d_state {n} > {MAX_D_STATE} is not supported by the kernel")
    u, dt, z, B, C = (_channel_contiguous(t) for t in (u, dt, z, B, C))
    A = A.to(device=u.device, dtype=torch.float32).contiguous()
    D = D.to(device=u.device, dtype=torch.float32).contiguous()
    out = torch.empty((bsz, seqlen, d), dtype=dtype, device=u.device)
    args = _ScanDir(
        u.data_ptr(), dt.data_ptr(), z.data_ptr(), B.data_ptr(), C.data_ptr(),
        A.data_ptr(), D.data_ptr(), out.data_ptr(),
        u.stride(0), u.stride(1), dt.stride(0), dt.stride(1),
        z.stride(0), z.stride(1), B.stride(0), B.stride(1),
        C.stride(0), C.stride(1))
    # Keep every buffer alive until the launch is enqueued.
    return args, out, (u, dt, z, B, C, A, D)


def selective_scan_dual_cuda(fwd: tuple, rev: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the dual-scan kernel on (u, dt, A, B, C, D, z) per direction."""
    u = fwd[0]
    if u.dtype not in _DTYPE_CODES:
        raise TypeError(f"the scan kernel takes float32 or bfloat16, not {u.dtype}")
    if rev[0].shape != u.shape or rev[0].dtype != u.dtype or rev[0].device != u.device:
        raise ValueError("both directions must share shape, dtype and device")
    args_f, out_f, keep_f = _scan_dir_args(*fwd)
    args_r, out_r, keep_r = _scan_dir_args(*rev)
    lib = _lib()
    bsz, seqlen, d = u.shape
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        status = lib.aum_selective_scan_dual_fwd(
            ctypes.byref(args_f), ctypes.byref(args_r), bsz, seqlen, d,
            fwd[2].shape[1], _DTYPE_CODES[u.dtype], stream)
    del keep_f, keep_r
    _build.check_status(status, lib.aum_scan_error_string,
                        "selective_scan_dual kernel launch")
    selective_scan_dual.launches += 1
    return out_f, out_r


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("selective_scan")
    fn = lib.aum_selective_scan_dual_fwd
    fn.argtypes = [ctypes.POINTER(_ScanDir), ctypes.POINTER(_ScanDir),
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.aum_scan_error_string.argtypes = [ctypes.c_int]
    lib.aum_scan_error_string.restype = ctypes.c_char_p
    return lib


def selective_scan_dual(args_fwd: tuple, args_rev: tuple
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused bidirectional selective scan.

    args_fwd / args_rev: (u, delta, A, B, C, D, z, delta_bias) for the
    forward-scanning and the reverse-scanning direction (bimamba v1 passes
    the same tensors in both, with its own A). delta is pre-softplus; D and
    z are required, as in the JAX kernel path. Returns (y_fwd, y_rev); the
    caller sums them.
    """
    uf, df, af, bf, cf, dskf, zf, biasf = args_fwd
    ur, dr, ar, br, cr, dskr, zr, biasr = args_rev
    dt_f = _prep_dt(df, biasf)
    # Bimamba v1 shares delta and bias: one softplus pass and one dt stream.
    dt_r = dt_f if (dr is df and biasr is biasf) else _prep_dt(dr, biasr)
    fwd = (uf, dt_f, af, bf, cf, dskf, zf)
    rev = (ur, dt_r, ar, br, cr, dskr, zr)
    if uf.device.type == "cpu":
        return selective_scan_dual_plain(fwd, rev)
    if uf.device.type != "cuda":
        raise ValueError(f"selective_scan_dual runs on cpu or cuda, not {uf.device}")
    return selective_scan_dual_cuda(fwd, rev)


selective_scan_dual.launches = 0
