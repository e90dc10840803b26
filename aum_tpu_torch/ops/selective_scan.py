"""Fused bidirectional selective scan under autograd: CUDA kernels + plain forms.

Counterpart of ``aum_tpu/ops/selective_scan.py::selective_scan_dual`` and its
custom VJP (``_make_dual_scan``, ``_dual_bwd_impl``). Two CUDA kernels:

- ``csrc/selective_scan.cu`` replaces the TPU kernel ``_fwd_kernel_dual`` in
  its default configuration (fused y-readout, per-step decay). In eval it
  writes the outputs only; when a grad is needed it also saves the state at
  the entry of every chunk of ``STATE_CHUNK`` steps (``save_states``).
- ``csrc/selective_scan_bwd.cu`` replaces ``_bwd_kernel`` (dla mode
  "xprev", no carried-in state): it restarts each chunk from its saved state
  and runs the adjoint. One launch takes one or both directions, so launched
  with both it is also the counterpart of ``_bwd_kernel_dual``.

The sources say what bounds each kernel on the card and what its design does
about that.

The ``_prep`` contract of the JAX op is kept: ``dt = softplus(delta + bias)``
is computed outside the kernels in fp32 and cast to delta's dtype, and the
kernels stream that rounded dt. The backward chain-rules ddelta from dt
alone, ``ddt * (1 - exp(-dt))``, writes it in dt's dtype and sums dbias in
fp32 from the value before that cast. Layout stays (B, L, D).

On CPU tensors every wrapper runs its plain PyTorch version (the sequential
oracle of ``ops/scan_ref.py``; the plain backward recomputes through it under
autograd); on CUDA tensors it launches its kernel or raises. Launch counts:
``selective_scan_dual.launches`` (every forward launch),
``selective_scan_dual.save_states_launches`` (those that saved states) and
``selective_scan_bwd.launches``, each raised where the kernel is launched.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from aum_tpu_torch.ops import _build
from aum_tpu_torch.ops.scan_ref import selective_scan_ref

MAX_D_STATE = 16
STATE_CHUNK = 64  # kChunk of both kernels: the interval of the saved states
BWD_BLOCK_CHANNELS = 32  # channels per block of the backward: one dB/dC partial row each


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # The JAX op's primitives-only form, so dt rounds identically to bf16.
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _prep_dt(delta: torch.Tensor, delta_bias: torch.Tensor | None) -> torch.Tensor:
    dt = delta.float()
    if delta_bias is not None:
        dt = dt + delta_bias.float()
    return _softplus(dt).to(delta.dtype)


# --- plain versions ----------------------------------------------------------

def selective_scan_dual_plain(fwd: tuple, rev: tuple, save_states: bool = False):
    """The forward kernel's function in plain PyTorch: the oracle per direction.

    fwd / rev: (u, dt, A, B, C, D, z) with dt already activated, as
    ``selective_scan_dual_cuda`` takes them. Returns (y_fwd, y_rev), and with
    ``save_states`` also (xb_fwd, xb_rev), each (B, ceil(L / STATE_CHUNK), N,
    D) fp32. The oracle uses exp where the kernel uses exp2 with log2 e
    folded in: the two differ by fp32 rounding.
    """
    every = STATE_CHUNK if save_states else 0
    out_f = selective_scan_ref(*fwd[:6], z=fwd[6], reverse=False, save_every=every)
    out_r = selective_scan_ref(*rev[:6], z=rev[6], reverse=True, save_every=every)
    if save_states:
        return out_f[0], out_r[0], out_f[1], out_r[1]
    return out_f, out_r


def selective_scan_bwd_plain(dirs: list, gs: list) -> list:
    """The backward kernel's function in plain PyTorch.

    dirs: per direction (u, dt, A, B, C, D, z, reverse); gs: the cotangent of
    each direction's output. Recomputes the oracle in fp32 under autograd and
    returns per direction (du, ddelta, dA, dB, dC, dD, dz, dbias): ddelta =
    ddt * (1 - exp(-dt)) in dt's dtype, dbias its fp32 sum taken before that
    cast, dA, dD fp32, the rest in their input's dtype.
    """
    grads = []
    for (u, dt, A, B, C, D, z, reverse), g in zip(dirs, gs):
        with torch.enable_grad():
            leaves = [t.detach().float().requires_grad_() for t in (u, dt, A, B, C, D, z)]
            y = selective_scan_ref(*leaves[:6], z=leaves[6], reverse=reverse)
            du, ddt, dA, dB, dC, dD, dz = torch.autograd.grad(y, leaves, g.float())
        ddelta = ddt * (1.0 - torch.exp(-dt.float()))  # sigmoid(delta + bias)
        grads.append((du.to(u.dtype), ddelta.to(dt.dtype), dA, dB.to(B.dtype),
                      dC.to(C.dtype), dD, dz.to(z.dtype), ddelta.sum(dim=(0, 1))))
    return grads


# --- CUDA kernels --------------------------------------------------------------

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_STREAM_STRIDES = ("u_sb", "u_sl", "dt_sb", "dt_sl", "z_sb", "z_sl",
                   "B_sb", "B_sl", "C_sb", "C_sl")


class _ScanDir(ctypes.Structure):
    """Mirror of ``ScanDir`` in csrc/selective_scan.cu."""

    _fields_ = [(name, ctypes.c_void_p) for name in
                ("u", "dt", "z", "B", "C", "A", "Dskip", "out", "xb")] + [
        (name, ctypes.c_longlong) for name in _STREAM_STRIDES]


class _ScanBwdDir(ctypes.Structure):
    """Mirror of ``ScanBwdDir`` in csrc/selective_scan_bwd.cu."""

    _fields_ = [(name, ctypes.c_void_p) for name in
                ("u", "dt", "z", "B", "C", "A", "Dskip", "g", "xb", "du", "ddelta",
                 "dz", "dA_part", "dD_part", "dbias_part", "dbc_part")] + [
        (name, ctypes.c_longlong) for name in _STREAM_STRIDES + ("g_sb", "g_sl")] + [
        ("reverse", ctypes.c_int)]


class _ScanBwdArgs(ctypes.Structure):
    _fields_ = [("dir", _ScanBwdDir * 2)]


def _channel_contiguous(t: torch.Tensor) -> torch.Tensor:
    """The kernels take any batch/length strides but need channel stride 1;
    a tensor without it is copied."""
    return t if t.stride(-1) == 1 else t.contiguous()


def _check_dir(u, dt, A, B, C, D, z):
    """Validate one direction's operands for a kernel; returns them with
    channel stride 1 and A, D as contiguous fp32 on u's device."""
    bsz, seqlen, d = u.shape
    n = A.shape[1]
    if u.dtype not in _DTYPE_CODES:
        raise TypeError(f"the scan kernels take float32 or bfloat16, not {u.dtype}")
    for name, t, shape in (("dt", dt, (bsz, seqlen, d)), ("z", z, (bsz, seqlen, d)),
                           ("B", B, (bsz, seqlen, n)), ("C", C, (bsz, seqlen, n))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != u.dtype:
            raise TypeError(f"{name} is {t.dtype} but u is {u.dtype}; the kernels "
                            "take one stream dtype")
        if t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, u on {u.device}")
    if tuple(A.shape) != (d, n) or tuple(D.shape) != (d,):
        raise ValueError(f"A {tuple(A.shape)} / D {tuple(D.shape)} do not match "
                         f"D={d}, N={n}")
    if n > MAX_D_STATE:
        raise ValueError(f"d_state {n} > {MAX_D_STATE} is not supported by the kernels")
    u, dt, z, B, C = (_channel_contiguous(t) for t in (u, dt, z, B, C))
    A = A.to(device=u.device, dtype=torch.float32).contiguous()
    D = D.to(device=u.device, dtype=torch.float32).contiguous()
    return u, dt, A, B, C, D, z


def _stream_strides(u, dt, z, B, C) -> list[int]:
    return [u.stride(0), u.stride(1), dt.stride(0), dt.stride(1), z.stride(0),
            z.stride(1), B.stride(0), B.stride(1), C.stride(0), C.stride(1)]


def _n_chunks(seqlen: int) -> int:
    return math.ceil(seqlen / STATE_CHUNK)


def _scan_dir_args(u, dt, A, B, C, D, z, save_states):
    u, dt, A, B, C, D, z = _check_dir(u, dt, A, B, C, D, z)
    bsz, seqlen, d = u.shape
    out = torch.empty((bsz, seqlen, d), dtype=u.dtype, device=u.device)
    xb = (torch.empty((bsz, _n_chunks(seqlen), A.shape[1], d), dtype=torch.float32,
                      device=u.device) if save_states else None)
    args = _ScanDir(
        u.data_ptr(), dt.data_ptr(), z.data_ptr(), B.data_ptr(), C.data_ptr(),
        A.data_ptr(), D.data_ptr(), out.data_ptr(),
        None if xb is None else xb.data_ptr(), *_stream_strides(u, dt, z, B, C))
    # Keep every buffer alive until the launch is enqueued.
    return args, out, xb, (u, dt, z, B, C, A, D)


def selective_scan_dual_cuda(fwd: tuple, rev: tuple, save_states: bool = False):
    """Launch the forward kernel on (u, dt, A, B, C, D, z) per direction.

    Returns (y_fwd, y_rev), and with ``save_states`` also (xb_fwd, xb_rev).
    """
    u = fwd[0]
    if rev[0].shape != u.shape or rev[0].dtype != u.dtype or rev[0].device != u.device:
        raise ValueError("both directions must share shape, dtype and device")
    args_f, out_f, xb_f, keep_f = _scan_dir_args(*fwd, save_states)
    args_r, out_r, xb_r, keep_r = _scan_dir_args(*rev, save_states)
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
    if save_states:
        selective_scan_dual.save_states_launches += 1
        return out_f, out_r, xb_f, xb_r
    return out_f, out_r


def selective_scan_bwd_cuda(dirs: list, gs: list, xbs: list) -> list:
    """Launch the backward kernel once for one or two directions.

    dirs: per direction (u, dt, A, B, C, D, z, reverse); gs: the output
    cotangents; xbs: the forward's saved states. Returns what
    ``selective_scan_bwd_plain`` returns.
    """
    if not 1 <= len(dirs) <= 2 or len(gs) != len(dirs) or len(xbs) != len(dirs):
        raise ValueError("the backward kernel takes one or two directions")
    u0 = dirs[0][0]
    bsz, seqlen, d = u0.shape
    n = dirs[0][2].shape[1]
    n_parts = math.ceil(d / BWD_BLOCK_CHANNELS)
    args = _ScanBwdArgs()
    outs, keep = [], []
    for i, ((u, dt, A, B, C, D, z, reverse), g, xb) in enumerate(zip(dirs, gs, xbs)):
        if u.shape != u0.shape or u.dtype != u0.dtype or u.device != u0.device:
            raise ValueError("both directions must share shape, dtype and device")
        if A.shape[1] != n:
            raise ValueError("both directions must share d_state")
        u, dt, A, B, C, D, z = _check_dir(u, dt, A, B, C, D, z)
        if g.shape != u.shape or g.dtype != u.dtype or g.device != u.device:
            raise ValueError(f"the cotangent {tuple(g.shape)} {g.dtype} does not match u")
        g = _channel_contiguous(g)
        xb_shape = (bsz, _n_chunks(seqlen), n, d)
        if (xb is None or tuple(xb.shape) != xb_shape or xb.dtype != torch.float32
                or not xb.is_contiguous() or xb.device != u.device):
            raise ValueError(f"the saved states must be contiguous fp32 {xb_shape}")

        def empty(*shape, dtype=torch.float32):
            return torch.empty(shape, dtype=dtype, device=u.device)

        du, ddelta, dz = (empty(bsz, seqlen, d, dtype=u.dtype) for _ in range(3))
        dA_p, dD_p, dbias_p = empty(bsz, n, d), empty(bsz, d), empty(bsz, d)
        dbc_p = empty(n_parts, bsz, seqlen, 2 * MAX_D_STATE)
        args.dir[i] = _ScanBwdDir(
            u.data_ptr(), dt.data_ptr(), z.data_ptr(), B.data_ptr(), C.data_ptr(),
            A.data_ptr(), D.data_ptr(), g.data_ptr(), xb.data_ptr(), du.data_ptr(),
            ddelta.data_ptr(), dz.data_ptr(), dA_p.data_ptr(), dD_p.data_ptr(),
            dbias_p.data_ptr(), dbc_p.data_ptr(), *_stream_strides(u, dt, z, B, C),
            g.stride(0), g.stride(1), int(bool(reverse)))
        outs.append((du, ddelta, dz, dA_p, dD_p, dbias_p, dbc_p, B.dtype, C.dtype))
        keep.append((u, dt, z, B, C, A, D, g, xb))
    lib = _bwd_lib()
    with torch.cuda.device(u0.device):
        stream = torch.cuda.current_stream(u0.device).cuda_stream
        status = lib.aum_selective_scan_bwd(
            ctypes.byref(args), len(dirs), bsz, seqlen, d, n, _DTYPE_CODES[u0.dtype], stream)
    del keep
    _build.check_status(status, lib.aum_scan_bwd_error_string,
                        "selective_scan_bwd kernel launch")
    selective_scan_bwd.launches += 1
    grads = []
    for du, ddelta, dz, dA_p, dD_p, dbias_p, dbc_p, b_dtype, c_dtype in outs:
        dbc = dbc_p.sum(dim=0)  # (B, L, 32): [:N] dB, [16:16+N] dC
        grads.append((du, ddelta, dA_p.sum(dim=0).t(), dbc[..., :n].to(b_dtype),
                      dbc[..., MAX_D_STATE:MAX_D_STATE + n].to(c_dtype),
                      dD_p.sum(dim=0), dz, dbias_p.sum(dim=0)))
    return grads


def _check_chunk(lib: ctypes.CDLL, fn_name: str) -> None:
    fn = getattr(lib, fn_name)
    fn.restype = ctypes.c_int
    if fn() != STATE_CHUNK:
        raise RuntimeError(f"{fn_name}() = {fn()} but STATE_CHUNK = {STATE_CHUNK}")


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
    _check_chunk(lib, "aum_scan_state_chunk")
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.library("selective_scan_bwd")
    fn = lib.aum_selective_scan_bwd
    fn.argtypes = [ctypes.POINTER(_ScanBwdArgs)] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.aum_scan_bwd_error_string.argtypes = [ctypes.c_int]
    lib.aum_scan_bwd_error_string.restype = ctypes.c_char_p
    _check_chunk(lib, "aum_scan_bwd_state_chunk")
    return lib


def selective_scan_bwd(dirs: list, gs: list, xbs: list) -> list:
    """The scan backward of one or two directions: the kernel on CUDA tensors
    (one launch), the plain version on CPU tensors (``xbs`` unused there)."""
    device = dirs[0][0].device
    if device.type == "cpu":
        return selective_scan_bwd_plain(dirs, gs)
    if device.type != "cuda":
        raise ValueError(f"selective_scan_bwd runs on cpu or cuda, not {device}")
    return selective_scan_bwd_cuda(dirs, gs, xbs)


selective_scan_bwd.launches = 0


# --- the op ----------------------------------------------------------------------

def _prep_both(args_fwd: tuple, args_rev: tuple):
    """(u, dt, A, B, C, D, z) per direction; bimamba v1, which shares delta
    and its bias, gets one softplus pass and one dt stream."""
    uf, df, af, bf, cf, dskf, zf, biasf = args_fwd
    ur, dr, ar, br, cr, dskr, zr, biasr = args_rev
    dt_f = _prep_dt(df, biasf)
    dt_r = dt_f if (dr is df and biasr is biasf) else _prep_dt(dr, biasr)
    return (uf, dt_f, af, bf, cf, dskf, zf), (ur, dt_r, ar, br, cr, dskr, zr)


def _forward(fwd: tuple, rev: tuple, save_states: bool):
    device = fwd[0].device
    if device.type == "cpu":
        # The plain backward recomputes from the inputs: no states to keep.
        return selective_scan_dual_plain(fwd, rev) + ((None, None) if save_states else ())
    if device.type != "cuda":
        raise ValueError(f"selective_scan_dual runs on cpu or cuda, not {device}")
    return selective_scan_dual_cuda(fwd, rev, save_states)


class _DualScan(torch.autograd.Function):
    """Both directions' (u, delta, A, B, C, D, z, delta_bias) -> (y_fwd, y_rev),
    with the chunk-entry states saved for the backward kernel."""

    @staticmethod
    def forward(ctx, *args16):
        args_fwd, args_rev = args16[:8], args16[8:]
        fwd, rev = _prep_both(args_fwd, args_rev)
        y_f, y_r, xb_f, xb_r = _forward(fwd, rev, save_states=True)
        # Bimamba v1 passes the same u/dt/B/C/D/z in both directions (only A
        # differs): those are saved once.
        ctx.shared = all(a is b for a, b in zip(fwd[:2] + fwd[3:], rev[:2] + rev[3:]))
        saved = fwd + (rev[2], xb_f, xb_r) if ctx.shared else fwd + rev + (xb_f, xb_r)
        ctx.save_for_backward(*saved)
        ctx.has_bias = (args_fwd[7] is not None, args_rev[7] is not None)
        return y_f, y_r

    @staticmethod
    def backward(ctx, g_f, g_r):
        saved = ctx.saved_tensors
        if ctx.shared:
            fwd = saved[:7]
            rev = fwd[:2] + (saved[7],) + fwd[3:]
        else:
            fwd, rev = saved[:7], saved[7:14]
        xb_f, xb_r = saved[-2:]
        gs = [torch.zeros_like(y[0]) if g is None else g
              for g, y in ((g_f, fwd), (g_r, rev))]
        grads = selective_scan_bwd([fwd + (False,), rev + (True,)], gs, [xb_f, xb_r])
        out = []
        for (du, ddelta, dA, dB, dC, dD, dz, dbias), has_bias in zip(grads, ctx.has_bias):
            out += [du, ddelta, dA, dB, dC, dD, dz, dbias if has_bias else None]
        return tuple(out)


def selective_scan_dual(args_fwd: tuple, args_rev: tuple
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused bidirectional selective scan.

    args_fwd / args_rev: (u, delta, A, B, C, D, z, delta_bias) for the
    forward-scanning and the reverse-scanning direction (bimamba v1 passes
    the same tensors in both, with its own A; autograd sums their grads).
    delta is pre-softplus; D and z are required, as in the JAX kernel path.
    Returns (y_fwd, y_rev); the caller sums them. Differentiable: when a
    grad is needed the forward kernel saves its chunk-entry states and the
    backward kernel runs in the backward pass; otherwise the eval forward
    runs alone.
    """
    tensors = [t for t in args_fwd + args_rev if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _DualScan.apply(*args_fwd, *args_rev)
    fwd, rev = _prep_both(args_fwd, args_rev)
    return _forward(fwd, rev, save_states=False)


selective_scan_dual.launches = 0
selective_scan_dual.save_states_launches = 0
