"""Selective scan under autograd, bidirectional and single-direction: CUDA
kernels + plain forms.

Counterpart of ``aum_tpu/ops/selective_scan.py``: ``selective_scan_dual``
with its custom VJP (``_make_dual_scan``, ``_dual_bwd_impl``), and
``selective_scan`` with its custom VJP (``_make_scan``). CUDA kernels:

- ``csrc/selective_scan.cu`` holds three forward kernels on one per-chain
  walk. ``scan_dual_fwd_kernel`` replaces the TPU kernel ``_fwd_kernel_dual``
  in its default configuration (fused y-readout, per-step decay);
  ``scan_dual_direct_fwd_kernel`` replaces ``_fwd_kernel_dual_direct`` (the
  same function, B/C read per step with no staging; AUM_SCAN_DIRECT=1);
  ``scan_single_fwd_kernel`` replaces ``_fwd_kernel_z``: one direction with a
  ``reverse`` flag, and the ``with_state`` form (a carried-in initial state,
  the final state out). In eval they write the outputs only; when a grad is
  needed they also save the state at the entry of every chunk of
  ``STATE_CHUNK`` steps (``save_states``).
- ``csrc/selective_scan_bwd.cu`` (K2) replaces ``_bwd_kernel`` (dla mode
  "xprev"), with its ``with_state`` form (the final state's cotangent in,
  the grad of the initial state out): it restarts each chunk from its saved
  state and runs the adjoint. One launch takes one or both directions, so
  launched with both it is also the counterpart of ``_bwd_kernel_dual``.
- ``csrc/selective_scan_bwd_fused.cu`` replaces ``_bwd_kernel_fused`` (the
  same function as K2 without ``with_state``, each chunk recomputed once;
  AUM_SCAN_BWD_FUSED=1), one or both directions per launch.

The sources say what bounds each kernel on the card and what its design does
about that.

The ``_prep`` contract of the JAX op is kept: ``dt = softplus(delta + bias)``
is computed outside the kernels in fp32 and cast to delta's dtype, and the
kernels stream that rounded dt. The backward chain-rules ddelta from dt
alone, ``ddt * (1 - exp(-dt))``, writes it in dt's dtype and sums dbias in
fp32 from the value before that cast. Layout stays (B, L, D); states cross
the API as the reference's (B, D, N) fp32.

The switches of ``aum_tpu`` choose among the kernels as there, read at every
call (JAX reads them at every trace): AUM_SCAN_DIRECT=1 the direct dual
forward (eval and saving); AUM_SCAN_BWD_FUSED=1 the fused backward, for the
dual scan and the single-direction one, except that AUM_SCAN_DUAL_BWD=1
keeps the dual scan on K2 with both directions (the port's counterpart of
``_bwd_kernel_dual``) and the ``with_state`` backward is never fused. On CPU
tensors every wrapper runs its plain PyTorch version (the sequential oracle
of ``ops/scan_ref.py``; the plain backward recomputes through it under
autograd), whatever the switches: the kernels they choose among compute one
function. On CUDA tensors the chosen kernel launches or the call raises.
Launch counts, each raised where the kernel is launched:
``selective_scan_dual.launches`` (every staged dual forward launch) and
``.save_states_launches`` (those that saved states),
``.direct_launches`` and ``.direct_save_states_launches`` (the direct
kernel's); ``selective_scan.launches`` (every single-direction forward
launch), ``.save_states_launches`` and ``.with_state_launches``;
``selective_scan_bwd.launches`` (K2) and ``.with_state_launches`` (those of
its with_state form), ``.fused_launches``.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os

import torch

from aum_tpu_torch.ops import _build
from aum_tpu_torch.ops.scan_ref import selective_scan_ref

MAX_D_STATE = 16
STATE_CHUNK = 64  # kChunk of both kernels: the interval of the saved states
BWD_BLOCK_CHANNELS = 32  # channels per block of K2: one dB/dC partial row each
BWD_FUSED_BLOCK_CHANNELS = 16  # the same for the fused backward


def _env_int(name: str, default: int) -> int:
    """A switch from the environment, parsed as ``aum_tpu`` parses its own
    (unset or empty: the default; otherwise an integer)."""
    value = os.environ.get(name)
    return int(value) if value else default


def direct_forward_chosen() -> bool:
    """AUM_SCAN_DIRECT=1: the dual forward runs ``_fwd_kernel_dual_direct``'s
    counterpart, in eval and when saving states."""
    return _env_int("AUM_SCAN_DIRECT", 0) != 0


def fused_backward_chosen(ndir: int) -> bool:
    """AUM_SCAN_BWD_FUSED=1: the scan backward of ``ndir`` directions runs the
    fused kernel; for the dual scan (two directions) AUM_SCAN_DUAL_BWD=1 takes
    precedence and keeps K2, as ``_dual_bwd_impl`` takes ``_bwd_kernel_dual``."""
    if ndir == 2 and _env_int("AUM_SCAN_DUAL_BWD", 0):
        return False
    return _env_int("AUM_SCAN_BWD_FUSED", 0) != 0


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # The JAX op's primitives-only form, so dt rounds identically to bf16.
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _prep_dt(delta: torch.Tensor, delta_bias: torch.Tensor | None,
             softplus: bool = True) -> torch.Tensor:
    dt = delta.float()
    if delta_bias is not None:
        dt = dt + delta_bias.float()
    return (_softplus(dt) if softplus else dt).to(delta.dtype)


# --- plain versions ----------------------------------------------------------

def selective_scan_dual_plain(fwd: tuple, rev: tuple, save_states: bool = False):
    """The dual forward kernels' function in plain PyTorch (the staged and the
    direct kernel compute the same): the oracle per direction.

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


def selective_scan_plain(args: tuple, reverse: bool, save_states: bool = False,
                         initial_state: torch.Tensor | None = None,
                         return_final_state: bool = False):
    """The single-direction forward kernel's function in plain PyTorch.

    args: (u, dt, A, B, C, D, z) with dt already activated, as
    ``selective_scan_cuda`` takes them; initial_state: (B, D, N) or None.
    Returns out, and after it, where asked for, xb (B, ceil(L /
    STATE_CHUNK), N, D) fp32 and the final state (B, D, N) fp32.
    """
    return selective_scan_ref(*args[:6], z=args[6], reverse=reverse,
                              save_every=STATE_CHUNK if save_states else 0,
                              initial_state=initial_state,
                              return_last_state=return_final_state)


def selective_scan_bwd_plain(dirs: list, gs: list, softplus: bool = True,
                             states: list | None = None) -> list:
    """The backward kernels' function in plain PyTorch (K2 and the fused
    kernel compute the same).

    dirs: per direction (u, dt, A, B, C, D, z, reverse); gs: the cotangent of
    each direction's output; ``states``: per direction (x0, gfin) for the
    with_state form, the (B, D, N) starting state and the cotangent of the
    final state. Recomputes the oracle in fp32 under autograd and returns per
    direction (du, ddelta, dA, dB, dC, dD, dz, dbias), then dx0 (B, D, N)
    fp32 in the with_state form: ddelta = ddt * (1 - exp(-dt)) through the
    softplus (ddt without it) in dt's dtype, dbias its fp32 sum taken before
    that cast, dA, dD fp32, the rest in their input's dtype.
    """
    grads = []
    for i, ((u, dt, A, B, C, D, z, reverse), g) in enumerate(zip(dirs, gs)):
        with torch.enable_grad():
            leaves = [t.detach().float().requires_grad_() for t in (u, dt, A, B, C, D, z)]
            if states is None:
                outs = (selective_scan_ref(*leaves[:6], z=leaves[6], reverse=reverse),)
                cots = (g.float(),)
            else:
                x0, gfin = states[i]
                leaves.append(x0.detach().float().requires_grad_())
                outs = selective_scan_ref(*leaves[:6], z=leaves[6], reverse=reverse,
                                          initial_state=leaves[7], return_last_state=True)
                cots = (g.float(), gfin.float())
            du, ddt, dA, dB, dC, dD, dz, *dx0 = torch.autograd.grad(outs, leaves, cots)
        # sigmoid(delta + bias), from dt alone
        ddelta = ddt * (1.0 - torch.exp(-dt.float())) if softplus else ddt
        grads.append((du.to(u.dtype), ddelta.to(dt.dtype), dA, dB.to(B.dtype),
                      dC.to(C.dtype), dD, dz.to(z.dtype), ddelta.sum(dim=(0, 1)), *dx0))
    return grads


# --- CUDA kernels --------------------------------------------------------------

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_STREAM_STRIDES = ("u_sb", "u_sl", "dt_sb", "dt_sl", "z_sb", "z_sl",
                   "B_sb", "B_sl", "C_sb", "C_sl")


class _ScanDir(ctypes.Structure):
    """Mirror of ``ScanDir`` in csrc/selective_scan.cu."""

    _fields_ = [(name, ctypes.c_void_p) for name in
                ("u", "dt", "z", "B", "C", "A", "Dskip", "out", "xb", "x0", "xfin")] + [
        (name, ctypes.c_longlong) for name in _STREAM_STRIDES]


class _ScanBwdDir(ctypes.Structure):
    """Mirror of ``ScanBwdDir`` in csrc/scan_bwd.cuh."""

    _fields_ = [(name, ctypes.c_void_p) for name in
                ("u", "dt", "z", "B", "C", "A", "Dskip", "g", "xb", "du", "ddelta",
                 "dz", "dA_part", "dD_part", "dbias_part", "dbc_part", "gfin", "dx0")] + [
        (name, ctypes.c_longlong) for name in _STREAM_STRIDES + ("g_sb", "g_sl")] + [
        ("reverse", ctypes.c_int), ("softplus", ctypes.c_int)]


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


def _scan_dir_args(u, dt, A, B, C, D, z, save_states, x0=None):
    """The kernel's arguments for one direction; ``x0`` (B, N, D) fp32
    contiguous selects the with_state form, whose final state is returned
    beside the outputs (xfin, else None)."""
    u, dt, A, B, C, D, z = _check_dir(u, dt, A, B, C, D, z)
    bsz, seqlen, d = u.shape

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=u.device)

    out = empty(bsz, seqlen, d, dtype=u.dtype)
    xb = empty(bsz, _n_chunks(seqlen), A.shape[1], d) if save_states else None
    xfin = None if x0 is None else empty(*x0.shape)
    args = _ScanDir(
        u.data_ptr(), dt.data_ptr(), z.data_ptr(), B.data_ptr(), C.data_ptr(),
        A.data_ptr(), D.data_ptr(), out.data_ptr(),
        *(None if t is None else t.data_ptr() for t in (xb, x0, xfin)),
        *_stream_strides(u, dt, z, B, C))
    # Keep every buffer alive until the launch is enqueued.
    return args, out, xb, xfin, (u, dt, z, B, C, A, D, x0)


def selective_scan_dual_cuda(fwd: tuple, rev: tuple, save_states: bool = False):
    """Launch a dual forward kernel on (u, dt, A, B, C, D, z) per direction:
    the staged one, or the direct one under AUM_SCAN_DIRECT=1.

    Returns (y_fwd, y_rev), and with ``save_states`` also (xb_fwd, xb_rev).
    """
    u = fwd[0]
    if rev[0].shape != u.shape or rev[0].dtype != u.dtype or rev[0].device != u.device:
        raise ValueError("both directions must share shape, dtype and device")
    args_f, out_f, xb_f, _, keep_f = _scan_dir_args(*fwd, save_states)
    args_r, out_r, xb_r, _, keep_r = _scan_dir_args(*rev, save_states)
    lib = _lib()
    direct = direct_forward_chosen()
    launch = lib.aum_selective_scan_dual_direct_fwd if direct else lib.aum_selective_scan_dual_fwd
    bsz, seqlen, d = u.shape
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        status = launch(ctypes.byref(args_f), ctypes.byref(args_r), bsz, seqlen, d,
                        fwd[2].shape[1], _DTYPE_CODES[u.dtype], stream)
    del keep_f, keep_r
    _build.check_status(status, lib.aum_scan_error_string,
                        "selective_scan_dual kernel launch")
    if direct:
        selective_scan_dual.direct_launches += 1
        selective_scan_dual.direct_save_states_launches += save_states
    else:
        selective_scan_dual.launches += 1
        selective_scan_dual.save_states_launches += save_states
    return (out_f, out_r, xb_f, xb_r) if save_states else (out_f, out_r)


def selective_scan_cuda(args: tuple, reverse: bool, save_states: bool = False,
                        initial_state: torch.Tensor | None = None,
                        return_final_state: bool = False):
    """Launch the single-direction forward kernel on (u, dt, A, B, C, D, z).

    Returns what ``selective_scan_plain`` returns. The with_state form runs
    when an initial state is given or the final state is asked for (from
    zeros when only the latter); states cross in (B, D, N) and the kernel
    takes (B, N, D), so the wrapper transposes them.
    """
    u, A = args[0], args[2]
    bsz, _, d = u.shape
    n = A.shape[1]
    with_state = initial_state is not None or return_final_state
    x0 = None
    if with_state:
        if initial_state is None:
            x0 = torch.zeros((bsz, n, d), dtype=torch.float32, device=u.device)
        elif tuple(initial_state.shape) != (bsz, d, n) or initial_state.device != u.device:
            raise ValueError(f"initial_state {tuple(initial_state.shape)} on "
                             f"{initial_state.device} must be ({bsz}, {d}, {n}) on {u.device}")
        else:
            x0 = initial_state.float().transpose(1, 2).contiguous()
    kargs, out, xb, xfin, keep = _scan_dir_args(*args, save_states, x0)
    lib = _lib()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        status = lib.aum_selective_scan_fwd(ctypes.byref(kargs), int(bool(reverse)),
                                            *u.shape, n, _DTYPE_CODES[u.dtype], stream)
    del keep
    _build.check_status(status, lib.aum_scan_error_string, "selective_scan kernel launch")
    selective_scan.launches += 1
    result = (out,)
    if save_states:
        selective_scan.save_states_launches += 1
        result += (xb,)
    if with_state:
        selective_scan.with_state_launches += 1
        if return_final_state:
            result += (xfin.transpose(1, 2),)
    return result if len(result) > 1 else out


def selective_scan_bwd_cuda(dirs: list, gs: list, xbs: list, softplus: bool = True,
                            gfins: list | None = None) -> list:
    """Launch a backward kernel once for one or two directions: K2, or the
    fused kernel under AUM_SCAN_BWD_FUSED=1 (see ``fused_backward_chosen``).

    dirs: per direction (u, dt, A, B, C, D, z, reverse); gs: the output
    cotangents; xbs: the forward's saved states; ``gfins``: per direction the
    (B, D, N) cotangent of the final state, for K2's with_state form (one
    direction; never fused), whose starting state is xb's first entry.
    Returns what ``selective_scan_bwd_plain`` returns.
    """
    if not 1 <= len(dirs) <= 2 or len(gs) != len(dirs) or len(xbs) != len(dirs):
        raise ValueError("the backward kernels take one or two directions")
    with_state = gfins is not None
    if with_state and (len(dirs) != 1 or len(gfins) != 1):
        raise ValueError("the with_state backward takes one direction")
    fused = not with_state and fused_backward_chosen(len(dirs))
    u0 = dirs[0][0]
    bsz, seqlen, d = u0.shape
    n = dirs[0][2].shape[1]
    n_parts = math.ceil(d / (BWD_FUSED_BLOCK_CHANNELS if fused else BWD_BLOCK_CHANNELS))
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

        gfin = dx0 = None
        if with_state:
            if tuple(gfins[i].shape) != (bsz, d, n) or gfins[i].device != u.device:
                raise ValueError(f"the final state's cotangent {tuple(gfins[i].shape)} on "
                                 f"{gfins[i].device} must be ({bsz}, {d}, {n}) on {u.device}")
            gfin = gfins[i].float().transpose(1, 2).contiguous()  # the kernel's (B, N, D)
            dx0 = empty(bsz, n, d)
        du, ddelta, dz = (empty(bsz, seqlen, d, dtype=u.dtype) for _ in range(3))
        dA_p, dD_p, dbias_p = empty(bsz, n, d), empty(bsz, d), empty(bsz, d)
        dbc_p = empty(n_parts, bsz, seqlen, 2 * MAX_D_STATE)
        args.dir[i] = _ScanBwdDir(
            u.data_ptr(), dt.data_ptr(), z.data_ptr(), B.data_ptr(), C.data_ptr(),
            A.data_ptr(), D.data_ptr(), g.data_ptr(), xb.data_ptr(), du.data_ptr(),
            ddelta.data_ptr(), dz.data_ptr(), dA_p.data_ptr(), dD_p.data_ptr(),
            dbias_p.data_ptr(), dbc_p.data_ptr(),
            *(None if t is None else t.data_ptr() for t in (gfin, dx0)),
            *_stream_strides(u, dt, z, B, C), g.stride(0), g.stride(1), int(bool(reverse)),
            int(bool(softplus)))
        outs.append((du, ddelta, dz, dA_p, dD_p, dbias_p, dbc_p, B.dtype, C.dtype, dx0))
        keep.append((u, dt, z, B, C, A, D, g, xb, gfin))
    lib, prefix = (_bwd_fused_lib(), "scan_bwd_fused") if fused else (_bwd_lib(), "scan_bwd")
    with torch.cuda.device(u0.device):
        stream = torch.cuda.current_stream(u0.device).cuda_stream
        status = getattr(lib, f"aum_selective_{prefix}")(
            ctypes.byref(args), len(dirs), bsz, seqlen, d, n, _DTYPE_CODES[u0.dtype], stream)
    del keep
    _build.check_status(status, getattr(lib, f"aum_{prefix}_error_string"),
                        f"selective_{prefix} kernel launch")
    if fused:
        selective_scan_bwd.fused_launches += 1
    else:
        selective_scan_bwd.launches += 1
        selective_scan_bwd.with_state_launches += with_state
    grads = []
    for du, ddelta, dz, dA_p, dD_p, dbias_p, dbc_p, b_dtype, c_dtype, dx0 in outs:
        dbc = dbc_p.sum(dim=0)  # (B, L, 32): [:N] dB, [16:16+N] dC
        grads.append((du, ddelta, dA_p.sum(dim=0).t(), dbc[..., :n].to(b_dtype),
                      dbc[..., MAX_D_STATE:MAX_D_STATE + n].to(c_dtype),
                      dD_p.sum(dim=0), dz, dbias_p.sum(dim=0))
                     + (() if dx0 is None else (dx0.transpose(1, 2),)))
    return grads


def _check_constant(lib: ctypes.CDLL, fn_name: str, value: int) -> None:
    fn = getattr(lib, fn_name)
    fn.restype = ctypes.c_int
    if fn() != value:
        raise RuntimeError(f"{fn_name}() = {fn()} but the wrapper assumes {value}")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("selective_scan")
    for fn in (lib.aum_selective_scan_dual_fwd, lib.aum_selective_scan_dual_direct_fwd):
        fn.argtypes = [ctypes.POINTER(_ScanDir), ctypes.POINTER(_ScanDir),
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    fn = lib.aum_selective_scan_fwd
    fn.argtypes = [ctypes.POINTER(_ScanDir)] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.aum_scan_error_string.argtypes = [ctypes.c_int]
    lib.aum_scan_error_string.restype = ctypes.c_char_p
    _check_constant(lib, "aum_scan_state_chunk", STATE_CHUNK)
    return lib


def _load_bwd_lib(name: str, prefix: str) -> ctypes.CDLL:
    lib = _build.library(name)
    fn = getattr(lib, f"aum_selective_{prefix}")
    fn.argtypes = [ctypes.POINTER(_ScanBwdArgs)] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    errors = getattr(lib, f"aum_{prefix}_error_string")
    errors.argtypes = [ctypes.c_int]
    errors.restype = ctypes.c_char_p
    _check_constant(lib, f"aum_{prefix}_state_chunk", STATE_CHUNK)
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = _load_bwd_lib("selective_scan_bwd", "scan_bwd")
    _check_constant(lib, "aum_scan_bwd_block_channels", BWD_BLOCK_CHANNELS)
    return lib


@functools.cache
def _bwd_fused_lib() -> ctypes.CDLL:
    lib = _load_bwd_lib("selective_scan_bwd_fused", "scan_bwd_fused")
    _check_constant(lib, "aum_scan_bwd_fused_block_channels", BWD_FUSED_BLOCK_CHANNELS)
    return lib


def _on_cpu(t: torch.Tensor, what: str) -> bool:
    """True for a CPU tensor (plain version), False for a CUDA one (kernel);
    any other device raises before any work is done."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {t.device}")
    return t.device.type == "cpu"


def selective_scan_bwd(dirs: list, gs: list, xbs: list, softplus: bool = True,
                       states: list | None = None) -> list:
    """The scan backward of one or two directions: a kernel on CUDA tensors
    (one launch), the plain version on CPU tensors (``xbs`` unused there).
    ``states``: per direction (x0, gfin), the with_state form (see
    ``selective_scan_bwd_plain``; the kernel restarts from xb, which holds x0)."""
    if _on_cpu(dirs[0][0], "selective_scan_bwd"):
        return selective_scan_bwd_plain(dirs, gs, softplus, states)
    return selective_scan_bwd_cuda(dirs, gs, xbs, softplus,
                                   None if states is None else [s[1] for s in states])


selective_scan_bwd.launches = 0
selective_scan_bwd.with_state_launches = 0
selective_scan_bwd.fused_launches = 0


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
    if _on_cpu(fwd[0], "selective_scan_dual"):
        # The plain backward recomputes from the inputs: no states to keep.
        return selective_scan_dual_plain(fwd, rev) + ((None, None) if save_states else ())
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
    _on_cpu(args_fwd[0], "selective_scan_dual")
    tensors = [t for t in args_fwd + args_rev if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _DualScan.apply(*args_fwd, *args_rev)
    fwd, rev = _prep_both(args_fwd, args_rev)
    return _forward(fwd, rev, save_states=False)


selective_scan_dual.launches = 0
selective_scan_dual.save_states_launches = 0
selective_scan_dual.direct_launches = 0
selective_scan_dual.direct_save_states_launches = 0


class _Scan(torch.autograd.Function):
    """One direction's (u, delta, A, B, C, D, z, delta_bias, x0) -> y, or
    (y, final state) in the with_state form, with the chunk-entry states
    saved for the backward kernel (one direction)."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, z, delta_bias, x0, reverse, softplus, with_state):
        args = (u, _prep_dt(delta, delta_bias, softplus), A, B, C, D, z)
        ctx.has_x0 = x0 is not None
        if with_state and x0 is None:
            x0 = torch.zeros((u.shape[0], u.shape[2], A.shape[1]), device=u.device)
        kw = {"initial_state": x0, "return_final_state": with_state}
        if _on_cpu(u, "selective_scan"):
            # The plain backward recomputes from the inputs: no states to keep.
            out = selective_scan_plain(args, reverse, **kw)
            (y, fin), xb = (out if with_state else (out, None)), None
        else:
            y, xb, *fin = selective_scan_cuda(args, reverse, save_states=True, **kw)
            fin = fin[0] if with_state else None
        ctx.save_for_backward(*args, xb, x0)
        ctx.reverse, ctx.softplus, ctx.with_state = reverse, softplus, with_state
        ctx.has_bias = delta_bias is not None
        return (y, fin) if with_state else y

    @staticmethod
    def backward(ctx, g, gfin=None):
        *args, xb, x0 = ctx.saved_tensors
        states = [(x0, gfin)] if ctx.with_state else None
        du, ddelta, dA, dB, dC, dD, dz, dbias, *dx0 = selective_scan_bwd(
            [tuple(args) + (ctx.reverse,)], [g], [xb], ctx.softplus, states)[0]
        return (du, ddelta, dA, dB, dC, dD, dz, dbias if ctx.has_bias else None,
                dx0[0] if ctx.has_x0 else None, None, None, None)


def selective_scan(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, z: torch.Tensor,
                   delta_bias: torch.Tensor | None = None, delta_softplus: bool = False,
                   reverse: bool = False, initial_state: torch.Tensor | None = None,
                   return_final_state: bool = False):
    """Single-direction selective scan (see ``ops/scan_ref.py`` for the math).

    u, delta, z: (B, L, D); A: (D, N); B, C: (B, L, N); D, delta_bias: (D,);
    ``reverse`` scans right to left. D and z are required, as in the JAX
    kernel path. ``initial_state`` (B, D, N) starts the recurrence from a
    carried state, and ``return_final_state`` also returns the (B, D, N) fp32
    state after the last processed step (position 0 when reversed).
    Returns y (B, L, D) in u's dtype, or (y, final state).

    Differentiable in every form: when a grad is needed the forward kernel
    saves its chunk-entry states and a one-direction backward kernel runs in
    the backward pass; with a carried or returned state it is K2's with_state
    form, which also gives the grad of ``initial_state``, so chained segments
    (each started from the previous one's final state) differentiate as one
    scan.
    """
    if D is None or z is None:
        raise ValueError("selective_scan takes D and z (the kernel path's form)")
    on_cpu = _on_cpu(u, "selective_scan")
    tensors = [t for t in (u, delta, A, B, C, D, z, delta_bias, initial_state)
               if t is not None]
    with_state = initial_state is not None or return_final_state
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        out = _Scan.apply(u, delta, A, B, C, D, z, delta_bias, initial_state, bool(reverse),
                          bool(delta_softplus), with_state)
        return out[0] if with_state and not return_final_state else out
    args = (u, _prep_dt(delta, delta_bias, delta_softplus), A, B, C, D, z)
    return (selective_scan_plain if on_cpu else selective_scan_cuda)(
        args, reverse, initial_state=initial_state, return_final_state=return_final_state)


selective_scan.launches = 0
selective_scan.save_states_launches = 0
selective_scan.with_state_launches = 0
