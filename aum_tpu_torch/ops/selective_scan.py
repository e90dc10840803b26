"""Selective scan under autograd, bidirectional and single-direction: CUDA
kernels + plain forms.

Counterpart of ``aum_tpu/ops/selective_scan.py``: ``selective_scan_dual``
with its custom VJP (``_make_dual_scan``, ``_dual_bwd_impl``), and
``selective_scan`` with its custom VJP (``_make_scan``). CUDA kernels:

- ``csrc/selective_scan.cu`` holds five forward kernels on one per-chain
  walk. ``scan_dual_fwd_kernel`` replaces the TPU kernel ``_fwd_kernel_dual``
  in its default configuration (fused y-readout, per-step decay), and two
  kernels its opt-in forms: ``scan_dual_fdt_fwd_kernel`` the ``fuse_dt``
  form (AUM_SCAN_FUSE_DT=1, eval: dt = softplus(dtr @ W + bias) formed in
  the kernel in fp32, never rounded), ``scan_dual_stage_fwd_kernel`` the
  ``bf16_stage`` form (AUM_SCAN_BF16_STAGE=1, bf16 streams, eval and
  saving);
  ``scan_dual_direct_fwd_kernel`` replaces ``_fwd_kernel_dual_direct`` (the
  same function, B/C read per step with no staging; AUM_SCAN_DIRECT=1);
  ``scan_single_fwd_kernel`` replaces ``_fwd_kernel_z``: one direction with a
  ``reverse`` flag, and the ``with_state`` form (a carried-in initial state,
  the final state out). In eval they write the outputs only; when a grad is
  needed they also save the state at the entry of every chunk of
  ``STATE_CHUNK`` steps (``save_states``).
- ``csrc/selective_scan_bwd.cu`` (K2) replaces ``_bwd_kernel`` (dla mode
  "xprev", and "xminus" / "dbu" in one x-minus form), with its
  ``with_state`` form (the final state's cotangent in, the grad of the
  initial state out): it restarts each chunk from its saved state and runs
  the adjoint. One launch takes one or both directions, so launched with
  both it is also the counterpart of ``_bwd_kernel_dual``.
- ``csrc/selective_scan_bwd_fused.cu`` replaces ``_bwd_kernel_fused`` (the
  same function as K2 without ``with_state``, each chunk recomputed once;
  AUM_SCAN_BWD_FUSED=1), one or both directions per launch. Both backward
  kernels write bf16 dB/dC partials under AUM_SCAN_BWD_BF16_PARTIALS=1.

The sources say what bounds each kernel on the card and what its design does
about that.

Every kernel takes any d_state, as the JAX op pads N and sums over it: a
launch takes at most ``SLICE_STATES`` (16) states, so above that (and for a
scan without z: the gated kernels always apply the gate) the wrappers run each
kernel's ungated build (the ``*_sliced`` libraries, ``csrc/common.cuh``)
once per slice of 16 states (``state_slices``; the last one ragged), each
on its own rows of A, columns of B and C and saved or carried states, and
``csrc/scan_combine.cu`` sums the slices' fp32 partials, adds D u and
applies the gate, rounding once (``scan_combine_cuda``); its backward twin
(``scan_combine_bwd_cuda``) sums the backward slices' du and ddelta
partials and forms dz, dD and dbias from the whole pre-gate y. D None is
the zero vector. The fuse_dt form takes any dt rank: past
``FDT_WHOLE_RANK`` (400) its windowed kernel accumulates the dt product
over windows of the rank.

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
``_bwd_kernel_dual``) and the ``with_state`` backward is never fused; the
four opt-in forms as ``fuse_dt_chosen``, ``bf16_stage_chosen``,
``bwd_bf16_partials_chosen`` and ``bwd_dla_mode`` say. On CPU tensors every
wrapper runs its plain PyTorch version (the sequential oracle of
``ops/scan_ref.py``; the plain backward recomputes through it under
autograd): one per function, so the direct kernel, the fused backward and
the x-minus form share theirs, while the fuse_dt form (fp32 dt), the stage
form (its bf16 roundings) and the bf16 partials (rounded per block of the
kernel's channels) have their own. On CUDA tensors the chosen kernel
launches or the call raises. Launch counts, each raised where the kernel is
launched: ``selective_scan_dual.launches`` (every staged dual forward launch)
and ``.save_states_launches`` (those that saved states),
``.direct_launches`` and ``.direct_save_states_launches`` (the direct
kernel's), ``.fdt_launches`` (the fuse_dt form's), ``.stage_launches`` and
``.stage_save_states_launches`` (the stage form's); ``selective_scan.launches``
(every single-direction forward launch), ``.save_states_launches`` and
``.with_state_launches``; ``selective_scan_bwd.launches`` (K2),
``.with_state_launches`` and ``.xminus_launches`` (those of its with_state
and x-minus forms), ``.fused_launches``, ``.bf16_partials_launches`` (K2 or
fused launches with bf16 partials). A sliced scan counts one launch of its
form per slice, and each op's ``.sliced_launches`` counts those launches
again; ``scan_combine_cuda.launches`` and ``scan_combine_bwd_cuda.launches``
count the combine's.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
import os

import torch

from aum_tpu_torch.ops import _build
from aum_tpu_torch.ops.scan_ref import selective_scan_ref

SLICE_STATES = 16  # kMaxN of the scan kernels: the states one launch takes
STATE_CHUNK = 64  # kChunk of both kernels: the interval of the saved states
BWD_BLOCK_CHANNELS = 32  # channels per block of K2: one dB/dC partial row each
BWD_FUSED_BLOCK_CHANNELS = 16  # the same for the fused backward
COMBINE_BWD_CHUNK = 32  # kBwdChunk of the combine's backward: steps per dD/dbias partial row


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


def fuse_dt_chosen() -> bool:
    """AUM_SCAN_FUSE_DT=1: the bimamba mixers pass x_proj's dt-rank columns
    and the dt_proj weight to the dual scan (``dt_fold``), whose eval forward
    forms dt in the kernel. A string compare, as ``aum_tpu`` reads it: "01"
    is off."""
    return os.environ.get("AUM_SCAN_FUSE_DT", "0") == "1"


def bf16_stage_chosen(dtype: torch.dtype, direct: bool, fuse_dt: bool = False) -> bool:
    """AUM_SCAN_BF16_STAGE=1: the staged dual forward (eval and saving)
    rounds dt log2 e and dt u to bf16 as the TPU kernel stages them; bf16
    streams only, never the direct kernel nor the fuse_dt eval form."""
    return (_env_int("AUM_SCAN_BF16_STAGE", 0) != 0 and dtype == torch.bfloat16
            and not direct and not fuse_dt)


def _dual_bwd_kernel_chosen(ndir: int) -> bool:
    """AUM_SCAN_DUAL_BWD=1 with both directions: K2's launch stands for
    ``_bwd_kernel_dual``, which has neither opt-in form below."""
    return ndir == 2 and _env_int("AUM_SCAN_DUAL_BWD", 0) != 0


def bwd_bf16_partials_chosen(ndir: int) -> bool:
    """AUM_SCAN_BWD_BF16_PARTIALS=1: the backward kernels (K2 and the fused
    one) write their dB/dC partials in bf16, summed in fp32 by the wrapper;
    not the launch that stands for ``_bwd_kernel_dual``, whose partials JAX
    keeps fp32."""
    return (_env_int("AUM_SCAN_BWD_BF16_PARTIALS", 0) != 0
            and not _dual_bwd_kernel_chosen(ndir))


def bwd_dla_mode() -> str:
    """The adjoint's dla form of ``_bwd_kernel``, as ``_bwd_dla_mode`` reads
    it: AUM_SCAN_BWD_XMINUS=1 "xminus" (before DBU), AUM_SCAN_BWD_DBU=1
    "dbu", else "xprev". Both opt-ins run K2's x-minus form (one function in
    fp32); it applies to K2 launches that stand for ``_bwd_kernel``, never to
    the fused kernel nor to the launch that stands for ``_bwd_kernel_dual``."""
    if _env_int("AUM_SCAN_BWD_XMINUS", 0):
        return "xminus"
    if _env_int("AUM_SCAN_BWD_DBU", 0):
        return "dbu"
    return "xprev"


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

LOG2E_BF16 = 1.4453125  # log2 e rounded to bf16, as the stage form multiplies by it


def _scan_bf16_stage_plain(u, dt, A, B, C, D, z, reverse: bool, save_every: int = 0):
    """The oracle's recurrence with the stage form's two bf16 roundings:
    x_t = exp2(bf16(dt log2 e) A) x_{t-1} + bf16(dt u) B_t (bf16 streams)."""
    scale = (dt.float() * LOG2E_BF16).to(torch.bfloat16).float()
    dtu = (dt.float() * u.float()).to(torch.bfloat16).float()
    A, Bv, Cv = A.float(), B.float(), C.float()
    bsz, seqlen, d = u.shape
    x = torch.zeros((bsz, d, A.shape[1]), dtype=torch.float32, device=u.device)
    ys, states = [None] * seqlen, []
    steps = range(seqlen - 1, -1, -1) if reverse else range(seqlen)
    for i, t in enumerate(steps):
        if save_every and i % save_every == 0:
            states.append(x.transpose(1, 2))
        x = torch.exp2(scale[:, t, :, None] * A[None]) * x + dtu[:, t, :, None] * Bv[:, t, None, :]
        ys[t] = torch.einsum("bdn,bn->bd", x, Cv[:, t])
    y = torch.stack(ys, dim=1)
    if D is not None:
        y = y + u.float() * D.float()
    if z is not None:
        y = y * torch.nn.functional.silu(z.float())
    return (y.to(u.dtype), torch.stack(states, dim=1)) if save_every else y.to(u.dtype)


def state_slices(n: int) -> list[tuple[int, int]]:
    """The kernels' slices of ``n`` states: [n0, n1) of SLICE_STATES each,
    the last one ragged."""
    return [(n0, min(n0 + SLICE_STATES, n)) for n0 in range(0, n, SLICE_STATES)]


def sliced_form(n: int, z: torch.Tensor | None) -> bool:
    """Whether the kernels run a scan of ``n`` states as ungated slices and a
    combine: above SLICE_STATES states, or without z (the ungated kernels
    apply no gate)."""
    return n > SLICE_STATES or z is None


def scan_combine_plain(parts: torch.Tensor, u: torch.Tensor, D: torch.Tensor | None,
                       z: torch.Tensor | None) -> torch.Tensor:
    """The combine kernel's function in plain PyTorch: the (S, B, L, D) fp32
    partials summed, plus D u, times silu(z) (none without z), cast once to
    u's dtype."""
    y = parts.sum(dim=0)
    if D is not None:
        y = y + u.float() * D.float()
    if z is not None:
        y = y * torch.nn.functional.silu(z.float())
    return y.to(u.dtype)


def scan_combine_bwd_plain(du_parts, dd_parts, y_parts, g, z, u, D):
    """The combine's backward in plain PyTorch: from the slices' fp32 du,
    ddelta and (with z) y partials, (du, ddelta, dz, dD, dbias): gy = g
    silu(z), y = sum y_s + D u, du = sum du_s + D gy, ddelta = sum
    ddelta_s, dz = g y dsilu(z); dD and dbias fp32 sums over (B, L) (dD
    None without D, dz None without z)."""
    gf = g.float()
    gy = gf if z is None else gf * torch.nn.functional.silu(z.float())
    Df = torch.zeros(u.shape[-1], device=u.device) if D is None else D.float()
    dz = None
    if z is not None:
        y = y_parts.sum(dim=0) + u.float() * Df
        sig = torch.sigmoid(z.float())
        dz = (gf * y * (sig * (1.0 + z.float() * (1.0 - sig)))).to(z.dtype)
    dd = dd_parts.sum(dim=0)
    du = du_parts.sum(dim=0) + gy * Df
    dD = None if D is None else (gy * u.float()).sum(dim=(0, 1))
    return du.to(u.dtype), dd.to(u.dtype), dz, dD, dd.sum(dim=(0, 1))


def selective_scan_dual_plain(fwd: tuple, rev: tuple, save_states: bool = False,
                              bf16_stage: bool = False):
    """The dual forward kernels' function in plain PyTorch (the staged and the
    direct kernel compute the same, and so do their sliced forms with the
    combine): the oracle per direction, or with ``bf16_stage`` the stage
    form's roundings (bf16 streams).

    fwd / rev: (u, dt, A, B, C, D, z) with dt already activated, as
    ``selective_scan_dual_cuda`` takes them (D or z may be None). Returns
    (y_fwd, y_rev), and with ``save_states`` also (xb_fwd, xb_rev), each (B,
    ceil(L / STATE_CHUNK), N, D) fp32. The oracle uses exp where the kernel
    uses exp2 with log2 e folded in: the two differ by fp32 rounding.
    """
    every = STATE_CHUNK if save_states else 0
    if bf16_stage:
        out_f = _scan_bf16_stage_plain(*fwd, reverse=False, save_every=every)
        out_r = _scan_bf16_stage_plain(*rev, reverse=True, save_every=every)
    else:
        out_f = selective_scan_ref(*fwd[:6], z=fwd[6], reverse=False, save_every=every)
        out_r = selective_scan_ref(*rev[:6], z=rev[6], reverse=True, save_every=every)
    if save_states:
        return out_f[0], out_r[0], out_f[1], out_r[1]
    return out_f, out_r


def fold_dt(dtr: torch.Tensor, W: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    """The fuse_dt form's dt in plain PyTorch: softplus(dtr @ W + bias), the
    product, the bias and the softplus in fp32, never rounded."""
    dt = dtr.float() @ W.float()
    return _softplus(dt if bias is None else dt + bias.float())


def selective_scan_dual_fdt_plain(fwd: tuple, rev: tuple):
    """The fuse_dt dual forward's function in plain PyTorch: fwd / rev are
    (u, dtr, W, A, B, C, D, z, bias) per direction, dtr (B, L, R), W (R, D);
    the oracle on the fp32 dt of ``fold_dt``. Returns (y_fwd, y_rev)."""
    return tuple(selective_scan_ref(u, fold_dt(dtr, W, bias), A, B, C, D, z=z, reverse=reverse)
                 for (u, dtr, W, A, B, C, D, z, bias), reverse in ((fwd, False), (rev, True)))


def selective_scan_plain(args: tuple, reverse: bool, save_states: bool = False,
                         initial_state: torch.Tensor | None = None,
                         return_final_state: bool = False):
    """The single-direction forward kernel's function in plain PyTorch (its
    sliced form with the combine computes the same).

    args: (u, dt, A, B, C, D, z) with dt already activated, as
    ``selective_scan_cuda`` takes them (D or z may be None); initial_state:
    (B, D, N) or None. Returns out, and after it, where asked for, xb (B,
    ceil(L / STATE_CHUNK), N, D) fp32 and the final state (B, D, N) fp32.
    """
    return selective_scan_ref(*args[:6], z=args[6], reverse=reverse,
                              save_every=STATE_CHUNK if save_states else 0,
                              initial_state=initial_state,
                              return_last_state=return_final_state)


def _oracle_grads(u, dt, A, B, C, D, z, reverse, g, state=None):
    """The fp32 grads of the oracle's (u, dt, A, B, C, D, z) (None for a
    None D or z), then of x0 where ``state`` = (x0, gfin) is given (the
    with_state form)."""
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().float().requires_grad_()
                  for t in (u, dt, A, B, C, D, z)]
        if state is None:
            outs = (selective_scan_ref(*leaves[:6], z=leaves[6], reverse=reverse),)
            cots = (g.float(),)
        else:
            leaves.append(state[0].detach().float().requires_grad_())
            outs = selective_scan_ref(*leaves[:6], z=leaves[6], reverse=reverse,
                                      initial_state=leaves[7], return_last_state=True)
            cots = (g.float(), state[1].float())
        grads = iter(torch.autograd.grad(outs, [t for t in leaves if t is not None], cots))
        return [None if t is None else next(grads) for t in leaves]


def selective_scan_bwd_plain(dirs: list, gs: list, softplus: bool = True,
                             states: list | None = None, bf16_partials: int = 0) -> list:
    """The backward kernels' function in plain PyTorch (K2 and the fused
    kernel compute the same, and so do their sliced forms with the combine's
    backward).

    dirs: per direction (u, dt, A, B, C, D, z, reverse) (D or z may be None);
    gs: the cotangent of each direction's output; ``states``: per direction
    (x0, gfin) for the with_state form, the (B, D, N) starting state and the
    cotangent of the final state. Recomputes the oracle in fp32 under
    autograd and returns per direction (du, ddelta, dA, dB, dC, dD, dz,
    dbias), then dx0 (B, D, N) fp32 in the with_state form: ddelta = ddt *
    (1 - exp(-dt)) through the softplus (ddt without it) in dt's dtype, dbias
    its fp32 sum taken before that cast, dA, dD fp32, the rest in their
    input's dtype; dD and dz None where D and z are.

    ``bf16_partials`` = P > 0: dB and dC as the kernels form them under
    AUM_SCAN_BWD_BF16_PARTIALS=1, the sum over each block of P channels
    rounded to bf16, the blocks summed in fp32 (P: the kernel's channels
    per block).
    """
    grads = []
    for i, ((u, dt, A, B, C, D, z, reverse), g) in enumerate(zip(dirs, gs)):
        state = None if states is None else states[i]
        du, ddt, dA, dB, dC, dD, dz, *dx0 = _oracle_grads(u, dt, A, B, C, D, z, reverse, g,
                                                           state)
        if bf16_partials:
            # The channels' chains are independent: each block's share of
            # dB, dC is the oracle's on that block's channels.
            dB, dC = torch.zeros_like(dB), torch.zeros_like(dC)
            for d0 in range(0, u.shape[-1], bf16_partials):
                ch = slice(d0, d0 + bf16_partials)
                blk = _oracle_grads(u[..., ch], dt[..., ch], A[ch], B, C,
                                    None if D is None else D[ch],
                                    None if z is None else z[..., ch], reverse, g[..., ch],
                                    None if state is None else (state[0][:, ch], state[1][:, ch]))
                dB += blk[3].to(torch.bfloat16).float()
                dC += blk[4].to(torch.bfloat16).float()
        # sigmoid(delta + bias), from dt alone
        ddelta = ddt * (1.0 - torch.exp(-dt.float())) if softplus else ddt
        grads.append((du.to(u.dtype), ddelta.to(dt.dtype), dA, dB.to(B.dtype),
                      dC.to(C.dtype), dD, None if dz is None else dz.to(z.dtype),
                      ddelta.sum(dim=(0, 1)), *dx0))
    return grads


# --- CUDA kernels --------------------------------------------------------------

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_STREAM_STRIDES = ("u_sb", "u_sl", "dt_sb", "dt_sl", "z_sb", "z_sl",
                   "B_sb", "B_sl", "C_sb", "C_sl")


class _ScanDir(ctypes.Structure):
    """Mirror of ``ScanDir`` in csrc/selective_scan.cu."""

    _fields_ = [(name, ctypes.c_void_p) for name in
                ("u", "dt", "z", "B", "C", "A", "Dskip", "out", "xb", "x0", "xfin")] + [
        (name, ctypes.c_longlong) for name in _STREAM_STRIDES] + [
        (name, ctypes.c_void_p) for name in ("dtr", "Wt", "bias")] + [
        (name, ctypes.c_longlong) for name in ("dtr_sb", "dtr_sl", "Wt_sd")] + [
        ("rank", ctypes.c_int)]


class _ScanBwdDir(ctypes.Structure):
    """Mirror of ``ScanBwdDir`` in csrc/scan_bwd.cuh."""

    _fields_ = [(name, ctypes.c_void_p) for name in
                ("u", "dt", "z", "B", "C", "A", "Dskip", "g", "xb", "du", "ddelta",
                 "dz", "dA_part", "dD_part", "dbias_part", "dbc_part", "gfin", "dx0")] + [
        (name, ctypes.c_longlong) for name in _STREAM_STRIDES + ("g_sb", "g_sl")] + [
        (name, ctypes.c_int) for name in ("reverse", "softplus", "xminus", "bf16_partials")]


class _ScanBwdArgs(ctypes.Structure):
    _fields_ = [("dir", _ScanBwdDir * 2)]


class _CombineDir(ctypes.Structure):
    """Mirror of ``CombineDir`` in csrc/scan_combine.cu."""

    _fields_ = [(name, ctypes.c_void_p) for name in ("parts", "u", "z", "Dskip", "out")] + [
        (name, ctypes.c_longlong) for name in ("u_sb", "u_sl", "z_sb", "z_sl")]


class _CombineArgs(ctypes.Structure):
    _fields_ = [("dir", _CombineDir * 2)]


class _CombineBwdDir(ctypes.Structure):
    """Mirror of ``CombineBwdDir`` in csrc/scan_combine.cu."""

    _fields_ = [(name, ctypes.c_void_p) for name in
                ("du_parts", "dd_parts", "y_parts", "g", "z", "u", "Dskip", "du", "ddelta", "dz",
                 "dD_part", "dbias_part")] + [
        (name, ctypes.c_longlong) for name in ("g_sb", "g_sl", "z_sb", "z_sl", "u_sb", "u_sl")]


class _CombineBwdArgs(ctypes.Structure):
    _fields_ = [("dir", _CombineBwdDir * 2)]


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _channel_contiguous(t: torch.Tensor | None) -> torch.Tensor | None:
    """The kernels take any batch/length strides but need channel stride 1;
    a tensor without it is copied."""
    return t if t is None or t.stride(-1) == 1 else t.contiguous()


def _check_dir(u, dt, A, B, C, D, z):
    """Validate one direction's operands for a kernel (dt None in the
    fuse_dt form; D or z None, the scan without them); returns them with
    channel stride 1 and A, D as contiguous fp32 on u's device."""
    bsz, seqlen, d = u.shape
    n = A.shape[1]
    if u.dtype not in _DTYPE_CODES:
        raise TypeError(f"the scan kernels take float32 or bfloat16, not {u.dtype}")
    streams = (("dt", dt, (bsz, seqlen, d)), ("z", z, (bsz, seqlen, d)),
               ("B", B, (bsz, seqlen, n)), ("C", C, (bsz, seqlen, n)))
    for name, t, shape in streams:
        if t is None and name in ("dt", "z"):
            continue
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != u.dtype:
            raise TypeError(f"{name} is {t.dtype} but u is {u.dtype}; the kernels "
                            "take one stream dtype")
        if t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, u on {u.device}")
    if tuple(A.shape) != (d, n) or (D is not None and tuple(D.shape) != (d,)):
        raise ValueError(f"A {tuple(A.shape)} / D {None if D is None else tuple(D.shape)} "
                         f"do not match D={d}, N={n}")
    u, dt, z, B, C = (_channel_contiguous(t) for t in (u, dt, z, B, C))
    A = A.to(device=u.device, dtype=torch.float32).contiguous()
    D = None if D is None else D.to(device=u.device, dtype=torch.float32).contiguous()
    return u, dt, A, B, C, D, z


def _zeros_for(D, u):
    """D, or the exact zero vector the scan without D stands for."""
    return torch.zeros(u.shape[-1], device=u.device) if D is None else D


def _stream_strides(u, dt, z, B, C) -> list[int]:
    dt_strides = (0, 0) if dt is None else (dt.stride(0), dt.stride(1))
    z_strides = (0, 0) if z is None else (z.stride(0), z.stride(1))
    return [u.stride(0), u.stride(1), *dt_strides, *z_strides,
            B.stride(0), B.stride(1), C.stride(0), C.stride(1)]


# kWholeRank of the fuse_dt kernel: the largest dt rank whose operands a block
# holds whole; past it the kernel's windowed form runs.
FDT_WHOLE_RANK = 400
# The shared memory a block can hold on an H100 (227 KB), opted in: the
# fuse_dt kernel's, which grows with the dt rank to FDT_WHOLE_RANK, must
# stay within it, and so must the windowed form's.
SMEM_PER_BLOCK = 232448


def _check_fold(u, dtr, W, bias):
    """The fuse_dt form's (dtr, W, bias) for a kernel: dtr (B, L, R) and W
    (R, D) in u's dtype, any R; returns dtr with rank stride 1, W
    as Wt (D, R) with rank stride 1 (dt_proj's own layout: no copy for
    ``weight.t()``), bias as contiguous fp32 (zeros where None)."""
    bsz, seqlen, d = u.shape
    rank = dtr.shape[-1]
    if tuple(dtr.shape) != (bsz, seqlen, rank) or tuple(W.shape) != (rank, d):
        raise ValueError(f"dtr {tuple(dtr.shape)} / W {tuple(W.shape)} do not match "
                         f"u {tuple(u.shape)}")
    for name, t in (("dtr", dtr), ("W", W)):
        if t.dtype != u.dtype or t.device != u.device:
            raise TypeError(f"{name} is {t.dtype} on {t.device}; u is {u.dtype} on {u.device}")
    bias = (torch.zeros(d, device=u.device) if bias is None
            else bias.to(device=u.device, dtype=torch.float32).contiguous())
    return _channel_contiguous(dtr), _channel_contiguous(W.t()), bias


def _n_chunks(seqlen: int) -> int:
    return math.ceil(seqlen / STATE_CHUNK)


def _scan_dir_args(u, dt, A, B, C, D, z, save_states, x0=None, fold=None, out=None):
    """The kernel's arguments for one direction; ``x0`` (B, N, D) fp32
    contiguous selects the with_state form, whose final state is returned
    beside the outputs (xfin, else None); ``fold`` = (dtr, W, bias), with dt
    None, the fuse_dt form's operands; ``out``: the output to write (an fp32
    plane of partials for an ungated launch, whose D and z are None)."""
    u, dt, A, B, C, D, z = _check_dir(u, dt, A, B, C, D, z)
    if A.shape[1] > SLICE_STATES:
        raise ValueError(f"a launch takes at most {SLICE_STATES} states, not {A.shape[1]}")
    dtr, Wt, bias = (None, None, None) if fold is None else _check_fold(u, *fold)
    bsz, seqlen, d = u.shape

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=u.device)

    out = empty(bsz, seqlen, d, dtype=u.dtype) if out is None else out
    xb = empty(bsz, _n_chunks(seqlen), A.shape[1], d) if save_states else None
    xfin = None if x0 is None else empty(*x0.shape)
    args = _ScanDir(
        u.data_ptr(), _ptr(dt), _ptr(z), B.data_ptr(), C.data_ptr(), A.data_ptr(), _ptr(D),
        out.data_ptr(), *(_ptr(t) for t in (xb, x0, xfin)),
        *_stream_strides(u, dt, z, B, C), *(_ptr(t) for t in (dtr, Wt, bias)),
        *((0, 0, 0, 0) if fold is None else (dtr.stride(0), dtr.stride(1), Wt.stride(0),
                                             dtr.shape[-1])))
    # Keep every buffer alive until the launch is enqueued.
    return args, out, xb, xfin, (u, dt, z, B, C, A, D, x0, dtr, Wt, bias)


def _slice_dir(args: tuple, n0: int, n1: int) -> tuple:
    """One direction's (u, dt, A, B, C, D, z) on states [n0, n1), for an
    ungated launch: its rows of A, its columns of B and C, no D, no z."""
    u, dt, A, B, C = args[:5]
    return u, dt, A[:, n0:n1], B[..., n0:n1], C[..., n0:n1], None, None


def _launch_dual(lib, entry: str, args_f, args_r, u, dstate: int) -> None:
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        status = getattr(lib, entry)(ctypes.byref(args_f), ctypes.byref(args_r), *u.shape,
                                     dstate, _DTYPE_CODES[u.dtype], stream)
    _build.check_status(status, lib.aum_scan_error_string, f"{entry} kernel launch")


def _check_pair(u, u_rev):
    if u_rev.shape != u.shape or u_rev.dtype != u.dtype or u_rev.device != u.device:
        raise ValueError("both directions must share shape, dtype and device")


def _dual_launches(entry: str, fwd: tuple, rev: tuple, save_states: bool,
                   folds: tuple = (None, None)):
    """The dual forward ``entry`` on both directions: one gated launch, or
    where the kernels slice one ungated launch per slice of states and the
    combine. Returns (y_fwd, y_rev, xb_fwd, xb_rev, launches, sliced)."""
    u, n = fwd[0], fwd[2].shape[1]
    if rev[2].shape[1] != n:
        raise ValueError("both directions must share d_state")
    if not (sliced_form(n, fwd[6]) or sliced_form(n, rev[6])):
        fwd, rev = (a[:5] + (_zeros_for(a[5], a[0]), a[6]) for a in (fwd, rev))
        args_f, out_f, xb_f, _, keep_f = _scan_dir_args(*fwd, save_states, fold=folds[0])
        args_r, out_r, xb_r, _, keep_r = _scan_dir_args(*rev, save_states, fold=folds[1])
        _launch_dual(_lib(), entry, args_f, args_r, u, n)
        del keep_f, keep_r
        return out_f, out_r, xb_f, xb_r, 1, False
    slices = state_slices(n)
    parts = [torch.empty((len(slices),) + tuple(u.shape), device=u.device) for _ in range(2)]
    xbs = ([], [])
    for i, (n0, n1) in enumerate(slices):
        args_f, _, xb_f, _, keep_f = _scan_dir_args(*_slice_dir(fwd, n0, n1), save_states,
                                                    fold=folds[0], out=parts[0][i])
        args_r, _, xb_r, _, keep_r = _scan_dir_args(*_slice_dir(rev, n0, n1), save_states,
                                                    fold=folds[1], out=parts[1][i])
        _launch_dual(_sliced_lib(), entry, args_f, args_r, u, n1 - n0)
        del keep_f, keep_r
        if save_states:
            xbs[0].append(xb_f)
            xbs[1].append(xb_r)
    out_f, out_r = scan_combine_cuda([(parts[0],) + (fwd[0], fwd[5], fwd[6]),
                                      (parts[1],) + (rev[0], rev[5], rev[6])])
    xb_f, xb_r = (torch.cat(x, dim=2) if save_states else None for x in xbs)
    return out_f, out_r, xb_f, xb_r, len(slices), True


def selective_scan_dual_cuda(fwd: tuple, rev: tuple, save_states: bool = False,
                             direct: bool | None = None):
    """Launch a dual forward kernel on (u, dt, A, B, C, D, z) per direction:
    the staged one, or the direct one under AUM_SCAN_DIRECT=1 (``direct``
    None: the switch decides; False: the staged one whatever it says), the
    staged one in its stage form under AUM_SCAN_BF16_STAGE=1 (bf16). Above
    SLICE_STATES states or without z, the kernel's ungated form once per
    slice of states, then the combine (``sliced_form``); D None is zero.

    Returns (y_fwd, y_rev), and with ``save_states`` also (xb_fwd, xb_rev).
    """
    u = fwd[0]
    _check_pair(u, rev[0])
    direct = direct_forward_chosen() if direct is None else direct
    stage = bf16_stage_chosen(u.dtype, direct)
    entry = ("aum_selective_scan_dual_direct_fwd" if direct else
             "aum_selective_scan_dual_stage_fwd" if stage else "aum_selective_scan_dual_fwd")
    out_f, out_r, xb_f, xb_r, k, sliced = _dual_launches(entry, fwd, rev, save_states)
    if direct:
        selective_scan_dual.direct_launches += k
        selective_scan_dual.direct_save_states_launches += k * save_states
    elif stage:
        selective_scan_dual.stage_launches += k
        selective_scan_dual.stage_save_states_launches += k * save_states
    else:
        selective_scan_dual.launches += k
        selective_scan_dual.save_states_launches += k * save_states
    selective_scan_dual.sliced_launches += k * sliced
    return (out_f, out_r, xb_f, xb_r) if save_states else (out_f, out_r)


def selective_scan_dual_fdt_cuda(fwd: tuple, rev: tuple):
    """Launch the fuse_dt dual forward (eval) on (u, dtr, W, A, B, C, D, z,
    bias) per direction (see ``selective_scan_dual_fdt_plain``), sliced as
    ``selective_scan_dual_cuda`` is.

    Returns (y_fwd, y_rev).
    """
    u = fwd[0]
    _check_pair(u, rev[0])
    out_f, out_r, _, _, k, sliced = _dual_launches(
        "aum_selective_scan_dual_fdt_fwd", (u, None) + tuple(fwd[3:8]),
        (rev[0], None) + tuple(rev[3:8]), False,
        folds=((fwd[1], fwd[2], fwd[8]), (rev[1], rev[2], rev[8])))
    selective_scan_dual.fdt_launches += k
    selective_scan_dual.sliced_launches += k * sliced
    return out_f, out_r


def _launch_single(lib, kargs, reverse: bool, u, dstate: int) -> None:
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        status = lib.aum_selective_scan_fwd(ctypes.byref(kargs), int(bool(reverse)),
                                            *u.shape, dstate, _DTYPE_CODES[u.dtype], stream)
    _build.check_status(status, lib.aum_scan_error_string, "selective_scan kernel launch")


def selective_scan_cuda(args: tuple, reverse: bool, save_states: bool = False,
                        initial_state: torch.Tensor | None = None,
                        return_final_state: bool = False):
    """Launch the single-direction forward kernel on (u, dt, A, B, C, D, z),
    sliced as ``selective_scan_dual_cuda`` is.

    Returns what ``selective_scan_plain`` returns. The with_state form runs
    when an initial state is given or the final state is asked for (from
    zeros when only the latter); states cross in (B, D, N) and the kernel
    takes (B, N, D), so the wrapper transposes them (each slice takes its
    states' rows).
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
    if not sliced_form(n, args[6]):
        kargs, out, xb, xfin, keep = _scan_dir_args(
            *args[:5], _zeros_for(args[5], u), args[6], save_states, x0)
        _launch_single(_lib(), kargs, reverse, u, n)
        del keep
        k = 1
    else:
        slices = state_slices(n)
        parts = torch.empty((len(slices),) + tuple(u.shape), device=u.device)
        xbs, fins = [], []
        for i, (n0, n1) in enumerate(slices):
            kargs, _, xb_s, fin_s, keep = _scan_dir_args(
                *_slice_dir(args, n0, n1), save_states,
                None if x0 is None else x0[:, n0:n1].contiguous(), out=parts[i])
            _launch_single(_sliced_lib(), kargs, reverse, u, n1 - n0)
            del keep
            xbs.append(xb_s)
            fins.append(fin_s)
        (out,) = scan_combine_cuda([(parts, u, args[5], args[6])])
        xb = torch.cat(xbs, dim=2) if save_states else None
        xfin = torch.cat(fins, dim=1) if with_state else None
        k = len(slices)
        selective_scan.sliced_launches += k
    selective_scan.launches += k
    result = (out,)
    if save_states:
        selective_scan.save_states_launches += k
        result += (xb,)
    if with_state:
        selective_scan.with_state_launches += k
        if return_final_state:
            result += (xfin.transpose(1, 2),)
    return result if len(result) > 1 else out


def scan_combine_cuda(items: list) -> list:
    """Launch the combine kernel once for one or two directions: per
    direction (parts, u, D, z), parts the (S, B, L, D) fp32 slice partials
    (contiguous), D or z None. Returns each direction's output (see
    ``scan_combine_plain``)."""
    u0 = items[0][1]
    args = _CombineArgs()
    outs, keep = [], []
    for i, (parts, u, D, z) in enumerate(items):
        if (parts.dtype != torch.float32 or not parts.is_contiguous()
                or tuple(parts.shape[1:]) != tuple(u0.shape) or u.shape != u0.shape
                or u.dtype != u0.dtype or (z is not None and z.shape != u.shape)):
            raise ValueError("the combine takes contiguous fp32 (S, B, L, D) partials and "
                             "(B, L, D) streams of one dtype")
        u, z = _channel_contiguous(u), _channel_contiguous(z)
        D = _zeros_for(D, u).to(device=u.device, dtype=torch.float32).contiguous()
        out = torch.empty(u.shape, dtype=u.dtype, device=u.device)
        args.dir[i] = _CombineDir(parts.data_ptr(), u.data_ptr(), _ptr(z), D.data_ptr(),
                                  out.data_ptr(), u.stride(0), u.stride(1),
                                  *((0, 0) if z is None else (z.stride(0), z.stride(1))))
        outs.append(out)
        keep.append((u, z, D))
    lib = _combine_lib()
    with torch.cuda.device(u0.device):
        stream = torch.cuda.current_stream(u0.device).cuda_stream
        status = lib.aum_scan_combine_fwd(ctypes.byref(args), len(items), items[0][0].shape[0],
                                          *u0.shape, _DTYPE_CODES[u0.dtype], stream)
    del keep
    _build.check_status(status, lib.aum_scan_combine_error_string, "scan_combine kernel launch")
    scan_combine_cuda.launches += 1
    return outs


scan_combine_cuda.launches = 0


def scan_combine_bwd_cuda(items: list) -> list:
    """Launch the combine's backward kernel once for one or two directions:
    per direction (du_parts, dd_parts, y_parts, g, z, u, D), the partials
    (S, B, L, D) fp32 contiguous (y_parts None without z). Returns per
    direction (du, ddelta, dz, dD, dbias) (see ``scan_combine_bwd_plain``)."""
    u0 = items[0][5]
    bsz, seqlen, d = u0.shape
    args = _CombineBwdArgs()
    outs, keep = [], []
    for i, (du_p, dd_p, y_p, g, z, u, D) in enumerate(items):
        g, z, u = (_channel_contiguous(t) for t in (g, z, u))
        Dk = _zeros_for(D, u).to(device=u.device, dtype=torch.float32).contiguous()

        def empty(*shape, dtype=torch.float32):
            return torch.empty(shape, dtype=dtype, device=u.device)

        du, ddelta = empty(*u.shape, dtype=u.dtype), empty(*u.shape, dtype=u.dtype)
        dz = None if z is None else empty(*u.shape, dtype=u.dtype)
        # One dD and dbias partial row per (b, chunk of COMBINE_BWD_CHUNK steps).
        dD_p, dbias_p = (empty(bsz * math.ceil(seqlen / COMBINE_BWD_CHUNK), d)
                         for _ in range(2))
        args.dir[i] = _CombineBwdDir(
            du_p.data_ptr(), dd_p.data_ptr(), _ptr(y_p), g.data_ptr(), _ptr(z), u.data_ptr(),
            Dk.data_ptr(), du.data_ptr(), ddelta.data_ptr(), _ptr(dz), dD_p.data_ptr(),
            dbias_p.data_ptr(), g.stride(0), g.stride(1),
            *((0, 0) if z is None else (z.stride(0), z.stride(1))), u.stride(0), u.stride(1))
        outs.append((du, ddelta, dz, dD_p, dbias_p, D is None))
        keep.append((du_p, dd_p, y_p, g, z, u, Dk))
    lib = _combine_lib()
    with torch.cuda.device(u0.device):
        stream = torch.cuda.current_stream(u0.device).cuda_stream
        status = lib.aum_scan_combine_bwd(ctypes.byref(args), len(items),
                                          items[0][0].shape[0], bsz, seqlen, d,
                                          _DTYPE_CODES[u0.dtype], stream)
    del keep
    _build.check_status(status, lib.aum_scan_combine_error_string,
                        "scan_combine_bwd kernel launch")
    scan_combine_bwd_cuda.launches += 1
    return [(du, ddelta, dz, None if no_d else dD_p.sum(dim=0), dbias_p.sum(dim=0))
            for du, ddelta, dz, dD_p, dbias_p, no_d in outs]


scan_combine_bwd_cuda.launches = 0


def _bwd_launch(fused: bool, sliced: bool, items: list, bsz: int, seqlen: int, d: int, n: int,
                dtype: torch.dtype, softplus: bool, xminus: bool, bf16_partials: bool) -> list:
    """One launch of a backward kernel (gated, or on one slice of ``n``
    states), per direction of ``items``: (u, dt, A, B, C, D, z, g, xb,
    reverse, gfin, du, ddelta, dz), the last three the outputs to write.
    Returns per direction its (dA, dD, dbias, dbc) partials (an ungated
    slice's dD and dbias None: the combine's backward forms them) and dx0
    (B, n, D) (None without gfin)."""
    n_parts = math.ceil(d / (BWD_FUSED_BLOCK_CHANNELS if fused else BWD_BLOCK_CHANNELS))
    device = items[0][0].device
    args = _ScanBwdArgs()
    outs, keep = [], []
    for i, (u, dt, A, B, C, D, z, g, xb, reverse, gfin, du, ddelta, dz) in enumerate(items):
        def empty(*shape, dtype=torch.float32):
            return torch.empty(shape, dtype=dtype, device=device)

        dx0 = None if gfin is None else empty(bsz, n, d)
        dA_p = empty(bsz, n, d)
        dD_p, dbias_p = (None, None) if sliced else (empty(bsz, d), empty(bsz, d))
        dbc_p = empty(n_parts, bsz, seqlen, 2 * SLICE_STATES,
                      dtype=torch.bfloat16 if bf16_partials else torch.float32)
        args.dir[i] = _ScanBwdDir(
            u.data_ptr(), dt.data_ptr(), _ptr(z), B.data_ptr(), C.data_ptr(), A.data_ptr(),
            _ptr(D), g.data_ptr(), xb.data_ptr(), du.data_ptr(), ddelta.data_ptr(), _ptr(dz),
            dA_p.data_ptr(), _ptr(dD_p), _ptr(dbias_p), dbc_p.data_ptr(),
            _ptr(gfin), _ptr(dx0), *_stream_strides(u, dt, z, B, C), g.stride(0), g.stride(1),
            int(bool(reverse)), int(bool(softplus)), int(xminus), int(bf16_partials))
        outs.append((dA_p, dD_p, dbias_p, dbc_p, dx0))
        keep.append((u, dt, z, B, C, A, D, g, xb, gfin))
    if fused:
        lib, prefix = (_bwd_fused_sliced_lib() if sliced else _bwd_fused_lib()), "scan_bwd_fused"
    else:
        lib, prefix = (_bwd_sliced_lib() if sliced else _bwd_lib()), "scan_bwd"
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = getattr(lib, f"aum_selective_{prefix}")(
            ctypes.byref(args), len(items), bsz, seqlen, d, n, _DTYPE_CODES[dtype], stream)
    del keep
    _build.check_status(status, getattr(lib, f"aum_{prefix}_error_string"),
                        f"selective_{prefix} kernel launch")
    return outs


def selective_scan_bwd_cuda(dirs: list, gs: list, xbs: list, softplus: bool = True,
                            gfins: list | None = None) -> list:
    """Launch a backward kernel once for one or two directions: K2, or the
    fused kernel under AUM_SCAN_BWD_FUSED=1 (see ``fused_backward_chosen``);
    K2 in its x-minus form under AUM_SCAN_BWD_XMINUS=1 or AUM_SCAN_BWD_DBU=1
    (``bwd_dla_mode``), either kernel with bf16 dB/dC partials under
    AUM_SCAN_BWD_BF16_PARTIALS=1 (``bwd_bf16_partials_chosen``). Where the
    forward slices (``sliced_form``), the chosen kernel's ungated form once
    per slice of states, then the combine's backward.

    dirs: per direction (u, dt, A, B, C, D, z, reverse) (D or z may be None);
    gs: the output cotangents; xbs: the forward's saved states; ``gfins``:
    per direction the (B, D, N) cotangent of the final state, for K2's
    with_state form (one direction; never fused), whose starting state is
    xb's first entry. Returns what ``selective_scan_bwd_plain`` returns.
    """
    if not 1 <= len(dirs) <= 2 or len(gs) != len(dirs) or len(xbs) != len(dirs):
        raise ValueError("the backward kernels take one or two directions")
    with_state = gfins is not None
    if with_state and (len(dirs) != 1 or len(gfins) != 1):
        raise ValueError("the with_state backward takes one direction")
    fused = not with_state and fused_backward_chosen(len(dirs))
    xminus = (not fused and not _dual_bwd_kernel_chosen(len(dirs))
              and bwd_dla_mode() != "xprev")
    bf16_partials = bwd_bf16_partials_chosen(len(dirs))
    u0 = dirs[0][0]
    bsz, seqlen, d = u0.shape
    n = dirs[0][2].shape[1]
    sliced = any(sliced_form(n, dr[6]) for dr in dirs)
    checked = []
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
        gfin = None
        if with_state:
            if tuple(gfins[i].shape) != (bsz, d, n) or gfins[i].device != u.device:
                raise ValueError(f"the final state's cotangent {tuple(gfins[i].shape)} on "
                                 f"{gfins[i].device} must be ({bsz}, {d}, {n}) on {u.device}")
            gfin = gfins[i].float().transpose(1, 2).contiguous()  # the kernel's (B, N, D)
        checked.append((u, dt, A, B, C, D, z, g, xb, reverse, gfin))
    launch = functools.partial(_bwd_launch, fused, sliced, bsz=bsz, seqlen=seqlen, d=d,
                               dtype=u0.dtype, softplus=softplus, xminus=xminus,
                               bf16_partials=bf16_partials)
    grads = []
    if not sliced:
        items = []
        for u, dt, A, B, C, D, z, g, xb, reverse, gfin in checked:
            du, ddelta, dz = (torch.empty(u.shape, dtype=u.dtype, device=u.device)
                              for _ in range(3))
            items.append((u, dt, A, B, C, _zeros_for(D, u), z, g, xb, reverse, gfin,
                          du, ddelta, dz))
        for item, dr, (dA_p, dD_p, dbias_p, dbc_p, dx0) in zip(items, dirs,
                                                                launch(items=items, n=n)):
            dbc = dbc_p.sum(dim=0, dtype=torch.float32)  # (B, L, 32): [:N] dB, [16:16+N] dC
            du, ddelta, dz = item[11:]
            grads.append((du, ddelta, dA_p.sum(dim=0).t(), dbc[..., :n].to(dr[3].dtype),
                          dbc[..., SLICE_STATES:SLICE_STATES + n].to(dr[4].dtype),
                          None if dr[5] is None else dD_p.sum(dim=0), dz, dbias_p.sum(dim=0))
                         + (() if dx0 is None else (dx0.transpose(1, 2),)))
        k = 1
    else:
        slices = state_slices(n)
        planes = [[None if z is None and j == 2 else
                   torch.empty((len(slices),) + tuple(u0.shape), device=u0.device)
                   for j in range(3)] for (_, _, _, _, _, _, z, *_) in checked]
        per_dir = [{"dA": [], "dB": [], "dC": [], "dx0": []} for _ in checked]
        for s, (n0, n1) in enumerate(slices):
            items = []
            for (u, dt, A, B, C, D, z, g, xb, reverse, gfin), (du_p, dd_p, y_p) in zip(
                    checked, planes):
                items.append((u, dt, A[:, n0:n1].contiguous(), B[..., n0:n1], C[..., n0:n1],
                              None, z, g, xb[:, :, n0:n1].contiguous(), reverse,
                              None if gfin is None else gfin[:, n0:n1].contiguous(),
                              du_p[s], dd_p[s], None if y_p is None else y_p[s]))
            for acc, (dA_p, _, _, dbc_p, dx0) in zip(per_dir, launch(items=items, n=n1 - n0)):
                dbc = dbc_p.sum(dim=0, dtype=torch.float32)
                acc["dA"].append(dA_p.sum(dim=0).t())
                acc["dB"].append(dbc[..., :n1 - n0])
                acc["dC"].append(dbc[..., SLICE_STATES:SLICE_STATES + n1 - n0])
                acc["dx0"].append(dx0)
        combined = scan_combine_bwd_cuda(
            [(du_p, dd_p, y_p, g, z, u, D) for (u, _, _, _, _, D, z, g, *_), (du_p, dd_p, y_p)
             in zip(checked, planes)])
        for (du, ddelta, dz, dD, dbias), acc, dr in zip(combined, per_dir, dirs):
            grads.append((du, ddelta, torch.cat(acc["dA"], dim=1),
                          torch.cat(acc["dB"], dim=-1).to(dr[3].dtype),
                          torch.cat(acc["dC"], dim=-1).to(dr[4].dtype), dD, dz, dbias)
                         + (() if not with_state else
                            (torch.cat(acc["dx0"], dim=1).transpose(1, 2),)))
        k = len(slices)
        selective_scan_bwd.sliced_launches += k
    if fused:
        selective_scan_bwd.fused_launches += k
    else:
        selective_scan_bwd.launches += k
        selective_scan_bwd.with_state_launches += k * with_state
        selective_scan_bwd.xminus_launches += k * xminus
    selective_scan_bwd.bf16_partials_launches += k * bf16_partials
    return grads


def _load_scan_lib(name: str) -> ctypes.CDLL:
    lib = _build.library(name)
    for fn in (lib.aum_selective_scan_dual_fwd, lib.aum_selective_scan_dual_direct_fwd,
               lib.aum_selective_scan_dual_fdt_fwd, lib.aum_selective_scan_dual_stage_fwd):
        fn.argtypes = [ctypes.POINTER(_ScanDir), ctypes.POINTER(_ScanDir),
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    fn = lib.aum_selective_scan_fwd
    fn.argtypes = [ctypes.POINTER(_ScanDir)] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.aum_scan_error_string.argtypes = [ctypes.c_int]
    lib.aum_scan_error_string.restype = ctypes.c_char_p
    _build.check_constant(lib, "aum_scan_state_chunk", STATE_CHUNK)
    _build.check_constant(lib, "aum_scan_fdt_whole_rank", FDT_WHOLE_RANK)
    fn = lib.aum_scan_fdt_smem_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    # The largest rank held whole, and one past it (the windowed form, the
    # same at every rank).
    for rank in (FDT_WHOLE_RANK, FDT_WHOLE_RANK + 1):
        for dtype in (torch.float32, torch.bfloat16):
            smem = fn(rank, _DTYPE_CODES[dtype])
            if smem > SMEM_PER_BLOCK:
                raise RuntimeError(f"the fuse_dt kernel takes {smem} bytes of shared memory "
                                   f"per block at rank {rank} in {dtype}, more than the "
                                   f"{SMEM_PER_BLOCK} a block can hold")
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return _load_scan_lib("selective_scan")


@functools.cache
def _sliced_lib() -> ctypes.CDLL:
    return _load_scan_lib("selective_scan_sliced")


def _load_bwd_lib(name: str, prefix: str) -> ctypes.CDLL:
    lib = _build.library(name)
    fn = getattr(lib, f"aum_selective_{prefix}")
    fn.argtypes = [ctypes.POINTER(_ScanBwdArgs)] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    errors = getattr(lib, f"aum_{prefix}_error_string")
    errors.argtypes = [ctypes.c_int]
    errors.restype = ctypes.c_char_p
    _build.check_constant(lib, f"aum_{prefix}_state_chunk", STATE_CHUNK)
    return lib


@functools.cache
def _bwd_lib(name: str = "selective_scan_bwd") -> ctypes.CDLL:
    lib = _load_bwd_lib(name, "scan_bwd")
    _build.check_constant(lib, "aum_scan_bwd_block_channels", BWD_BLOCK_CHANNELS)
    return lib


@functools.cache
def _bwd_fused_lib(name: str = "selective_scan_bwd_fused") -> ctypes.CDLL:
    lib = _load_bwd_lib(name, "scan_bwd_fused")
    _build.check_constant(lib, "aum_scan_bwd_fused_block_channels", BWD_FUSED_BLOCK_CHANNELS)
    return lib


def _bwd_sliced_lib() -> ctypes.CDLL:
    return _bwd_lib("selective_scan_bwd_sliced")


def _bwd_fused_sliced_lib() -> ctypes.CDLL:
    return _bwd_fused_lib("selective_scan_bwd_fused_sliced")


@functools.cache
def _combine_lib() -> ctypes.CDLL:
    lib = _build.library("scan_combine")
    lib.aum_scan_combine_fwd.argtypes = [ctypes.POINTER(_CombineArgs)] + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    lib.aum_scan_combine_bwd.argtypes = [ctypes.POINTER(_CombineBwdArgs)] + [
        ctypes.c_int] * 6 + [ctypes.c_void_p]
    for fn in (lib.aum_scan_combine_fwd, lib.aum_scan_combine_bwd):
        fn.restype = ctypes.c_int
    lib.aum_scan_combine_error_string.argtypes = [ctypes.c_int]
    lib.aum_scan_combine_error_string.restype = ctypes.c_char_p
    _build.check_constant(lib, "aum_scan_combine_bwd_chunk", COMBINE_BWD_CHUNK)
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
    (one launch), the plain version on CPU tensors (``xbs`` unused there), in
    the bf16-partials form where the switches choose it (at the channels per
    block of the kernel they choose). ``states``: per direction (x0, gfin),
    the with_state form (see ``selective_scan_bwd_plain``; the kernel
    restarts from xb, which holds x0)."""
    if _on_cpu(dirs[0][0], "selective_scan_bwd"):
        partials = 0
        if bwd_bf16_partials_chosen(len(dirs)):
            fused = states is None and fused_backward_chosen(len(dirs))
            partials = BWD_FUSED_BLOCK_CHANNELS if fused else BWD_BLOCK_CHANNELS
        return selective_scan_bwd_plain(dirs, gs, softplus, states, partials)
    return selective_scan_bwd_cuda(dirs, gs, xbs, softplus,
                                   None if states is None else [s[1] for s in states])


selective_scan_bwd.launches = 0
selective_scan_bwd.sliced_launches = 0
selective_scan_bwd.with_state_launches = 0
selective_scan_bwd.fused_launches = 0
selective_scan_bwd.xminus_launches = 0
selective_scan_bwd.bf16_partials_launches = 0


# --- the op ----------------------------------------------------------------------

def _prep_both(args_fwd: tuple, args_rev: tuple):
    """(u, dt, A, B, C, D, z) per direction; bimamba v1, which shares delta
    and its bias, gets one softplus pass and one dt stream."""
    uf, df, af, bf, cf, dskf, zf, biasf = args_fwd
    ur, dr, ar, br, cr, dskr, zr, biasr = args_rev
    dt_f = _prep_dt(df, biasf)
    dt_r = dt_f if (dr is df and biasr is biasf) else _prep_dt(dr, biasr)
    return (uf, dt_f, af, bf, cf, dskf, zf), (ur, dt_r, ar, br, cr, dskr, zr)


def _forward(fwd: tuple, rev: tuple, save_states: bool, direct: bool | None = None):
    """The dual forward, kernel or plain by device; ``direct`` as
    ``selective_scan_dual_cuda`` takes it."""
    if _on_cpu(fwd[0], "selective_scan_dual"):
        direct = direct_forward_chosen() if direct is None else direct
        # The plain backward recomputes from the inputs: no states to keep.
        return (selective_scan_dual_plain(fwd, rev, bf16_stage=bf16_stage_chosen(fwd[0].dtype,
                                                                                  direct))
                + ((None, None) if save_states else ()))
    return selective_scan_dual_cuda(fwd, rev, save_states, direct)


def _dual_forward_saving(ctx, args_fwd: tuple, args_rev: tuple, direct: bool | None = None,
                         extra: tuple = ()):
    """The saving dual forward of an autograd op: runs it and saves what the
    backward needs on ``ctx``, then ``extra`` tensors (``_dual_backward``
    hands them back). Returns (y_fwd, y_rev)."""
    fwd, rev = _prep_both(args_fwd, args_rev)
    y_f, y_r, xb_f, xb_r = _forward(fwd, rev, save_states=True, direct=direct)
    # Bimamba v1 passes the same u/dt/B/C/D/z in both directions (only A
    # differs): those are saved once.
    ctx.shared = all(a is b for a, b in zip(fwd[:2] + fwd[3:], rev[:2] + rev[3:]))
    saved = fwd + (rev[2], xb_f, xb_r) if ctx.shared else fwd + rev + (xb_f, xb_r)
    ctx.save_for_backward(*saved, *extra)
    ctx.n_extra = len(extra)
    ctx.has_bias = (args_fwd[7] is not None, args_rev[7] is not None)
    return y_f, y_r


def _dual_backward(ctx, g_f, g_r):
    """The backward of ``_dual_forward_saving``: per direction (du, ddelta,
    dA, dB, dC, dD, dz, dbias), and the ``extra`` tensors."""
    saved = ctx.saved_tensors
    saved, extra = saved[:len(saved) - ctx.n_extra], saved[len(saved) - ctx.n_extra:]
    if ctx.shared:
        fwd = saved[:7]
        rev = fwd[:2] + (saved[7],) + fwd[3:]
    else:
        fwd, rev = saved[:7], saved[7:14]
    xb_f, xb_r = saved[-2:]
    gs = [torch.zeros_like(y[0]) if g is None else g
          for g, y in ((g_f, fwd), (g_r, rev))]
    return selective_scan_bwd([fwd + (False,), rev + (True,)], gs, [xb_f, xb_r]), extra


class _DualScan(torch.autograd.Function):
    """Both directions' (u, delta, A, B, C, D, z, delta_bias) -> (y_fwd, y_rev),
    with the chunk-entry states saved for the backward kernel."""

    @staticmethod
    def forward(ctx, *args16):
        return _dual_forward_saving(ctx, args16[:8], args16[8:])

    @staticmethod
    def backward(ctx, g_f, g_r):
        grads, _ = _dual_backward(ctx, g_f, g_r)
        out = []
        for (du, ddelta, dA, dB, dC, dD, dz, dbias), has_bias in zip(grads, ctx.has_bias):
            out += [du, ddelta, dA, dB, dC, dD, dz, dbias if has_bias else None]
        return tuple(out)


@contextlib.contextmanager
def _fp32_products():
    """fp32 matrix products without TF32 on the card for the block, as JAX's
    precision=HIGHEST; the setting is restored after it."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


class _DualScanFold(torch.autograd.Function):
    """The dual scan with the dt_proj product folded in, under autograd: per
    direction (u, dtr, W, A, B, C, D, z, delta_bias) -> (y_fwd, y_rev).
    ``_make_dual_scan_fdt``'s rules: the forward forms delta = dtr @ W in the
    compute dtype (torch.matmul, outside any kernel, as XLA forms it in JAX)
    and runs the staged saving dual forward (never the direct one); the
    backward is the dual scan's, then d(dtr) = ddelta W^T and dW = dtr^T
    ddelta in fp32, each cast to its input's dtype."""

    @staticmethod
    def forward(ctx, *args18):
        fold_f, fold_r = args18[:9], args18[9:]
        # Bimamba v1 passes one (dtr, W) to both directions: one product,
        # saved once.
        ctx.fold_shared = fold_r[1] is fold_f[1] and fold_r[2] is fold_f[2]
        delta_f = torch.matmul(fold_f[1], fold_f[2])
        delta_r = delta_f if ctx.fold_shared else torch.matmul(fold_r[1], fold_r[2])
        extra = fold_f[1:3] + (() if ctx.fold_shared else fold_r[1:3])
        return _dual_forward_saving(ctx, (fold_f[0], delta_f) + fold_f[3:],
                                    (fold_r[0], delta_r) + fold_r[3:], direct=False,
                                    extra=extra)

    @staticmethod
    def backward(ctx, g_f, g_r):
        grads, extra = _dual_backward(ctx, g_f, g_r)
        folds = (extra[:2], extra[:2] if ctx.fold_shared else extra[2:])
        out = []
        for (du, ddelta, dA, dB, dC, dD, dz, dbias), (dtr, W), has_bias in zip(
                grads, folds, ctx.has_bias):
            with _fp32_products():
                dd = ddelta.float()
                d_dtr = (dd @ W.float().t()).to(dtr.dtype)
                dW = (dtr.float().flatten(0, 1).t() @ dd.flatten(0, 1)).to(W.dtype)
            out += [du, d_dtr, dW, dA, dB, dC, dD, dz, dbias if has_bias else None]
        return tuple(out)


def selective_scan_dual(args_fwd: tuple, args_rev: tuple, dt_fold: tuple | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused bidirectional selective scan.

    args_fwd / args_rev: (u, delta, A, B, C, D, z, delta_bias) for the
    forward-scanning and the reverse-scanning direction (bimamba v1 passes
    the same tensors in both, with its own A; autograd sums their grads).
    delta is pre-softplus; D or z may be None (no skip term; no gate), as
    the JAX op's oracle path takes them. Returns (y_fwd, y_rev); the caller
    sums them. Differentiable: when a
    grad is needed the forward kernel saves its chunk-entry states and the
    backward kernel runs in the backward pass; otherwise the eval forward
    runs alone.

    ``dt_fold`` = ((dtr_f, W_f), (dtr_r, W_r)), with None in the delta slots
    (AUM_SCAN_FUSE_DT=1; bimamba v1 passes one pair to both): the (B, L, R)
    dt-rank columns of x_proj's output and the (R, D) dt_proj weight per
    direction, delta = dtr @ W; delta_bias keeps its role. Without a grad
    the fuse_dt kernel forms dt itself, in fp32; under autograd
    ``_DualScanFold`` runs.
    """
    _on_cpu(args_fwd[0], "selective_scan_dual")
    tensors = [t for t in args_fwd + args_rev if t is not None]
    if dt_fold is not None:
        (dtr_f, w_f), (dtr_r, w_r) = dt_fold
        fold_f = (args_fwd[0], dtr_f, w_f) + tuple(args_fwd[2:])
        fold_r = (args_rev[0], dtr_r, w_r) + tuple(args_rev[2:])
        if torch.is_grad_enabled() and any(t.requires_grad for t in tensors + [dtr_f, w_f,
                                                                                 dtr_r, w_r]):
            return _DualScanFold.apply(*fold_f, *fold_r)
        if _on_cpu(args_fwd[0], "selective_scan_dual"):
            return selective_scan_dual_fdt_plain(fold_f, fold_r)
        return selective_scan_dual_fdt_cuda(fold_f, fold_r)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _DualScan.apply(*args_fwd, *args_rev)
    fwd, rev = _prep_both(args_fwd, args_rev)
    return _forward(fwd, rev, save_states=False)


selective_scan_dual.launches = 0
selective_scan_dual.sliced_launches = 0
selective_scan_dual.save_states_launches = 0
selective_scan_dual.direct_launches = 0
selective_scan_dual.direct_save_states_launches = 0
selective_scan_dual.fdt_launches = 0
selective_scan_dual.stage_launches = 0
selective_scan_dual.stage_save_states_launches = 0


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
                   B: torch.Tensor, C: torch.Tensor, D: torch.Tensor | None = None,
                   z: torch.Tensor | None = None,
                   delta_bias: torch.Tensor | None = None, delta_softplus: bool = False,
                   reverse: bool = False, initial_state: torch.Tensor | None = None,
                   return_final_state: bool = False):
    """Single-direction selective scan (see ``ops/scan_ref.py`` for the math).

    u, delta, z: (B, L, D); A: (D, N); B, C: (B, L, N); D, delta_bias: (D,);
    ``reverse`` scans right to left. D or z may be None (no skip term; no
    gate), as the JAX op takes them. ``initial_state`` (B, D, N) starts the
    recurrence from a carried state, and ``return_final_state`` also returns the (B, D, N) fp32
    state after the last processed step (position 0 when reversed).
    Returns y (B, L, D) in u's dtype, or (y, final state).

    Differentiable in every form: when a grad is needed the forward kernel
    saves its chunk-entry states and a one-direction backward kernel runs in
    the backward pass; with a carried or returned state it is K2's with_state
    form, which also gives the grad of ``initial_state``, so chained segments
    (each started from the previous one's final state) differentiate as one
    scan.
    """
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
selective_scan.sliced_launches = 0
selective_scan.save_states_launches = 0
selective_scan.with_state_launches = 0
