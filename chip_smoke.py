#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``aum_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py

Phases (each prints JSON lines; any failure raises and the exit code is not 0):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; build: nvcc compiles every kernel from ``aum_tpu_torch/csrc/``
   (all sources at once) and the build time is printed, with ptxas's
   registers and spills; occupancy: per scan kernel instantiation, the
   blocks and warps per SM the occupancy calculator allows, its registers,
   spill bytes and shared memory (each scan library's ``aum_kernel_info``).
2. kernels: each kernel against its plain PyTorch version on the card, in
   fp32 and bf16. The dual scan forward, v1 (shared operands) and v2
   (separate), both directions, at the Fo-Bi eval path's shapes (B=8, L=513,
   D=1536, N=16, strided operands as the model passes them); its saving form
   (outputs and states), the scan backward in both forms (one launch for both
   directions, one launch per direction; all 8 grads per direction) and the
   conv backward at the train path's shapes (B=12, L=513). The
   single-direction scan forward, forward and reverse: at the Fo-Fo eval
   shapes (B=8) as is and in its with_state form (outputs and final state
   from a random x0); its saving form (outputs and states) and the backward
   of its autograd op (all 8 grads, through the one-direction backward) at
   B=12. The conv forward, causal and anti-causal. All of them also at
   ragged shapes (L=37, D=40; L=150, three state chunks, the last short),
   the scan kernels at L=37, D=40 also with d_state 5, which leaves the
   last of the backward's 4 lanes per chain with part of its states or
   none. The backward (K2 and fused, one launch for both directions and one
   per direction) also without the softplus.
   The kernels behind ``aum_tpu``'s switches, at the same shapes: the
   direct dual forward (AUM_SCAN_DIRECT=1; eval and saving) against the
   plain version and the staged kernel, the fused backward
   (AUM_SCAN_BWD_FUSED=1; one and both directions) against the plain
   backward and K2; K2's with_state form (the 9 grads, d(x0) the last, from
   a random x0 and final-state cotangent) and its form without the softplus
   through the autograd op; and a scan split at an uneven point into two
   segments chained by their states against the unsplit scan, outputs and
   grads, forward and reverse (train and ragged shapes).
   The four opt-in forms: the fuse_dt dual forward (AUM_SCAN_FUSE_DT=1;
   dtr read in place from an x_proj-shaped output, dt rank 48, and 12 at
   the ragged shapes) against its plain version and against the staged
   kernel fed the materialised dt, v1 and v2, fp32 and bf16; the stage form
   (AUM_SCAN_BF16_STAGE=1), eval and saving, against its plain version, and
   bit-equal to the default kernel in fp32; K2 and the fused kernel with
   bf16 partials against their fp32-partials launches (dB, dC at the bf16
   grad tolerance, the rest bit-equal), one and both directions; K2's
   x-minus form against the plain backward, one and both directions and
   with_state; each also shows its form's launch count rose. The
   redesigned kernels at the edges of their designs (``_check_edges``): the
   fuse_dt forward at dt ranks 1, 16, 17, 47 (unaligned dtr rows) and 64 and
   at L = 1, 15, 16, 17, 65, 81 with D=136; the conv forward and backward at
   D=36, on a slice at an odd channel offset, at L=1 and one past its tile;
   the fused backward (with the saving forward that feeds it) against the
   plain version and K2, one and both directions, with and without the
   softplus, at L = 1, 63, 64, 65, 127, 128, 129, 513 with D = 40 and 136,
   with d_state 5, and with bf16 partials against its fp32-partials launch.
   Then the small-dt probe: ddelta at dt in [1e-6, 1e-4] from K2 and the fused
   kernel in fp32, and from the plain version, each against fp64; a kernel
   fails it if its relative error exceeds the plain version's by more than
   SMALL_DT_RATIO.
3. model: AuM-Base Fo-Bi at full width and depth 24. fp32, B=2: the card
   (with kernels) against the same weights on the CPU (plain path). Then the
   eval path itself, ``aum_tpu_torch.entry.entry()`` (bf16, B=8), with every
   launch counter set to 0 just before and read just after: it must show 24
   dual-scan and 24 conv launches and no other, and (8, 527) finite logits;
   then its latency (CUDA events, 10 forwards after warm-up). Then the fp32
   check and ``entry()`` again under AUM_SCAN_DIRECT=1: 24 direct launches
   and no staged one; under AUM_SCAN_FUSE_DT=1 (fp32 check too), alone and
   with AUM_SCAN_DIRECT=1: 24 fuse_dt launches and no other scan launch;
   under AUM_SCAN_BF16_STAGE=1: 24 stage launches (``EVAL_SWITCHES``).
4. wav: AuM-Base Fo-Fo at full width and depth 24 from 10 s waveforms
   (160,000 samples: the Kaldi fbank, pad to 1024 frames, AudioSet's
   normalization, the model). fp32, B=2: the card (kernels and frontend)
   against the same weights on the CPU. Then the path itself,
   ``aum_tpu_torch.entry.wav_entry()`` (bf16, B=8), between a reset and a read
   of every launch counter: 24 single-direction scan and 24 conv launches
   and no other, no graph, (8, 527) finite logits; then its latency and the
   frontend's share of it, timed alone.
5. train: at full width, depth 2, fp32, B=2, for Fo-Bi and for Fo-Fo: the
   loss and the grads of in_proj, A_log (and Fo-Bi's A_b_log), dt_proj.bias,
   conv1d.weight, x_proj.weight and dt_proj.weight, and those params after
   one full train step (Adam, no
   warmup), on the card against the same weights on the CPU (plain path);
   the launches of the card's forward and backward are read (Fo-Fo: 2 saving
   single-direction forwards and 2 one-direction backwards).
   Then the train path itself, ``aum_tpu_torch.entry.train_entry()`` (Fo-Bi,
   depth 24, bf16, B=12, split remat): three steps with finite losses, one of
   them between a reset and a read of every launch counter (24 saving
   forwards, 24 backwards, 96 conv launches: forward, split recompute, and
   the backward's pre-activation and dx); then ms per step and clips/s (CUDA
   events after warm-up), peak memory, SM clock and power. The fp32 checks
   also run under the switches (Fo-Fo: AUM_SCAN_BWD_FUSED=1; Fo-Bi: both),
   and the train path under both switches launches 24 direct saving
   forwards, 24 fused backwards and no K2; its ms per step are timed in
   turns with the default path's (default, switched, switched, default).
   The Fo-Bi fp32 check also runs under AUM_SCAN_FUSE_DT=1, and the train
   path's launches are checked under the sets of ``TRAIN_CHECK_SWITCHES``:
   the fuse_dt rule (24 staged saving forwards and 24 K2, with
   AUM_SCAN_DIRECT=1 too), and every opt-in form at once (the stage form's
   saving forward, K2 in its x-minus form or the fused kernel, bf16
   partials).
6. bench: the ``bench.py`` workload (Fo-Bi, B=64 x 1024 x 128, bf16):
   clips/s with CUDA events after warm-up; then ``wav_entry``'s model at
   B=64 from waveforms: clips/s, and the frontend's ms alone. Then per kernel
   at the shapes those forwards give it: ms per launch, the plain version's
   ms, the least time the card could take (bound), and for the conv one
   PyTorch call computing the same function (``F.conv1d(groups=D)`` + SiLU)
   as a yardstick the port never calls. The scan bounds let a share of the
   exponentials run on the FP32 pipe (``exp_floor_s``). nvidia-smi samples
   the SM clock and power draw during the timed forwards and the timed
   kernel launches. Then the train shapes' scan kernels (B=12, bf16): the
   saving dual forward, the backward (both directions in one launch, and one
   direction), and the saving single-direction forward, each beside its plain
   version and its bound; the direct and fused kernels beside them (the
   fused backward and K2 in turns: fused, K2, K2, fused), and
   K2's with_state form, the stage form's saving forward, K2 with bf16
   partials and in its x-minus form (in turns with the default) and the
   fused kernel with bf16 partials. At the bench shapes also the fuse_dt
   form (its bound adds the dt_proj product on the tensor cores) and the
   stage form. B=64 Fo-Bi clips/s are timed in turns: default,
   AUM_SCAN_DIRECT=1, AUM_SCAN_FUSE_DT=1, AUM_SCAN_FUSE_DT=1,
   AUM_SCAN_DIRECT=1, default.
7. profile: one Fo-Bi bench forward (and one under AUM_SCAN_FUSE_DT=1),
   one Fo-Fo forward from waveforms (B=64), then one train step, under
   ``torch.profiler``: device time by
   kernel category (dual and single scan forward, scan backward, conv,
   frontend FFTs, matrix products, other), the top kernels, and the device's
   idle share of the wall time.

Every phase runs with the switches (``SWITCHES``) off and sets them
itself, restoring the environment after; each prints its seconds. The line
before the last is nvidia-smi's name and power limit; the one before it the
kernels summary; the last line is exactly
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

import torch

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
FP32_PIPE_OPS_PER_S = FP32_FLOPS_PER_S / 2  # an FMA is two flops, one instruction
BF16_TENSOR_FLOPS_PER_S = 989e12  # dense bf16 on the tensor cores
# Special-function-unit exponentials: 16 per SM per clock (Hopper SM).
SFU_PER_SM_PER_CLOCK = 16
# The scan's FP32-pipe instructions per (b, l, d, n) element and direction:
# dt*A and dt*u*B (two multiplies), the state update and the C readout (two
# FMAs): the six flops of its fp32 count.
SCAN_FP32_OPS_PER_ELEMENT = 4
# An exp2 emulated on the FP32 pipe (as FlashAttention-style kernels move part
# of theirs off the SFUs): range reduction (3 adds) and a degree-3 polynomial
# (3 FMAs).
FP32_OPS_PER_EMULATED_EXP = 6

# The scan backward's FP32-pipe instructions per (b, l, d, n) element and
# direction, the least its adjoint needs, each counted once: dt*A for the
# exp2, the state recompute (a multiply, an FMA), the y readout (FMA), lam
# (FMA), a*lam (a multiply: the carry, and a factor of lam*a*x_{t-1}), its
# product with x_{t-1} (a multiply), dA and sum_n lam*a*x_{t-1}*A (two FMAs),
# sum_n lam*B (FMA), dB and dC as dot products over channels (an FMA each).
SCAN_BWD_FP32_OPS_PER_ELEMENT = 12

SCAN_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}  # (atol, rtol)
CONV_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 1e-2)}
# Saved states are fp32 in both dtypes, from the same inputs: the fp32 bound.
XB_TOL = (1e-4, 1e-4)
# Grads, as max |err| over the reference's max |value|: fp32 sums in another
# order; in bf16 du, ddelta, dz, dB, dC (and dx, dw, db) are rounded to bf16,
# one ulp of 2^-8 relative at most.
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
MODEL_FP32_TOL = (2e-3, 2e-3)
# The paths' scan and conv shapes (batch, tokens, d_inner) at AuM-Base's 513
# tokens and d_inner 1536: the eval entries' B=8, the train entry's B=12;
# and the bench batch.
EVAL_DIMS = (8, 513, 1536)
TRAIN_DIMS = (12, 513, 1536)
BENCH_BATCH = 64
# fp32 train step, card (kernels) against CPU (plain): loss relative, grads
# as max |err| over max |ref|; the two sum in other orders over 2 layers.
# The params after one Adam step, as ||card - cpu|| over the norm of the
# CPU's update: Adam's first step moves each param by lr * g / (|g| + eps),
# about lr whatever |g|, so where |g| is within a few grad errors of eps
# (1e-8) or of zero the two updates may differ by up to 2 lr; a step that
# never reached the params reads 1 (an H100 read at most 1.9e-4).
TRAIN_FP32_TOL = {"loss_rtol": 1e-4, "grad": 1e-3, "update": 1e-2}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    return float(smi("clocks.max.sm").split()[0]) * 1e6


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call over ``iters`` calls, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


SWITCHES = ("AUM_SCAN_DIRECT", "AUM_SCAN_BWD_FUSED", "AUM_SCAN_DUAL_BWD", "AUM_SCAN_FUSE_DT",
            "AUM_SCAN_BF16_STAGE", "AUM_SCAN_BWD_BF16_PARTIALS", "AUM_SCAN_BWD_XMINUS",
            "AUM_SCAN_BWD_DBU")


@contextlib.contextmanager
def scan_switches(**switches):
    """The port's scan switches (``SWITCHES``, each on or off) for the block;
    the environment is restored after it."""
    saved = {name: os.environ.get(name) for name in switches}
    os.environ.update({name: str(int(bool(on))) for name, on in switches.items()})
    try:
        yield
    finally:
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value


@contextlib.contextmanager
def sample_clocks(out: dict, period_ms: int = 50):
    """Sample the card's SM clock and power draw while the block runs; the
    min/median/max of each land in ``out``."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
         f"--loop-ms={period_ms}"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        yield out
    finally:
        proc.terminate()
        text, _ = proc.communicate(timeout=30)
    rows = []
    for line in text.splitlines():
        try:
            rows.append([float(v) for v in line.split(",")])
        except ValueError:
            continue
    for i, key in enumerate(("sm_clock_mhz", "power_w")):
        vals = sorted(r[i] for r in rows)
        out[key] = ({"min": vals[0], "median": vals[len(vals) // 2], "max": vals[-1]}
                    if vals else None)
    out["samples"] = len(rows)


def exp_floor_s(exps: float, fp32_ops: float, sfu_rate: float) -> float:
    """Least time for ``exps`` exponentials beside ``fp32_ops`` FP32-pipe
    instructions, when any share of the exponentials may run as polynomials on
    the FP32 pipe instead of the SFUs. At the best share both pipes finish
    together: every exponential costs FP32_OPS_PER_EMULATED_EXP pipe
    instructions, over the FP32 pipe's rate plus the SFUs' in those units.
    (Issue slots, which both pipes share, are not counted: this stays a floor.)"""
    p = FP32_OPS_PER_EMULATED_EXP
    split = (p * exps + fp32_ops) / (FP32_PIPE_OPS_PER_S + p * sfu_rate)
    return max(fp32_ops / FP32_PIPE_OPS_PER_S, min(exps / sfu_rate, split))


def compare(got: torch.Tensor, want: torch.Tensor, atol: float, rtol: float) -> dict:
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    return {"max_abs_err": diff.max().item(),
            "max_rel_err": (diff / w.abs().clamp_min(1e-6)).max().item(),
            "atol": atol, "rtol": rtol,
            "ok": bool(torch.isfinite(g).all() and (diff <= atol + rtol * w.abs()).all())}


def compare_scaled(got: torch.Tensor, want: torch.Tensor, tol: float) -> dict:
    """max |got - want| against tol * max |want|: for grads, whose elements
    may cancel to near zero."""
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    scale = w.abs().max().item()
    return {"max_abs_err": err, "max_ref": scale, "scaled_err": err / max(scale, 1e-30),
            "tol": tol, "ok": bool(torch.isfinite(g).all()) and err <= tol * scale}


# --- inputs ------------------------------------------------------------------

def scan_inputs(bsz, seqlen, d, n, dtype, seed, device="cuda"):
    """One direction's (u, delta, A, B, C, D, z, bias) as the mixer passes
    them: z a column view of the in_proj output, B/C columns of x_proj's."""
    g = torch.Generator().manual_seed(seed)
    rank = 48

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(device)

    xz = randn(bsz, seqlen, 2 * d).to(dtype)
    x_dbl = randn(bsz, seqlen, rank + 2 * n).to(dtype)
    u = randn(bsz, seqlen, d).to(dtype)
    delta = randn(bsz, seqlen, d, scale=0.5).to(dtype)
    A = -(torch.arange(1, n + 1, dtype=torch.float32).expand(d, n)
          * torch.exp(torch.randn((d, n), generator=g) * 0.1)).to(device)
    # The mixer's dt-bias init: softplus(bias) log-uniform in [1e-3, 1e-1].
    dt0 = torch.exp(torch.rand(d, generator=g) * math.log(100.0) + math.log(1e-3))
    bias = (dt0 + torch.log(-torch.expm1(-dt0))).to(device)
    D = randn(d)
    return (u, delta, A, x_dbl[..., rank:rank + n], x_dbl[..., rank + n:], D,
            xz[..., d:], bias)


def fold_inputs(bsz, seqlen, d, n, dtype, seed, rank=48, device="cuda"):
    """One direction's (u, dtr, W, A, B, C, D, z, bias) as the mixer passes
    them under AUM_SCAN_FUSE_DT=1: dtr, B and C columns of one x_proj output,
    W (rank, D) the transposed view of a (D, rank) dt_proj weight (the
    mixer's init), z a column view of the in_proj output."""
    g = torch.Generator().manual_seed(seed)
    u, _, A, _, _, D, z, bias = scan_inputs(bsz, seqlen, d, n, dtype, seed, device)
    x_dbl = torch.randn((bsz, seqlen, rank + 2 * n), generator=g).to(device, dtype)
    w = ((torch.rand((d, rank), generator=g) * 2 - 1) / math.sqrt(rank)).to(device, dtype)
    return (u, x_dbl[..., :rank], w.t(), A, x_dbl[..., rank:rank + n], x_dbl[..., rank + n:],
            D, z, bias)


def conv_inputs(bsz, seqlen, d, k, dtype, seed, device="cuda", offset=0):
    """x a column slice, from channel ``offset``, of an in_proj-shaped
    output, as the mixer passes it (an odd offset breaks its alignment)."""
    g = torch.Generator().manual_seed(seed)
    xz = torch.randn((bsz, seqlen, 2 * d), generator=g).to(device=device, dtype=dtype)
    w = (torch.rand((d, k), generator=g) * 2 - 1).mul(0.5).to(device=device, dtype=dtype)
    b = (torch.rand((d,), generator=g) * 2 - 1).mul(0.5).to(device=device, dtype=dtype)
    return xz[..., offset:offset + d], w, b


# --- phases ------------------------------------------------------------------

def phase_device() -> dict:
    name_power = smi("name,power.limit")
    print(name_power, flush=True)
    info = {"phase": "device", "nvidia_smi": name_power,
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "sms": torch.cuda.get_device_properties(0).multi_processor_count,
            "max_sm_clock_mhz": max_sm_clock_hz() / 1e6,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0]}
    emit(info)
    return info


def phase_build() -> None:
    from aum_tpu_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {}
    for name, path in paths.items():
        log = path.with_suffix(".log")
        lines = log.read_text().splitlines() if log.exists() else []
        ptxas[name] = [ln.strip() for ln in lines
                       if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "seconds": seconds, "libraries": [p.name for p in paths.values()],
          "ptxas": ptxas})
    # What the occupancy calculator gives each kernel the paths launch.
    emit({"phase": "occupancy", "kernels": {name: _build.kernel_resources(name)
                                            for name in _build.SOURCES}})


GRAD_NAMES = ("du", "ddelta", "dA", "dB", "dC", "dD", "dz", "dbias")


def _scan_dirs(bsz, seqlen, d, dtype, shared, n=16):
    """Both directions' (u, dt, A, B, C, D, z) as the mixer passes them."""
    from aum_tpu_torch.ops.selective_scan import _prep_dt

    fwd = scan_inputs(bsz, seqlen, d, n, dtype, seed=1)
    rev = fwd if shared else scan_inputs(bsz, seqlen, d, n, dtype, seed=2)
    if shared:  # bimamba v1: same operands, its own A
        rev = (fwd[0], fwd[1], fwd[2] * 0.5) + fwd[3:]
    dt_f = _prep_dt(fwd[1], fwd[7])
    dt_r = dt_f if shared else _prep_dt(rev[1], rev[7])
    return ((fwd[0], dt_f) + fwd[2:7], (rev[0], dt_r) + rev[2:7])


def _check_scan(label, dims, dtype, shared, train: bool, n=16) -> list[dict]:
    """The eval forward, or (train) the saving forward and both forms of the
    backward (one launch for both directions, one per direction), with and
    without the softplus, against their plain versions: each through the
    default kernel and through the one its switch chooses (the direct
    forward, the fused backward), which is also held to the default
    kernel's result. ``n``: d_state."""
    from aum_tpu_torch.ops.selective_scan import (
        selective_scan_bwd_cuda,
        selective_scan_bwd_plain,
        selective_scan_dual_cuda,
        selective_scan_dual_plain,
    )

    bsz, seqlen, d = dims
    tag = dict(shape=label, dims=[bsz, seqlen, d, n], dtype=str(dtype),
               bimamba="v1" if shared else "v2")
    dir_f, dir_r = _scan_dirs(bsz, seqlen, d, dtype, shared, n)
    atol, rtol = SCAN_TOL[dtype]
    results = []
    fwd_kernels = {False: "selective_scan_dual_fwd", True: "selective_scan_dual_direct_fwd"}
    got = {}
    for direct, kernel in fwd_kernels.items():
        with scan_switches(AUM_SCAN_DIRECT=direct):
            got[direct] = selective_scan_dual_cuda(dir_f, dir_r, save_states=train)
        torch.cuda.synchronize()
    want = selective_scan_dual_plain(dir_f, dir_r, save_states=train)
    for direct, kernel in fwd_kernels.items():
        refs = {"plain": want, **({"staged_kernel": got[False]} if direct else {})}
        for against, ref in refs.items():
            for i, (y, w) in enumerate(zip(got[direct], ref)):
                tol = (atol, rtol) if i < 2 else XB_TOL
                extra = {"save_states": True, "output": "out" if i < 2 else "xb"} if train else {}
                results.append({**compare(y, w, *tol), "kernel": kernel, "against": against,
                                **extra, "direction": "reverse" if i % 2 else "forward", **tag})
    if not train:
        return results
    xb_f, xb_r = got[False][2:]
    g = torch.Generator().manual_seed(5)
    gs = [torch.randn((bsz, seqlen, d), generator=g).to("cuda", dtype) for _ in range(2)]
    dirs = [dir_f + (False,), dir_r + (True,)]
    for softplus in (True, False):
        want = selective_scan_bwd_plain(dirs, gs, softplus)
        k2 = {}
        for fused, kernel in ((False, "selective_scan_bwd"), (True, "selective_scan_bwd_fused")):
            with scan_switches(AUM_SCAN_BWD_FUSED=fused):
                forms = {"two_directions": selective_scan_bwd_cuda(dirs, gs, [xb_f, xb_r],
                                                                   softplus),
                         "one_direction": [selective_scan_bwd_cuda([dirs[i]], [gs[i]], [xb],
                                                                   softplus)[0]
                                           for i, xb in enumerate((xb_f, xb_r))]}
            torch.cuda.synchronize()
            for form, grads in forms.items():
                refs = {"plain": want, **({"k2": k2[form]} if fused else {})}
                for against, ref in refs.items():
                    for direction, (gr, wr) in enumerate(zip(grads, ref)):
                        results.append({**_grad_checks(GRAD_NAMES, gr, wr, GRAD_TOL[dtype]),
                                        "kernel": kernel,
                                        "form": form + ("" if softplus else "_no_softplus"),
                                        "against": against,
                                        "direction": "reverse" if direction else "forward",
                                        **tag})
            k2 = forms
    return results


def _check_fdt(label, dims, dtype, shared, n=16, rank=48) -> list[dict]:
    """The fuse_dt dual forward (eval) against its plain version, and against
    the staged kernel fed the materialised dt: in fp32 elementwise at the
    fp32 tolerance; in bf16 the staged kernel streams dt rounded to bf16,
    which the fuse_dt form does not, so the two compute different functions
    and differ where y + D u cancels: there as max |err| over max |ref|,
    at the bf16 tolerance (GRAD_TOL)."""
    from aum_tpu_torch.ops.selective_scan import (
        fold_dt,
        selective_scan_dual_cuda,
        selective_scan_dual_fdt_cuda,
        selective_scan_dual_fdt_plain,
    )

    bsz, seqlen, d = dims
    tag = dict(shape=label, dims=[bsz, seqlen, d, n], rank=rank, dtype=str(dtype),
               bimamba="v1" if shared else "v2")
    fwd = fold_inputs(bsz, seqlen, d, n, dtype, seed=21, rank=rank)
    rev = (fwd[:3] + (fwd[3] * 0.5,) + fwd[4:] if shared
           else fold_inputs(bsz, seqlen, d, n, dtype, seed=22, rank=rank))
    got = selective_scan_dual_fdt_cuda(fwd, rev)
    torch.cuda.synchronize()

    def materialised(f):
        return (f[0], fold_dt(f[1], f[2], f[8]).to(dtype)) + f[3:8]

    refs = {"plain": selective_scan_dual_fdt_plain(fwd, rev),
            "staged_kernel_materialised_dt": selective_scan_dual_cuda(
                materialised(fwd), materialised(rev), direct=False)}
    results = []
    for against, ref in refs.items():
        for i, (y, w) in enumerate(zip(got, ref)):
            scaled = against != "plain" and dtype == torch.bfloat16
            r = compare_scaled(y, w, GRAD_TOL[dtype]) if scaled else compare(y, w, *SCAN_TOL[dtype])
            results.append({**r, "kernel": "selective_scan_dual_fdt_fwd", "against": against,
                            "direction": "reverse" if i else "forward", **tag})
    return results


def _check_stage(label, dims, shared, n=16) -> list[dict]:
    """The stage form (AUM_SCAN_BF16_STAGE=1) of the staged dual forward, eval
    and saving, bf16, against its plain version; in fp32 the switch changes
    nothing: bit-equal to the default kernel."""
    from aum_tpu_torch.ops.selective_scan import (
        selective_scan_dual,
        selective_scan_dual_cuda,
        selective_scan_dual_plain,
    )

    bsz, seqlen, d = dims
    results = []
    for dtype in (torch.bfloat16, torch.float32):
        tag = dict(shape=label, dims=[bsz, seqlen, d, n], dtype=str(dtype),
                   bimamba="v1" if shared else "v2")
        dir_f, dir_r = _scan_dirs(bsz, seqlen, d, dtype, shared, n)
        for save in (False, True):
            before = selective_scan_dual.stage_launches
            with scan_switches(AUM_SCAN_BF16_STAGE=True):
                got = selective_scan_dual_cuda(dir_f, dir_r, save_states=save)
            torch.cuda.synchronize()
            extra = {"save_states": True} if save else {}
            if dtype == torch.float32:
                base = selective_scan_dual_cuda(dir_f, dir_r, save_states=save)
                same = all(torch.equal(a, b) for a, b in zip(got, base))
                results.append({"kernel": "selective_scan_dual_fwd", "check": "bf16_stage_fp32_noop",
                                "against": "default_kernel", "bit_equal": same,
                                "max_abs_err": 0.0 if same else float("nan"), "ok": same,
                                **extra, **tag})
                continue
            ran = selective_scan_dual.stage_launches == before + 1
            want = selective_scan_dual_plain(dir_f, dir_r, save_states=save, bf16_stage=True)
            for i, (y, w) in enumerate(zip(got, want)):
                tol = SCAN_TOL[dtype] if i < 2 else XB_TOL
                r = compare(y, w, *tol)
                results.append({**r, "ok": r["ok"] and ran, "kernel": "selective_scan_dual_stage_fwd",
                                "against": "plain", "output": "out" if i < 2 else "xb",
                                "direction": "reverse" if i % 2 else "forward", **extra, **tag})
    return results


def _check_bwd_forms(label, dims, dtype, n=16) -> list[dict]:
    """The backward's opt-in forms, v1 operands: K2 and the fused kernel with
    bf16 dB/dC partials against the same kernel's fp32-partials launch (dB
    and dC at the bf16 grad tolerance, every other output bit-equal), both
    directions in one launch and one direction; K2's x-minus form
    (AUM_SCAN_BWD_XMINUS=1) against the plain backward, both directions, one
    direction and the with_state form (9 grads)."""
    from aum_tpu_torch.ops import selective_scan_bwd
    from aum_tpu_torch.ops.selective_scan import (
        selective_scan_bwd_cuda,
        selective_scan_bwd_plain,
        selective_scan_cuda,
        selective_scan_dual_cuda,
    )

    bsz, seqlen, d = dims
    tag = dict(shape=label, dims=[bsz, seqlen, d, n], dtype=str(dtype), bimamba="v1")
    dir_f, dir_r = _scan_dirs(bsz, seqlen, d, dtype, True, n)
    _, _, xb_f, xb_r = selective_scan_dual_cuda(dir_f, dir_r, save_states=True)
    g = torch.Generator().manual_seed(25)
    gs = [torch.randn((bsz, seqlen, d), generator=g).to("cuda", dtype) for _ in range(2)]
    dirs = [dir_f + (False,), dir_r + (True,)]

    def launches(**switches):
        with scan_switches(**switches):
            out = {"two_directions": selective_scan_bwd_cuda(dirs, gs, [xb_f, xb_r]),
                   "one_direction": [selective_scan_bwd_cuda([dirs[i]], [gs[i]], [xb])[0]
                                     for i, xb in enumerate((xb_f, xb_r))]}
        torch.cuda.synchronize()
        return out

    results = []
    for fused, kernel in ((False, "selective_scan_bwd"), (True, "selective_scan_bwd_fused")):
        base = launches(AUM_SCAN_BWD_FUSED=fused)
        before = selective_scan_bwd.bf16_partials_launches
        part = launches(AUM_SCAN_BWD_FUSED=fused, AUM_SCAN_BWD_BF16_PARTIALS=True)
        ran = selective_scan_bwd.bf16_partials_launches == before + 3
        for form, grads in part.items():
            for direction, (gr, br) in enumerate(zip(grads, base[form])):
                checks = {name: compare_scaled(a, b, GRAD_TOL[torch.bfloat16])
                          for name, a, b in zip(GRAD_NAMES, gr, br) if name in ("dB", "dC")}
                same = all(torch.equal(a, b) for name, a, b in zip(GRAD_NAMES, gr, br)
                           if name not in ("dB", "dC"))
                results.append({"max_abs_err": max(c["max_abs_err"] for c in checks.values()),
                                "tol": GRAD_TOL[torch.bfloat16],
                                "grads": {k: [c["max_abs_err"], c["scaled_err"]]
                                          for k, c in checks.items()},
                                "others_bit_equal": same,
                                "ok": ran and same and all(c["ok"] for c in checks.values()),
                                "kernel": kernel, "variant": "bf16_partials", "form": form,
                                "against": "fp32_partials_launch",
                                "direction": "reverse" if direction else "forward", **tag})
    want = selective_scan_bwd_plain(dirs, gs)
    before = selective_scan_bwd.xminus_launches
    got = launches(AUM_SCAN_BWD_XMINUS=True)
    ran = selective_scan_bwd.xminus_launches == before + 3
    for form, grads in got.items():
        for direction, (gr, wr) in enumerate(zip(grads, want)):
            r = _grad_checks(GRAD_NAMES, gr, wr, GRAD_TOL[dtype])
            results.append({**r, "ok": r["ok"] and ran, "kernel": "selective_scan_bwd",
                            "variant": "xminus", "form": form, "against": "plain",
                            "direction": "reverse" if direction else "forward", **tag})
    # The with_state form: a random starting state and final-state cotangent.
    x0, gfin = (torch.randn((bsz, d, n), generator=g).cuda() for _ in range(2))
    _, xb_s, _ = selective_scan_cuda(dir_f, False, save_states=True, initial_state=x0,
                                     return_final_state=True)
    before = selective_scan_bwd.xminus_launches
    with scan_switches(AUM_SCAN_BWD_XMINUS=True):
        got = selective_scan_bwd_cuda(dirs[:1], gs[:1], [xb_s], gfins=[gfin])[0]
    torch.cuda.synchronize()
    ran = selective_scan_bwd.xminus_launches == before + 1
    want = selective_scan_bwd_plain(dirs[:1], gs[:1], states=[(x0, gfin)])[0]
    r = _grad_checks(GRAD_NAMES + ("dx0",), got, want, GRAD_TOL[dtype])
    results.append({**r, "ok": r["ok"] and ran, "kernel": "selective_scan_bwd",
                    "variant": "xminus", "form": "with_state", "with_state": True,
                    "against": "plain", "direction": "forward", **tag})
    return results


# The small-dt probe: K2 and the fused kernel form the softplus chain rule
# as ddt (1 - 2^(-dt log2 e)) with the SFU's exp2; the difference of two
# numbers near 1 may lose relative precision at small dt. A kernel fails the
# probe where its relative error exceeds the plain version's by more than
# this factor.
SMALL_DT_RATIO = 4.0


def probe_small_dt() -> list[dict]:
    """ddelta at dt in [1e-6, 1e-4] (log-uniform), fp32, one direction: K2,
    the fused kernel and the plain version each against an fp64 evaluation
    of its own ddt times (1 - e^(-dt)) (ddt from the same kernel launched
    without the softplus, whose adjoint is the same computation), as the
    relative error over elements whose reference exceeds 1e-3 of the
    largest; max and median."""
    from aum_tpu_torch.ops.selective_scan import (
        selective_scan_bwd_cuda,
        selective_scan_bwd_plain,
        selective_scan_cuda,
    )

    bsz, seqlen, d, n = 2, 150, 64, 16
    raw = scan_inputs(bsz, seqlen, d, n, torch.float32, seed=27)
    g = torch.Generator().manual_seed(28)
    dt = torch.exp(torch.rand((bsz, seqlen, d), generator=g) * math.log(100.0)
                   + math.log(1e-6)).cuda()
    args = (raw[0], dt) + raw[2:7]
    gout = torch.randn((bsz, seqlen, d), generator=g).cuda()
    _, xb = selective_scan_cuda(args, False, save_states=True)
    factor = -torch.expm1(-dt.double())

    def rel_err(ddelta, ddt):
        ref = ddt.double() * factor
        keep = ref.abs() > 1e-3 * ref.abs().max()
        err = ((ddelta.double() - ref).abs() / ref.abs())[keep]
        return {"max_rel_err": err.max().item(), "median_rel_err": err.median().item(),
                "elements": int(keep.sum())}

    dirs = [args + (False,)]
    errs = {"plain": rel_err(selective_scan_bwd_plain(dirs, [gout], True)[0][1],
                             selective_scan_bwd_plain(dirs, [gout], False)[0][1])}
    for fused, kernel in ((False, "selective_scan_bwd"), (True, "selective_scan_bwd_fused")):
        with scan_switches(AUM_SCAN_BWD_FUSED=fused):
            errs[kernel] = rel_err(selective_scan_bwd_cuda(dirs, [gout], [xb], True)[0][1],
                                   selective_scan_bwd_cuda(dirs, [gout], [xb], False)[0][1])
    limit = SMALL_DT_RATIO * errs["plain"]["max_rel_err"]
    return [{"kernel": k, "check": "small_dt_ddelta", "dims": [bsz, seqlen, d, n],
             "dt_range": [1e-6, 1e-4], "dtype": str(torch.float32), "shape": "small_dt",
             **errs[k], "plain": errs["plain"], "ratio_limit": SMALL_DT_RATIO,
             "max_abs_err": errs[k]["max_rel_err"], "ok": errs[k]["max_rel_err"] <= limit}
            for k in ("selective_scan_bwd", "selective_scan_bwd_fused")]


def _check_scan_single(label, dims, dtype, reverse, train: bool, n=16) -> list[dict]:
    """The single-direction forward and its with_state form, or (train) its
    saving form and the backward of the autograd op (``selective_scan``
    under grad: the saving forward, then the one-direction backward kernel),
    against their plain versions. ``n``: d_state."""
    from aum_tpu_torch.ops.selective_scan import (
        _prep_dt,
        selective_scan,
        selective_scan_bwd_plain,
        selective_scan_cuda,
        selective_scan_plain,
    )

    bsz, seqlen, d = dims
    tag = dict(shape=label, dims=[bsz, seqlen, d, n], dtype=str(dtype),
               direction="reverse" if reverse else "forward")
    raw = scan_inputs(bsz, seqlen, d, n, dtype, seed=11)
    args = (raw[0], _prep_dt(raw[1], raw[7])) + raw[2:7]
    atol, rtol = SCAN_TOL[dtype]
    g = torch.Generator().manual_seed(12)
    results = []

    def check(got, want, tol, **kw):
        results.append({**compare(got, want, *tol), "kernel": "selective_scan_fwd", **kw, **tag})

    if not train:
        got = selective_scan_cuda(args, reverse)
        torch.cuda.synchronize()
        check(got, selective_scan_plain(args, reverse), (atol, rtol))
        x0 = torch.randn((bsz, d, n), generator=g).cuda()
        got, fin = selective_scan_cuda(args, reverse, initial_state=x0, return_final_state=True)
        torch.cuda.synchronize()
        want, want_fin = selective_scan_plain(args, reverse, initial_state=x0,
                                              return_final_state=True)
        check(got, want, (atol, rtol), with_state=True, output="out")
        check(fin, want_fin, XB_TOL, with_state=True, output="final_state")
        return results
    got, xb = selective_scan_cuda(args, reverse, save_states=True)
    torch.cuda.synchronize()
    want, want_xb = selective_scan_plain(args, reverse, save_states=True)
    check(got, want, (atol, rtol), save_states=True, output="out")
    check(xb, want_xb, XB_TOL, save_states=True, output="xb")
    gout = torch.randn((bsz, seqlen, d), generator=g).to("cuda", dtype)
    x0 = torch.randn((bsz, d, n), generator=g).cuda()
    gfin = torch.randn((bsz, d, n), generator=g).cuda()
    # The autograd op's backward: as the Fo-Fo train step runs it; without
    # the softplus (ddelta = ddt; delta is then the positive dt itself, with
    # no bias); and the with_state form from a random x0 with a random
    # cotangent of the final state (9 grads, dx0 the last).
    forms = {"one_direction_autograd": (True, False),
             "one_direction_autograd_no_softplus": (False, False),
             "with_state_autograd": (True, True)}
    for form, (softplus, with_state) in forms.items():
        inputs = raw if softplus else args
        leaves = [t.detach().requires_grad_() for t in inputs]  # strided views stay strided
        bias = leaves[7] if softplus else None
        kw = {}
        if with_state:
            leaves.append(x0.clone().requires_grad_())
            kw = {"initial_state": leaves[-1], "return_final_state": True}
        out = selective_scan(*leaves[:7], delta_bias=bias, delta_softplus=softplus,
                             reverse=reverse, **kw)
        torch.autograd.backward(out, (gout, gfin) if with_state else gout)
        torch.cuda.synchronize()
        want = selective_scan_bwd_plain([args + (reverse,)], [gout], softplus,
                                        [(x0, gfin)] if with_state else None)[0]
        names = GRAD_NAMES + (("dx0",) if with_state else ())
        got = [t.grad for t in leaves]
        if not softplus:  # no bias: compare the 7 grads
            names, want = names[:7], want[:7]
        results.append({**_grad_checks(names, got, want, GRAD_TOL[dtype]),
                        "kernel": "selective_scan_bwd", "form": form,
                        **({"with_state": True} if with_state else {}), **tag})
    return results


def _check_chained(label, dims, dtype) -> list[dict]:
    """A scan split at an uneven point, the second segment started from the
    first one's final state (reverse: the right-hand segment first), against
    the unsplit scan: outputs and all 8 grads under autograd, forward and
    reverse (the property sequence parallelism rests on). Runs the
    single-direction forward's with_state form and K2's with_state backward."""
    from aum_tpu_torch.ops.selective_scan import selective_scan

    bsz, seqlen, d = dims
    split = seqlen * 2 // 5 + 1
    raw = scan_inputs(bsz, seqlen, d, 16, dtype, seed=14)
    gout = torch.randn((bsz, seqlen, d), generator=torch.Generator().manual_seed(15))
    gout = gout.to("cuda", dtype)
    atol, rtol = SCAN_TOL[dtype]
    results = []
    for reverse in (False, True):
        outs, grads = {}, {}
        for mode in ("unsplit", "chained"):
            _reset_counters()
            leaves = [t.detach().requires_grad_() for t in raw]
            u, delta, A, B, C, D, z, bias = leaves

            def scan(lo, hi, **kw):
                return selective_scan(u[:, lo:hi], delta[:, lo:hi], A, B[:, lo:hi],
                                      C[:, lo:hi], D, z[:, lo:hi], delta_bias=bias,
                                      delta_softplus=True, reverse=reverse, **kw)

            if mode == "unsplit":
                y = scan(0, seqlen)
            else:
                first, second = ((split, seqlen), (0, split)) if reverse else \
                    ((0, split), (split, seqlen))
                y_a, state = scan(*first, return_final_state=True)
                y_b = scan(*second, initial_state=state)
                y = torch.cat((y_b, y_a) if reverse else (y_a, y_b), dim=1)
            y.backward(gout)
            torch.cuda.synchronize()
            outs[mode], grads[mode] = y.detach(), [t.grad for t in leaves]
        launches = {k: v for k, v in _read_counters().items() if v}  # of the chained run
        tag = dict(shape=label, dims=[bsz, seqlen, d, 16], split=split, dtype=str(dtype),
                   direction="reverse" if reverse else "forward", launches=launches)
        results.append({**compare(outs["chained"], outs["unsplit"], atol, rtol),
                        "kernel": "selective_scan_fwd", "check": "chained_segments",
                        "with_state": True, "output": "out", **tag})
        results.append({**_grad_checks(GRAD_NAMES, grads["chained"], grads["unsplit"],
                                       GRAD_TOL[dtype]),
                        "kernel": "selective_scan_bwd", "check": "chained_segments",
                        "with_state": True, **tag})
    return results


def _grad_checks(names, got, want, tol) -> dict:
    """One line for a set of grads: each one's max abs and scaled error, the
    largest abs error over all of them, ok if each is within tol."""
    checks = {name: compare_scaled(g, w, tol) for name, g, w in zip(names, got, want)
              if w is not None}
    return {"max_abs_err": max(c["max_abs_err"] for c in checks.values()), "tol": tol,
            "grads": {k: [c["max_abs_err"], c["scaled_err"]] for k, c in checks.items()},
            "ok": all(c["ok"] for c in checks.values())}


def _check_conv(label, dims, dtype, train: bool, offset=0) -> list[dict]:
    """The conv forward (or, train, its backward) against the plain version,
    causal and anti-causal, with bias and SiLU and without; x a column slice
    from channel ``offset``."""
    from aum_tpu_torch.ops.conv1d import (
        causal_conv1d_bwd_cuda,
        causal_conv1d_bwd_plain,
        causal_conv1d_cuda,
        causal_conv1d_plain,
    )

    bsz, seqlen, d = dims
    results = []
    for reverse in (False, True):
        for with_bias, act in ((True, "silu"), (False, None)):
            x, w, b = conv_inputs(bsz, seqlen, d, 4, dtype, seed=3, offset=offset)
            b = b if with_bias else None
            tag = dict(shape=label, dims=[bsz, seqlen, d, 4], dtype=str(dtype),
                       reverse=reverse, bias=with_bias, activation=act,
                       **({"offset": offset} if offset else {}))
            if not train:
                got = causal_conv1d_cuda(x, w, b, act, reverse)
                torch.cuda.synchronize()
                results.append({**compare(got, causal_conv1d_plain(x, w, b, act, reverse),
                                          *CONV_TOL[dtype]),
                                "kernel": "causal_conv1d_fwd", **tag})
                continue
            g = torch.randn((bsz, seqlen, d), generator=torch.Generator().manual_seed(6))
            g = g.to("cuda", dtype)
            got = causal_conv1d_bwd_cuda(x, w, b, g, act, reverse)
            torch.cuda.synchronize()
            want = causal_conv1d_bwd_plain(x, w, b, g, act, reverse)
            results.append({**_grad_checks(("dx", "dweight", "dbias"), got, want,
                                           GRAD_TOL[dtype]),
                            "kernel": "causal_conv1d_bwd", **tag})
    return results


# The fused backward's edges: lengths around its chunk of 64 steps (the
# short chunk is processed first, alone or beside a full one; 513 is the
# train path's one-step chunk) and its sub-chunks of 8, at D=40 and D=136
# (the last block of 16 channels half full).
FUSED_EDGE_LENGTHS = (1, 63, 64, 65, 127, 128, 129, 513)
FUSED_EDGE_DIMS = (40, 136)


def _check_fused_edges() -> list[dict]:
    """The fused backward at the edges of its design, fp32 and bf16, v1
    operands, one and both directions, with and without the softplus,
    against the plain backward and K2 (``_check_scan``, which holds the
    saving forward that feeds it too): at every length of
    FUSED_EDGE_LENGTHS and D of FUSED_EDGE_DIMS; with d_state 5 (B/C rows
    staged value by value) at L=65 and 513; and with bf16 partials against
    its fp32-partials launch (``_check_bwd_forms``, which holds K2's forms
    there too) at L=65, D=40 and L=513, D=136."""
    results = []
    for dtype in (torch.float32, torch.bfloat16):
        for seqlen in FUSED_EDGE_LENGTHS:
            for d in FUSED_EDGE_DIMS:
                results += _check_scan("fused_bwd_edge", (2, seqlen, d), dtype, True, True)
        for seqlen in (65, 513):
            results += _check_scan("fused_bwd_edge_n5", (2, seqlen, 40), dtype, True, True, n=5)
        for dims in ((2, 65, 40), (2, 513, 136)):
            results += _check_bwd_forms("fused_bwd_edge", dims, dtype)
    return results


def _check_edges() -> list[dict]:
    """The redesigned kernels at the edges of their designs, fp32 and bf16.
    The fuse_dt dual forward, v1 and v2 (``_check_fdt``): dt ranks 1 (one
    partial k-step), 16 (one whole one), 17, 47 (dtr rows 79 elements apart:
    not 16-byte aligned, so staged value by value, as at ranks 1 and 17) and
    64 (the largest) at L=37, D=40; lengths 1, 15, 16, 17 (around a dt
    tile), 65 (one step into the second chunk) and 81 (one into the dtr
    ring's second window) at D=136 (a block with 8 channels) and rank 48. The conv, forward and backward: D=36 (not
    whole 8-channel vectors), x a slice at an odd channel offset (unaligned
    base), L=1 and L one past a tile (the kernel's own tile length). The
    fused backward (``_check_fused_edges``)."""
    from aum_tpu_torch.ops.conv1d import TILE_STEPS

    results = _check_fused_edges()
    for dtype in (torch.float32, torch.bfloat16):
        for shared in (True, False):
            for rank in (1, 16, 17, 47, 64):
                results += _check_fdt("fdt_rank", (2, 37, 40), dtype, shared, rank=rank)
            for seqlen in (1, 15, 16, 17, 65, 81):
                results += _check_fdt("fdt_length", (2, seqlen, 136), dtype, shared)
        for train in (False, True):
            for label, dims, offset in (("conv_d36", (2, 37, 36), 0),
                                        ("conv_odd_offset", (2, 37, 40), 1),
                                        ("conv_l1", (2, 1, 40), 0),
                                        ("conv_tile_plus_1", (2, TILE_STEPS + 1, 40), 0)):
                results += _check_conv(label, dims, dtype, train, offset)
    return results


def phase_kernels() -> dict:
    """Every kernel against its plain version; returns the largest absolute
    error of each at the paths' shapes in bf16."""
    # (dims, train: False eval / True train / None both, d_state). N=5 is
    # not a multiple of the 4 lanes a chain's states are split over, so the
    # last lane of each chain holds part of its states and one none.
    shapes = {"eval": (EVAL_DIMS, False, 16), "train": (TRAIN_DIMS, True, 16),
              "ragged": ((2, 37, 40), None, 16), "ragged_n5": ((2, 37, 40), None, 5),
              "multi_chunk": ((2, 150, 40), None, 16)}
    results = []
    for label, (dims, train, n) in shapes.items():
        for dtype in (torch.float32, torch.bfloat16):
            modes = (False, True) if train is None else (train,)
            for mode in modes:
                for shared in (True, False):
                    results += _check_scan(label, dims, dtype, shared, mode, n)
                for reverse in (False, True):
                    results += _check_scan_single(label, dims, dtype, reverse, mode, n)
                if n == 16:  # the conv has no d_state
                    results += _check_conv(label, dims, dtype, mode)
            if train is not False and n == 16:
                results += _check_chained(label, dims, dtype)
            # The opt-in forms: fuse_dt (eval shapes) at AuM-Base's dt rank
            # and, at the ragged shape, AuM-tiny's (12: one partial k-step);
            # the backward's forms at the train shapes.
            if train is not True:
                for rank in (48,) if label == "eval" else (48, 12):
                    for shared in (True, False):
                        results += _check_fdt(label, dims, dtype, shared, n, rank)
            if train is not False:
                results += _check_bwd_forms(label, dims, dtype, n)
        for shared in (True, False):
            results += _check_stage(label, dims, shared, n)
    results += _check_edges()
    results += probe_small_dt()
    worst = {}
    for r in results:
        emit({"phase": "kernels", **r})
        if (r["shape"] in ("eval", "train") and r["dtype"] == str(torch.bfloat16)
                and r.get("against", "plain") in ("plain", "fp32_partials_launch")
                and "check" not in r):
            key = r["kernel"] + ("_save_states" if r.get("save_states") else "") + (
                "_with_state" if r.get("with_state") else "") + (
                "_no_softplus" if r.get("form", "").endswith("no_softplus") else "") + (
                f"_{r['variant']}" if "variant" in r else "")
            worst[key] = max(worst.get(key, 0.0), r["max_abs_err"])
    failed = [r for r in results if not r["ok"]]
    emit({"phase": "kernels_summary", "checks": len(results), "failed": len(failed),
          "worst_bf16_max_abs_err": worst})
    if failed:
        raise RuntimeError(f"{len(failed)} kernel checks disagree with the plain version")
    return worst


def phase_model() -> dict:
    from aum_tpu_torch.entry import entry, flagship_config
    from aum_tpu_torch.models import AudioMamba

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = flagship_config(dtype="float32")
    x = torch.randn((2, 1024, 128), generator=torch.Generator().manual_seed(7))
    t0 = time.perf_counter()
    with torch.inference_mode():
        gpu = AudioMamba(cfg32, device="cuda", seed=0)
        got = gpu(x.cuda()).cpu()
        del gpu
        t1 = time.perf_counter()
        want = AudioMamba(cfg32, device="cpu", seed=0)(x)
    t2 = time.perf_counter()
    atol, rtol = MODEL_FP32_TOL
    r = compare(got, want, atol, rtol)
    emit({"phase": "model_fp32_vs_cpu", "batch": 2, "depth": cfg32.depth,
          "width": cfg32.embed_dim, "logits_shape": list(got.shape),
          "gpu_s": t1 - t0, "cpu_s": t2 - t1, **r})
    if not r["ok"]:
        raise RuntimeError("fp32 model on the card disagrees with the CPU plain path")
    # The same weights and input through the direct dual forward.
    with scan_switches(AUM_SCAN_DIRECT=True), torch.inference_mode():
        gpu = AudioMamba(cfg32, device="cuda", seed=0)
        got = gpu(x.cuda()).cpu()
        del gpu
    r = compare(got, want, atol, rtol)
    emit({"phase": "model_fp32_vs_cpu", "switches": {"AUM_SCAN_DIRECT": 1}, "batch": 2,
          "depth": cfg32.depth, "width": cfg32.embed_dim, **r})
    if not r["ok"]:
        raise RuntimeError("fp32 model through the direct dual forward disagrees with the CPU")
    # The same weights and input through the fuse_dt form (dt formed in the
    # kernel). In fp32 it computes the default path's function (dt is never
    # rounded in either), so the CPU's default logits stay the reference.
    with scan_switches(AUM_SCAN_FUSE_DT=True), torch.inference_mode():
        gpu = AudioMamba(cfg32, device="cuda", seed=0)
        got = gpu(x.cuda()).cpu()
        del gpu
    r = compare(got, want, atol, rtol)
    emit({"phase": "model_fp32_vs_cpu", "switches": {"AUM_SCAN_FUSE_DT": 1}, "batch": 2,
          "depth": cfg32.depth, "width": cfg32.embed_dim, **r})
    if not r["ok"]:
        raise RuntimeError("fp32 model through the fuse_dt dual forward disagrees with the CPU")

    depth = flagship_config().depth
    fn, args = entry()
    out = {}
    for name, (switches, scan) in EVAL_SWITCHES.items():
        with scan_switches(**switches):
            torch.cuda.synchronize()
            _reset_counters()
            logits = fn(*args)
            torch.cuda.synchronize()
            launches = _read_counters()
            finite = bool(torch.isfinite(logits.float()).all())
            latency_ms = cuda_ms(lambda: fn(*args), iters=10)
        emit({"phase": "main_path", "entry": "aum_tpu_torch.entry.entry", "batch": 8,
              "switches": {k: int(bool(v)) for k, v in switches.items()},
              "logits_shape": list(logits.shape), "dtype": str(logits.dtype),
              "finite": finite, "launches": launches, "graph_built": logits.requires_grad,
              "ms_per_forward": latency_ms})
        if tuple(logits.shape) != (8, 527) or not finite:
            raise RuntimeError("main path logits are not (8, 527) finite values")
        expected = _launches(**{scan: depth}, causal_conv1d_fwd=depth)
        if launches != expected or logits.requires_grad:
            raise RuntimeError(f"expected {expected} launches and no graph ({name}), "
                               f"got {launches}")
        out[name] = launches
    return out


# entry() under each switch set: the switches, and the one dual forward
# kernel the eval path must launch (the fuse_dt form ignores AUM_SCAN_DIRECT,
# as JAX's fuse_dt op never takes the direct kernel).
EVAL_SWITCHES = {
    "default": ({}, "selective_scan_dual_fwd"),
    "direct": ({"AUM_SCAN_DIRECT": True}, "selective_scan_dual_direct_fwd"),
    "fuse_dt": ({"AUM_SCAN_FUSE_DT": True}, "selective_scan_dual_fdt_fwd"),
    "fuse_dt_direct": ({"AUM_SCAN_FUSE_DT": True, "AUM_SCAN_DIRECT": True},
                       "selective_scan_dual_fdt_fwd"),
    "bf16_stage": ({"AUM_SCAN_BF16_STAGE": True}, "selective_scan_dual_stage_fwd"),
}


def phase_wav() -> dict:
    """AuM-Base Fo-Fo from waveforms: fp32 card against CPU, then
    ``wav_entry()``'s launches, logits and latency."""
    from aum_tpu_torch.entry import (
        CLIP_SAMPLES,
        WAV_BATCH,
        flagship_config,
        wav_entry,
        wav_forward_fn,
        wav_frontend_fn,
    )
    from aum_tpu_torch.models import AudioMamba

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = flagship_config("Fo-Fo", dtype="float32")
    wav = 0.1 * torch.randn((2, CLIP_SAMPLES), generator=torch.Generator().manual_seed(7))
    t0 = time.perf_counter()
    with torch.inference_mode():
        gpu = AudioMamba(cfg32, device="cuda", seed=0)
        got = wav_forward_fn(gpu)(wav.cuda()).cpu()
        del gpu
        t1 = time.perf_counter()
        want = wav_forward_fn(AudioMamba(cfg32, device="cpu", seed=0))(wav)
    t2 = time.perf_counter()
    r = compare(got, want, *MODEL_FP32_TOL)
    emit({"phase": "wav_fp32_vs_cpu", "batch": 2, "samples": CLIP_SAMPLES,
          "depth": cfg32.depth, "width": cfg32.embed_dim, "bimamba": cfg32.bimamba_type,
          "logits_shape": list(got.shape), "gpu_s": t1 - t0, "cpu_s": t2 - t1, **r})
    if not r["ok"]:
        raise RuntimeError("fp32 Fo-Fo from waveforms on the card disagrees with the CPU")

    fn, (wav,) = wav_entry()
    torch.cuda.synchronize()
    _reset_counters()
    logits = fn(wav)
    torch.cuda.synchronize()
    launches = _read_counters()
    finite = bool(torch.isfinite(logits.float()).all())
    latency_ms = cuda_ms(lambda: fn(wav), iters=10)
    frontend = wav_frontend_fn(cfg32)
    frontend_ms = cuda_ms(lambda: frontend(wav), iters=10)
    emit({"phase": "wav_path", "entry": "aum_tpu_torch.entry.wav_entry", "batch": WAV_BATCH,
          "samples": CLIP_SAMPLES, "logits_shape": list(logits.shape),
          "dtype": str(logits.dtype), "finite": finite, "launches": launches,
          "graph_built": logits.requires_grad, "ms_per_forward": latency_ms,
          "frontend_ms": frontend_ms})
    depth = cfg32.depth
    if tuple(logits.shape) != (WAV_BATCH, 527) or not finite:
        raise RuntimeError("wav path logits are not (8, 527) finite values")
    expected = _launches(selective_scan_fwd=depth, causal_conv1d_fwd=depth)
    if launches != expected or logits.requires_grad:
        raise RuntimeError(f"expected {expected} launches and no graph, got {launches}")
    return launches


def _counters() -> dict:
    """Every launch counter: name -> (holder, attribute)."""
    from aum_tpu_torch.ops import (
        causal_conv1d,
        selective_scan,
        selective_scan_bwd,
        selective_scan_dual,
    )

    return {"selective_scan_dual_fwd": (selective_scan_dual, "launches"),
            "selective_scan_dual_fwd_save_states": (selective_scan_dual,
                                                    "save_states_launches"),
            "selective_scan_dual_direct_fwd": (selective_scan_dual, "direct_launches"),
            "selective_scan_dual_direct_fwd_save_states": (selective_scan_dual,
                                                           "direct_save_states_launches"),
            "selective_scan_dual_fdt_fwd": (selective_scan_dual, "fdt_launches"),
            "selective_scan_dual_stage_fwd": (selective_scan_dual, "stage_launches"),
            "selective_scan_dual_stage_fwd_save_states": (selective_scan_dual,
                                                          "stage_save_states_launches"),
            "selective_scan_fwd": (selective_scan, "launches"),
            "selective_scan_fwd_save_states": (selective_scan, "save_states_launches"),
            "selective_scan_fwd_with_state": (selective_scan, "with_state_launches"),
            "selective_scan_bwd": (selective_scan_bwd, "launches"),
            "selective_scan_bwd_with_state": (selective_scan_bwd, "with_state_launches"),
            "selective_scan_bwd_fused": (selective_scan_bwd, "fused_launches"),
            "selective_scan_bwd_xminus": (selective_scan_bwd, "xminus_launches"),
            "selective_scan_bwd_bf16_partials": (selective_scan_bwd, "bf16_partials_launches"),
            "causal_conv1d_fwd": (causal_conv1d, "launches")}


def _reset_counters() -> None:
    for holder, attr in _counters().values():
        setattr(holder, attr, 0)


def _read_counters() -> dict:
    return {name: getattr(holder, attr) for name, (holder, attr) in _counters().items()}


def _launches(**counts) -> dict:
    """Every counter at 0 but those given."""
    return {**dict.fromkeys(_counters(), 0), **counts}


def _expected_train_launches(aum_type: str, depth: int, switches: dict, bf16: bool) -> dict:
    """What one forward and backward launches per layer: the scan's saving
    forward and its backward (the kernels the switches choose: the fuse_dt
    rule's saving forward is the staged kernel whatever AUM_SCAN_DIRECT says;
    the stage form takes bf16 streams only) and the conv four times (split
    remat: forward, recompute, the backward's pre-activation and dx)."""
    on = {k for k, v in switches.items() if v}
    direct = "AUM_SCAN_DIRECT" in on and "AUM_SCAN_FUSE_DT" not in on
    if aum_type == "Fo-Fo":
        scans = {"selective_scan_fwd": depth, "selective_scan_fwd_save_states": depth}
    elif direct:
        scans = {"selective_scan_dual_direct_fwd": depth,
                 "selective_scan_dual_direct_fwd_save_states": depth}
    elif "AUM_SCAN_BF16_STAGE" in on and bf16:
        scans = {"selective_scan_dual_stage_fwd": depth,
                 "selective_scan_dual_stage_fwd_save_states": depth}
    else:
        scans = {"selective_scan_dual_fwd": depth, "selective_scan_dual_fwd_save_states": depth}
    fused = "AUM_SCAN_BWD_FUSED" in on
    bwd = {"selective_scan_bwd_fused" if fused else "selective_scan_bwd": depth}
    if not fused and on & {"AUM_SCAN_BWD_XMINUS", "AUM_SCAN_BWD_DBU"}:
        bwd["selective_scan_bwd_xminus"] = depth
    if "AUM_SCAN_BWD_BF16_PARTIALS" in on:
        bwd["selective_scan_bwd_bf16_partials"] = depth
    return _launches(**scans, **bwd, causal_conv1d_fwd=4 * depth)


def _train_fp32_check(aum_type: str, switch_sets: dict) -> dict:
    """fp32, full width, depth 2 (the CPU oracle's backward stays short): the
    loss and grads of one forward and backward, then one full train step
    without warmup (its lr is the schedule's 5e-5, not the warmup's 0), card
    against CPU. The card runs once per switch set (name -> switches), the CPU
    once. Returns the launches of each card run's forward and backward."""
    import dataclasses

    from aum_tpu_torch.entry import STEPS_PER_EPOCH, TRAIN_HP, flagship_config
    from aum_tpu_torch.models import AudioMamba
    from aum_tpu_torch.train import init_train_state, loss_fn_of, make_optimizer, make_train_step

    cfg = flagship_config(aum_type, dtype="float32", depth=2, remat=True, remat_mode="split")
    hp = dataclasses.replace(TRAIN_HP, warmup=False)
    g = torch.Generator().manual_seed(8)
    x = torch.randn((2, 1024, 128), generator=g)
    y = torch.nn.functional.one_hot(torch.arange(2) % 527, 527).float()
    keys = ("in_proj.weight", "A_log", "A_b_log", "dt_proj.bias", "conv1d.weight",
            "x_proj.weight", "dt_proj.weight")
    if cfg.bimamba_type == "none":  # Fo-Fo has no A_b_log
        keys = tuple(k for k in keys if k != "A_b_log")
    names = [f"layers.{i}.mixer.{k}" for i in range(cfg.depth) for k in keys]

    def run(device):
        t0 = time.perf_counter()
        model = AudioMamba(cfg, device=device, seed=0)
        batch = {"x": x.to(device), "y": y.to(device)}
        if device == "cuda":
            torch.cuda.synchronize()
            _reset_counters()
        loss = loss_fn_of("BCE")(model(batch["x"], train=True), batch["y"])
        loss.backward()
        launches = None
        if device == "cuda":
            torch.cuda.synchronize()
            launches = _read_counters()
        params = dict(model.named_parameters())
        grads = {k: params[k].grad.cpu() for k in names}
        before = {k: params[k].detach().cpu().clone() for k in names}
        state = init_train_state(model, make_optimizer(model.parameters(), hp))
        make_train_step(hp, STEPS_PER_EPOCH, "BCE")(state, batch)
        after = {k: params[k].detach().cpu() for k in names}
        return loss.item(), grads, before, after, time.perf_counter() - t0, launches

    loss_c, grads_c, before_c, after_c, s_c, _ = run("cpu")
    out = {}
    for set_name, switches in switch_sets.items():
        with scan_switches(**switches):
            loss_g, grads_g, _, after_g, s_g, launches = run("cuda")
        checks = {k: compare_scaled(grads_g[k], grads_c[k], TRAIN_FP32_TOL["grad"])
                  for k in grads_c}
        updates = {}
        for k in names:
            err = (after_g[k] - after_c[k]).norm().item()
            moved = (after_c[k] - before_c[k]).norm().item()
            updates[k] = {"err_norm": err, "update_norm": moved,
                          "ok": moved > 0 and err <= TRAIN_FP32_TOL["update"] * moved}
        expected = _expected_train_launches(aum_type, cfg.depth, switches, bf16=False)
        loss_ok = abs(loss_g - loss_c) <= TRAIN_FP32_TOL["loss_rtol"] * abs(loss_c)
        ok = (loss_ok and all(c["ok"] for c in checks.values())
              and all(u["ok"] for u in updates.values()) and launches == expected)
        emit({"phase": "train_fp32_vs_cpu", "aum_type": aum_type,
              "switches": {k: int(bool(v)) for k, v in switches.items()}, "batch": 2,
              "depth": cfg.depth, "width": cfg.embed_dim, "loss_gpu": loss_g, "loss_cpu": loss_c,
              "loss_rtol": TRAIN_FP32_TOL["loss_rtol"], "grads": checks, "lr": hp.lr,
              "params_after_step": updates, "update_tol": TRAIN_FP32_TOL["update"],
              "launches": launches, "expected_launches": expected,
              "gpu_s": s_g, "cpu_s": s_c, "ok": ok})
        if not ok:
            raise RuntimeError(f"fp32 {aum_type} train step on the card ({set_name}) disagrees "
                               "with the CPU plain path, or launched other kernels than expected")
        out[set_name] = launches
    return out


# The train path's switch sets: the default kernels, and the direct forward
# with the fused backward (Fo-Fo has no dual forward: the fused backward
# alone), timed in turns; then sets whose launches alone are checked: the
# fuse_dt rule (with AUM_SCAN_DIRECT=1 also, which it ignores), and every
# opt-in form of the forward and the backward at once (K2 in its x-minus
# form, or the fused kernel, with bf16 partials).
TRAIN_SWITCHES = {"default": {}, "direct_fused": {"AUM_SCAN_DIRECT": True,
                                                  "AUM_SCAN_BWD_FUSED": True}}
FUSE_DT = {"AUM_SCAN_FUSE_DT": True}
TRAIN_CHECK_SWITCHES = {
    "fuse_dt": FUSE_DT,
    "fuse_dt_direct": {**FUSE_DT, "AUM_SCAN_DIRECT": True},
    "opt_in_k2": {**FUSE_DT, "AUM_SCAN_BF16_STAGE": True, "AUM_SCAN_BWD_BF16_PARTIALS": True,
                  "AUM_SCAN_BWD_XMINUS": True},
    "opt_in_fused": {**FUSE_DT, "AUM_SCAN_BF16_STAGE": True, "AUM_SCAN_BWD_BF16_PARTIALS": True,
                     "AUM_SCAN_BWD_FUSED": True},
}


def phase_train() -> dict:
    """The depth-2 fp32 checks, then ``train_entry()`` under each switch set:
    three steps with their launches, then ms per step in turns (default,
    switched, switched, default) and each set's peak memory."""
    from aum_tpu_torch.entry import TRAIN_BATCH, train_entry

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fofo_launches = _train_fp32_check("Fo-Fo", {"default": {},
                                                "fused": {"AUM_SCAN_BWD_FUSED": True}})
    _train_fp32_check("Fo-Bi", {**TRAIN_SWITCHES, "fuse_dt": FUSE_DT})

    step, state, batch = train_entry()
    depth = state.model.config.depth
    out = {"phase": "train_path", "entry": "aum_tpu_torch.entry.train_entry",
           "batch": TRAIN_BATCH, "depth": depth, "dtype": "bfloat16", "remat_mode": "split",
           "fofo_check_launches": fofo_launches}
    for set_name, switches in {**TRAIN_SWITCHES, **TRAIN_CHECK_SWITCHES}.items():
        losses = []
        with scan_switches(**switches):
            for i in range(3):
                torch.cuda.synchronize()
                if i == 1:
                    _reset_counters()
                state, loss = step(state, batch)
                torch.cuda.synchronize()
                if i == 1:
                    launches = _read_counters()
                losses.append(loss.item())
            torch.cuda.reset_peak_memory_stats()
            step(state, batch)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
        expected = _expected_train_launches("Fo-Bi", depth, switches, bf16=True)
        finite = all(math.isfinite(v) for v in losses)
        out[set_name] = {"switches": {k: int(bool(v)) for k, v in switches.items()},
                         "losses": losses, "finite": finite, "launches_per_step": launches,
                         "expected_launches": expected, "peak_mem_bytes": peak, "ms_per_step": []}
        if not finite:
            raise RuntimeError(f"train path losses are not finite ({set_name}): {losses}")
        if launches != expected:
            raise RuntimeError(f"expected {expected} launches per train step ({set_name}), "
                               f"got {launches}")
    for set_name in ("default", "direct_fused", "direct_fused", "default"):
        with scan_switches(**TRAIN_SWITCHES[set_name]), sample_clocks({}) as card:
            ms = cuda_ms(lambda: step(state, batch), iters=5, warmup=1)
        out[set_name]["ms_per_step"].append(ms)
        out[set_name].setdefault("card", []).append(card)
    for set_name in TRAIN_SWITCHES:
        ms = sum(out[set_name]["ms_per_step"]) / 2
        out[set_name]["clips_per_s"] = TRAIN_BATCH / (ms / 1e3)
    emit(out)
    del step, state, batch
    return out


def phase_bench(device_info: dict) -> dict:
    from aum_tpu_torch.entry import flagship_config
    from aum_tpu_torch.models import AudioMamba
    from aum_tpu_torch.ops.conv1d import causal_conv1d_cuda, causal_conv1d_plain
    from aum_tpu_torch.ops.selective_scan import (
        _prep_dt,
        selective_scan_dual_cuda,
        selective_scan_dual_fdt_cuda,
        selective_scan_dual_fdt_plain,
        selective_scan_dual_plain,
    )

    (_, seqlen, d), n, k = EVAL_DIMS, 16, 4
    bsz = BENCH_BATCH
    dtype = torch.bfloat16
    es = 2
    model = AudioMamba(flagship_config(), device="cuda", seed=0)
    x = torch.randn((bsz, 1024, 128), generator=torch.Generator().manual_seed(1)).cuda()

    def forward():
        with torch.inference_mode():
            return model(x)

    # The default path, the direct dual forward (AUM_SCAN_DIRECT=1) and the
    # fuse_dt form (AUM_SCAN_FUSE_DT=1), in turns: default, direct, fuse_dt,
    # fuse_dt, direct, default.
    runs = {name: {"ms_per_forward": [], "card": []} for name in ("default", "direct", "fuse_dt")}
    for name in ("default", "direct", "fuse_dt", "fuse_dt", "direct", "default"):
        with scan_switches(AUM_SCAN_DIRECT=name == "direct", AUM_SCAN_FUSE_DT=name == "fuse_dt"):
            torch.cuda.reset_peak_memory_stats()
            with sample_clocks({}) as card:
                runs[name]["ms_per_forward"].append(cuda_ms(forward, iters=10, warmup=2))
            runs[name]["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        runs[name]["card"].append(card)
    del model
    for run in runs.values():
        run["clips_per_s"] = [bsz / (ms / 1e3) for ms in run["ms_per_forward"]]
    fwd_ms = runs["default"]["ms_per_forward"][0]
    emit({"phase": "bench", "batch": bsz, "dtype": "bfloat16", "ms_per_forward": fwd_ms,
          "clips_per_s": bsz / (fwd_ms / 1e3), "peak_mem_bytes": runs["default"]["peak_mem_bytes"],
          "card": runs["default"]["card"][0], "in_turns": runs})
    wav = bench_wav()

    # Scan at the forward's shapes: v1, both directions on shared operands.
    u, delta, A, B, C, D, z, bias = scan_inputs(bsz, seqlen, d, n, dtype, seed=4)
    dt = _prep_dt(delta, bias)
    fwd = (u, dt, A, B, C, D, z)
    rev = (u, dt, A * 0.5, B, C, D, z)
    # Enough launches that the clock sampler sees the kernel alone (~0.6 s).
    with sample_clocks({}) as card:
        scan_ms = cuda_ms(lambda: selective_scan_dual_cuda(fwd, rev), iters=400)
    with scan_switches(AUM_SCAN_DIRECT=True), sample_clocks({}) as card_direct:
        direct_ms = cuda_ms(lambda: selective_scan_dual_cuda(fwd, rev), iters=400)
    with scan_switches(AUM_SCAN_BF16_STAGE=True), sample_clocks({}) as card_stage:
        stage_ms = cuda_ms(lambda: selective_scan_dual_cuda(fwd, rev), iters=400)
    scan_again_ms = cuda_ms(lambda: selective_scan_dual_cuda(fwd, rev), iters=400)
    scan_plain_ms = cuda_ms(lambda: selective_scan_dual_plain(fwd, rev), iters=2, warmup=1)
    stage_plain_ms = cuda_ms(lambda: selective_scan_dual_plain(fwd, rev, bf16_stage=True),
                             iters=2, warmup=1)
    elems = 2 * bsz * seqlen * d * n  # (b, l, d, n) per direction
    scan_bytes = (3 * bsz * seqlen * d + 2 * bsz * seqlen * n) * es \
        + 2 * bsz * seqlen * d * es + 2 * d * n * 4 + d * 4
    sfu_rate = device_info["sms"] * SFU_PER_SM_PER_CLOCK * max_sm_clock_hz()
    scan_fp32_ops = SCAN_FP32_OPS_PER_ELEMENT * elems
    # bound_ms takes "operations": the exponentials with a share moved to the
    # FP32 pipe; "sfu_only" (every exp2 on the SFUs) is shown beside it.
    scan_bounds = {"bytes": scan_bytes / HBM_BYTES_PER_S * 1e3,
                   "operations": exp_floor_s(elems, scan_fp32_ops, sfu_rate) * 1e3}
    scan_other = {"sfu_only": elems / sfu_rate * 1e3,
                  "fp32_pipe_only": scan_fp32_ops / FP32_PIPE_OPS_PER_S * 1e3}
    del u, delta, dt, z, B, C, fwd, rev

    # The fuse_dt form at the same shapes (v1: one dtr and W for both
    # directions), the product formed in the kernel.
    fold = fold_inputs(bsz, seqlen, d, n, dtype, seed=4)
    fold_r = fold[:3] + (fold[3] * 0.5,) + fold[4:]
    with sample_clocks({}) as card_fdt:
        fdt_ms = cuda_ms(lambda: selective_scan_dual_fdt_cuda(fold, fold_r), iters=400)
    fdt_plain_ms = cuda_ms(lambda: selective_scan_dual_fdt_plain(fold, fold_r), iters=2,
                           warmup=1)
    rank = fold[1].shape[-1]
    # Its bound: the dual forward's exponentials and FP32 work, plus the
    # (B*L, R) @ (R, D) product (once: v1 shares it) on the tensor cores,
    # against bytes with dtr (B, L, R), W and the bias in dt's place.
    fdt_bytes = scan_bytes - bsz * seqlen * d * es + bsz * seqlen * rank * es \
        + rank * d * es + d * 4
    product_s = 2 * bsz * seqlen * rank * d / BF16_TENSOR_FLOPS_PER_S
    fdt_bounds = {"bytes": fdt_bytes / HBM_BYTES_PER_S * 1e3,
                  "operations": (exp_floor_s(elems, scan_fp32_ops, sfu_rate) + product_s) * 1e3}
    del fold, fold_r

    xc, w, b = conv_inputs(bsz, seqlen, d, k, dtype, seed=5)
    with sample_clocks({}) as card_conv:
        conv_ms = cuda_ms(lambda: causal_conv1d_cuda(xc, w, b, "silu", False), iters=3000)
    conv_plain_ms = cuda_ms(lambda: causal_conv1d_plain(xc, w, b, "silu", False), iters=10)
    w3 = w[:, None, :]
    conv_lib_ms = cuda_ms(lambda: torch.nn.functional.silu(torch.nn.functional.conv1d(
        xc.transpose(1, 2), w3, b, padding=k - 1, groups=d)[..., :seqlen]), iters=50)
    conv_bytes = 2 * bsz * seqlen * d * es + d * (k + 1) * es
    conv_bounds = {"bytes": conv_bytes / HBM_BYTES_PER_S * 1e3,
                   "fp32_flops": (2 * k + 4) * bsz * seqlen * d / FP32_FLOPS_PER_S * 1e3}
    # The direct kernel computes the staged one's function: the same plain
    # version and bounds; the staged kernel timed again after it.
    out = {"scan": {"ms": scan_ms, "plain_ms": scan_plain_ms, "bounds_ms": scan_bounds,
                    "other_floors_ms": scan_other, "ms_after_direct": scan_again_ms},
           "scan_direct": {"ms": direct_ms, "plain_ms": scan_plain_ms, "bounds_ms": scan_bounds},
           "scan_stage": {"ms": stage_ms, "plain_ms": stage_plain_ms, "bounds_ms": scan_bounds},
           "scan_fdt": {"ms": fdt_ms, "plain_ms": fdt_plain_ms, "bounds_ms": fdt_bounds,
                        "rank": rank},
           "conv": {"ms": conv_ms, "plain_ms": conv_plain_ms, "library_ms": conv_lib_ms,
                    "bounds_ms": conv_bounds}}
    emit({"phase": "bench_kernels", "dims": [bsz, seqlen, d, n], "dtype": "bfloat16", **out,
          "card": {"scan": card, "scan_direct": card_direct, "scan_stage": card_stage,
                   "scan_fdt": card_fdt, "conv": card_conv}})
    del xc, w, b
    single = bench_single_kernels(sfu_rate)
    train = bench_train_kernels(sfu_rate)
    return {**out, **single, **train, "wav": wav}


def bench_wav() -> dict:
    """``wav_entry``'s model (AuM-Base Fo-Fo, bf16) at B=64 from waveforms:
    clips/s, and the frontend alone."""
    from aum_tpu_torch.entry import (
        CLIP_SAMPLES,
        flagship_config,
        wav_forward_fn,
        wav_frontend_fn,
    )
    from aum_tpu_torch.models import AudioMamba

    bsz = BENCH_BATCH
    model = AudioMamba(flagship_config("Fo-Fo"), device="cuda", seed=0)
    fn = wav_forward_fn(model)
    wav = (0.1 * torch.randn((bsz, CLIP_SAMPLES), generator=torch.Generator().manual_seed(1))
           ).cuda()
    frontend = wav_frontend_fn(model.config)
    torch.cuda.reset_peak_memory_stats()

    def forward():
        with torch.inference_mode():
            return fn(wav)

    with sample_clocks({}) as card:
        fwd_ms = cuda_ms(forward, iters=10, warmup=2)
    peak = torch.cuda.max_memory_allocated()
    frontend_ms = cuda_ms(lambda: frontend(wav), iters=10)
    del model, fn
    out = {"phase": "bench_wav", "batch": bsz, "samples": CLIP_SAMPLES, "dtype": "bfloat16",
           "bimamba": "none", "ms_per_forward": fwd_ms, "clips_per_s": bsz / (fwd_ms / 1e3),
           "frontend_ms": frontend_ms, "peak_mem_bytes": peak, "card": card}
    emit(out)
    return out


def _single_bounds(bsz, seqlen, d, n, es, sfu_rate, extra_bytes=0) -> dict:
    """One direction's scan forward: u, dt, z, B, C, A, D read once, out
    written once (plus ``extra_bytes`` of states); one exp2 and
    SCAN_FP32_OPS_PER_ELEMENT FP32-pipe instructions per (b, l, d, n)."""
    elems = bsz * seqlen * d * n
    nbytes = (4 * bsz * seqlen * d + 2 * bsz * seqlen * n) * es + (n + 1) * d * 4 + extra_bytes
    return {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
            "operations": exp_floor_s(elems, SCAN_FP32_OPS_PER_ELEMENT * elems, sfu_rate) * 1e3}


def bench_single_kernels(sfu_rate: float) -> dict:
    """The single-direction scan forward (bf16): at the Fo-Fo bench forward's
    shapes (B=64) as is and in its with_state form, and its saving form at
    the train shapes (B=12)."""
    from aum_tpu_torch.ops.selective_scan import (
        STATE_CHUNK,
        _prep_dt,
        selective_scan_cuda,
        selective_scan_plain,
    )

    (_, seqlen, d), n, es = EVAL_DIMS, 16, 2
    dtype = torch.bfloat16
    out, cards = {}, {}
    for bsz, form in ((BENCH_BATCH, "eval"), (BENCH_BATCH, "with_state"),
                      (TRAIN_DIMS[0], "save_states")):
        u, delta, A, B, C, D, z, bias = scan_inputs(bsz, seqlen, d, n, dtype, seed=13)
        args = (u, _prep_dt(delta, bias), A, B, C, D, z)
        kw, extra = {}, 0
        if form == "with_state":
            kw = {"initial_state": torch.zeros((bsz, d, n), device="cuda"),
                  "return_final_state": True}
            extra = 2 * bsz * n * d * 4
        elif form == "save_states":
            kw = {"save_states": True}
            extra = bsz * math.ceil(seqlen / STATE_CHUNK) * n * d * 4
        # Enough launches (about a second) that the clock sampler, which
        # takes a few hundred ms to start, sees the kernel alone.
        with sample_clocks({}) as cards[form]:
            ms = cuda_ms(lambda: selective_scan_cuda(args, False, **kw), iters=1500)
        plain_ms = cuda_ms(lambda: selective_scan_plain(args, False, **kw), iters=2, warmup=1)
        out[f"scan_single_{form}"] = {
            "ms": ms, "plain_ms": plain_ms, "batch": bsz,
            "bounds_ms": _single_bounds(bsz, seqlen, d, n, es, sfu_rate, extra),
            "other_floors_ms": {"sfu_only": bsz * seqlen * d * n / sfu_rate * 1e3}}
        del u, delta, z, B, C, args
    emit({"phase": "bench_single_kernels", "dims": [seqlen, d, n], "dtype": "bfloat16", **out,
          "card": cards})
    return out


def bench_train_kernels(sfu_rate: float) -> dict:
    """The train path's scan kernels at its shapes (v1, B=12, bf16): the
    saving forward, staged and direct; the backward of both directions in one
    launch (the train path's form) and of the forward direction alone, the
    fused kernel and K2 in turns (fused, K2, K2, fused); and K2's with_state
    form on one direction."""
    from aum_tpu_torch.ops.selective_scan import (
        STATE_CHUNK,
        selective_scan_bwd_cuda,
        selective_scan_bwd_plain,
        selective_scan_cuda,
        selective_scan_dual_cuda,
        selective_scan_dual_plain,
    )

    (bsz, seqlen, d), n = TRAIN_DIMS, 16
    dtype, es = torch.bfloat16, 2
    dir_f, dir_r = _scan_dirs(bsz, seqlen, d, dtype, shared=True)
    with sample_clocks({}) as card_save:
        save_ms = cuda_ms(lambda: selective_scan_dual_cuda(dir_f, dir_r, save_states=True),
                          iters=400)
    with scan_switches(AUM_SCAN_DIRECT=True), sample_clocks({}) as card_save_direct:
        save_direct_ms = cuda_ms(
            lambda: selective_scan_dual_cuda(dir_f, dir_r, save_states=True), iters=400)
    with scan_switches(AUM_SCAN_BF16_STAGE=True), sample_clocks({}) as card_save_stage:
        save_stage_ms = cuda_ms(
            lambda: selective_scan_dual_cuda(dir_f, dir_r, save_states=True), iters=400)
    save_plain_ms = cuda_ms(lambda: selective_scan_dual_plain(dir_f, dir_r, save_states=True),
                            iters=1, warmup=1)
    save_stage_plain_ms = cuda_ms(lambda: selective_scan_dual_plain(
        dir_f, dir_r, save_states=True, bf16_stage=True), iters=1, warmup=1)
    _, _, xb_f, xb_r = selective_scan_dual_cuda(dir_f, dir_r, save_states=True)
    g = torch.Generator().manual_seed(9)
    gs = [torch.randn((bsz, seqlen, d), generator=g).to("cuda", dtype) for _ in range(2)]
    dirs = [dir_f + (False,), dir_r + (True,)]
    # The fused kernel and K2 in turns (fused, K2, K2, fused): both
    # directions in one launch, then the forward direction alone.
    turns = {name: {"two": [], "one": []} for name in ("fused", "k2")}
    cards = {}
    for name in ("fused", "k2", "k2", "fused"):
        with scan_switches(AUM_SCAN_BWD_FUSED=name == "fused"), sample_clocks({}) as card:
            turns[name]["two"].append(cuda_ms(
                lambda: selective_scan_bwd_cuda(dirs, gs, [xb_f, xb_r]), iters=100))
            turns[name]["one"].append(cuda_ms(
                lambda: selective_scan_bwd_cuda(dirs[:1], gs[:1], [xb_f]), iters=100))
        cards.setdefault(name, card)
    card_bwd, card_fused = cards["k2"], cards["fused"]
    bwd_ms, bwd1_ms = turns["k2"]["two"][0], turns["k2"]["one"][0]
    fused_ms, fused1_ms = turns["fused"]["two"][0], turns["fused"]["one"][0]
    bwd_plain_ms = cuda_ms(lambda: selective_scan_bwd_plain(dirs, gs), iters=1, warmup=1)
    bwd1_plain_ms = cuda_ms(lambda: selective_scan_bwd_plain(dirs[:1], gs[:1]),
                            iters=1, warmup=1)
    with scan_switches(AUM_SCAN_BWD_FUSED=True, AUM_SCAN_BWD_BF16_PARTIALS=True):
        fused_part_ms = cuda_ms(lambda: selective_scan_bwd_cuda(dirs, gs, [xb_f, xb_r]),
                                iters=100)
    # K2's opt-in forms in turns with the default: default, bf16 partials,
    # x-minus, x-minus, bf16 partials, default (the default's first turn is
    # bwd_ms above).
    forms = {"bf16_partials": {"AUM_SCAN_BWD_BF16_PARTIALS": True},
             "xminus": {"AUM_SCAN_BWD_XMINUS": True}, "default": {}}
    form_ms = {name: [] for name in forms}
    for name in ("bf16_partials", "xminus", "xminus", "bf16_partials", "default"):
        with scan_switches(**forms[name]):
            form_ms[name].append(cuda_ms(
                lambda: selective_scan_bwd_cuda(dirs, gs, [xb_f, xb_r]), iters=100))
    bwd_again_ms = form_ms["default"][0]
    # K2's with_state form: the saving forward from a random x0, then the
    # backward with a random cotangent of the final state.
    x0, gfin = (torch.randn((bsz, d, n), generator=g).cuda() for _ in range(2))
    _, xb_s, _ = selective_scan_cuda(dir_f, False, save_states=True, initial_state=x0,
                                     return_final_state=True)
    with sample_clocks({}) as card_state:
        state_ms = cuda_ms(lambda: selective_scan_bwd_cuda(dirs[:1], gs[:1], [xb_s],
                                                           gfins=[gfin]), iters=1000)
    state_plain_ms = cuda_ms(lambda: selective_scan_bwd_plain(dirs[:1], gs[:1],
                                                              states=[(x0, gfin)]),
                             iters=1, warmup=1)

    bld, bln = bsz * seqlen * d, bsz * seqlen * n
    xb_bytes = bsz * math.ceil(seqlen / STATE_CHUNK) * n * d * 4  # one direction
    elems = bld * n  # (b, l, d, n) of one direction
    # Saving forward: u, dt, z, B, C read once (v1 shares them), both outputs
    # and both directions' states written once.
    save_bytes = (3 * bld + 2 * bln) * es + 2 * bld * es + 2 * xb_bytes + 2 * d * n * 4 + d * 4
    save_fp32 = SCAN_FP32_OPS_PER_ELEMENT * 2 * elems
    save_bounds = {"bytes": save_bytes / HBM_BYTES_PER_S * 1e3,
                   "operations": exp_floor_s(2 * elems, save_fp32, sfu_rate) * 1e3}
    def bwd_bounds(ndir: int) -> dict:
        # The function's bytes: u, dt, z, B, C read once, and per direction
        # its cotangent, states, A and D; per direction du, ddelta, dz, dB,
        # dC and the fp32 dA, dD, dbias written once. The kernel's own fp32
        # partials (summed by its wrapper) are a choice of its design, not
        # bytes the function needs.
        nbytes = ((3 * bld + 2 * bln) * es + ndir * (bld * es + xb_bytes + (n + 1) * d * 4
                  + (3 * bld + 2 * bln) * es + (n + 2) * d * 4))
        fp32 = SCAN_BWD_FP32_OPS_PER_ELEMENT * ndir * elems
        return {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                "operations": exp_floor_s(ndir * elems, fp32, sfu_rate) * 1e3}

    # The direct and the fused kernels compute the functions of the staged
    # forward and K2: the same plain versions and bounds. The with_state
    # backward moves gfin in and dx0 out on top of K2's one direction.
    state_bounds = bwd_bounds(1)
    state_bounds["bytes"] += 2 * bsz * n * d * 4 / HBM_BYTES_PER_S * 1e3
    out = {"scan_save": {"ms": save_ms, "plain_ms": save_plain_ms, "bounds_ms": save_bounds},
           "scan_save_direct": {"ms": save_direct_ms, "plain_ms": save_plain_ms,
                                "bounds_ms": save_bounds},
           "scan_save_stage": {"ms": save_stage_ms, "plain_ms": save_stage_plain_ms,
                               "bounds_ms": save_bounds},
           "scan_bwd": {"ms": bwd_ms, "ms_turns": turns["k2"]["two"], "plain_ms": bwd_plain_ms,
                        "bounds_ms": bwd_bounds(2),
                        "other_floors_ms": {"sfu_only": 2 * elems / sfu_rate * 1e3,
                                            "fp32_pipe_only": SCAN_BWD_FP32_OPS_PER_ELEMENT
                                            * 2 * elems / FP32_PIPE_OPS_PER_S * 1e3},
                        "ms_after_fused": bwd_again_ms},
           "scan_bwd_one_direction": {"ms": bwd1_ms, "ms_turns": turns["k2"]["one"],
                                      "plain_ms": bwd1_plain_ms, "bounds_ms": bwd_bounds(1)},
           "scan_bwd_fused": {"ms": fused_ms, "ms_turns": turns["fused"]["two"],
                              "plain_ms": bwd_plain_ms, "bounds_ms": bwd_bounds(2)},
           "scan_bwd_fused_bf16_partials": {"ms": fused_part_ms, "plain_ms": bwd_plain_ms,
                                            "bounds_ms": bwd_bounds(2)},
           "scan_bwd_bf16_partials": {"ms": form_ms["bf16_partials"][0],
                                      "ms_turns": form_ms["bf16_partials"],
                                      "plain_ms": bwd_plain_ms, "bounds_ms": bwd_bounds(2)},
           "scan_bwd_xminus": {"ms": form_ms["xminus"][0], "ms_turns": form_ms["xminus"],
                               "plain_ms": bwd_plain_ms, "bounds_ms": bwd_bounds(2)},
           "scan_bwd_fused_one_direction": {"ms": fused1_ms, "ms_turns": turns["fused"]["one"],
                                            "plain_ms": bwd1_plain_ms,
                                            "bounds_ms": bwd_bounds(1)},
           "scan_bwd_with_state": {"ms": state_ms, "plain_ms": state_plain_ms,
                                   "bounds_ms": state_bounds}}
    emit({"phase": "bench_train_kernels", "dims": [bsz, seqlen, d, n], "dtype": "bfloat16",
          "bimamba": "v1", **out, "card": {"scan_save": card_save,
                                           "scan_save_direct": card_save_direct,
                                           "scan_save_stage": card_save_stage,
                                           "scan_bwd": card_bwd, "scan_bwd_fused": card_fused,
                                           "scan_bwd_with_state": card_state}})
    return out


# Exploratory builds of the fused backward, by the macros of its source:
# AUM_FUSED_PROBE times one piece of its work (outputs wrong by design);
# AUM_FUSED_HOLD (steps per slot) and AUM_FUSED_MIN_BLOCKS (the register
# cap's blocks per SM) are the design's two choices, each build a whole
# kernel.
FUSED_PROBES = {"walk_only": ["-DAUM_FUSED_PROBE=1"],
                "adjoint_only": ["-DAUM_FUSED_PROBE=2"],
                "global_streams": ["-DAUM_FUSED_PROBE=3"],
                **{f"hold{h}_blocks{m}": [f"-DAUM_FUSED_HOLD={h}", f"-DAUM_FUSED_MIN_BLOCKS={m}"]
                   for h, m in ((8, 4), (8, 6), (8, 8), (4, 4), (4, 5), (4, 7), (4, 8), (2, 5))}}


def probe_fused_bwd(trees: dict[str, str] | None = None,
                    probes: dict[str, list[str]] | None = None) -> dict:
    """The fused backward against its exploratory builds (``probes``, name
    to nvcc flags; FUSED_PROBES by default) at the train path's shapes
    (B=12, L=513, D=1536, N=16, bf16, v1; both directions in one launch and
    the forward direction alone), with K2 and the fused kernels of other
    trees (``trees``, name to a ``csrc`` directory) beside them: every
    variant in one order, then in the reverse order, and each variant's
    resources from its ``aum_kernel_info``. Not part of ``main``; after
    ``phase_device()`` and ``phase_build()``, run as
    ``probe_fused_bwd({"parent": "build/parent/aum_tpu_torch/csrc"})``."""
    import ctypes
    import importlib
    from pathlib import Path

    from aum_tpu_torch.ops import _build

    ss = importlib.import_module("aum_tpu_torch.ops.selective_scan")
    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    builds = {name: (_build.CSRC_DIR, flags)
              for name, flags in (FUSED_PROBES if probes is None else probes).items()}
    builds.update({name: (Path(src), []) for name, src in (trees or {}).items()})
    start = time.perf_counter()
    procs = {}
    for name, (src_dir, flags) in builds.items():
        path = out_dir / f"{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(path),
               str(src_dir / "selective_scan_bwd_fused.cu")]
        procs[name] = (path, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
    paths = {}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        path.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} build:\n{log}")
        paths[name] = path
    build_s = time.perf_counter() - start

    real_library = _build.library
    libs, resources = {"fused": ss._bwd_fused_lib()}, {}
    try:
        for name, path in paths.items():
            lib = ctypes.CDLL(str(path))
            _build.library = lambda _name, lib=lib: lib
            libs[name] = ss._bwd_fused_lib.__wrapped__()  # the wrapper's load-time checks
        for name, lib in libs.items():
            _build.library = lambda _name, lib=lib: lib
            resources[name] = _build.kernel_resources("selective_scan_bwd_fused")[0]
    finally:
        _build.library = real_library

    (bsz, seqlen, d), n = TRAIN_DIMS, 16
    dir_f, dir_r = _scan_dirs(bsz, seqlen, d, torch.bfloat16, shared=True)
    _, _, xb_f, xb_r = ss.selective_scan_dual_cuda(dir_f, dir_r, save_states=True)
    g = torch.Generator().manual_seed(9)
    gs = [torch.randn((bsz, seqlen, d), generator=g).to("cuda", torch.bfloat16)
          for _ in range(2)]
    dirs = [dir_f + (False,), dir_r + (True,)]
    order = [*libs, "k2"]
    ms = {name: {"two": [], "one": []} for name in order}
    # Each whole build (no AUM_FUSED_PROBE) against K2 on the same inputs.
    with scan_switches(AUM_SCAN_BWD_FUSED=False):
        want = ss.selective_scan_bwd_cuda(dirs, gs, [xb_f, xb_r])
    agree = {}
    real_lib = ss._bwd_fused_lib
    try:
        for name in libs:
            if any("AUM_FUSED_PROBE" in f for f in builds.get(name, (None, []))[1]):
                continue
            ss._bwd_fused_lib = lambda lib=libs[name]: lib
            with scan_switches(AUM_SCAN_BWD_FUSED=True):
                got = ss.selective_scan_bwd_cuda(dirs, gs, [xb_f, xb_r])
            agree[name] = max(compare_scaled(a, b, GRAD_TOL[torch.bfloat16])["scaled_err"]
                              for gd, wd in zip(got, want) for a, b in zip(gd, wd))
        for name in order + order[::-1]:
            if name != "k2":
                ss._bwd_fused_lib = lambda lib=libs[name]: lib
            with scan_switches(AUM_SCAN_BWD_FUSED=name != "k2"):
                ms[name]["two"].append(cuda_ms(
                    lambda: ss.selective_scan_bwd_cuda(dirs, gs, [xb_f, xb_r]), iters=100))
                ms[name]["one"].append(cuda_ms(
                    lambda: ss.selective_scan_bwd_cuda(dirs[:1], gs[:1], [xb_f]), iters=100))
    finally:
        ss._bwd_fused_lib = real_lib
    out = {"dims": [bsz, seqlen, d, n], "dtype": "bfloat16", "bimamba": "v1",
           "order": order + order[::-1], "ms": ms, "resources": resources,
           "scaled_err_vs_k2": agree,
           "build_s": build_s, "card": smi("name,power.limit")}
    emit({"phase": "probe_fused_bwd", **out})
    return out


def _kernel_category(name: str) -> str:
    low = name.lower()
    if "scan_bwd_kernel" in low:
        return "scan_bwd_kernel"
    if "scan_bwd_fused_kernel" in low:
        return "scan_bwd_fused_kernel"
    if "scan_dual_fwd_kernel" in low:
        return "scan_fwd_kernel"
    if "scan_dual_direct_fwd_kernel" in low:
        return "scan_direct_fwd_kernel"
    if "scan_dual_fdt_fwd_kernel" in low:
        return "scan_fdt_fwd_kernel"
    if "scan_dual_stage_fwd_kernel" in low:
        return "scan_stage_fwd_kernel"
    if "scan_single_fwd_kernel" in low:
        return "scan_single_fwd_kernel"
    if "conv1d_fwd_kernel" in low:
        return "conv_kernel"
    if any(s in low for s in ("gemm", "nvjet", "cutlass", "xmma")):
        return "matmul"
    if "fft" in low or "radix" in low:  # cuFFT's kernels: the frontend's rfft
        return "frontend_fft"
    return "other"


def _profile(label: str, fn, **info) -> dict:
    """``fn`` once under torch.profiler: device time by kernel category,
    device busy time against the wall time (the idle share)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_cat, by_name, spans = {}, {}, []
    for e in kernels:
        ms = e.time_range.elapsed_us() / 1e3
        cat = _kernel_category(e.name)
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
        total, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + ms, count + 1)
        spans.append((e.time_range.start, e.time_range.end))
    busy_us, last_end = 0.0, None
    for start, end in sorted(spans):
        if last_end is None or start >= last_end:
            busy_us += end - start
            last_end = end
        elif end > last_end:
            busy_us += end - last_end
            last_end = end
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    out = {"phase": label, **info, "wall_ms": wall_ms,
           "kernels_traced": len(kernels), "device_busy_ms": busy_us / 1e3,
           "idle_share": 1.0 - busy_us / 1e3 / wall_ms if kernels else None,
           "by_category_ms": by_cat,
           "top_kernels": [[name[:90], ms, n] for name, (ms, n) in top]}
    emit(out)
    return out


def phase_profile() -> dict:
    """One Fo-Bi bench forward (B=64), one Fo-Fo forward from waveforms
    (B=64), then one train step of the train path."""
    from aum_tpu_torch.entry import (
        CLIP_SAMPLES,
        TRAIN_BATCH,
        flagship_config,
        train_entry,
        wav_forward_fn,
    )
    from aum_tpu_torch.models import AudioMamba

    model = AudioMamba(flagship_config(), device="cuda", seed=0)
    x = torch.randn((BENCH_BATCH, *reversed(model.config.spectrogram_size)),
                    generator=torch.Generator().manual_seed(1)).cuda()

    def forward():
        with torch.inference_mode():
            model(x)

    forward()
    out = {"eval": _profile("profile", forward, batch=BENCH_BATCH, dtype="bfloat16")}
    with scan_switches(AUM_SCAN_FUSE_DT=True):
        forward()
        out["eval_fuse_dt"] = _profile("profile_fuse_dt", forward, batch=BENCH_BATCH,
                                       dtype="bfloat16", switches={"AUM_SCAN_FUSE_DT": 1})
    del model, x
    fn = wav_forward_fn(AudioMamba(flagship_config("Fo-Fo"), device="cuda", seed=0))
    wav = (0.1 * torch.randn((BENCH_BATCH, CLIP_SAMPLES),
                             generator=torch.Generator().manual_seed(1))).cuda()

    def wav_forward():
        with torch.inference_mode():
            fn(wav)

    wav_forward()
    out["wav"] = _profile("profile_wav", wav_forward, batch=BENCH_BATCH, dtype="bfloat16",
                          bimamba="none", samples=CLIP_SAMPLES)
    del fn, wav
    step, state, batch = train_entry()
    step(state, batch)
    out["train"] = _profile("profile_train_step", lambda: step(state, batch),
                            batch=TRAIN_BATCH, dtype="bfloat16", remat_mode="split")
    return out


def _bound(bounds: dict) -> tuple[float, str]:
    key = max(bounds, key=bounds.get)
    return bounds[key], "bytes" if key == "bytes" else "operations"


def _kernel_entry(name, source, replaces, launches, max_abs_err, bench, library_ms=None):
    bound, by = _bound(bench["bounds_ms"])
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max_abs_err, "ms": bench["ms"],
            "plain_ms": bench["plain_ms"], "bound_ms": bound, "bound_by": by,
            "library_ms": library_ms}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import aum_tpu_torch  # noqa: F401  (fails here, before any output, outside a checkout)

    t0 = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        start = time.perf_counter()
        result = fn(*args)
        seconds[name] = time.perf_counter() - start
        emit({"phase": "seconds", "of": name, "seconds": seconds[name]})
        return result

    # Every phase starts from the default kernels; each switched run sets its
    # switches itself.
    with scan_switches(**dict.fromkeys(SWITCHES, False)):
        device_info = timed("device", phase_device)
        timed("build", phase_build)
        worst = timed("kernels", phase_kernels)
        eval_runs = timed("model", phase_model)
        wav_launches = timed("wav", phase_wav)
        train = timed("train", phase_train)
        bench = timed("bench", phase_bench, device_info)
        timed("profile", phase_profile)
    emit({"phase": "done", "seconds": time.perf_counter() - t0, "by_phase": seconds})
    eval_launches, eval_direct = eval_runs["default"], eval_runs["direct"]
    train_launches = train["default"]["launches_per_step"]
    train_switched = train["direct_fused"]["launches_per_step"]
    train_fdt = train["fuse_dt"]["launches_per_step"]
    train_opt_k2 = train["opt_in_k2"]["launches_per_step"]
    train_opt_fused = train["opt_in_fused"]["launches_per_step"]
    fofo_launches = train["fofo_check_launches"]["default"]
    fofo_fused = train["fofo_check_launches"]["fused"]
    scan = _kernel_entry(
        "selective_scan_dual_fwd", "aum_tpu_torch/csrc/selective_scan.cu",
        "aum_tpu/ops/selective_scan.py:1648", eval_launches["selective_scan_dual_fwd"],
        worst["selective_scan_dual_fwd"], bench["scan"])
    # The same kernel saving its chunk-entry states, on the train path.
    scan["save_states"] = _kernel_entry(
        "selective_scan_dual_fwd", scan["source"], scan["replaces"],
        train_launches["selective_scan_dual_fwd_save_states"],
        worst["selective_scan_dual_fwd_save_states"], bench["scan_save"])
    scan["launches_by_path"] = {"eval": eval_launches["selective_scan_dual_fwd"],
                                "wav": wav_launches["selective_scan_dual_fwd"],
                                "train": train_launches["selective_scan_dual_fwd"],
                                "eval_fuse_dt": eval_runs["fuse_dt"]["selective_scan_dual_fwd"],
                                "train_fuse_dt": train_fdt["selective_scan_dual_fwd"]}
    # AUM_SCAN_FUSE_DT=1: entry() runs the fuse_dt form (train_entry() the
    # staged saving forward above, with delta formed outside the kernel).
    fdt = _kernel_entry(
        "selective_scan_dual_fdt_fwd", scan["source"],
        "aum_tpu/ops/selective_scan.py:1648 (fuse_dt, :1705-1731)",
        eval_runs["fuse_dt"]["selective_scan_dual_fdt_fwd"], worst["selective_scan_dual_fdt_fwd"],
        bench["scan_fdt"])
    fdt["launches_by_path"] = {
        "eval_fuse_dt": eval_runs["fuse_dt"]["selective_scan_dual_fdt_fwd"],
        "eval_fuse_dt_direct": eval_runs["fuse_dt_direct"]["selective_scan_dual_fdt_fwd"],
        "eval": eval_launches["selective_scan_dual_fdt_fwd"],
        "train_fuse_dt": train_fdt["selective_scan_dual_fdt_fwd"]}
    # AUM_SCAN_BF16_STAGE=1: entry() and the train path's saving forward.
    stage = _kernel_entry(
        "selective_scan_dual_stage_fwd", scan["source"],
        "aum_tpu/ops/selective_scan.py:1648 (bf16_stage, :1689-1702, :1751-1752, :1767-1770)",
        eval_runs["bf16_stage"]["selective_scan_dual_stage_fwd"],
        worst["selective_scan_dual_stage_fwd"], bench["scan_stage"])
    stage["save_states"] = _kernel_entry(
        "selective_scan_dual_stage_fwd", scan["source"], stage["replaces"],
        train_opt_k2["selective_scan_dual_stage_fwd_save_states"],
        worst["selective_scan_dual_stage_fwd_save_states"], bench["scan_save_stage"])
    stage["launches_by_path"] = {
        "eval_bf16_stage": eval_runs["bf16_stage"]["selective_scan_dual_stage_fwd"],
        "train_opt_in": train_opt_k2["selective_scan_dual_stage_fwd"],
        "eval": eval_launches["selective_scan_dual_stage_fwd"],
        "train": train_launches["selective_scan_dual_stage_fwd"]}
    # AUM_SCAN_DIRECT=1: entry() and train_entry() run the direct kernel.
    direct = _kernel_entry(
        "selective_scan_dual_direct_fwd", scan["source"], "aum_tpu/ops/selective_scan.py:1856",
        eval_direct["selective_scan_dual_direct_fwd"], worst["selective_scan_dual_direct_fwd"],
        bench["scan_direct"])
    direct["save_states"] = _kernel_entry(
        "selective_scan_dual_direct_fwd", scan["source"], direct["replaces"],
        train_switched["selective_scan_dual_direct_fwd_save_states"],
        worst["selective_scan_dual_direct_fwd_save_states"], bench["scan_save_direct"])
    direct["launches_by_path"] = {
        "eval_direct": eval_direct["selective_scan_dual_direct_fwd"],
        "train_direct_fused": train_switched["selective_scan_dual_direct_fwd"],
        "eval": eval_launches["selective_scan_dual_direct_fwd"],
        "train": train_launches["selective_scan_dual_direct_fwd"]}
    bwd = _kernel_entry(
        "selective_scan_bwd", "aum_tpu_torch/csrc/selective_scan_bwd.cu",
        "aum_tpu/ops/selective_scan.py:392", train_launches["selective_scan_bwd"],
        worst["selective_scan_bwd"], bench["scan_bwd"])
    bwd["also_replaces"] = "aum_tpu/ops/selective_scan.py:822 (both directions in one launch)"
    bwd["launches_by_path"] = {"eval": 0, "wav": 0, "train": train_launches["selective_scan_bwd"],
                               "fofo_train_check": fofo_launches["selective_scan_bwd"],
                               "train_direct_fused": train_switched["selective_scan_bwd"],
                               "train_fuse_dt": train_fdt["selective_scan_bwd"]}
    # Its opt-in forms on the train path with every opt-in switch on
    # (AUM_SCAN_BWD_XMINUS=1, AUM_SCAN_BWD_BF16_PARTIALS=1).
    bwd["xminus"] = _kernel_entry(
        "selective_scan_bwd", bwd["source"],
        "aum_tpu/ops/selective_scan.py:392 (dla_mode xminus/dbu, :497-537)",
        train_opt_k2["selective_scan_bwd_xminus"], worst["selective_scan_bwd_xminus"],
        bench["scan_bwd_xminus"])
    bwd["bf16_partials"] = _kernel_entry(
        "selective_scan_bwd", bwd["source"],
        "aum_tpu/ops/selective_scan.py:392 (bf16 dB/dC partials, :741-757)",
        train_opt_k2["selective_scan_bwd_bf16_partials"],
        worst["selective_scan_bwd_bf16_partials"], bench["scan_bwd_bf16_partials"])
    # The same kernel on one direction, the form of _bwd_kernel: the Fo-Fo
    # train check launches it (the train path takes both directions at once).
    bwd["one_direction"] = _kernel_entry(
        "selective_scan_bwd", bwd["source"], bwd["replaces"],
        fofo_launches["selective_scan_bwd"], worst["selective_scan_bwd"],
        bench["scan_bwd_one_direction"])
    # Its with_state form, which no entry path runs yet (the LM prefill and
    # sequence parallelism); the chained-segment kernel check runs it through
    # selective_scan under autograd.
    bwd["with_state"] = _kernel_entry(
        "selective_scan_bwd", bwd["source"], "aum_tpu/ops/selective_scan.py:392 (with_state)",
        train_launches["selective_scan_bwd_with_state"],
        worst["selective_scan_bwd_with_state"], bench["scan_bwd_with_state"])
    # AUM_SCAN_BWD_FUSED=1: train_entry() (both directions per launch) and
    # the Fo-Fo train check (one direction) run the fused kernel.
    fused = _kernel_entry(
        "selective_scan_bwd_fused", "aum_tpu_torch/csrc/selective_scan_bwd_fused.cu",
        "aum_tpu/ops/selective_scan.py:553", train_switched["selective_scan_bwd_fused"],
        worst["selective_scan_bwd_fused"], bench["scan_bwd_fused"])
    fused["one_direction"] = _kernel_entry(
        "selective_scan_bwd_fused", fused["source"], fused["replaces"],
        fofo_fused["selective_scan_bwd_fused"], worst["selective_scan_bwd_fused"],
        bench["scan_bwd_fused_one_direction"])
    fused["launches_by_path"] = {"train_direct_fused": train_switched["selective_scan_bwd_fused"],
                                 "fofo_train_check_fused": fofo_fused["selective_scan_bwd_fused"],
                                 "train": train_launches["selective_scan_bwd_fused"]}
    fused["bf16_partials"] = _kernel_entry(
        "selective_scan_bwd_fused", fused["source"],
        "aum_tpu/ops/selective_scan.py:553 (bf16 dB/dC partials, :741-757)",
        train_opt_fused["selective_scan_bwd_bf16_partials"],
        worst["selective_scan_bwd_fused_bf16_partials"], bench["scan_bwd_fused_bf16_partials"])
    single = _kernel_entry(
        "selective_scan_fwd", "aum_tpu_torch/csrc/selective_scan.cu",
        "aum_tpu/ops/selective_scan.py:111", wav_launches["selective_scan_fwd"],
        worst["selective_scan_fwd"], bench["scan_single_eval"])
    # Its saving form, under grad (the Fo-Fo train check), and its with_state
    # form, which no path runs yet (the LM prefill and sequence parallelism).
    single["save_states"] = _kernel_entry(
        "selective_scan_fwd", single["source"], single["replaces"],
        fofo_launches["selective_scan_fwd_save_states"],
        worst["selective_scan_fwd_save_states"], bench["scan_single_save_states"])
    single["with_state"] = _kernel_entry(
        "selective_scan_fwd", single["source"], single["replaces"],
        wav_launches["selective_scan_fwd_with_state"],
        worst["selective_scan_fwd_with_state"], bench["scan_single_with_state"])
    single["launches_by_path"] = {"eval": eval_launches["selective_scan_fwd"],
                                  "wav": wav_launches["selective_scan_fwd"],
                                  "train": train_launches["selective_scan_fwd"],
                                  "fofo_train_check": fofo_launches["selective_scan_fwd"]}
    conv = _kernel_entry(
        "causal_conv1d_fwd", "aum_tpu_torch/csrc/conv1d.cu", "aum_tpu/ops/conv1d.py:107",
        eval_launches["causal_conv1d_fwd"], worst["causal_conv1d_fwd"], bench["conv"],
        library_ms=bench["conv"]["library_ms"])
    conv["launches_by_path"] = {"eval": eval_launches["causal_conv1d_fwd"],
                                "wav": wav_launches["causal_conv1d_fwd"],
                                "train": train_launches["causal_conv1d_fwd"]}
    emit({"kernels": [scan, direct, fdt, stage, single, bwd, fused, conv]})
    print(smi("name,power.limit"), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
