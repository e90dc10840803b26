#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``aum_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py

Phases (each prints JSON lines; any failure raises and the exit code is not 0):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; build: nvcc compiles every kernel from ``aum_tpu_torch/csrc/``
   (all sources at once) and the build time is printed.
2. kernels: each kernel against its plain PyTorch version on the card, in
   fp32 and bf16, v1 (shared operands) and v2 (separate), both scan
   directions, conv causal and anti-causal: the eval forward at the eval
   path's shapes (B=8, L=513, D=1536, N=16, strided operands as the model
   passes them); the forward with saved states (outputs and states), the
   scan backward in both forms (one launch for both directions, one launch
   per direction; all 8 grads per direction) and the conv backward at the
   train path's shapes (B=12, L=513); all of them at ragged shapes (L=37,
   D=40; L=150, three state chunks, the last one short).
3. model: AuM-Base Fo-Bi at full width and depth 24. fp32, B=2: the card
   (with kernels) against the same weights on the CPU (plain path). Then the
   eval path itself, ``aum_tpu_torch.entry.entry()`` (bf16, B=8), with every
   launch counter set to 0 just before and read just after: it must show 24
   scan and 24 conv launches, and (8, 527) finite logits; then its latency
   (CUDA events, 10 forwards after warm-up).
4. train: AuM-Base Fo-Bi at full width, depth 2, fp32, B=2: the loss and the
   grads of in_proj, A_log, A_b_log, dt_proj.bias and conv1d.weight, and
   those params after one full train step (Adam, no warmup), on the card
   against the same weights on the CPU (plain path).
   Then the train path itself, ``aum_tpu_torch.entry.train_entry()`` (depth
   24, bf16, B=12, split remat): three steps with finite losses, one of them
   between a reset and a read of every launch counter (24 saving forwards,
   24 backwards, 96 conv launches: forward, split recompute, and the
   backward's pre-activation and dx); then ms per step and clips/s (CUDA
   events after warm-up), peak memory, SM clock and power.
5. bench: the ``bench.py`` workload (B=64 x 1024 x 128, bf16): clips/s with
   CUDA events after warm-up, then per kernel at the shapes that forward gives
   it: ms per launch, the plain version's ms, the least time the card could
   take (bound), and for the conv one PyTorch call computing the same function
   (``F.conv1d(groups=D)`` + SiLU) as a yardstick the port never calls. The
   scan's bound lets a share of its exponentials run on the FP32 pipe
   (``exp_floor_s``). nvidia-smi samples the SM clock and power draw during
   the timed forwards and the timed kernel launches. Then the train path's
   scan kernels at its shapes (B=12, bf16, v1): the saving forward and the
   backward (both directions in one launch), each beside its plain version
   and its bound.
6. profile: one such forward, then one train step, under ``torch.profiler``:
   device time by kernel category (scan forward, scan backward, conv, matrix
   products, other), the top kernels, and the device's idle share of the
   wall time.

The line before the last is nvidia-smi's name and power limit; the one before
it the kernels summary; the last line is exactly
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time

import torch

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
FP32_PIPE_OPS_PER_S = FP32_FLOPS_PER_S / 2  # an FMA is two flops, one instruction
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


def conv_inputs(bsz, seqlen, d, k, dtype, seed, device="cuda"):
    g = torch.Generator().manual_seed(seed)
    xz = torch.randn((bsz, seqlen, 2 * d), generator=g).to(device=device, dtype=dtype)
    w = (torch.rand((d, k), generator=g) * 2 - 1).mul(0.5).to(device=device, dtype=dtype)
    b = (torch.rand((d,), generator=g) * 2 - 1).mul(0.5).to(device=device, dtype=dtype)
    return xz[..., :d], w, b


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
        ptxas[name] = [ln.strip() for ln in lines if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": seconds, "libraries": [p.name for p in paths.values()],
          "ptxas": ptxas})


GRAD_NAMES = ("du", "ddelta", "dA", "dB", "dC", "dD", "dz", "dbias")


def _scan_dirs(bsz, seqlen, d, dtype, shared):
    """Both directions' (u, dt, A, B, C, D, z) as the mixer passes them."""
    from aum_tpu_torch.ops.selective_scan import _prep_dt

    fwd = scan_inputs(bsz, seqlen, d, 16, dtype, seed=1)
    rev = fwd if shared else scan_inputs(bsz, seqlen, d, 16, dtype, seed=2)
    if shared:  # bimamba v1: same operands, its own A
        rev = (fwd[0], fwd[1], fwd[2] * 0.5) + fwd[3:]
    dt_f = _prep_dt(fwd[1], fwd[7])
    dt_r = dt_f if shared else _prep_dt(rev[1], rev[7])
    return ((fwd[0], dt_f) + fwd[2:7], (rev[0], dt_r) + rev[2:7])


def _check_scan(label, dims, dtype, shared, train: bool) -> list[dict]:
    """The eval forward, or (train) the saving forward and both forms of the
    backward, against their plain versions."""
    from aum_tpu_torch.ops.selective_scan import (
        selective_scan_bwd_cuda,
        selective_scan_bwd_plain,
        selective_scan_dual_cuda,
        selective_scan_dual_plain,
    )

    bsz, seqlen, d = dims
    tag = dict(shape=label, dims=[bsz, seqlen, d, 16], dtype=str(dtype),
               bimamba="v1" if shared else "v2")
    dir_f, dir_r = _scan_dirs(bsz, seqlen, d, dtype, shared)
    atol, rtol = SCAN_TOL[dtype]
    results = []
    if not train:
        got = selective_scan_dual_cuda(dir_f, dir_r)
        torch.cuda.synchronize()
        want = selective_scan_dual_plain(dir_f, dir_r)
        for direction, (y, w) in enumerate(zip(got, want)):
            results.append({**compare(y, w, atol, rtol), "kernel": "selective_scan_dual_fwd",
                            "direction": "reverse" if direction else "forward", **tag})
        return results
    got = selective_scan_dual_cuda(dir_f, dir_r, save_states=True)
    torch.cuda.synchronize()
    want = selective_scan_dual_plain(dir_f, dir_r, save_states=True)
    for i, (y, w) in enumerate(zip(got, want)):
        tol = (atol, rtol) if i < 2 else XB_TOL
        results.append({**compare(y, w, *tol), "kernel": "selective_scan_dual_fwd",
                        "save_states": True, "output": "out" if i < 2 else "xb",
                        "direction": "reverse" if i % 2 else "forward", **tag})
    xb_f, xb_r = got[2:]
    g = torch.Generator().manual_seed(5)
    gs = [torch.randn((bsz, seqlen, d), generator=g).to("cuda", dtype) for _ in range(2)]
    dirs = [dir_f + (False,), dir_r + (True,)]
    forms = {"two_directions": selective_scan_bwd_cuda(dirs, gs, [xb_f, xb_r]),
             "one_direction": [selective_scan_bwd_cuda([dirs[i]], [gs[i]], [xb])[0]
                               for i, xb in enumerate((xb_f, xb_r))]}
    torch.cuda.synchronize()
    want = selective_scan_bwd_plain(dirs, gs)
    for form, grads in forms.items():
        for direction, (gr, wr) in enumerate(zip(grads, want)):
            results.append({**_grad_checks(GRAD_NAMES, gr, wr, GRAD_TOL[dtype]),
                            "kernel": "selective_scan_bwd", "form": form,
                            "direction": "reverse" if direction else "forward", **tag})
    return results


def _grad_checks(names, got, want, tol) -> dict:
    """One line for a set of grads: each one's max abs and scaled error, the
    largest abs error over all of them, ok if each is within tol."""
    checks = {name: compare_scaled(g, w, tol) for name, g, w in zip(names, got, want)
              if w is not None}
    return {"max_abs_err": max(c["max_abs_err"] for c in checks.values()), "tol": tol,
            "grads": {k: [c["max_abs_err"], c["scaled_err"]] for k, c in checks.items()},
            "ok": all(c["ok"] for c in checks.values())}


def _check_conv(label, dims, dtype, train: bool) -> list[dict]:
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
            x, w, b = conv_inputs(bsz, seqlen, d, 4, dtype, seed=3)
            b = b if with_bias else None
            tag = dict(shape=label, dims=[bsz, seqlen, d, 4], dtype=str(dtype),
                       reverse=reverse, bias=with_bias, activation=act)
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


def phase_kernels() -> dict:
    """Every kernel against its plain version; returns the largest absolute
    error of each at the paths' shapes in bf16."""
    shapes = {"eval": ((8, 513, 1536), False), "train": ((12, 513, 1536), True),
              "ragged": ((2, 37, 40), None), "multi_chunk": ((2, 150, 40), None)}
    results = []
    for label, (dims, train) in shapes.items():
        for dtype in (torch.float32, torch.bfloat16):
            modes = (False, True) if train is None else (train,)
            for mode in modes:
                for shared in (True, False):
                    results += _check_scan(label, dims, dtype, shared, mode)
                results += _check_conv(label, dims, dtype, mode)
    worst = {}
    for r in results:
        emit({"phase": "kernels", **r})
        if r["shape"] in ("eval", "train") and r["dtype"] == str(torch.bfloat16):
            key = r["kernel"] + ("_save_states" if r.get("save_states") else "")
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

    fn, args = entry()
    torch.cuda.synchronize()
    _reset_counters()
    logits = fn(*args)
    torch.cuda.synchronize()
    launches = _read_counters()
    finite = bool(torch.isfinite(logits.float()).all())
    latency_ms = cuda_ms(lambda: fn(*args), iters=10)
    emit({"phase": "main_path", "entry": "aum_tpu_torch.entry.entry", "batch": 8,
          "logits_shape": list(logits.shape), "dtype": str(logits.dtype),
          "finite": finite, "launches": launches, "graph_built": logits.requires_grad,
          "ms_per_forward": latency_ms})
    depth = flagship_config().depth
    if tuple(logits.shape) != (8, 527) or not finite:
        raise RuntimeError("main path logits are not (8, 527) finite values")
    expected = {"selective_scan_dual_fwd": depth, "selective_scan_dual_fwd_save_states": 0,
                "selective_scan_bwd": 0, "causal_conv1d_fwd": depth}
    if launches != expected or logits.requires_grad:
        raise RuntimeError(f"expected {expected} launches and no graph, got {launches}")
    return launches


def _reset_counters() -> None:
    from aum_tpu_torch.ops import causal_conv1d, selective_scan_bwd, selective_scan_dual

    selective_scan_dual.launches = 0
    selective_scan_dual.save_states_launches = 0
    selective_scan_bwd.launches = 0
    causal_conv1d.launches = 0


def _read_counters() -> dict:
    from aum_tpu_torch.ops import causal_conv1d, selective_scan_bwd, selective_scan_dual

    return {"selective_scan_dual_fwd": selective_scan_dual.launches,
            "selective_scan_dual_fwd_save_states": selective_scan_dual.save_states_launches,
            "selective_scan_bwd": selective_scan_bwd.launches,
            "causal_conv1d_fwd": causal_conv1d.launches}


def phase_train() -> dict:
    import dataclasses

    from aum_tpu_torch.entry import (
        STEPS_PER_EPOCH,
        TRAIN_BATCH,
        TRAIN_HP,
        flagship_config,
        train_entry,
    )
    from aum_tpu_torch.models import AudioMamba
    from aum_tpu_torch.train import init_train_state, loss_fn_of, make_optimizer, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # fp32, full width, depth 2 (the CPU oracle's backward stays short): the
    # loss and grads of one forward and backward, then one full train step
    # without warmup (its lr is the schedule's 5e-5, not the warmup's 0).
    cfg = flagship_config(dtype="float32", depth=2, remat=True, remat_mode="split")
    hp = dataclasses.replace(TRAIN_HP, warmup=False)
    g = torch.Generator().manual_seed(8)
    x = torch.randn((2, 1024, 128), generator=g)
    y = torch.nn.functional.one_hot(torch.arange(2) % 527, 527).float()
    names = [f"layers.{i}.mixer.{k}" for i in range(cfg.depth)
             for k in ("in_proj.weight", "A_log", "A_b_log", "dt_proj.bias", "conv1d.weight")]
    runs = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        model = AudioMamba(cfg, device=device, seed=0)
        batch = {"x": x.to(device), "y": y.to(device)}
        loss = loss_fn_of("BCE")(model(batch["x"], train=True), batch["y"])
        loss.backward()
        params = dict(model.named_parameters())
        grads = {k: params[k].grad.cpu() for k in names}
        before = {k: params[k].detach().cpu().clone() for k in names}
        state = init_train_state(model, make_optimizer(model.parameters(), hp))
        make_train_step(hp, STEPS_PER_EPOCH, "BCE")(state, batch)
        after = {k: params[k].detach().cpu() for k in names}
        runs[device] = (loss.item(), grads, before, after, time.perf_counter() - t0)
    (loss_g, grads_g, _, after_g, s_g), (loss_c, grads_c, before_c, after_c, s_c) = (
        runs["cuda"], runs["cpu"])
    checks = {k: compare_scaled(grads_g[k], grads_c[k], TRAIN_FP32_TOL["grad"])
              for k in grads_c}
    updates = {}
    for k in names:
        err = (after_g[k] - after_c[k]).norm().item()
        moved = (after_c[k] - before_c[k]).norm().item()
        updates[k] = {"err_norm": err, "update_norm": moved,
                      "ok": moved > 0 and err <= TRAIN_FP32_TOL["update"] * moved}
    loss_ok = abs(loss_g - loss_c) <= TRAIN_FP32_TOL["loss_rtol"] * abs(loss_c)
    ok = (loss_ok and all(c["ok"] for c in checks.values())
          and all(u["ok"] for u in updates.values()))
    emit({"phase": "train_fp32_vs_cpu", "batch": 2, "depth": cfg.depth,
          "width": cfg.embed_dim, "loss_gpu": loss_g, "loss_cpu": loss_c,
          "loss_rtol": TRAIN_FP32_TOL["loss_rtol"], "grads": checks, "lr": hp.lr,
          "params_after_step": updates, "update_tol": TRAIN_FP32_TOL["update"],
          "gpu_s": s_g, "cpu_s": s_c, "ok": ok})
    if not ok:
        raise RuntimeError("fp32 train step on the card disagrees with the CPU plain path")

    step, state, batch = train_entry()
    depth = state.model.config.depth
    losses = []
    for i in range(3):
        torch.cuda.synchronize()
        if i == 1:
            _reset_counters()
        state, loss = step(state, batch)
        torch.cuda.synchronize()
        if i == 1:
            launches = _read_counters()
        losses.append(loss.item())
    expected = {"selective_scan_dual_fwd": depth, "selective_scan_dual_fwd_save_states": depth,
                "selective_scan_bwd": depth, "causal_conv1d_fwd": 4 * depth}
    finite = all(math.isfinite(v) for v in losses)
    torch.cuda.reset_peak_memory_stats()
    with sample_clocks({}) as card:
        step_ms = cuda_ms(lambda: step(state, batch), iters=5, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    out = {"phase": "train_path", "entry": "aum_tpu_torch.entry.train_entry",
           "batch": TRAIN_BATCH, "depth": depth, "dtype": "bfloat16", "remat_mode": "split",
           "losses": losses, "finite": finite, "launches_per_step": launches,
           "expected_launches": expected, "ms_per_step": step_ms,
           "clips_per_s": TRAIN_BATCH / (step_ms / 1e3), "peak_mem_bytes": peak,
           "card": card}
    emit(out)
    if not finite:
        raise RuntimeError(f"train path losses are not finite: {losses}")
    if launches != expected:
        raise RuntimeError(f"expected {expected} launches per train step, got {launches}")
    del step, state, batch
    return out


def phase_bench(device_info: dict) -> dict:
    from aum_tpu_torch.entry import flagship_config
    from aum_tpu_torch.models import AudioMamba
    from aum_tpu_torch.ops.conv1d import causal_conv1d_cuda, causal_conv1d_plain
    from aum_tpu_torch.ops.selective_scan import (
        _prep_dt,
        selective_scan_dual_cuda,
        selective_scan_dual_plain,
    )

    bsz, seqlen, d, n, k = 64, 513, 1536, 16, 4
    dtype = torch.bfloat16
    es = 2
    model = AudioMamba(flagship_config(), device="cuda", seed=0)
    x = torch.randn((bsz, 1024, 128), generator=torch.Generator().manual_seed(1)).cuda()
    torch.cuda.reset_peak_memory_stats()

    def forward():
        with torch.inference_mode():
            return model(x)

    with sample_clocks({}) as card:
        fwd_ms = cuda_ms(forward, iters=10, warmup=2)
    peak = torch.cuda.max_memory_allocated()
    del model
    emit({"phase": "bench", "batch": bsz, "dtype": "bfloat16", "ms_per_forward": fwd_ms,
          "clips_per_s": bsz / (fwd_ms / 1e3), "peak_mem_bytes": peak, "card": card})

    # Scan at the forward's shapes: v1, both directions on shared operands.
    u, delta, A, B, C, D, z, bias = scan_inputs(bsz, seqlen, d, n, dtype, seed=4)
    dt = _prep_dt(delta, bias)
    fwd = (u, dt, A, B, C, D, z)
    rev = (u, dt, A * 0.5, B, C, D, z)
    # Enough launches that the clock sampler sees the kernel alone (~0.6 s).
    with sample_clocks({}) as card:
        scan_ms = cuda_ms(lambda: selective_scan_dual_cuda(fwd, rev), iters=400)
    scan_plain_ms = cuda_ms(lambda: selective_scan_dual_plain(fwd, rev), iters=2, warmup=1)
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
    out = {"scan": {"ms": scan_ms, "plain_ms": scan_plain_ms, "bounds_ms": scan_bounds,
                    "other_floors_ms": scan_other},
           "conv": {"ms": conv_ms, "plain_ms": conv_plain_ms, "library_ms": conv_lib_ms,
                    "bounds_ms": conv_bounds}}
    emit({"phase": "bench_kernels", "dims": [bsz, seqlen, d, n], "dtype": "bfloat16", **out,
          "card": {"scan": card, "conv": card_conv}})
    del xc, w, b
    train = bench_train_kernels(sfu_rate)
    return {**out, **train}


def bench_train_kernels(sfu_rate: float) -> dict:
    """The train path's scan kernels at its shapes (v1, B=12, bf16): the
    saving forward, and the backward of both directions in one launch (the
    train path's form) and of the forward direction alone."""
    from aum_tpu_torch.ops.selective_scan import (
        STATE_CHUNK,
        selective_scan_bwd_cuda,
        selective_scan_bwd_plain,
        selective_scan_dual_cuda,
        selective_scan_dual_plain,
    )

    bsz, seqlen, d, n = 12, 513, 1536, 16
    dtype, es = torch.bfloat16, 2
    dir_f, dir_r = _scan_dirs(bsz, seqlen, d, dtype, shared=True)
    with sample_clocks({}) as card_save:
        save_ms = cuda_ms(lambda: selective_scan_dual_cuda(dir_f, dir_r, save_states=True),
                          iters=400)
    save_plain_ms = cuda_ms(lambda: selective_scan_dual_plain(dir_f, dir_r, save_states=True),
                            iters=1, warmup=1)
    _, _, xb_f, xb_r = selective_scan_dual_cuda(dir_f, dir_r, save_states=True)
    g = torch.Generator().manual_seed(9)
    gs = [torch.randn((bsz, seqlen, d), generator=g).to("cuda", dtype) for _ in range(2)]
    dirs = [dir_f + (False,), dir_r + (True,)]
    with sample_clocks({}) as card_bwd:
        bwd_ms = cuda_ms(lambda: selective_scan_bwd_cuda(dirs, gs, [xb_f, xb_r]), iters=100)
    bwd_plain_ms = cuda_ms(lambda: selective_scan_bwd_plain(dirs, gs), iters=1, warmup=1)
    bwd1_ms = cuda_ms(lambda: selective_scan_bwd_cuda(dirs[:1], gs[:1], [xb_f]), iters=100)
    bwd1_plain_ms = cuda_ms(lambda: selective_scan_bwd_plain(dirs[:1], gs[:1]),
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

    out = {"scan_save": {"ms": save_ms, "plain_ms": save_plain_ms, "bounds_ms": save_bounds},
           "scan_bwd": {"ms": bwd_ms, "plain_ms": bwd_plain_ms, "bounds_ms": bwd_bounds(2),
                        "other_floors_ms": {"sfu_only": 2 * elems / sfu_rate * 1e3,
                                            "fp32_pipe_only": SCAN_BWD_FP32_OPS_PER_ELEMENT
                                            * 2 * elems / FP32_PIPE_OPS_PER_S * 1e3}},
           "scan_bwd_one_direction": {"ms": bwd1_ms, "plain_ms": bwd1_plain_ms,
                                      "bounds_ms": bwd_bounds(1)}}
    emit({"phase": "bench_train_kernels", "dims": [bsz, seqlen, d, n], "dtype": "bfloat16",
          "bimamba": "v1", **out, "card": {"scan_save": card_save, "scan_bwd": card_bwd}})
    return out


def _kernel_category(name: str) -> str:
    low = name.lower()
    if "scan_bwd_kernel" in low:
        return "scan_bwd_kernel"
    if "scan_dual_fwd_kernel" in low:
        return "scan_fwd_kernel"
    if "conv1d_fwd_kernel" in low:
        return "conv_kernel"
    if any(s in low for s in ("gemm", "nvjet", "cutlass", "xmma")):
        return "matmul"
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
    """One bench forward (B=64), then one train step of the train path."""
    from aum_tpu_torch.entry import TRAIN_BATCH, flagship_config, train_entry
    from aum_tpu_torch.models import AudioMamba

    model = AudioMamba(flagship_config(), device="cuda", seed=0)
    x = torch.randn((64, 1024, 128), generator=torch.Generator().manual_seed(1)).cuda()

    def forward():
        with torch.inference_mode():
            model(x)

    forward()
    out = {"eval": _profile("profile", forward, batch=64, dtype="bfloat16")}
    del model, x
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
    device_info = phase_device()
    phase_build()
    worst = phase_kernels()
    eval_launches = phase_model()
    train = phase_train()
    train_launches = train["launches_per_step"]
    bench = phase_bench(device_info)
    phase_profile()
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
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
                                "train": train_launches["selective_scan_dual_fwd"]}
    bwd = _kernel_entry(
        "selective_scan_bwd", "aum_tpu_torch/csrc/selective_scan_bwd.cu",
        "aum_tpu/ops/selective_scan.py:392", train_launches["selective_scan_bwd"],
        worst["selective_scan_bwd"], bench["scan_bwd"])
    bwd["also_replaces"] = "aum_tpu/ops/selective_scan.py:822 (both directions in one launch)"
    bwd["launches_by_path"] = {"eval": 0, "train": train_launches["selective_scan_bwd"]}
    # The same kernel on one direction, the form of _bwd_kernel; no path
    # launches it (the train path takes both directions at once).
    bwd["one_direction"] = _kernel_entry(
        "selective_scan_bwd", bwd["source"], bwd["replaces"], 0, worst["selective_scan_bwd"],
        bench["scan_bwd_one_direction"])
    conv = _kernel_entry(
        "causal_conv1d_fwd", "aum_tpu_torch/csrc/conv1d.cu", "aum_tpu/ops/conv1d.py:107",
        eval_launches["causal_conv1d_fwd"], worst["causal_conv1d_fwd"], bench["conv"],
        library_ms=bench["conv"]["library_ms"])
    conv["launches_by_path"] = {"eval": eval_launches["causal_conv1d_fwd"],
                                "train": train_launches["causal_conv1d_fwd"]}
    emit({"kernels": [scan, bwd, conv]})
    print(smi("name,power.limit"), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
