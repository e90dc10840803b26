#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``aum_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py

Phases (each prints JSON lines; any failure raises and the exit code is not 0):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; build: nvcc compiles every kernel from ``aum_tpu_torch/csrc/``
   (all sources at once) and the build time is printed.
2. kernels: each kernel against its plain PyTorch version on the card, at the
   main path's shapes (B=8, L=513, D=1536, N=16, strided operands as the model
   passes them) and at ragged shapes (L=37, D=40), in fp32 and bf16, both scan
   directions, conv causal and anti-causal.
3. model: AuM-Base Fo-Bi at full width and depth 24. fp32, B=2: the card
   (with kernels) against the same weights on the CPU (plain path). Then the
   main path itself, ``aum_tpu_torch.entry.entry()`` (bf16, B=8), with every
   launch counter set to 0 just before and read just after: it must show 24
   scan and 24 conv launches, and (8, 527) finite logits; then its latency
   (CUDA events, 10 forwards after warm-up).
4. bench: the ``bench.py`` workload (B=64 x 1024 x 128, bf16): clips/s with
   CUDA events after warm-up, then per kernel at the shapes that forward gives
   it: ms per launch, the plain version's ms, the least time the card could
   take (bound), and for the conv one PyTorch call computing the same function
   (``F.conv1d(groups=D)`` + SiLU) as a yardstick the port never calls. The
   scan's bound lets a share of its exponentials run on the FP32 pipe
   (``exp_floor_s``). nvidia-smi samples the SM clock and power draw during
   the timed forwards and the timed kernel launches.
5. profile: one such forward under ``torch.profiler``: device time by kernel
   category (scan, conv, matrix products, other), the top kernels, and the
   device's idle share of the forward's wall time.

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

SCAN_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}  # (atol, rtol)
CONV_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 1e-2)}
MODEL_FP32_TOL = (2e-3, 2e-3)


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


def phase_kernels() -> dict:
    from aum_tpu_torch.ops.conv1d import causal_conv1d_cuda, causal_conv1d_plain
    from aum_tpu_torch.ops.selective_scan import (
        _prep_dt,
        selective_scan_dual_cuda,
        selective_scan_dual_plain,
    )

    results, worst = [], {"scan": 0.0, "conv": 0.0}
    shapes = {"main": (8, 513, 1536), "ragged": (2, 37, 40)}
    for label, (bsz, seqlen, d) in shapes.items():
        for dtype in (torch.float32, torch.bfloat16):
            atol, rtol = SCAN_TOL[dtype]
            for shared in (True, False):
                fwd = scan_inputs(bsz, seqlen, d, 16, dtype, seed=1)
                rev = fwd if shared else scan_inputs(bsz, seqlen, d, 16, dtype, seed=2)
                if shared:  # bimamba v1: same operands, its own A
                    rev = (fwd[0], fwd[1], fwd[2] * 0.5) + fwd[3:]
                dirs = []
                for args in (fwd, rev):
                    u, delta, A, B, C, D, z, bias = args
                    dirs.append((u, _prep_dt(delta, bias), A, B, C, D, z))
                got = selective_scan_dual_cuda(dirs[0], dirs[1])
                torch.cuda.synchronize()
                want = selective_scan_dual_plain(dirs[0], dirs[1])
                for direction, (y, w) in enumerate(zip(got, want)):
                    r = compare(y, w, atol, rtol)
                    r.update(kernel="selective_scan_dual_fwd", shape=label,
                             dims=[bsz, seqlen, d, 16], dtype=str(dtype),
                             bimamba="v1" if shared else "v2",
                             direction="reverse" if direction else "forward")
                    results.append(r)
                    if label == "main" and dtype == torch.bfloat16:
                        worst["scan"] = max(worst["scan"], r["max_abs_err"])
            atol, rtol = CONV_TOL[dtype]
            for reverse in (False, True):
                for with_bias, act in ((True, "silu"), (False, None)):
                    x, w, b = conv_inputs(bsz, seqlen, d, 4, dtype, seed=3)
                    b = b if with_bias else None
                    got = causal_conv1d_cuda(x, w, b, act, reverse)
                    torch.cuda.synchronize()
                    r = compare(got, causal_conv1d_plain(x, w, b, act, reverse), atol, rtol)
                    r.update(kernel="causal_conv1d_fwd", shape=label,
                             dims=[bsz, seqlen, d, 4], dtype=str(dtype), reverse=reverse,
                             bias=with_bias, activation=act)
                    results.append(r)
                    if label == "main" and dtype == torch.bfloat16:
                        worst["conv"] = max(worst["conv"], r["max_abs_err"])
    for r in results:
        emit({"phase": "kernels", **r})
    failed = [r for r in results if not r["ok"]]
    if failed:
        raise RuntimeError(f"{len(failed)} kernel checks disagree with the plain version")
    return worst


def phase_model() -> dict:
    from aum_tpu_torch.entry import entry, flagship_config
    from aum_tpu_torch.models import AudioMamba
    from aum_tpu_torch.ops import causal_conv1d, selective_scan_dual

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = flagship_config(dtype="float32")
    x = torch.randn((2, 1024, 128), generator=torch.Generator().manual_seed(7))
    t0 = time.perf_counter()
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
    selective_scan_dual.launches = 0
    causal_conv1d.launches = 0
    logits = fn(*args)
    torch.cuda.synchronize()
    launches = {"selective_scan_dual_fwd": selective_scan_dual.launches,
                "causal_conv1d_fwd": causal_conv1d.launches}
    finite = bool(torch.isfinite(logits.float()).all())
    latency_ms = cuda_ms(lambda: fn(*args), iters=10)
    emit({"phase": "main_path", "entry": "aum_tpu_torch.entry.entry", "batch": 8,
          "logits_shape": list(logits.shape), "dtype": str(logits.dtype),
          "finite": finite, "launches": launches, "ms_per_forward": latency_ms})
    depth = flagship_config().depth
    if tuple(logits.shape) != (8, 527) or not finite:
        raise RuntimeError("main path logits are not (8, 527) finite values")
    if launches != {"selective_scan_dual_fwd": depth, "causal_conv1d_fwd": depth}:
        raise RuntimeError(f"expected {depth} launches of each kernel, got {launches}")
    return launches


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
    with sample_clocks({}) as card:
        fwd_ms = cuda_ms(lambda: model(x), iters=10, warmup=2)
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
    return out


def _kernel_category(name: str) -> str:
    low = name.lower()
    if "scan_dual_fwd_kernel" in low:
        return "scan_kernel"
    if "conv1d_fwd_kernel" in low:
        return "conv_kernel"
    if any(s in low for s in ("gemm", "nvjet", "cutlass", "xmma")):
        return "matmul"
    return "other"


def phase_profile() -> dict:
    """One bench forward under torch.profiler: device time by kernel category,
    device busy time against the forward's wall time (the idle share)."""
    from torch.profiler import ProfilerActivity, profile

    from aum_tpu_torch.entry import flagship_config
    from aum_tpu_torch.models import AudioMamba

    model = AudioMamba(flagship_config(), device="cuda", seed=0)
    x = torch.randn((64, 1024, 128), generator=torch.Generator().manual_seed(1)).cuda()
    model(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model(x)
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
    out = {"phase": "profile", "batch": 64, "dtype": "bfloat16", "wall_ms": wall_ms,
           "kernels_traced": len(kernels), "device_busy_ms": busy_us / 1e3,
           "idle_share": 1.0 - busy_us / 1e3 / wall_ms if kernels else None,
           "by_category_ms": by_cat,
           "top_kernels": [[name[:90], ms, n] for name, (ms, n) in top]}
    emit(out)
    return out


def _bound(bounds: dict) -> tuple[float, str]:
    key = max(bounds, key=bounds.get)
    return bounds[key], "bytes" if key == "bytes" else "operations"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import aum_tpu_torch  # noqa: F401  (fails here, before any output, outside a checkout)

    t0 = time.perf_counter()
    device_info = phase_device()
    phase_build()
    worst = phase_kernels()
    launches = phase_model()
    bench = phase_bench(device_info)
    phase_profile()
    scan_bound, scan_by = _bound(bench["scan"]["bounds_ms"])
    conv_bound, conv_by = _bound(bench["conv"]["bounds_ms"])
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    emit({"kernels": [
        {"name": "selective_scan_dual_fwd", "route": "cuda",
         "source": "aum_tpu_torch/csrc/selective_scan.cu",
         "replaces": "aum_tpu/ops/selective_scan.py:1648",
         "launches": launches["selective_scan_dual_fwd"], "max_abs_err": worst["scan"],
         "ms": bench["scan"]["ms"], "plain_ms": bench["scan"]["plain_ms"],
         "bound_ms": scan_bound, "bound_by": scan_by, "library_ms": None},
        {"name": "causal_conv1d_fwd", "route": "cuda",
         "source": "aum_tpu_torch/csrc/conv1d.cu",
         "replaces": "aum_tpu/ops/conv1d.py:107",
         "launches": launches["causal_conv1d_fwd"], "max_abs_err": worst["conv"],
         "ms": bench["conv"]["ms"], "plain_ms": bench["conv"]["plain_ms"],
         "bound_ms": conv_bound, "bound_by": conv_by,
         "library_ms": bench["conv"]["library_ms"]},
    ]})
    print(smi("name,power.limit"), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
