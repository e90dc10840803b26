"""Published peaks of one NVIDIA H100 SXM, and the work of the ops the
per-layer metrics read: their least time on the card, and the model's FLOPs
per clip.

A bound counts the work the op needs, whatever implements it: each input
byte read once and each output byte written once, and the fewest FP32-pipe
instructions and exponentials the arithmetic takes. A later kernel is read
against the same work. The counts are copies of ``chip_smoke.py``'s
``_single_bounds``, ``_bwd_bounds``, the dual forward's ``scan_bounds`` and
``exp_floor_s``.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet (dense rates, 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_TENSOR_FLOPS_PER_S = 989e12
FP32_PIPE_OPS_PER_S = FP32_FLOPS_PER_S / 2  # an FMA is two flops, one instruction
# 132 SMs at the 1980 MHz boost clock (the data sheet), 16 exponentials per SM
# per clock (CUDA C++ Programming Guide, arithmetic instruction throughput,
# compute capability 9.0).
SMS = 132
SM_CLOCK_HZ = 1.98e9
SFU_PER_SM_PER_CLOCK = 16
SFU_EXP_PER_S = SMS * SFU_PER_SM_PER_CLOCK * SM_CLOCK_HZ

# The scan forward's FP32-pipe instructions per (b, l, d, n) element and
# direction: dt*A and dt*u*B (two multiplies), the state update and the C
# readout (two FMAs); six flops.
SCAN_FP32_OPS_PER_ELEMENT = 4
SCAN_FLOPS_PER_ELEMENT = 6
# The backward's, each counted once: dt*A for the exponential, the state
# recompute (a multiply, an FMA), the y readout, lam, a*lam, its product with
# x_{t-1}, dA and sum_n lam*a*x_{t-1}*A, sum_n lam*B, dB and dC.
SCAN_BWD_FP32_OPS_PER_ELEMENT = 12
# An exponential emulated on the FP32 pipe: range reduction (3 adds) and a
# degree-3 polynomial (3 FMAs).
FP32_OPS_PER_EMULATED_EXP = 6
# The interval of the states the forward saves for the backward.
STATE_CHUNK = 64


def exp_floor_s(exps: float, fp32_ops: float) -> float:
    """Least time for ``exps`` exponentials beside ``fp32_ops`` FP32-pipe
    instructions, when any share of the exponentials may run as polynomials
    on the FP32 pipe instead of the SFUs."""
    p = FP32_OPS_PER_EMULATED_EXP
    split = (p * exps + fp32_ops) / (FP32_PIPE_OPS_PER_S + p * SFU_EXP_PER_S)
    return max(fp32_ops / FP32_PIPE_OPS_PER_S, min(exps / SFU_EXP_PER_S, split))


def scan_fwd_single_s(bsz, seqlen, d, n, es) -> float:
    """One direction's scan forward: u, dt, z, B, C, A, D read once, out
    written once."""
    elems = bsz * seqlen * d * n
    nbytes = (4 * bsz * seqlen * d + 2 * bsz * seqlen * n) * es + (n + 1) * d * 4
    return max(nbytes / HBM_BYTES_PER_S,
               exp_floor_s(elems, SCAN_FP32_OPS_PER_ELEMENT * elems))


def scan_fwd_dual_s(bsz, seqlen, d, n, es) -> float:
    """Both directions' forward on shared operands (bimamba v1): u, dt, z, B,
    C read once, both outputs written once, both A and the shared D."""
    bld, bln = bsz * seqlen * d, bsz * seqlen * n
    elems = 2 * bld * n
    nbytes = (3 * bld + 2 * bln) * es + 2 * bld * es + 2 * d * n * 4 + d * 4
    return max(nbytes / HBM_BYTES_PER_S,
               exp_floor_s(elems, SCAN_FP32_OPS_PER_ELEMENT * elems))


def scan_bwd_s(bsz, seqlen, d, n, es, ndir: int) -> float:
    """The scan backward of ``ndir`` directions: u, dt, z, B, C read once, and
    per direction its cotangent, saved states, A and D; per direction du,
    ddelta, dz, dB, dC and the fp32 dA, dD, dbias written once."""
    bld, bln = bsz * seqlen * d, bsz * seqlen * n
    xb_bytes = bsz * math.ceil(seqlen / STATE_CHUNK) * n * d * 4
    elems = bld * n
    nbytes = ((3 * bld + 2 * bln) * es + ndir * (bld * es + xb_bytes + (n + 1) * d * 4
              + (3 * bld + 2 * bln) * es + (n + 2) * d * 4))
    return max(nbytes / HBM_BYTES_PER_S,
               exp_floor_s(ndir * elems, SCAN_BWD_FP32_OPS_PER_ELEMENT * ndir * elems))


def aum_shapes(model: dict) -> dict:
    """The mixer's sizes from a configuration's ``model`` section."""
    f, t = model["spectrogram_size"]
    (ph, pw), (sh, sw) = model["patch_size"], model["strides"]
    patches = ((f - ph) // sh + 1) * ((t - pw) // sw + 1)
    d = model["embed_dim"]
    return {"d_model": d, "d_inner": 2 * d, "d_state": model["d_state"],
            "dt_rank": math.ceil(d / 16), "d_conv": model.get("d_conv", 4),
            "patches": patches, "tokens": patches + 1, "patch_area": ph * pw,
            "depth": model["depth"], "classes": model["num_classes"],
            "directions": 1 if model["bimamba_type"] == "none" else 2}


def aum_forward_flops_per_clip(model: dict) -> float:
    """The forward's FLOPs for one clip: the products (patch embedding,
    in_proj, x_proj, dt_proj, out_proj, head), the conv and the scan; the
    norms and the other elementwise work are not counted."""
    s = aum_shapes(model)
    L, d, di, n, r = s["tokens"], s["d_model"], s["d_inner"], s["d_state"], s["dt_rank"]
    layer = 2 * L * (d * 2 * di + di * (r + 2 * n) + r * di + di * d)
    layer += 2 * s["d_conv"] * L * di
    layer += s["directions"] * SCAN_FLOPS_PER_ELEMENT * L * di * n
    return s["depth"] * layer + 2 * s["patches"] * s["patch_area"] * d + 2 * d * s["classes"]
