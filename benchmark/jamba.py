"""Jamba cells: the shapes and FLOPs of a prefill call, the port's model with
the seed's weights drawn on the card leaf by leaf, the reference on the same
weights and inputs, and what the per-layer metrics read.

Weights. Each parameter (by its HF key) has a generator of its own on the
card, seeded from the run's seed and the key (``leaf_seed``): one uniform
draw in [-1, 1) of the leaf's shape, the first matching rule of the
configuration's ``weights`` list applied in fp32 (``weights._leaf``), then
held in the program's dtype (the configuration's ``dtype``; fp32 for
``A_log``, ``D`` and the dt bias, as the program holds them). The weights in
that dtype are the model, as AI21 releases it in bf16, so the reference
redraws one layer's leaves at a time, rounds them the same way and computes
in fp32 from there. No leaf is ever drawn whole on the host, and no draw
spans the model (the flat fp32 draw of ``weights.draw`` would be 104 GB here).

The port is reached only through its public entry points:
``aum_tpu_torch.models.jamba`` (``JambaConfig.from_hf``, ``JambaLM``) and
``aum_tpu_torch.models.lm.prefill``.
"""

from __future__ import annotations

import math
import re
import zlib

import torch

from benchmark import roofline, weights
from benchmark.reference import jamba as ref_jamba
from benchmark.reference.precision import rounding, set_exact_fp32

# The parameters the program holds in fp32 whatever its dtype (by key suffix).
FP32_SUFFIXES = (".A_log", ".D", ".dt_proj.bias")


def leaf_seed(seed: int, key: str) -> int:
    return (seed * 1_000_003 + zlib.crc32(key.encode())) % (2 ** 63)


def held_dtype(config: dict, key: str) -> torch.dtype:
    return torch.float32 if key.endswith(FP32_SUFFIXES) else getattr(torch, config["dtype"])


def draw_leaf(config: dict, key: str, shape: tuple, seed: int, device) -> torch.Tensor:
    """The leaf ``key`` of the seed's weights in the dtype the program holds."""
    rule = next((r for r in config["weights"] if re.fullmatch(r["match"], key)), None)
    if rule is None:
        raise KeyError(f"no weight rule matches {key!r}")
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, key))
    u = torch.rand(shape, generator=gen, device=device).mul_(2).sub_(1)
    return weights._leaf(rule, u).to(held_dtype(config, key))


def build_program(config: dict, seed: int, device):
    """The port's JambaLM of ``config`` on ``device``, each parameter
    overwritten with the seed's leaf as it is drawn."""
    from aum_tpu_torch.models.jamba import JambaConfig, JambaLM

    model = JambaLM(JambaConfig.from_hf(config, dtype=config["dtype"]), device=device)
    with torch.no_grad():
        for key, p in model.named_parameters():
            p.copy_(draw_leaf(config, key, tuple(p.shape), seed, device))
    return model


def param_count(config: dict) -> int:
    return sum(math.prod(shape) for shape in ref_jamba.param_shapes(config).values())


def forward_flops_per_call(config: dict, batch: int, seqlen: int) -> float:
    """A prefill call's FLOPs: every product (the MoE's for its top-k experts
    per token, the head for the last position only), the causal attention
    core (QK^T and PV over the causal half, 2 * 2 * heads * head_dim * L^2 /
    2), the conv and the scan; norms, softmaxes and other elementwise work
    are not counted."""
    d, f, n = config["hidden_size"], config["intermediate_size"], config["mamba_d_state"]
    di, r, k = config["mamba_expand"] * d, ref_jamba.dt_rank(config), config["mamba_d_conv"]
    kv = config["num_key_value_heads"] * d // config["num_attention_heads"]
    tokens = batch * seqlen
    total = 2.0 * batch * d * config["vocab_size"]
    for mixer, ffn in ref_jamba.layer_kinds(config):
        if mixer == "mamba":
            total += 2 * tokens * (d * 2 * di + di * (r + 2 * n) + r * di + di * d)
            total += 2 * k * tokens * di + roofline.SCAN_FLOPS_PER_ELEMENT * tokens * di * n
        else:
            total += 2 * tokens * d * (2 * d + 2 * kv) + attention_core_flops(config, batch, seqlen)
        swiglu = 2 * tokens * 3 * d * f
        if ffn == "moe":
            total += 2 * tokens * d * config["num_experts"]
            total += config["num_experts_per_tok"] * swiglu
        else:
            total += swiglu
    return total


def attention_core_flops(config: dict, batch: int, seqlen: int) -> float:
    """One attention layer's causal core: QK^T and PV on the causal half."""
    return 2.0 * batch * config["hidden_size"] * seqlen * seqlen


def reference_last_logits(config: dict, seed: int, ids: torch.Tensor, device,
                          precision: str = "fp32", routes=None, margin: float = 0.0):
    """The reference's last-position fp32 logits (Bt, vocab) of ``ids`` (Bt,
    L) on the CPU, and its routing stats (``reference.jamba.logits``)."""
    set_exact_fp32()
    shapes = ref_jamba.param_shapes(config)

    def get(keys):
        return {k: draw_leaf(config, k, shapes[k], seed, device).float() for k in keys}

    with torch.no_grad():
        logits, stats = ref_jamba.logits(get, config, ids.to(device), rounding(precision),
                                         routes=routes, margin=margin, last_only=True)
    return logits.cpu(), stats


# --- what the per-layer metrics read from a traced stretch ----------------------


def _call_shape(view):
    tr = view.cell["traffic_spec"]
    return tr["batch"], tr["seqlen"]


def mfu_pct(view):
    """The prefill's FLOPs (``forward_flops_per_call``) for the stretch's
    calls over its seconds, over the dense bf16 peak, in percent."""
    if view.window_s <= 0 or not view.device_ops:
        return None
    flops = forward_flops_per_call(view.cell["config_spec"], *_call_shape(view)) * view.calls
    return 100.0 * flops / view.window_s / roofline.BF16_TENSOR_FLOPS_PER_S


def elementwise_ms_per_clip(view):
    """Device ms per clip of the kernels that are neither the port's, a
    library's, nor SDPA's attention (``metrics/kernels/attention/``): the
    routing (softmax, top-k, the count, sort, gathers), the norms (the dt/B/C
    norms among them), SwiGLU's gate and the casts."""
    if not view.clips:
        return None
    named = {id(k) for g in ("port", "library", "attention") for k in view.matching(g)}
    return sum(k[2] for k in view.kernels if id(k) not in named) / 1e3 / view.clips


def scan_roofline_pct(view):
    """The single-direction scan forward's least time at the cell's shapes
    (one scan per Mamba layer per call) over the device time of the kernels
    in ``metrics/kernels/scan_fwd_single/``, in percent."""
    kernels = view.matching("scan_fwd_single")
    if not kernels:
        return None
    cfg = view.cell["config_spec"]
    batch, seqlen = _call_shape(view)
    layers = sum(m == "mamba" for m, _ in ref_jamba.layer_kinds(cfg))
    bound = roofline.scan_fwd_single_s(batch, seqlen, cfg["mamba_expand"] * cfg["hidden_size"],
                                       cfg["mamba_d_state"], 2)
    return 100.0 * bound * layers * view.calls / (sum(k[2] for k in kernels) / 1e6)


def attention_roofline_pct(view):
    """The attention layers' causal core at the dense bf16 peak over the
    device time of SDPA's kernels (``metrics/kernels/attention/``), in
    percent."""
    kernels = view.matching("attention")
    if not kernels:
        return None
    cfg = view.cell["config_spec"]
    layers = sum(m == "attention" for m, _ in ref_jamba.layer_kinds(cfg))
    bound = attention_core_flops(cfg, *_call_shape(view)) / roofline.BF16_TENSOR_FLOPS_PER_S
    return 100.0 * bound * layers * view.calls / (sum(k[2] for k in kernels) / 1e6)
