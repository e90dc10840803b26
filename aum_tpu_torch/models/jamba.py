"""Jamba: Mamba-1 layers with dt/B/C norms, GQA attention layers and a top-k
mixture of experts, on the LM path of ``models/lm.py``.

Follows ``transformers``' ``models/jamba/modeling_jamba.py`` (4.57) for the
configurations AI21 publishes (``model_type: "jamba"``), with its module tree
and state-dict keys (``model.embed_tokens``, ``model.layers.{i}.mamba.*`` or
``.self_attn.{q,k,v,o}_proj``, ``.feed_forward.{gate,up,down}_proj`` or
``.feed_forward.router`` and ``.experts.{e}.*``, ``input_layernorm``,
``pre_ff_layernorm``, ``model.final_layernorm``, ``lm_head``), so a released
checkpoint loads with ``strict=True``:

- layer i: x += mixer(RMSNorm(x)), then x += ffn(RMSNorm(x)). The mixer is
  attention where ``i % attn_layer_period == attn_layer_offset``, else
  Mamba; the ffn is the MoE where ``i % expert_layer_period ==
  expert_layer_offset`` (and ``num_experts > 1``), else a dense SwiGLU MLP
  (``JambaConfig.layers_block_type`` / ``layers_num_experts``, as HF's).
  ``final_layernorm`` and ``lm_head`` (or the tied embedding) follow;
- the Mamba mixer is ``models/mamba.py``'s Fo-Fo ``MambaMixer`` with the
  dt/B/C RMSNorms on (``bcdt_norms``): the conv kernel and the
  single-direction scan kernel on the card;
- attention: GQA through ``F.scaled_dot_product_attention``, causal, scale
  1/sqrt(head_dim), no positional encoding, K/V repeated over the query
  groups as HF's ``repeat_kv``. On the card only SDPA's fused backends may
  run it (flash, cuDNN, memory-efficient): the math backend's (heads, L, L)
  scores at 32k tokens would need 68 GB;
- MoE: the router's product, its softmax in fp32, top-k, the weights not
  renormalised (HF's ``JambaSparseMoeBlock``). The (token, slot) choices are
  sorted by expert (a stable argsort), their counts (a scatter-add) are
  read on the host once, the layer's one sync, to cut the sorted rows into
  each expert's block, and each expert runs its three cuBLAS products on its
  block. The outputs go back to (token, slot) order and are weighted and
  summed over the slots: no atomics, so the result is deterministic.

Precision: parameters are held in ``config.dtype`` (bf16 as released) but
for ``A_log``, ``D`` and the dt bias (fp32); products, the conv and the scan
streams run in that dtype; the residual stream and the norms' arithmetic are
fp32 (``ops.fused_add_norm``), as are the router's softmax and the SSM
state. ``JambaLM`` is built on the meta device and then each parameter is
made on its device in its dtype, so nothing is drawn on the host at full size.

Instruments: ``profiling.annotate`` ranges ``jamba.mamba``,
``jamba.attention``, ``jamba.moe`` and ``jamba.mlp`` around each sublayer; a
routing counter on the device, tokens per expert per MoE layer summed from
those counts (``routing_counts`` / ``reset_routing_counts``, neither syncs);
and, once switched on by ``record_routes``, each MoE layer's
choices of every call (``take_routes``), which a check against a reference
needs where the router nearly ties.

The hybrid cache of ``prefill`` / ``decode_step``: ``conv`` and ``ssm``, one
(B, d_inner, d_conv) and one (B, d_inner, d_state) fp32 tensor per Mamba
layer, and ``key`` and ``value``, one (B, num_key_value_heads, L, head_dim)
tensor per attention layer, each a list in layer order.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import json
import math
import os

import torch
import torch.nn.functional as F
from torch import nn

from aum_tpu_torch.models.mamba import MambaMixer, _Weights
from aum_tpu_torch.ops import fused_add_norm
from aum_tpu_torch.train.profiling import annotate
from aum_tpu_torch.utils import resolve_device

# The parameters held in fp32 whatever the model's dtype, by key suffix.
FP32_SUFFIXES = (".A_log", ".D", ".dt_proj.bias")


@dataclasses.dataclass(frozen=True)
class JambaConfig:
    """HF's ``JambaConfig`` keys that fix the shapes and the math; defaults
    are AI21-Jamba2-Mini's published values. ``dtype`` is the dtype the
    parameters are held and computed in."""

    vocab_size: int = 65536
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    hidden_act: str = "silu"
    rms_norm_eps: float = 1e-6
    num_experts_per_tok: int = 2
    num_experts: int = 16
    expert_layer_period: int = 2
    expert_layer_offset: int = 1
    attn_layer_period: int = 8
    attn_layer_offset: int = 4
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int | str = "auto"
    mamba_conv_bias: bool = True
    mamba_proj_bias: bool = False
    tie_word_embeddings: bool = False
    sliding_window: int | None = None
    initializer_range: float = 0.02
    dtype: str = "bfloat16"

    def __post_init__(self):
        for kind in ("attn", "expert"):
            if getattr(self, f"{kind}_layer_offset") >= getattr(self, f"{kind}_layer_period"):
                raise ValueError(f"{kind}_layer_offset must be below {kind}_layer_period")
        unsupported = {"hidden_act": (self.hidden_act, "silu"),
                       "mamba_proj_bias": (self.mamba_proj_bias, False),
                       "mamba_conv_bias": (self.mamba_conv_bias, True),
                       "sliding_window": (self.sliding_window, None)}
        for key, (got, want) in unsupported.items():
            if got != want:
                raise NotImplementedError(f"{key}={got!r}: only {want!r} is supported")
        if self.hidden_size % self.num_attention_heads or (
                self.num_attention_heads % self.num_key_value_heads):
            raise ValueError("hidden_size, num_attention_heads and num_key_value_heads "
                             "must divide evenly")

    @classmethod
    def from_hf(cls, raw: dict, dtype: str | None = None) -> "JambaConfig":
        """The keys of an HF ``config.json`` that this class has (the others
        are ignored); ``dtype`` defaults to its ``torch_dtype``, else bf16."""
        names = {f.name for f in dataclasses.fields(cls)} - {"dtype"}
        return cls(**{k: v for k, v in raw.items() if k in names},
                   dtype=dtype or raw.get("torch_dtype") or "bfloat16")

    @property
    def dt_rank(self) -> int:
        if self.mamba_dt_rank == "auto":
            return math.ceil(self.hidden_size / 16)
        return int(self.mamba_dt_rank)

    @property
    def d_inner(self) -> int:
        return self.mamba_expand * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def layers_block_type(self) -> list:
        return ["attention" if i % self.attn_layer_period == self.attn_layer_offset else "mamba"
                for i in range(self.num_hidden_layers)]

    @property
    def layers_num_experts(self) -> list:
        return [self.num_experts if i % self.expert_layer_period == self.expert_layer_offset
                else 1 for i in range(self.num_hidden_layers)]

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def _linear(w: _Weights, x: torch.Tensor) -> torch.Tensor:
    return x @ w.weight.to(x.dtype).t()


class JambaMLP(nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x)); one dense layer or one expert."""

    def __init__(self, cfg: JambaConfig):
        super().__init__()
        d, f = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = _Weights((f, d))
        self.up_proj = _Weights((f, d))
        self.down_proj = _Weights((d, f))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.silu(_linear(self.gate_proj, x)) * _linear(self.up_proj, x)
        return _linear(self.down_proj, h)


class JambaSparseMoeBlock(nn.Module):
    """The top-k MoE (see the module docstring for the order of its work)."""

    def __init__(self, cfg: JambaConfig):
        super().__init__()
        self.top_k = cfg.num_experts_per_tok
        self.router = _Weights((cfg.num_experts, cfg.hidden_size))
        self.experts = nn.ModuleList(JambaMLP(cfg) for _ in range(cfg.num_experts))
        self.register_buffer("expert_tokens", torch.zeros(cfg.num_experts, dtype=torch.long),
                             persistent=False)
        self.routes = None  # a list while ``JambaLM.record_routes`` is on

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape, k = x.shape, self.top_k
        x = x.reshape(-1, shape[-1])
        probs = torch.softmax(_linear(self.router, x).float(), dim=-1)
        weights, chosen = torch.topk(probs, k, dim=-1)
        flat = chosen.flatten()
        # A scatter-add and not torch.bincount, which on the card reads the
        # input's max on the host: a second sync.
        counts = torch.zeros_like(self.expert_tokens).scatter_add_(0, flat, torch.ones_like(flat))
        self.expert_tokens += counts
        if self.routes is not None:
            self.routes.append(chosen.to(torch.uint8).view(*shape[:-1], k))
        order = torch.argsort(flat, stable=True)
        rows = x[order // k]
        out = torch.empty_like(rows)
        start = 0
        for expert, n in zip(self.experts, counts.tolist()):  # the layer's one host sync
            if n:
                out[start:start + n] = expert(rows[start:start + n])
            start += n
        back = torch.empty_like(out)
        back[order] = out
        y = (back.view(-1, k, shape[-1]) * weights.to(x.dtype)[..., None]).sum(dim=1)
        return y.view(shape)


def _repeat_kv(t: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, kv, L, hd) -> (B, kv * groups, L, hd), each head repeated
    ``groups`` times in a row (HF's ``repeat_kv``)."""
    if groups == 1:
        return t
    b, kv, n, hd = t.shape
    return t[:, :, None].expand(b, kv, groups, n, hd).reshape(b, kv * groups, n, hd)


def _fused_sdpa(device: torch.device):
    """On the card, SDPA's fused backends only; elsewhere any."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    from torch.nn.attention import SDPBackend, sdpa_kernel

    return sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                        SDPBackend.EFFICIENT_ATTENTION])


class JambaAttention(nn.Module):
    """GQA, causal, no positional encoding."""

    def __init__(self, cfg: JambaConfig):
        super().__init__()
        d, hd = cfg.hidden_size, cfg.head_dim
        self.heads, self.kv_heads, self.head_dim = (cfg.num_attention_heads,
                                                    cfg.num_key_value_heads, hd)
        self.q_proj = _Weights((self.heads * hd, d))
        self.k_proj = _Weights((self.kv_heads * hd, d))
        self.v_proj = _Weights((self.kv_heads * hd, d))
        self.o_proj = _Weights((d, self.heads * hd))

    def forward(self, x: torch.Tensor, past: tuple | None = None):
        """x (B, L, d) -> (out (B, L, d), (K, V) (B, kv, L_past + L, hd)): over
        the prompt (``past`` None, causal), or new positions after the
        cached K/V (one token attends to every cached one)."""
        b, n, _ = x.shape

        def heads(w, h):
            return _linear(w, x).view(b, n, h, self.head_dim).transpose(1, 2)

        q, k, v = heads(self.q_proj, self.heads), heads(self.k_proj, self.kv_heads), \
            heads(self.v_proj, self.kv_heads)
        if past is not None:
            if n != 1:
                raise ValueError("decoding on the cache takes one token at a time")
            k, v = torch.cat([past[0], k], dim=2), torch.cat([past[1], v], dim=2)
        groups = self.heads // self.kv_heads
        with _fused_sdpa(x.device):
            o = F.scaled_dot_product_attention(q, _repeat_kv(k, groups), _repeat_kv(v, groups),
                                               is_causal=past is None,
                                               scale=1.0 / math.sqrt(self.head_dim))
        return _linear(self.o_proj, o.transpose(1, 2).reshape(b, n, -1)), (k, v)


class JambaDecoderLayer(nn.Module):
    """HF's ``JambaMambaDecoderLayer`` or ``JambaAttentionDecoderLayer``."""

    def __init__(self, cfg: JambaConfig, index: int):
        super().__init__()
        d = cfg.hidden_size
        self.kind = cfg.layers_block_type[index]
        if self.kind == "mamba":
            self.mamba = MambaMixer(d, d_state=cfg.mamba_d_state, bimamba_type="none",
                                    n_layer=cfg.num_hidden_layers, d_conv=cfg.mamba_d_conv,
                                    expand=cfg.mamba_expand, dt_rank=cfg.dt_rank,
                                    bcdt_norms=True, norm_eps=cfg.rms_norm_eps)
        else:
            self.self_attn = JambaAttention(cfg)
        self.moe = cfg.layers_num_experts[index] > 1
        self.feed_forward = JambaSparseMoeBlock(cfg) if self.moe else JambaMLP(cfg)
        self.input_layernorm = _Weights((d,))
        self.pre_ff_layernorm = _Weights((d,))


class _Model(nn.Module):
    def __init__(self, cfg: JambaConfig):
        super().__init__()
        self.embed_tokens = _Weights((cfg.vocab_size, cfg.hidden_size))
        self.layers = nn.ModuleList(JambaDecoderLayer(cfg, i)
                                    for i in range(cfg.num_hidden_layers))
        self.final_layernorm = _Weights((cfg.hidden_size,))


def _materialize(module: nn.Module, device: torch.device, dtype: torch.dtype) -> None:
    """Each meta parameter and buffer made anew on ``device``: parameters in
    ``dtype`` (fp32 where ``FP32_SUFFIXES`` says), buffers zeros in theirs."""
    for prefix, mod in module.named_modules():
        for name, p in list(mod._parameters.items()):
            if p is not None:
                key = f"{prefix}.{name}"
                dt = torch.float32 if key.endswith(FP32_SUFFIXES) else dtype
                mod._parameters[name] = nn.Parameter(torch.empty(p.shape, dtype=dt, device=device))
        for name, b in list(mod._buffers.items()):
            if b is not None:
                mod._buffers[name] = torch.zeros(b.shape, dtype=b.dtype, device=device)


class JambaLM(nn.Module):
    """Jamba's causal LM, built on ``device`` (CUDA unless the caller names
    another) in ``config.dtype``, with HF's initialisation drawn from
    ``seed`` on that device."""

    def __init__(self, config: JambaConfig, device: str | torch.device | None = None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        with torch.device("meta"):
            self.model = _Model(config)
            self.lm_head = (None if config.tie_word_embeddings
                            else _Weights((config.vocab_size, config.hidden_size)))
        _materialize(self, device, config.torch_dtype)
        self.reset_parameters(torch.Generator(device).manual_seed(seed))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """HF's ``_init_weights``: products, conv and embedding N(0,
        initializer_range), biases 0, norms and D 1, A_log log(1..d_state)."""
        for key, p in self.named_parameters():
            if key.endswith(".A_log"):
                p.copy_(torch.log(torch.arange(1, p.shape[1] + 1, dtype=torch.float32,
                                               device=p.device)).expand_as(p))
            elif key.endswith((".D", "layernorm.weight")):
                p.fill_(1.0)
            elif key.endswith(".bias"):
                p.zero_()
            else:
                p.normal_(0.0, self.config.initializer_range, generator=generator)

    # --- instruments -----------------------------------------------------------

    def moe_blocks(self) -> list:
        return [layer.feed_forward for layer in self.model.layers if layer.moe]

    def routing_counts(self) -> torch.Tensor:
        """(MoE layers, num_experts) tokens routed to each expert since the
        last reset, a device tensor (reading it on the host is the caller's
        sync)."""
        return torch.stack([m.expert_tokens for m in self.moe_blocks()])

    def reset_routing_counts(self) -> None:
        for m in self.moe_blocks():
            m.expert_tokens.zero_()

    def record_routes(self, on: bool) -> None:
        for m in self.moe_blocks():
            m.routes = [] if on else None

    def take_routes(self) -> list:
        """Per MoE layer, the (B, L, top_k) uint8 expert choices recorded
        since the last take, positions in order; the record starts again."""
        out = []
        for m in self.moe_blocks():
            out.append(torch.cat(m.routes, dim=1))
            m.routes = []
        return out

    # --- forward, prefill, decode -------------------------------------------------

    def _embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.model.embed_tokens.weight[input_ids]

    def _head_weight(self) -> torch.Tensor:
        return (self.model.embed_tokens if self.lm_head is None else self.lm_head).weight

    def _trunk(self, hidden: torch.Tensor, state: dict | None, caches: dict | None):
        """Every layer over ``hidden`` (B, L, d): over a prompt, or one token
        on ``state``; with ``caches`` (a dict of empty lists) each layer's
        new cache is appended. Returns (last sublayer's output, fp32
        residual) for the final add and norm."""
        eps = self.config.rms_norm_eps
        residual = None  # the first add starts the fp32 residual stream
        im = ia = 0
        for layer in self.model.layers:
            normed, residual = fused_add_norm(hidden, layer.input_layernorm.weight,
                                              residual=residual, eps=eps)
            if layer.kind == "mamba":
                with annotate("jamba.mamba"):
                    if state is not None:
                        out, conv, ssm = layer.mamba.step(normed[:, 0], state["conv"][im],
                                                          state["ssm"][im])
                        hidden = out[:, None]
                    elif caches is not None:
                        hidden, conv, ssm = layer.mamba.prefill(normed)
                    else:
                        hidden = layer.mamba(normed)
                if caches is not None:
                    caches["conv"].append(conv)
                    caches["ssm"].append(ssm)
                im += 1
            else:
                with annotate("jamba.attention"):
                    past = None if state is None else (state["key"][ia], state["value"][ia])
                    hidden, (k, v) = layer.self_attn(normed, past)
                if caches is not None:
                    caches["key"].append(k)
                    caches["value"].append(v)
                ia += 1
            normed, residual = fused_add_norm(hidden, layer.pre_ff_layernorm.weight,
                                              residual=residual, eps=eps)
            with annotate("jamba.moe" if layer.moe else "jamba.mlp"):
                hidden = layer.feed_forward(normed)
        return hidden, residual

    def _logits(self, hidden: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        out = fused_add_norm(hidden, self.model.final_layernorm.weight, residual=residual,
                             prenorm=False, eps=self.config.rms_norm_eps)
        return out @ self._head_weight().t()

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids (B, L) -> logits (B, L, vocab_size) in the config's dtype."""
        hidden, residual = self._trunk(self._embed(input_ids), None, None)
        return self._logits(hidden, residual)

    @torch.inference_mode()
    def prefill(self, input_ids: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """The prompt (B, L) in one parallel pass -> (last-position logits
        (B, vocab_size), the hybrid cache)."""
        caches = {"conv": [], "ssm": [], "key": [], "value": []}
        hidden, residual = self._trunk(self._embed(input_ids), None, caches)
        return self._logits(hidden[:, -1], residual[:, -1]), caches

    @torch.inference_mode()
    def decode_step(self, token: torch.Tensor, state: dict) -> tuple[torch.Tensor, dict]:
        """One token (B,) on the hybrid cache -> (logits (B, vocab_size), the
        new cache)."""
        caches = {"conv": [], "ssm": [], "key": [], "value": []}
        hidden, residual = self._trunk(self._embed(token)[:, None], state, caches)
        return self._logits(hidden[:, 0], residual[:, 0]), caches


# --- checkpoints -----------------------------------------------------------------

_SAFETENSORS_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
                       "BF16": torch.bfloat16}


def read_safetensors(path: str):
    """(key, CPU tensor) of each tensor of a safetensors file, one at a time
    (the format: an 8-byte little-endian header length, a JSON header of
    dtype, shape and byte offsets, then the data)."""
    with open(path, "rb") as f:
        size = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(size))
        for key, info in header.items():
            if key == "__metadata__":
                continue
            start, end = info["data_offsets"]
            f.seek(8 + size + start)
            dtype = _SAFETENSORS_DTYPES[info["dtype"]]
            if end == start:
                yield key, torch.empty(info["shape"], dtype=dtype)
                continue
            yield key, torch.frombuffer(bytearray(f.read(end - start)),
                                        dtype=dtype).reshape(info["shape"])


def load_hf_directory(path: str, device: str | torch.device | None = None,
                      dtype: str | None = None) -> JambaLM:
    """A local HF Jamba directory (``config.json`` with ``model_type:
    "jamba"``, ``*.safetensors`` shards) -> ``JambaLM`` on ``device``, each
    tensor copied into its parameter as it is read. Strict: a key the model
    lacks, a shape that differs or a parameter no shard holds raises."""
    with open(os.path.join(path, "config.json")) as f:
        raw = json.load(f)
    if raw.get("model_type") != "jamba":
        raise ValueError(f"{path} holds a {raw.get('model_type')!r} model, not 'jamba'")
    model = JambaLM(JambaConfig.from_hf(raw, dtype), device=device)
    params = dict(model.named_parameters())
    shards = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if not shards:
        raise FileNotFoundError(f"no *.safetensors in {path}")
    seen = set()
    with torch.no_grad():
        for shard in shards:
            for key, t in read_safetensors(shard):
                if key == "lm_head.weight" and model.lm_head is None:
                    continue  # the tied head is the embedding
                if key not in params:
                    raise KeyError(f"unexpected key {key!r} in {shard}")
                if tuple(t.shape) != tuple(params[key].shape):
                    raise ValueError(f"{key}: {tuple(t.shape)} in {shard}, the model has "
                                     f"{tuple(params[key].shape)}")
                params[key].copy_(t)
                seen.add(key)
    missing = sorted(set(params) - seen)
    if missing:
        raise KeyError(f"{len(missing)} parameters are in no shard, e.g. {missing[:3]}")
    return model
