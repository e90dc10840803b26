"""Plain fp32 reference of Jamba's causal LM, after ``transformers``'
``models/jamba/modeling_jamba.py`` (4.57.6).

``logits(get, cfg, input_ids)`` follows ``JambaForCausalLM.forward`` for the
published configurations (``cfg`` holds HF's config keys): the embedding,
``num_hidden_layers`` decoder layers, ``final_layernorm`` and ``lm_head``
(the embedding where ``tie_word_embeddings``). Layer i is
x += mixer(RMSNorm(x)), x += ffn(RMSNorm(x)), the mixer attention where
``i % attn_layer_period == attn_layer_offset`` and Mamba elsewhere, the ffn
the MoE where ``i % expert_layer_period == expert_layer_offset`` and
``num_experts > 1``, a SwiGLU MLP elsewhere:

- Mamba (``JambaMambaMixer.slow_forward``): in_proj, the causal depthwise
  conv with its bias and SiLU, x_proj split into (dt, B, C), an RMSNorm on
  each, dt_proj with its bias, softplus, the selective scan gated by
  silu(z), out_proj;
- attention (``JambaAttention``): q, k, v, K/V repeated over the query
  groups, softmax(QK^T / sqrt(head_dim)) with the causal mask, no positional
  encoding, o_proj;
- MoE (``JambaSparseMoeBlock``): the router without bias, softmax in fp32,
  top-k, the chosen probabilities as weights without renormalisation, each
  expert's SwiGLU on its tokens.

Departures from HF, none of which changes the function: the residual stream
is fp32 throughout (HF keeps it in the weights' dtype; with fp32 weights the
two agree); the scan is ``benchmark/reference/scan.py``'s recurrence run over
blocks of ``scan_block`` steps from the carried state, so that a block's
(steps, B, d_inner, d_state) tensors fit the card at 32k tokens; attention
is computed over blocks of ``q_block`` queries, each against the keys up to
its end; the dense MLP runs over blocks of ``row_block`` tokens; there is no
cache (decoding is compared against this full forward).

Where the program's expert choices are given (``routes``), the reference
holds the router to them only at near-ties: at a position whose top-k set
differs from the program's, with R the reference's set and P the program's,
the gap is max p(R \\ P) - min p(P \\ R) of the reference's fp32
probabilities. A gap up to ``margin`` is a tie: the reference takes P and
counts it (``near_ties``); a larger gap keeps R and counts as
``beyond_margin``. The weights are the reference's probabilities of the set
taken.

``get(keys)`` returns {key: fp32 tensor} for the keys asked, so a caller can
hand over one layer's parameters at a time. ``rnd`` rounds at the points
the configuration computes in its compute dtype (``precision.rounding``).
Imports only torch and this package.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.aum import causal_conv_silu
from benchmark.reference.scan import LinearRecurrence


def dt_rank(cfg: dict) -> int:
    r = cfg.get("mamba_dt_rank", "auto")
    return math.ceil(cfg["hidden_size"] / 16) if r == "auto" else int(r)


def layer_kinds(cfg: dict) -> list:
    """(mixer, ffn) of each layer: ("mamba" | "attention", "moe" | "mlp")."""
    return [("attention" if i % cfg["attn_layer_period"] == cfg["attn_layer_offset"] else "mamba",
             "moe" if cfg["num_experts"] > 1
             and i % cfg["expert_layer_period"] == cfg["expert_layer_offset"] else "mlp")
            for i in range(cfg["num_hidden_layers"])]


def _mlp_shapes(pre: str, d: int, f: int) -> dict:
    return {pre + "gate_proj.weight": (f, d), pre + "up_proj.weight": (f, d),
            pre + "down_proj.weight": (d, f)}


def layer_shapes(cfg: dict, i: int) -> dict:
    """HF's parameter keys and shapes of layer i."""
    d, f, n = cfg["hidden_size"], cfg["intermediate_size"], cfg["mamba_d_state"]
    di, r, k = cfg["mamba_expand"] * d, dt_rank(cfg), cfg["mamba_d_conv"]
    hd = d // cfg["num_attention_heads"]
    mixer, ffn = layer_kinds(cfg)[i]
    pre = f"model.layers.{i}."
    if mixer == "mamba":
        m = pre + "mamba."
        out = {m + "A_log": (di, n), m + "D": (di,), m + "conv1d.weight": (di, 1, k),
               m + "conv1d.bias": (di,), m + "in_proj.weight": (2 * di, d),
               m + "x_proj.weight": (r + 2 * n, di), m + "dt_proj.weight": (di, r),
               m + "dt_proj.bias": (di,), m + "out_proj.weight": (d, di),
               m + "dt_layernorm.weight": (r,), m + "b_layernorm.weight": (n,),
               m + "c_layernorm.weight": (n,)}
    else:
        a, kv = pre + "self_attn.", cfg["num_key_value_heads"] * hd
        out = {a + "q_proj.weight": (d, d), a + "k_proj.weight": (kv, d),
               a + "v_proj.weight": (kv, d), a + "o_proj.weight": (d, d)}
    if ffn == "moe":
        out[pre + "feed_forward.router.weight"] = (cfg["num_experts"], d)
        for e in range(cfg["num_experts"]):
            out.update(_mlp_shapes(f"{pre}feed_forward.experts.{e}.", d, f))
    else:
        out.update(_mlp_shapes(pre + "feed_forward.", d, f))
    out[pre + "input_layernorm.weight"] = (d,)
    out[pre + "pre_ff_layernorm.weight"] = (d,)
    return out


def head_keys(cfg: dict) -> list:
    return ["model.final_layernorm.weight",
            "model.embed_tokens.weight" if cfg["tie_word_embeddings"] else "lm_head.weight"]


def param_shapes(cfg: dict) -> dict:
    """Every parameter's key and shape, in HF's order."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    out = {"model.embed_tokens.weight": (v, d)}
    for i in range(cfg["num_hidden_layers"]):
        out.update(layer_shapes(cfg, i))
    out["model.final_layernorm.weight"] = (d,)
    if not cfg["tie_word_embeddings"]:
        out["lm_head.weight"] = (v, d)
    return out


def rms_norm(x, weight, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * weight


def scan_blocks(u, delta, A, B, C, D, z, delta_bias, block: int):
    """The selective scan of ``scan.selective_scan`` (forward, zero initial
    state), its recurrence run ``block`` steps at a time from the carried
    state. u, delta, z (Bt, L, Dm); A (Dm, N); B, C (Bt, L, N)."""
    dt = F.softplus(delta + delta_bias)
    h = torch.zeros(u.shape[0], u.shape[2], A.shape[1], device=u.device)
    ys = []
    for t0 in range(0, u.shape[1], block):
        sl = slice(t0, t0 + block)
        dt_t, u_t = dt[:, sl].transpose(0, 1), u[:, sl].transpose(0, 1)   # (l, Bt, Dm)
        a = torch.exp(dt_t[..., None] * A)                                  # (l, Bt, Dm, N)
        b = (dt_t * u_t)[..., None] * B[:, sl].transpose(0, 1)[:, :, None, :]
        b[0] += a[0] * h
        hs = LinearRecurrence.apply(a, b, False)
        ys.append(torch.einsum("lbdn,lbn->bld", hs, C[:, sl].transpose(0, 1)))
        h = hs[-1]
        del a, b, hs
    return (torch.cat(ys, dim=1) + u * D) * F.silu(z)


def mamba(p: dict, pre: str, x, cfg: dict, rnd, scan_block: int):
    eps, n, r = cfg["rms_norm_eps"], cfg["mamba_d_state"], dt_rank(cfg)
    xz = rnd(x @ rnd(p[pre + "in_proj.weight"]).t())
    xs, z = xz.chunk(2, dim=-1)
    xc = causal_conv_silu(xs, p[pre + "conv1d.weight"], p[pre + "conv1d.bias"], rnd)
    x_dbl = rnd(xc @ rnd(p[pre + "x_proj.weight"]).t())
    dtr, bm, cm = x_dbl.split([r, n, n], dim=-1)
    dtr = rnd(rms_norm(dtr, rnd(p[pre + "dt_layernorm.weight"]), eps))
    bm = rnd(rms_norm(bm, rnd(p[pre + "b_layernorm.weight"]), eps))
    cm = rnd(rms_norm(cm, rnd(p[pre + "c_layernorm.weight"]), eps))
    delta = rnd(dtr @ rnd(p[pre + "dt_proj.weight"]).t())
    a = -torch.exp(p[pre + "A_log"])
    y = rnd(scan_blocks(xc, delta, a, bm, cm, p[pre + "D"], z, p[pre + "dt_proj.bias"],
                        scan_block))
    return rnd(y @ rnd(p[pre + "out_proj.weight"]).t())


def attention(p: dict, pre: str, x, cfg: dict, rnd, q_block: int):
    bt, length, d = x.shape
    heads, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // heads

    def proj(name, h):
        out = rnd(x @ rnd(p[pre + name]).t()).view(bt, length, h, hd).transpose(1, 2)
        return out.repeat_interleave(heads // h, dim=1)

    q, k, v = proj("q_proj.weight", heads), proj("k_proj.weight", kv), proj("v_proj.weight", kv)
    out = torch.empty_like(q)
    pos = torch.arange(length, device=x.device)
    for b in range(bt):
        for q0 in range(0, length, q_block):
            q1 = min(q0 + q_block, length)
            s = q[b, :, q0:q1] @ k[b, :, :q1].transpose(-1, -2) / math.sqrt(hd)
            s = s.masked_fill(pos[q0:q1, None] < pos[None, :q1], -math.inf)
            out[b, :, q0:q1] = torch.softmax(s, dim=-1) @ v[b, :, :q1]
    o = rnd(out.transpose(1, 2).reshape(bt, length, d))
    return rnd(o @ rnd(p[pre + "o_proj.weight"]).t())


def swiglu(p: dict, pre: str, x, rnd):
    g = rnd(x @ rnd(p[pre + "gate_proj.weight"]).t())
    u = rnd(x @ rnd(p[pre + "up_proj.weight"]).t())
    return rnd(rnd(F.silu(g) * u) @ rnd(p[pre + "down_proj.weight"]).t())


def mlp(p: dict, pre: str, x, rnd, row_block: int):
    flat = x.reshape(-1, x.shape[-1])
    return torch.cat([swiglu(p, pre, flat[i:i + row_block], rnd)
                      for i in range(0, flat.shape[0], row_block)]).view(x.shape)


def moe(p: dict, pre: str, x, cfg: dict, rnd, routes, margin: float, stats: dict):
    """The MoE over x (Bt, L, d); appends its own choices to
    ``stats["routes"]``, and applies the near-tie rule against ``routes``
    ((Bt, L, k) of the program's choices, or None)."""
    k, experts = cfg["num_experts_per_tok"], cfg["num_experts"]
    flat = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(rnd(flat @ rnd(p[pre + "router.weight"]).t()), dim=-1)
    chosen = torch.topk(probs, k, dim=-1).indices
    stats["routes"].append(chosen.view(*x.shape[:-1], k).to(torch.uint8))
    if routes is not None:
        theirs = routes.reshape(-1, k).long().to(x.device)
        own_set = torch.zeros_like(probs, dtype=torch.bool).scatter_(1, chosen, True)
        their_set = torch.zeros_like(own_set).scatter_(1, theirs, True)
        differ = (own_set != their_set).any(dim=1)
        if differ.any():
            only_own = (own_set & ~their_set)[differ]
            only_theirs = (their_set & ~own_set)[differ]
            pd = probs[differ]
            gap = (pd.masked_fill(~only_own, -1.0).amax(1)
                   - pd.masked_fill(~only_theirs, 2.0).amin(1))
            tie = gap <= margin
            rows = differ.nonzero()[:, 0]
            chosen = chosen.clone()
            chosen[rows[tie]] = theirs[rows[tie]]
            stats["near_ties"] += int(tie.sum())
            stats["beyond_margin"] += int((~tie).sum())
            stats["max_tie_gap"] = max(stats["max_tie_gap"],
                                       float(gap[tie].max()) if tie.any() else 0.0)
    weights = probs.gather(1, chosen)
    out = torch.zeros_like(flat)
    for e in range(experts):
        tok, slot = torch.where(chosen == e)
        if tok.numel():
            y = swiglu(p, f"{pre}experts.{e}.", flat[tok], rnd)
            out.index_add_(0, tok, y * weights[tok, slot, None])
    return rnd(out).view(x.shape)


def new_stats() -> dict:
    return {"near_ties": 0, "beyond_margin": 0, "max_tie_gap": 0.0, "routes": []}


def logits(get, cfg: dict, input_ids: torch.Tensor, rnd=lambda t: t.float(), routes=None,
           margin: float = 0.0, last_only: bool = False, scan_block: int = 512,
           q_block: int = 512, row_block: int = 16384):
    """input_ids (Bt, L) -> (fp32 logits (Bt, L, vocab), or (Bt, vocab) of
    the last position with ``last_only``; the stats: ``near_ties``,
    ``beyond_margin``, the largest gap taken as a tie, and the reference's
    own choices per MoE layer). ``routes``:
    the program's (Bt, L, k) choices per MoE layer, in layer order."""
    eps = cfg["rms_norm_eps"]
    stats = new_stats()
    emb = get(["model.embed_tokens.weight"])["model.embed_tokens.weight"]
    h = rnd(emb[input_ids]).float()
    del emb
    im = 0
    for i, (mixer, ffn) in enumerate(layer_kinds(cfg)):
        p = get(list(layer_shapes(cfg, i)))
        pre = f"model.layers.{i}."
        x = rnd(rms_norm(h, rnd(p[pre + "input_layernorm.weight"]), eps))
        if mixer == "mamba":
            h = h + mamba(p, pre + "mamba.", x, cfg, rnd, scan_block)
        else:
            h = h + attention(p, pre + "self_attn.", x, cfg, rnd, q_block)
        x = rnd(rms_norm(h, rnd(p[pre + "pre_ff_layernorm.weight"]), eps))
        if ffn == "moe":
            h = h + moe(p, pre + "feed_forward.", x, cfg, rnd,
                        None if routes is None else routes[im], margin, stats)
            im += 1
        else:
            h = h + mlp(p, pre + "feed_forward.", x, rnd, row_block)
        del p, x
    norm_key, head_key = head_keys(cfg)
    p = get([norm_key, head_key])
    if last_only:
        h = h[:, -1]
    x = rnd(rms_norm(h, rnd(p[norm_key]), eps))
    return rnd(x @ rnd(p[head_key]).t()).float(), stats
