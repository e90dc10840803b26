"""Jamba on the port's LM path against the plain reference
(``benchmark/reference/jamba.py``) and ``transformers``' Jamba, on the CPU
at a tiny size: width 64, one period of 8 layers (attention at 4, the MoE on
the odd layers), 4 experts top-2, 4 query and 2 KV heads, vocabulary 256,
two prompts of 37 tokens, fp32.

Tolerances: the port and the reference compute the same fp32 function in
different orders (fused add and norm, the scan kernel's plain version against
the blocked recurrence, SDPA against the blocked softmax), which leaves about
1e-6 of relative difference in the logits; the checks allow 1e-5. Greedy
tokens are compared exactly: at this size the top two logits lie far further
apart than 1e-5.
"""

import dataclasses
import json
import math

import pytest
import torch

from aum_tpu_torch.models import lm
from aum_tpu_torch.models.jamba import JambaConfig, JambaLM
from aum_tpu_torch.models.mamba import MambaMixer
from benchmark.reference import jamba as ref

TINY = JambaConfig(vocab_size=256, hidden_size=64, intermediate_size=96, num_hidden_layers=8,
                   num_attention_heads=4, num_key_value_heads=2, num_experts=4,
                   num_experts_per_tok=2, mamba_d_state=8, dtype="float32")
RTOL = 1e-5
# The reference takes the program's expert choices only where its own fp32
# probabilities tie them within this: in fp32 on both sides, none should differ.
MARGIN = 1e-5


def _raw(cfg: JambaConfig) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _rel(got, want) -> float:
    return float((got.double() - want.double()).norm() / want.double().norm())


@pytest.fixture(scope="module")
def model():
    """The tiny model with weights spread wider than HF's N(0, 0.02), so that
    every layer moves the logits: norms and D near 1, dt bias near -4."""
    m = JambaLM(TINY, device="cpu", seed=3)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for key, p in m.named_parameters():
            noise = torch.randn(p.shape, generator=g)
            if key.endswith(".A_log"):
                p.add_(0.1 * noise)
            elif key.endswith((".D", "layernorm.weight")):
                p.copy_(1 + 0.1 * noise)
            elif key.endswith("dt_proj.bias"):
                p.copy_(-4 + noise)
            else:
                p.copy_(noise * (0.3 if "conv1d" in key else 0.08))
    return m


@pytest.fixture(scope="module")
def ids():
    return torch.randint(0, TINY.vocab_size, (2, 42), generator=torch.Generator().manual_seed(1))


@pytest.fixture(scope="module")
def reference(model, ids):
    sd = {k: v.float() for k, v in model.state_dict().items()}
    return ref.logits(lambda keys: {k: sd[k] for k in keys}, _raw(TINY), ids)


def test_keys_and_shapes_are_the_references(model):
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert shapes == {k: tuple(v) for k, v in ref.param_shapes(_raw(TINY)).items()}


def test_forward_matches_reference(model, ids):
    x = ids[:, :37]
    model.record_routes(True)
    try:
        with torch.no_grad():
            got = model(x)
        routes = model.take_routes()
    finally:
        model.record_routes(False)
    sd = {k: v.float() for k, v in model.state_dict().items()}
    want, stats = ref.logits(lambda keys: {k: sd[k] for k in keys}, _raw(TINY), x,
                             routes=routes, margin=MARGIN)
    assert got.shape == want.shape == (2, 37, TINY.vocab_size)
    assert stats["beyond_margin"] == stats["near_ties"] == 0
    assert _rel(got, want) < RTOL
    # In fp32 on both sides every choice is the reference's own.
    assert len(routes) == 4
    assert all(torch.equal(mine, theirs) for mine, theirs in zip(routes, stats["routes"]))


def test_prefill_then_decode_matches_reference(model, ids, reference):
    want, _ = reference
    logits, state = lm.prefill(model, ids[:, :37])
    assert len(state["conv"]) == len(state["ssm"]) == 7 and len(state["key"]) == 1
    assert state["key"][0].shape == (2, TINY.num_key_value_heads, 37, TINY.head_dim)
    assert _rel(logits, want[:, 36]) < RTOL
    for t in range(37, 42):
        logits, state = lm.decode_step(model, ids[:, t], state)
        assert _rel(logits, want[:, t]) < RTOL, t
    assert state["value"][0].shape[2] == 42


def test_generate_greedy_matches_reference_argmax(model, ids):
    sd = {k: v.float() for k, v in model.state_dict().items()}
    out = lm.generate(model, ids[:, :37], max_new_tokens=4, temperature=0.0)
    seq = ids[:, :37]
    for _ in range(4):
        want, _ = ref.logits(lambda keys: {k: sd[k] for k in keys}, _raw(TINY), seq,
                             last_only=True)
        top2 = want.topk(2, dim=-1).values
        assert float((top2[:, 0] - top2[:, 1]).min()) > 100 * RTOL * float(want.abs().max())
        seq = torch.cat([seq, want.argmax(-1, keepdim=True)], dim=1)
    assert torch.equal(out, seq)


PUBLISHED = {
    # The catalog's config.json keys of both AI21 Jamba2 models.
    "AI21-Jamba2-Mini": {"attn_layer_offset": 4, "attn_layer_period": 8,
                         "expert_layer_offset": 1, "expert_layer_period": 2,
                         "hidden_act": "silu", "hidden_size": 4096, "intermediate_size": 14336,
                         "mamba_conv_bias": True, "mamba_d_conv": 4, "mamba_d_state": 16,
                         "mamba_dt_rank": 256, "mamba_expand": 2, "mamba_proj_bias": False,
                         "max_position_embeddings": 262144, "model_type": "jamba",
                         "num_attention_heads": 32, "num_experts": 16,
                         "num_experts_per_tok": 2, "num_hidden_layers": 32,
                         "num_key_value_heads": 8, "num_logits_to_keep": 1,
                         "rms_norm_eps": 1e-06, "sliding_window": None,
                         "tie_word_embeddings": False, "use_mamba_kernels": True,
                         "vocab_size": 65536},
    "AI21-Jamba2-3B": {"attn_layer_offset": 7, "attn_layer_period": 14,
                       "expert_layer_offset": 1, "expert_layer_period": 2,
                       "hidden_act": "silu", "hidden_size": 2560, "intermediate_size": 8192,
                       "mamba_conv_bias": True, "mamba_d_conv": 4, "mamba_d_state": 16,
                       "mamba_dt_rank": 160, "mamba_expand": 2, "mamba_proj_bias": False,
                       "max_position_embeddings": 262144, "model_type": "jamba",
                       "num_attention_heads": 20, "num_experts": 1, "num_experts_per_tok": 1,
                       "num_hidden_layers": 28, "num_key_value_heads": 1,
                       "num_logits_to_keep": 1, "rms_norm_eps": 1e-06, "sliding_window": None,
                       "tie_word_embeddings": True, "use_mamba_kernels": True,
                       "vocab_size": 65536},
}


@pytest.mark.parametrize("name, attention, moe", [
    ("AI21-Jamba2-Mini", [4, 12, 20, 28], list(range(1, 32, 2))),
    ("AI21-Jamba2-3B", [7, 21], []),
])
def test_layer_types_of_published_configs(name, attention, moe):
    raw = PUBLISHED[name]
    cfg = JambaConfig.from_hf(raw)
    kinds = cfg.layers_block_type
    assert [i for i, k in enumerate(kinds) if k == "attention"] == attention
    assert [i for i, e in enumerate(cfg.layers_num_experts) if e > 1] == moe
    assert [(m, f == "moe") for m, f in ref.layer_kinds(raw)] == list(
        zip(kinds, [e > 1 for e in cfg.layers_num_experts]))
    assert cfg.dt_rank == raw["mamba_dt_rank"] and cfg.dtype == "bfloat16"


def _save_hf_directory(model, path, extra=None, drop=None):
    st = pytest.importorskip("safetensors.torch")
    sd = {k: v.detach().clone().contiguous() for k, v in model.state_dict().items()}
    if drop:
        del sd[drop]
    if extra:
        sd[extra] = torch.zeros(3)
    keys = sorted(sd)
    half = len(keys) // 2
    for i, part in enumerate((keys[:half], keys[half:])):
        name = f"model-0000{i + 1}-of-00002.safetensors"
        st.save_file({k: sd[k] for k in part}, str(path / name))
    (path / "config.json").write_text(json.dumps(
        {**_raw(TINY), "model_type": "jamba", "torch_dtype": "float32", "dtype": None}))


def test_from_pretrained_hf_round_trip(model, ids, tmp_path):
    _save_hf_directory(model, tmp_path)
    loaded = lm.from_pretrained_hf(str(tmp_path), device="cpu")
    assert isinstance(loaded, JambaLM) and loaded.config == TINY
    mine, theirs = model.state_dict(), loaded.state_dict()
    assert set(mine) == set(theirs) and all(torch.equal(mine[k], theirs[k]) for k in mine)
    with torch.no_grad():
        assert torch.equal(loaded(ids[:, :9]), model(ids[:, :9]))


@pytest.mark.parametrize("fault", ["extra", "missing"])
def test_from_pretrained_hf_is_strict(model, tmp_path, fault):
    if fault == "extra":
        _save_hf_directory(model, tmp_path, extra="model.layers.0.mamba.bogus")
    else:
        _save_hf_directory(model, tmp_path, drop="model.layers.4.self_attn.k_proj.weight")
    with pytest.raises(KeyError):
        lm.from_pretrained_hf(str(tmp_path), device="cpu")


def test_routing_counter_sums_to_tokens_times_top_k(model, ids):
    model.reset_routing_counts()
    with torch.no_grad():
        model(ids[:, :37])
    logits, state = lm.prefill(model, ids[:, :20])
    lm.decode_step(model, ids[:, 20], state)
    counts = model.routing_counts()
    tokens = 2 * (37 + 20 + 1)
    assert counts.shape == (4, TINY.num_experts) and counts.dtype == torch.long
    assert counts.sum(dim=1).tolist() == [tokens * TINY.num_experts_per_tok] * 4
    model.reset_routing_counts()
    assert int(model.routing_counts().sum()) == 0


def test_reference_matches_transformers(model, ids, reference):
    transformers = pytest.importorskip("transformers")
    want, _ = reference
    hcfg = transformers.JambaConfig(**{k: v for k, v in _raw(TINY).items() if k != "dtype"},
                                    use_mamba_kernels=False, attn_implementation="eager")
    hf = transformers.JambaForCausalLM(hcfg).eval()
    hf.load_state_dict({k: v.float() for k, v in model.state_dict().items()}, strict=True)
    with torch.no_grad():
        got = hf(ids, logits_to_keep=0).logits
    assert _rel(got, want) < RTOL


# --- the mixers of the benchmark's AuM cells: unchanged with the norms off ------


def _mixer_as_before(m: MambaMixer, x, ops):
    """The mixer's forward as it was before the dt/B/C norms: B and C strided
    column views of the x_proj product."""
    dtype, d_in, r, n = x.dtype, m.d_inner, m.dt_rank, m.d_state
    xz = x @ m.in_proj.weight.to(dtype).t()
    xs, z = xz[..., :d_in], xz[..., d_in:]
    xc = ops.causal_conv1d(xs, m.conv1d.weight[:, 0].to(dtype), m.conv1d.bias.to(dtype),
                           activation="silu")
    x_dbl = xc @ m.x_proj.weight.to(dtype).t()
    delta = x_dbl[..., :r] @ m.dt_proj.weight.to(dtype).t()
    bias = m.dt_proj.bias.float()
    args = (xc, delta, -torch.exp(m.A_log.float()), x_dbl[..., r:r + n], x_dbl[..., r + n:],
            m.D.float(), z, bias)
    if m.bimamba_type == "none":
        y = ops.selective_scan(*args, delta_softplus=True)
    else:
        rev = (xc, delta, -torch.exp(m.A_b_log.float())) + args[3:]
        y_f, y_b = ops.selective_scan_dual(args, rev, None)
        y = y_f + y_b
    return y @ m.out_proj.weight.to(dtype).t()


@pytest.mark.parametrize("bimamba_type", ["none", "v1"], ids=["aum-base-fofo", "aum-base-fobi"])
def test_mixer_without_norms_is_unchanged(bimamba_type, monkeypatch):
    import aum_tpu_torch.models.mamba as mamba_mod
    from aum_tpu_torch import ops

    monkeypatch.delenv("AUM_SCAN_FUSE_DT", raising=False)
    m = MambaMixer(768, d_state=16, bimamba_type=bimamba_type)  # AuM-Base's mixer
    m.reset_parameters(torch.Generator().manual_seed(5))
    assert not any("layernorm" in k for k in m.state_dict())
    x = torch.randn(2, 33, 768, generator=torch.Generator().manual_seed(6)).bfloat16()
    calls = {"conv": 0, "scan": 0, "dual": 0, "norm": 0}
    seen_b = []

    def counted(name, fn, record_b=False):
        def wrapper(*a, **k):
            calls[name] += 1
            if record_b:
                bm = a[0][3] if name == "dual" else a[3]
                seen_b.append(bm.stride())
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(mamba_mod, "causal_conv1d", counted("conv", ops.causal_conv1d))
    monkeypatch.setattr(mamba_mod, "selective_scan", counted("scan", ops.selective_scan, True))
    monkeypatch.setattr(mamba_mod, "selective_scan_dual",
                        counted("dual", ops.selective_scan_dual, True))
    monkeypatch.setattr(mamba_mod, "rms_norm", counted("norm", ops.rms_norm))
    with torch.no_grad():
        got = m(x)
    dual = bimamba_type != "none"
    assert calls == {"conv": 1, "scan": int(not dual), "dual": int(dual), "norm": 0}
    # B is still a column view of the (B, L, dt_rank + 2 d_state) product.
    assert seen_b == [(33 * (m.dt_rank + 32), m.dt_rank + 32, 1)]
    with torch.no_grad():
        want = _mixer_as_before(m, x, ops)
    assert torch.equal(got, want)


def test_jamba_mixer_norms_feed_the_scan(monkeypatch):
    """With the norms on, B and C reach the scan as the norms' outputs."""
    import aum_tpu_torch.models.mamba as mamba_mod
    from aum_tpu_torch import ops

    m = MambaMixer(64, d_state=8, bimamba_type="none", dt_rank=6, bcdt_norms=True)
    m.reset_parameters(torch.Generator().manual_seed(2))
    x = torch.randn(1, 11, 64, generator=torch.Generator().manual_seed(3))
    seen = []

    def scan(*a, **k):
        seen.append(a)
        return ops.selective_scan(*a, **k)

    monkeypatch.setattr(mamba_mod, "selective_scan", scan)
    with torch.no_grad():
        m(x)
        x_dbl = ops.causal_conv1d(
            (x @ m.in_proj.weight.t())[..., :128], m.conv1d.weight[:, 0], m.conv1d.bias,
            activation="silu") @ m.x_proj.weight.t()
    bm, cm = seen[0][3], seen[0][4]
    assert torch.allclose(bm, ops.rms_norm(x_dbl[..., 6:14], m.b_layernorm.weight, 1e-6))
    assert torch.allclose(cm, ops.rms_norm(x_dbl[..., 14:], m.c_layernorm.weight, 1e-6))
    assert math.isclose(m.norm_eps, 1e-6)
