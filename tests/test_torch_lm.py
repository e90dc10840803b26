"""The PyTorch port's Mamba LM (``aum_tpu_torch.models.lm``) against the JAX
package's, on the CPU, at ``tests/test_lm.py``'s size (d_model 64, 2 layers,
vocabulary 100, d_state 8).

The JAX model's weights are drawn by its ``init`` and carried into the port
by ``convert.lm_state_dict_from_jax``; both packages then run the same
function on the same token ids:

- the forward logits, ``prefill`` (the last position's logits and both
  caches, also for a prompt shorter than d_conv), ``decode_step`` from the
  JAX prefill's caches, and the two decode ops (``selective_state_update``,
  ``causal_conv1d_update``) on random inputs from a seed;
- greedy ``generate``, token for token;
- ``sample_token`` with repetition penalty, top-k and top-p on JAX's own
  Gumbel draws (``jax.random.categorical`` is argmax(logits + Gumbel noise
  of the same key), which the test checks first);
- ``save_pretrained`` / ``load_pretrained`` in both directions between the
  packages, and ``from_pretrained_hf`` on a local directory the test writes;
- the kernel limits for a CUDA device (any d_state and conv width from 1),
  checked without a card through ``check_kernel_limits``.

The JAX prefill and forward run the Pallas scan kernel in interpret mode on
the CPU, as ``tests/test_lm.py`` runs them; their results are computed once
per module. fp32 throughout: the port's plain scan is the sequential oracle,
the JAX kernel a chunked scan, so they agree to fp32 rounding (``TOL``).
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from aum_tpu.models import lm as jlm
from aum_tpu.ops.conv1d import causal_conv1d_update as jax_conv_update
from aum_tpu.ops.state_update import selective_state_update as jax_state_update

CFG = jlm.MambaLMConfig(d_model=64, n_layer=2, vocab_size=100, d_state=8)
IDS = np.array([[5, 17, 3, 42, 8, 13], [2, 9, 31, 7, 1, 64]], np.int32)
# Logits and caches, port (plain, sequential scan) against JAX (chunked
# kernel in interpret mode), both fp32.
TOL = dict(rtol=2e-5, atol=2e-5)


def _port_cfg(cfg=CFG):
    from aum_tpu_torch.models.lm import MambaLMConfig

    return MambaLMConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


@pytest.fixture(scope="module")
def models():
    """(JAX params, port model with the same weights)."""
    from aum_tpu_torch.convert import lm_state_dict_from_jax
    from aum_tpu_torch.models.lm import MambaLM

    params = jlm.MambaLM(CFG).init(jax.random.PRNGKey(0), jnp.asarray(IDS))
    params_np = jax.tree.map(np.asarray, params)
    model = MambaLM(_port_cfg(), device="cpu", seed=1)
    model.load_state_dict(lm_state_dict_from_jax(params_np, CFG))
    return params, model


@pytest.fixture(scope="module")
def jax_prefills(models):
    params, _ = models
    fn = jax.jit(lambda ids: jlm.prefill(params, CFG, ids))
    return {n: jax.tree.map(np.asarray, fn(jnp.asarray(IDS[:, :n]))) for n in (6, 2)}


def _t(x):
    import torch

    return torch.from_numpy(np.array(x))


def test_forward_logits_match_jax(models):
    import torch

    params, model = models
    want = np.asarray(jlm.MambaLM(CFG).apply(params, jnp.asarray(IDS)))
    with torch.no_grad():
        got = model(_t(IDS).long()).numpy()
    assert got.shape == (2, 6, CFG.padded_vocab) == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("length", [6, 2], ids=["prompt6", "shorter_than_d_conv"])
def test_prefill_logits_and_caches_match_jax(models, jax_prefills, length):
    from aum_tpu_torch.models.lm import prefill

    _, model = models
    want_logits, want_state = jax_prefills[length]
    logits, state = prefill(model, _t(IDS[:, :length]).long())
    np.testing.assert_allclose(logits.numpy(), want_logits, **TOL)
    for k in ("conv", "ssm"):
        assert state[k].shape == want_state[k].shape
        np.testing.assert_allclose(state[k].numpy(), want_state[k], **TOL)
    if length < CFG.d_conv:  # left-padded with zeros, oldest first
        assert not state["conv"][..., :CFG.d_conv - length].any()


def test_decode_step_matches_jax(models, jax_prefills):
    from aum_tpu_torch.models.lm import decode_step

    params, model = models
    _, state = jax_prefills[6]
    token = np.array([7, 55], np.int32)
    want_logits, want_state = jlm.decode_step(params, CFG, jnp.asarray(token),
                                              jax.tree.map(jnp.asarray, state))
    logits, got_state = decode_step(model, _t(token).long(),
                                    {k: _t(v) for k, v in state.items()})
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), **TOL)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(got_state[k].numpy(), np.asarray(want_state[k]), **TOL)


@pytest.mark.parametrize("with_dz", [True, False], ids=["D_z_bias", "bare"])
def test_decode_ops_match_jax(with_dz):
    from aum_tpu_torch.ops import causal_conv1d_update, selective_state_update

    rng = np.random.default_rng(3)
    b, d, n, k = 3, 24, 8, 4
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    state, x, dt, bm, cm = f(b, d, n), f(b, d), f(b, d), f(b, n), f(b, n)
    a = -np.exp(f(d, n))
    extra = dict(D=f(d), z=f(b, d), dt_bias=f(d), dt_softplus=True) if with_dz else {}
    want = jax_state_update(*map(jnp.asarray, (state, x, dt, a, bm, cm)),
                            **{k_: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                               for k_, v in extra.items()})
    got = selective_state_update(*map(_t, (state, x, dt, a, bm, cm)),
                                 **{k_: _t(v) if isinstance(v, np.ndarray) else v
                                    for k_, v in extra.items()})
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    conv_state, w_conv, bias = f(b, d, k), f(d, k), f(d)
    bias_arg = bias if with_dz else None
    want = jax_conv_update(jnp.asarray(x), jnp.asarray(conv_state), jnp.asarray(w_conv),
                           None if bias_arg is None else jnp.asarray(bias_arg))
    got = causal_conv1d_update(_t(x), _t(conv_state), _t(w_conv),
                               None if bias_arg is None else _t(bias_arg))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_generate_greedy_token_equal(models):
    from aum_tpu_torch.models.lm import generate

    params, model = models
    want = np.asarray(jlm.generate(params, CFG, jnp.asarray(IDS), max_new_tokens=6,
                                   temperature=0.0))
    got = generate(model, _t(IDS).long(), max_new_tokens=6, temperature=0.0).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.max() < CFG.vocab_size


@pytest.mark.parametrize("kw", [
    dict(temperature=0.0, top_k=0, top_p=1.0, repetition_penalty=1.3),
    dict(temperature=1.0, top_k=0, top_p=1.0, repetition_penalty=1.0),
    dict(temperature=0.7, top_k=10, top_p=1.0, repetition_penalty=1.2),
    dict(temperature=1.0, top_k=0, top_p=0.9, repetition_penalty=1.2),
    dict(temperature=1.3, top_k=20, top_p=0.8, repetition_penalty=1.5),
], ids=["greedy_penalty", "plain", "top_k", "top_p", "all"])
def test_sample_token_matches_jax_on_its_draws(kw):
    from aum_tpu_torch.models.lm import sample_token

    rng = np.random.default_rng(5)
    logits = (3.0 * rng.standard_normal((16, CFG.padded_vocab))).astype(np.float32)
    prev = rng.integers(0, CFG.vocab_size, (16, 7)).astype(np.int32)
    key = jax.random.PRNGKey(11)
    noise = jax.random.gumbel(key, logits.shape, jnp.float32)
    # jax.random.categorical is argmax(logits + the key's Gumbel noise).
    probe = jnp.asarray(logits)
    assert (np.asarray(jax.random.categorical(key, probe))
            == np.asarray(jnp.argmax(probe + noise, axis=-1))).all()
    want = np.asarray(jlm._sample_token(key, jnp.asarray(logits), jnp.asarray(prev), kw[
        "temperature"], kw["top_k"], kw["top_p"], kw["repetition_penalty"], CFG.vocab_size))
    got = sample_token(_t(logits), _t(prev).long(), _t(noise), vocab_size=CFG.vocab_size,
                       **kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.max() < CFG.vocab_size


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_save_load_pretrained_between_packages(models, tmp_path, direction):
    import torch

    from aum_tpu_torch.models import lm as plm

    params, model = models
    path = str(tmp_path / "ckpt")
    ids = jnp.asarray(IDS[:1, :4])
    if direction == "jax_to_port":
        jlm.save_pretrained(params, CFG, path)
        loaded = plm.load_pretrained(path, device="cpu")
        assert loaded.config == model.config
        with torch.no_grad():
            got = loaded(_t(IDS[:1, :4]).long()).numpy()
        want = np.asarray(jlm.MambaLM(CFG).apply(params, ids))
    else:
        plm.save_pretrained(model, path)
        params2, cfg2 = jlm.load_pretrained(path)
        assert cfg2 == CFG
        assert (jax.tree_util.tree_structure(params2)
                == jax.tree_util.tree_structure(jax.tree.map(np.asarray, params)))
        for a, b in zip(jax.tree.leaves(params2), jax.tree.leaves(params)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        got = np.asarray(jlm.MambaLM(cfg2).apply(params2, ids))
        want = np.asarray(jlm.MambaLM(CFG).apply(params, ids))
    np.testing.assert_allclose(got, want, **TOL)


def test_from_pretrained_hf_local_dir(models, tmp_path, monkeypatch):
    """A local HF-format directory: config.json and the reference state dict
    (with its tied lm_head.weight) in pytorch_model.bin. A hub id is looked
    up in the local HF cache only, here an empty one, so it raises."""
    import torch

    from aum_tpu_torch.models.lm import from_pretrained_hf

    _, model = models
    hf = tmp_path / "hf"
    hf.mkdir()
    (hf / "config.json").write_text(json.dumps({
        "d_model": CFG.d_model, "n_layer": CFG.n_layer, "vocab_size": CFG.vocab_size,
        "d_state": CFG.d_state, "ssm_cfg": {}, "rms_norm": True, "fused_add_norm": True,
        "pad_vocab_size_multiple": 8}))
    sd = dict(model.state_dict())
    sd["lm_head.weight"] = sd["backbone.embedding.weight"]
    torch.save(sd, str(hf / "pytorch_model.bin"))
    got = from_pretrained_hf(str(hf), device="cpu")
    assert got.config == model.config
    for k, v in model.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "empty_hub"))
    with pytest.raises(FileNotFoundError, match="downloads nothing"):
        from_pretrained_hf("state-spaces/mamba-130m", device="cpu")


@pytest.mark.parametrize("overrides", [{"d_state": 32, "d_conv": 3}, {"d_conv": 12}],
                         ids=["d_state", "d_conv"])
def test_kernel_limits_raise_on_cuda(overrides):
    """The kernels take any d_state (in slices of 16 states) and any conv
    width (past 8 the conv kernel's general form): d_state 32 with d_conv 3
    and d_conv 12 are taken on a CUDA device, while a size of 0, which no
    kernel takes, raises there; the CPU's plain path takes the configs."""
    import dataclasses

    import torch

    from aum_tpu_torch.models.lm import MambaLM, check_kernel_limits

    cfg = dataclasses.replace(_port_cfg(), **overrides)
    check_kernel_limits(cfg, torch.device("cuda"))
    for name in overrides:
        with pytest.raises(ValueError, match=f"{name}=0"):
            check_kernel_limits(dataclasses.replace(cfg, **{name: 0}), torch.device("cuda"))
    check_kernel_limits(cfg, torch.device("cpu"))
    check_kernel_limits(_port_cfg(), torch.device("cuda"))
    # The plain path on the CPU takes the config.
    model = MambaLM(cfg, device="cpu")
    with torch.no_grad():
        assert model(torch.tensor([[1, 2, 3, 4, 5]])).shape == (1, 5, CFG.padded_vocab)
