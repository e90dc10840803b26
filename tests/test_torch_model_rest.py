"""The rest of the PyTorch port's AuM model (``aum_tpu_torch``) against the JAX package, on the CPU.

At ``tests/test_model.py``'s size (depth 2, embed 192, a (128, 128)
spectrogram, 5 classes), fp32, with the port's weights carried to the JAX
model by the JAX package's porter:

- the resize matrices and their pinv (bit-equal, float64), the kernel and
  pos-embed resamplers (``tokenization.py``);
- the logits at run-time patch sizes 8 and 32 (flexible patch sizes);
- the random cls position, the token shuffle and the sequence flip, fed the
  draws JAX makes (the test replays ``AudioMamba.__call__``'s key splits),
  with a single and a double cls token;
- RoPE's buffers, ``apply_rope`` and ``interp_to_grid``, and the model with
  ``if_rope`` and ``if_rope_residual``;
- the four config fields ``rms_norm``, ``residual_in_fp32``,
  ``if_devide_out`` and ``init_layer_scale`` (and ``convert`` carrying
  their parameters);
- ``remat_mode="auto"``'s resolution;
- a train step at patch 8 against ``aum_tpu.train.loop.make_train_step``,
  and ``train_loop``'s sequence of patch sizes against JAX's.

torch is imported inside the tests, as in the other port test modules.
"""

import dataclasses
import functools
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

from aum_tpu.convert.torch_port import port_aum_state_dict
from aum_tpu.models import AudioMamba as JaxAudioMamba
from aum_tpu.models import AudioMambaConfig as JaxConfig
from aum_tpu.models import rope as jrope
from aum_tpu.models import tokenization as jtok

BASE = dict(depth=2, embed_dim=192, spectrogram_size=(128, 128), num_classes=5, remat=False)
# fp32 on both sides, sums in other orders (tests/test_torch_model.py's bound).
TOL = dict(rtol=1e-5, atol=1e-5)


def _port(seed=0, **kw):
    """The port's model at BASE, weights from ``seed``; the LayerNorm biases
    and LayerScale's gamma (which init to constants) made random, so that
    they count."""
    import torch

    from aum_tpu_torch.models import AudioMamba, AudioMambaConfig

    model = AudioMamba(AudioMambaConfig(**{**BASE, **kw}), device="cpu", seed=seed)
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("norm.bias") or name == "norm_f.bias" or name.endswith("gamma"):
                p.copy_(1.0 + 0.3 * torch.randn(p.shape, generator=g)
                        if name.endswith("gamma") else 0.3 * torch.randn(p.shape, generator=g))
    return model


def _jax_params(model):
    """The port's weights as JAX params: the JAX porter, and the LayerNorm
    biases it does not map, stacked as the JAX model holds them."""
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    cfg = model.config
    params = port_aum_state_dict(sd, JaxConfig(**dataclasses.asdict(cfg)))
    if not cfg.rms_norm:
        p = params["params"]
        p["norm_f_bias"] = sd["norm_f.bias"]
        p["layers"]["block"]["norm_bias"] = np.stack(
            [sd[f"layers.{i}.norm.bias"] for i in range(cfg.depth)])
    return params


def _x(seed, bsz=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((bsz, 128, 128)) * 0.5).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_apply(kw_items, **flags):
    """A jitted apply of the JAX model of BASE + kw, with static ``flags``."""
    model = JaxAudioMamba(JaxConfig(**{**BASE, **dict(kw_items)}), use_kernel=False)
    return jax.jit(functools.partial(model.apply, **flags))


def _eval(model, x, **kw):
    import torch

    with torch.inference_mode():
        return model(torch.from_numpy(x), **kw).float().numpy()


# --- resampling ---------------------------------------------------------------

@pytest.mark.parametrize("old,new", [((16, 16), (8, 8)), ((16, 16), (12, 12)),
                                     ((16, 16), (32, 32)), ((8, 64), (16, 128)),
                                     ((16, 16), (16, 16))])
def test_resize_matrices_match_jax(old, new):
    from aum_tpu_torch.models import tokenization as tok

    np.testing.assert_array_equal(tok.resize_matrix(old, new), jtok.resize_matrix(old, new))
    np.testing.assert_array_equal(tok.resize_matrix_pinv(old, new),
                                  jtok.resize_matrix_pinv(old, new))


@pytest.mark.parametrize("new", [(8, 8), (12, 12), (32, 32)])
def test_resamplers_match_jax(new):
    import torch

    from aum_tpu_torch.models import tokenization as tok

    rng = np.random.default_rng(5)
    hwio = rng.standard_normal((16, 16, 1, 24)).astype(np.float32)
    oihw = torch.from_numpy(hwio.transpose(3, 2, 0, 1).copy())
    for port_fn, jax_fn in ((tok.resample_patch_embed, jtok.resample_patch_embed),
                            (tok.vanilla_resample_patch_embed, jtok.vanilla_resample_patch_embed)):
        got = port_fn(oihw, new).numpy().transpose(2, 3, 1, 0)
        np.testing.assert_allclose(got, np.asarray(jax_fn(jnp.asarray(hwio), new)), atol=1e-6)
    pos = rng.standard_normal((1, 1 + 8 * 8, 24)).astype(np.float32)
    grid = (128 // new[0], 128 // new[1])
    got = tok.resample_abs_pos_embed(torch.from_numpy(pos), grid, (8, 8), 1).numpy()
    want = np.asarray(jtok.resample_abs_pos_embed(jnp.asarray(pos), grid, (8, 8), 1))
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("patch", [8, 32])
def test_flexible_patch_logits_match_jax(patch):
    model = _port(seed=1)
    x = _x(1)
    want = np.asarray(_jax_apply((), patch_size=patch, strides=patch)(
        _jax_params(model), jnp.asarray(x)))
    got = _eval(model, x, patch_size=patch, strides=patch)
    assert got.shape == (2, 5)
    np.testing.assert_allclose(got, want, **TOL)
    assert not np.allclose(got, _eval(model, x), atol=1e-3)  # another grid, other logits


# --- the stochastic token order -------------------------------------------------

def _jax_draws(key, n_patches, n_tokens, random_cls, shuffle, flip_prob):
    """The draws ``aum_tpu``'s ``AudioMamba.__call__`` makes from ``rng=key``:
    its key splits replayed, in its order."""
    from aum_tpu_torch.models import TokenDraws

    rng, pos, perm, flip = key, None, None, False
    if random_cls:
        rng, k = jax.random.split(rng)
        pos = int(jax.random.randint(k, (), 0, n_patches + 1))
    if shuffle:
        rng, k = jax.random.split(rng)
        perm = tuple(int(i) for i in jax.random.permutation(k, n_tokens))
    if flip_prob > 0:
        rng, k = jax.random.split(rng)
        flip = bool(jax.random.uniform(k, ()) < flip_prob)
    return TokenDraws(pos, perm, flip)


STOCHASTIC = {
    "random_cls": (dict(), (True, False, 0.0)),
    "shuffle": (dict(), (False, True, 0.0)),
    "cls_shuffle_flip": (dict(), (True, True, 0.5)),
    "double_cls_shuffle_flip": (dict(use_double_cls_token=True, use_middle_cls_token=False),
                                (False, True, 0.5)),
    "double_cls_flip": (dict(use_double_cls_token=True, use_middle_cls_token=False),
                        (False, False, 0.5)),
}


@pytest.mark.parametrize("name", list(STOCHASTIC))
def test_stochastic_tokens_match_jax_draws(name):
    kw, (random_cls, shuffle, flip_prob) = STOCHASTIC[name]
    model = _port(seed=2, **kw)
    params = _jax_params(model)
    fn = _jax_apply(tuple(kw.items()), if_random_cls_token_position=random_cls,
                    if_random_token_rank=shuffle, flip_sequence_prob=flip_prob)
    x = _x(2)
    n = 64  # (128 / 16)^2 patches
    flips = set()
    # Keys 0..3 draw flips both ways at p=0.5 (checked below).
    for seed in range(4 if flip_prob else 1):
        key = jax.random.PRNGKey(seed)
        draws = _jax_draws(key, n, n + model.config.num_prefix_tokens, random_cls, shuffle,
                           flip_prob)
        flips.add(draws.flip)
        want = np.asarray(fn(params, jnp.asarray(x), rng=key))
        got = _eval(model, x, if_random_cls_token_position=random_cls,
                    if_random_token_rank=shuffle, flip_sequence_prob=flip_prob,
                    token_draws=draws)
        np.testing.assert_allclose(got, want, **TOL, err_msg=f"key {seed}: {draws}")
    assert flips == ({False, True} if flip_prob else {False})


def test_stochastic_tokens_draw_from_the_generator():
    import torch

    from aum_tpu_torch.models import draw_tokens

    model = _port(seed=3)
    x = _x(3)
    kw = dict(if_random_cls_token_position=True, if_random_token_rank=True,
              flip_sequence_prob=0.5)
    draws = draw_tokens(torch.Generator().manual_seed(4), 64, 65, True, True, 0.5)
    assert 0 <= draws.cls_position <= 64 and sorted(draws.perm) == list(range(65))
    # The forward's own draw from a generator is that draw, applied.
    got = _eval(model, x, generator=torch.Generator().manual_seed(4), **kw)
    np.testing.assert_array_equal(got, _eval(model, x, token_draws=draws, **kw))
    with pytest.raises(ValueError, match="Generator"):
        _eval(model, x, **kw)
    # Marker tokens: the tracked position still points at the cls token.
    from aum_tpu_torch.models.audio_mamba import _track_flip, _track_shuffle

    seq = np.arange(65)
    perm = list(draws.perm)
    for tp, dyn in (([0, 64], None), (32, None), (None, 7)):
        want = seq[tp] if isinstance(tp, list) else [seq[dyn if dyn is not None else tp]]
        tp2, dyn2 = _track_shuffle(perm, tp, dyn)
        tp3, dyn3 = _track_flip(65, tp2, dyn2)
        shuffled = seq[perm]
        for s, (t, d) in ((shuffled, (tp2, dyn2)), (shuffled[::-1], (tp3, dyn3))):
            got = [s[p] for p in t] if isinstance(t, list) else [s[d]]
            assert list(got) == list(want)


# --- RoPE ---------------------------------------------------------------------

def test_rope_matches_jax():
    import torch

    from aum_tpu_torch.models import rope

    for dim, grid in ((96, (8, 8)), (10, (3, 5))):
        for got, want in zip(rope.rope_freqs_2d(dim, grid, grid),
                             jrope.rope_freqs_2d(dim, grid, grid)):
            np.testing.assert_array_equal(got, want)
    cos, sin = jrope.rope_freqs_2d(96, (8, 8), (8, 8))
    x = np.random.default_rng(6).standard_normal((2, 65, 200)).astype(np.float32)
    got = rope.apply_rope(torch.from_numpy(x), torch.from_numpy(cos), torch.from_numpy(sin), 1)
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin), 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_array_equal(rope.rotate_half(torch.from_numpy(x)).numpy(),
                                  np.asarray(jrope.rotate_half(jnp.asarray(x))))
    np.testing.assert_allclose(rope.interp_to_grid(cos, (8, 8), (16, 8)),
                               jrope.interp_to_grid(cos, (8, 8), (16, 8)), atol=1e-6)


@pytest.mark.parametrize("kw", [dict(if_rope=True, if_rope_residual=True),
                                dict(if_rope=True, bimamba_type="v1", if_bidirectional=True)],
                         ids=["rope_residual", "bidirectional_pairs"])
def test_rope_model_matches_jax(kw):
    model = _port(seed=4, **kw)
    # The buffers follow the config: they are not in the state dict.
    assert not any("rope" in k for k in model.state_dict())
    x = _x(4)
    want = np.asarray(_jax_apply(tuple(kw.items()))(_jax_params(model), jnp.asarray(x)))
    np.testing.assert_allclose(_eval(model, x), want, **TOL)


# --- the four config fields -------------------------------------------------------

FIELDS = {"rms_norm": dict(rms_norm=False),
          "residual_in_fp32": dict(residual_in_fp32=False, dtype="bfloat16"),
          "if_devide_out": dict(if_devide_out=False),
          "init_layer_scale": dict(init_layer_scale=0.5)}


@pytest.mark.parametrize("field", list(FIELDS))
def test_config_fields_match_jax(field):
    from aum_tpu_torch.convert import state_dict_from_jax

    kw = FIELDS[field]
    model = _port(seed=5, **kw)
    params = _jax_params(model)
    # convert carries the field's parameters back, key for key.
    back = state_dict_from_jax(params, model.config)
    assert set(back) == set(model.state_dict())
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)
    x = _x(5)
    want = np.asarray(_jax_apply(tuple(kw.items()))(params, jnp.asarray(x)), np.float32)
    got = _eval(model, x)
    if kw.get("dtype") == "bfloat16":
        # bf16 rounds at other places (tests/test_torch_model.py's bf16 bound).
        np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)
        import torch

        layer = model.layers[0]
        h = torch.zeros((1, 3, 192), dtype=torch.bfloat16)
        assert layer(h, None, torch.bfloat16)[1].dtype == torch.bfloat16  # the residual
    else:
        np.testing.assert_allclose(got, want, **TOL)
    assert not np.allclose(got, _eval(_port(seed=5), x), atol=1e-3)  # the field counts


# --- remat_mode="auto" ------------------------------------------------------------

def test_remat_auto_resolution(monkeypatch):
    import torch

    from aum_tpu_torch.models.audio_mamba import SPLIT_REMAT_BYTES_PER_ELEMENT, resolve_remat_mode
    from aum_tpu_torch.train import loss_fn_of

    from aum_tpu_torch.models import AudioMamba, AudioMambaConfig

    monkeypatch.delenv("AUM_SPLIT_REMAT_BUDGET", raising=False)
    # A narrower model: only the rule and the grads' equality are tested.
    model = AudioMamba(AudioMambaConfig(**{**BASE, "embed_dim": 32, "remat": True}),
                       device="cpu", seed=6)
    cfg = model.config
    assert cfg.remat_mode == "auto" and model.remat_mode(12, 65) == "split"  # CPU: no budget
    est = cfg.depth * 12 * 65 * 2 * cfg.embed_dim * SPLIT_REMAT_BYTES_PER_ELEMENT[4]
    for budget, mode in ((est, "split"), (est - 1, "block")):
        monkeypatch.setenv("AUM_SPLIT_REMAT_BUDGET", str(budget))
        assert model.remat_mode(12, 65) == mode
        assert resolve_remat_mode(cfg, 12, 65, torch.device("cpu"), 0) == mode
    # The bf16 figure for a bf16 model; no figure for a dtype not measured.
    bf16 = dataclasses.replace(cfg, dtype="bfloat16")
    assert resolve_remat_mode(bf16, 12, 65, torch.device("cpu"), 0) == "split"  # est < fp32's
    with pytest.raises(ValueError, match="float64"):
        resolve_remat_mode(dataclasses.replace(cfg, dtype="float64"), 12, 65,
                           torch.device("cpu"), 0)
    # Whichever it resolves to, the grads are the same.
    x, y = torch.from_numpy(_x(6)), torch.eye(5)[:2]
    grads = []
    for budget in ("1e30", "0"):
        monkeypatch.setenv("AUM_SPLIT_REMAT_BUDGET", budget)
        model.zero_grad(set_to_none=True)
        loss_fn_of("BCE")(model(x, train=True), y).backward()
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
    for k, g in grads[0].items():
        assert torch.equal(grads[1][k], g), k


# --- the flexible-patch train step and loop ------------------------------------------

TRAIN_HP = dict(lr=1e-3, weight_decay=1e-2, warmup=False)


def _recording(tx):
    """tx, keeping the raw grads in its state: the JAX step's grads, read
    back without a second compile."""
    def init(params):
        return jax.tree.map(jnp.zeros_like, params), tx.init(params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[1], params)
        return updates, (grads, inner)

    return optax.GradientTransformation(init, update)


def test_flexible_train_step_matches_jax():
    """One train step at patch 8 (the model's stored patch is 16): the loss,
    every grad and the params after, against ``aum_tpu``'s step built with
    ``patch_size=8``."""
    import torch

    from aum_tpu.train.loop import AugmentConfig, TrainState, make_train_step
    from aum_tpu.train.optim import TrainHyperParams, make_optimizer

    from aum_tpu_torch.convert import state_dict_from_jax
    from aum_tpu_torch.train import TrainHyperParams as PortHP
    from aum_tpu_torch.train import init_train_state
    from aum_tpu_torch.train import make_optimizer as port_optimizer
    from aum_tpu_torch.train import make_train_step as port_step

    model = _port(seed=7)
    params = jax.tree.map(jnp.asarray, _jax_params(model))
    jmodel = JaxAudioMamba(JaxConfig(**BASE), use_kernel=False)
    tx = _recording(make_optimizer(TrainHyperParams(**TRAIN_HP), steps_per_epoch=100))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=tx.init(params),
                       loss_sum=jnp.zeros((), jnp.float32),
                       nonfinite_count=jnp.zeros((), jnp.int32))
    x, y = _x(7), np.eye(5, dtype=np.float32)[[1, 3]]
    step = make_train_step(jmodel, tx, None, "BCE", AugmentConfig(), donate=False, patch_size=8)
    state, want_loss = step(state, {"x": jnp.asarray(x), "y": jnp.asarray(y)},
                            jax.random.PRNGKey(0))
    want_grads = state_dict_from_jax(jax.device_get(state.opt_state[0]), model.config)
    want_params = state_dict_from_jax(jax.device_get(state.params), model.config)

    hp = PortHP(**TRAIN_HP)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    pstate = init_train_state(model, port_optimizer(model.parameters(), hp))
    grads = {}
    for name, p in model.named_parameters():  # the grads, as the step takes them
        p.register_hook(lambda g, name=name: grads.__setitem__(name, g.clone()))
    pstate, loss = port_step(hp, 100, "BCE", patch_size=8)(
        pstate, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    # tests/test_torch_train.py's bounds: the loss, each grad within 1e-4 of
    # its tensor's largest element.
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    assert set(grads) == set(want_grads)
    for k, w in want_grads.items():
        w = w.numpy()
        err = np.abs(grads[k].numpy() - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= 1e-4, (k, err)
    # The params after the Adam step, as chip_smoke.py's TRAIN_FP32_TOL
    # holds them: Adam's first step moves each param by about lr whatever
    # its grad, so a grad within rounding of 0 may move it another way (one
    # element of in_proj by 2.4e-5 here); the error's norm stays within 1e-2
    # of the update's.
    for k, p in model.named_parameters():
        want = want_params[k]
        err = (p.detach() - want).norm().item()
        assert err <= 1e-2 * (want - before[k]).norm().item(), (k, err)


def test_train_loop_patch_sizes_match_jax(monkeypatch):
    """Each step's patch size over two epochs, against ``aum_tpu``'s
    ``train_loop`` (its steps and eval stubbed to record them)."""
    from aum_tpu.train import loop as jloop

    from aum_tpu_torch.train import flexible_patch_schedule
    from aum_tpu_torch.train import loop as ploop

    sizes = [8, 12, 16]
    batches = [{"x": np.zeros((1, 1), np.float32)}] * 3

    def run(mod, call):
        seen = []

        def make_train_step(*a, **k):
            return lambda state, batch, *rest: (seen.append(k.get("patch_size")) or state, 0.0)

        metrics = {"main": 0.0, "mAP": 0.0, "AUC": 0.0, "acc": 0.0, "d_prime": 0.0, "loss": 0.0}
        monkeypatch.setattr(mod, "make_train_step", make_train_step)
        monkeypatch.setattr(mod, "make_eval_step", lambda *a, **k: None)
        monkeypatch.setattr(mod, "evaluate", lambda *a, **k: (dict(metrics), None, None, None))
        monkeypatch.setattr(mod, "reset_loss_accum", lambda s: s)
        call(types.SimpleNamespace(step=0, loss_sum=0.0, nonfinite_count=0, params=None,
                                       model=None))
        return seen

    want = run(jloop, lambda s: jloop.train_loop(
        None, None, None, lambda e: batches, lambda: [], 2, s, jax.random.PRNGKey(0),
        flexible_patch_sizes=sizes))
    got = run(ploop, lambda s: ploop.train_loop(
        s, None, 3, lambda e: batches, lambda: [], 2, flexible_patch_sizes=sizes))
    assert got == want == flexible_patch_schedule(sizes, 6)
    assert want[:5] == [16, 16, 16, 12, 8]  # chip_smoke.py's flex recipe reaches every size
