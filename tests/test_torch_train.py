"""The PyTorch port's train path (``aum_tpu_torch``) against the JAX package, on the CPU.

- the scan and conv under autograd: every grad of the port's ops (on the CPU
  their plain versions, so this tests the autograd wiring: the dt prep and
  its chain rule, dbias, v1's shared tensors, strided views) against
  ``jax.grad`` of the JAX ops, whose Pallas kernels (``_fwd_kernel_dual``
  with saved states, ``_bwd_kernel``, ``_conv_kernel``) run in interpret
  mode, as the JAX package's own tests run them;
- the plain forward's saved chunk-entry states against the JAX oracle's
  final state on each prefix (suffix, in reverse);
- the norm, the model's loss and every parameter grad, and two train steps
  against ``aum_tpu.train.loop.make_train_step``;
- the step's semantics: ``accum_steps``, the non-finite skip, the lr
  schedule, remat modes and drop path;
- hygiene: the backward on CPU tensors launches no kernel.

Inputs are drawn with numpy from fixed seeds and handed to both frameworks.
torch is imported inside the tests, as in the other port test modules.
"""

import copy
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

from aum_tpu.convert.torch_port import port_aum_state_dict
from aum_tpu.ops import conv1d as jconv
from aum_tpu.ops import norms as jnorms
from aum_tpu.ops.scan_ref import selective_scan_ref as jscan_ref
from aum_tpu.ops.selective_scan import selective_scan_dual as jscan_dual
from scripts.record_goldens import build_flax, golden_input

SCAN_NAMES = ("u", "delta", "A", "B", "C", "D", "z", "bias")
# Streams (u, delta, B, C, z) take the test dtype; A, D and the bias stay fp32.
_STREAMS = (0, 1, 3, 4, 6)


def _torch(a, dtype="float32", grad=False):
    import torch

    t = torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dtype))
    return t.requires_grad_(grad)


def _np(t):
    return t.detach().float().numpy()


def _scan_args(seed, bsz=2, seqlen=37, d=8, n=16):
    """(u, delta, A, B, C, D, z, delta_bias) as fp32 numpy arrays."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((bsz, seqlen, d)),
            rng.standard_normal((bsz, seqlen, d)) * 0.5,
            -np.exp(rng.standard_normal((d, n)) * 0.5),
            rng.standard_normal((bsz, seqlen, n)),
            rng.standard_normal((bsz, seqlen, n)),
            rng.standard_normal(d),
            rng.standard_normal((bsz, seqlen, d)),
            rng.standard_normal(d) * 0.1]


def _max_rel(got, want):
    """max |got - want| over max |want| (each tensor's own scale)."""
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# fp32: JAX's own bound for its kernel's grads against its oracle
# (tests/test_selective_scan.py). bf16: both sides take the same bf16 inputs
# and the same rounded dt, sum in fp32 in different orders and round du,
# ddelta, dz, dB, dC to bf16 (2^-8 relative), so a grad may differ by a few
# bf16 ulps of its largest element; measured up to ~8e-3 of it.
SCAN_GRAD_TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def _jax_dual_loss(fwd, rev, w_f, w_r):
    yf, yr = jscan_dual(fwd, rev, d_block=8, l_chunk=8)
    return jnp.sum(yf.astype(jnp.float32) * w_f) + jnp.sum(yr.astype(jnp.float32) * w_r)


# Both directions' grads; one compile per dtype serves v1 and v2.
_jax_dual_grads = jax.jit(jax.grad(_jax_dual_loss, argnums=(0, 1)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shared", [True, False], ids=["v1_shared", "v2_separate"])
def test_scan_grads_match_jax_kernels(shared, dtype):
    """All grads of the dual scan against JAX's save_states forward +
    _bwd_kernel (interpret mode) at L=37 (overhang for JAX's l_chunk=8).
    v1 hands its shared operands to both JAX directions and sums their two
    grads, as autodiff does for an operand used twice."""
    from aum_tpu_torch.ops import selective_scan_dual

    rng = np.random.default_rng(9)
    args_f = _scan_args(31)
    args_r = _scan_args(32)
    w_f, w_r = (rng.standard_normal(args_f[0].shape) for _ in range(2))
    if shared:  # bimamba v1: one set of operands, its own A_b
        leaves = args_f + [args_f[2] * 0.5]

        def split(ls):
            return tuple(ls[:8]), tuple(ls[:2]) + (ls[8],) + tuple(ls[3:8])
    else:
        leaves = args_f + args_r

        def split(ls):
            return tuple(ls[:8]), tuple(ls[8:])
    kinds = [i % 8 for i in range(16)] if not shared else list(range(8)) + [2]

    jl = [jnp.asarray(a, dtype if k in _STREAMS else "float32")
          for a, k in zip(leaves, kinds)]
    g_f, g_r = _jax_dual_grads(*split(jl), jnp.asarray(w_f, jnp.float32),
                               jnp.asarray(w_r, jnp.float32))
    if shared:  # A and A_b are each one direction's; the rest are summed
        want = [g_f[i] if i == 2 else g_f[i] + g_r[i] for i in range(8)] + [g_r[2]]
    else:
        want = list(g_f) + list(g_r)
    tl = [_torch(a, dtype if k in _STREAMS else "float32", grad=True)
          for a, k in zip(leaves, kinds)]
    yf, yr = selective_scan_dual(*split(tl))
    ((yf.float() * _torch(w_f)).sum() + (yr.float() * _torch(w_r)).sum()).backward()
    for i, (t, w) in enumerate(zip(tl, want)):
        assert str(t.grad.dtype) == f"torch.{np.dtype(w.dtype).name}", i
        err = _max_rel(_np(t.grad), np.asarray(w, np.float32))
        assert err <= SCAN_GRAD_TOL[dtype], (SCAN_NAMES[kinds[i]], i, err)


@pytest.mark.parametrize("reverse", [False, True])
def test_plain_saved_states_match_jax_oracle(reverse):
    """xb[:, c] is the state after c * STATE_CHUNK processed steps: the JAX
    oracle's final state on that prefix (reverse: suffix)."""
    import torch

    from aum_tpu_torch.ops.selective_scan import (
        STATE_CHUNK,
        _prep_dt,
        selective_scan_dual_plain,
    )

    seqlen = 2 * STATE_CHUNK + 9  # three chunks, the last one short
    u, delta, A, B, C, D, z, bias = _scan_args(5, bsz=1, seqlen=seqlen, d=8, n=4)
    dt = _prep_dt(_torch(delta), _torch(bias))
    args = (_torch(u), dt, _torch(A), _torch(B), _torch(C), _torch(D), _torch(z))
    *_, xb_f, xb_r = selective_scan_dual_plain(args, args, save_states=True)
    xb = xb_r if reverse else xb_f
    assert tuple(xb.shape) == (1, 3, 4, 8) and xb.dtype == torch.float32
    assert float(xb[:, 0].abs().max()) == 0.0
    for c in (1, 2):
        sl = slice(seqlen - c * STATE_CHUNK, None) if reverse else slice(0, c * STATE_CHUNK)
        _, last = jscan_ref(*(jnp.asarray(a[:, sl]) for a in (u, dt.numpy())),
                            jnp.asarray(A), jnp.asarray(B[:, sl]), jnp.asarray(C[:, sl]),
                            reverse=reverse, return_last_state=True)
        # fp32 recurrences over up to 128 steps, exp vs exp: 1e-5.
        np.testing.assert_allclose(xb[:, c].transpose(1, 2).numpy(), np.asarray(last),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("activation", ["silu", None])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("reverse", [False, True])
def test_conv_grads_match_jax(reverse, with_bias, activation):
    from aum_tpu_torch.ops import causal_conv1d

    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 37, 24))
    w = rng.uniform(-0.5, 0.5, (24, 4))
    b = rng.uniform(-0.5, 0.5, 24) if with_bias else None
    gout = rng.standard_normal((2, 37, 24))
    leaves = [x, w] + ([b] if with_bias else [])

    def jloss(conv, *ls):
        out = conv(ls[0], ls[1], ls[2] if with_bias else None, activation=activation,
                   reverse=reverse)
        return jnp.sum(out * gout)

    kernel = functools.partial(jconv.causal_conv1d, use_kernel=True, interpret=True)
    argnums = tuple(range(1, len(leaves) + 1))
    want_k = jax.grad(jloss, argnums)(kernel, *map(jnp.asarray, leaves))
    want_x = jax.grad(jloss, argnums)(jconv.causal_conv1d_xla, *map(jnp.asarray, leaves))
    tl = [_torch(a, grad=True) for a in leaves]
    out = causal_conv1d(tl[0], tl[1], tl[2] if with_bias else None,
                        activation=activation, reverse=reverse)
    (out * _torch(gout)).sum().backward()
    for t, wk, wx in zip(tl, want_k, want_x):
        # fp32 on every side; sums in other orders (the XLA form's autodiff
        # takes another route to the same grads).
        np.testing.assert_allclose(_np(t.grad), np.asarray(wk), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_np(t.grad), np.asarray(wx), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_residual", [False, True])
def test_norm_grads_match_jax(with_residual):
    from aum_tpu_torch.ops import fused_add_norm

    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 9, 32)) * 2.0
    res = rng.standard_normal((2, 9, 32))
    w = 1.0 + 0.1 * rng.standard_normal(32)
    g_y, g_res = rng.standard_normal((2, 9, 32)), rng.standard_normal((2, 9, 32))
    leaves = [x, w] + ([res] if with_residual else [])

    def jloss(*ls):
        y, r = jnorms.fused_add_norm(ls[0], ls[1], residual=ls[2] if with_residual else None,
                                     prenorm=True)
        return jnp.sum(y * g_y) + jnp.sum(r * g_res)

    want = jax.grad(jloss, tuple(range(len(leaves))))(*map(jnp.asarray, leaves))
    tl = [_torch(a, grad=True) for a in leaves]
    y, r = fused_add_norm(tl[0], tl[1], residual=tl[2] if with_residual else None,
                          prenorm=True)
    ((y * _torch(g_y)).sum() + (r * _torch(g_res)).sum()).backward()
    for t, wv in zip(tl, want):
        # fp32 norms, reduction orders differ.
        np.testing.assert_allclose(_np(t.grad), np.asarray(wv), rtol=1e-5, atol=1e-5)


# --- the model and the train step --------------------------------------------

def _tiny_kw(bimamba):
    # remat off in both frameworks: the same numbers, a smaller JAX compile
    # (the port's remat modes are tested against each other below).
    return dict(spectrogram_size=(32, 64), depth=2, embed_dim=32, d_state=16,
                num_classes=5, bimamba_type=bimamba, remat=False)


def _tiny_port(bimamba, **overrides):
    """The tiny model of the port, weights from a fixed seed."""
    from aum_tpu_torch.models import AudioMamba, AudioMambaConfig

    return AudioMamba(AudioMambaConfig(**{**_tiny_kw(bimamba), **overrides}),
                      device="cpu", seed=21)


@functools.lru_cache(maxsize=None)
def _tiny_jax(bimamba):
    """(JAX config, JAX model, params as numpy) with the port's weights,
    carried over by the JAX package's porter (no JAX init to compile)."""
    jcfg, jmodel = build_flax(_tiny_kw(bimamba))
    sd = {k: v.detach().numpy() for k, v in _tiny_port(bimamba).state_dict().items()}
    return jcfg, jmodel, port_aum_state_dict(sd, jcfg)


def _batch(seed, bsz=4, classes=5):
    x = golden_input(_tiny_jax("v1")[0], seed)
    x = np.concatenate([x, x[::-1] * 0.5])[:bsz]
    y = np.eye(classes, dtype=np.float32)[np.arange(bsz) % classes]
    return x, y


TRAIN_HP = dict(lr=1e-3, weight_decay=1e-2, warmup=False)
TRAIN_STEPS = 2


def _recording(tx):
    """tx, keeping the raw grads it was given in its state: the JAX step's
    grads, read back without a second compile of its value_and_grad."""
    def init(params):
        return jax.tree.map(jnp.zeros_like, params), tx.init(params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[1], params)
        return updates, (grads, inner)

    return optax.GradientTransformation(init, update)


@functools.lru_cache(maxsize=None)
def _jax_train(bimamba):
    """TRAIN_STEPS steps of ``aum_tpu.train.loop.make_train_step`` on the
    tiny model from the port's weights, on ``_batch(3)``: per step (loss,
    grads, params after), as numpy trees."""
    from aum_tpu.train.loop import AugmentConfig, TrainState, make_train_step
    from aum_tpu.train.optim import TrainHyperParams, make_optimizer

    jcfg, jmodel, params = _tiny_jax(bimamba)
    tx = _recording(make_optimizer(TrainHyperParams(**TRAIN_HP), steps_per_epoch=100))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=jax.tree.map(jnp.asarray, params),
                       opt_state=tx.init(params), loss_sum=jnp.zeros((), jnp.float32),
                       nonfinite_count=jnp.zeros((), jnp.int32))
    step = make_train_step(jmodel, tx, None, "BCE", AugmentConfig(), donate=False)
    x, y = _batch(3)
    out = []
    for i in range(TRAIN_STEPS):
        state, loss = step(state, {"x": jnp.asarray(x), "y": jnp.asarray(y)},
                           jax.random.PRNGKey(i))
        out.append((float(loss), jax.device_get(state.opt_state[0]),
                    jax.device_get(state.params)))
    return out


def _port_train(accum_steps=1):
    from aum_tpu_torch.train import (
        TrainHyperParams,
        init_train_state,
        make_optimizer,
        make_train_step,
    )

    hp = TrainHyperParams(**TRAIN_HP)
    model = _tiny_port("v1", remat=True, remat_mode="split")
    state = init_train_state(model, make_optimizer(model.parameters(), hp))
    return state, make_train_step(hp, 100, "BCE", accum_steps=accum_steps)


def _torch_batch():
    import torch

    x, y = _batch(3)
    return {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}


@pytest.fixture(scope="module")
def port_run():
    """TRAIN_STEPS port steps on ``_batch(3)``, from the weights ``_jax_train``
    starts from: per step (loss, params after as numpy), the final state,
    and a copy of the state after the first step."""
    state, step = _port_train()
    steps, after_first = [], None
    for i in range(TRAIN_STEPS):
        state, loss = step(state, _torch_batch())
        # Copies: the next step updates the params in place.
        steps.append((float(loss), {k: _np(p).copy() for k, p in state.model.named_parameters()}))
        if i == 0:
            after_first = copy.deepcopy(state)
    return {"steps": steps, "state": state, "after_first": after_first}


@pytest.mark.parametrize("bimamba", ["v1", "v2"])
def test_model_loss_and_grads_match_jax(bimamba):
    """The loss and every parameter grad against those of JAX's first train
    step (``jax.value_and_grad`` of the model in train mode, BCE)."""
    import torch

    from aum_tpu_torch.convert import state_dict_from_jax
    from aum_tpu_torch.train import loss_fn_of

    want_loss, grads, _ = _jax_train(bimamba)[0]
    x, y = _batch(3)
    model = _tiny_port(bimamba)
    loss = loss_fn_of("BCE")(model(torch.from_numpy(x), train=True), torch.from_numpy(y))
    loss.backward()
    # fp32 on both sides; reduction orders differ.
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    want = state_dict_from_jax(grads, model.config)
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for k, w in want.items():
        # Each grad within 1e-4 of its tensor's largest element (fp32, sums
        # in other orders through 2 layers and the scan adjoint).
        assert _max_rel(_np(got[k]), w.numpy()) <= 1e-4, k


def test_two_train_steps_match_jax(port_run):
    from aum_tpu_torch.convert import state_dict_from_jax

    config = port_run["state"].model.config
    for (loss, params), (want_loss, _, want_params) in zip(port_run["steps"],
                                                           _jax_train("v1")):
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        want_sd = state_dict_from_jax(want_params, config)
        assert set(params) == set(want_sd)
        for k, p in params.items():
            # Adam moves every param by about lr (1e-3) whatever its grad's
            # size, so where a grad is near zero its fp32 rounding noise sets
            # the step: 2% of one lr (measured up to 8.7e-6 after 2 steps).
            np.testing.assert_allclose(p, want_sd[k].numpy(), rtol=1e-5, atol=2e-5, err_msg=k)
    assert port_run["state"].step == 2 and port_run["state"].nonfinite_count == 0


def test_accum_steps_equal_full_batch_step(port_run):
    state, step = _port_train(accum_steps=2)
    state, loss = step(state, _torch_batch())
    full_loss, full_params = port_run["steps"][0]
    # Equal microbatches: the mean of their mean losses and grads is the
    # full-batch step, up to fp32 summation order.
    np.testing.assert_allclose(float(loss), full_loss, rtol=1e-6)
    for k, p in state.model.named_parameters():
        np.testing.assert_allclose(_np(p), full_params[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_nonfinite_loss_skips_the_update_but_advances_the_schedule(port_run):
    import torch

    from aum_tpu_torch.train import TrainHyperParams, make_train_step

    state = copy.deepcopy(port_run["after_first"])  # Adam's state keyed by the copy's params
    assert all(p in state.optimizer.state for p in state.model.parameters())
    good = port_run["steps"][0][0]
    step = make_train_step(TrainHyperParams(**TRAIN_HP), 100, "BCE")
    batch = _torch_batch()
    params = [p.detach().clone() for p in state.model.parameters()]
    opt_state = {k: (v["step"].clone(), v["exp_avg"].clone(), v["exp_avg_sq"].clone())
                 for k, v in state.optimizer.state.items()}
    state, loss = step(state, {"x": torch.full_like(batch["x"], float("nan")), "y": batch["y"]})
    assert not torch.isfinite(loss)
    for a, b in zip(params, state.model.parameters()):
        assert torch.equal(a, b)
    for k, (n, m, v) in opt_state.items():
        now = state.optimizer.state[k]
        assert torch.equal(now["step"], n) and float(n) == 1.0
        assert torch.equal(now["exp_avg"], m) and torch.equal(now["exp_avg_sq"], v)
    assert state.step == 2 and state.nonfinite_count == 1
    assert state.loss_sum == float(good)


def test_lr_at_step_matches_jax():
    from aum_tpu_torch.train import TrainHyperParams, lr_at_step

    from aum_tpu.train.optim import TrainHyperParams as JaxHP
    from aum_tpu.train.optim import lr_at_step as jax_lr_at_step

    cases = [  # (hyperparameters, steps per epoch)
        (dict(lr=1e-4, warmup=True), 2000),
        (dict(lr=1e-4, warmup=True), 130),  # warmup spanning epochs
        (dict(lr=1e-4, warmup=True, bs_scale_factor=4, lrscheduler_start=20), 2000),  # w % q
        (dict(lr=1e-4, warmup=False, lrscheduler_start=1, lrscheduler_step=2), 50),
        (dict(lr=1e-3, epic=True, warmup=True), 100),
        (dict(lr=1e-3, epic=True, warmup=False), 100),
    ]
    steps = sorted({0, 1, 49, 50, 51, 240, 245, 250, 260, 300, 349, 999, 1000, 1030,
                    1040, 1500, 2100, 2500, 4500, 6500} | set(range(0, 3000, 97)))
    for kw, spe in cases:
        got = [lr_at_step(TrainHyperParams(**kw), s, spe) for s in steps]
        want = [float(jax_lr_at_step(JaxHP(**kw), s, spe)) for s in steps]
        # JAX computes in fp32, the port in Python floats.
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, err_msg=str(kw))


# --- remat, drop path, hygiene -----------------------------------------------

def _grads(model, x, y, **kw):
    import torch

    from aum_tpu_torch.train import loss_fn_of

    model.zero_grad(set_to_none=True)
    loss_fn_of("BCE")(model(torch.from_numpy(x), train=True, **kw),
                      torch.from_numpy(y)).backward()
    return {k: p.grad.clone() for k, p in model.named_parameters()}


def test_remat_modes_give_identical_grads():
    import torch

    from aum_tpu_torch.models import AudioMamba, AudioMambaConfig

    x, y = _batch(2)
    base = _grads(_tiny_port("v1"), x, y)
    for mode in ("none", "block", "split"):
        got = _grads(_tiny_port("v1", remat=True, remat_mode=mode), x, y)
        for k, g in base.items():
            assert torch.equal(got[k], g), (mode, k)  # the same ops, recomputed
    with pytest.raises(NotImplementedError, match="auto"):
        AudioMamba(AudioMambaConfig(**{**_tiny_kw("v1"), "remat": True, "remat_mode": "auto"}),
                   device="cpu")


def test_drop_path_rates_follow_the_jax_rule():
    from aum_tpu_torch.models.audio_mamba import drop_path_rates

    for rate, depth in ((0.1, 24), (0.3, 5), (0.0, 3)):
        # The JAX model's rule (audio_mamba.py, use_dp branch), in numpy.
        dpr = np.linspace(0.0, rate, depth)
        want = np.concatenate([[0.0], dpr[:-1]]).astype(np.float32)
        np.testing.assert_array_equal(drop_path_rates(rate, depth), want)


def test_drop_path_masks_whole_samples():
    import torch

    from aum_tpu_torch.models.audio_mamba import _drop, keep_mask

    x = torch.randn((64, 5, 3), generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    same, keep = keep_mask((64, 1, 1), 0.0, g, "cpu")
    assert keep == 1.0 and torch.equal(_drop(x, same, keep), x)  # rate 0: identity
    mask, keep = keep_mask((64, 1, 1), 0.5, g, "cpu")
    out = _drop(x, mask, keep)
    dropped = (out == 0).flatten(1).all(1)
    kept = torch.isclose(out, x / 0.5).flatten(1).all(1)
    assert torch.equal(dropped | kept, torch.ones(64, dtype=torch.bool))
    assert 0 < int(dropped.sum()) < 64


def test_block_remat_reuses_the_drop_path_masks():
    """Masks are drawn outside the checkpoint, so the recompute of a block
    sees the same mask as its forward: grads equal the no-remat ones."""
    import torch

    x, y = _batch(4)
    grads = [_grads(_tiny_port("v1", remat=True, remat_mode=mode, drop_path_rate=0.5,
                               drop_rate=0.2),
                    x, y, generator=torch.Generator().manual_seed(3))
             for mode in ("none", "block")]
    for k, g in grads[0].items():
        assert torch.equal(grads[1][k], g), k


def test_cpu_backward_launches_no_kernel():
    from aum_tpu_torch.ops import causal_conv1d, selective_scan_bwd, selective_scan_dual

    x, y = _batch(1)
    _grads(_tiny_port("v2", remat=True, remat_mode="split"), x, y)
    assert (selective_scan_dual.launches, selective_scan_dual.save_states_launches,
            selective_scan_bwd.launches, causal_conv1d.launches) == (0, 0, 0, 0)


def test_eval_step_and_unported_augmentation():
    import torch

    from aum_tpu_torch.train import AugmentConfig, TrainHyperParams, make_eval_step
    from aum_tpu_torch.train import make_train_step

    x, _ = _batch(6)
    logits = make_eval_step(_tiny_port("v1"))(torch.from_numpy(x))
    assert logits.shape == (4, 5) and not logits.requires_grad
    for aug in (AugmentConfig(freqm=8), AugmentConfig(timem=8), AugmentConfig(noise=True)):
        with pytest.raises(NotImplementedError):
            make_train_step(TrainHyperParams(), 100, augment=aug)


def test_train_entry_builds_the_workload_and_needs_a_card(monkeypatch):
    import torch

    from aum_tpu_torch.entry import TRAIN_BATCH, train_entry

    step, state, batch = train_entry(device="cpu")
    assert callable(step) and state.step == 0
    assert state.model.config.remat_mode == "split" and state.model.config.depth == 24
    assert tuple(batch["x"].shape) == (TRAIN_BATCH, 1024, 128)
    assert torch.equal(batch["y"].argmax(1), torch.arange(TRAIN_BATCH) % 527)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_entry()
