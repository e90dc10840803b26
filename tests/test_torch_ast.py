"""The PyTorch port's AST baseline and its checkpoint porters against the JAX package, on the CPU.

- ``models/ast.py::ASTModel`` against ``aum_tpu.models.ast.ASTModel`` on the
  JAX init's weights (carried over by ``convert.ast_state_dict_from_jax``):
  fp32 and bf16 logits, plain and distilled;
- ``retarget_pos_embed`` (crop and interpolation) against JAX's;
- ``convert/ast_port.py``: a timm DeiT (the RGB sum, the square grid, the
  non-square refusal) and a reference AST audio checkpoint (the head kept
  and dropped), each ported by both packages: the weights, and the logits;
- one depth-2 AST train step (``train.make_train_step``): its loss and
  every grad against ``jax.value_and_grad`` of the JAX model under the JAX
  train step's BCE (``aum_tpu/train/loop.py::loss_fn_of``, written out here
  so that the module does not import ``aum_tpu.train``);
- the runner refusing ``aum_drop_path`` for ``model=ast``.

Inputs are drawn with numpy from fixed seeds; the JAX models are built and
compiled once per module. torch is imported inside the tests, as in the
other port test modules.
"""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

from aum_tpu.convert import ast_port as jax_ast_port
from aum_tpu.convert.torch_port import merge_with_init as jax_merge_with_init
from aum_tpu.models import ast as jax_ast

# A 64 x 32 (T x F) input at stride 10: a (2, 5) grid of overlapping patches.
TINY = dict(label_dim=5, input_fdim=32, input_tdim=64, fstride=10, tstride=10, depth=2,
            embed_dim=64, num_heads=4)


def _x(seed, bsz=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((bsz, TINY["input_tdim"], TINY["input_fdim"])).astype(np.float32)


def _max_rel(got, want):
    """max |got - want| over max |want| (each tensor's own scale)."""
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@functools.lru_cache(maxsize=None)
def _jax_init(distilled):
    cfg = jax_ast.ASTConfig(**TINY, distilled=distilled)
    init = jax.jit(jax_ast.ASTModel(cfg).init)
    return jax.device_get(init(jax.random.PRNGKey(3 + distilled), jnp.asarray(_x(0, 1))))


@functools.lru_cache(maxsize=None)
def _jax_model(distilled=False, dtype="float32"):
    """(cfg, model, params as numpy, jitted apply): the JAX init (one per
    readout; the compute dtype does not change the params)."""
    cfg = jax_ast.ASTConfig(**TINY, distilled=distilled, dtype=dtype)
    model = jax_ast.ASTModel(cfg)
    return cfg, model, _jax_init(distilled), jax.jit(model.apply)


def _port(params, distilled=False, dtype="float32"):
    from aum_tpu_torch.convert import ast_state_dict_from_jax
    from aum_tpu_torch.models.ast import ASTConfig, ASTModel

    cfg = ASTConfig(**TINY, distilled=distilled, dtype=dtype)
    model = ASTModel(cfg, device="cpu")
    model.load_state_dict(ast_state_dict_from_jax(params, cfg))
    return model


def _logits(model, x):
    import torch

    with torch.no_grad():
        return model(torch.from_numpy(x)).float().numpy()


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("distilled", [False, True], ids=["plain", "distilled"])
def test_ast_model_matches_jax(distilled, dtype, tol):
    cfg, _, params, apply = _jax_model(distilled, dtype)
    x = _x(1)
    want = np.asarray(apply(params, jnp.asarray(x)), np.float32)
    got = _logits(_port(params, distilled, dtype), x)
    assert got.shape == want.shape == (3, TINY["label_dim"])
    # fp32: sums in other orders; bf16: both round at the same places
    # (matmul outputs, residual adds), the softmax and the query scale at
    # others.
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_ast_init_matches_jax_shapes_and_scales():
    """The port's init: JAX's keys and shapes (through the converter), and
    each weight's spread within 20% of the JAX init's."""
    import torch

    from aum_tpu_torch.convert import ast_state_dict_from_jax
    from aum_tpu_torch.models.ast import ASTConfig, ASTModel

    cfg, _, params, _ = _jax_model()
    want = ast_state_dict_from_jax(params, cfg)
    got = ASTModel(ASTConfig(**TINY), device="cpu", seed=5).state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    for k in got:
        if got[k].numel() > 64 and float(want[k].std()) > 0:
            ratio = float(got[k].std()) / float(want[k].std())
            assert 0.8 < ratio < 1.2, (k, ratio)
        elif k.endswith("bias"):
            assert torch.equal(got[k], want[k]), k  # zeros


@pytest.mark.parametrize("old,new", [((6, 8), (4, 5)), ((3, 4), (5, 7)), ((6, 4), (3, 9))],
                         ids=["crop", "interpolate", "crop_f_interpolate_t"])
def test_retarget_pos_embed_matches_jax(old, new):
    from aum_tpu_torch.models.ast import retarget_pos_embed

    pos = np.random.default_rng(2).standard_normal((1, 2 + old[0] * old[1], 16)).astype(
        np.float32)
    want = jax_ast.retarget_pos_embed(pos, old, new, 2)
    got = retarget_pos_embed(pos, old, new, 2)
    assert got.shape == want.shape == (1, 2 + new[0] * new[1], 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _deit(seed, grid, channels=3, depth=TINY["depth"], d=TINY["embed_dim"], distilled=False):
    """A timm DeiT state dict (numpy) with random weights."""
    rng = np.random.default_rng(seed)

    def r(*s):
        return (rng.standard_normal(s) * 0.1).astype(np.float32)

    n_prefix = 2 if distilled else 1
    sd = {"cls_token": r(1, 1, d), "pos_embed": r(1, n_prefix + grid[0] * grid[1], d),
          "patch_embed.proj.weight": r(d, channels, 16, 16), "patch_embed.proj.bias": r(d),
          "norm.weight": 1 + r(d), "norm.bias": r(d)}
    if distilled:
        sd["dist_token"] = r(1, 1, d)
    for i in range(depth):
        p = f"blocks.{i}."
        sd.update({p + "attn.qkv.weight": r(3 * d, d), p + "attn.qkv.bias": r(3 * d),
                   p + "attn.proj.weight": r(d, d), p + "attn.proj.bias": r(d),
                   p + "norm1.weight": 1 + r(d), p + "norm1.bias": r(d),
                   p + "norm2.weight": 1 + r(d), p + "norm2.bias": r(d),
                   p + "mlp.fc1.weight": r(4 * d, d), p + "mlp.fc1.bias": r(4 * d),
                   p + "mlp.fc2.weight": r(d, 4 * d), p + "mlp.fc2.bias": r(d)})
    return sd


def _check_ported(jax_ported, ported, distilled=False):
    """The port's ported state dict against the JAX package's ported tree
    (merged over the JAX init): the same keys and values, exactly; and the
    logits of both, merged over the same init."""
    from aum_tpu_torch.convert import ast_state_dict_from_jax, merge_with_init

    cfg, _, init, apply = _jax_model(distilled)
    jparams = jax_merge_with_init(jax_ported, init)
    want_sd = ast_state_dict_from_jax(jax.device_get(jparams), cfg)
    for k, v in ported.items():
        np.testing.assert_array_equal(v.numpy(), want_sd[k].numpy(), err_msg=k)
    model = _port(init, distilled)  # the JAX init, under the ported keys
    model.load_state_dict(merge_with_init(ported, model.state_dict()))
    x = _x(4)
    want = np.asarray(apply(jparams, jnp.asarray(x)))
    np.testing.assert_allclose(_logits(model, x), want, rtol=1e-5, atol=1e-5)
    return want_sd


@pytest.mark.parametrize("grid,channels", [((4, 4), 3), ((2, 5), 1)],
                         ids=["rgb_square", "one_channel_at_target_grid"])
def test_port_deit_matches_jax(grid, channels):
    from aum_tpu_torch.convert import port_deit_state_dict
    from aum_tpu_torch.models.ast import ASTConfig

    sd = _deit(6, grid, channels)
    kw = {} if grid[0] == grid[1] else {"source_grid": grid}
    cfg = ASTConfig(**TINY)
    ported = port_deit_state_dict({k: v.copy() for k, v in sd.items()}, cfg, **kw)
    jported = jax_ast_port.port_deit_state_dict(sd, _jax_model()[0], **kw)
    assert not any(k.startswith("mlp_head") for k in ported)  # the head: the init's
    _check_ported(jported, ported)
    # The RGB sum (not the mean) of the patch kernel.
    np.testing.assert_allclose(ported["v.patch_embed.proj.weight"].numpy(),
                               sd["patch_embed.proj.weight"].sum(axis=1, keepdims=True),
                               rtol=0, atol=0)
    if grid[0] != grid[1]:
        with pytest.raises(ValueError, match="not a square grid"):
            port_deit_state_dict(sd, cfg)


@pytest.mark.parametrize("label_dim", [TINY["label_dim"], 7], ids=["head_kept", "head_dropped"])
def test_port_ast_pretrain_matches_jax(label_dim):
    """A reference AST audio checkpoint (``module.v.`` + ``module.mlp_head.``)
    at a (4, 3) pretrain grid (to the (2, 5) target: a frequency crop and a
    time interpolation), exported by the JAX package from its init."""
    from aum_tpu_torch.convert import port_ast_pretrain_state_dict
    from aum_tpu_torch.models.ast import ASTConfig

    pre = jax_ast.ASTConfig(**{**TINY, "label_dim": label_dim, "input_fdim": 48,
                               "input_tdim": 36})
    assert pre.patch_grid == (4, 3)
    pre_params = jax.jit(jax_ast.ASTModel(pre).init)(jax.random.PRNGKey(8),
                                                     jnp.zeros((1, 36, 48), jnp.float32))
    sd = {"module." + k: v for k, v in jax_ast_port.export_ast_state_dict(pre_params,
                                                                          pre).items()}
    cfg = ASTConfig(**TINY)
    ported = port_ast_pretrain_state_dict(sd, cfg, pretrain_grid=(4, 3))
    jported = jax_ast_port.port_ast_pretrain_state_dict(sd, _jax_model()[0],
                                                        pretrain_grid=(4, 3))
    assert ("mlp_head.1.weight" in ported) == (label_dim == TINY["label_dim"])
    _check_ported(jported, ported)


def test_export_ast_state_dict_matches_jax():
    from aum_tpu_torch.convert import export_ast_state_dict

    cfg, _, params, _ = _jax_model(distilled=True)
    want = jax_ast_port.export_ast_state_dict(params, cfg)
    got = export_ast_state_dict(_port(params, distilled=True))
    assert list(got) != [] and set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_ast_train_step_matches_jax():
    """One train step (BCE, Adam) of the depth-2 AST on the same weights:
    the loss and every grad Adam receives."""
    import torch

    from aum_tpu_torch.convert import ast_state_dict_from_jax
    from aum_tpu_torch.train import (
        TrainHyperParams,
        init_train_state,
        make_optimizer,
        make_train_step,
    )

    cfg, model, params, _ = _jax_model()
    x = _x(5, bsz=4)
    y = np.eye(TINY["label_dim"], dtype=np.float32)[np.arange(4) % TINY["label_dim"]]

    def loss_f(p):  # the JAX step's loss: loss_fn_of("BCE") on the train-mode logits
        logits = model.apply(p, jnp.asarray(x), train=True)
        return jnp.mean(optax.sigmoid_binary_cross_entropy(logits.astype(jnp.float32),
                                                           jnp.asarray(y)))

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_f))(params)
    want_grads = ast_state_dict_from_jax(jax.device_get(jgrads), cfg)

    hp = TrainHyperParams(lr=1e-3, weight_decay=1e-2, warmup=False)
    port = _port(params)
    state = init_train_state(port, make_optimizer(port.parameters(), hp))
    grads, step_opt = {}, state.optimizer.step

    def recording_step(*a, **k):
        grads.update({n: p.grad.detach().clone() for n, p in port.named_parameters()})
        return step_opt(*a, **k)

    state.optimizer.step = recording_step
    state, loss = make_train_step(hp, 100, "BCE")(
        state, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    assert set(grads) == set(want_grads) and state.step == 1
    for k, w in want_grads.items():
        assert _max_rel(grads[k].numpy(), w.numpy()) <= 1e-3, k


def test_run_refuses_drop_path_for_ast():
    from aum_tpu_torch.configs import RECIPES, ast_variant
    from aum_tpu_torch.run import build_model

    cfg = dataclasses.replace(ast_variant("speechcommands/aum-base_scratch"), aum_drop_path=0.1)
    assert cfg is not RECIPES["speechcommands/aum-base_scratch"]
    with pytest.raises(ValueError, match="aum_drop_path has no effect on the AST model"):
        build_model(cfg, "cpu")
