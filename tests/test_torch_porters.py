"""The PyTorch port's checkpoint porters (``convert/torch_port.py``) against the JAX package's, on the CPU.

Reference-layout ``.pth`` files are written by the JAX package's
``export_aum_state_dict`` (with a ``module.`` prefix, as DDP saves them) and
read by both packages' ``load_torch_checkpoint``. The JAX trees they are
exported from are the port's seeded inits carried into the JAX layout by the
JAX package's own porter, which needs no JAX init to compile. Each port is
then held to the JAX package's:

- the ported state dict against ``state_dict_from_jax`` of JAX's ported
  tree, key for key and bit for bit;
- the logits of the target model after ``merge_with_init`` over the same
  init, fp32 within 1e-5;

for AuM v1 and v2, with and without ``if_bidirectional``, from donors at
the same grid, at a grid to resample, at another patch size and strides
(PI-resize, ``pretrain_fstride``/``tstride``) and with another class count
(the head from the init). Also ``infer_pretrain_grid``, ImageNet ViM
checkpoints (a middle and a double cls, the RGB mean, a resampled token
count that a 128-bin grid also has, read from under the ``model`` key),
``export_aum_state_dict`` and ``save_reference_checkpoint``, and
``merge_with_init``'s rules. torch is imported inside the tests, as in the
other port test modules.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from aum_tpu.convert import torch_port as jax_port
from aum_tpu.models import AudioMambaConfig as JaxConfig
from scripts.record_goldens import build_flax

BASE = dict(depth=2, embed_dim=64, num_classes=5, spectrogram_size=(32, 64))  # (2, 4) grid
COMBOS = {"v1": dict(bimamba_type="v1"), "v1_bidir": dict(bimamba_type="v1", if_bidirectional=True),
          "v2": dict(bimamba_type="v2"), "v2_bidir": dict(bimamba_type="v2", if_bidirectional=True)}
# Donor geometry over BASE, and the porter's keyword arguments.
DONORS = {
    "same_grid": ({}, {}),
    "resampled_grid": ({"spectrogram_size": (128, 64)}, {}),  # (8, 4) -> (2, 4)
    # Patch 8 at strides (8, 4): a (16, 15) grid, found only at the pretrain
    # strides; the kernel PI-resized 8 -> 16.
    "pi_resized_patch": ({"spectrogram_size": (128, 64), "patch_size": (8, 8), "strides": (8, 4)},
                         {"pretrain_fstride": 8, "pretrain_tstride": 4}),
    "class_mismatch": ({"num_classes": 7}, {}),
}


def _port_model(kw, seed):
    from aum_tpu_torch.models import AudioMamba, AudioMambaConfig

    return AudioMamba(AudioMambaConfig(**kw), device="cpu", seed=seed)


def _jax_tree(model, kw):
    """The port model's weights as a JAX parameter tree (the JAX porter)."""
    return jax_port.port_aum_state_dict({k: v.numpy() for k, v in model.state_dict().items()},
                                        JaxConfig(**kw))


def _save_reference(tmp_path, name, tree, kw):
    """A ``.pth`` of JAX's export of ``tree``, keys prefixed ``module.``."""
    import torch

    path = str(tmp_path / f"{name}.pth")
    torch.save({"module." + k: torch.from_numpy(np.array(v))
                for k, v in jax_port.export_aum_state_dict(tree, JaxConfig(**kw)).items()}, path)
    return path


@functools.lru_cache(maxsize=None)
def _target(kw_items):
    """(port model, its JAX tree, jitted JAX apply) of a target config."""
    kw = dict(kw_items)
    model = _port_model(kw, seed=1)
    _, jmodel = build_flax(kw)
    return model, _jax_tree(model, kw), jax.jit(jmodel.apply)


def _check_port(ported, jax_ported, kw, x_seed=0):
    """``ported`` against JAX's ``jax_ported``: the state dicts exactly, then
    the logits of the target merged over the same init."""
    import torch

    from aum_tpu_torch.convert import merge_with_init, state_dict_from_jax
    from aum_tpu_torch.models import AudioMamba, AudioMambaConfig

    cfg = AudioMambaConfig(**kw)
    want = state_dict_from_jax(jax_ported, cfg)
    assert set(ported) == set(want)
    for k, v in ported.items():
        assert v.dtype == torch.float32, k
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)
    init, jinit, apply = _target(tuple(sorted(kw.items())))
    model = AudioMamba(cfg, device="cpu")
    model.load_state_dict(merge_with_init(ported, init.state_dict()))
    rng = np.random.default_rng(x_seed)
    f, t = cfg.spectrogram_size
    x = (rng.standard_normal((2, t, f)) * 0.5).astype(np.float32)
    expected = np.asarray(apply(jax_port.merge_with_init(jax_ported, jinit), jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    # fp32 on both sides; reduction orders differ.
    np.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("donor", list(DONORS))
@pytest.mark.parametrize("combo", list(COMBOS))
def test_port_aum_state_dict_matches_jax(tmp_path, combo, donor):
    from aum_tpu_torch.convert import load_torch_checkpoint, port_aum_state_dict
    from aum_tpu_torch.models import AudioMambaConfig

    kw = {**BASE, **COMBOS[combo]}
    donor_kw, port_kw = DONORS[donor]
    dkw = {**kw, **donor_kw}
    path = _save_reference(tmp_path, donor, _jax_tree(_port_model(dkw, seed=2), dkw), dkw)
    sd = load_torch_checkpoint(path)
    assert all(k.startswith("module.") for k in sd)
    ported = port_aum_state_dict(sd, AudioMambaConfig(**kw), **port_kw)
    jax_ported = jax_port.port_aum_state_dict(jax_port.load_torch_checkpoint(path),
                                              JaxConfig(**kw), **port_kw)
    assert ("head.weight" in ported) == (donor != "class_mismatch")
    _check_port(ported, jax_ported, kw)


@pytest.mark.parametrize("n,patch,strides", [
    (512, (16, 16), (16, 16)), (1212, (16, 16), (10, 10)), (240, (8, 8), (8, 4)),
    (32, (16, 16), (16, 16)), (7, (16, 16), (16, 16))])
def test_infer_pretrain_grid_matches_jax(n, patch, strides):
    import torch

    from aum_tpu_torch.convert import infer_pretrain_grid

    pos = torch.zeros((1, 1 + n, 4))
    try:
        want = jax_port.infer_pretrain_grid(pos.numpy(), patch, strides, 1)
    except ValueError:
        with pytest.raises(ValueError, match="could not infer pretrain grid"):
            infer_pretrain_grid(pos, patch, strides, 1)
        return
    assert infer_pretrain_grid(pos, patch, strides, 1) == want
    assert want[0] * want[1] == n


def _vim_checkpoint(tmp_path, kw, double_cls=False, side=4, seed=3):
    """A random ImageNet ViM checkpoint (Bi-Bi) on a ``side`` x ``side``
    image grid, under the ``model`` key: a 3-channel patch kernel, the cls
    pos embed at its sequence place (the middle, or both ends), 1000
    classes. Returns (path, the numpy state dict)."""
    import torch

    vkw = {**kw, "spectrogram_size": (16 * side, 16 * side), "num_classes": 1000,
           "use_double_cls_token": double_cls}
    sd = {k: v.numpy().copy() for k, v in _port_model(vkw, seed).state_dict().items()}
    pos = sd.pop("pos_embed.pos_embed")
    n_prefix = 2 if double_cls else 1
    grid = pos[:, n_prefix:]
    if double_cls:
        sd["pos_embed"] = np.concatenate([pos[:, :1], grid, pos[:, 1:2]], axis=1)
    else:
        mid = grid.shape[1] // 2
        sd["pos_embed"] = np.concatenate([grid[:, :mid], pos[:, :1], grid[:, mid:]], axis=1)
    d = kw["embed_dim"]
    sd["patch_embed.proj.weight"] = (np.random.default_rng(seed).standard_normal(
        (d, 3, 16, 16)) * 0.05).astype(np.float32)
    path = str(tmp_path / "vim.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}, "epoch": 300}, path)
    return path, sd


@pytest.mark.parametrize("case", ["middle_cls", "double_cls", "count_of_a_128_bin_grid"])
def test_port_vim_imagenet_matches_jax(tmp_path, case):
    from aum_tpu_torch.convert import load_torch_checkpoint, port_vim_imagenet_state_dict
    from aum_tpu_torch.models import AudioMambaConfig

    kw = {**BASE, "bimamba_type": "v2"}
    double = case == "double_cls"
    if double:
        kw["use_double_cls_token"] = True
    side = 4
    if case == "count_of_a_128_bin_grid":
        # A 6 x 6 ViM grid resampled to (8, 4): 32 tokens, the count of a
        # length-64 grid at 128 bins, which must not be resampled again.
        kw["spectrogram_size"], side = (128, 64), 6
    path, vim = _vim_checkpoint(tmp_path, kw, double, side)
    sd = load_torch_checkpoint(path, "model")
    assert set(load_torch_checkpoint(path)) == {"model", "epoch"}
    flags = dict(load_double_cls_token=double)
    ported = port_vim_imagenet_state_dict(sd, AudioMambaConfig(**kw), **flags)
    jax_ported = jax_port.port_vim_imagenet_state_dict(
        jax_port.load_torch_checkpoint(path, "model"), JaxConfig(**kw), **flags)
    assert "head.weight" not in ported
    np.testing.assert_allclose(ported["patch_embed.proj.weight"].numpy(),
                               vim["patch_embed.proj.weight"].mean(axis=1, keepdims=True),
                               rtol=1e-6, atol=1e-7)  # the RGB mean
    _check_port(ported, jax_ported, kw, x_seed=1)


@pytest.mark.parametrize("combo", list(COMBOS))
def test_export_and_save_reference_checkpoint_match_jax(tmp_path, combo):
    import torch

    from aum_tpu_torch.convert import export_aum_state_dict, save_reference_checkpoint

    kw = {**BASE, **COMBOS[combo]}
    model = _port_model(kw, seed=4)
    tree = _jax_tree(model, kw)
    want = jax_port.export_aum_state_dict(tree, JaxConfig(**kw))
    got = export_aum_state_dict(model)
    assert list(got) != [] and set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    save_reference_checkpoint(model, str(tmp_path / "port.pth"))
    jax_port.save_reference_checkpoint(tree, JaxConfig(**kw), str(tmp_path / "jax.pth"))
    a, b = torch.load(tmp_path / "port.pth"), torch.load(tmp_path / "jax.pth")
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def test_merge_with_init_rules():
    import torch

    from aum_tpu_torch.convert import merge_with_init

    init = {"a": torch.zeros(2), "b": torch.ones(3)}
    out = merge_with_init({"a": np.array([1.0, 2.0]), "extra": torch.ones(1)}, init)
    assert set(out) == {"a", "b"}  # the extra key ignored
    assert torch.equal(out["a"], torch.tensor([1.0, 2.0])) and out["b"] is init["b"]
    with pytest.raises(ValueError, match="checkpoint shape"):
        merge_with_init({"b": torch.ones(4)}, init)
