"""The PyTorch port's model (``aum_tpu_torch``) against the JAX package, on the CPU.

- weights: ``state_dict_from_jax`` equals the JAX exporter key for key and
  loads into the port's module tree with ``strict=True``;
- the slice as a whole: the port's AudioMamba, with weights carried from the
  JAX init that recorded ``tests/goldens/``, reproduces the committed
  reference logits of all 8 goldens (Fo-Fo, Fo-Bi, Bi-Bi, if_bidirectional),
  and agrees with ``AudioMamba(cfg, use_kernel=False)`` of the JAX package
  in fp32 and bf16 (Bi-Bi) and in fp32 (Fo-Fo, if_bidirectional);
- hygiene: the package imports neither JAX nor ``aum_tpu``; without a card
  and without ``device=`` the entry points raise; CPU tensors never launch a
  kernel.

torch is imported inside the tests, as in the other test modules that use it.
"""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from aum_tpu.convert.torch_port import export_aum_state_dict, port_aum_state_dict
from scripts.record_goldens import (
    GOLDEN_DIR,
    GOLDENS,
    build_flax,
    golden_input,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The goldens whose variants the port covers: all of them.
PORTED_GOLDENS = ["v1_middle", "v2_middle", "v1_end_cls", "v2_double_cls",
                  "v1_transpose", "v1_depth24_tiny", "none_middle", "none_bidirectional"]


@functools.lru_cache(maxsize=None)
def _golden_params(name):
    """(JAX config, JAX params as numpy) for a golden, from its seeded init
    (``scripts/record_goldens.py::flax_params``, compiled: the same draws)."""
    kwargs, seed = GOLDENS[name]
    cfg, model = build_flax(kwargs)
    f, t = cfg.spectrogram_size
    init = jax.jit(model.init)
    return cfg, jax.device_get(init(jax.random.PRNGKey(seed), jnp.zeros((1, t, f))))


def _eval(model, x):
    """The port's eval forward on a numpy input, as a numpy array."""
    import torch

    with torch.inference_mode():
        return model(torch.from_numpy(x)).float().numpy()


def _port_model(name, **overrides):
    from aum_tpu_torch.convert import state_dict_from_jax
    from aum_tpu_torch.models import AudioMamba, AudioMambaConfig

    cfg = AudioMambaConfig(**{**GOLDENS[name][0], **overrides})
    model = AudioMamba(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(_golden_params(name)[1], cfg),
                          strict=True)
    return model


@pytest.mark.parametrize("name", ["v1_middle", "v2_double_cls", "none_bidirectional"])
def test_state_dict_from_jax_matches_exporter(name):
    import torch

    from aum_tpu_torch.convert import state_dict_from_jax
    from aum_tpu_torch.models import AudioMamba, AudioMambaConfig

    jcfg, params = _golden_params(name)
    cfg = AudioMambaConfig(**GOLDENS[name][0])
    got = state_dict_from_jax(params, cfg)
    want = export_aum_state_dict(params, jcfg)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    model = AudioMamba(cfg, device="cpu")
    assert set(model.state_dict()) == set(got)
    model.load_state_dict(got, strict=True)


@pytest.mark.parametrize("name", PORTED_GOLDENS)
def test_port_reproduces_golden_logits(name):
    import torch

    data = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))
    assert json.loads(str(data["config"])) == {  # the golden is of this config
        k: list(v) if isinstance(v, tuple) else v for k, v in GOLDENS[name][0].items()}
    cfg = _golden_params(name)[0]
    x = golden_input(cfg, int(data["seed"]))
    got = _eval(_port_model(name), x)
    # The bound tests/test_goldens.py holds the JAX package to.
    np.testing.assert_allclose(got, data["logits"], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_matches_jax_model(dtype):
    import torch

    from aum_tpu.models import AudioMamba as JaxAudioMamba

    name = "v2_middle"
    jcfg, params = _golden_params(name)
    jcfg = jcfg.__class__(**{**GOLDENS[name][0], "dtype": dtype})
    x = golden_input(jcfg, 3)
    want = np.asarray(jax.jit(JaxAudioMamba(jcfg, use_kernel=False).apply)(
        params, jnp.asarray(x)), np.float32)
    got = _eval(_port_model(name, dtype=dtype), x)
    if dtype == "float32":
        # Same fp32 math; reduction orders differ (measured ~3e-7).
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        # bf16 rounds at other places: the JAX reference path keeps the
        # activated dt in fp32 and sums the conv taps in bf16, the port rounds
        # dt to bf16 (the kernel contract) and sums the taps in fp32. Over
        # 4 layers that is about one bf16 ulp (2^-9) of logits of size ~0.4.
        np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("name", ["none_middle", "none_bidirectional"])
def test_port_matches_jax_model_fofo(name):
    """Fo-Fo, alone and in if_bidirectional layer pairs, in fp32."""
    from aum_tpu.models import AudioMamba as JaxAudioMamba

    jcfg, params = _golden_params(name)
    x = golden_input(jcfg, 3)
    want = np.asarray(jax.jit(JaxAudioMamba(jcfg, use_kernel=False).apply)(
        params, jnp.asarray(x)))
    # Same fp32 math; reduction orders differ.
    np.testing.assert_allclose(_eval(_port_model(name), x), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("readout", ["front_cls", "mean", "max", "all", "none"])
def test_port_readouts_match_jax_model(readout):
    from aum_tpu_torch.models import AudioMamba, AudioMambaConfig

    kw = dict(spectrogram_size=(32, 64), depth=2, embed_dim=32, num_classes=5,
              bimamba_type="v1")
    if readout == "front_cls":
        kw["use_middle_cls_token"] = False
    else:
        kw.update(if_cls_token=False, final_pool_type=readout)
    cfg = AudioMambaConfig(**kw)
    model = AudioMamba(cfg, device="cpu", seed=11)
    # The port's weights go to the JAX model through the JAX package's porter
    # (the exporter's inverse), which saves a JAX init per readout.
    jcfg, jmodel = build_flax(kw)
    params = port_aum_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, jcfg)
    x = golden_input(jcfg, 11)
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(x)))
    got = _eval(model, x)
    assert got.shape == want.shape
    # fp32 on both sides; reduction orders differ.
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import aum_tpu_torch, aum_tpu_torch.ops, aum_tpu_torch.models\n"
        "import aum_tpu_torch.convert, aum_tpu_torch.entry, aum_tpu_torch.train\n"
        "import aum_tpu_torch.audio, aum_tpu_torch.serving\n"
        "import aum_tpu_torch.data, aum_tpu_torch.data.native, aum_tpu_torch.run\n"
        "import aum_tpu_torch.configs, aum_tpu_torch.logging_utils\n"
        "import aum_tpu_torch.train.metrics, aum_tpu_torch.train.checkpoints\n"
        "import aum_tpu_torch.train.profiling\n"
        "import aum_tpu_torch.convert.torch_port, aum_tpu_torch.convert.ast_port\n"
        "import aum_tpu_torch.models.ast\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'aum_tpu')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    import torch

    from aum_tpu_torch.entry import entry
    from aum_tpu_torch.models import AudioMamba, AudioMambaConfig
    from aum_tpu_torch.models.ast import ASTConfig, ASTModel
    from aum_tpu_torch.run import main as run_main
    from aum_tpu_torch.serving import export_bundle, load_bundle

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AudioMamba(AudioMambaConfig(depth=1, embed_dim=32, spectrogram_size=(32, 32),
                                    num_classes=3, bimamba_type="v1"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_main(["--recipe", "as20k/aum-base_scratch", "--exp-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ASTModel(ASTConfig(depth=1, embed_dim=32, num_heads=2, input_fdim=32, input_tdim=32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_bundle(export_bundle(AudioMamba(AudioMambaConfig(
            depth=1, embed_dim=32, spectrogram_size=(32, 32), num_classes=3, bimamba_type="v1"),
            device="cpu"), audio_length=32, melbins=32))
    assert not os.listdir(tmp_path)


def test_entry_on_cpu_builds_the_flagship():
    from aum_tpu_torch.entry import entry

    fn, (x,) = entry(device="cpu")
    assert callable(fn)
    assert tuple(x.shape) == (8, 1024, 128) and x.device.type == "cpu"


def test_param_count_base_fobi():
    from aum_tpu_torch.entry import flagship_config
    from aum_tpu_torch.models import AudioMamba

    model = AudioMamba(flagship_config(), device="cpu")
    # The reference's 92.1M (tests/test_model.py holds the JAX package to it).
    assert abs(sum(p.numel() for p in model.parameters()) - 92.1e6) < 0.05e6


def test_param_count_base_fofo():
    """AuM-Base Fo-Fo has exactly the JAX model's parameters (no A_b_log)."""
    from aum_tpu.models import AudioMamba as JaxAudioMamba
    from aum_tpu.models import AudioMambaConfig as JaxConfig

    from aum_tpu_torch.entry import flagship_config
    from aum_tpu_torch.models import AudioMamba

    cfg = flagship_config("Fo-Fo")
    jcfg = JaxConfig.from_variant("base", "Fo-Fo", num_classes=527)
    f, t = jcfg.spectrogram_size
    shapes = jax.eval_shape(JaxAudioMamba(jcfg, use_kernel=False).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, t, f)))
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    model = AudioMamba(cfg, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == want
    assert not any("A_b_log" in k for k in model.state_dict())


def test_cpu_tensors_take_the_plain_path():
    import torch

    from aum_tpu_torch.ops import causal_conv1d, selective_scan_dual

    before = (selective_scan_dual.launches, causal_conv1d.launches)
    model = _port_model("v1_middle")
    x = golden_input(_golden_params("v1_middle")[0], 1)
    assert np.isfinite(_eval(model, x)).all()
    assert (selective_scan_dual.launches, causal_conv1d.launches) == before == (0, 0)


def test_wrappers_refuse_other_devices():
    import torch

    from aum_tpu_torch.ops import causal_conv1d, selective_scan, selective_scan_dual

    x = torch.empty((1, 5, 8), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        causal_conv1d(x, torch.empty((8, 4), device="meta"))
    args = (x, x, torch.empty((8, 4), device="meta"), torch.empty((1, 5, 4), device="meta"),
            torch.empty((1, 5, 4), device="meta"), torch.empty(8, device="meta"), x, None)
    with pytest.raises(ValueError, match="cpu or cuda"):
        selective_scan_dual(args, args)
    with pytest.raises(ValueError, match="cpu or cuda"):
        selective_scan(*args)
