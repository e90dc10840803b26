"""The PyTorch port against the upstream Audio-Mamba-AuM code itself, on the CPU.

``aum_tpu_torch/convert/ref_runner.py`` imports the upstream model code with
its fused CUDA/Triton ops replaced by torch oracles; the port's models,
given the upstream model's weights through the port's porters, must give the
same logits (2e-3 + 2e-3·|ref|, as ``tests/test_ref_parity.py`` holds the
JAX package):

- AuM at base width (embed 768, depth 24, middle cls) for Fo-Fo, Fo-Bi and
  Bi-Bi, through ``port_aum_state_dict`` and ``merge_with_init``;
- the Mamba LM (upstream ``MambaLMHeadModel``) written as an HF-format
  directory and read by ``from_pretrained_hf``;
- ``python -m aum_tpu_torch.scripts.verify_ckpt --ref-parity`` recording
  the upstream logits as the golden file, then verifying against it.

Skipped when no upstream checkout is present (``reference_available()``:
``$AUM_REFERENCE_PATH``, else ``reference/`` in the repository root), as
``tests/test_ref_parity.py`` skips. The stubs the runner installs are
removed again after the module.
"""

import json
import sys

import numpy as np
import pytest

from aum_tpu_torch.convert.ref_runner import (
    import_reference_lm,
    import_reference_models,
    reference_available,
    reference_state_dict_numpy,
)

pytestmark = pytest.mark.skipif(not reference_available(),
                                reason="no upstream Audio-Mamba-AuM checkout present")

SPEC = (128, 128)  # (F, T) -> an 8 x 8 grid, 64 patches + cls = 65 tokens
TOL = dict(rtol=2e-3, atol=2e-3)


@pytest.fixture(scope="module")
def upstream():
    """(mamba_models, mixer_seq_simple), with sys.modules and sys.path
    restored after the module."""
    modules, path = dict(sys.modules), list(sys.path)
    try:
        yield import_reference_models(), import_reference_lm()
    finally:
        for name in set(sys.modules) - set(modules):
            del sys.modules[name]
        sys.modules.update(modules)
        sys.path[:] = path


@pytest.mark.parametrize("bimamba", ["none", "v1", "v2"])
def test_base_scale_variant_logit_parity(upstream, bimamba):
    import torch

    from aum_tpu_torch.convert import merge_with_init, port_aum_state_dict
    from aum_tpu_torch.models import AudioMamba, AudioMambaConfig

    mm, _ = upstream
    torch.manual_seed(1)
    ref = mm.AudioMamba(spectrogram_size=SPEC, depth=24, embed_dim=768, num_classes=11,
                        bimamba_type=bimamba)
    ref.eval()
    x = torch.randn(2, SPEC[1], SPEC[0]) * 0.5
    with torch.no_grad():
        want = ref(x).float().numpy()
    cfg = AudioMambaConfig(spectrogram_size=SPEC, depth=24, embed_dim=768, num_classes=11,
                           bimamba_type=bimamba)
    model = AudioMamba(cfg, device="cpu")
    ported = port_aum_state_dict(reference_state_dict_numpy(ref), cfg)
    model.load_state_dict(merge_with_init(ported, model.state_dict()))
    with torch.no_grad():
        got = model(x).float().numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_lm_logit_parity(upstream, tmp_path):
    import torch

    from aum_tpu_torch.models.lm import from_pretrained_hf

    _, mix = upstream
    from mamba_ssm.models.config_mamba import MambaConfig

    raw = {"d_model": 64, "n_layer": 2, "vocab_size": 100, "ssm_cfg": {}, "rms_norm": True,
           "residual_in_fp32": True, "fused_add_norm": True, "pad_vocab_size_multiple": 8}
    torch.manual_seed(2)
    ref = mix.MambaLMHeadModel(MambaConfig(**raw))
    ref.eval()
    (tmp_path / "config.json").write_text(json.dumps(raw))
    torch.save(ref.state_dict(), str(tmp_path / "pytorch_model.bin"))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 100, (2, 16)))
    with torch.no_grad():
        want = ref(tokens).logits.float().numpy()
        got = from_pretrained_hf(str(tmp_path), device="cpu")(tokens).float().numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_verify_ckpt_ref_parity_mode(upstream, tmp_path):
    import torch

    from aum_tpu_torch.scripts.verify_ckpt import main

    mm, _ = upstream
    torch.manual_seed(10)
    donor = mm.AudioMamba(spectrogram_size=(128, 128), depth=24, embed_dim=192, num_classes=35,
                          bimamba_type="v1")
    pth = str(tmp_path / "tiny.pth")
    torch.save(donor.state_dict(), pth)
    npz = str(tmp_path / "fb.npz")
    np.savez(npz, x=(np.random.default_rng(20).standard_normal((2, 128, 128)) * 0.4
                     ).astype(np.float32))
    golden = str(tmp_path / "golden.npz")
    args = ["--ckpt", pth, "--model-type", "tiny", "--aum-type", "Fo-Bi", "--n-class", "35",
            "--audio-length", "128", "--melbins", "128", "--fbank-npz", npz, "--device", "cpu"]
    assert main(args + ["--ref-parity", "--record-to", golden]) == 0
    assert main(args + ["--golden", golden]) == 0
