"""LM checkpoint verification: an HF-format Mamba LM -> the port -> logits
of seeded tokens -> a golden file or the upstream code. Counterpart of
``scripts/verify_lm.py``, with its flags.

``--model`` is a local directory (``config.json`` + ``pytorch_model.bin``) or
a hub id such as ``state-spaces/mamba-130m`` whose files are in the local HF
cache (``models/lm.py::from_pretrained_hf``; nothing is downloaded). Then:

  --ref-parity   build the upstream ``MambaLMHeadModel`` on the CPU with its
                 fused ops replaced by torch oracles (``convert/ref_runner.py``),
                 strict-load the same weights, and compare logits within
                 --atol;
  --record-to F  save the tokens and logits as a golden .npz;
  --golden F     compare against a recorded golden.

    python -m aum_tpu_torch.scripts.verify_lm --model state-spaces/mamba-130m \\
        [--record-to g.npz | --golden g.npz] [--ref-parity] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch


def model_files(model: str) -> tuple[str, str]:
    """(config.json, pytorch_model.bin) of a directory or a cached hub id."""
    from aum_tpu_torch.models.lm import CONFIG_NAME, WEIGHTS_NAME, hub_cached_file

    if os.path.isdir(model):
        return os.path.join(model, CONFIG_NAME), os.path.join(model, WEIGHTS_NAME)
    return hub_cached_file(model, CONFIG_NAME), hub_cached_file(model, WEIGHTS_NAME)


def reference_logits(model: str, tokens: np.ndarray) -> np.ndarray:
    """The upstream ``MambaLMHeadModel``'s logits on the CPU, built from the
    same config.json and strict-loaded with the same weights."""
    from aum_tpu_torch.convert.ref_runner import import_reference_lm

    mix = import_reference_lm()
    from mamba_ssm.models.config_mamba import MambaConfig

    config_file, weights_file = model_files(model)
    with open(config_file) as f:
        raw = json.load(f)
    ref_cfg = MambaConfig(
        d_model=raw["d_model"], n_layer=raw["n_layer"], vocab_size=raw["vocab_size"],
        ssm_cfg=raw.get("ssm_cfg", {}), rms_norm=raw.get("rms_norm", True),
        residual_in_fp32=raw.get("residual_in_fp32", True),
        fused_add_norm=raw.get("fused_add_norm", True),
        pad_vocab_size_multiple=raw.get("pad_vocab_size_multiple", 8))
    ref = mix.MambaLMHeadModel(ref_cfg)
    ref.load_state_dict(torch.load(weights_file, map_location="cpu", weights_only=True))
    ref.eval()
    with torch.no_grad():
        return ref(torch.from_numpy(tokens).long()).logits.float().numpy()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", required=True,
                   help="HF-format dir (config.json + pytorch_model.bin) or hub id")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--seq-len", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ref-parity", action="store_true")
    p.add_argument("--record-to", help="save logits to this .npz")
    p.add_argument("--golden", help="compare logits to this .npz")
    p.add_argument("--atol", type=float, default=2e-3, help="fp32 tolerance on logits")
    p.add_argument("--device", default=None, help="default: the CUDA card")
    args = p.parse_args(argv)

    from aum_tpu_torch.models.lm import from_pretrained_hf
    from aum_tpu_torch.utils import resolve_device

    device = resolve_device(args.device)
    model = from_pretrained_hf(args.model, device=device)
    cfg = model.config
    print(f"ported: d_model={cfg.d_model} n_layer={cfg.n_layer} "
          f"vocab={cfg.vocab_size} (padded {cfg.padded_vocab})")

    rng = np.random.default_rng(args.seed)
    tokens = rng.integers(0, cfg.vocab_size, (args.batch, args.seq_len)).astype(np.int32)
    with torch.inference_mode():
        logits = model(torch.from_numpy(tokens).long().to(device)).float().cpu().numpy()
    if not np.isfinite(logits).all():
        raise FloatingPointError("non-finite logits")
    print(f"logits {logits.shape} mean={logits.mean():.6f} "
          f"std={logits.std():.6f} argmax[0,-1]={int(logits[0, -1].argmax())}")

    if args.record_to:
        np.savez(args.record_to, tokens=tokens, logits=logits)
        print(f"golden recorded: {args.record_to}")
    if args.golden:
        g = np.load(args.golden)
        np.testing.assert_array_equal(g["tokens"], tokens)
        np.testing.assert_allclose(logits, g["logits"], atol=args.atol)
        print("LM GOLDEN OK")

    if args.ref_parity:
        ref_logits = reference_logits(args.model, tokens)
        # The upstream head is padded to padded_vocab too: the shapes match.
        np.testing.assert_allclose(logits, ref_logits, atol=args.atol)
        print(f"LM PARITY OK (max abs diff {np.abs(logits - ref_logits).max():.2e}, "
              f"atol {args.atol})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
