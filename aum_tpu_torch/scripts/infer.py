"""Single-clip inference: a WAV -> Kaldi fbank -> normalize -> the recipe's
model -> sigmoid -> the top-k labels (the upstream inference notebook's
single-sample path). Counterpart of ``scripts/infer.py``.

    python -m aum_tpu_torch.scripts.infer --wav clip.wav \\
        --recipe audioset/aum-base_scratch --ckpt aum-base.pth \\
        --label-csv labels.csv [--topk 5] [--set k=v ...] [--device cpu]

``--ckpt`` is a reference ``.pth`` (through the porter, keys it lacks keep
the init) or a run's checkpoint directory (its ``best``). Without it the
model keeps its random init, which exercises the whole flow but gives
meaningless scores. Without ``--wav`` the sample clip and label CSV of an
upstream checkout are read where one is present (``convert.ref_runner``).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def _examples_dir() -> str:
    from aum_tpu_torch.convert.ref_runner import reference_root

    return os.path.join(reference_root(), "examples", "inference")


def featurize_clip(path: str, cfg, device) -> torch.Tensor:
    """(audio_length, melbins) normalized log-mel of one WAV on ``device``:
    mean subtraction, fbank at the file's rate, pad or crop, normalize."""
    from aum_tpu_torch.audio import FbankConfig, fbank, normalize
    from aum_tpu_torch.data import load_wav

    wave, sr = load_wav(path)
    wave = torch.from_numpy(wave - wave.mean()).to(device)
    fb = fbank(wave, FbankConfig(sample_frequency=sr, num_mel_bins=cfg.melbins))
    t = fb.shape[0]
    if t < cfg.audio_length:
        fb = torch.nn.functional.pad(fb, (0, 0, 0, cfg.audio_length - t))
    else:
        fb = fb[:cfg.audio_length]
    return normalize(fb, cfg.dataset_mean, cfg.dataset_std)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--wav", default=None)
    p.add_argument("--recipe", default="audioset/aum-base_scratch")
    p.add_argument("--ckpt", default=None,
                   help="reference .pth or a run's checkpoint directory; omitted = random "
                        "init (flow smoke only)")
    p.add_argument("--label-csv", default=None)
    p.add_argument("--topk", type=int, default=5)
    p.add_argument("--set", action="append", default=[])
    p.add_argument("--device", default=None, help="default: the CUDA card")
    args = p.parse_args(argv)

    if args.wav is None:
        cand = os.path.join(_examples_dir(), "data", "sample0.wav")
        if not os.path.exists(cand):
            p.error("--wav is required (no bundled sample found)")
        args.wav = cand
    if args.label_csv is None:
        cand = os.path.join(_examples_dir(), "datafiles", "class_labels_indices.csv")
        args.label_csv = cand if os.path.exists(cand) else None

    from aum_tpu_torch.configs import RECIPES
    from aum_tpu_torch.data import make_name_dict
    from aum_tpu_torch.run import apply_overrides, build_model, load_checkpoint
    from aum_tpu_torch.utils import resolve_device

    device = resolve_device(args.device)
    cfg = apply_overrides(RECIPES[args.recipe], args.set)
    fb = featurize_clip(args.wav, cfg, device)
    model = build_model(cfg, device)
    if args.ckpt is None:
        print("# no --ckpt: random-init model (flow smoke; scores are meaningless)")
    else:
        load_checkpoint(model, cfg, args.ckpt)
    model.eval()
    with torch.inference_mode():
        logits = model(fb[None])[0]
    scores = torch.sigmoid(logits.float()).cpu().numpy()
    names = make_name_dict(args.label_csv) if args.label_csv else {}
    for i in np.argsort(-scores, kind="stable")[:args.topk]:
        print(f"{names.get(int(i), i)}: {float(scores[i]):.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
