"""A dataset's fbank mean and std for normalization: the un-normalized
(``skip_norm``) training pipeline, no augmentation, the per-batch means and
stds averaged (the upstream ``get_norm_stats.py``). Counterpart of
``scripts/get_norm_stats.py``.

    python -m aum_tpu_torch.scripts.get_norm_stats --data data.json \\
        --label-csv labels.csv [--target-length 1024] [--batches 100] \\
        [--device cpu]

With ``--batches`` the result depends on the shuffled order of the batches,
which is the JAX package's for the same seed.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data", required=True)
    p.add_argument("--label-csv", required=True)
    p.add_argument("--target-length", type=int, default=1024)
    p.add_argument("--melbins", type=int, default=128)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--batches", type=int, default=0, help="limit number of batches (0 = all)")
    p.add_argument("--device", default=None, help="default: the CUDA card")
    args = p.parse_args(argv)

    from aum_tpu_torch.data import AudioConf, AudioJsonDataset, BatchPipeline

    conf = AudioConf(num_mel_bins=args.melbins, target_length=args.target_length,
                     skip_norm=True, freqm=0, timem=0, mixup=0.0)
    ds = AudioJsonDataset(args.data, conf, args.label_csv)
    pipe = BatchPipeline(ds, args.batch_size, train=True, device=args.device)

    means, stds = [], []
    for i, batch in enumerate(pipe.batches(0)):
        x = batch["x"].double()
        means.append(x.mean().item())
        stds.append(x.std(correction=0).item())
        if args.batches and i + 1 >= args.batches:
            break
    print(f"mean={np.mean(means):.7f} std={np.mean(stds):.7f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
