"""The per-sample balanced-sampling weights CSV for AudioSet:
weight(sample) = the sum over its labels of 1000 / (class count + 0.01)
(the upstream ``gen_weight_file.py``). Counterpart of
``scripts/gen_weight_file.py``.

    python -m aum_tpu_torch.scripts.gen_weight_file --data unbalanced.json \\
        --label-csv labels.csv --out weights.csv [--device cpu]

The weights are host arithmetic; ``--device`` is resolved as every tool's
is (the card unless named), so a run without a card and without
``--device cpu`` stops as the others do.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data", required=True)
    p.add_argument("--label-csv", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default=None, help="default: the CUDA card")
    args = p.parse_args(argv)

    from aum_tpu_torch.data import AudioConf, AudioJsonDataset, balanced_sample_weights
    from aum_tpu_torch.utils import resolve_device

    resolve_device(args.device)
    ds = AudioJsonDataset(args.data, AudioConf(), args.label_csv)
    weights = balanced_sample_weights(ds)
    with open(args.out, "w") as f:
        for d, w in zip(ds.data, weights):
            f.write(f"{d['wav']},{w}\n")
    print(f"wrote {len(weights)} weights -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
