"""Export a run's checkpoint to a reference-format torch ``.pth``.

Takes a checkpoint directory written by the training loop
(``train/checkpoints.py``: ``<exp_dir>/models`` holding ``best`` and
``epoch_N``) and writes the model's weights with the exact key set and
tensor layout of the upstream ``AudioMamba.state_dict()``
(``convert/torch_port.py::save_reference_checkpoint``), so upstream users
load them unchanged, strictly or through their ``aum_pretrain`` path.
Counterpart of ``scripts/export_torch_ckpt.py``; its ``--orbax`` flag names
the directory here too.

    python -m aum_tpu_torch.scripts.export_torch_ckpt --ckpt-dir exp/models \\
        --name best --model-type base --aum-type Fo-Bi --n-class 527 \\
        --out aum-base.pth [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ckpt-dir", "--orbax", dest="ckpt_dir", required=True,
                   help="a run's checkpoint dir (contains best, epoch_N)")
    p.add_argument("--name", default="best", help="best or epoch_<N>")
    p.add_argument("--out", required=True, help="output .pth path")
    p.add_argument("--model-type", default="base", choices=["base", "small", "tiny"])
    p.add_argument("--aum-type", default="Fo-Bi", choices=["Fo-Fo", "Fo-Bi", "Bi-Bi"])
    p.add_argument("--n-class", type=int, required=True)
    p.add_argument("--audio-length", type=int, default=1024)
    p.add_argument("--melbins", type=int, default=128)
    p.add_argument("--device", default=None, help="default: the CUDA card")
    args = p.parse_args(argv)

    from aum_tpu_torch.convert import save_reference_checkpoint
    from aum_tpu_torch.models import AudioMamba, AudioMambaConfig
    from aum_tpu_torch.train import Checkpointer

    cfg = AudioMambaConfig.from_variant(args.model_type, args.aum_type,
                                        num_classes=args.n_class,
                                        spectrogram_size=(args.melbins, args.audio_length))
    model = AudioMamba(cfg, device=args.device)
    model.load_state_dict(Checkpointer(os.path.abspath(args.ckpt_dir)).model_state(args.name))
    save_reference_checkpoint(model, args.out)
    n = sum(v.numel() for v in model.state_dict().values())
    print(f"exported {args.name} ({n/1e6:.1f}M params) -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
