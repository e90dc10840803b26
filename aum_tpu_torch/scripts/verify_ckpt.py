"""Released-checkpoint parity harness: a reference ``.pth`` -> the porter ->
AudioMamba logits on clips (or a recorded fbank file) -> compared with a
golden file. Counterpart of ``scripts/verify_ckpt.py``, with its flags.

Modes:
  record   -- ``--record-to g.npz``: save the logits (and inputs) as a golden
              file;
  verify   -- ``--golden g.npz``: compare the logits with a golden file
              within ``--atol``;
  topk     -- ``--label-csv``: print each clip's top-k classes.
``--ref-parity`` also runs the upstream model code (``convert.ref_runner``:
its fused ops replaced by torch oracles, on the CPU) on the same inputs and
compares; with ``--record-to`` its logits are what is recorded.
``--features`` / ``--features-record-to`` compare or record the raw per-clip
Kaldi fbanks alone (no checkpoint needed).

    python -m aum_tpu_torch.scripts.verify_ckpt --ckpt aum-base.pth \\
        --model-type base --aum-type Fo-Bi --n-class 527 --wav a.wav b.flac \\
        [--golden g.npz] [--record-to g.npz] [--label-csv labels.csv] \\
        [--device cpu]

For dataset-level metrics use the runner:
``python -m aum_tpu_torch.run --recipe audioset/aum-base_scratch --run-type
eval --ckpt ckpt.pth --data-eval eval.json --label-csv labels.csv
--exp-dir exp``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def model_config(args):
    from aum_tpu_torch.models import AudioMambaConfig

    return AudioMambaConfig.from_variant(args.model_type, args.aum_type,
                                         num_classes=args.n_class,
                                         spectrogram_size=(args.melbins, args.audio_length))


def build_model(args, device):
    """The variant's AudioMamba on ``device`` with the ported ``--ckpt``
    merged over its init (seed 0)."""
    from aum_tpu_torch.convert import load_torch_checkpoint, merge_with_init, port_aum_state_dict
    from aum_tpu_torch.models import AudioMamba

    cfg = model_config(args)
    model = AudioMamba(cfg, device=device)
    ported = port_aum_state_dict(load_torch_checkpoint(args.ckpt), cfg)
    model.load_state_dict(merge_with_init(ported, model.state_dict()))
    return model.eval()


def _decode(path: str, max_samples: int | None) -> np.ndarray:
    """A clip's samples: WAV through ``load_wav``, any other format through
    the ffmpeg-backed decoder (capped at ``max_samples``, or whole)."""
    from aum_tpu_torch.data import load_wav

    if path.lower().endswith(".wav"):
        return load_wav(path)[0]
    from aum_tpu_torch.data.native import decode_audio

    if max_samples is None:
        max_samples = max(decode_audio(path, 1)[1], 1)  # the clip's whole length
    out, n, _sr = decode_audio(path, max_samples)
    return out[:min(n, max_samples)]


def featurize_wavs(paths, args, device) -> np.ndarray:
    """Decode, fbank and normalize as the eval pipeline does: (B, T, F)."""
    from aum_tpu_torch.audio import FbankConfig, fbank, normalize
    from aum_tpu_torch.data import AudioConf

    conf = AudioConf(num_mel_bins=args.melbins, target_length=args.audio_length,
                     mean=args.dataset_mean, std=args.dataset_std)
    waves, n_frames = [], []
    for p in paths:
        w = _decode(p, conf.target_samples)
        w = w - w.mean()
        n_frames.append(int(conf.n_frames(len(w))))
        tgt = conf.target_samples
        w = w[:tgt] if len(w) >= tgt else np.pad(w, (0, tgt - len(w)))
        waves.append(w.astype(np.float32))
    fb = fbank(torch.from_numpy(np.stack(waves)).to(device),
               FbankConfig(num_mel_bins=conf.num_mel_bins))
    mask = (torch.arange(fb.shape[1], device=device)[None]
            < torch.tensor(n_frames, device=device)[:, None])
    fb = torch.where(mask[:, :, None], fb, torch.zeros((), device=device))
    return normalize(fb, conf.mean, conf.std).cpu().numpy()


def reference_logits(args, x: np.ndarray) -> np.ndarray:
    """Golden logits from the upstream code on the CPU: its AudioMamba built
    with ``aum_pretrain_path=--ckpt``, so its own checkpoint surgery loads
    the ``.pth`` (``convert/ref_runner.py``)."""
    from aum_tpu_torch.convert.ref_runner import import_reference_models

    mm = import_reference_models()
    embed = {"base": 768, "small": 384, "tiny": 192}[args.model_type]
    bimamba = {"Fo-Fo": "none", "Fo-Bi": "v1", "Bi-Bi": "v2"}[args.aum_type]
    model = mm.AudioMamba(spectrogram_size=(args.melbins, args.audio_length), depth=24,
                          embed_dim=embed, num_classes=args.n_class, bimamba_type=bimamba,
                          aum_pretrain=True, aum_pretrain_path=args.ckpt)
    model.eval()
    with torch.no_grad():
        return model(torch.from_numpy(np.asarray(x))).float().numpy()


def raw_fbank_clips(paths, args, device) -> list:
    """Per-clip raw Kaldi fbank (no pad or crop, no normalization): the
    waveform mean-subtracted, then the fbank (htk_compat, 'hanning', no
    dither), the upstream dataloader's feature step."""
    from aum_tpu_torch.audio import FbankConfig, fbank

    clips = []
    for p in paths:
        w = _decode(p, None)
        w = (w - w.mean()).astype(np.float32)
        fb = fbank(torch.from_numpy(w).to(device), FbankConfig(num_mel_bins=args.melbins))
        clips.append(fb.cpu().numpy().astype(np.float32))
    return clips


def run_feature_mode(args, device) -> int:
    """--features / --features-record-to: the frontend alone against a
    golden of per-clip fbanks (``clip_000``, ``clip_001``, ...), as
    torchaudio.compliance.kaldi.fbank(w - w.mean(), htk_compat=True,
    sample_frequency=sr, use_energy=False, window_type='hanning',
    num_mel_bins=128, dither=0.0, frame_shift=10) gives them."""
    clips = raw_fbank_clips(args.wav, args, device)
    if args.features_record_to:
        np.savez(args.features_record_to, **{f"clip_{i:03d}": c for i, c in enumerate(clips)})
        print(f"recorded {len(clips)} raw fbank clips -> {args.features_record_to}")
    rc = 0
    if args.features:
        g = np.load(args.features)
        names = sorted(k for k in g.files if k.startswith("clip_"))
        if len(names) != len(clips):
            raise ValueError(f"{args.features} holds {len(names)} clips, --wav gives "
                             f"{len(clips)}")
        for name, ours in zip(names, clips):
            ref = g[name]
            if ref.shape != ours.shape:
                print(f"{name}: SHAPE MISMATCH ours {ours.shape} vs golden {ref.shape}")
                rc = 1
                continue
            err = float(np.abs(ours - ref).max())
            status = "OK" if err <= args.features_atol else "FAIL"
            if status == "FAIL":
                rc = 1
            print(f"{name}: frames={ref.shape[0]} max|Δ|={err:.6f} "
                  f"(atol {args.features_atol}) {status}")
        print("FEATURES PARITY " + ("OK" if rc == 0 else "FAIL"))
    return rc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ckpt", help="reference .pth (not needed for the --features-only modes)")
    p.add_argument("--model-type", default="base")
    p.add_argument("--aum-type", default="Fo-Bi")
    p.add_argument("--n-class", type=int, default=527)
    p.add_argument("--audio-length", type=int, default=1024)
    p.add_argument("--melbins", type=int, default=128)
    p.add_argument("--dataset-mean", type=float, default=-4.2677393)
    p.add_argument("--dataset-std", type=float, default=4.5689974)
    p.add_argument("--wav", nargs="*", help="input clips (wav/flac/m4a)")
    p.add_argument("--fbank-npz", help=".npz with 'x' (B, T, F) precomputed fbanks (bypasses "
                                       "the frontend)")
    p.add_argument("--golden", help="golden .npz with 'logits' to compare")
    p.add_argument("--record-to", help="save computed logits to this .npz")
    p.add_argument("--ref-parity", action="store_true",
                   help="also run the upstream model code on the same inputs and compare; "
                        "with --record-to, its logits are recorded")
    p.add_argument("--atol", type=float, default=1e-2, help="logit tolerance vs golden")
    p.add_argument("--label-csv", help="for top-k display names")
    p.add_argument("--topk", type=int, default=5)
    p.add_argument("--features", help=".npz of per-clip raw Kaldi fbanks (clip_000, ...) to "
                                      "compare the frontend against")
    p.add_argument("--features-record-to", help="save this frontend's raw per-clip fbanks")
    p.add_argument("--features-atol", type=float, default=2e-3,
                   help="raw log-mel tolerance (fp32 FFT and product order vs torchaudio)")
    p.add_argument("--device", default=None, help="default: the CUDA card")
    args = p.parse_args(argv)

    from aum_tpu_torch.utils import resolve_device

    device = resolve_device(args.device)
    if args.features or args.features_record_to:
        if not args.wav:
            p.error("the --features modes need --wav clips")
        rc = run_feature_mode(args, device)
        if not args.ckpt or rc:
            return rc

    if not args.ckpt:
        p.error("--ckpt required (or use the --features-only modes)")
    if not (args.fbank_npz or args.wav):
        p.error("need --wav clips or --fbank-npz")
    model = build_model(args, device)
    if args.fbank_npz:
        x = np.load(args.fbank_npz)["x"].astype(np.float32)
    else:
        x = featurize_wavs(args.wav, args, device)
    with torch.inference_mode():
        logits = model(torch.from_numpy(x).to(device)).float().cpu().numpy()
    print(f"logits: shape={logits.shape} mean={logits.mean():.4f} std={logits.std():.4f}")

    if args.label_csv:
        from aum_tpu_torch.data import make_name_dict

        names = make_name_dict(args.label_csv)
        scores = 1.0 / (1.0 + np.exp(-logits))
        for i in range(len(logits)):
            top = np.argsort(-scores[i])[:args.topk]
            print(f"clip {i}: " + ", ".join(f"{names[int(k)]}={scores[i, k]:.3f}" for k in top))

    rc = 0
    record = logits
    if args.ref_parity:
        ref = reference_logits(args, x)
        err = np.abs(logits - ref).max()
        print(f"reference-code max|Δlogit| = {err:.5f} (atol {args.atol})")
        if err > args.atol:
            print("REF PARITY FAIL")
            rc = 1
        else:
            print("REF PARITY OK")
        record = ref
    if args.record_to:
        np.savez(args.record_to, logits=record, x=x)
        print(f"recorded golden -> {args.record_to}")
    if args.golden:
        g = np.load(args.golden)["logits"]
        err = np.abs(logits - g).max()
        print(f"golden max|Δlogit| = {err:.5f} (atol {args.atol})")
        if err > args.atol:
            print("PARITY FAIL")
            return 1
        print("PARITY OK")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
