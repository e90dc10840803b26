"""aum_tpu_torch — the PyTorch/CUDA port of ``aum_tpu`` for NVIDIA Hopper.

The JAX package ``aum_tpu`` is the reference; this package mirrors its module
names so each counterpart is easy to find:

- ``aum_tpu_torch.ops``    — selective-scan (forward, backward) and
                             causal-conv CUDA kernels (``csrc/``) under
                             autograd, with their plain PyTorch versions,
                             the sequential scan oracle, fused add+norm.
- ``aum_tpu_torch.models`` — AudioMamba eval and train forward (remat, drop
                             path), Mamba mixer blocks, patch/pos embedding;
                             the AST baseline (``models.ast``); the Mamba LM.
- ``aum_tpu_torch.audio``  — the Kaldi fbank, normalization and the
                             train-time augmentations (SpecAugment, mixup,
                             noise and roll).
- ``aum_tpu_torch.data``   — WAV datasets, the native batch decoder, the
                             batch pipeline with the featurizer on the
                             device, the prefetcher.
- ``aum_tpu_torch.train``  — Adam with the reference's lr schedule, the
                             train and eval steps, the epoch loop, eval
                             metrics, checkpoints, profiling.
- ``aum_tpu_torch.configs``— the published training recipes.
- ``aum_tpu_torch.run``    — the experiment runner (``python -m
                             aum_tpu_torch.run``): train, eval, eval_wa,
                             eval_ensemble; AuM or AST, from scratch or
                             from a pretrained checkpoint.
- ``aum_tpu_torch.serving``— the served forward (also from waveforms),
                             serving bundles (export, int8 weights, load,
                             predict) and the HTTP server (``python -m
                             aum_tpu_torch.serving export|serve``).
- ``aum_tpu_torch.convert``— the checkpoint porters (reference AuM, ViM,
                             DeiT and AST ``.pth`` -> state dicts, and
                             back), the JAX package's parameter trees
                             -> this package's state dicts, and the runner
                             of the upstream model code (``ref_runner``).
- ``aum_tpu_torch.scripts``— the user tools (``python -m
                             aum_tpu_torch.scripts.<name>``): infer,
                             verify_ckpt, verify_lm, get_norm_stats,
                             gen_weight_file, export_torch_ckpt.
- ``aum_tpu_torch.parallel``— the parallel modes: the mesh of ranks and the
                             tensor-parallel layout, multi-process runs,
                             the collectives, GPipe, the rank spawner and
                             the per-rank checks.
- ``aum_tpu_torch.entry``  — the flagship forward and train step (AuM-Base
                             Fo-Bi, bf16); ``dryrun_multichip``.

Nothing here imports JAX or ``aum_tpu``. Entry points run on CUDA unless the
caller passes ``device="cpu"``; without a card and without that argument they
raise. Kernels are compiled with nvcc at first use (``ops/_build.py``), the
WAV decoder with the host C++ compiler (``data/native.py``).
"""

__version__ = "0.1.0"
