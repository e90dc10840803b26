"""aum_tpu_torch — the PyTorch/CUDA port of ``aum_tpu`` for NVIDIA Hopper.

The JAX package ``aum_tpu`` is the reference; this package mirrors its module
names so each counterpart is easy to find:

- ``aum_tpu_torch.ops``    — selective-scan (forward, backward) and
                             causal-conv CUDA kernels (``csrc/``) under
                             autograd, with their plain PyTorch versions,
                             the sequential scan oracle, fused add+norm.
- ``aum_tpu_torch.models`` — AudioMamba eval and train forward (remat, drop
                             path), Mamba mixer blocks, patch/pos embedding.
- ``aum_tpu_torch.train``  — Adam with the reference's lr schedule, the
                             train and eval steps.
- ``aum_tpu_torch.convert``— JAX parameter tree -> this package's state dict.
- ``aum_tpu_torch.entry``  — the flagship forward and train step (AuM-Base
                             Fo-Bi, bf16).

Nothing here imports JAX or ``aum_tpu``. Entry points run on CUDA unless the
caller passes ``device="cpu"``; without a card and without that argument they
raise. Kernels are compiled with nvcc at first use (``ops/_build.py``).
"""

__version__ = "0.1.0"
