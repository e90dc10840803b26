"""The user tools of the port, each the counterpart of a script of the JAX
package's ``scripts/`` with the same flags plus ``--device`` (the CUDA card
unless ``--device cpu``), run as ``python -m aum_tpu_torch.scripts.<name>``:

- ``infer``: one clip -> fbank -> the recipe's model -> top-k labels;
- ``verify_ckpt``: a reference ``.pth`` through the porter, logits recorded,
  verified against a golden file, top-k, the raw fbank goldens
  (``--features``) and the upstream code's logits (``--ref-parity``);
- ``verify_lm``: an HF-format Mamba LM (a directory or a hub id in the
  local cache) -> logits, recorded or verified, and against the upstream
  ``MambaLMHeadModel`` (``--ref-parity``);
- ``get_norm_stats``: a dataset's fbank mean and std for normalization;
- ``gen_weight_file``: the balanced-sampling weights CSV;
- ``export_torch_ckpt``: a run's checkpoint -> a reference-layout ``.pth``.

Each module's ``main(argv)`` returns the exit code.
"""
