#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``aum_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py

Phases (each prints JSON lines; any failure raises and the exit code is not 0):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; build: nvcc compiles every kernel from ``aum_tpu_torch/csrc/``
   (all sources at once) and the build time is printed, with ptxas's
   registers and spills; occupancy: per scan kernel instantiation, the
   blocks and warps per SM the occupancy calculator allows, its registers,
   spill bytes and shared memory (each scan library's ``aum_kernel_info``).
2. kernels: each kernel against its plain PyTorch version on the card, in
   fp32 and bf16. The dual scan forward, v1 (shared operands) and v2
   (separate), both directions, at the Fo-Bi eval path's shapes (B=8, L=513,
   D=1536, N=16, strided operands as the model passes them); its saving form
   (outputs and states), the scan backward in both forms (one launch for both
   directions, one launch per direction; all 8 grads per direction) and the
   conv backward at the train path's shapes (B=12, L=513). The
   single-direction scan forward, forward and reverse: at the Fo-Fo eval
   shapes (B=8) as is and in its with_state form (outputs and final state
   from a random x0); its saving form (outputs and states) and the backward
   of its autograd op (all 8 grads, through the one-direction backward) at
   B=12. The conv forward, causal and anti-causal. All of them also at
   ragged shapes (L=37, D=40; L=150, three state chunks, the last short),
   the scan kernels at L=37, D=40 also with d_state 5, which leaves the
   last of the backward's 4 lanes per chain with part of its states or
   none. The backward (K2 and fused, one launch for both directions and one
   per direction) also without the softplus.
   The kernels behind ``aum_tpu``'s switches, at the same shapes: the
   direct dual forward (AUM_SCAN_DIRECT=1; eval and saving) against the
   plain version and the staged kernel, the fused backward
   (AUM_SCAN_BWD_FUSED=1; one and both directions) against the plain
   backward and K2; K2's with_state form (the 9 grads, d(x0) the last, from
   a random x0 and final-state cotangent) and its form without the softplus
   through the autograd op; and a scan split at an uneven point into two
   segments chained by their states against the unsplit scan, outputs and
   grads, forward and reverse (train and ragged shapes).
   The four opt-in forms: the fuse_dt dual forward (AUM_SCAN_FUSE_DT=1;
   dtr read in place from an x_proj-shaped output, dt rank 48, and 12 at
   the ragged shapes) against its plain version and against the staged
   kernel fed the materialised dt, v1 and v2, fp32 and bf16; the stage form
   (AUM_SCAN_BF16_STAGE=1), eval and saving, against its plain version, and
   bit-equal to the default kernel in fp32; K2 and the fused kernel with
   bf16 partials against their fp32-partials launches (dB, dC at the bf16
   grad tolerance, the rest bit-equal), one and both directions; K2's
   x-minus form against the plain backward, one and both directions and
   with_state; each also shows its form's launch count rose. The
   redesigned kernels at the edges of their designs (``_check_edges``): the
   fuse_dt forward at dt ranks 1, 16, 17, 47 (unaligned dtr rows) and 64 and
   at L = 1, 15, 16, 17, 65, 81 with D=136; the conv forward and backward at
   D=36, on a slice at an odd channel offset, at L=1 and one past its tile;
   the fused backward (with the saving forward that feeds it) against the
   plain version and K2, one and both directions, with and without the
   softplus, at L = 1, 63, 64, 65, 127, 128, 129, 513 with D = 40 and 136,
   with d_state 5, and with bf16 partials against its fp32-partials launch.
   The single-direction forward (as is and with_state) and the conv also at
   the LM prefill's shapes (``LM_PREFILL_DIMS``: B=8, L=512, D=1536).
   Then the small-dt probe: ddelta at dt in [1e-6, 1e-4] from K2 and the fused
   kernel in fp32, and from the plain version, each against fp64; a kernel
   fails it if its relative error exceeds the plain version's by more than
   SMALL_DT_RATIO.
3. model: AuM-Base Fo-Bi at full width and depth 24. fp32, B=2: the card
   (with kernels) against the same weights on the CPU (plain path). Then the
   eval path itself, ``aum_tpu_torch.entry.entry()`` (bf16, B=8), with every
   launch counter set to 0 just before and read just after: it must show 24
   dual-scan and 24 conv launches and no other, and (8, 527) finite logits;
   then its latency (CUDA events, 10 forwards after warm-up). Then the fp32
   check and ``entry()`` again under AUM_SCAN_DIRECT=1: 24 direct launches
   and no staged one; under AUM_SCAN_FUSE_DT=1 (fp32 check too), alone and
   with AUM_SCAN_DIRECT=1: 24 fuse_dt launches and no other scan launch;
   under AUM_SCAN_BF16_STAGE=1: 24 stage launches (``EVAL_SWITCHES``).
4. wav: AuM-Base Fo-Fo at full width and depth 24 from 10 s waveforms
   (160,000 samples: the Kaldi fbank, pad to 1024 frames, AudioSet's
   normalization, the model). fp32, B=2: the card (kernels and frontend)
   against the same weights on the CPU. Then the path itself,
   ``aum_tpu_torch.entry.wav_entry()`` (bf16, B=8), between a reset and a read
   of every launch counter: 24 single-direction scan and 24 conv launches
   and no other, no graph, (8, 527) finite logits; then its latency and the
   frontend's share of it, timed alone.
5. train: at full width, depth 2, fp32, B=2, for Fo-Bi and for Fo-Fo: the
   loss and the grads of in_proj, A_log (and Fo-Bi's A_b_log), dt_proj.bias,
   conv1d.weight, x_proj.weight and dt_proj.weight, and those params after
   one full train step (Adam, no
   warmup), on the card against the same weights on the CPU (plain path);
   the launches of the card's forward and backward are read (Fo-Fo: 2 saving
   single-direction forwards and 2 one-direction backwards).
   Then the train path itself, ``aum_tpu_torch.entry.train_entry()`` (Fo-Bi,
   depth 24, bf16, B=12, remat "auto", which resolves to split): three steps
   with finite losses, one of them between a reset and a read of every
   launch counter (24 saving
   forwards, 24 backwards, 96 conv launches: forward, split recompute, and
   the backward's pre-activation and dx); then ms per step and clips/s (CUDA
   events after warm-up), peak memory, SM clock and power. The fp32 checks
   also run under the switches (Fo-Fo: AUM_SCAN_BWD_FUSED=1; Fo-Bi: both),
   and the train path under both switches launches 24 direct saving
   forwards, 24 fused backwards and no K2; its ms per step are timed in
   turns with the default path's (default, switched, switched, default).
   The Fo-Bi fp32 check also runs under AUM_SCAN_FUSE_DT=1, and the train
   path's launches are checked under the sets of ``TRAIN_CHECK_SWITCHES``:
   the fuse_dt rule (24 staged saving forwards and 24 K2, with
   AUM_SCAN_DIRECT=1 too), and every opt-in form at once (the stage form's
   saving forward, K2 in its x-minus form or the fused kernel, bf16
   partials).
6. recipe: recipes from WAV files through ``aum_tpu_torch.run.main``, on
   synthetic 16-bit WAV clips at 16 kHz (most of full length, every sixth
   shorter, so that the frame mask acts) with multi-label manifests,
   written to a temporary directory. as20k (AuM-Base Fo-Bi at full width
   and depth, bf16, B=12, 1024 frames, mixup 0.5, SpecAugment 48/192):
   one epoch of 48 clips (4 steps), then validation on 24 (one batch of
   24); every launch counter is set to 0 just before ``run.main`` and read
   just after, and each step's and validation batch's launches must be the
   train path's and the eval path's. Per step: the loss (finite), host ms
   and CUDA-event ms; the third step under torch.profiler (idle share,
   the pipeline's work for the next batch included); clips/s, peak
   memory, the val metrics and the artifacts. Then ``--run-type eval``
   from the written ``models/``: its val scores must equal the trained
   state's bit for bit. Then the pipeline alone: decode ms per batch
   (native and Python decoders) and featurize ms per batch (CUDA events),
   and one featurized train batch on the card against the CPU from the
   same draws (``FEATURIZE_TOL``). Then SpeechCommands (B=128, 1 s clips,
   35 classes, noise, mixup 0.6; full width and depth): 2 steps, its
   validation, and the post-train valid and eval pass.
7. epic: the EPIC-SOUNDS recipe (AuM-Base Fo-Bi at full width and depth,
   bf16, B=12, 44 classes, 10 s clips at 24 kHz, 1024 frames x 128 mels,
   CE, warm-up) through ``aum_tpu_torch.run.main`` on in-memory pipelines
   (records and a dict of samples; the card's machine has no pandas or
   h5py): segments longer than a clip, one clip, and shorter (edge-padded).
   4 train steps and one validation batch (B=24) between a reset and a read
   of every launch counter (per step and batch as the recipe phase checks
   them), then the test split from the written checkpoint (4 records x 5
   views, averaged per record: one row of scores per record), then host
   and featurize ms per batch (STFT, time warp, masks, normalize) and one
   featurized train batch on the card against the CPU from the same draws
   (``EPIC_FEATURIZE_TOL``).
8. flex: the as20k recipe trained with flexible patch sizes, from flac
   files. (a) The saving dual forward (outputs and states), K2 on both
   directions and the conv forward and backward against their plain
   versions at the token counts of patch 8 and 32 (``FLEX_DIMS``: B=12, L =
   2049 and 129), fp32 and bf16, and each one's ms beside its bound and its
   plain version's ms. (b) ``run.main`` with ``--set
   flexible_patch_sizes=8,12,16`` on 60 clips (flac, written by the native
   decoder library's encoder and decoded by it; WAV, with a line that says
   so, where the ffmpeg headers are missing): 5 steps at patches 16, 16,
   16, 12, 8, each with the train path's launches and a finite loss, and
   one validation batch with the eval path's; peak memory. (c) One train
   step at each of patches 8, 12, 16, 24, 32 through
   ``make_train_step(patch_size=)`` (AuM-Base Fo-Bi, B=12, split remat),
   bf16 and fp32: ms, launches, peak memory, a profiled step (bf16), and
   the least-squares slope of
   the peak over depth x B x L x d_inner, the bytes per element that
   ``remat_mode="auto"`` reads; "auto" must resolve to split at each. (d)
   fp32 on the card against the CPU on the same weights and draws: depth-2
   Fo-Bi train steps at patch 8 (B=1) and 32 (B=2) and a depth-2 Bi-Bi
   train step (phase 5's bounds); full-depth B=2 forwards with a random cls position,
   a shuffle and a flip, with RoPE, and Bi-Bi (``MODEL_FP32_TOL``). (e) Two
   bf16 Fo-Bi forwards at B=8, with the three stochastic knobs and with
   RoPE: finite logits and ``entry()``'s launches.
9. lm: the Mamba LM at mamba-130m's widths (bf16, 24 layers, random
   weights from seed 0): prefill of B=8 x 512 tokens (ms, tokens/s), one
   decode step (ms, tokens/s) and greedy generation of 32 tokens (ms,
   tokens/s, peak memory), each between a reset and a read of every launch
   counter: 24 with_state single-direction forwards and 24 convs per
   prefill and per generate, none per decode step. Then, fp32 at depth 2,
   the prefill's logits and caches and 8 decode steps' logits on the card
   against the CPU (``LM_FP32_TOL``), and on the card the prefill against
   decode_step stepped through a 64-token prompt (``LM_STEPWISE_TOL``).
10. porters: reference checkpoints with random weights through the
   porters and ``aum_tpu_torch.run.main``, on synthetic WAV clips: an
   AuM-Base Fo-Bi checkpoint of AudioSet's geometry (1024 x 128, 527
   classes, ``module.`` keys) into SpeechCommands
   (``audioset_pretrained_variant``: the grid resampled (8, 64) -> (8, 8),
   the head dropped), and an ImageNet ViM-small checkpoint (3-channel
   kernel, 14 x 14 grid, middle cls, under ``model``) into SpeechCommands'
   Bi-Bi small (``small_imagenet_variant``): 2 train steps (B=128) and a
   val batch each, the built model bit-equal to the porter's weights, each
   step's and batch's launches the train and eval paths'; ``--run-type eval
   --ckpt x.pth`` on an as20k val batch, bit-equal to the same weights drawn
   in process; the ported model in fp32 on the card against the CPU.
11. ast: the AST baseline (``ast_variant``: deit_base, strides 10, 1213
   tokens) on as20k from a random AST audio checkpoint at the (8, 64)
   pretrain grid: 3 train steps (the third profiled) and a val batch
   through ``run.main``, none launching a kernel of ours (ms per step,
   clips/s, idle share, peak memory); fp32 on the card against the CPU.
12. serving: AuM-Base Fo-Bi bundles at batch sizes 1, 8, 64 (bf16 float and
   int8, from log-mels and from 10 s waveforms; fp32): MB, load seconds,
   ``predict`` at B=3, 64, 70 against the in-process forward (fp32 1e-5
   elementwise, bf16 1e-2 of the largest logit: ``SERVE_TOL``), int8
   against float at the JAX package's bound, the B=64 predicts' launches,
   ms per predict at B=8 and 64 beside the in-process forward (in turns;
   the bf16 bundles but the int8 one from waveforms), the int8
   dequantization's ms, and the HTTP server's /healthz and
   /predict (topk 5).
13. bench: the ``bench.py`` workload (Fo-Bi, B=64 x 1024 x 128, bf16):
   clips/s with CUDA events after warm-up; then ``wav_entry``'s model at
   B=64 from waveforms: clips/s, and the frontend's ms alone. Then per kernel
   at the shapes those forwards give it: ms per launch, the plain version's
   ms, the least time the card could take (bound), and for the conv one
   PyTorch call computing the same function (``F.conv1d(groups=D)`` + SiLU)
   as a yardstick the port never calls. The scan bounds let a share of the
   exponentials run on the FP32 pipe (``exp_floor_s``). nvidia-smi samples
   the SM clock and power draw during the timed forwards and the timed
   kernel launches. Then the train shapes' scan kernels (B=12, bf16): the
   saving dual forward, the backward (both directions in one launch, and one
   direction), and the saving single-direction forward, each beside its plain
   version and its bound; the direct and fused kernels beside them (the
   fused backward and K2 in turns: fused, K2, K2, fused), and
   K2's with_state form, the stage form's saving forward, K2 with bf16
   partials and in its x-minus form (in turns with the default) and the
   fused kernel with bf16 partials. At the bench shapes also the fuse_dt
   form (its bound adds the dt_proj product on the tensor cores) and the
   stage form; the with_state single-direction forward at the LM prefill's
   shapes. B=64 Fo-Bi clips/s are timed in turns: default,
   AUM_SCAN_DIRECT=1, AUM_SCAN_FUSE_DT=1, AUM_SCAN_FUSE_DT=1,
   AUM_SCAN_DIRECT=1, default.
14. sizes (run after lm): the shapes the JAX package's ops take beyond the
   default paths'. Every scan form (the dual forward staged and direct, the
   single-direction one as is, saving and with_state, K2 and the fused
   backward, one and both directions, the stage, x-minus, bf16-partials and
   fuse_dt forms) at d_state 17, 24, 32, 64 and 128 on the ragged shape,
   which the kernels run as slices of 16 states and a combine; the scan
   without z and/or D at d_state 5, 16 and 40; the combine and its
   backward alone (at L=70000 too, at the train shapes, at a D not a
   multiple of 4; the backward run twice for the same bits); d_state 64 at
   AuM-Base's eval (B=64) and train (B=12)
   shapes; the conv at widths 1, 2, 3, 5, 8 and, through its general form,
   9, 12, 16 and 33 (past one window of taps), causal and anti-causal, at
   (8, 513, 1536) and at D=36 on an odd offset, and 40 (past L) there; the
   fuse_dt form at dt ranks 65, 80, 128, 256, and past 400 (its windowed
   form) 401, 416, 417 and 512, the last two at the width they imply (d_inner
   32 x rank, B=8). Then AuM-Base Fo-Bi with d_state 64 (bf16,
   depth 24): a B=64 eval forward and a B=12 train step with their launches,
   its fp32 depth-2 forward and train step against the CPU; the Mamba LM at
   mamba-130m's widths with d_state 64 and d_conv 3, and with d_state 16 and
   d_conv 12 (the conv's general form): a B=8 x 512 prefill and
   16 decode steps with their launches, and the fp32 depth-2 checks
   against the CPU and stepwise decoding. Then each new form's ms beside its
   bound and its plain version's: a sliced form one launch on one slice of
   16 states (its whole op beside it), the combine and its backward on
   planes of their own per direction, the conv at every width, the fuse_dt
   form at every rank (and past 400 at the width the rank implies).
15. profile: one Fo-Bi bench forward (and one under AUM_SCAN_FUSE_DT=1),
   one Fo-Fo forward from waveforms (B=64), then one train step, under
   ``torch.profiler``: device time by
   kernel category (dual and single scan forward, scan backward, conv,
   frontend FFTs, matrix products, other), the top kernels, and the device's
   idle share of the wall time.
16. ref_oracles (run after serving): the port against the upstream code's
   fused ops as ``convert/ref_runner.py`` writes them (torch oracles written
   without the port's ops), on the card: one AuM-Base mixer layer (d_model
   768, B=2, L=513) for Fo-Fo (``mamba_inner_fn``), Fo-Bi
   (``bimamba_inner_fn``) and Bi-Bi (two ``mamba_inner_fn_no_out_proj``,
   the second on the flipped sequence), fp32 and bf16, its inference
   forward (elementwise) and the grads of its input and every weight (in
   bf16 against the oracle's fp32 grads: ``_check_ref_mixer``); the scan
   with its last state against the with_state scan, the conv, and
   add+RMSNorm alone; every kernel of those paths must have launched.
17. tools (run after ref_oracles): each user tool's ``main(argv)`` on the
   card (``python -m aum_tpu_torch.scripts.<name>``): ``infer`` (AuM-Base
   Fo-Bi from a 10 s WAV and a reference ``.pth``; its top-5 equal to the
   in-process forward's; ms per clip at B=1), ``export_torch_ckpt``,
   ``verify_ckpt`` (record, verify, the raw fbank goldens; fp32 logits
   against ``--device cpu``), ``verify_lm`` (a random LM at mamba-130m's
   widths by directory and as a cached hub id: equal logits),
   ``get_norm_stats`` and ``gen_weight_file`` against ``--device cpu``,
   each with its launches and seconds; ``--ref-parity`` reported as
   skipped with its reason while no upstream checkout is present; then
   the HTTP front under concurrent clients against sequential
   ``predict_scores``.

Every phase runs with the switches (``SWITCHES``) off and sets them
itself, restoring the environment after; each prints its seconds. The line
before the last is nvidia-smi's name and power limit; the one before it the
kernels summary; the last line is exactly
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

import torch

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
FP32_PIPE_OPS_PER_S = FP32_FLOPS_PER_S / 2  # an FMA is two flops, one instruction
BF16_TENSOR_FLOPS_PER_S = 989e12  # dense bf16 on the tensor cores
# Special-function-unit exponentials: 16 per SM per clock (Hopper SM).
SFU_PER_SM_PER_CLOCK = 16
# The scan's FP32-pipe instructions per (b, l, d, n) element and direction:
# dt*A and dt*u*B (two multiplies), the state update and the C readout (two
# FMAs): the six flops of its fp32 count.
SCAN_FP32_OPS_PER_ELEMENT = 4
# An exp2 emulated on the FP32 pipe (as FlashAttention-style kernels move part
# of theirs off the SFUs): range reduction (3 adds) and a degree-3 polynomial
# (3 FMAs).
FP32_OPS_PER_EMULATED_EXP = 6

# The scan backward's FP32-pipe instructions per (b, l, d, n) element and
# direction, the least its adjoint needs, each counted once: dt*A for the
# exp2, the state recompute (a multiply, an FMA), the y readout (FMA), lam
# (FMA), a*lam (a multiply: the carry, and a factor of lam*a*x_{t-1}), its
# product with x_{t-1} (a multiply), dA and sum_n lam*a*x_{t-1}*A (two FMAs),
# sum_n lam*B (FMA), dB and dC as dot products over channels (an FMA each).
SCAN_BWD_FP32_OPS_PER_ELEMENT = 12

SCAN_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}  # (atol, rtol)
CONV_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 1e-2)}
# Saved states are fp32 in both dtypes, from the same inputs: the fp32 bound.
XB_TOL = (1e-4, 1e-4)
# Grads, as max |err| over the reference's max |value|: fp32 sums in another
# order; in bf16 du, ddelta, dz, dB, dC (and dx, dw, db) are rounded to bf16,
# one ulp of 2^-8 relative at most.
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
MODEL_FP32_TOL = (2e-3, 2e-3)
# The paths' scan and conv shapes (batch, tokens, d_inner) at AuM-Base's 513
# tokens and d_inner 1536: the eval entries' B=8, the train entry's B=12;
# and the bench batch.
EVAL_DIMS = (8, 513, 1536)
TRAIN_DIMS = (12, 513, 1536)
# The recipe phase's: as20k validation (B=24, batch_size * 2); SpeechCommands'
# 128 frames (64 patches and the cls token: 65 tokens) in its train steps
# (B=128) and its validation (B=256).
RECIPE_DIMS = {"as20k_val": ((24, 513, 1536), False),
               "speechcommands_train": ((128, 65, 1536), True),
               "speechcommands_val": ((256, 65, 1536), False)}
BENCH_BATCH = 64
# The Mamba LM's prefill: B=8 prompts of 512 tokens at mamba-130m's d_inner
# 1536 (``scripts/bench_lm_decode.py``'s shapes).
LM_PREFILL_DIMS = (8, 512, 1536)
# fp32 train step, card (kernels) against CPU (plain): loss relative, grads
# as max |err| over max |ref|; the two sum in other orders over 2 layers.
# The params after one Adam step, as ||card - cpu|| over the norm of the
# CPU's update: Adam's first step moves each param by lr * g / (|g| + eps),
# about lr whatever |g|, so where |g| is within a few grad errors of eps
# (1e-8) or of zero the two updates may differ by up to 2 lr; a step that
# never reached the params reads 1 (an H100 read at most 1.9e-4).
TRAIN_FP32_TOL = {"loss_rtol": 1e-4, "grad": 1e-3, "update": 1e-2}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    return float(smi("clocks.max.sm").split()[0]) * 1e6


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call over ``iters`` calls, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


SWITCHES = ("AUM_SCAN_DIRECT", "AUM_SCAN_BWD_FUSED", "AUM_SCAN_DUAL_BWD", "AUM_SCAN_FUSE_DT",
            "AUM_SCAN_BF16_STAGE", "AUM_SCAN_BWD_BF16_PARTIALS", "AUM_SCAN_BWD_XMINUS",
            "AUM_SCAN_BWD_DBU")


@contextlib.contextmanager
def scan_switches(**switches):
    """The port's scan switches (``SWITCHES``, each on or off) for the block;
    the environment is restored after it."""
    saved = {name: os.environ.get(name) for name in switches}
    os.environ.update({name: str(int(bool(on))) for name, on in switches.items()})
    try:
        yield
    finally:
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value


@contextlib.contextmanager
def sample_clocks(out: dict, period_ms: int = 50):
    """Sample the card's SM clock and power draw while the block runs; the
    min/median/max of each land in ``out``."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
         f"--loop-ms={period_ms}"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        yield out
    finally:
        proc.terminate()
        text, _ = proc.communicate(timeout=30)
    rows = []
    for line in text.splitlines():
        try:
            rows.append([float(v) for v in line.split(",")])
        except ValueError:
            continue
    for i, key in enumerate(("sm_clock_mhz", "power_w")):
        vals = sorted(r[i] for r in rows)
        out[key] = ({"min": vals[0], "median": vals[len(vals) // 2], "max": vals[-1]}
                    if vals else None)
    out["samples"] = len(rows)


def exp_floor_s(exps: float, fp32_ops: float, sfu_rate: float) -> float:
    """Least time for ``exps`` exponentials beside ``fp32_ops`` FP32-pipe
    instructions, when any share of the exponentials may run as polynomials on
    the FP32 pipe instead of the SFUs. At the best share both pipes finish
    together: every exponential costs FP32_OPS_PER_EMULATED_EXP pipe
    instructions, over the FP32 pipe's rate plus the SFUs' in those units.
    (Issue slots, which both pipes share, are not counted: this stays a floor.)"""
    p = FP32_OPS_PER_EMULATED_EXP
    split = (p * exps + fp32_ops) / (FP32_PIPE_OPS_PER_S + p * sfu_rate)
    return max(fp32_ops / FP32_PIPE_OPS_PER_S, min(exps / sfu_rate, split))


def compare(got: torch.Tensor, want: torch.Tensor, atol: float, rtol: float) -> dict:
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    return {"max_abs_err": diff.max().item(),
            "max_rel_err": (diff / w.abs().clamp_min(1e-6)).max().item(),
            "atol": atol, "rtol": rtol,
            "ok": bool(torch.isfinite(g).all() and (diff <= atol + rtol * w.abs()).all())}


def compare_scaled(got: torch.Tensor, want: torch.Tensor, tol: float) -> dict:
    """max |got - want| against tol * max |want|: for grads, whose elements
    may cancel to near zero."""
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    scale = w.abs().max().item()
    return {"max_abs_err": err, "max_ref": scale, "scaled_err": err / max(scale, 1e-30),
            "tol": tol, "ok": bool(torch.isfinite(g).all()) and err <= tol * scale}


# --- inputs ------------------------------------------------------------------

def scan_inputs(bsz, seqlen, d, n, dtype, seed, device="cuda"):
    """One direction's (u, delta, A, B, C, D, z, bias) as the mixer passes
    them: z a column view of the in_proj output, B/C columns of x_proj's."""
    g = torch.Generator().manual_seed(seed)
    rank = 48

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(device)

    xz = randn(bsz, seqlen, 2 * d).to(dtype)
    x_dbl = randn(bsz, seqlen, rank + 2 * n).to(dtype)
    u = randn(bsz, seqlen, d).to(dtype)
    delta = randn(bsz, seqlen, d, scale=0.5).to(dtype)
    A = -(torch.arange(1, n + 1, dtype=torch.float32).expand(d, n)
          * torch.exp(torch.randn((d, n), generator=g) * 0.1)).to(device)
    # The mixer's dt-bias init: softplus(bias) log-uniform in [1e-3, 1e-1].
    dt0 = torch.exp(torch.rand(d, generator=g) * math.log(100.0) + math.log(1e-3))
    bias = (dt0 + torch.log(-torch.expm1(-dt0))).to(device)
    D = randn(d)
    return (u, delta, A, x_dbl[..., rank:rank + n], x_dbl[..., rank + n:], D,
            xz[..., d:], bias)


def fold_inputs(bsz, seqlen, d, n, dtype, seed, rank=48, device="cuda"):
    """One direction's (u, dtr, W, A, B, C, D, z, bias) as the mixer passes
    them under AUM_SCAN_FUSE_DT=1: dtr, B and C columns of one x_proj output,
    W (rank, D) the transposed view of a (D, rank) dt_proj weight (the
    mixer's init), z a column view of the in_proj output."""
    g = torch.Generator().manual_seed(seed)
    u, _, A, _, _, D, z, bias = scan_inputs(bsz, seqlen, d, n, dtype, seed, device)
    x_dbl = torch.randn((bsz, seqlen, rank + 2 * n), generator=g).to(device, dtype)
    w = ((torch.rand((d, rank), generator=g) * 2 - 1) / math.sqrt(rank)).to(device, dtype)
    return (u, x_dbl[..., :rank], w.t(), A, x_dbl[..., rank:rank + n], x_dbl[..., rank + n:],
            D, z, bias)


def conv_inputs(bsz, seqlen, d, k, dtype, seed, device="cuda", offset=0):
    """x a column slice, from channel ``offset``, of an in_proj-shaped
    output, as the mixer passes it (an odd offset breaks its alignment)."""
    g = torch.Generator().manual_seed(seed)
    xz = torch.randn((bsz, seqlen, 2 * d), generator=g).to(device=device, dtype=dtype)
    w = (torch.rand((d, k), generator=g) * 2 - 1).mul(0.5).to(device=device, dtype=dtype)
    b = (torch.rand((d,), generator=g) * 2 - 1).mul(0.5).to(device=device, dtype=dtype)
    return xz[..., offset:offset + d], w, b


# --- phases ------------------------------------------------------------------

def phase_device() -> dict:
    name_power = smi("name,power.limit")
    print(name_power, flush=True)
    info = {"phase": "device", "nvidia_smi": name_power,
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "sms": torch.cuda.get_device_properties(0).multi_processor_count,
            "max_sm_clock_mhz": max_sm_clock_hz() / 1e6,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0]}
    emit(info)
    return info


def phase_build() -> None:
    from aum_tpu_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {}
    for name, path in paths.items():
        log = path.with_suffix(".log")
        lines = log.read_text().splitlines() if log.exists() else []
        ptxas[name] = [ln.strip() for ln in lines
                       if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    # The recipe path's host WAV decoder (csrc/wavloader.cpp, g++).
    from aum_tpu_torch.data import native

    t0 = time.perf_counter()
    decoder = native.build()
    emit({"phase": "build", "seconds": seconds, "libraries": [p.name for p in paths.values()],
          "ptxas": ptxas, "wav_decoder": decoder.name,
          "wav_decoder_seconds": time.perf_counter() - t0})
    # What the occupancy calculator gives each kernel the paths launch.
    emit({"phase": "occupancy", "kernels": {name: _build.kernel_resources(name)
                                            for name in _build.LIBRARIES}})


GRAD_NAMES = ("du", "ddelta", "dA", "dB", "dC", "dD", "dz", "dbias")


def _scan_dirs(bsz, seqlen, d, dtype, shared, n=16):
    """Both directions' (u, dt, A, B, C, D, z) as the mixer passes them."""
    from aum_tpu_torch.ops.selective_scan import _prep_dt

    fwd = scan_inputs(bsz, seqlen, d, n, dtype, seed=1)
    rev = fwd if shared else scan_inputs(bsz, seqlen, d, n, dtype, seed=2)
    if shared:  # bimamba v1: same operands, its own A
        rev = (fwd[0], fwd[1], fwd[2] * 0.5) + fwd[3:]
    dt_f = _prep_dt(fwd[1], fwd[7])
    dt_r = dt_f if shared else _prep_dt(rev[1], rev[7])
    return ((fwd[0], dt_f) + fwd[2:7], (rev[0], dt_r) + rev[2:7])


def _check_scan(label, dims, dtype, shared, train: bool, n=16) -> list[dict]:
    """The eval forward, or (train) the saving forward and both forms of the
    backward (one launch for both directions, one per direction), with and
    without the softplus, against their plain versions: each through the
    default kernel and through the one its switch chooses (the direct
    forward, the fused backward), which is also held to the default
    kernel's result. ``n``: d_state."""
    from aum_tpu_torch.ops.selective_scan import (
        selective_scan_bwd_cuda,
        selective_scan_bwd_plain,
        selective_scan_dual_cuda,
        selective_scan_dual_plain,
    )

    bsz, seqlen, d = dims
    tag = dict(shape=label, dims=[bsz, seqlen, d, n], dtype=str(dtype),
               bimamba="v1" if shared else "v2")
    dir_f, dir_r = _scan_dirs(bsz, seqlen, d, dtype, shared, n)
    atol, rtol = SCAN_TOL[dtype]
    results = []
    fwd_kernels = {False: "selective_scan_dual_fwd", True: "selective_scan_dual_direct_fwd"}
    got = {}
    for direct, kernel in fwd_kernels.items():
        with scan_switches(AUM_SCAN_DIRECT=direct):
            got[direct] = selective_scan_dual_cuda(dir_f, dir_r, save_states=train)
        torch.cuda.synchronize()
    want = selective_scan_dual_plain(dir_f, dir_r, save_states=train)
    for direct, kernel in fwd_kernels.items():
        refs = {"plain": want, **({"staged_kernel": got[False]} if direct else {})}
        for against, ref in refs.items():
            for i, (y, w) in enumerate(zip(got[direct], ref)):
                tol = (atol, rtol) if i < 2 else XB_TOL
                extra = {"save_states": True, "output": "out" if i < 2 else "xb"} if train else {}
                results.append({**compare(y, w, *tol), "kernel": kernel, "against": against,
                                **extra, "direction": "reverse" if i % 2 else "forward", **tag})
    if not train:
        return results
    xb_f, xb_r = got[False][2:]
    g = torch.Generator().manual_seed(5)
    gs = [torch.randn((bsz, seqlen, d), generator=g).to("cuda", dtype) for _ in range(2)]
    dirs = [dir_f + (False,), dir_r + (True,)]
    for softplus in (True, False):
        want = selective_scan_bwd_plain(dirs, gs, softplus)
        k2 = {}
        for fused, kernel in ((False, "selective_scan_bwd"), (True, "selective_scan_bwd_fused")):
            with scan_switches(AUM_SCAN_BWD_FUSED=fused):
                forms = {"two_directions": selective_scan_bwd_cuda(dirs, gs, [xb_f, xb_r],
                                                                   softplus),
                         "one_direction": [selective_scan_bwd_cuda([dirs[i]], [gs[i]], [xb],
                                                                   softplus)[0]
                                           for i, xb in enumerate((xb_f, xb_r))]}
            torch.cuda.synchronize()
            for form, grads in forms.items():
                refs = {"plain": want, **({"k2": k2[form]} if fused else {})}
                for against, ref in refs.items():
                    for direction, (gr, wr) in enumerate(zip(grads, ref)):
                        results.append({**_grad_checks(GRAD_NAMES, gr, wr, GRAD_TOL[dtype]),
                                        "kernel": kernel,
                                        "form": form + ("" if softplus else "_no_softplus"),
                                        "against": against,
                                        "direction": "reverse" if direction else "forward",
                                        **tag})
            k2 = forms
    return results


def _check_fdt(label, dims, dtype, shared, n=16, rank=48) -> list[dict]:
    """The fuse_dt dual forward (eval) against its plain version, and against
    the staged kernel fed the materialised dt: in fp32 elementwise at the
    fp32 tolerance; in bf16 the staged kernel streams dt rounded to bf16,
    which the fuse_dt form does not, so the two compute different functions
    and differ where y + D u cancels: there as max |err| over max |ref|,
    at the bf16 tolerance (GRAD_TOL)."""
    from aum_tpu_torch.ops.selective_scan import (
        fold_dt,
        selective_scan_dual_cuda,
        selective_scan_dual_fdt_cuda,
        selective_scan_dual_fdt_plain,
    )

    bsz, seqlen, d = dims
    tag = dict(shape=label, dims=[bsz, seqlen, d, n], rank=rank, dtype=str(dtype),
               bimamba="v1" if shared else "v2")
    fwd = fold_inputs(bsz, seqlen, d, n, dtype, seed=21, rank=rank)
    rev = (fwd[:3] + (fwd[3] * 0.5,) + fwd[4:] if shared
           else fold_inputs(bsz, seqlen, d, n, dtype, seed=22, rank=rank))
    got = selective_scan_dual_fdt_cuda(fwd, rev)
    torch.cuda.synchronize()

    def materialised(f):
        return (f[0], fold_dt(f[1], f[2], f[8]).to(dtype)) + f[3:8]

    refs = {"plain": selective_scan_dual_fdt_plain(fwd, rev),
            "staged_kernel_materialised_dt": selective_scan_dual_cuda(
                materialised(fwd), materialised(rev), direct=False)}
    results = []
    for against, ref in refs.items():
        for i, (y, w) in enumerate(zip(got, ref)):
            scaled = against != "plain" and dtype == torch.bfloat16
            r = compare_scaled(y, w, GRAD_TOL[dtype]) if scaled else compare(y, w, *SCAN_TOL[dtype])
            results.append({**r, "kernel": "selective_scan_dual_fdt_fwd", "against": against,
                            "direction": "reverse" if i else "forward", **tag})
    return results


def _check_stage(label, dims, shared, n=16) -> list[dict]:
    """The stage form (AUM_SCAN_BF16_STAGE=1) of the staged dual forward, eval
    and saving, bf16, against its plain version; in fp32 the switch changes
    nothing: bit-equal to the default kernel."""
    from aum_tpu_torch.ops.selective_scan import (
        selective_scan_dual,
        selective_scan_dual_cuda,
        selective_scan_dual_plain,
    )

    bsz, seqlen, d = dims
    results = []
    for dtype in (torch.bfloat16, torch.float32):
        tag = dict(shape=label, dims=[bsz, seqlen, d, n], dtype=str(dtype),
                   bimamba="v1" if shared else "v2")
        dir_f, dir_r = _scan_dirs(bsz, seqlen, d, dtype, shared, n)
        for save in (False, True):
            before = selective_scan_dual.stage_launches
            with scan_switches(AUM_SCAN_BF16_STAGE=True):
                got = selective_scan_dual_cuda(dir_f, dir_r, save_states=save)
            torch.cuda.synchronize()
            extra = {"save_states": True} if save else {}
            if dtype == torch.float32:
                base = selective_scan_dual_cuda(dir_f, dir_r, save_states=save)
                same = all(torch.equal(a, b) for a, b in zip(got, base))
                results.append({"kernel": "selective_scan_dual_fwd", "check": "bf16_stage_fp32_noop",
                                "against": "default_kernel", "bit_equal": same,
                                "max_abs_err": 0.0 if same else float("nan"), "ok": same,
                                **extra, **tag})
                continue
            ran = selective_scan_dual.stage_launches == before + math.ceil(n / 16)
            want = selective_scan_dual_plain(dir_f, dir_r, save_states=save, bf16_stage=True)
            for i, (y, w) in enumerate(zip(got, want)):
                tol = SCAN_TOL[dtype] if i < 2 else XB_TOL
                r = compare(y, w, *tol)
                results.append({**r, "ok": r["ok"] and ran, "kernel": "selective_scan_dual_stage_fwd",
                                "against": "plain", "output": "out" if i < 2 else "xb",
                                "direction": "reverse" if i % 2 else "forward", **extra, **tag})
    return results


def _check_bwd_forms(label, dims, dtype, n=16) -> list[dict]:
    """The backward's opt-in forms, v1 operands: K2 and the fused kernel with
    bf16 dB/dC partials against the same kernel's fp32-partials launch (dB
    and dC at the bf16 grad tolerance, every other output bit-equal), both
    directions in one launch and one direction; K2's x-minus form
    (AUM_SCAN_BWD_XMINUS=1) against the plain backward, both directions, one
    direction and the with_state form (9 grads)."""
    from aum_tpu_torch.ops import selective_scan_bwd
    from aum_tpu_torch.ops.selective_scan import (
        selective_scan_bwd_cuda,
        selective_scan_bwd_plain,
        selective_scan_cuda,
        selective_scan_dual_cuda,
    )

    bsz, seqlen, d = dims
    tag = dict(shape=label, dims=[bsz, seqlen, d, n], dtype=str(dtype), bimamba="v1")
    dir_f, dir_r = _scan_dirs(bsz, seqlen, d, dtype, True, n)
    _, _, xb_f, xb_r = selective_scan_dual_cuda(dir_f, dir_r, save_states=True)
    g = torch.Generator().manual_seed(25)
    gs = [torch.randn((bsz, seqlen, d), generator=g).to("cuda", dtype) for _ in range(2)]
    dirs = [dir_f + (False,), dir_r + (True,)]

    def launches(**switches):
        with scan_switches(**switches):
            out = {"two_directions": selective_scan_bwd_cuda(dirs, gs, [xb_f, xb_r]),
                   "one_direction": [selective_scan_bwd_cuda([dirs[i]], [gs[i]], [xb])[0]
                                     for i, xb in enumerate((xb_f, xb_r))]}
        torch.cuda.synchronize()
        return out

    results = []
    for fused, kernel in ((False, "selective_scan_bwd"), (True, "selective_scan_bwd_fused")):
        base = launches(AUM_SCAN_BWD_FUSED=fused)
        before = selective_scan_bwd.bf16_partials_launches
        part = launches(AUM_SCAN_BWD_FUSED=fused, AUM_SCAN_BWD_BF16_PARTIALS=True)
        ran = selective_scan_bwd.bf16_partials_launches == before + 3 * math.ceil(n / 16)
        for form, grads in part.items():
            for direction, (gr, br) in enumerate(zip(grads, base[form])):
                checks = {name: compare_scaled(a, b, GRAD_TOL[torch.bfloat16])
                          for name, a, b in zip(GRAD_NAMES, gr, br) if name in ("dB", "dC")}
                same = all(torch.equal(a, b) for name, a, b in zip(GRAD_NAMES, gr, br)
                           if name not in ("dB", "dC"))
                results.append({"max_abs_err": max(c["max_abs_err"] for c in checks.values()),
                                "tol": GRAD_TOL[torch.bfloat16],
                                "grads": {k: [c["max_abs_err"], c["scaled_err"]]
                                          for k, c in checks.items()},
                                "others_bit_equal": same,
                                "ok": ran and same and all(c["ok"] for c in checks.values()),
                                "kernel": kernel, "variant": "bf16_partials", "form": form,
                                "against": "fp32_partials_launch",
                                "direction": "reverse" if direction else "forward", **tag})
    want = selective_scan_bwd_plain(dirs, gs)
    before = selective_scan_bwd.xminus_launches
    got = launches(AUM_SCAN_BWD_XMINUS=True)
    ran = selective_scan_bwd.xminus_launches == before + 3 * math.ceil(n / 16)
    for form, grads in got.items():
        for direction, (gr, wr) in enumerate(zip(grads, want)):
            r = _grad_checks(GRAD_NAMES, gr, wr, GRAD_TOL[dtype])
            results.append({**r, "ok": r["ok"] and ran, "kernel": "selective_scan_bwd",
                            "variant": "xminus", "form": form, "against": "plain",
                            "direction": "reverse" if direction else "forward", **tag})
    # The with_state form: a random starting state and final-state cotangent.
    x0, gfin = (torch.randn((bsz, d, n), generator=g).cuda() for _ in range(2))
    _, xb_s, _ = selective_scan_cuda(dir_f, False, save_states=True, initial_state=x0,
                                     return_final_state=True)
    before = selective_scan_bwd.xminus_launches
    with scan_switches(AUM_SCAN_BWD_XMINUS=True):
        got = selective_scan_bwd_cuda(dirs[:1], gs[:1], [xb_s], gfins=[gfin])[0]
    torch.cuda.synchronize()
    ran = selective_scan_bwd.xminus_launches == before + math.ceil(n / 16)
    want = selective_scan_bwd_plain(dirs[:1], gs[:1], states=[(x0, gfin)])[0]
    r = _grad_checks(GRAD_NAMES + ("dx0",), got, want, GRAD_TOL[dtype])
    results.append({**r, "ok": r["ok"] and ran, "kernel": "selective_scan_bwd",
                    "variant": "xminus", "form": "with_state", "with_state": True,
                    "against": "plain", "direction": "forward", **tag})
    return results


# The small-dt probe: K2 and the fused kernel form the softplus chain rule
# as ddt (1 - 2^(-dt log2 e)) with the SFU's exp2; the difference of two
# numbers near 1 may lose relative precision at small dt. A kernel fails the
# probe where its relative error exceeds the plain version's by more than
# this factor.
SMALL_DT_RATIO = 4.0


def probe_small_dt() -> list[dict]:
    """ddelta at dt in [1e-6, 1e-4] (log-uniform), fp32, one direction: K2,
    the fused kernel and the plain version each against an fp64 evaluation
    of its own ddt times (1 - e^(-dt)) (ddt from the same kernel launched
    without the softplus, whose adjoint is the same computation), as the
    relative error over elements whose reference exceeds 1e-3 of the
    largest; max and median."""
    from aum_tpu_torch.ops.selective_scan import (
        selective_scan_bwd_cuda,
        selective_scan_bwd_plain,
        selective_scan_cuda,
    )

    bsz, seqlen, d, n = 2, 150, 64, 16
    raw = scan_inputs(bsz, seqlen, d, n, torch.float32, seed=27)
    g = torch.Generator().manual_seed(28)
    dt = torch.exp(torch.rand((bsz, seqlen, d), generator=g) * math.log(100.0)
                   + math.log(1e-6)).cuda()
    args = (raw[0], dt) + raw[2:7]
    gout = torch.randn((bsz, seqlen, d), generator=g).cuda()
    _, xb = selective_scan_cuda(args, False, save_states=True)
    factor = -torch.expm1(-dt.double())

    def rel_err(ddelta, ddt):
        ref = ddt.double() * factor
        keep = ref.abs() > 1e-3 * ref.abs().max()
        err = ((ddelta.double() - ref).abs() / ref.abs())[keep]
        return {"max_rel_err": err.max().item(), "median_rel_err": err.median().item(),
                "elements": int(keep.sum())}

    dirs = [args + (False,)]
    errs = {"plain": rel_err(selective_scan_bwd_plain(dirs, [gout], True)[0][1],
                             selective_scan_bwd_plain(dirs, [gout], False)[0][1])}
    for fused, kernel in ((False, "selective_scan_bwd"), (True, "selective_scan_bwd_fused")):
        with scan_switches(AUM_SCAN_BWD_FUSED=fused):
            errs[kernel] = rel_err(selective_scan_bwd_cuda(dirs, [gout], [xb], True)[0][1],
                                   selective_scan_bwd_cuda(dirs, [gout], [xb], False)[0][1])
    limit = SMALL_DT_RATIO * errs["plain"]["max_rel_err"]
    return [{"kernel": k, "check": "small_dt_ddelta", "dims": [bsz, seqlen, d, n],
             "dt_range": [1e-6, 1e-4], "dtype": str(torch.float32), "shape": "small_dt",
             **errs[k], "plain": errs["plain"], "ratio_limit": SMALL_DT_RATIO,
             "max_abs_err": errs[k]["max_rel_err"], "ok": errs[k]["max_rel_err"] <= limit}
            for k in ("selective_scan_bwd", "selective_scan_bwd_fused")]


def _check_scan_single(label, dims, dtype, reverse, train: bool, n=16) -> list[dict]:
    """The single-direction forward and its with_state form, or (train) its
    saving form and the backward of the autograd op (``selective_scan``
    under grad: the saving forward, then the one-direction backward kernel),
    against their plain versions. ``n``: d_state."""
    from aum_tpu_torch.ops.selective_scan import (
        _prep_dt,
        selective_scan,
        selective_scan_bwd_plain,
        selective_scan_cuda,
        selective_scan_plain,
    )

    bsz, seqlen, d = dims
    tag = dict(shape=label, dims=[bsz, seqlen, d, n], dtype=str(dtype),
               direction="reverse" if reverse else "forward")
    raw = scan_inputs(bsz, seqlen, d, n, dtype, seed=11)
    args = (raw[0], _prep_dt(raw[1], raw[7])) + raw[2:7]
    atol, rtol = SCAN_TOL[dtype]
    g = torch.Generator().manual_seed(12)
    results = []

    def check(got, want, tol, **kw):
        results.append({**compare(got, want, *tol), "kernel": "selective_scan_fwd", **kw, **tag})

    if not train:
        got = selective_scan_cuda(args, reverse)
        torch.cuda.synchronize()
        check(got, selective_scan_plain(args, reverse), (atol, rtol))
        x0 = torch.randn((bsz, d, n), generator=g).cuda()
        got, fin = selective_scan_cuda(args, reverse, initial_state=x0, return_final_state=True)
        torch.cuda.synchronize()
        want, want_fin = selective_scan_plain(args, reverse, initial_state=x0,
                                              return_final_state=True)
        check(got, want, (atol, rtol), with_state=True, output="out")
        check(fin, want_fin, XB_TOL, with_state=True, output="final_state")
        return results
    got, xb = selective_scan_cuda(args, reverse, save_states=True)
    torch.cuda.synchronize()
    want, want_xb = selective_scan_plain(args, reverse, save_states=True)
    check(got, want, (atol, rtol), save_states=True, output="out")
    check(xb, want_xb, XB_TOL, save_states=True, output="xb")
    gout = torch.randn((bsz, seqlen, d), generator=g).to("cuda", dtype)
    x0 = torch.randn((bsz, d, n), generator=g).cuda()
    gfin = torch.randn((bsz, d, n), generator=g).cuda()
    # The autograd op's backward: as the Fo-Fo train step runs it; without
    # the softplus (ddelta = ddt; delta is then the positive dt itself, with
    # no bias); and the with_state form from a random x0 with a random
    # cotangent of the final state (9 grads, dx0 the last).
    forms = {"one_direction_autograd": (True, False),
             "one_direction_autograd_no_softplus": (False, False),
             "with_state_autograd": (True, True)}
    for form, (softplus, with_state) in forms.items():
        inputs = raw if softplus else args
        leaves = [t.detach().requires_grad_() for t in inputs]  # strided views stay strided
        bias = leaves[7] if softplus else None
        kw = {}
        if with_state:
            leaves.append(x0.clone().requires_grad_())
            kw = {"initial_state": leaves[-1], "return_final_state": True}
        out = selective_scan(*leaves[:7], delta_bias=bias, delta_softplus=softplus,
                             reverse=reverse, **kw)
        torch.autograd.backward(out, (gout, gfin) if with_state else gout)
        torch.cuda.synchronize()
        want = selective_scan_bwd_plain([args + (reverse,)], [gout], softplus,
                                        [(x0, gfin)] if with_state else None)[0]
        names = GRAD_NAMES + (("dx0",) if with_state else ())
        got = [t.grad for t in leaves]
        if not softplus:  # no bias: compare the 7 grads
            names, want = names[:7], want[:7]
        results.append({**_grad_checks(names, got, want, GRAD_TOL[dtype]),
                        "kernel": "selective_scan_bwd", "form": form,
                        **({"with_state": True} if with_state else {}), **tag})
    return results


def _check_chained(label, dims, dtype) -> list[dict]:
    """A scan split at an uneven point, the second segment started from the
    first one's final state (reverse: the right-hand segment first), against
    the unsplit scan: outputs and all 8 grads under autograd, forward and
    reverse (the property sequence parallelism rests on). Runs the
    single-direction forward's with_state form and K2's with_state backward."""
    from aum_tpu_torch.ops.selective_scan import selective_scan

    bsz, seqlen, d = dims
    split = seqlen * 2 // 5 + 1
    raw = scan_inputs(bsz, seqlen, d, 16, dtype, seed=14)
    gout = torch.randn((bsz, seqlen, d), generator=torch.Generator().manual_seed(15))
    gout = gout.to("cuda", dtype)
    atol, rtol = SCAN_TOL[dtype]
    results = []
    for reverse in (False, True):
        outs, grads = {}, {}
        for mode in ("unsplit", "chained"):
            _reset_counters()
            leaves = [t.detach().requires_grad_() for t in raw]
            u, delta, A, B, C, D, z, bias = leaves

            def scan(lo, hi, **kw):
                return selective_scan(u[:, lo:hi], delta[:, lo:hi], A, B[:, lo:hi],
                                      C[:, lo:hi], D, z[:, lo:hi], delta_bias=bias,
                                      delta_softplus=True, reverse=reverse, **kw)

            if mode == "unsplit":
                y = scan(0, seqlen)
            else:
                first, second = ((split, seqlen), (0, split)) if reverse else \
                    ((0, split), (split, seqlen))
                y_a, state = scan(*first, return_final_state=True)
                y_b = scan(*second, initial_state=state)
                y = torch.cat((y_b, y_a) if reverse else (y_a, y_b), dim=1)
            y.backward(gout)
            torch.cuda.synchronize()
            outs[mode], grads[mode] = y.detach(), [t.grad for t in leaves]
        launches = {k: v for k, v in _read_counters().items() if v}  # of the chained run
        tag = dict(shape=label, dims=[bsz, seqlen, d, 16], split=split, dtype=str(dtype),
                   direction="reverse" if reverse else "forward", launches=launches)
        results.append({**compare(outs["chained"], outs["unsplit"], atol, rtol),
                        "kernel": "selective_scan_fwd", "check": "chained_segments",
                        "with_state": True, "output": "out", **tag})
        results.append({**_grad_checks(GRAD_NAMES, grads["chained"], grads["unsplit"],
                                       GRAD_TOL[dtype]),
                        "kernel": "selective_scan_bwd", "check": "chained_segments",
                        "with_state": True, **tag})
    return results


def _grad_checks(names, got, want, tol) -> dict:
    """One line for a set of grads: each one's max abs and scaled error, the
    largest abs error over all of them, ok if each is within tol."""
    checks = {name: compare_scaled(g, w, tol) for name, g, w in zip(names, got, want)
              if w is not None}
    return {"max_abs_err": max(c["max_abs_err"] for c in checks.values()), "tol": tol,
            "grads": {k: [c["max_abs_err"], c["scaled_err"]] for k, c in checks.items()},
            "ok": all(c["ok"] for c in checks.values())}


def _check_conv(label, dims, dtype, train: bool, offset=0, k=4) -> list[dict]:
    """The conv forward (or, train, its backward) against the plain version,
    causal and anti-causal, with bias and SiLU and without; x a column slice
    from channel ``offset``; width ``k``."""
    from aum_tpu_torch.ops.conv1d import (
        causal_conv1d_bwd_cuda,
        causal_conv1d_bwd_plain,
        causal_conv1d_cuda,
        causal_conv1d_plain,
    )

    bsz, seqlen, d = dims
    results = []
    for reverse in (False, True):
        for with_bias, act in ((True, "silu"), (False, None)):
            x, w, b = conv_inputs(bsz, seqlen, d, k, dtype, seed=3, offset=offset)
            b = b if with_bias else None
            tag = dict(shape=label, dims=[bsz, seqlen, d, k], dtype=str(dtype),
                       reverse=reverse, bias=with_bias, activation=act,
                       **({"offset": offset} if offset else {}))
            if not train:
                got = causal_conv1d_cuda(x, w, b, act, reverse)
                torch.cuda.synchronize()
                results.append({**compare(got, causal_conv1d_plain(x, w, b, act, reverse),
                                          *CONV_TOL[dtype]),
                                "kernel": "causal_conv1d_fwd", **tag})
                continue
            g = torch.randn((bsz, seqlen, d), generator=torch.Generator().manual_seed(6))
            g = g.to("cuda", dtype)
            got = causal_conv1d_bwd_cuda(x, w, b, g, act, reverse)
            torch.cuda.synchronize()
            want = causal_conv1d_bwd_plain(x, w, b, g, act, reverse)
            results.append({**_grad_checks(("dx", "dweight", "dbias"), got, want,
                                           GRAD_TOL[dtype]),
                            "kernel": "causal_conv1d_bwd", **tag})
    return results


# The fused backward's edges: lengths around its chunk of 64 steps (the
# short chunk is processed first, alone or beside a full one; 513 is the
# train path's one-step chunk) and its sub-chunks of 8, at D=40 and D=136
# (the last block of 16 channels half full).
FUSED_EDGE_LENGTHS = (1, 63, 64, 65, 127, 128, 129, 513)
FUSED_EDGE_DIMS = (40, 136)


def _check_fused_edges() -> list[dict]:
    """The fused backward at the edges of its design, fp32 and bf16, v1
    operands, one and both directions, with and without the softplus,
    against the plain backward and K2 (``_check_scan``, which holds the
    saving forward that feeds it too): at every length of
    FUSED_EDGE_LENGTHS and D of FUSED_EDGE_DIMS; with d_state 5 (B/C rows
    staged value by value) at L=65 and 513; and with bf16 partials against
    its fp32-partials launch (``_check_bwd_forms``, which holds K2's forms
    there too) at L=65, D=40 and L=513, D=136."""
    results = []
    for dtype in (torch.float32, torch.bfloat16):
        for seqlen in FUSED_EDGE_LENGTHS:
            for d in FUSED_EDGE_DIMS:
                results += _check_scan("fused_bwd_edge", (2, seqlen, d), dtype, True, True)
        for seqlen in (65, 513):
            results += _check_scan("fused_bwd_edge_n5", (2, seqlen, 40), dtype, True, True, n=5)
        for dims in ((2, 65, 40), (2, 513, 136)):
            results += _check_bwd_forms("fused_bwd_edge", dims, dtype)
    return results


def _check_edges() -> list[dict]:
    """The redesigned kernels at the edges of their designs, fp32 and bf16.
    The fuse_dt dual forward, v1 and v2 (``_check_fdt``): dt ranks 1 (one
    partial k-step), 16 (one whole one), 17, 47 (dtr rows 79 elements apart:
    not 16-byte aligned, so staged value by value, as at ranks 1 and 17) and
    64 (the largest) at L=37, D=40; lengths 1, 15, 16, 17 (around a dt
    tile), 65 (one step into the second chunk) and 81 (one into the dtr
    ring's second window) at D=136 (a block with 8 channels) and rank 48. The conv, forward and backward: D=36 (not
    whole 8-channel vectors), x a slice at an odd channel offset (unaligned
    base), L=1 and L one past a tile (the kernel's own tile length). The
    fused backward (``_check_fused_edges``)."""
    from aum_tpu_torch.ops.conv1d import TILE_STEPS

    results = _check_fused_edges()
    for dtype in (torch.float32, torch.bfloat16):
        for shared in (True, False):
            for rank in (1, 16, 17, 47, 64):
                results += _check_fdt("fdt_rank", (2, 37, 40), dtype, shared, rank=rank)
            for seqlen in (1, 15, 16, 17, 65, 81):
                results += _check_fdt("fdt_length", (2, seqlen, 136), dtype, shared)
        for train in (False, True):
            for label, dims, offset in (("conv_d36", (2, 37, 36), 0),
                                        ("conv_odd_offset", (2, 37, 40), 1),
                                        ("conv_l1", (2, 1, 40), 0),
                                        ("conv_tile_plus_1", (2, TILE_STEPS + 1, 40), 0)):
                results += _check_conv(label, dims, dtype, train, offset)
    return results


def phase_kernels() -> dict:
    """Every kernel against its plain version; returns the largest absolute
    error of each at the paths' shapes in bf16."""
    # (dims, train: False eval / True train / None both, d_state). N=5 is
    # not a multiple of the 4 lanes a chain's states are split over, so the
    # last lane of each chain holds part of its states and one none.
    shapes = {"eval": (EVAL_DIMS, False, 16), "train": (TRAIN_DIMS, True, 16),
              **{label: (dims, train, 16) for label, (dims, train) in RECIPE_DIMS.items()},
              "ragged": ((2, 37, 40), None, 16), "ragged_n5": ((2, 37, 40), None, 5),
              "multi_chunk": ((2, 150, 40), None, 16)}
    results = []
    for label, (dims, train, n) in shapes.items():
        for dtype in (torch.float32, torch.bfloat16):
            modes = (False, True) if train is None else (train,)
            for mode in modes:
                for shared in (True, False):
                    results += _check_scan(label, dims, dtype, shared, mode, n)
                for reverse in (False, True):
                    results += _check_scan_single(label, dims, dtype, reverse, mode, n)
                if n == 16:  # the conv has no d_state
                    results += _check_conv(label, dims, dtype, mode)
            if train is not False and n == 16:
                results += _check_chained(label, dims, dtype)
            # The opt-in forms: fuse_dt (eval shapes) at AuM-Base's dt rank
            # and, at the narrow shapes, AuM-tiny's (12: one partial k-step);
            # the backward's forms at the train shapes.
            if train is not True:
                for rank in (48,) if dims[2] == 1536 else (48, 12):
                    for shared in (True, False):
                        results += _check_fdt(label, dims, dtype, shared, n, rank)
            if train is not False:
                results += _check_bwd_forms(label, dims, dtype, n)
        for shared in (True, False):
            results += _check_stage(label, dims, shared, n)
    # The LM prefill's kernels at its shapes: the single-direction forward
    # (as is and in its with_state form) and the conv.
    for dtype in (torch.float32, torch.bfloat16):
        results += _check_scan_single("lm_prefill", LM_PREFILL_DIMS, dtype, False, False)
        results += _check_conv("lm_prefill", LM_PREFILL_DIMS, dtype, False)
    results += _check_edges()
    results += probe_small_dt()
    worst = {}
    for r in results:
        emit({"phase": "kernels", **r})
        if (r["shape"] in ("eval", "train", "lm_prefill", *RECIPE_DIMS)
                and r["dtype"] == str(torch.bfloat16)
                and r.get("against", "plain") in ("plain", "fp32_partials_launch")
                and "check" not in r):
            key = r["kernel"] + ("_save_states" if r.get("save_states") else "") + (
                "_with_state" if r.get("with_state") else "") + (
                "_no_softplus" if r.get("form", "").endswith("no_softplus") else "") + (
                f"_{r['variant']}" if "variant" in r else "")
            worst[key] = max(worst.get(key, 0.0), r["max_abs_err"])
    failed = [r for r in results if not r["ok"]]
    emit({"phase": "kernels_summary", "checks": len(results), "failed": len(failed),
          "worst_bf16_max_abs_err": worst})
    if failed:
        raise RuntimeError(f"{len(failed)} kernel checks disagree with the plain version")
    return worst


def phase_model() -> dict:
    from aum_tpu_torch.entry import entry, flagship_config
    from aum_tpu_torch.models import AudioMamba

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = flagship_config(dtype="float32")
    x = torch.randn((2, 1024, 128), generator=torch.Generator().manual_seed(7))
    t0 = time.perf_counter()
    with torch.inference_mode():
        gpu = AudioMamba(cfg32, device="cuda", seed=0)
        got = gpu(x.cuda()).cpu()
        del gpu
        t1 = time.perf_counter()
        want = AudioMamba(cfg32, device="cpu", seed=0)(x)
    t2 = time.perf_counter()
    atol, rtol = MODEL_FP32_TOL
    r = compare(got, want, atol, rtol)
    emit({"phase": "model_fp32_vs_cpu", "batch": 2, "depth": cfg32.depth,
          "width": cfg32.embed_dim, "logits_shape": list(got.shape),
          "gpu_s": t1 - t0, "cpu_s": t2 - t1, **r})
    if not r["ok"]:
        raise RuntimeError("fp32 model on the card disagrees with the CPU plain path")
    # The same weights and input through the direct dual forward.
    with scan_switches(AUM_SCAN_DIRECT=True), torch.inference_mode():
        gpu = AudioMamba(cfg32, device="cuda", seed=0)
        got = gpu(x.cuda()).cpu()
        del gpu
    r = compare(got, want, atol, rtol)
    emit({"phase": "model_fp32_vs_cpu", "switches": {"AUM_SCAN_DIRECT": 1}, "batch": 2,
          "depth": cfg32.depth, "width": cfg32.embed_dim, **r})
    if not r["ok"]:
        raise RuntimeError("fp32 model through the direct dual forward disagrees with the CPU")
    # The same weights and input through the fuse_dt form (dt formed in the
    # kernel). In fp32 it computes the default path's function (dt is never
    # rounded in either), so the CPU's default logits stay the reference.
    with scan_switches(AUM_SCAN_FUSE_DT=True), torch.inference_mode():
        gpu = AudioMamba(cfg32, device="cuda", seed=0)
        got = gpu(x.cuda()).cpu()
        del gpu
    r = compare(got, want, atol, rtol)
    emit({"phase": "model_fp32_vs_cpu", "switches": {"AUM_SCAN_FUSE_DT": 1}, "batch": 2,
          "depth": cfg32.depth, "width": cfg32.embed_dim, **r})
    if not r["ok"]:
        raise RuntimeError("fp32 model through the fuse_dt dual forward disagrees with the CPU")

    depth = flagship_config().depth
    fn, args = entry()
    out = {}
    for name, (switches, scan) in EVAL_SWITCHES.items():
        with scan_switches(**switches):
            torch.cuda.synchronize()
            _reset_counters()
            logits = fn(*args)
            torch.cuda.synchronize()
            launches = _read_counters()
            finite = bool(torch.isfinite(logits.float()).all())
            latency_ms = cuda_ms(lambda: fn(*args), iters=10)
        emit({"phase": "main_path", "entry": "aum_tpu_torch.entry.entry", "batch": 8,
              "switches": {k: int(bool(v)) for k, v in switches.items()},
              "logits_shape": list(logits.shape), "dtype": str(logits.dtype),
              "finite": finite, "launches": launches, "graph_built": logits.requires_grad,
              "ms_per_forward": latency_ms})
        if tuple(logits.shape) != (8, 527) or not finite:
            raise RuntimeError("main path logits are not (8, 527) finite values")
        expected = _launches(**{scan: depth}, causal_conv1d_fwd=depth)
        if launches != expected or logits.requires_grad:
            raise RuntimeError(f"expected {expected} launches and no graph ({name}), "
                               f"got {launches}")
        out[name] = launches
    return out


# entry() under each switch set: the switches, and the one dual forward
# kernel the eval path must launch (the fuse_dt form ignores AUM_SCAN_DIRECT,
# as JAX's fuse_dt op never takes the direct kernel).
EVAL_SWITCHES = {
    "default": ({}, "selective_scan_dual_fwd"),
    "direct": ({"AUM_SCAN_DIRECT": True}, "selective_scan_dual_direct_fwd"),
    "fuse_dt": ({"AUM_SCAN_FUSE_DT": True}, "selective_scan_dual_fdt_fwd"),
    "fuse_dt_direct": ({"AUM_SCAN_FUSE_DT": True, "AUM_SCAN_DIRECT": True},
                       "selective_scan_dual_fdt_fwd"),
    "bf16_stage": ({"AUM_SCAN_BF16_STAGE": True}, "selective_scan_dual_stage_fwd"),
}


def phase_wav() -> dict:
    """AuM-Base Fo-Fo from waveforms: fp32 card against CPU, then
    ``wav_entry()``'s launches, logits and latency."""
    from aum_tpu_torch.entry import (
        CLIP_SAMPLES,
        WAV_BATCH,
        flagship_config,
        wav_entry,
        wav_forward_fn,
        wav_frontend_fn,
    )
    from aum_tpu_torch.models import AudioMamba

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = flagship_config("Fo-Fo", dtype="float32")
    wav = 0.1 * torch.randn((2, CLIP_SAMPLES), generator=torch.Generator().manual_seed(7))
    t0 = time.perf_counter()
    with torch.inference_mode():
        gpu = AudioMamba(cfg32, device="cuda", seed=0)
        got = wav_forward_fn(gpu)(wav.cuda()).cpu()
        del gpu
        t1 = time.perf_counter()
        want = wav_forward_fn(AudioMamba(cfg32, device="cpu", seed=0))(wav)
    t2 = time.perf_counter()
    r = compare(got, want, *MODEL_FP32_TOL)
    emit({"phase": "wav_fp32_vs_cpu", "batch": 2, "samples": CLIP_SAMPLES,
          "depth": cfg32.depth, "width": cfg32.embed_dim, "bimamba": cfg32.bimamba_type,
          "logits_shape": list(got.shape), "gpu_s": t1 - t0, "cpu_s": t2 - t1, **r})
    if not r["ok"]:
        raise RuntimeError("fp32 Fo-Fo from waveforms on the card disagrees with the CPU")

    fn, (wav,) = wav_entry()
    torch.cuda.synchronize()
    _reset_counters()
    logits = fn(wav)
    torch.cuda.synchronize()
    launches = _read_counters()
    finite = bool(torch.isfinite(logits.float()).all())
    latency_ms = cuda_ms(lambda: fn(wav), iters=10)
    frontend = wav_frontend_fn(cfg32)
    frontend_ms = cuda_ms(lambda: frontend(wav), iters=10)
    emit({"phase": "wav_path", "entry": "aum_tpu_torch.entry.wav_entry", "batch": WAV_BATCH,
          "samples": CLIP_SAMPLES, "logits_shape": list(logits.shape),
          "dtype": str(logits.dtype), "finite": finite, "launches": launches,
          "graph_built": logits.requires_grad, "ms_per_forward": latency_ms,
          "frontend_ms": frontend_ms})
    depth = cfg32.depth
    if tuple(logits.shape) != (WAV_BATCH, 527) or not finite:
        raise RuntimeError("wav path logits are not (8, 527) finite values")
    expected = _launches(selective_scan_fwd=depth, causal_conv1d_fwd=depth)
    if launches != expected or logits.requires_grad:
        raise RuntimeError(f"expected {expected} launches and no graph, got {launches}")
    return launches


def _counters() -> dict:
    """Every launch counter: name -> (holder, attribute)."""
    from aum_tpu_torch.parallel.checks import launch_counters

    return launch_counters()


def _reset_counters() -> None:
    for holder, attr in _counters().values():
        setattr(holder, attr, 0)


def _read_counters() -> dict:
    return {name: getattr(holder, attr) for name, (holder, attr) in _counters().items()}


def _launches(**counts) -> dict:
    """Every counter at 0 but those given."""
    return {**dict.fromkeys(_counters(), 0), **counts}


def _expected_train_launches(aum_type: str, depth: int, switches: dict, bf16: bool,
                             slices: int = 1) -> dict:
    """What one forward and backward launches per layer: the scan's saving
    forward and its backward (the kernels the switches choose: the fuse_dt
    rule's saving forward is the staged kernel whatever AUM_SCAN_DIRECT says;
    the stage form takes bf16 streams only) and the conv four times (split
    remat: forward, recompute, the backward's pre-activation and dx; Bi-Bi's
    two convs each). ``slices`` > 1 (d_state above 16): each scan kernel once
    per slice of 16 states, and the combine and its backward once a layer."""
    on = {k for k, v in switches.items() if v}
    direct = "AUM_SCAN_DIRECT" in on and "AUM_SCAN_FUSE_DT" not in on
    if aum_type == "Fo-Fo":
        scans = {"selective_scan_fwd": depth, "selective_scan_fwd_save_states": depth}
    elif direct:
        scans = {"selective_scan_dual_direct_fwd": depth,
                 "selective_scan_dual_direct_fwd_save_states": depth}
    elif "AUM_SCAN_BF16_STAGE" in on and bf16:
        scans = {"selective_scan_dual_stage_fwd": depth,
                 "selective_scan_dual_stage_fwd_save_states": depth}
    else:
        scans = {"selective_scan_dual_fwd": depth, "selective_scan_dual_fwd_save_states": depth}
    fused = "AUM_SCAN_BWD_FUSED" in on
    bwd = {"selective_scan_bwd_fused" if fused else "selective_scan_bwd": depth}
    if not fused and on & {"AUM_SCAN_BWD_XMINUS", "AUM_SCAN_BWD_DBU"}:
        bwd["selective_scan_bwd_xminus"] = depth
    if "AUM_SCAN_BWD_BF16_PARTIALS" in on:
        bwd["selective_scan_bwd_bf16_partials"] = depth
    convs = 2 if aum_type == "Bi-Bi" else 1
    if slices > 1:
        scans = {k: v * slices for k, v in scans.items()}
        bwd = {k: v * slices for k, v in bwd.items()}
        fwd_sliced = "selective_scan_fwd_sliced" if aum_type == "Fo-Fo" else \
            "selective_scan_dual_fwd_sliced"
        scans.update({fwd_sliced: slices * depth, "scan_combine_fwd": depth})
        bwd.update({"selective_scan_bwd_sliced": slices * depth, "scan_combine_bwd": depth})
    return _launches(**scans, **bwd, causal_conv1d_fwd=4 * convs * depth)


def _train_fp32_check(aum_type: str, switch_sets: dict, patch_size: int | None = None,
                      batch: int = 2, overrides: dict | None = None, slices: int = 1) -> dict:
    """fp32, full width, depth 2 (the CPU oracle's backward stays short): the
    loss and grads of one forward and backward, then one full train step
    without warmup (its lr is the schedule's 5e-5, not the warmup's 0), card
    against CPU; at the run-time ``patch_size`` where given. The card runs
    once per switch set (name -> switches), the CPU once. Returns the
    launches of each card run's forward and backward. ``overrides``: config
    fields (a d_state whose scans take ``slices`` slices)."""
    import dataclasses

    from aum_tpu_torch.entry import STEPS_PER_EPOCH, TRAIN_HP, flagship_config
    from aum_tpu_torch.models import AudioMamba
    from aum_tpu_torch.train import init_train_state, loss_fn_of, make_optimizer, make_train_step

    cfg = flagship_config(aum_type, dtype="float32", depth=2, remat=True, remat_mode="split",
                          **(overrides or {}))
    hp = dataclasses.replace(TRAIN_HP, warmup=False)
    g = torch.Generator().manual_seed(8)
    x = torch.randn((batch, 1024, 128), generator=g)
    y = torch.nn.functional.one_hot(torch.arange(batch) % 527, 527).float()
    keys = ("in_proj.weight", "A_log", "A_b_log", "dt_proj.bias", "conv1d.weight",
            "x_proj.weight", "dt_proj.weight")
    if cfg.bimamba_type == "none":  # Fo-Fo has no A_b_log
        keys = tuple(k for k in keys if k != "A_b_log")
    names = [f"layers.{i}.mixer.{k}" for i in range(cfg.depth) for k in keys]
    patch = {} if patch_size is None else {"patch_size": patch_size, "strides": patch_size}

    def run(device):
        t0 = time.perf_counter()
        model = AudioMamba(cfg, device=device, seed=0)
        batch = {"x": x.to(device), "y": y.to(device)}
        if device == "cuda":
            torch.cuda.synchronize()
            _reset_counters()
        loss = loss_fn_of("BCE")(model(batch["x"], train=True, **patch), batch["y"])
        loss.backward()
        launches = None
        if device == "cuda":
            torch.cuda.synchronize()
            launches = _read_counters()
        params = dict(model.named_parameters())
        grads = {k: params[k].grad.cpu() for k in names}
        before = {k: params[k].detach().cpu().clone() for k in names}
        state = init_train_state(model, make_optimizer(model.parameters(), hp))
        make_train_step(hp, STEPS_PER_EPOCH, "BCE", patch_size=patch_size)(state, batch)
        after = {k: params[k].detach().cpu() for k in names}
        return loss.item(), grads, before, after, time.perf_counter() - t0, launches

    loss_c, grads_c, before_c, after_c, s_c, _ = run("cpu")
    out = {}
    for set_name, switches in switch_sets.items():
        with scan_switches(**switches):
            loss_g, grads_g, _, after_g, s_g, launches = run("cuda")
        checks = {k: compare_scaled(grads_g[k], grads_c[k], TRAIN_FP32_TOL["grad"])
                  for k in grads_c}
        updates = {}
        for k in names:
            err = (after_g[k] - after_c[k]).norm().item()
            moved = (after_c[k] - before_c[k]).norm().item()
            updates[k] = {"err_norm": err, "update_norm": moved,
                          "ok": moved > 0 and err <= TRAIN_FP32_TOL["update"] * moved}
        expected = _expected_train_launches(aum_type, cfg.depth, switches, bf16=False,
                                            slices=slices)
        loss_ok = abs(loss_g - loss_c) <= TRAIN_FP32_TOL["loss_rtol"] * abs(loss_c)
        ok = (loss_ok and all(c["ok"] for c in checks.values())
              and all(u["ok"] for u in updates.values()) and launches == expected)
        emit({"phase": "train_fp32_vs_cpu", "aum_type": aum_type, "patch_size": patch_size,
              "d_state": cfg.d_state,
              "switches": {k: int(bool(v)) for k, v in switches.items()}, "batch": batch,
              "depth": cfg.depth, "width": cfg.embed_dim, "loss_gpu": loss_g, "loss_cpu": loss_c,
              "loss_rtol": TRAIN_FP32_TOL["loss_rtol"], "grads": checks, "lr": hp.lr,
              "params_after_step": updates, "update_tol": TRAIN_FP32_TOL["update"],
              "launches": launches, "expected_launches": expected,
              "gpu_s": s_g, "cpu_s": s_c, "ok": ok})
        if not ok:
            raise RuntimeError(f"fp32 {aum_type} train step on the card ({set_name}) disagrees "
                               "with the CPU plain path, or launched other kernels than expected")
        out[set_name] = launches
    return out


# The train path's switch sets: the default kernels, and the direct forward
# with the fused backward (Fo-Fo has no dual forward: the fused backward
# alone), timed in turns; then sets whose launches alone are checked: the
# fuse_dt rule (with AUM_SCAN_DIRECT=1 also, which it ignores), and every
# opt-in form of the forward and the backward at once (K2 in its x-minus
# form, or the fused kernel, with bf16 partials).
TRAIN_SWITCHES = {"default": {}, "direct_fused": {"AUM_SCAN_DIRECT": True,
                                                  "AUM_SCAN_BWD_FUSED": True}}
FUSE_DT = {"AUM_SCAN_FUSE_DT": True}
TRAIN_CHECK_SWITCHES = {
    "fuse_dt": FUSE_DT,
    "fuse_dt_direct": {**FUSE_DT, "AUM_SCAN_DIRECT": True},
    "opt_in_k2": {**FUSE_DT, "AUM_SCAN_BF16_STAGE": True, "AUM_SCAN_BWD_BF16_PARTIALS": True,
                  "AUM_SCAN_BWD_XMINUS": True},
    "opt_in_fused": {**FUSE_DT, "AUM_SCAN_BF16_STAGE": True, "AUM_SCAN_BWD_BF16_PARTIALS": True,
                     "AUM_SCAN_BWD_FUSED": True},
}


def phase_train() -> dict:
    """The depth-2 fp32 checks, then ``train_entry()`` under each switch set:
    three steps with their launches, then ms per step in turns (default,
    switched, switched, default) and each set's peak memory."""
    from aum_tpu_torch.entry import TRAIN_BATCH, train_entry

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fofo_launches = _train_fp32_check("Fo-Fo", {"default": {},
                                                "fused": {"AUM_SCAN_BWD_FUSED": True}})
    _train_fp32_check("Fo-Bi", {**TRAIN_SWITCHES, "fuse_dt": FUSE_DT})

    step, state, batch = train_entry()
    depth = state.model.config.depth
    out = {"phase": "train_path", "entry": "aum_tpu_torch.entry.train_entry",
           "batch": TRAIN_BATCH, "depth": depth, "dtype": "bfloat16", "remat_mode": "split",
           "fofo_check_launches": fofo_launches}
    for set_name, switches in {**TRAIN_SWITCHES, **TRAIN_CHECK_SWITCHES}.items():
        losses = []
        with scan_switches(**switches):
            for i in range(3):
                torch.cuda.synchronize()
                if i == 1:
                    _reset_counters()
                state, loss = step(state, batch)
                torch.cuda.synchronize()
                if i == 1:
                    launches = _read_counters()
                losses.append(loss.item())
            torch.cuda.reset_peak_memory_stats()
            step(state, batch)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
        expected = _expected_train_launches("Fo-Bi", depth, switches, bf16=True)
        finite = all(math.isfinite(v) for v in losses)
        out[set_name] = {"switches": {k: int(bool(v)) for k, v in switches.items()},
                         "losses": losses, "finite": finite, "launches_per_step": launches,
                         "expected_launches": expected, "peak_mem_bytes": peak, "ms_per_step": []}
        if not finite:
            raise RuntimeError(f"train path losses are not finite ({set_name}): {losses}")
        if launches != expected:
            raise RuntimeError(f"expected {expected} launches per train step ({set_name}), "
                               f"got {launches}")
    for set_name in ("default", "direct_fused", "direct_fused", "default"):
        with scan_switches(**TRAIN_SWITCHES[set_name]), sample_clocks({}) as card:
            ms = cuda_ms(lambda: step(state, batch), iters=5, warmup=1)
        out[set_name]["ms_per_step"].append(ms)
        out[set_name].setdefault("card", []).append(card)
    for set_name in TRAIN_SWITCHES:
        ms = sum(out[set_name]["ms_per_step"]) / 2
        out[set_name]["clips_per_s"] = TRAIN_BATCH / (ms / 1e3)
    emit(out)
    del step, state, batch
    return out


# The recipe path's synthetic data: 16-bit WAV clips at 16 kHz, most of a
# recipe's full length and every RECIPE_SHORT_EVERY-th shorter, so that the
# frame mask acts; multi-label manifests over the recipe's classes.
RECIPE_SPLITS = {"as20k/aum-base_scratch": {"train": 48, "val": 24},
                 "speechcommands/aum-base_scratch": {"train": 256, "val": 128, "eval": 128}}
RECIPE_SECONDS = {"as20k/aum-base_scratch": (10.0, 7.3),
                  "speechcommands/aum-base_scratch": (1.0, 0.73)}
RECIPE_SHORT_EVERY = 6
# The card's featurized batch against the CPU's from the same draws: the
# fbank's bound against the JAX package on the CPU (cuFFT against pocketfft,
# fp32 sums in other orders), on the normalized log-mels.
FEATURIZE_TOL = (1e-4, 1e-4)  # (atol, rtol)


def _write_recipe_data(root: str, recipe: str, n_classes: int, seed: int,
                       splits: dict | None = None, codec: str | None = None) -> dict:
    """Clips, a label CSV and one JSON manifest per split under ``root``:
    16-bit WAV files, or with ``codec`` ("flac") files written by the native
    decoder library's own encoder. ``splits``: clips per split (default
    ``RECIPE_SPLITS[recipe]``)."""
    import wave

    import numpy as np

    rng = np.random.default_rng(seed)
    long_s, short_s = RECIPE_SECONDS[recipe]
    files = {"csv": os.path.join(root, "labels.csv")}
    with open(files["csv"], "w") as f:
        f.write("index,mid,display_name\n")
        f.writelines(f"{i},/m/c{i},class {i}\n" for i in range(n_classes))
    for split, n in (splits or RECIPE_SPLITS[recipe]).items():
        entries = []
        for i in range(n):
            samples = int(16000 * (short_s if i % RECIPE_SHORT_EVERY == 5 else long_s))
            labels = rng.choice(n_classes, size=1 + int(rng.integers(0, 3)), replace=False)
            t = np.arange(samples) / 16000
            wav = 0.1 * rng.standard_normal(samples) + 0.3 * np.sin(
                2 * np.pi * (200 + 20 * labels[0]) * t)
            if codec is not None:
                from aum_tpu_torch.data.native import encode_test_audio

                path = os.path.join(root, f"{split}{i}.{codec}")
                encode_test_audio(path, codec, np.clip(wav, -1.0, 1.0).astype(np.float32), 16000)
            else:
                path = os.path.join(root, f"{split}{i}.wav")
                with wave.open(path, "wb") as w:
                    w.setnchannels(1)
                    w.setsampwidth(2)
                    w.setframerate(16000)
                    w.writeframes(np.clip(wav * 32767, -32768, 32767).astype("<i2").tobytes())
            entries.append({"wav": path, "labels": ",".join(f"/m/c{c}" for c in labels)})
        files[split] = os.path.join(root, f"{split}.json")
        with open(files[split], "w") as f:
            json.dump({"data": entries}, f)
    return files


@contextlib.contextmanager
def _recipe_probes(records: dict):
    """Wrap the train loop's step, eval step and evaluate while a recipe runs:
    per train step its loss, host ms, CUDA-event ms, launches and patch size
    (and step ``records["profile_step"]``, the third by default, under
    torch.profiler, the pipeline's work for the next batch included); per
    val batch its launches; the val scores."""
    from aum_tpu_torch.train import loop

    saved = (loop.make_train_step, loop.make_eval_step, loop.evaluate)
    profile_step = records.setdefault("profile_step", 2)

    def make_train_step(*a, **k):
        step = saved[0](*a, **k)

        def probed(state, batch):
            before = _read_counters()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            if len(records["steps"]) == profile_step:
                out = []
                records["profile"] = _profile(
                    "profile_recipe_step", lambda: out.append(step(state, batch)),
                    recipe=records["recipe"], batch=int(batch["x"].shape[0]))
                state, loss = out[0]
            else:
                state, loss = step(state, batch)
            end.record()
            host_ms = (time.perf_counter() - t0) * 1e3
            end.synchronize()
            after = _read_counters()
            records["steps"].append({
                "loss": float(loss), "host_ms": host_ms, "cuda_ms": start.elapsed_time(end),
                "launches": {n: after[n] - before[n] for n in after},
                "patch_size": k.get("patch_size")})
            return state, loss

        return probed

    def make_eval_step(model):
        fn = saved[1](model)

        def probed(x):
            before = _read_counters()
            out = fn(x)
            torch.cuda.synchronize()
            after = _read_counters()
            records["val_batches"].append({k: after[k] - before[k] for k in after})
            return out

        return probed

    def evaluate(*a, **k):
        out = saved[2](*a, **k)
        records["val_scores"] = out[1]
        return out

    # run.main and train_loop both read these names from the loop module.
    loop.make_train_step, loop.make_eval_step, loop.evaluate = (make_train_step, make_eval_step,
                                                                evaluate)
    try:
        yield records
    finally:
        loop.make_train_step, loop.make_eval_step, loop.evaluate = saved


def _run_recipe(recipe: str, files: dict | None, exp_dir: str, overrides: list,
                pipelines: tuple | None = None, profile_step: int | None = 2) -> dict:
    """``aum_tpu_torch.run.main`` training ``recipe`` for one epoch, from the
    manifests in ``files`` or on the caller's (train, val, eval)
    ``pipelines``, with every launch counter set to 0 just before and read
    just after; train step ``profile_step`` (None: none) under
    torch.profiler."""
    from aum_tpu_torch.run import main as run_main

    argv = ["--recipe", recipe, "--exp-dir", exp_dir, "--set", "n_epochs=1"]
    if files is not None:
        argv += ["--data-train", files["train"], "--data-val", files["val"],
                 "--label-csv", files["csv"]]
        if "eval" in files:
            argv += ["--data-eval", files["eval"]]
    records = {"recipe": recipe, "steps": [], "val_batches": [], "profile_step": profile_step}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _recipe_probes(records):
        t0 = time.perf_counter()
        _reset_counters()
        history = run_main(argv + [a for o in overrides for a in ("--set", o)],
                           pipelines=pipelines)
        torch.cuda.synchronize()
        records["launches"] = _read_counters()
        records["seconds"] = time.perf_counter() - t0
    records["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    records["history"] = history
    return records


def _check_recipe_run(rec: dict, batch: int, n_steps: int, n_val: int, depth: int,
                      aum_type: str = "Fo-Bi", kernels: bool = True) -> dict:
    """The recipe run's steps and validation batches: finite losses, and
    each one's launches those of the train and eval paths of an AuM of
    ``aum_type`` (Fo-Bi or Bi-Bi); ``kernels=False``: none of ours (AST)."""
    if kernels:
        convs = 2 if aum_type == "Bi-Bi" else 1
        step_launches = _expected_train_launches(aum_type, depth, {}, bf16=True)
        val_launches = _launches(selective_scan_dual_fwd=depth, causal_conv1d_fwd=convs * depth)
    else:
        step_launches = val_launches = _launches()
    losses = [s["loss"] for s in rec["steps"]]
    # Past the first step (warm-up), and not the profiled one.
    steady = [s["cuda_ms"] for i, s in enumerate(rec["steps"])
              if i not in (0, rec["profile_step"])]
    shown = [{**s, "launches": {k: v for k, v in s["launches"].items() if v}}
             for s in rec["steps"]]
    out = {"phase": "recipe_path", "recipe": rec["recipe"], "seconds": rec["seconds"],
           "steps": shown, "losses": losses,
           "val_batches": len(rec["val_batches"]), "val_metrics": rec["history"][-1],
           "launches": rec["launches"], "expected_step_launches": step_launches,
           "expected_val_launches": val_launches,
           "step_launches": rec["steps"][0]["launches"] if rec["steps"] else None,
           "val_batch_launches": rec["val_batches"][0] if rec["val_batches"] else None,
           "peak_mem_bytes": rec["peak_mem_bytes"],
           "epoch_clips_per_s": rec["history"][-1]["clips_per_sec"],
           "steady_step_cuda_ms": sum(steady) / len(steady),
           "steady_clips_per_s": batch / (sum(steady) / len(steady) / 1e3),
           "idle_share": rec["profile"]["idle_share"] if "profile" in rec else None}
    if "profile" in rec:
        # The profiler slows the host's launches; the profiled step's device
        # time over an unprofiled steady step's time estimates the idle share
        # without it.
        out["idle_share_steady_est"] = 1.0 - rec["profile"]["device_busy_ms"] / out[
            "steady_step_cuda_ms"]
    emit(out)
    if len(losses) != n_steps or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"{rec['recipe']}: expected {n_steps} finite losses, got {losses}")
    if any(s["launches"] != step_launches for s in rec["steps"]):
        raise RuntimeError(f"{rec['recipe']}: a train step launched other kernels than "
                           f"{step_launches}")
    if len(rec["val_batches"]) != n_val or any(v != val_launches for v in rec["val_batches"]):
        raise RuntimeError(f"{rec['recipe']}: expected {n_val} val batches of {val_launches} "
                           "launches")
    total = {k: n_steps * step_launches[k] + n_val * val_launches[k] for k in step_launches}
    if rec["launches"] != total:
        raise RuntimeError(f"{rec['recipe']}: the run launched {rec['launches']}, not {total}")
    return out


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _check_featurize(pipe, python_pipe, n_batches: int = 3) -> dict:
    """Decode ms per batch (native, and the Python decoder of
    ``python_pipe``), featurize ms per batch; one featurized train batch on
    the card against the same batch on the CPU from the same draws, the
    batch before it the mixup partners."""
    import concurrent.futures as cf

    import numpy as np

    from aum_tpu_torch.data.pipeline import draw_featurize, to_device

    conf = pipe.dataset.conf
    rng = np.random.default_rng(0)
    order = pipe._epoch_order(1)
    host, decode_ms = [], []
    with cf.ThreadPoolExecutor(pipe.num_workers) as pool:
        for b in range(n_batches):
            t0 = time.perf_counter()
            host.append(pipe.host_batch(order[b * pipe.batch_size:(b + 1) * pipe.batch_size],
                                        rng, pool))
            decode_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        python_pipe.host_batch(order[:pipe.batch_size], rng, pool)
        python_decode_ms = (time.perf_counter() - t0) * 1e3
    pw, _, py = to_device(pipe.device, *host[0])
    w, n, y = to_device(pipe.device, *host[1])
    bsz = w.shape[0]
    draws = draw_featurize(pipe.generator(1), conf, True, bsz, 2 * bsz)
    featurize_ms = cuda_ms(lambda: pipe.featurize(w, n, y, draws, pw, py), iters=5)
    got = pipe.featurize(w, n, y, draws, pw, py)
    want = pipe.featurize(*_to_cpu((w, n, y, draws, pw, py)))
    r = compare(got["x"].cpu(), want["x"], *FEATURIZE_TOL)
    r_y = compare(got["y"].cpu(), want["y"], 1e-6, 0.0)
    out = {"phase": "recipe_featurize", "batch": bsz, "samples": conf.target_samples,
           "frames": conf.target_length, "decode_ms_per_batch": decode_ms,
           "python_decode_ms_per_batch": python_decode_ms, "featurize_ms_per_batch": featurize_ms,
           "x_vs_cpu": r, "y_vs_cpu": r_y, "tol": FEATURIZE_TOL,
           "n_frames": n.tolist()}
    emit(out)
    if not (r["ok"] and r_y["ok"]):
        raise RuntimeError("the card's featurized batch disagrees with the CPU's")
    return out


def phase_recipe() -> dict:
    """Recipes from WAV files through ``aum_tpu_torch.run``: as20k (AuM-Base
    Fo-Bi, B=12, 1024 frames) for 4 steps and its validation, the eval run
    from its checkpoint (bit-equal val scores), SpeechCommands (B=128, 128
    frames, noise) for 2 steps and its valid + eval pass, and the featurizer
    on the card against the CPU."""
    import tempfile

    import numpy as np

    from aum_tpu_torch.configs import RECIPES
    from aum_tpu_torch.data import AudioJsonDataset, BatchPipeline
    from aum_tpu_torch.run import main as run_main

    out = {}
    as20k = "as20k/aum-base_scratch"
    cfg = RECIPES[as20k]
    with tempfile.TemporaryDirectory(prefix="aum_recipe_") as root:
        files = _write_recipe_data(root, as20k, cfg.n_class, seed=0)
        exp = os.path.join(root, "exp")
        rec = _run_recipe(as20k, files, exp, [])
        depth = cfg.model_config().depth
        out["as20k"] = _check_recipe_run(rec, cfg.batch_size, n_steps=4, n_val=1, depth=depth)
        artifacts = sorted(os.listdir(exp)) + [f"models/{n}" for n in
                                               sorted(os.listdir(os.path.join(exp, "models")))]
        # Restore the checkpoint: the eval run's val scores against the
        # trained state's, bit for bit.
        ev = os.path.join(root, "eval")
        metrics = run_main(["--recipe", as20k, "--data-val", files["val"], "--label-csv",
                            files["csv"], "--exp-dir", ev, "--run-type", "eval", "--ckpt",
                            os.path.join(exp, "models")])
        restored = np.loadtxt(os.path.join(ev, "predictions_eval.csv"), delimiter=",")
        trained = rec["val_scores"]
        equal = bool(np.array_equal(restored.astype(np.float32), trained))
        out["restore"] = {"phase": "recipe_restore", "artifacts": artifacts,
                          "eval_artifacts": sorted(os.listdir(ev)),
                          "scores_shape": list(trained.shape), "bit_equal": equal,
                          "max_abs_diff": float(np.abs(restored - trained).max()),
                          "eval_metrics": metrics}
        emit(out["restore"])
        if not equal or metrics["mAP"] != rec["history"][-1]["mAP"]:
            raise RuntimeError("the restored checkpoint's val scores differ from the trained "
                               "state's")
        ds = AudioJsonDataset(files["train"], cfg.audio_conf(train=True), files["csv"])
        out["featurize"] = _check_featurize(
            BatchPipeline(ds, cfg.batch_size, seed=cfg.seed),
            BatchPipeline(ds, cfg.batch_size, seed=cfg.seed, use_native=False))
        del rec
    spc = "speechcommands/aum-base_scratch"
    with tempfile.TemporaryDirectory(prefix="aum_recipe_") as root:
        files = _write_recipe_data(root, spc, RECIPES[spc].n_class, seed=1)
        rec = _run_recipe(spc, files, os.path.join(root, "exp"), [])
        # Validation in the epoch, then the post-train valid and eval pass.
        out["speechcommands"] = _check_recipe_run(rec, RECIPES[spc].batch_size, n_steps=2,
                                                  n_val=3, depth=RECIPES[spc].model_config().depth)
    return out


# EPIC-SOUNDS on the card: the epic_sounds/aum-base_scratch recipe over an
# in-memory dataset (records and a dict of 24 kHz samples), as the card's
# machine has no pandas or h5py for the reference's annotation pickle and
# HDF5 store. Segment lengths cycle through three kinds: longer than the
# 10 s clip (a random window), one clip, and shorter (taken whole, the
# log-mel edge-padded). 48 train records (4 steps of 12), 24 val (one
# batch), 4 test records of 5 views (one batch of 20).
EPIC_RECIPE = "epic_sounds/aum-base_scratch"
EPIC_RECORDS = {"train": 48, "val": 24, "test": 4}
EPIC_SEGMENT_SECONDS = (12.5, 10.0, 4.0)
EPIC_VIDEOS, EPIC_VIDEO_SECONDS = 8, 40.0
# The card's featurized train batch against the CPU's from the same draws:
# cuFFT against pocketfft, the spline's SVD solve on each, fp32 sums in
# other orders; the recipe featurizer's bound (FEATURIZE_TOL).
EPIC_FEATURIZE_TOL = (1e-4, 1e-4)  # (atol, rtol)


def _hms(sec: float) -> str:
    return f"{int(sec // 3600):02d}:{int(sec % 3600 // 60):02d}:{sec % 60:06.3f}"


def _epic_data(sampling_rate: int, n_classes: int, seed: int) -> tuple[dict, dict]:
    """(audio: video_id -> fp32 samples, records per split): class-tinted
    tones in noise, segments at whole milliseconds."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = int(EPIC_VIDEO_SECONDS * sampling_rate)
    t = np.arange(n) / sampling_rate
    audio = {f"video{v}": (0.3 * np.sin(2 * np.pi * (200 + 40 * v) * t)
                           + 0.1 * rng.standard_normal(n)).astype(np.float32)
             for v in range(EPIC_VIDEOS)}
    records = {}
    for split, count in EPIC_RECORDS.items():
        records[split] = []
        for i in range(count):
            dur = EPIC_SEGMENT_SECONDS[i % len(EPIC_SEGMENT_SECONDS)]
            start = round(float(rng.uniform(0.0, EPIC_VIDEO_SECONDS - dur - 0.5)), 3)
            records[split].append({"video_id": f"video{i % EPIC_VIDEOS}",
                                   "start_timestamp": _hms(start),
                                   "stop_timestamp": _hms(start + dur),
                                   "class_id": int(rng.integers(n_classes))})
    return audio, records


def _check_epic_featurize(pipe, n_batches: int = 3) -> dict:
    """Host ms per batch (window draws and slicing), featurize ms per batch
    (STFT, time warp, masks, normalize; CUDA events), and one featurized
    train batch on the card against the CPU from the same draws."""
    import concurrent.futures as cf

    from aum_tpu_torch.data.epic import draw_epic_featurize
    from aum_tpu_torch.data.pipeline import to_device

    cfg = pipe.dataset.cfg
    order, rng = pipe.epoch_order(1)
    bs = pipe.batch_size
    host, host_ms = [], []
    with cf.ThreadPoolExecutor(pipe.num_workers) as pool:
        for b in range(n_batches):
            t0 = time.perf_counter()
            host.append(pipe.host_batch(order[b * bs:(b + 1) * bs], rng, pool))
            host_ms.append((time.perf_counter() - t0) * 1e3)
    w, n, y = to_device(pipe.device, *host[0][:3])
    draws = draw_epic_featurize(pipe.generator(1), cfg, True, (bs, cfg.num_frames,
                                                                cfg.num_frequencies))
    featurize_ms = cuda_ms(lambda: pipe.featurize(w, n, y, draws), iters=5)
    got = pipe.featurize(w, n, y, draws)
    want = pipe.featurize(*_to_cpu((w, n, y, draws)))
    r = compare(got["x"].cpu(), want["x"], *EPIC_FEATURIZE_TOL)
    out = {"phase": "epic_featurize", "batch": bs, "samples": cfg.clip_samples,
           "frames": cfg.num_frames, "host_ms_per_batch": host_ms,
           "featurize_ms_per_batch": featurize_ms, "x_vs_cpu": r, "tol": EPIC_FEATURIZE_TOL,
           "n_frames": n.tolist(), "warp_point": draws["augment"]["warp"]["point"].tolist()}
    emit(out)
    if not r["ok"]:
        raise RuntimeError("the card's featurized EPIC batch disagrees with the CPU's")
    return out


def phase_epic() -> dict:
    """The EPIC-SOUNDS recipe (AuM-Base Fo-Bi, full width and depth, bf16,
    B=12, 24 kHz 10 s clips, 1024 frames x 128 mels, CE, warm-up) through
    ``aum_tpu_torch.run.main`` on in-memory pipelines: 4 train steps and one
    validation batch (B=24), then the test split (``--run-type eval`` from
    the written checkpoint) on 5 views per record, averaged; then the
    featurizer on the card against the CPU."""
    import tempfile

    import numpy as np

    from aum_tpu_torch.configs import RECIPES
    from aum_tpu_torch.data.epic import EpicBatchPipeline, EpicSoundsDataset
    from aum_tpu_torch.run import epic_audio_config
    from aum_tpu_torch.run import main as run_main

    cfg = RECIPES[EPIC_RECIPE]
    ecfg = epic_audio_config(cfg)
    audio, records = _epic_data(ecfg.sampling_rate, cfg.n_class, seed=2)
    pipes = {split: EpicBatchPipeline(
        EpicSoundsDataset(records[split], audio, ecfg, split=split),
        cfg.batch_size if split == "train" else 2 * cfg.batch_size, train=split == "train",
        seed=cfg.seed) for split in EPIC_RECORDS}
    depth = cfg.model_config().depth
    out = {}
    with tempfile.TemporaryDirectory(prefix="aum_epic_") as root:
        exp = os.path.join(root, "exp")
        rec = _run_recipe(EPIC_RECIPE, None, exp, [],
                          pipelines=(pipes["train"], pipes["val"], None))
        out["train"] = _check_recipe_run(rec, cfg.batch_size, n_steps=4, n_val=1, depth=depth)
        del rec
        ev = os.path.join(root, "test")
        test = {"recipe": EPIC_RECIPE, "steps": [], "val_batches": []}
        with _recipe_probes(test):
            torch.cuda.synchronize()
            _reset_counters()
            metrics = run_main(["--recipe", EPIC_RECIPE, "--exp-dir", ev, "--run-type", "eval",
                                "--ckpt", os.path.join(exp, "models")],
                               pipelines=(None, None, pipes["test"]))
            torch.cuda.synchronize()
            launches = _read_counters()
        scores = np.loadtxt(os.path.join(ev, "predictions_eval.csv"), delimiter=",")
        view_launches = _launches(selective_scan_dual_fwd=depth, causal_conv1d_fwd=depth)
        n_views = EPIC_RECORDS["test"] * ecfg.num_ensemble_views
        out["test"] = {"phase": "epic_test_split", "records": EPIC_RECORDS["test"],
                       "views": ecfg.num_ensemble_views, "batches": len(test["val_batches"]),
                       "batch_launches": test["val_batches"], "launches": launches,
                       "scores_shape": list(scores.shape), "metrics": metrics,
                       "artifacts": sorted(os.listdir(ev))}
        emit(out["test"])
        if (scores.shape != (EPIC_RECORDS["test"], cfg.n_class) or not np.isfinite(scores).all()
                or not 0.0 <= metrics["acc"] <= 1.0):
            raise RuntimeError("EPIC test split: expected finite view-averaged scores, "
                               f"one row per record, got {scores.shape}")
        n_batches = -(-n_views // pipes["test"].batch_size)
        if (len(test["val_batches"]) != n_batches
                or any(b != view_launches for b in test["val_batches"])):
            raise RuntimeError(f"EPIC test split: expected {n_batches} batches of "
                               f"{view_launches} launches")
    out["featurize"] = _check_epic_featurize(pipes["train"])
    return out


# The flex phase: the as20k recipe trained with flexible patch sizes (the
# runner's ``--set flexible_patch_sizes``, the reference's FlexiAuM
# training) from flac files, decoded by the native ffmpeg-backed decoder.
# train_loop draws each step's size from np.random.default_rng(1234): 16,
# 16, 16, 12, 8 over the first five steps, so 60 train clips (5 steps of
# 12) reach every size; one validation batch of 24 at the recipe's patch 16.
FLEX_RECIPE = "as20k/aum-base_scratch"
FLEX_SIZES = (8, 12, 16)
FLEX_SPLITS = {"train": 60, "val": 24}
FLEX_STEPS = 5
# The recipe's kernels at the token counts of patch 8 (16 x 128 patches and
# the cls token) and of patch 32 (4 x 32 and the cls token), at B=12.
FLEX_DIMS = {"flex_p8": (12, 2049, 1536), "flex_p32": (12, 129, 1536)}
# One train step at each of these patch sizes (AuM-Base Fo-Bi, B=12, split
# remat): ms, launches and peak memory at each token count, and the fit of
# the memory per (layer, sample, token, channel) that remat_mode="auto" reads.
FLEX_STEP_PATCHES = (8, 12, 16, 24, 32)
FLEX_EVAL_BATCH = 8


def _tokens(patch: int, cfg) -> int:
    from aum_tpu_torch.models.tokenization import patch_grid_shape

    f, t = patch_grid_shape(patch, patch, *cfg.spectrogram_size)
    return f * t + cfg.num_prefix_tokens


def _check_flex_kernels(label, dims, dtype) -> list[dict]:
    """The flexible recipe's kernels at ``dims``, against their plain
    versions: the saving dual forward on v1 operands (outputs and states), K2
    on both directions from those states, and the conv forward and
    backward."""
    from aum_tpu_torch.ops.selective_scan import (
        selective_scan_bwd_cuda,
        selective_scan_bwd_plain,
        selective_scan_dual_cuda,
        selective_scan_dual_plain,
    )

    bsz, seqlen, d = dims
    tag = dict(shape=label, dims=[bsz, seqlen, d, 16], dtype=str(dtype), bimamba="v1")
    dir_f, dir_r = _scan_dirs(bsz, seqlen, d, dtype, shared=True)
    got = selective_scan_dual_cuda(dir_f, dir_r, save_states=True)
    torch.cuda.synchronize()
    want = selective_scan_dual_plain(dir_f, dir_r, save_states=True)
    atol, rtol = SCAN_TOL[dtype]
    results = []
    for i, (y, w) in enumerate(zip(got, want)):
        results.append({**compare(y, w, *((atol, rtol) if i < 2 else XB_TOL)),
                        "kernel": "selective_scan_dual_fwd", "against": "plain",
                        "save_states": True, "output": "out" if i < 2 else "xb",
                        "direction": "reverse" if i % 2 else "forward", **tag})
    del want
    g = torch.Generator().manual_seed(5)
    gs = [torch.randn((bsz, seqlen, d), generator=g).to("cuda", dtype) for _ in range(2)]
    dirs = [dir_f + (False,), dir_r + (True,)]
    grads = selective_scan_bwd_cuda(dirs, gs, list(got[2:]))
    torch.cuda.synchronize()
    want = selective_scan_bwd_plain(dirs, gs)
    for direction, (gr, wr) in enumerate(zip(grads, want)):
        results.append({**_grad_checks(GRAD_NAMES, gr, wr, GRAD_TOL[dtype]),
                        "kernel": "selective_scan_bwd", "form": "two_directions",
                        "against": "plain", "direction": "reverse" if direction else "forward",
                        **tag})
    for train in (False, True):
        results += _check_conv(label, dims, dtype, train)
    return results


def _bench_flex_kernels(sfu_rate: float) -> dict:
    """The three kernels of the flexible recipe at each of FLEX_DIMS (bf16):
    ms per launch (CUDA events), the plain version's ms, the bound, and for
    the conv the PyTorch call that computes its function."""
    from aum_tpu_torch.ops.conv1d import causal_conv1d_cuda, causal_conv1d_plain
    from aum_tpu_torch.ops.selective_scan import (
        selective_scan_bwd_cuda,
        selective_scan_bwd_plain,
        selective_scan_dual_cuda,
        selective_scan_dual_plain,
    )

    n, k, es, dtype = 16, 4, 2, torch.bfloat16
    out = {}
    for label, (bsz, seqlen, d) in FLEX_DIMS.items():
        dir_f, dir_r = _scan_dirs(bsz, seqlen, d, dtype, shared=True)
        iters = max(20, 100 * 513 // seqlen)
        save = {"ms": cuda_ms(lambda: selective_scan_dual_cuda(dir_f, dir_r, save_states=True),
                              iters=iters),
                "plain_ms": cuda_ms(lambda: selective_scan_dual_plain(dir_f, dir_r,
                                                                      save_states=True),
                                    iters=1, warmup=1),
                "bounds_ms": _save_bounds(bsz, seqlen, d, n, es, sfu_rate)}
        _, _, xb_f, xb_r = selective_scan_dual_cuda(dir_f, dir_r, save_states=True)
        g = torch.Generator().manual_seed(9)
        gs = [torch.randn((bsz, seqlen, d), generator=g).to("cuda", dtype) for _ in range(2)]
        dirs = [dir_f + (False,), dir_r + (True,)]
        bwd = {"ms": cuda_ms(lambda: selective_scan_bwd_cuda(dirs, gs, [xb_f, xb_r]),
                             iters=iters),
               "plain_ms": cuda_ms(lambda: selective_scan_bwd_plain(dirs, gs), iters=1,
                                   warmup=1),
               "bounds_ms": _bwd_bounds(bsz, seqlen, d, n, es, sfu_rate, 2)}
        del dir_f, dir_r, xb_f, xb_r, gs, dirs
        xc, w, b = conv_inputs(bsz, seqlen, d, k, dtype, seed=5)
        w3 = w[:, None, :]
        conv = {"ms": cuda_ms(lambda: causal_conv1d_cuda(xc, w, b, "silu", False),
                              iters=10 * iters),
                "plain_ms": cuda_ms(lambda: causal_conv1d_plain(xc, w, b, "silu", False),
                                    iters=10),
                "library_ms": cuda_ms(lambda: torch.nn.functional.silu(
                    torch.nn.functional.conv1d(xc.transpose(1, 2), w3, b, padding=k - 1,
                                               groups=d)[..., :seqlen]), iters=50),
                "bounds_ms": _conv_bounds(bsz, seqlen, d, k, es)}
        del xc, w, b, w3
        for entry in (save, bwd, conv):
            entry["bound_ms"], entry["bound_by"] = _bound(entry["bounds_ms"])
            entry["over_bound"] = entry["ms"] / entry["bound_ms"]
        out[label] = {"dims": [bsz, seqlen, d, n], "scan_save": save, "scan_bwd": bwd,
                      "conv": conv}
    emit({"phase": "flex_bench_kernels", "dtype": "bfloat16", **out})
    return out


def _flex_steps() -> dict:
    """One train step of AuM-Base Fo-Bi (B=12, split remat) at each patch of
    FLEX_STEP_PATCHES through ``make_train_step(patch_size=)``, bf16 and
    fp32: launches, finite loss, ms per step and one step profiled (bf16: 3
    steps after one) and peak memory after one warm-up step. The peak's slope over depth x B x L x
    d_inner is the bytes per element of remat_mode="auto"'s estimate."""
    import dataclasses

    import numpy as np

    from aum_tpu_torch.entry import STEPS_PER_EPOCH, TRAIN_BATCH, TRAIN_HP, flagship_config
    from aum_tpu_torch.models import AudioMamba
    from aum_tpu_torch.models.audio_mamba import (
        SPLIT_REMAT_BYTES_PER_ELEMENT,
        resolve_remat_mode,
    )
    from aum_tpu_torch.train import init_train_state, make_optimizer, make_train_step

    out = {}
    for dtype in ("bfloat16", "float32"):
        cfg = flagship_config(dtype=dtype, remat=True, remat_mode="split")
        g = torch.Generator().manual_seed(11)
        x = torch.randn((TRAIN_BATCH, *reversed(cfg.spectrogram_size)), generator=g)
        y = torch.nn.functional.one_hot(torch.arange(TRAIN_BATCH) % cfg.num_classes,
                                        cfg.num_classes).float()
        batch = {"x": x.cuda(), "y": y.cuda()}
        model = AudioMamba(cfg, device="cuda", seed=0)
        state = init_train_state(model, make_optimizer(model.parameters(), TRAIN_HP))
        param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
        rows = []
        for patch in FLEX_STEP_PATCHES:
            step = make_train_step(TRAIN_HP, STEPS_PER_EPOCH, "BCE", patch_size=patch)
            state, _ = step(state, batch)  # Adam's moments exist from here on
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_counters()
            state, loss = step(state, batch)
            torch.cuda.synchronize()
            launches = _read_counters()
            peak = torch.cuda.max_memory_allocated()
            tokens = _tokens(patch, cfg)
            row = {"patch_size": patch, "tokens": tokens, "loss": float(loss),
                   "launches": {k: v for k, v in launches.items() if v},
                   "peak_mem_bytes": peak,
                   "elements": cfg.depth * TRAIN_BATCH * tokens * 2 * cfg.embed_dim,
                   "auto_resolves_to": resolve_remat_mode(
                       dataclasses.replace(cfg, remat_mode="auto"), TRAIN_BATCH, tokens,
                       torch.device("cuda"), param_bytes)}
            if dtype == "bfloat16":
                row["ms_per_step"] = cuda_ms(lambda: step(state, batch), iters=3, warmup=0)
                # A steady step under torch.profiler: where its time goes.
                prof = _profile("profile_flex_step", lambda: step(state, batch),
                                patch_size=patch, tokens=tokens, batch=TRAIN_BATCH)
                row["idle_share"] = prof["idle_share"]
                row["device_busy_ms"] = prof["device_busy_ms"]
            emit({"phase": "flex_step", "dtype": dtype, "batch": TRAIN_BATCH, **row})
            expected = _expected_train_launches("Fo-Bi", cfg.depth, {}, bf16=dtype == "bfloat16")
            if launches != expected or not math.isfinite(row["loss"]):
                raise RuntimeError(f"flex step at patch {patch} ({dtype}): expected {expected} "
                                   f"launches and a finite loss, got {launches}, {row['loss']}")
            rows.append(row)
        elements = np.array([r["elements"] for r in rows], np.float64)
        peaks = np.array([r["peak_mem_bytes"] for r in rows], np.float64)
        slope, intercept = np.polyfit(elements, peaks, 1)
        fit = {"bytes_per_element": float(slope), "fixed_bytes": float(intercept),
               "param_bytes": param_bytes,
               "max_residual_bytes": float(np.abs(peaks - (slope * elements + intercept)).max()),
               "table_bytes_per_element": SPLIT_REMAT_BYTES_PER_ELEMENT[
                   getattr(torch, dtype).itemsize]}
        emit({"phase": "flex_remat_fit", "dtype": dtype, **fit,
              "total_memory_bytes": torch.cuda.get_device_properties(0).total_memory})
        if any(r["auto_resolves_to"] != "split" for r in rows):
            raise RuntimeError(f"remat_mode='auto' does not resolve to split at every patch "
                               f"({dtype})")
        out[dtype] = {"steps": rows, "fit": fit}
        del model, state, step
    return out


def _flex_fp32_checks() -> dict:
    """fp32 against the CPU, on the same weights and draws: a depth-2 train
    step at patch 8 (B=1: the CPU oracle's backward over 2049 tokens takes
    ~75 s a sample on the card's host) and at patch 32 (Fo-Bi) and a
    depth-2 Bi-Bi train step (``_train_fp32_check``'s bounds); full-depth
    forwards at the model bound
    (B=2): Fo-Bi with a random cls position, a token shuffle and a flip
    drawn once on the CPU and applied on both, Fo-Bi with RoPE on the hidden
    and the residual stream, and Bi-Bi."""
    from aum_tpu_torch.entry import flagship_config
    from aum_tpu_torch.models import AudioMamba, draw_tokens

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"train": {}}
    for patch, batch in ((8, 1), (32, 2)):
        out["train"][f"fobi_p{patch}"] = _train_fp32_check("Fo-Bi", {"default": {}}, patch,
                                                           batch)
    out["train"]["bibi"] = _train_fp32_check("Bi-Bi", {"default": {}})
    base = flagship_config(dtype="float32")
    x = torch.randn((2, *reversed(base.spectrogram_size)),
                    generator=torch.Generator().manual_seed(12))
    draws = draw_tokens(torch.Generator().manual_seed(13), base.num_patches,
                        base.num_patches + 1, True, True, 1.0)
    stochastic = dict(if_random_cls_token_position=True, if_random_token_rank=True,
                      flip_sequence_prob=1.0, token_draws=draws)
    forwards = {"stochastic_tokens": (base, stochastic),
                "rope": (flagship_config(dtype="float32", if_rope=True, if_rope_residual=True),
                         {}),
                "bibi": (flagship_config("Bi-Bi", dtype="float32"), {})}
    atol, rtol = MODEL_FP32_TOL
    for name, (cfg, kw) in forwards.items():
        t0 = time.perf_counter()
        with torch.inference_mode():
            gpu = AudioMamba(cfg, device="cuda", seed=0)
            torch.cuda.synchronize()
            _reset_counters()
            got = gpu(x.cuda(), **kw).cpu()
            launches = _read_counters()
            del gpu
            t1 = time.perf_counter()
            want = AudioMamba(cfg, device="cpu", seed=0)(x, **kw)
        r = compare(got, want, atol, rtol)
        expected = _launches(selective_scan_dual_fwd=cfg.depth, causal_conv1d_fwd=cfg.depth * (
            2 if cfg.bimamba_type == "v2" else 1))
        out[name] = {"phase": "flex_fp32_vs_cpu", "forward": name, "batch": 2,
                     "depth": cfg.depth, "width": cfg.embed_dim, "bimamba": cfg.bimamba_type,
                     "launches": launches, "expected_launches": expected,
                     "gpu_s": t1 - t0, "cpu_s": time.perf_counter() - t1, **r,
                     **({"draws": {"cls_position": draws.cls_position, "flip": draws.flip}}
                        if kw else {})}
        emit(out[name])
        if not r["ok"] or launches != expected:
            raise RuntimeError(f"fp32 {name} forward on the card disagrees with the CPU, or "
                               "launched other kernels than expected")
    return out


def _flex_bf16_forwards() -> dict:
    """Two full-width bf16 Fo-Bi forwards at B=8, as ``entry()`` runs them:
    with a random cls position, a shuffle and a flip (drawn from a
    generator), and with RoPE; finite (8, 527) logits and entry()'s
    launches."""
    from aum_tpu_torch.entry import flagship_config
    from aum_tpu_torch.models import AudioMamba

    runs = {"stochastic_tokens": ({}, dict(if_random_cls_token_position=True,
                                           if_random_token_rank=True, flip_sequence_prob=0.5,
                                           generator=torch.Generator().manual_seed(14))),
            "rope": ({"if_rope": True, "if_rope_residual": True}, {})}
    out = {}
    for name, (cfg_kw, kw) in runs.items():
        cfg = flagship_config(**cfg_kw)
        model = AudioMamba(cfg, device="cuda", seed=0)
        x = torch.zeros((FLEX_EVAL_BATCH, *reversed(cfg.spectrogram_size)), device="cuda")
        with torch.inference_mode():
            torch.cuda.synchronize()
            _reset_counters()
            logits = model(x, **kw)
            torch.cuda.synchronize()
            launches = _read_counters()
            ms = cuda_ms(lambda: model(x, **kw), iters=5)
        finite = bool(torch.isfinite(logits.float()).all())
        expected = _launches(selective_scan_dual_fwd=cfg.depth, causal_conv1d_fwd=cfg.depth)
        out[name] = {"phase": "flex_bf16_forward", "forward": name, "batch": FLEX_EVAL_BATCH,
                     "logits_shape": list(logits.shape), "finite": finite,
                     "launches": launches, "ms_per_forward": ms}
        emit(out[name])
        if (tuple(logits.shape) != (FLEX_EVAL_BATCH, cfg.num_classes) or not finite
                or launches != expected):
            raise RuntimeError(f"bf16 {name} forward: expected finite (8, 527) logits and "
                               f"{expected} launches, got {launches}")
        del model
    return out


def phase_flex(device_info: dict) -> dict:
    """The flexible-patch recipe and its kernels: (a) the saving dual
    forward, K2 and the conv at FLEX_DIMS against their plain versions, fp32
    and bf16, and their times beside their bounds; (b) ``run.main`` on the
    as20k recipe with ``--set flexible_patch_sizes=8,12,16`` from flac
    files, 5 train steps (patches 16, 16, 16, 12, 8) and one validation
    batch, every launch counter set to 0 just before and read
    just after; (c) one train step at each of FLEX_STEP_PATCHES, the memory
    fit of remat_mode="auto"; (d) fp32 checks against the CPU; (e) two bf16
    forwards with the stochastic token order and with RoPE. Where the
    ffmpeg headers are missing, (b) runs from WAV files and says so."""
    import tempfile

    from aum_tpu_torch.configs import RECIPES
    from aum_tpu_torch.data import native
    from aum_tpu_torch.train import flexible_patch_schedule

    results = []
    for label, dims in FLEX_DIMS.items():
        for dtype in (torch.float32, torch.bfloat16):
            results += _check_flex_kernels(label, dims, dtype)
    worst = {}
    for r in results:
        emit({"phase": "flex_kernels", **r})
        if r["dtype"] == str(torch.bfloat16):
            key = r["kernel"] + ("_save_states" if r.get("save_states") else "")
            worst[key] = max(worst.get(key, 0.0), r["max_abs_err"])
    failed = [r for r in results if not r["ok"]]
    emit({"phase": "flex_kernels_summary", "checks": len(results), "failed": len(failed),
          "worst_bf16_max_abs_err": worst})
    if failed:
        raise RuntimeError(f"{len(failed)} flex kernel checks disagree with the plain version")
    sfu_rate = device_info["sms"] * SFU_PER_SM_PER_CLOCK * max_sm_clock_hz()
    bench = _bench_flex_kernels(sfu_rate)

    cfg = RECIPES[FLEX_RECIPE]
    codec = "flac" if native.av_headers() is not None else None
    if codec is None:
        emit({"phase": "flex_decoder", "ffmpeg_headers": None,
              "note": "no libav headers on this machine: the flex recipe runs from WAV files "
                      "and the ffmpeg-backed decoder is not exercised"})
    else:
        native.audio_decoder_available()  # a failed build raises here
        emit({"phase": "flex_decoder", "ffmpeg_headers": native.av_headers(),
              "library": native.audio_library_path().name})
    sizes = ",".join(str(p) for p in FLEX_SIZES)
    with tempfile.TemporaryDirectory(prefix="aum_flex_") as root:
        t0 = time.perf_counter()
        files = _write_recipe_data(root, FLEX_RECIPE, cfg.n_class, seed=3, splits=FLEX_SPLITS,
                                   codec=codec)
        write_s = time.perf_counter() - t0
        # No step profiled: each size's first step grows the allocator's
        # pool; _flex_steps profiles steady steps at every size.
        rec = _run_recipe(FLEX_RECIPE, files, os.path.join(root, "exp"),
                          [f"flexible_patch_sizes={sizes}"], profile_step=None)
    depth = cfg.model_config().depth
    recipe = _check_recipe_run(rec, cfg.batch_size, n_steps=FLEX_STEPS, n_val=1, depth=depth)
    want_sizes = flexible_patch_schedule(FLEX_SIZES, FLEX_STEPS)
    per_step = [{"patch_size": s["patch_size"], "tokens": _tokens(s["patch_size"],
                                                                   cfg.model_config()),
                 "cuda_ms": s["cuda_ms"], "host_ms": s["host_ms"], "loss": s["loss"],
                 "launches": {k: v for k, v in s["launches"].items() if v}}
                for s in rec["steps"]]
    flex = {"phase": "flex_recipe", "format": codec or "wav", "write_s": write_s,
            "patch_sizes": [s["patch_size"] for s in rec["steps"]], "steps": per_step,
            "peak_mem_bytes": rec["peak_mem_bytes"],
            "val_batch_launches": rec["val_batches"][0] if rec["val_batches"] else None}
    emit(flex)
    if flex["patch_sizes"] != want_sizes:
        raise RuntimeError(f"flex recipe ran patch sizes {flex['patch_sizes']}, not "
                           f"{want_sizes}")
    del rec
    steps = _flex_steps()
    checks = _flex_fp32_checks()
    forwards = _flex_bf16_forwards()
    return {"worst": worst, "bench": bench, "recipe": recipe, "flex": flex, "steps": steps,
            "checks": checks, "forwards": forwards}


# The Mamba LM: mamba-130m's widths (the config's defaults) at
# scripts/bench_lm_decode.py's shapes, bf16, random weights from a seed.
LM_CONFIG = dict(d_model=768, n_layer=24, vocab_size=50277, dtype="bfloat16")
LM_NEW_TOKENS = 32
# fp32, depth 2: the card (kernels) against the CPU plain path, within
# tests/test_goldens.py's bound; the card's prefill against stepping its
# decode_step through the same prompt, within tests/test_lm.py's.
LM_CHECK_DEPTH, LM_CHECK_BATCH, LM_CHECK_STEPS, LM_STEPWISE_PROMPT = 2, 4, 8, 64
LM_FP32_TOL = (2e-3, 2e-3)  # (atol, rtol)
LM_STEPWISE_TOL = (2e-4, 2e-4)


def _lm_fp32_checks(cfg) -> dict:
    """(b) prefill logits and caches, then LM_CHECK_STEPS decode steps'
    logits, card against CPU; (c) on the card, prefill's next logits and
    caches against decode_step stepped through the same prompt."""
    import dataclasses

    from aum_tpu_torch.models.lm import MambaLM, decode_step, init_decode_state, prefill

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, n_layer=LM_CHECK_DEPTH, dtype="float32")
    gpu = MambaLM(cfg32, device="cuda", seed=1)
    cpu = MambaLM(cfg32, device="cpu", seed=1)
    g = torch.Generator().manual_seed(3)
    seqlen = LM_PREFILL_DIMS[1]
    ids = torch.randint(0, cfg.vocab_size, (LM_CHECK_BATCH, seqlen), generator=g)
    steps = torch.randint(0, cfg.vocab_size, (LM_CHECK_STEPS, LM_CHECK_BATCH), generator=g)
    t0 = time.perf_counter()
    lg, sg = prefill(gpu, ids.cuda())
    lc, sc = prefill(cpu, ids)
    checks = {"prefill_logits": compare(lg.cpu(), lc, *LM_FP32_TOL),
              "prefill_conv": compare(sg["conv"].cpu(), sc["conv"], *LM_FP32_TOL),
              "prefill_ssm": compare(sg["ssm"].cpu(), sc["ssm"], *LM_FP32_TOL)}
    for i in range(LM_CHECK_STEPS):
        lg, sg = decode_step(gpu, steps[i].cuda(), sg)
        lc, sc = decode_step(cpu, steps[i], sc)
        checks[f"decode_{i}_logits"] = compare(lg.cpu(), lc, *LM_FP32_TOL)
    vs_cpu_s = time.perf_counter() - t0
    # (c) stepwise against parallel, on the card.
    prompt = ids[:, :LM_STEPWISE_PROMPT].cuda()
    lp, sp = prefill(gpu, prompt)
    ss = init_decode_state(cfg32, LM_CHECK_BATCH, "cuda")
    for t in range(prompt.shape[1]):
        ls, ss = decode_step(gpu, prompt[:, t], ss)
    nxt = lp.argmax(dim=-1)
    stepwise = {"logits": compare(lp, ls, *LM_STEPWISE_TOL),
                "conv": compare(sp["conv"], ss["conv"], *LM_STEPWISE_TOL),
                "ssm": compare(sp["ssm"], ss["ssm"], *LM_STEPWISE_TOL),
                "next_logits": compare(decode_step(gpu, nxt, sp)[0],
                                       decode_step(gpu, nxt, ss)[0], *LM_STEPWISE_TOL)}
    out = {"phase": "lm_fp32_checks", "depth": LM_CHECK_DEPTH, "batch": LM_CHECK_BATCH,
           "prompt": seqlen, "decode_steps": LM_CHECK_STEPS, "vs_cpu": checks,
           "vs_cpu_tol": LM_FP32_TOL, "vs_cpu_s": vs_cpu_s,
           "stepwise_prompt": LM_STEPWISE_PROMPT, "stepwise_vs_prefill": stepwise,
           "stepwise_tol": LM_STEPWISE_TOL}
    emit(out)
    failed = [k for k, r in {**checks, **stepwise}.items() if not r["ok"]]
    if failed:
        raise RuntimeError(f"LM fp32 checks failed: {failed}")
    return out


def phase_lm() -> dict:
    """The Mamba LM at mamba-130m's widths (bf16, random weights from seed
    0): prefill of B=8 x 512 tokens (ms, tokens/s, launches: 24 with_state
    single-direction forwards and 24 convs), one decode step (launches: no
    scan or conv kernel; ms), greedy generation of 32 tokens (ms per decode
    step, tokens/s, peak memory); then the fp32 checks."""
    from aum_tpu_torch.models.lm import MambaLM, MambaLMConfig, decode_step, generate, prefill

    cfg = MambaLMConfig(**LM_CONFIG)
    bsz, seqlen, _ = LM_PREFILL_DIMS
    model = MambaLM(cfg, device="cuda", seed=0)
    ids = torch.randint(0, cfg.vocab_size, (bsz, seqlen),
                        generator=torch.Generator().manual_seed(0)).cuda()
    prefill(model, ids)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    logits, state = prefill(model, ids)
    torch.cuda.synchronize()
    prefill_launches = _read_counters()
    token = logits.argmax(dim=-1)
    _reset_counters()
    step_logits, _ = decode_step(model, token, state)
    torch.cuda.synchronize()
    decode_launches = _read_counters()
    prefill_ms = cuda_ms(lambda: prefill(model, ids), iters=5)
    decode_ms = cuda_ms(lambda: decode_step(model, token, state), iters=20)
    generate(model, ids, 2, temperature=0.0)  # warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    _reset_counters()
    t0 = time.perf_counter()
    start.record()
    tokens = generate(model, ids, LM_NEW_TOKENS, temperature=0.0)
    end.record()
    end.synchronize()
    generate_host_ms = (time.perf_counter() - t0) * 1e3
    generate_launches = _read_counters()
    generate_ms = start.elapsed_time(end)
    depth = cfg.n_layer
    expected_prefill = _launches(selective_scan_fwd=depth, selective_scan_fwd_with_state=depth,
                                 causal_conv1d_fwd=depth)
    finite = bool(torch.isfinite(logits.float()).all() and torch.isfinite(step_logits.float()).all())
    out = {"phase": "lm_path", "config": LM_CONFIG, "batch": bsz, "prompt": seqlen,
           "new_tokens": LM_NEW_TOKENS, "logits_shape": list(logits.shape),
           "dtype": str(logits.dtype), "finite": finite,
           "prefill_ms": prefill_ms, "prefill_tokens_per_s": bsz * seqlen / (prefill_ms / 1e3),
           "decode_step_ms": decode_ms, "decode_tokens_per_s": bsz / (decode_ms / 1e3),
           "generate_ms": generate_ms, "generate_host_ms": generate_host_ms,
           "generate_tokens_per_s": bsz * LM_NEW_TOKENS / (generate_ms / 1e3),
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "prefill_launches": prefill_launches, "decode_step_launches": decode_launches,
           "generate_launches": generate_launches, "tokens_shape": list(tokens.shape)}
    emit(out)
    if tuple(logits.shape) != (bsz, cfg.padded_vocab) or not finite:
        raise RuntimeError("LM prefill/decode logits are not finite (B, padded vocab) values")
    if tuple(tokens.shape) != (bsz, seqlen + LM_NEW_TOKENS) or int(tokens.max()) >= cfg.vocab_size:
        raise RuntimeError(f"generate returned {tuple(tokens.shape)} tokens or padded ids")
    if prefill_launches != expected_prefill or generate_launches != expected_prefill:
        raise RuntimeError(f"expected {expected_prefill} launches per prefill and per generate, "
                           f"got {prefill_launches} and {generate_launches}")
    if decode_launches != _launches():
        raise RuntimeError(f"a decode step launched {decode_launches}")
    del model, logits, state
    out["fp32"] = _lm_fp32_checks(cfg)
    return out


# The checkpoint porters on the card: reference checkpoints with random
# weights, written by the porters' inverse, brought in through run.main.
PORTER_SPC = "speechcommands/aum-base_scratch"
PORTER_AS20K = "as20k/aum-base_scratch"
PORTER_SPC_SPLITS = {"train": 256, "val": 128}  # 2 steps at B=128, one val batch
PORTER_AS20K_SPLITS = {"val": 24}  # one as20k val batch
# The AuM donor's seed: run.main with --set seed=PORTER_SEED draws the same
# weights in process, which the .pth eval must reproduce bit for bit.
PORTER_SEED = 11
VIM_SEED = 12


def _variant_sets(variant, base) -> list:
    """The ``--set`` overrides that make recipe ``base`` into ``variant``
    (what a ``configs`` variant helper returns), its name aside."""
    import dataclasses

    return [f"{f.name}={getattr(variant, f.name)}" for f in dataclasses.fields(variant)
            if f.name != "name" and getattr(variant, f.name) != getattr(base, f.name)]


@contextlib.contextmanager
def _build_probe(records: dict, expected: dict):
    """Wrap ``run.build_model`` while a run builds its model: the built
    model's state dict against ``expected`` (the ported keys), key for key
    and bit for bit, and the keys the init kept."""
    from aum_tpu_torch import run

    saved = run.build_model

    def build_model(cfg, device, *args, **kwargs):
        model = saved(cfg, device, *args, **kwargs)
        sd = model.state_dict()
        records.update({
            "ported_keys": len(expected),
            "equal": sum(k in sd and torch.equal(sd[k].cpu(), v) for k, v in expected.items()),
            "kept_from_init": sorted(set(sd) - set(expected)),
            "params": sum(v.numel() for v in sd.values())})
        return model

    run.build_model = build_model
    try:
        yield records
    finally:
        run.build_model = saved


def _check_build(label: str, built: dict, fresh: set) -> dict:
    emit({"phase": label, **built})
    if built.get("equal") != built.get("ported_keys") or set(built["kept_from_init"]) != fresh:
        raise RuntimeError(f"{label}: the built model does not hold the ported weights "
                           f"(keys kept from the init: {built.get('kept_from_init')}, "
                           f"expected {sorted(fresh)})")
    return built


def _reference_aum(path: str, cfg, seed: int) -> None:
    """A random reference AuM checkpoint of ``cfg``, keys prefixed
    ``module.`` (as the reference's DDP runs save them)."""
    from aum_tpu_torch.convert import export_aum_state_dict
    from aum_tpu_torch.models import AudioMamba

    sd = export_aum_state_dict(AudioMamba(cfg, device="cpu", seed=seed))
    torch.save({"module." + k: v for k, v in sd.items()}, path)


def _vim_checkpoint(path: str, seed: int) -> None:
    """A random ImageNet ViM-small checkpoint, under the ``model`` key:
    Bi-Bi, 384 wide, 24 layers, a 3-channel 16 x 16 patch kernel, the
    224 x 224 image's 14 x 14 grid with the cls pos embed in the middle,
    1000 classes."""
    from aum_tpu_torch.models import AudioMamba, AudioMambaConfig

    cfg = AudioMambaConfig.from_variant("small", "Bi-Bi", spectrogram_size=(224, 224),
                                        num_classes=1000)
    sd = dict(AudioMamba(cfg, device="cpu", seed=seed).state_dict())
    pos = sd.pop("pos_embed.pos_embed")
    grid = pos[:, 1:]
    mid = grid.shape[1] // 2
    sd["pos_embed"] = torch.cat([grid[:, :mid], pos[:, :1], grid[:, mid:]], dim=1)
    sd["patch_embed.proj.weight"] = 0.02 * torch.randn(
        (cfg.embed_dim, 3, 16, 16), generator=torch.Generator().manual_seed(seed))
    torch.save({"model": sd, "epoch": 300}, path)


def phase_porters() -> dict:
    """Reference checkpoints through the porters and ``run.main``: (a) a
    random AuM-Base Fo-Bi checkpoint of AudioSet's geometry (1024 x 128,
    patch 16, 527 classes, ``module.`` keys) into SpeechCommands
    (``audioset_pretrained_variant``: the grid resampled (8, 64) -> (8, 8),
    the head dropped for 35 classes), 2 train steps and a val batch; (b) a
    random ImageNet ViM-small checkpoint into SpeechCommands' Bi-Bi small
    (``small_imagenet_variant``), 2 train steps and a val batch; each
    built model held to the porter's weights bit for bit, each step's and
    batch's launches to the train and eval paths'; (c) ``--run-type eval
    --ckpt x.pth`` of the AuM checkpoint on an as20k val batch: its scores
    bit-equal to those of the same weights drawn in process; (d) the ported
    AuM-Base in fp32 on the card against the CPU (B=1)."""
    import dataclasses
    import tempfile

    import numpy as np

    from aum_tpu_torch.configs import RECIPES, audioset_pretrained_variant, small_imagenet_variant
    from aum_tpu_torch.convert import (
        load_torch_checkpoint,
        merge_with_init,
        port_aum_state_dict,
        port_vim_imagenet_state_dict,
    )
    from aum_tpu_torch.models import AudioMamba
    from aum_tpu_torch.run import main as run_main

    out = {}
    spc = RECIPES[PORTER_SPC]
    with tempfile.TemporaryDirectory(prefix="aum_porters_") as root:
        t0 = time.perf_counter()
        aum_pth, vim_pth = os.path.join(root, "aum_base.pth"), os.path.join(root, "vim_small.pth")
        _reference_aum(aum_pth, RECIPES[PORTER_AS20K].model_config(), PORTER_SEED)
        _vim_checkpoint(vim_pth, VIM_SEED)
        files = _write_recipe_data(root, PORTER_SPC, spc.n_class, seed=4, splits=PORTER_SPC_SPLITS)
        emit({"phase": "porters_setup", "seconds": time.perf_counter() - t0,
              "aum_pth_mb": os.path.getsize(aum_pth) / 1e6,
              "vim_pth_mb": os.path.getsize(vim_pth) / 1e6})
        # (variant, its AuM type, its porter); the head comes from the init.
        runs = {"pretrained": (audioset_pretrained_variant(PORTER_SPC, aum_pth), "Fo-Bi",
                               lambda cfg: port_aum_state_dict(load_torch_checkpoint(aum_pth),
                                                               cfg)),
                "imagenet": (small_imagenet_variant(PORTER_SPC, vim_pth), "Bi-Bi",
                             lambda cfg: port_vim_imagenet_state_dict(
                                 load_torch_checkpoint(vim_pth, "model"), cfg))}
        ported = {}
        for name, (variant, aum_type, port) in runs.items():
            mcfg = variant.model_config()
            expected = ported[name] = port(mcfg)
            built = {}
            with _build_probe(built, expected):
                rec = _run_recipe(PORTER_SPC, files, os.path.join(root, f"exp_{name}"),
                                  _variant_sets(variant, spc), profile_step=None)
            out[name] = _check_recipe_run(rec, spc.batch_size, n_steps=2, n_val=1,
                                          depth=mcfg.depth, aum_type=aum_type)
            out[name]["build"] = _check_build(f"porters_{name}_build", built,
                                              {"head.weight", "head.bias"})
            del rec

        # (c) The .pth eval, against the same weights drawn in process.
        as20k_root = os.path.join(root, "as20k")
        os.makedirs(as20k_root)
        a20 = _write_recipe_data(as20k_root, PORTER_AS20K, RECIPES[PORTER_AS20K].n_class, seed=5,
                                 splits=PORTER_AS20K_SPLITS)
        argv = ["--recipe", PORTER_AS20K, "--data-val", a20["val"], "--label-csv", a20["csv"],
                "--run-type", "eval"]
        evals = {}
        for name, extra in (("pth", ["--ckpt", aum_pth]), ("seed", ["--set",
                                                                    f"seed={PORTER_SEED}"])):
            rec = {"recipe": PORTER_AS20K, "steps": [], "val_batches": []}
            torch.cuda.synchronize()
            _reset_counters()
            with _recipe_probes(rec):
                metrics = run_main(argv + ["--exp-dir", os.path.join(root, f"ev_{name}")] + extra)
            torch.cuda.synchronize()
            evals[name] = {"metrics": metrics, "launches": _read_counters(),
                           "val_batches": rec["val_batches"], "scores": rec["val_scores"]}
        depth = RECIPES[PORTER_AS20K].model_config().depth
        val_launches = _launches(selective_scan_dual_fwd=depth, causal_conv1d_fwd=depth)
        pth = evals["pth"]
        equal = bool(np.array_equal(pth["scores"], evals["seed"]["scores"]))
        out["pth_eval"] = {"phase": "porters_pth_eval", "recipe": PORTER_AS20K,
                           "val_batches": len(pth["val_batches"]), "launches": pth["launches"],
                           "val_batch_launches": pth["val_batches"][0],
                           "scores_shape": list(pth["scores"].shape),
                           "bit_equal_to_in_process": equal, "metrics": pth["metrics"]}
        emit(out["pth_eval"])
        if not equal or pth["val_batches"] != [val_launches] or pth["launches"] != val_launches:
            raise RuntimeError("the .pth eval's scores or launches are not those of the same "
                               "weights drawn in process")

    # (d) The ported AuM-Base (SpeechCommands' grid, resampled), fp32: the
    # card against the CPU.
    cfg32 = dataclasses.replace(runs["pretrained"][0].model_config(), dtype="float32")
    ref = AudioMamba(cfg32, device="cpu", seed=spc.seed)
    ref.load_state_dict(merge_with_init(ported["pretrained"], ref.state_dict()))
    gpu = AudioMamba(cfg32, device="cuda", seed=0)
    gpu.load_state_dict(ref.state_dict())
    x = torch.randn((1, spc.audio_length, spc.melbins), generator=torch.Generator().manual_seed(8))
    with torch.inference_mode():
        got = gpu(x.cuda()).cpu()
        want = ref(x)
    r = compare(got, want, *MODEL_FP32_TOL)
    out["fp32"] = {"phase": "porters_fp32_vs_cpu", "batch": 1, "depth": cfg32.depth,
                   "grid": list(cfg32.patch_grid), "logits_shape": list(got.shape),
                   "tol": MODEL_FP32_TOL, **r}
    emit(out["fp32"])
    if not r["ok"]:
        raise RuntimeError("the ported AuM-Base in fp32 on the card disagrees with the CPU")
    return out


AST_RECIPE = "as20k/aum-base_scratch"
AST_SPLITS = {"train": 36, "val": 24}  # 3 steps at B=12, one val batch
AST_STEPS = 3


def phase_ast() -> dict:
    """The AST baseline (``ast_variant``: deit_base, 768 wide, 12 heads, 12
    layers, strides 10: 12 x 101 patches and the cls token) on as20k from a
    random reference AST audio checkpoint at the 16/16 pretrain grid (8,
    64): 3 train steps (the third profiled) and a val batch through
    ``run.main``, none of which launches a kernel of ours; the built model
    held to the porter's weights; then an fp32 forward on the card against
    the CPU (B=1)."""
    import dataclasses
    import tempfile

    from aum_tpu_torch.configs import RECIPES, ast_variant
    from aum_tpu_torch.convert import (
        export_ast_state_dict,
        load_torch_checkpoint,
        port_ast_pretrain_state_dict,
    )
    from aum_tpu_torch.models.ast import ASTModel
    from aum_tpu_torch.run import ast_config

    base = RECIPES[AST_RECIPE]
    out = {}
    with tempfile.TemporaryDirectory(prefix="aum_ast_") as root:
        path = os.path.join(root, "ast_audioset.pth")
        variant = dataclasses.replace(ast_variant(AST_RECIPE), ast_pretrain_path=path)
        acfg = ast_config(variant)
        pre = dataclasses.replace(acfg, fstride=variant.ast_pretrain_fstride,
                                  tstride=variant.ast_pretrain_tstride,
                                  input_fdim=variant.ast_pretrain_input_fdim,
                                  input_tdim=variant.ast_pretrain_input_tdim)
        sd = export_ast_state_dict(ASTModel(pre, device="cpu", seed=13))
        torch.save({"module." + k: v for k, v in sd.items()}, path)
        expected = port_ast_pretrain_state_dict(load_torch_checkpoint(path), acfg,
                                                pretrain_grid=pre.patch_grid)
        files = _write_recipe_data(root, AST_RECIPE, base.n_class, seed=6, splits=AST_SPLITS)
        built = {}
        with _build_probe(built, expected):
            rec = _run_recipe(AST_RECIPE, files, os.path.join(root, "exp"),
                              _variant_sets(variant, base), profile_step=AST_STEPS - 1)
    out["recipe"] = _check_recipe_run(rec, base.batch_size, n_steps=AST_STEPS, n_val=1,
                                      depth=acfg.depth, kernels=False)
    out["build"] = _check_build("ast_build", built, set())
    out["grid"] = {"phase": "ast_geometry", "pretrain_grid": list(pre.patch_grid),
                   "grid": list(acfg.patch_grid), "tokens": acfg.num_prefix + acfg.patch_grid[0]
                   * acfg.patch_grid[1], "width": acfg.embed_dim, "heads": acfg.num_heads,
                   "depth": acfg.depth, "params": built["params"]}
    emit(out["grid"])
    del rec

    cfg32 = dataclasses.replace(acfg, dtype="float32")
    x = torch.randn((1, base.audio_length, base.melbins), generator=torch.Generator().manual_seed(9))
    t0 = time.perf_counter()
    with torch.inference_mode():
        got = ASTModel(cfg32, device="cuda", seed=0)(x.cuda()).cpu()
        t1 = time.perf_counter()
        want = ASTModel(cfg32, device="cpu", seed=0)(x)
    r = compare(got, want, *MODEL_FP32_TOL)
    out["fp32"] = {"phase": "ast_fp32_vs_cpu", "batch": 1, "logits_shape": list(got.shape),
                   "gpu_s": t1 - t0, "cpu_s": time.perf_counter() - t1, "tol": MODEL_FP32_TOL,
                   **r}
    emit(out["fp32"])
    if not r["ok"]:
        raise RuntimeError("the AST in fp32 on the card disagrees with the CPU")
    return out


SERVE_BATCH_SIZES = (1, 8, 64)
SERVE_REQUESTS = (3, 64, 70)  # padded to 8; exact; chunked 64 + (6 padded to 8)
# The bundle's predict against the in-process forward at the request's
# batch size. fp32: elementwise (atol, rtol). bf16: max |diff| over the
# logits' largest magnitude, as the GEMMs (by batch rows) and the frontend's
# FFTs (by batch) round differently at a padded size, by about one bf16 ulp
# of the largest logit wherever the reference is small (on an H100: 0.0156
# at B=70 from waveforms, where |ref| ~ 1e-3).
SERVE_TOL = {"float32": (1e-5, 1e-5), "bfloat16": 1e-2}
SERVE_TIMED = (8, 64)
SERVE_TIMED_BUNDLES = ("bfloat16", "bfloat16_wav", "bfloat16_int8")
# The JAX package's int8 bound against the float logits (tests/test_serving.py).
INT8_MIN_COS, INT8_MAX_ABS_FRAC = 0.99, 0.35


def _in_turns(fns: dict, iters: int = 10) -> dict:
    """ms per call of each function (``cuda_ms`` over ``iters`` calls),
    timed in turns: in order, then in the reverse order; each one's mean of
    its two runs, and the runs."""
    runs = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        runs[name].append(cuda_ms(fns[name], iters))
    return {**{name: sum(v) / len(v) for name, v in runs.items()}, "runs": runs}


def _int8_vs_float(got: torch.Tensor, want: torch.Tensor) -> dict:
    got, want = got.float().cpu(), want.float().cpu()
    cos = (got * want).sum(-1) / (got.norm(dim=-1) * want.norm(dim=-1))
    max_abs = float((got - want).abs().max())
    bound = INT8_MAX_ABS_FRAC * max(1.0, float(want.abs().max()))
    return {"min_cos": float(cos.min()), "max_abs": max_abs, "max_abs_bound": bound,
            "ok": bool(cos.min() > INT8_MIN_COS and max_abs < bound)}


def phase_serving() -> dict:
    """Serving bundles of AuM-Base Fo-Bi (random weights, seed 0) at batch
    sizes 1, 8 and 64: bf16 float and int8, each from log-mels and from
    10 s waveforms (the frontend), and an fp32 one. Per bundle its MB and
    load seconds; ``predict`` at B=3, 64 and 70 against the in-process
    forward (``SERVE_TOL``), int8 against float at the JAX package's
    bound; each B=64 predict's launches (the eval path's); ms per
    ``predict`` at B=8 and 64 beside the in-process forward, from a device
    tensor and from a host array, in turns (``SERVE_TIMED_BUNDLES``); the int8
    dequantization's ms alone; then the HTTP server's /healthz and
    /predict (topk 5) on 127.0.0.1."""
    from aum_tpu_torch.entry import (
        AUDIOSET_MEAN,
        AUDIOSET_STD,
        CLIP_SAMPLES,
        SAMPLE_RATE,
        flagship_config,
        wav_forward_fn,
    )
    from aum_tpu_torch.models import AudioMamba
    from aum_tpu_torch.serving import (
        dequantize_params,
        export_bundle,
        load_bundle,
        quantize_weights_int8,
    )
    from aum_tpu_torch.train import make_eval_step

    labels = [f"class {i}" for i in range(527)]
    gen = torch.Generator().manual_seed(10)
    n = max(SERVE_REQUESTS)
    inputs = {False: torch.randn((n, 1024, 128), generator=gen),
              True: 0.1 * torch.randn((n, CLIP_SAMPLES), generator=gen)}
    out = {"bundles": {}}
    depth = flagship_config().depth
    eval_launches = _launches(selective_scan_dual_fwd=depth, causal_conv1d_fwd=depth)
    failed = []
    for dtype in ("bfloat16", "float32"):
        model = AudioMamba(flagship_config(dtype=dtype), device="cuda", seed=0)
        in_process = {False: make_eval_step(model), True: make_eval_step(wav_forward_fn(model))}
        forms = ([(None, False), (None, True), ("int8", False), ("int8", True)]
                 if dtype == "bfloat16" else [(None, False)])
        floats = {}
        for quant, frontend in forms:
            name = f"{dtype}{'_int8' if quant else ''}{'_wav' if frontend else ''}"
            t0 = time.perf_counter()
            blob = export_bundle(model, audio_length=1024, melbins=128,
                                 batch_sizes=SERVE_BATCH_SIZES, mean=AUDIOSET_MEAN,
                                 std=AUDIOSET_STD, labels=labels, include_frontend=frontend,
                                 sample_rate=SAMPLE_RATE,
                                 wav_samples=CLIP_SAMPLES if frontend else None,
                                 weight_quant=quant)
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            sm = load_bundle(blob)
            torch.cuda.synchronize()
            rec = {"phase": "serving_bundle", "bundle": name, "mb": len(blob) / 1e6,
                   "export_s": export_s, "load_s": time.perf_counter() - t0}
            del blob
            x = inputs[frontend]
            for b in SERVE_REQUESTS:
                got = sm.predict(x[:b])
                if tuple(got.shape) != (b, 527) or not bool(torch.isfinite(got.float()).all()):
                    failed.append(f"{name}: predict at B={b} gave {tuple(got.shape)} or "
                                  "non-finite logits")
                if quant is None:
                    floats[(frontend, b)] = got
                    want = in_process[frontend](x[:b].cuda()).float().cpu()
                    r = (compare(got.float().cpu(), want, *SERVE_TOL[dtype]) if dtype == "float32"
                         else compare_scaled(got.cpu(), want, SERVE_TOL[dtype]))
                else:
                    r = _int8_vs_float(got, floats[(frontend, b)])
                rec[f"b{b}"] = r
                if not r["ok"]:
                    failed.append(f"{name}: predict at B={b} {r}")
            big = SERVE_BATCH_SIZES[-1]
            torch.cuda.synchronize()
            _reset_counters()
            sm.predict(x[:big].cuda())
            torch.cuda.synchronize()
            rec["launches_b64"] = _read_counters()
            if rec["launches_b64"] != eval_launches:
                failed.append(f"{name}: a B={big} predict launched {rec['launches_b64']}")
            for b in SERVE_TIMED if name in SERVE_TIMED_BUNDLES else ():
                dev, host = x[:b].cuda(), x[:b].numpy()
                rec[f"ms_b{b}"] = _in_turns({
                    "in_process": lambda: in_process[frontend](dev),
                    "predict_device_input": lambda: sm.predict(dev),
                    "predict_host_input": lambda: sm.predict(host)})
            emit(rec)
            out["bundles"][name] = rec
            if name == "bfloat16":
                out["http"] = _check_http(sm, x[:2])
            del sm
        if dtype == "bfloat16":
            q = quantize_weights_int8(model.state_dict())
            out["dequantize_ms"] = cuda_ms(lambda: dequantize_params(q), 10)
            emit({"phase": "serving_dequantize", "ms": out["dequantize_ms"],
                  "int8_weights": sum(isinstance(v, dict) for v in q.values()),
                  "int8_params": sum(v["int8"].numel() for v in q.values()
                                     if isinstance(v, dict))})
            del q
        del model, in_process, floats
    if failed or not out["http"]["ok"]:
        raise RuntimeError(f"serving: {failed or out['http']}")
    return out


def _check_http(sm, x: torch.Tensor) -> dict:
    """The HTTP front on 127.0.0.1 (an ephemeral port): /healthz, then
    /predict with topk 5 against ``predict_scores``; the server is shut
    down and its thread joined."""
    import json as _json
    import threading
    import urllib.request

    from aum_tpu_torch.serving import make_http_server

    srv = make_http_server(sm, "127.0.0.1", 0)
    port = srv.server_address[1]
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
            health = _json.loads(r.read())
        body = _json.dumps({"instances": x.tolist(), "topk": 5}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/predict", data=body,
                                     headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=120) as r:
            reply = _json.loads(r.read())
        request_ms = (time.perf_counter() - t0) * 1e3
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    want = sm.predict_scores(x).cpu()
    scores = torch.tensor(reply["scores"])
    r = compare(scores, want, 1e-6, 1e-5)
    # Each row's top 5: the 5 largest scores (bf16 logits tie, so the order
    # of equal scores is free), each under its own label.
    index = {name: i for i, name in enumerate(sm.labels)}
    top_ok = len(reply["topk"]) == len(want) and all(
        len(row) == 5
        and [t["score"] for t in row] == want[b].sort(descending=True).values[:5].tolist()
        and all(want[b, index[t["label"]]].item() == t["score"] for t in row)
        for b, row in enumerate(reply["topk"]))
    out = {"phase": "serving_http", "healthz": health, "request_mb": len(body) / 1e6,
           "request_ms": request_ms, "scores": r, "topk": reply["topk"], "topk_ok": top_ok,
           "thread_alive": thread.is_alive(),
           "ok": bool(health.get("ok") and health.get("batch_sizes") == list(SERVE_BATCH_SIZES)
                      and r["ok"] and top_ok and not thread.is_alive())}
    emit(out)
    return out


# --- the upstream code's oracles and the user tools ---------------------------------

# One AuM-Base mixer layer (d_model 768: d_inner 1536, dt rank 48, d_state
# 16, conv width 4) on B=2 x 513 tokens, against the upstream fast path
# through ``convert/ref_runner.py``'s oracles.
REF_ORACLE_DIMS = (2, 513, 768)
REF_ORACLE_VARIANTS = {"Fo-Fo": "none", "Fo-Bi": "v1", "Bi-Bi": "v2"}
REF_ORACLE_SEED = 21
# bf16 mixer grads: the port's error against the oracle's fp32 grads may be
# this many times the oracle's own bf16 error (the two are independent bf16
# roundings of one function; on the card they read 1.03 apart at worst).
REF_BF16_GRAD_RATIO = 2.0
# The counters each variant's forward (inference) and train pass (forward
# under grad, then backward) must move: the dual forward (both directions in
# one launch) or the single one, in eval and saving forms, the conv, and K2
# (one launch for both directions: _bwd_kernel_dual's form, or one for
# Fo-Fo's one direction).
REF_ORACLE_COUNTERS = {
    "Fo-Fo": ("selective_scan_fwd", "selective_scan_fwd_save_states", "causal_conv1d_fwd",
              "selective_scan_bwd"),
    "Fo-Bi": ("selective_scan_dual_fwd", "selective_scan_dual_fwd_save_states",
              "causal_conv1d_fwd", "selective_scan_bwd"),
    "Bi-Bi": ("selective_scan_dual_fwd", "selective_scan_dual_fwd_save_states",
              "causal_conv1d_fwd", "selective_scan_bwd")}


def _grads_of(loss, tensors: dict) -> dict:
    names = [k for k, v in tensors.items() if v.requires_grad]
    return dict(zip(names, torch.autograd.grad(loss, [tensors[k] for k in names])))


def _check_ref_mixer(variant: str, dtype) -> dict:
    """The port's MambaMixer (kernels) against ``oracle_mixer_forward`` on
    the card, the same weights (the mixer's own state dict: the port's
    module tree is the upstream's layout, conv weight (D, 1, K), A = -exp(A_log))
    and inputs: the inference forward (elementwise bound), then the grads of
    the input and every weight through autograd on both sides (scaled; in
    bf16 against the oracle's fp32 grads, see below)."""
    from aum_tpu_torch.convert.ref_runner import oracle_mixer_forward
    from aum_tpu_torch.models.mamba import MambaMixer

    bsz, seqlen, d_model = REF_ORACLE_DIMS
    mixer = MambaMixer(d_model, d_state=16, bimamba_type=REF_ORACLE_VARIANTS[variant],
                       n_layer=24)
    mixer.reset_parameters(torch.Generator().manual_seed(REF_ORACLE_SEED))
    mixer.to("cuda")
    g = torch.Generator().manual_seed(REF_ORACLE_SEED + 1)
    x = torch.randn((bsz, seqlen, d_model), generator=g).to("cuda", dtype)
    cot = torch.randn((bsz, seqlen, d_model), generator=g).to("cuda")
    params = dict(mixer.named_parameters())
    tol = SCAN_TOL[dtype]
    _reset_counters()
    with torch.inference_mode():
        got = mixer(x)
    torch.cuda.synchronize()
    eval_launches = _read_counters()
    with torch.no_grad():
        want = oracle_mixer_forward(params, x, REF_ORACLE_VARIANTS[variant])
    fwd = compare(got, want, *tol)
    # The train pass: forward under grad (the saving forms), backward (K2).
    xg = x.clone().requires_grad_()
    _reset_counters()
    got_grads = _grads_of((mixer(xg).float() * cot).sum(), {"x": xg, **params})
    torch.cuda.synchronize()
    train_launches = _read_counters()
    def oracle_grads(x_dtype):
        ref = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
        xr = x.to(x_dtype).requires_grad_()
        return _grads_of((oracle_mixer_forward(ref, xr, REF_ORACLE_VARIANTS[variant]).float()
                          * cot).sum(), {"x": xr, **ref})

    want_grads = oracle_grads(dtype)
    names = list(want_grads)
    grads = _grad_checks(names, [got_grads[k] for k in names], [want_grads[k] for k in names],
                         GRAD_TOL[dtype])
    if dtype != torch.float32:
        # Two bf16 pipelines round at other places (the port rounds dt,
        # du, ... to bf16 as the JAX package does; upstream keeps dt in
        # fp32), and the upstream's own bf16 grads lie 1-2% of max-abs from
        # its fp32 grads. So in bf16 the port's grads are held to the
        # oracle's fp32 grads, within 1e-2 of max-abs or
        # REF_BF16_GRAD_RATIO times the oracle's own worst bf16 error there,
        # the larger; the direct comparison is reported.
        exact = oracle_grads(torch.float32)
        own = _grad_checks(names, [want_grads[k] for k in names], [exact[k] for k in names],
                           GRAD_TOL[dtype])
        allowed = max(GRAD_TOL[dtype],
                      REF_BF16_GRAD_RATIO * max(e for _, e in own["grads"].values()))
        vs_fp32 = _grad_checks(names, [got_grads[k] for k in names],
                               [exact[k] for k in names], allowed)
        grads = {"vs_oracle_bf16": grads, "oracle_bf16_vs_fp32": own,
                 "vs_oracle_fp32": vs_fp32, "tol": allowed, "ok": vs_fp32["ok"]}
    needed = REF_ORACLE_COUNTERS[variant]
    launched = {k: eval_launches[k] + train_launches[k] for k in needed}
    out = {"phase": "ref_oracles_mixer", "variant": variant, "dtype": str(dtype),
           "dims": [bsz, seqlen, d_model], "forward": fwd, "grads": grads,
           "eval_launches": {k: v for k, v in eval_launches.items() if v},
           "train_launches": {k: v for k, v in train_launches.items() if v},
           "ok": bool(fwd["ok"] and grads["ok"] and all(launched.values()))}
    emit(out)
    return out


def _check_ref_ops(dtype) -> list[dict]:
    """The oracles of single ops against the port's on the card, at the mixer's
    shapes (B=2, L=513, d_inner 1536, N=16), forward and the grads of every
    input: ``selective_scan_fn(..., return_last_state=True)`` against the
    with_state single scan (in bf16 with dt activated outside and rounded to
    bf16, as the port's and the JAX package's scans take it; the upstream
    kernel keeps it fp32), ``causal_conv1d_fn`` (SiLU) against the conv
    kernel, ``rms_norm_fn(prenorm=True, residual_in_fp32=True)`` against the
    block's add+RMSNorm (plain torch, no kernel)."""
    import torch.nn.functional as F

    from aum_tpu_torch.convert import ref_runner
    from aum_tpu_torch.ops import causal_conv1d, fused_add_norm, selective_scan

    o = ref_runner._build_oracle_modules()
    bsz, seqlen, d, n = REF_ORACLE_DIMS[0], REF_ORACLE_DIMS[1], 2 * REF_ORACLE_DIMS[2], 16
    g = torch.Generator().manual_seed(REF_ORACLE_SEED + 2)

    def rand(*shape, scale=1.0, dt=dtype):
        return (scale * torch.randn(shape, generator=g)).to("cuda", dt).requires_grad_()

    out = []
    # The scan, upstream layout (B, D, L) and (B, N, L).
    softplus = dtype == torch.float32
    a = {"u": rand(bsz, d, seqlen), "delta": rand(bsz, d, seqlen, scale=0.5),
         "A": (-torch.exp(0.5 * torch.randn((d, n), generator=g))).cuda().requires_grad_(),
         "B": rand(bsz, n, seqlen), "C": rand(bsz, n, seqlen),
         "D": rand(d, dt=torch.float32), "z": rand(bsz, d, seqlen),
         "delta_bias": rand(d, scale=0.5, dt=torch.float32)}
    if not softplus:
        dt = F.softplus(a["delta"].detach().float() + a["delta_bias"].detach()[None, :, None])
        a["delta"] = dt.to(dtype).requires_grad_()
        del a["delta_bias"]
    y, last = o["selective_scan_fn"](a["u"], a["delta"], a["A"], a["B"], a["C"], a["D"],
                                     z=a["z"], delta_bias=a.get("delta_bias"),
                                     delta_softplus=softplus, return_last_state=True)
    cot = torch.randn(y.shape, generator=g).cuda()
    want_grads = _grads_of((y.float() * cot).sum() + last.sum(), a)
    p = {k: (v.detach().transpose(1, 2) if v.dim() == 3 else v.detach()).requires_grad_()
         for k, v in a.items()}
    y_p, last_p = selective_scan(p["u"], p["delta"], p["A"], p["B"], p["C"], p["D"], p["z"],
                                 p.get("delta_bias"), delta_softplus=softplus,
                                 return_final_state=True)
    got_grads = _grads_of((y_p.float() * cot.transpose(1, 2)).sum() + last_p.sum(), p)
    names = list(want_grads)
    scan = {"phase": "ref_oracles_scan", "dtype": str(dtype), "dims": [bsz, seqlen, d, n],
            "dt_activated_outside": not softplus,
            "y": compare(y_p.transpose(1, 2), y, *SCAN_TOL[dtype]),
            "last_state": compare(last_p, last, *SCAN_TOL[torch.float32]),
            "grads": _grad_checks(names, [got_grads[k].transpose(1, 2)
                                          if got_grads[k].dim() == 3 else got_grads[k]
                                          for k in names],
                                  [want_grads[k] for k in names], GRAD_TOL[dtype])}
    scan["ok"] = scan["y"]["ok"] and scan["last_state"]["ok"] and scan["grads"]["ok"]
    emit(scan)
    out.append(scan)
    # The conv, upstream layout (B, D, L), weight (D, K).
    x, w, b = rand(bsz, d, seqlen), rand(d, 4, scale=0.5), rand(d, scale=0.5)
    want_out = o["causal_conv1d_fn"](x, w, b, activation="silu")
    cot = torch.randn(want_out.shape, generator=g).cuda()
    want_grads = _grads_of((want_out.float() * cot).sum(), {"x": x, "w": w, "b": b})
    xp, wp, bp = (t.detach().clone().requires_grad_() for t in (x, w, b))
    got_out = causal_conv1d(xp.transpose(1, 2), wp, bp, activation="silu")
    got_grads = _grads_of((got_out.float() * cot.transpose(1, 2)).sum(),
                          {"x": xp, "w": wp, "b": bp})
    conv = {"phase": "ref_oracles_conv", "dtype": str(dtype), "dims": [bsz, seqlen, d, 4],
            "out": compare(got_out.transpose(1, 2), want_out, *CONV_TOL[dtype]),
            "grads": _grad_checks(["dx", "dw", "db"], list(got_grads.values()),
                                  list(want_grads.values()), GRAD_TOL[dtype])}
    conv["ok"] = conv["out"]["ok"] and conv["grads"]["ok"]
    emit(conv)
    out.append(conv)
    # add+RMSNorm: hidden in the compute dtype, the residual stream fp32.
    h, res = rand(bsz, seqlen, d // 2), rand(bsz, seqlen, d // 2, dt=torch.float32)
    wn = rand(d // 2, dt=torch.float32)
    y_o, res_o = o["rms_norm_fn"](h, wn, None, residual=res, eps=1e-5, prenorm=True,
                                  residual_in_fp32=True)
    y_p, res_p = fused_add_norm(h, wn.to(dtype), residual=res, prenorm=True, eps=1e-5,
                                residual_in_fp32=True)
    norm = {"phase": "ref_oracles_rms_norm", "dtype": str(dtype),
            "out": compare(y_p, y_o, *SCAN_TOL[dtype]),
            "residual": compare(res_p, res_o, 0.0, 0.0)}
    norm["ok"] = norm["out"]["ok"] and norm["residual"]["ok"] and res_p.dtype == torch.float32
    emit(norm)
    out.append(norm)
    return out


def phase_ref_oracles() -> dict:
    """The port against the upstream code's fused ops as ``convert/ref_runner.py``
    writes them (torch oracles, independent of the port's ops), all on the
    card: one AuM-Base mixer layer for Fo-Fo (``mamba_inner_fn``), Fo-Bi
    (``bimamba_inner_fn``) and Bi-Bi (two ``mamba_inner_fn_no_out_proj``,
    the second on the flipped sequence), fp32 and bf16, forward and the
    grads of the input and every weight; the scan with its last state, the
    conv and add+RMSNorm alone. Every launch counter is set to 0 before the
    phase and read after it: the dual and single forwards (eval, saving and
    with_state), the conv and K2 (one and both directions) must have
    launched."""
    results, by_run = [], {}
    _reset_counters()
    for dtype in (torch.float32, torch.bfloat16):
        for variant in REF_ORACLE_VARIANTS:
            r = _check_ref_mixer(variant, dtype)
            by_run[f"{variant}_{str(dtype).split('.')[-1]}"] = {
                k: r["eval_launches"].get(k, 0) + r["train_launches"].get(k, 0)
                for k in _counters()}
            results.append(r)
    _reset_counters()
    for dtype in (torch.float32, torch.bfloat16):
        results += _check_ref_ops(dtype)
    ops_launches = _read_counters()
    launches = {k: sum(run[k] for run in by_run.values()) + ops_launches[k] for k in _counters()}
    needed = ("selective_scan_dual_fwd", "selective_scan_dual_fwd_save_states",
              "selective_scan_fwd", "selective_scan_fwd_save_states",
              "selective_scan_fwd_with_state", "causal_conv1d_fwd", "selective_scan_bwd",
              "selective_scan_bwd_with_state")
    failed = [f"{r['phase']} {r.get('variant', '')} {r['dtype']}" for r in results
              if not r["ok"]]
    failed += [f"no launch of {k}" for k in needed if not launches[k]]
    out = {"phase": "ref_oracles", "launches": launches, "launches_by_run": by_run,
           "ops_launches": ops_launches, "checks": len(results), "failed": failed}
    emit(out)
    if failed:
        raise RuntimeError(f"ref_oracles: {failed}")
    return out


TOOLS_SEED = 31
TOOLS_WAVS = 8  # the norm-stats and weights set: 1 to 10 s clips
TOOLS_LM_TOKENS = (2, 16)  # verify_lm's default batch and length
TOOLS_HTTP_CLIENTS, TOOLS_HTTP_REQUESTS = 4, 2


def _run_tool(name: str, argv: list, env: dict | None = None) -> dict:
    """``aum_tpu_torch.scripts.<name>.main(argv)`` between a reset and a read
    of every launch counter, its standard output captured; raises unless it
    returns 0."""
    import importlib
    import io

    main = importlib.import_module(f"aum_tpu_torch.scripts.{name}").main
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    buf = io.StringIO()
    try:
        _reset_counters()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _read_counters()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out = {"rc": rc, "seconds": seconds, "stdout": buf.getvalue(),
           "launches": {k: v for k, v in launches.items() if v}}
    if rc != 0:
        raise RuntimeError(f"tool {name} {argv} returned {rc}:\n{buf.getvalue()}")
    return out


def _write_wav16(path: str, samples, sr: int = 16000) -> None:
    import wave

    data = (samples.clamp(-1, 1) * 32767).to(torch.int16).numpy().tobytes()
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(data)


def _http_concurrent(sm, rows: dict) -> dict:
    """``TOOLS_HTTP_CLIENTS`` threads POST their requests to the HTTP front
    at once; each answer against a sequential ``predict_scores`` of the same
    rows (equal expected: the same batch shapes on the same card)."""
    import json as _json
    import threading
    import urllib.request

    from aum_tpu_torch.serving import make_http_server

    srv = make_http_server(sm, "127.0.0.1", 0)
    port = srv.server_address[1]
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    answers, errors = {}, []

    def client(t):
        try:
            for i in range(TOOLS_HTTP_REQUESTS):
                body = _json.dumps({"instances": rows[t, i].tolist()}).encode()
                req = urllib.request.Request(f"http://127.0.0.1:{port}/predict", data=body,
                                             headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=300) as r:
                    answers[t, i] = torch.tensor(_json.loads(r.read())["scores"])
        except Exception as e:  # noqa: BLE001 — reported in the result
            errors.append(repr(e))

    clients = [threading.Thread(target=client, args=(t,)) for t in range(TOOLS_HTTP_CLIENTS)]
    t0 = time.perf_counter()
    try:
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    seconds = time.perf_counter() - t0
    diffs = {f"{t}_{i}": (answers[t, i] - sm.predict_scores(x).cpu()).abs().max().item()
             for (t, i), x in rows.items() if (t, i) in answers}
    out = {"phase": "tools_http_concurrent", "clients": TOOLS_HTTP_CLIENTS,
           "requests": len(rows), "answered": len(answers), "errors": errors,
           "rows": {f"{t}_{i}": len(x) for (t, i), x in rows.items()},
           "seconds": seconds, "max_abs_diff_by_request": diffs,
           "ok": not errors and len(answers) == len(rows) and all(v == 0 for v in diffs.values())
           and not thread.is_alive()}
    emit(out)
    return out


def phase_tools() -> dict:
    """The user tools (``python -m aum_tpu_torch.scripts.<name>``), each
    through its ``main(argv)`` on the card, between a reset and a read of
    every launch counter:

    - ``infer``: AuM-Base Fo-Bi (the AudioSet recipe, bf16, depth 24) on a
      synthetic 10 s 16 kHz WAV, from a random reference ``.pth``; its top-5
      lines must equal those of the same model's in-process forward (the
      recipe's model with the ``.pth`` ported over it, the clip featurized
      as the tool does); ms per clip of that forward at B=1 (CUDA events);
    - ``verify_ckpt`` (AuM-Base Fo-Bi, fp32, 1024 frames, two 10 s clips):
      record, then verify against that record, the raw fbank goldens
      recorded and verified; the recorded logits against ``--device cpu``'s
      within 2e-3 + 2e-3·|ref|;
    - ``verify_lm``: a random Mamba LM at mamba-130m's widths (fp32) written as
      an HF-format directory, then found as a hub id in a hub-cache layout
      under a temporary ``HF_HUB_CACHE``: equal logits either way;
    - ``get_norm_stats`` and ``gen_weight_file`` on 8 synthetic WAVs: against
      ``--device cpu`` (mean and std within 1e-5; the CSV equal);
    - ``export_torch_ckpt``: the infer model saved as a run's ``best``,
      exported; equal to the ``.pth`` it came from;
    - ``--ref-parity``: reported as skipped, with the reason, while no upstream
      checkout is present;
    - the HTTP front under ``TOOLS_HTTP_CLIENTS`` concurrent clients against
      sequential ``predict_scores`` (``_http_concurrent``)."""
    import re
    import tempfile

    import numpy as np

    from aum_tpu_torch.configs import RECIPES
    from aum_tpu_torch.convert.ref_runner import reference_available, reference_root
    from aum_tpu_torch.entry import AUDIOSET_MEAN, AUDIOSET_STD
    from aum_tpu_torch.models.lm import MambaLM, MambaLMConfig
    from aum_tpu_torch.run import build_model, load_checkpoint
    from aum_tpu_torch.scripts.infer import featurize_clip
    from aum_tpu_torch.serving import export_bundle, load_bundle

    out, failed = {}, []
    g = torch.Generator().manual_seed(TOOLS_SEED)
    with tempfile.TemporaryDirectory(prefix="aum_tools_") as tmp:
        labels_csv = os.path.join(tmp, "labels.csv")
        with open(labels_csv, "w") as f:
            f.write("index,mid,display_name\n" + "".join(
                f"{i},/m/c{i},class {i}\n" for i in range(527)))
        t = torch.arange(160000) / 16000.0
        clip = os.path.join(tmp, "clip.wav")
        _write_wav16(clip, 0.05 * torch.randn(160000, generator=g)
                     + 0.3 * torch.sin(2 * math.pi * 440.0 * t))
        clip2 = os.path.join(tmp, "clip2.wav")
        _write_wav16(clip2, 0.1 * torch.randn(160000, generator=g))

        # infer: the tool, then the same model's in-process forward.
        recipe = "audioset/aum-base_scratch"
        cfg = RECIPES[recipe]
        pth = os.path.join(tmp, "aum.pth")
        _reference_aum(pth, cfg.model_config(), seed=TOOLS_SEED)
        run = _run_tool("infer", ["--wav", clip, "--recipe", recipe, "--ckpt", pth,
                                  "--label-csv", labels_csv, "--topk", "5"])
        model = build_model(cfg, torch.device("cuda"))
        load_checkpoint(model, cfg, pth)
        model.eval()
        fb = featurize_clip(clip, cfg, torch.device("cuda"))
        with torch.inference_mode():
            scores = torch.sigmoid(model(fb[None])[0].float()).cpu().numpy()
        names = {i: f"class {i}" for i in range(527)}
        lines = [f"{names[int(i)]}: {float(scores[i]):.4f}"
                 for i in np.argsort(-scores, kind="stable")[:5]]
        with torch.inference_mode():
            clip_ms = cuda_ms(lambda: model(fb[None]), iters=10)
        infer = {"phase": "tools_infer", "recipe": recipe, "dtype": cfg.dtype,
                 "seconds": run["seconds"], "launches": run["launches"],
                 "topk": run["stdout"].splitlines(), "in_process_topk": lines,
                 "ms_per_clip_b1": clip_ms,
                 "ok": run["stdout"].splitlines() == lines
                 and run["launches"].get("selective_scan_dual_fwd") == cfg.model_config().depth}
        emit(infer)
        out["infer"] = infer

        # export_torch_ckpt: the same weights as a run's best -> .pth.
        models_dir = os.path.join(tmp, "models")
        os.makedirs(models_dir)
        torch.save({"model": model.state_dict()}, os.path.join(models_dir, "best"))
        exported = os.path.join(tmp, "exported.pth")
        run = _run_tool("export_torch_ckpt", [
            "--ckpt-dir", models_dir, "--out", exported, "--n-class", str(cfg.n_class),
            "--model-type", cfg.model_type, "--aum-type", cfg.aum_type,
            "--audio-length", str(cfg.audio_length), "--melbins", str(cfg.melbins)])
        src = {k[len("module."):]: v for k, v in torch.load(pth, weights_only=True).items()}
        got = torch.load(exported, weights_only=True)
        export = {"phase": "tools_export_torch_ckpt", "seconds": run["seconds"],
                  "keys": len(got), "ok": set(got) == set(src)
                  and all(torch.equal(got[k], v) for k, v in src.items())}
        emit(export)
        out["export_torch_ckpt"] = export
        del model

        # verify_ckpt: record, verify, features; the card against the CPU.
        args = ["--ckpt", pth, "--model-type", cfg.model_type, "--aum-type", cfg.aum_type,
                "--n-class", str(cfg.n_class), "--audio-length", str(cfg.audio_length),
                "--melbins", str(cfg.melbins), "--wav", clip, clip2, "--label-csv", labels_csv]
        golden, feats = os.path.join(tmp, "golden.npz"), os.path.join(tmp, "features.npz")
        rec = _run_tool("verify_ckpt", args + ["--record-to", golden,
                                               "--features-record-to", feats])
        ver = _run_tool("verify_ckpt", args + ["--golden", golden, "--features", feats])
        cpu_golden = os.path.join(tmp, "golden_cpu.npz")
        cpu = _run_tool("verify_ckpt", args + ["--record-to", cpu_golden, "--device", "cpu"])
        card_logits = torch.from_numpy(np.load(golden)["logits"])
        cpu_logits = torch.from_numpy(np.load(cpu_golden)["logits"])
        vs_cpu = compare(card_logits, cpu_logits, *MODEL_FP32_TOL)
        verify = {"phase": "tools_verify_ckpt", "record_seconds": rec["seconds"],
                  "verify_seconds": ver["seconds"], "cpu_seconds": cpu["seconds"],
                  "launches_record": rec["launches"], "logits": list(card_logits.shape),
                  "vs_cpu_fp32": vs_cpu,
                  "verify_stdout": ver["stdout"].splitlines()[-3:],
                  "ok": "PARITY OK" in ver["stdout"] and "FEATURES PARITY OK" in ver["stdout"]
                  and vs_cpu["ok"]
                  and rec["launches"].get("selective_scan_dual_fwd") == cfg.model_config().depth}
        emit(verify)
        out["verify_ckpt"] = verify

        # verify_lm: an HF directory, then the same files as a cached hub id.
        lm_cfg = MambaLMConfig()  # mamba-130m's widths, fp32
        lm = MambaLM(lm_cfg, device="cpu", seed=TOOLS_SEED)
        hf = os.path.join(tmp, "hf")
        os.makedirs(hf)
        with open(os.path.join(hf, "config.json"), "w") as f:
            json.dump({"d_model": lm_cfg.d_model, "n_layer": lm_cfg.n_layer,
                       "vocab_size": lm_cfg.vocab_size, "ssm_cfg": {}, "rms_norm": True,
                       "residual_in_fp32": True, "fused_add_norm": True,
                       "pad_vocab_size_multiple": lm_cfg.pad_vocab_size_multiple}, f)
        sd = dict(lm.state_dict())
        sd["lm_head.weight"] = sd["backbone.embedding.weight"]
        torch.save(sd, os.path.join(hf, "pytorch_model.bin"))
        del lm, sd
        snap = os.path.join(tmp, "hub", "models--org--aum-lm", "snapshots", "c0ffee")
        os.makedirs(snap)
        os.makedirs(os.path.join(tmp, "hub", "models--org--aum-lm", "refs"))
        with open(os.path.join(tmp, "hub", "models--org--aum-lm", "refs", "main"), "w") as f:
            f.write("c0ffee")
        for name in ("config.json", "pytorch_model.bin"):
            os.symlink(os.path.join(hf, name), os.path.join(snap, name))
        by_dir, by_hub = os.path.join(tmp, "lm_dir.npz"), os.path.join(tmp, "lm_hub.npz")
        d_run = _run_tool("verify_lm", ["--model", hf, "--record-to", by_dir])
        h_run = _run_tool("verify_lm", ["--model", "org/aum-lm", "--record-to", by_hub,
                                        "--golden", by_dir],
                          env={"HF_HUB_CACHE": os.path.join(tmp, "hub")})
        same = bool(np.array_equal(np.load(by_dir)["logits"], np.load(by_hub)["logits"]))
        lm_out = {"phase": "tools_verify_lm", "d_model": lm_cfg.d_model,
                  "n_layer": lm_cfg.n_layer, "tokens": list(TOOLS_LM_TOKENS),
                  "dir_seconds": d_run["seconds"], "hub_seconds": h_run["seconds"],
                  "launches": d_run["launches"], "equal_by_dir_and_hub_id": same,
                  "ok": same and d_run["launches"].get("selective_scan_fwd") == lm_cfg.n_layer}
        emit(lm_out)
        out["verify_lm"] = lm_out

        # get_norm_stats and gen_weight_file on a small WAV set.
        entries = []
        for i in range(TOOLS_WAVS):
            n = 16000 * (1 + (9 * i) // (TOOLS_WAVS - 1))
            path = os.path.join(tmp, f"set{i}.wav")
            _write_wav16(path, 0.1 * torch.randn(n, generator=g))
            entries.append({"wav": path, "labels": f"/m/c{i % 5}" + (",/m/c7" if i % 3 else "")})
        manifest = os.path.join(tmp, "set.json")
        with open(manifest, "w") as f:
            json.dump({"data": entries}, f)
        data_args = ["--data", manifest, "--label-csv", labels_csv]
        stats = {}
        for where in ("cuda", "cpu"):
            run = _run_tool("get_norm_stats", data_args + ["--batch-size", "4"]
                            + (["--device", "cpu"] if where == "cpu" else []))
            stats[where] = (run["seconds"], [float(v) for v in re.findall(
                r"=(-?[0-9.]+)", run["stdout"])])
        weights = {}
        for where in ("cuda", "cpu"):
            csv = os.path.join(tmp, f"weights_{where}.csv")
            run = _run_tool("gen_weight_file", data_args + ["--out", csv]
                            + (["--device", "cpu"] if where == "cpu" else []))
            with open(csv) as f:
                weights[where] = (run["seconds"], f.read())
        diff = max(abs(a - b) for a, b in zip(stats["cuda"][1], stats["cpu"][1]))
        prep = {"phase": "tools_prep", "wavs": TOOLS_WAVS, "norm_stats_card": stats["cuda"][1],
                "norm_stats_cpu": stats["cpu"][1], "max_abs_diff": diff,
                "norm_stats_seconds": stats["cuda"][0], "weights_seconds": weights["cuda"][0],
                "weights_rows": len(weights["cuda"][1].splitlines()),
                "ok": len(stats["cuda"][1]) == 2
                and diff <= 1e-5 + 1e-5 * max(map(abs, stats["cpu"][1]))
                and weights["cuda"][1] == weights["cpu"][1]}
        emit(prep)
        out["prep"] = prep

    # The upstream code runs on the CPU (tests/test_torch_ref_parity.py and
    # --ref-parity run it there); this phase never reports it as passed.
    out["ref_parity"] = {
        "phase": "tools_ref_parity", "status": "skipped",
        "reason": (f"an upstream checkout is at {reference_root()}: its parity runs on the CPU"
                   if reference_available() else
                   f"no upstream Audio-Mamba-AuM checkout at {reference_root()}")}
    emit(out["ref_parity"])

    # The HTTP front under concurrent clients: an AuM-Base Fo-Bi bf16 bundle.
    from aum_tpu_torch.entry import flagship_config
    from aum_tpu_torch.models import AudioMamba

    model = AudioMamba(flagship_config(), device="cuda", seed=TOOLS_SEED)
    sm = load_bundle(export_bundle(model, audio_length=1024, melbins=128, batch_sizes=(1, 2, 4),
                                   mean=AUDIOSET_MEAN, std=AUDIOSET_STD), device="cuda")
    rows = {(c, i): torch.randn((1 + (c + i) % 2, 1024, 128), generator=g)
            for c in range(TOOLS_HTTP_CLIENTS) for i in range(TOOLS_HTTP_REQUESTS)}
    out["http_concurrent"] = _http_concurrent(sm, rows)

    failed = [k for k, v in out.items() if k != "ref_parity" and not v["ok"]]
    summary = {"phase": "tools", "failed": failed,
               "seconds_by_tool": {"infer": out["infer"]["seconds"],
                                   "verify_ckpt_record": out["verify_ckpt"]["record_seconds"],
                                   "verify_lm_dir": out["verify_lm"]["dir_seconds"],
                                   "get_norm_stats": out["prep"]["norm_stats_seconds"],
                                   "gen_weight_file": out["prep"]["weights_seconds"],
                                   "export_torch_ckpt": out["export_torch_ckpt"]["seconds"]}}
    emit(summary)
    if failed:
        raise RuntimeError(f"tools: {failed}")
    return out


# --- the parallel modes ------------------------------------------------------------

# Ranks of the parallel phase: every rank a process on the one card, over
# gloo (NCCL refuses two ranks on one card); the NCCL leg is one rank.
PARALLEL_WORLD = 4
PARALLEL_SERVE_WORLD = 2
PARALLEL_FP32_LAYOUTS = {"dp_tp": {"n_data": 2, "n_model": 2},
                         "dp_sp": {"n_data": 2, "n_seq": 2},
                         "dp_pp": {"n_data": 2, "n_pipe": 2, "pipe_microbatches": 2}}
PARALLEL_BF16_LAYOUTS = {"dp_tp": {"n_data": 2, "n_model": 2},
                         "dp_sp": {"n_data": 2, "n_seq": 2},
                         "pp4": {"n_pipe": 4, "pipe_microbatches": 4}}
PARALLEL_FP32_BATCH = 4
PARALLEL_DROP_RATE = 0.1  # the pipe layout's fp32 check runs with drop path
PARALLEL_LOGITS_DEPTH = 24  # the TP=2 fp32 forward
PARALLEL_RUN_SPLITS = {"train": 24, "val": 24}  # 2 steps at B=12 (n_data 1), one val batch
PARALLEL_SERVE_BATCH = 8


def _expected_parallel_launches(layout: dict, depth: int, m: int = 1) -> dict:
    """One bf16 train step's launches on one rank (Fo-Bi, split remat): the
    dual scan and K2 on both directions per layer, the conv four times, or
    under 'seq' two single-direction scans with carried state per
    direction, both differentiated by K2's with_state form; a pipe stage
    runs its depth/P layers once per microbatch."""
    layers = depth // layout.get("n_pipe", 1) * m
    if layout.get("n_seq", 1) > 1:
        scans = 4 * layers
        return _launches(selective_scan_fwd=scans, selective_scan_fwd_save_states=scans,
                         selective_scan_fwd_with_state=scans, selective_scan_bwd=scans,
                         selective_scan_bwd_with_state=scans, causal_conv1d_fwd=4 * layers)
    return _launches(selective_scan_dual_fwd=layers, selective_scan_dual_fwd_save_states=layers,
                     selective_scan_bwd=layers, causal_conv1d_fwd=4 * layers)


def _parallel_config(aum_type: str = "Fo-Bi", **overrides) -> dict:
    import dataclasses

    from aum_tpu_torch.entry import flagship_config

    return dataclasses.asdict(flagship_config(aum_type, **overrides))


def _fp32_references(x, y, hp: dict) -> dict:
    """Each fp32 leg (``_fp32_legs``) in this process on the card: the
    one-process run that the parallel run is held to, and the initial
    parameters of the stepped ones."""
    from aum_tpu_torch.models import AudioMamba, AudioMambaConfig
    from aum_tpu_torch.parallel.checks import train_leg

    refs = {}
    for name, (cfg_kw, _) in _fp32_legs().items():
        if name == "tp_logits_d24":
            refs[name] = train_leg({}, cfg_kw, 0, x, y, hp, steps=0, device="cuda", grads=False)
            continue
        refs[name] = train_leg({}, cfg_kw, 0, x, y, hp, steps=1, device="cuda", logits=False)
        refs[name]["before"] = {k: v.detach().float() for k, v in AudioMamba(
            AudioMambaConfig(**cfg_kw), device="cpu", seed=0).state_dict().items()}
    return refs


def _fp32_parallel_checks(par: dict, refs: dict) -> dict:
    """Each fp32 layout's step (4 ranks) against the same step in one
    process on the card: the loss within TRAIN_FP32_TOL's 1e-4 relative,
    every parameter's grad (the mixers' and the replicated leaves': patch
    and position embeddings, cls token, final norm, head) within 1e-3 of
    its max-abs, every parameter's update within 1e-2 of the one-process
    update; the TP=2 depth-24 logits within 2e-3 + 2e-3·|ref|."""
    import numpy as np

    out = {}
    for name, (cfg_kw, _) in _fp32_legs().items():
        ref, got = refs[name], par[name]
        if name == "tp_logits_d24":
            want = torch.from_numpy(ref["logits"])
            err = (torch.from_numpy(got["logits"]) - want).abs()
            out[name] = {"max_abs_err": err.max().item(), "max_ref": want.abs().max().item(),
                         "ok": bool((err <= 2e-3 + 2e-3 * want.abs()).all())}
            continue
        keys = sorted(ref["grads"])
        if set(got["grads"]) != set(keys) or set(got["params"]) != set(keys):
            raise RuntimeError(f"{name}: the gathered parameters differ from one process's")
        grads = {k: compare_scaled(torch.from_numpy(got["grads"][k]),
                                   torch.from_numpy(ref["grads"][k]), TRAIN_FP32_TOL["grad"])
                 for k in keys}
        updates = {}
        for k in keys:
            a, r = torch.from_numpy(got["params"][k]), torch.from_numpy(ref["params"][k])
            err, moved = (a - r).norm().item(), (r - ref["before"][k]).norm().item()
            updates[k] = {"err_norm": err, "update_norm": moved,
                          "ok": moved > 0 and err <= TRAIN_FP32_TOL["update"] * moved}
        loss_ok = abs(got["losses"][0] - ref["losses"][0]) <= TRAIN_FP32_TOL["loss_rtol"] * abs(
            ref["losses"][0])
        ok = (loss_ok and np.isfinite(got["losses"][0]) and all(g["ok"] for g in grads.values())
              and all(u["ok"] for u in updates.values()))
        worst_grad = max(keys, key=lambda k: grads[k]["scaled_err"])
        worst_update = max(keys, key=lambda k: updates[k]["err_norm"]
                           / max(updates[k]["update_norm"], 1e-30))
        out[name] = {"loss": got["losses"][0], "loss_one_process": ref["losses"][0],
                     "params_compared": len(keys),
                     "worst_grad": grads[worst_grad]["scaled_err"], "worst_grad_param": worst_grad,
                     "worst_update": updates[worst_update]["err_norm"]
                     / max(updates[worst_update]["update_norm"], 1e-30),
                     "worst_update_param": worst_update,
                     "failed": sorted(k for k in keys
                                      if not (grads[k]["ok"] and updates[k]["ok"])),
                     "ok": ok}
    return out


def _fp32_legs() -> dict:
    """name -> (config, layout) of the fp32 exactness legs: depth 2 Fo-Bi
    under each layout (the pipe one with drop path), Bi-Bi under TP and
    SP, and the TP=2 forward at depth 24."""
    d2 = dict(dtype="float32", depth=2, remat=True, remat_mode="split")
    legs = {f"{name}_fobi": (_parallel_config(**d2, **(
        {"drop_path_rate": PARALLEL_DROP_RATE} if "n_pipe" in layout else {})), layout)
        for name, layout in PARALLEL_FP32_LAYOUTS.items()}
    for name in ("dp_tp", "dp_sp"):
        legs[f"{name}_bibi"] = (_parallel_config("Bi-Bi", **d2), PARALLEL_FP32_LAYOUTS[name])
    legs["tp_logits_d24"] = (_parallel_config(dtype="float32", depth=PARALLEL_LOGITS_DEPTH),
                             PARALLEL_FP32_LAYOUTS["dp_tp"])
    return legs


def phase_parallel() -> dict:
    """The parallel modes on the one card, every rank a process over gloo:
    one spawn of 4 ranks runs (1) the fp32 exactness legs (``_fp32_legs``)
    against this process; (2) one bf16 step each of AuM-Base Fo-Bi at full
    width and depth (global B = 12, split remat) under data 2 x model 2,
    data 2 x seq 2 and pipe 4, with each rank's launches (held to
    ``_expected_parallel_launches``: under 'seq' no dual forward, the
    single forward and K2 in their with_state forms), peak memory, the
    bytes of each collective and the step's seconds (ranks time-sliced on
    one card: not a scaling number); (3) ``run.main`` on as20k from WAV
    files under --n-model 2 --n-seq 2, 2 steps and a val batch, whose
    checkpoint restores into one process bit-equal to the gathered
    parameters (checked on rank 0). Then 2 ranks serve a DP=2 and a TP=2
    bundle (``predict`` at B=8 against the one-card bundle, ``SERVE_TOL``)
    while a one-rank NCCL group runs the data x model step code; last,
    ``entry.dryrun_multichip(4)`` at its defaults, on the card."""
    import io
    import tempfile

    import numpy as np

    from aum_tpu_torch.entry import dryrun_multichip
    from aum_tpu_torch.models import AudioMamba, AudioMambaConfig
    from aum_tpu_torch.parallel.checks import train_leg
    from aum_tpu_torch.parallel.launch import start
    from aum_tpu_torch.serving import export_bundle, load_bundle

    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(13)
    x32 = torch.randn((PARALLEL_FP32_BATCH, 1024, 128), generator=g).numpy()
    y32 = torch.nn.functional.one_hot(torch.arange(PARALLEL_FP32_BATCH) % 527, 527).float().numpy()
    from aum_tpu_torch.entry import TRAIN_BATCH, TRAIN_HP

    hp = {"lr": TRAIN_HP.lr, "weight_decay": TRAIN_HP.weight_decay, "warmup": False}
    xb = torch.randn((TRAIN_BATCH, 1024, 128), generator=g).numpy()
    yb = torch.nn.functional.one_hot(torch.arange(TRAIN_BATCH) % 527, 527).float().numpy()
    legs = []
    for name, (cfg_kw, layout) in _fp32_legs().items():
        logits_only = name == "tp_logits_d24"
        legs.append((name, "train_leg", dict(layout=layout, config=cfg_kw, seed=0, x=x32, y=y32,
                                             hp=hp, steps=0 if logits_only else 1,
                                             logits=logits_only, grads=not logits_only,
                                             device="cuda")))
    bf16 = _parallel_config(remat=True, remat_mode="split")
    for name, layout in PARALLEL_BF16_LAYOUTS.items():
        legs.append((f"bf16_{name}", "train_leg", dict(layout=layout, config=bf16, seed=0, x=xb,
                                                       y=yb, hp=hp, steps=1, logits=False,
                                                       grads=False, params=False, timed_steps=1,
                                                       device="cuda")))
    with tempfile.TemporaryDirectory() as tmp:
        files = _write_recipe_data(tmp, "as20k/aum-base_scratch", 527, seed=7,
                                   splits=PARALLEL_RUN_SPLITS)
        exp_dir = os.path.join(tmp, "exp")
        argv = ["--recipe", "as20k/aum-base_scratch", "--exp-dir", exp_dir, "--set",
                "n_epochs=1", "--data-train", files["train"], "--data-val", files["val"],
                "--label-csv", files["csv"], "--n-model", "2", "--n-seq", "2",
                "--dist-backend", "gloo", "--num-workers", "2"]
        legs.append(("runner", "run_leg", dict(
            argv=argv, checkpoint=os.path.join(exp_dir, "models", "epoch_1"))))
        ranks = start("aum_tpu_torch.parallel.checks:suite_leg", PARALLEL_WORLD, {"legs": legs},
                      backend="gloo", device="cuda:0", timeout=900)
        # The one-process references run while the ranks start and run.
        refs = _fp32_references(x32, y32, hp)
        cfg_kw, _ = _fp32_legs()["dp_tp_fobi"]
        nccl_ref = train_leg({}, cfg_kw, 0, x32, y32, hp, steps=1, device="cuda", logits=False)
        par = ranks.join()[0]
        seconds = {"suite": time.perf_counter() - t0, "legs": par.pop("leg_seconds")}
        runner = par.pop("runner")
        runner_equal = runner["checkpoint_equal"]
    fp32 = _fp32_parallel_checks(par, refs)
    emit({"phase": "parallel_fp32", "world": PARALLEL_WORLD, "backend": "gloo",
          "batch": PARALLEL_FP32_BATCH, "checks": fp32})
    bf16_out = {}
    for name, layout in PARALLEL_BF16_LAYOUTS.items():
        got = par[f"bf16_{name}"]
        launches = got["step_counts"][0]["launches"]
        m = layout.get("pipe_microbatches", 4) if layout.get("n_pipe", 1) > 1 else 1
        expected = _expected_parallel_launches(layout, bf16["depth"], m)
        bf16_out[name] = {"layout": layout, "losses": got["losses"],
                          "launches_per_rank": launches,
                          "expected": {k: v for k, v in expected.items() if v},
                          "launches_ok": launches == expected,
                          "bytes_per_step": got["step_counts"][0]["bytes"],
                          "peak_mem_bytes": got.get("peak_bytes"),
                          "step_seconds_time_sliced": got["step_seconds"][0]}
    emit({"phase": "parallel_bf16", "world": PARALLEL_WORLD, "global_batch": TRAIN_BATCH,
          "note": "4 ranks time-sliced on one card over gloo: not a scaling number",
          "steps": bf16_out})
    emit({"phase": "parallel_runner", "argv": argv[4:], "history": runner["result"],
          "launches_per_run": runner["counts"]["launches"], "bytes": runner["counts"]["bytes"],
          "seconds": runner["seconds"], "saves_per_rank": runner["saves_per_rank"],
          "checkpoint_keys": runner["checkpoint_keys"],
          "checkpoint_restore_bit_equal": runner_equal})

    # Serving on 2 ranks (a DP=2 and a TP=2 bundle against the one-card one)
    # and a one-rank NCCL group running the data x model step code (the
    # fp32 Fo-Bi depth-2 leg), side by side.
    t1 = time.perf_counter()
    cfg_serve = _parallel_config()
    xs = torch.randn((PARALLEL_SERVE_BATCH, 1024, 128), generator=g).numpy()
    serve_ranks = start("aum_tpu_torch.parallel.checks:serve_leg", PARALLEL_SERVE_WORLD,
                        dict(config=cfg_serve, seed=0, x=xs, batch_sizes=(PARALLEL_SERVE_BATCH,),
                             device="cuda:0"), backend="gloo", device="cuda:0", timeout=600)
    nccl_rank = start("aum_tpu_torch.parallel.checks:train_leg", 1,
                      dict(layout={"n_data": 1, "n_model": 1}, config=cfg_kw, seed=0, x=x32,
                           y=y32, hp=hp, steps=1, logits=False, device="cuda:0"),
                      backend="nccl", device="cuda:0", timeout=600)
    one = AudioMamba(AudioMambaConfig(**cfg_serve), device="cuda", seed=0)
    want = load_bundle(export_bundle(one, audio_length=1024, melbins=128,
                                     batch_sizes=(PARALLEL_SERVE_BATCH,)), "cuda").predict(xs)
    want = want.float().cpu()
    del one
    served = serve_ranks.join()[0]
    serve = []
    for s in served:
        err = (torch.from_numpy(s["logits"]) - want).abs().max().item()
        scale = want.abs().max().item()
        serve.append({**s["manifest"], "max_abs_err": err, "max_ref": scale,
                      "tol": SERVE_TOL["bfloat16"], "launches": s["counts"]["launches"],
                      "bytes": s["counts"]["bytes"],
                      "ok": err <= SERVE_TOL["bfloat16"] * scale})
    emit({"phase": "parallel_serving", "batch": PARALLEL_SERVE_BATCH, "bundles": serve})

    nccl = nccl_rank.join()[0]
    seconds["serving_and_nccl"] = time.perf_counter() - t1
    nccl_ok = (abs(nccl["losses"][0] - nccl_ref["losses"][0])
               <= TRAIN_FP32_TOL["loss_rtol"] * abs(nccl_ref["losses"][0])
               and nccl["grad_counts"]["bytes"].get("tp_x_dbl", 0) > 0
               and nccl["grad_counts"]["bytes"].get("dp_grads", 0) > 0)
    emit({"phase": "parallel_nccl", "world": 1, "loss": nccl["losses"][0],
          "loss_one_process": nccl_ref["losses"][0], "bytes": nccl["grad_counts"]["bytes"],
          "ok": nccl_ok})

    # The dry-run entry point at its defaults: 4 ranks sharing the card.
    t2 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        dry = dryrun_multichip(PARALLEL_WORLD)
    seconds["dryrun"] = time.perf_counter() - t2
    dry_ok = (dry["device"].startswith("cuda") and np.isfinite(dry["loss"])
              and dry["launches"]["selective_scan_fwd_with_state"] > 0
              and dry["launches"]["causal_conv1d_fwd"] > 0)
    emit({"phase": "parallel_dryrun", "summary": printed.getvalue().strip(),
          "device": dry["device"], "launches": {k: v for k, v in dry["launches"].items() if v},
          "seconds": seconds["dryrun"], "ok": dry_ok})
    seconds["phase"] = time.perf_counter() - t0
    ok = (all(c["ok"] for c in fp32.values())
          and all(b["launches_ok"] and all(np.isfinite(b["losses"])) for b in bf16_out.values())
          and runner_equal and all(np.isfinite(h["train_loss"]) for h in runner["result"])
          and all(s["ok"] for s in serve) and nccl_ok and dry_ok)
    emit({"phase": "parallel", "seconds": seconds["phase"], "by_part": seconds, "ok": ok})
    if not ok:
        raise RuntimeError("parallel phase: a layout disagrees with one process, launched other "
                           "kernels than expected, or a leg failed (see the lines above)")
    return {"bf16": bf16_out, "runner": runner["counts"]["launches"]}


def phase_bench(device_info: dict) -> dict:
    from aum_tpu_torch.entry import flagship_config
    from aum_tpu_torch.models import AudioMamba
    from aum_tpu_torch.ops.conv1d import causal_conv1d_cuda, causal_conv1d_plain
    from aum_tpu_torch.ops.selective_scan import (
        _prep_dt,
        selective_scan_dual_cuda,
        selective_scan_dual_fdt_cuda,
        selective_scan_dual_fdt_plain,
        selective_scan_dual_plain,
    )

    (_, seqlen, d), n, k = EVAL_DIMS, 16, 4
    bsz = BENCH_BATCH
    dtype = torch.bfloat16
    es = 2
    model = AudioMamba(flagship_config(), device="cuda", seed=0)
    x = torch.randn((bsz, 1024, 128), generator=torch.Generator().manual_seed(1)).cuda()

    def forward():
        with torch.inference_mode():
            return model(x)

    # The default path, the direct dual forward (AUM_SCAN_DIRECT=1) and the
    # fuse_dt form (AUM_SCAN_FUSE_DT=1), in turns: default, direct, fuse_dt,
    # fuse_dt, direct, default.
    runs = {name: {"ms_per_forward": [], "card": []} for name in ("default", "direct", "fuse_dt")}
    for name in ("default", "direct", "fuse_dt", "fuse_dt", "direct", "default"):
        with scan_switches(AUM_SCAN_DIRECT=name == "direct", AUM_SCAN_FUSE_DT=name == "fuse_dt"):
            torch.cuda.reset_peak_memory_stats()
            with sample_clocks({}) as card:
                runs[name]["ms_per_forward"].append(cuda_ms(forward, iters=10, warmup=2))
            runs[name]["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        runs[name]["card"].append(card)
    del model
    for run in runs.values():
        run["clips_per_s"] = [bsz / (ms / 1e3) for ms in run["ms_per_forward"]]
    fwd_ms = runs["default"]["ms_per_forward"][0]
    emit({"phase": "bench", "batch": bsz, "dtype": "bfloat16", "ms_per_forward": fwd_ms,
          "clips_per_s": bsz / (fwd_ms / 1e3), "peak_mem_bytes": runs["default"]["peak_mem_bytes"],
          "card": runs["default"]["card"][0], "in_turns": runs})
    wav = bench_wav()

    # Scan at the forward's shapes: v1, both directions on shared operands.
    u, delta, A, B, C, D, z, bias = scan_inputs(bsz, seqlen, d, n, dtype, seed=4)
    dt = _prep_dt(delta, bias)
    fwd = (u, dt, A, B, C, D, z)
    rev = (u, dt, A * 0.5, B, C, D, z)
    # Enough launches that the clock sampler sees the kernel alone (~0.6 s).
    with sample_clocks({}) as card:
        scan_ms = cuda_ms(lambda: selective_scan_dual_cuda(fwd, rev), iters=400)
    with scan_switches(AUM_SCAN_DIRECT=True), sample_clocks({}) as card_direct:
        direct_ms = cuda_ms(lambda: selective_scan_dual_cuda(fwd, rev), iters=400)
    with scan_switches(AUM_SCAN_BF16_STAGE=True), sample_clocks({}) as card_stage:
        stage_ms = cuda_ms(lambda: selective_scan_dual_cuda(fwd, rev), iters=400)
    scan_again_ms = cuda_ms(lambda: selective_scan_dual_cuda(fwd, rev), iters=400)
    scan_plain_ms = cuda_ms(lambda: selective_scan_dual_plain(fwd, rev), iters=2, warmup=1)
    stage_plain_ms = cuda_ms(lambda: selective_scan_dual_plain(fwd, rev, bf16_stage=True),
                             iters=2, warmup=1)
    elems = 2 * bsz * seqlen * d * n  # (b, l, d, n) per direction
    scan_bytes = (3 * bsz * seqlen * d + 2 * bsz * seqlen * n) * es \
        + 2 * bsz * seqlen * d * es + 2 * d * n * 4 + d * 4
    sfu_rate = device_info["sms"] * SFU_PER_SM_PER_CLOCK * max_sm_clock_hz()
    scan_fp32_ops = SCAN_FP32_OPS_PER_ELEMENT * elems
    # bound_ms takes "operations": the exponentials with a share moved to the
    # FP32 pipe; "sfu_only" (every exp2 on the SFUs) is shown beside it.
    scan_bounds = {"bytes": scan_bytes / HBM_BYTES_PER_S * 1e3,
                   "operations": exp_floor_s(elems, scan_fp32_ops, sfu_rate) * 1e3}
    scan_other = {"sfu_only": elems / sfu_rate * 1e3,
                  "fp32_pipe_only": scan_fp32_ops / FP32_PIPE_OPS_PER_S * 1e3}
    del u, delta, dt, z, B, C, fwd, rev

    # The fuse_dt form at the same shapes (v1: one dtr and W for both
    # directions), the product formed in the kernel.
    fold = fold_inputs(bsz, seqlen, d, n, dtype, seed=4)
    fold_r = fold[:3] + (fold[3] * 0.5,) + fold[4:]
    with sample_clocks({}) as card_fdt:
        fdt_ms = cuda_ms(lambda: selective_scan_dual_fdt_cuda(fold, fold_r), iters=400)
    fdt_plain_ms = cuda_ms(lambda: selective_scan_dual_fdt_plain(fold, fold_r), iters=2,
                           warmup=1)
    rank = fold[1].shape[-1]
    # Its bound: the dual forward's exponentials and FP32 work, plus the
    # (B*L, R) @ (R, D) product (once: v1 shares it) on the tensor cores,
    # against bytes with dtr (B, L, R), W and the bias in dt's place.
    fdt_bytes = scan_bytes - bsz * seqlen * d * es + bsz * seqlen * rank * es \
        + rank * d * es + d * 4
    product_s = 2 * bsz * seqlen * rank * d / BF16_TENSOR_FLOPS_PER_S
    fdt_bounds = {"bytes": fdt_bytes / HBM_BYTES_PER_S * 1e3,
                  "operations": (exp_floor_s(elems, scan_fp32_ops, sfu_rate) + product_s) * 1e3}
    del fold, fold_r

    xc, w, b = conv_inputs(bsz, seqlen, d, k, dtype, seed=5)
    with sample_clocks({}) as card_conv:
        conv_ms = cuda_ms(lambda: causal_conv1d_cuda(xc, w, b, "silu", False), iters=3000)
    conv_plain_ms = cuda_ms(lambda: causal_conv1d_plain(xc, w, b, "silu", False), iters=10)
    w3 = w[:, None, :]
    conv_lib_ms = cuda_ms(lambda: torch.nn.functional.silu(torch.nn.functional.conv1d(
        xc.transpose(1, 2), w3, b, padding=k - 1, groups=d)[..., :seqlen]), iters=50)
    conv_bounds = _conv_bounds(bsz, seqlen, d, k, es)
    # The direct kernel computes the staged one's function: the same plain
    # version and bounds; the staged kernel timed again after it.
    out = {"scan": {"ms": scan_ms, "plain_ms": scan_plain_ms, "bounds_ms": scan_bounds,
                    "other_floors_ms": scan_other, "ms_after_direct": scan_again_ms},
           "scan_direct": {"ms": direct_ms, "plain_ms": scan_plain_ms, "bounds_ms": scan_bounds},
           "scan_stage": {"ms": stage_ms, "plain_ms": stage_plain_ms, "bounds_ms": scan_bounds},
           "scan_fdt": {"ms": fdt_ms, "plain_ms": fdt_plain_ms, "bounds_ms": fdt_bounds,
                        "rank": rank},
           "conv": {"ms": conv_ms, "plain_ms": conv_plain_ms, "library_ms": conv_lib_ms,
                    "bounds_ms": conv_bounds}}
    emit({"phase": "bench_kernels", "dims": [bsz, seqlen, d, n], "dtype": "bfloat16", **out,
          "card": {"scan": card, "scan_direct": card_direct, "scan_stage": card_stage,
                   "scan_fdt": card_fdt, "conv": card_conv}})
    del xc, w, b
    single = bench_single_kernels(sfu_rate)
    train = bench_train_kernels(sfu_rate)
    return {**out, **single, **train, "wav": wav}


def bench_wav() -> dict:
    """``wav_entry``'s model (AuM-Base Fo-Fo, bf16) at B=64 from waveforms:
    clips/s, and the frontend alone."""
    from aum_tpu_torch.entry import (
        CLIP_SAMPLES,
        flagship_config,
        wav_forward_fn,
        wav_frontend_fn,
    )
    from aum_tpu_torch.models import AudioMamba

    bsz = BENCH_BATCH
    model = AudioMamba(flagship_config("Fo-Fo"), device="cuda", seed=0)
    fn = wav_forward_fn(model)
    wav = (0.1 * torch.randn((bsz, CLIP_SAMPLES), generator=torch.Generator().manual_seed(1))
           ).cuda()
    frontend = wav_frontend_fn(model.config)
    torch.cuda.reset_peak_memory_stats()

    def forward():
        with torch.inference_mode():
            return fn(wav)

    with sample_clocks({}) as card:
        fwd_ms = cuda_ms(forward, iters=10, warmup=2)
    peak = torch.cuda.max_memory_allocated()
    frontend_ms = cuda_ms(lambda: frontend(wav), iters=10)
    del model, fn
    out = {"phase": "bench_wav", "batch": bsz, "samples": CLIP_SAMPLES, "dtype": "bfloat16",
           "bimamba": "none", "ms_per_forward": fwd_ms, "clips_per_s": bsz / (fwd_ms / 1e3),
           "frontend_ms": frontend_ms, "peak_mem_bytes": peak, "card": card}
    emit(out)
    return out


def _single_bounds(bsz, seqlen, d, n, es, sfu_rate, extra_bytes=0) -> dict:
    """One direction's scan forward: u, dt, z, B, C, A, D read once, out
    written once (plus ``extra_bytes`` of states); one exp2 and
    SCAN_FP32_OPS_PER_ELEMENT FP32-pipe instructions per (b, l, d, n)."""
    elems = bsz * seqlen * d * n
    nbytes = (4 * bsz * seqlen * d + 2 * bsz * seqlen * n) * es + (n + 1) * d * 4 + extra_bytes
    return {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
            "operations": exp_floor_s(elems, SCAN_FP32_OPS_PER_ELEMENT * elems, sfu_rate) * 1e3}


def bench_single_kernels(sfu_rate: float) -> dict:
    """The single-direction scan forward (bf16): at the Fo-Fo bench forward's
    shapes (B=64) as is, in its with_state form at the LM prefill's (B=8,
    L=512), and its saving form at the train shapes (B=12)."""
    from aum_tpu_torch.ops.selective_scan import (
        STATE_CHUNK,
        _prep_dt,
        selective_scan_cuda,
        selective_scan_plain,
    )

    (_, eval_len, d), n, es = EVAL_DIMS, 16, 2
    dtype = torch.bfloat16
    out, cards = {}, {}
    for bsz, seqlen, form in ((BENCH_BATCH, eval_len, "eval"),
                              (LM_PREFILL_DIMS[0], LM_PREFILL_DIMS[1], "with_state"),
                              (TRAIN_DIMS[0], eval_len, "save_states")):
        u, delta, A, B, C, D, z, bias = scan_inputs(bsz, seqlen, d, n, dtype, seed=13)
        args = (u, _prep_dt(delta, bias), A, B, C, D, z)
        kw, extra = {}, 0
        if form == "with_state":
            kw = {"initial_state": torch.zeros((bsz, d, n), device="cuda"),
                  "return_final_state": True}
            extra = 2 * bsz * n * d * 4
        elif form == "save_states":
            kw = {"save_states": True}
            extra = bsz * math.ceil(seqlen / STATE_CHUNK) * n * d * 4
        # Enough launches (about a second) that the clock sampler, which
        # takes a few hundred ms to start, sees the kernel alone.
        with sample_clocks({}) as cards[form]:
            ms = cuda_ms(lambda: selective_scan_cuda(args, False, **kw),
                         iters=1500 * BENCH_BATCH // bsz if form == "with_state" else 1500)
        plain_ms = cuda_ms(lambda: selective_scan_plain(args, False, **kw), iters=2, warmup=1)
        out[f"scan_single_{form}"] = {
            "ms": ms, "plain_ms": plain_ms, "batch": bsz, "seqlen": seqlen,
            "bounds_ms": _single_bounds(bsz, seqlen, d, n, es, sfu_rate, extra),
            "other_floors_ms": {"sfu_only": bsz * seqlen * d * n / sfu_rate * 1e3}}
        del u, delta, z, B, C, args
    emit({"phase": "bench_single_kernels", "dims": [d, n], "dtype": "bfloat16", **out,
          "card": cards})
    return out


def _save_bounds(bsz, seqlen, d, n, es, sfu_rate) -> dict:
    """The saving dual forward (v1): u, dt, z, B, C read once (shared by the
    two directions), both outputs and both directions' chunk-entry states
    written once; per direction one exp2 and SCAN_FP32_OPS_PER_ELEMENT
    FP32-pipe instructions per (b, l, d, n)."""
    from aum_tpu_torch.ops.selective_scan import STATE_CHUNK

    bld, bln = bsz * seqlen * d, bsz * seqlen * n
    xb_bytes = bsz * math.ceil(seqlen / STATE_CHUNK) * n * d * 4  # one direction
    elems = bld * n
    nbytes = (3 * bld + 2 * bln) * es + 2 * bld * es + 2 * xb_bytes + 2 * d * n * 4 + d * 4
    return {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
            "operations": exp_floor_s(2 * elems, SCAN_FP32_OPS_PER_ELEMENT * 2 * elems,
                                      sfu_rate) * 1e3}


def _bwd_bounds(bsz, seqlen, d, n, es, sfu_rate, ndir: int) -> dict:
    """The scan backward of ``ndir`` directions: u, dt, z, B, C read once,
    and per direction its cotangent, states, A and D; per direction du,
    ddelta, dz, dB, dC and the fp32 dA, dD, dbias written once (the kernel's
    own fp32 partials, summed by its wrapper, are a choice of its design,
    not bytes the function needs); SCAN_BWD_FP32_OPS_PER_ELEMENT per (b, l,
    d, n) and direction."""
    from aum_tpu_torch.ops.selective_scan import STATE_CHUNK

    bld, bln = bsz * seqlen * d, bsz * seqlen * n
    xb_bytes = bsz * math.ceil(seqlen / STATE_CHUNK) * n * d * 4
    elems = bld * n
    nbytes = ((3 * bld + 2 * bln) * es + ndir * (bld * es + xb_bytes + (n + 1) * d * 4
              + (3 * bld + 2 * bln) * es + (n + 2) * d * 4))
    fp32 = SCAN_BWD_FP32_OPS_PER_ELEMENT * ndir * elems
    return {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
            "operations": exp_floor_s(ndir * elems, fp32, sfu_rate) * 1e3}


def _conv_bounds(bsz, seqlen, d, k, es) -> dict:
    """The conv forward: x read and out written once, the taps and bias;
    2k + 4 fp32 flops per output (the taps' FMAs, the bias, SiLU)."""
    return {"bytes": (2 * bsz * seqlen * d * es + d * (k + 1) * es) / HBM_BYTES_PER_S * 1e3,
            "fp32_flops": (2 * k + 4) * bsz * seqlen * d / FP32_FLOPS_PER_S * 1e3}


def bench_train_kernels(sfu_rate: float) -> dict:
    """The train path's scan kernels at its shapes (v1, B=12, bf16): the
    saving forward, staged and direct; the backward of both directions in one
    launch (the train path's form) and of the forward direction alone, the
    fused kernel and K2 in turns (fused, K2, K2, fused); and K2's with_state
    form on one direction."""
    from aum_tpu_torch.ops.selective_scan import (
        STATE_CHUNK,
        selective_scan_bwd_cuda,
        selective_scan_bwd_plain,
        selective_scan_cuda,
        selective_scan_dual_cuda,
        selective_scan_dual_plain,
    )

    (bsz, seqlen, d), n = TRAIN_DIMS, 16
    dtype, es = torch.bfloat16, 2
    dir_f, dir_r = _scan_dirs(bsz, seqlen, d, dtype, shared=True)
    with sample_clocks({}) as card_save:
        save_ms = cuda_ms(lambda: selective_scan_dual_cuda(dir_f, dir_r, save_states=True),
                          iters=400)
    with scan_switches(AUM_SCAN_DIRECT=True), sample_clocks({}) as card_save_direct:
        save_direct_ms = cuda_ms(
            lambda: selective_scan_dual_cuda(dir_f, dir_r, save_states=True), iters=400)
    with scan_switches(AUM_SCAN_BF16_STAGE=True), sample_clocks({}) as card_save_stage:
        save_stage_ms = cuda_ms(
            lambda: selective_scan_dual_cuda(dir_f, dir_r, save_states=True), iters=400)
    save_plain_ms = cuda_ms(lambda: selective_scan_dual_plain(dir_f, dir_r, save_states=True),
                            iters=1, warmup=1)
    save_stage_plain_ms = cuda_ms(lambda: selective_scan_dual_plain(
        dir_f, dir_r, save_states=True, bf16_stage=True), iters=1, warmup=1)
    _, _, xb_f, xb_r = selective_scan_dual_cuda(dir_f, dir_r, save_states=True)
    g = torch.Generator().manual_seed(9)
    gs = [torch.randn((bsz, seqlen, d), generator=g).to("cuda", dtype) for _ in range(2)]
    dirs = [dir_f + (False,), dir_r + (True,)]
    # The fused kernel and K2 in turns (fused, K2, K2, fused): both
    # directions in one launch, then the forward direction alone.
    turns = {name: {"two": [], "one": []} for name in ("fused", "k2")}
    cards = {}
    for name in ("fused", "k2", "k2", "fused"):
        with scan_switches(AUM_SCAN_BWD_FUSED=name == "fused"), sample_clocks({}) as card:
            turns[name]["two"].append(cuda_ms(
                lambda: selective_scan_bwd_cuda(dirs, gs, [xb_f, xb_r]), iters=100))
            turns[name]["one"].append(cuda_ms(
                lambda: selective_scan_bwd_cuda(dirs[:1], gs[:1], [xb_f]), iters=100))
        cards.setdefault(name, card)
    card_bwd, card_fused = cards["k2"], cards["fused"]
    bwd_ms, bwd1_ms = turns["k2"]["two"][0], turns["k2"]["one"][0]
    fused_ms, fused1_ms = turns["fused"]["two"][0], turns["fused"]["one"][0]
    bwd_plain_ms = cuda_ms(lambda: selective_scan_bwd_plain(dirs, gs), iters=1, warmup=1)
    bwd1_plain_ms = cuda_ms(lambda: selective_scan_bwd_plain(dirs[:1], gs[:1]),
                            iters=1, warmup=1)
    with scan_switches(AUM_SCAN_BWD_FUSED=True, AUM_SCAN_BWD_BF16_PARTIALS=True):
        fused_part_ms = cuda_ms(lambda: selective_scan_bwd_cuda(dirs, gs, [xb_f, xb_r]),
                                iters=100)
    # K2's opt-in forms in turns with the default: default, bf16 partials,
    # x-minus, x-minus, bf16 partials, default (the default's first turn is
    # bwd_ms above).
    forms = {"bf16_partials": {"AUM_SCAN_BWD_BF16_PARTIALS": True},
             "xminus": {"AUM_SCAN_BWD_XMINUS": True}, "default": {}}
    form_ms = {name: [] for name in forms}
    for name in ("bf16_partials", "xminus", "xminus", "bf16_partials", "default"):
        with scan_switches(**forms[name]):
            form_ms[name].append(cuda_ms(
                lambda: selective_scan_bwd_cuda(dirs, gs, [xb_f, xb_r]), iters=100))
    bwd_again_ms = form_ms["default"][0]
    # K2's with_state form: the saving forward from a random x0, then the
    # backward with a random cotangent of the final state.
    x0, gfin = (torch.randn((bsz, d, n), generator=g).cuda() for _ in range(2))
    _, xb_s, _ = selective_scan_cuda(dir_f, False, save_states=True, initial_state=x0,
                                     return_final_state=True)
    with sample_clocks({}) as card_state:
        state_ms = cuda_ms(lambda: selective_scan_bwd_cuda(dirs[:1], gs[:1], [xb_s],
                                                           gfins=[gfin]), iters=1000)
    state_plain_ms = cuda_ms(lambda: selective_scan_bwd_plain(dirs[:1], gs[:1],
                                                              states=[(x0, gfin)]),
                             iters=1, warmup=1)

    elems = bsz * seqlen * d * n  # (b, l, d, n) of one direction
    save_bounds = _save_bounds(bsz, seqlen, d, n, es, sfu_rate)

    def bwd_bounds(ndir: int) -> dict:
        return _bwd_bounds(bsz, seqlen, d, n, es, sfu_rate, ndir)

    # The direct and the fused kernels compute the functions of the staged
    # forward and K2: the same plain versions and bounds. The with_state
    # backward moves gfin in and dx0 out on top of K2's one direction.
    state_bounds = bwd_bounds(1)
    state_bounds["bytes"] += 2 * bsz * n * d * 4 / HBM_BYTES_PER_S * 1e3
    out = {"scan_save": {"ms": save_ms, "plain_ms": save_plain_ms, "bounds_ms": save_bounds},
           "scan_save_direct": {"ms": save_direct_ms, "plain_ms": save_plain_ms,
                                "bounds_ms": save_bounds},
           "scan_save_stage": {"ms": save_stage_ms, "plain_ms": save_stage_plain_ms,
                               "bounds_ms": save_bounds},
           "scan_bwd": {"ms": bwd_ms, "ms_turns": turns["k2"]["two"], "plain_ms": bwd_plain_ms,
                        "bounds_ms": bwd_bounds(2),
                        "other_floors_ms": {"sfu_only": 2 * elems / sfu_rate * 1e3,
                                            "fp32_pipe_only": SCAN_BWD_FP32_OPS_PER_ELEMENT
                                            * 2 * elems / FP32_PIPE_OPS_PER_S * 1e3},
                        "ms_after_fused": bwd_again_ms},
           "scan_bwd_one_direction": {"ms": bwd1_ms, "ms_turns": turns["k2"]["one"],
                                      "plain_ms": bwd1_plain_ms, "bounds_ms": bwd_bounds(1)},
           "scan_bwd_fused": {"ms": fused_ms, "ms_turns": turns["fused"]["two"],
                              "plain_ms": bwd_plain_ms, "bounds_ms": bwd_bounds(2)},
           "scan_bwd_fused_bf16_partials": {"ms": fused_part_ms, "plain_ms": bwd_plain_ms,
                                            "bounds_ms": bwd_bounds(2)},
           "scan_bwd_bf16_partials": {"ms": form_ms["bf16_partials"][0],
                                      "ms_turns": form_ms["bf16_partials"],
                                      "plain_ms": bwd_plain_ms, "bounds_ms": bwd_bounds(2)},
           "scan_bwd_xminus": {"ms": form_ms["xminus"][0], "ms_turns": form_ms["xminus"],
                               "plain_ms": bwd_plain_ms, "bounds_ms": bwd_bounds(2)},
           "scan_bwd_fused_one_direction": {"ms": fused1_ms, "ms_turns": turns["fused"]["one"],
                                            "plain_ms": bwd1_plain_ms,
                                            "bounds_ms": bwd_bounds(1)},
           "scan_bwd_with_state": {"ms": state_ms, "plain_ms": state_plain_ms,
                                   "bounds_ms": state_bounds}}
    emit({"phase": "bench_train_kernels", "dims": [bsz, seqlen, d, n], "dtype": "bfloat16",
          "bimamba": "v1", **out, "card": {"scan_save": card_save,
                                           "scan_save_direct": card_save_direct,
                                           "scan_save_stage": card_save_stage,
                                           "scan_bwd": card_bwd, "scan_bwd_fused": card_fused,
                                           "scan_bwd_with_state": card_state}})
    return out


# Exploratory builds of the fused backward, by the macros of its source:
# AUM_FUSED_PROBE times one piece of its work (outputs wrong by design);
# AUM_FUSED_HOLD (steps per slot) and AUM_FUSED_MIN_BLOCKS (the register
# cap's blocks per SM) are the design's two choices, each build a whole
# kernel.
FUSED_PROBES = {"walk_only": ["-DAUM_FUSED_PROBE=1"],
                "adjoint_only": ["-DAUM_FUSED_PROBE=2"],
                "global_streams": ["-DAUM_FUSED_PROBE=3"],
                **{f"hold{h}_blocks{m}": [f"-DAUM_FUSED_HOLD={h}", f"-DAUM_FUSED_MIN_BLOCKS={m}"]
                   for h, m in ((8, 4), (8, 6), (8, 8), (4, 4), (4, 5), (4, 7), (4, 8), (2, 5))}}


def probe_fused_bwd(trees: dict[str, str] | None = None,
                    probes: dict[str, list[str]] | None = None) -> dict:
    """The fused backward against its exploratory builds (``probes``, name
    to nvcc flags; FUSED_PROBES by default) at the train path's shapes
    (B=12, L=513, D=1536, N=16, bf16, v1; both directions in one launch and
    the forward direction alone), with K2 and the fused kernels of other
    trees (``trees``, name to a ``csrc`` directory) beside them: every
    variant in one order, then in the reverse order, and each variant's
    resources from its ``aum_kernel_info``. Not part of ``main``; after
    ``phase_device()`` and ``phase_build()``, run as
    ``probe_fused_bwd({"parent": "build/parent/aum_tpu_torch/csrc"})``."""
    import ctypes
    import importlib
    from pathlib import Path

    from aum_tpu_torch.ops import _build

    ss = importlib.import_module("aum_tpu_torch.ops.selective_scan")
    out_dir = _build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    builds = {name: (_build.CSRC_DIR, flags)
              for name, flags in (FUSED_PROBES if probes is None else probes).items()}
    builds.update({name: (Path(src), []) for name, src in (trees or {}).items()})
    start = time.perf_counter()
    procs = {}
    for name, (src_dir, flags) in builds.items():
        path = out_dir / f"{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(path),
               str(src_dir / "selective_scan_bwd_fused.cu")]
        procs[name] = (path, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
    paths = {}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        path.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} build:\n{log}")
        paths[name] = path
    build_s = time.perf_counter() - start

    real_library = _build.library
    libs, resources = {"fused": ss._bwd_fused_lib()}, {}
    try:
        for name, path in paths.items():
            lib = ctypes.CDLL(str(path))
            _build.library = lambda _name, lib=lib: lib
            libs[name] = ss._bwd_fused_lib.__wrapped__()  # the wrapper's load-time checks
        for name, lib in libs.items():
            _build.library = lambda _name, lib=lib: lib
            resources[name] = _build.kernel_resources("selective_scan_bwd_fused")[0]
    finally:
        _build.library = real_library

    (bsz, seqlen, d), n = TRAIN_DIMS, 16
    dir_f, dir_r = _scan_dirs(bsz, seqlen, d, torch.bfloat16, shared=True)
    _, _, xb_f, xb_r = ss.selective_scan_dual_cuda(dir_f, dir_r, save_states=True)
    g = torch.Generator().manual_seed(9)
    gs = [torch.randn((bsz, seqlen, d), generator=g).to("cuda", torch.bfloat16)
          for _ in range(2)]
    dirs = [dir_f + (False,), dir_r + (True,)]
    order = [*libs, "k2"]
    ms = {name: {"two": [], "one": []} for name in order}
    # Each whole build (no AUM_FUSED_PROBE) against K2 on the same inputs.
    with scan_switches(AUM_SCAN_BWD_FUSED=False):
        want = ss.selective_scan_bwd_cuda(dirs, gs, [xb_f, xb_r])
    agree = {}
    real_lib = ss._bwd_fused_lib
    try:
        for name in libs:
            if any("AUM_FUSED_PROBE" in f for f in builds.get(name, (None, []))[1]):
                continue
            ss._bwd_fused_lib = lambda lib=libs[name]: lib
            with scan_switches(AUM_SCAN_BWD_FUSED=True):
                got = ss.selective_scan_bwd_cuda(dirs, gs, [xb_f, xb_r])
            agree[name] = max(compare_scaled(a, b, GRAD_TOL[torch.bfloat16])["scaled_err"]
                              for gd, wd in zip(got, want) for a, b in zip(gd, wd))
        for name in order + order[::-1]:
            if name != "k2":
                ss._bwd_fused_lib = lambda lib=libs[name]: lib
            with scan_switches(AUM_SCAN_BWD_FUSED=name != "k2"):
                ms[name]["two"].append(cuda_ms(
                    lambda: ss.selective_scan_bwd_cuda(dirs, gs, [xb_f, xb_r]), iters=100))
                ms[name]["one"].append(cuda_ms(
                    lambda: ss.selective_scan_bwd_cuda(dirs[:1], gs[:1], [xb_f]), iters=100))
    finally:
        ss._bwd_fused_lib = real_lib
    out = {"dims": [bsz, seqlen, d, n], "dtype": "bfloat16", "bimamba": "v1",
           "order": order + order[::-1], "ms": ms, "resources": resources,
           "scaled_err_vs_k2": agree,
           "build_s": build_s, "card": smi("name,power.limit")}
    emit({"phase": "probe_fused_bwd", **out})
    return out


AB_ORDER = ("parent", "change", "change", "parent")


def ab_bench(trees: dict[str, str], order: tuple = AB_ORDER) -> dict:
    """Two trees in turns on one card: each tree's own ``chip_smoke.py`` in a
    process of its own (cwd and PYTHONPATH the tree, so each builds and
    loads its own kernels), ``phase_build`` (its occupancy line) and
    ``phase_bench`` (rows 1-7's kernels and the conv at K=4 at the bench
    shapes, B=64 Fo-Bi clips/s), in ``order`` over the names of ``trees``,
    e.g. ``ab_bench({"parent": "build/parent", "change": "."})`` with the
    parent unpacked from ``git archive`` into the git-ignored ``build/``.
    Emits each run's ms by kernel, the change/parent ratio of each kernel's
    mean ms, and the kernel instantiations whose registers, spills, shared
    memory or warps per SM differ between the trees."""
    script = ("import json, chip_smoke as c; i = c.phase_device(); c.phase_build(); "
              "b = c.phase_bench(i); print('AB_RESULT ' + json.dumps("
              "{k: v['ms'] for k, v in b.items() if isinstance(v, dict) and 'ms' in v}))")
    ms = {name: [] for name in trees}
    occupancy = {}
    for name in order:
        tree = os.path.abspath(trees[name])
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", script], cwd=tree, capture_output=True,
                              text=True, env={**os.environ, "PYTHONPATH": tree})
        if proc.returncode != 0:
            raise RuntimeError(f"ab_bench: {name} failed:\n{proc.stderr[-4000:]}")
        for line in proc.stdout.splitlines():
            if line.startswith("AB_RESULT "):
                ms[name].append(json.loads(line[len("AB_RESULT "):]))
            elif line.startswith('{"phase": "occupancy"'):
                occupancy[name] = {(lib, r["kernel"]): (r["registers"], r["local_bytes"],
                                                        r["shared_bytes"], r["warps_per_sm"])
                                   for lib, rows in json.loads(line)["kernels"].items()
                                   for r in rows}
        emit({"phase": "ab_run", "tree": name, "ms": ms[name][-1],
              "seconds": time.perf_counter() - t0})
    base, other = order[0], next(n for n in order if n != order[0])
    ratio = {k: (sum(r[k] for r in ms[other]) / len(ms[other]))
             / (sum(r[k] for r in ms[base]) / len(ms[base]))
             for k in ms[base][0] if k in ms[other][0]}
    common = occupancy[base].keys() & occupancy[other].keys()
    changed = {f"{lib} {kernel}": {base: occupancy[base][(lib, kernel)],
                                   other: occupancy[other][(lib, kernel)]}
               for lib, kernel in sorted(common)
               if occupancy[base][(lib, kernel)] != occupancy[other][(lib, kernel)]}
    out = {"phase": "ab", "order": list(order), "ms": ms, f"ratio_{other}_over_{base}": ratio,
           "instantiations_compared": len(common), "resources_changed": changed,
           f"only_in_{other}": sorted(f"{lib} {k}" for lib, k in
                                      occupancy[other].keys() - occupancy[base].keys())}
    emit(out)
    return out


def _kernel_category(name: str) -> str:
    low = name.lower()
    if "scan_bwd_kernel" in low:
        return "scan_bwd_kernel"
    if "scan_bwd_fused_kernel" in low:
        return "scan_bwd_fused_kernel"
    if "scan_dual_fwd_kernel" in low:
        return "scan_fwd_kernel"
    if "scan_dual_direct_fwd_kernel" in low:
        return "scan_direct_fwd_kernel"
    if "scan_dual_fdt_fwd_kernel" in low:
        return "scan_fdt_fwd_kernel"
    if "scan_dual_stage_fwd_kernel" in low:
        return "scan_stage_fwd_kernel"
    if "scan_single_fwd_kernel" in low:
        return "scan_single_fwd_kernel"
    if "conv1d_fwd_kernel" in low:
        return "conv_kernel"
    if any(s in low for s in ("gemm", "nvjet", "cutlass", "xmma")):
        return "matmul"
    if "fft" in low or "radix" in low:  # cuFFT's kernels: the frontend's rfft
        return "frontend_fft"
    return "other"


def _profile(label: str, fn, **info) -> dict:
    """``fn`` once under torch.profiler: device time by kernel category,
    device busy time against the wall time (the idle share)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_cat, by_name, spans = {}, {}, []
    for e in kernels:
        ms = e.time_range.elapsed_us() / 1e3
        cat = _kernel_category(e.name)
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
        total, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + ms, count + 1)
        spans.append((e.time_range.start, e.time_range.end))
    busy_us, last_end = 0.0, None
    for start, end in sorted(spans):
        if last_end is None or start >= last_end:
            busy_us += end - start
            last_end = end
        elif end > last_end:
            busy_us += end - last_end
            last_end = end
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    out = {"phase": label, **info, "wall_ms": wall_ms,
           "kernels_traced": len(kernels), "device_busy_ms": busy_us / 1e3,
           "idle_share": 1.0 - busy_us / 1e3 / wall_ms if kernels else None,
           "by_category_ms": by_cat,
           "top_kernels": [[name[:90], ms, n] for name, (ms, n) in top]}
    emit(out)
    return out


def phase_profile() -> dict:
    """One Fo-Bi bench forward (B=64), one Fo-Fo forward from waveforms
    (B=64), then one train step of the train path."""
    from aum_tpu_torch.entry import (
        CLIP_SAMPLES,
        TRAIN_BATCH,
        flagship_config,
        train_entry,
        wav_forward_fn,
    )
    from aum_tpu_torch.models import AudioMamba

    model = AudioMamba(flagship_config(), device="cuda", seed=0)
    x = torch.randn((BENCH_BATCH, *reversed(model.config.spectrogram_size)),
                    generator=torch.Generator().manual_seed(1)).cuda()

    def forward():
        with torch.inference_mode():
            model(x)

    forward()
    out = {"eval": _profile("profile", forward, batch=BENCH_BATCH, dtype="bfloat16")}
    with scan_switches(AUM_SCAN_FUSE_DT=True):
        forward()
        out["eval_fuse_dt"] = _profile("profile_fuse_dt", forward, batch=BENCH_BATCH,
                                       dtype="bfloat16", switches={"AUM_SCAN_FUSE_DT": 1})
    del model, x
    fn = wav_forward_fn(AudioMamba(flagship_config("Fo-Fo"), device="cuda", seed=0))
    wav = (0.1 * torch.randn((BENCH_BATCH, CLIP_SAMPLES),
                             generator=torch.Generator().manual_seed(1))).cuda()

    def wav_forward():
        with torch.inference_mode():
            fn(wav)

    wav_forward()
    out["wav"] = _profile("profile_wav", wav_forward, batch=BENCH_BATCH, dtype="bfloat16",
                          bimamba="none", samples=CLIP_SAMPLES)
    del fn, wav
    step, state, batch = train_entry()
    step(state, batch)
    out["train"] = _profile("profile_train_step", lambda: step(state, batch),
                            batch=TRAIN_BATCH, dtype="bfloat16", remat_mode="split")
    return out


# --- sizes: every shape the JAX package's ops take ------------------------------

# The scan kernels run any d_state as slices of 16 states (the sliced
# libraries) and a combine; the conv kernel any width (past 8 its general
# form); the fuse_dt form any dt rank (past 400 its windowed form). The sizes
# phase holds each new form to its plain version, drives AuM-Base and the
# Mamba LM with a wide state and the LM with a wide conv, and times the new
# forms.
SIZES_STATES = (17, 24, 32, 64, 128)
SIZES_RAGGED = (2, 37, 40)
# A length past grid.y's 65535 blocks: the combine puts L on grid.x.
SIZES_LONG = (1, 70000, 40)
SIZES_WIDE_N = 64
SIZES_EVAL_DIMS = (BENCH_BATCH, 513, 1536)  # AuM-Base's eval batch
SIZES_CONV_WIDTHS = (1, 2, 3, 5, 8, 9, 12, 16, 33)
# The general form at a width past L, at the unaligned shape (L = 37).
SIZES_CONV_PAST_L = 40
# The conv at AuM-Base's widths and length (B=8: each check draws its
# inputs on the host, and B=64 took most of the phase's time; the kernels
# are timed at B=64 below), and at an unaligned D on a slice at an odd
# channel offset (value by value).
SIZES_CONV_DIMS = {"sizes_aligned": ((8, 513, 1536), 0), "sizes_unaligned": ((2, 37, 36), 1)}
SIZES_RANKS = (65, 80, 128, 256, 416, 512)
# Past 400 (the windowed fuse_dt form) each rank is also checked and timed at
# the width it implies (d_inner = 32 x rank: dt rank ceil(d_model / 16)),
# B=8; 401 (a partial k-step in the last window) and 417 (dtr rows not
# 16-byte aligned: staged value by value) at the ragged shape.
SIZES_WIDE_RANKS = {416: (8, 513, 13312), 512: (8, 513, 16384)}
SIZES_RAGGED_RANKS = (401, 417)
# The combine's backward with D not a multiple of its 4-channel vectors.
SIZES_COMBINE_ODD = (2, 45, 38)
# mamba-130m's widths with a wide state and a conv of width 3.
SIZES_LM = dict(d_model=768, n_layer=24, vocab_size=50280, dtype="bfloat16", d_state=64,
                d_conv=3)
# The same widths with d_state 16 and a conv of width 12: the general form.
SIZES_LM_CONV = dict(SIZES_LM, d_state=16, d_conv=12)
SIZES_DECODE_STEPS = 16


def _check_no_gate(label, dims, dtype, n) -> list[dict]:
    """The scan without z and/or D (the ungated kernels and the combine,
    without its gate or skip term): the single-direction forward (as is, and
    with_state), the dual forward, and the autograd op's backward (K2 and the
    fused kernel, one and both directions), against their plain versions."""
    from aum_tpu_torch.ops.selective_scan import (
        _prep_dt,
        selective_scan,
        selective_scan_bwd_plain,
        selective_scan_cuda,
        selective_scan_dual,
        selective_scan_dual_cuda,
        selective_scan_dual_plain,
        selective_scan_plain,
    )

    bsz, seqlen, d = dims
    raw = scan_inputs(bsz, seqlen, d, n, dtype, seed=31)
    atol, rtol = SCAN_TOL[dtype]
    g = torch.Generator().manual_seed(32)
    gouts = [torch.randn((bsz, seqlen, d), generator=g).to("cuda", dtype) for _ in range(2)]
    x0 = torch.randn((bsz, d, n), generator=g).cuda()
    results = []
    for has_d, has_z in ((False, False), (False, True), (True, False)):
        tag = dict(shape=label, dims=[bsz, seqlen, d, n], dtype=str(dtype), D=has_d, z=has_z)
        D, z = (raw[5] if has_d else None), (raw[6] if has_z else None)
        args = (raw[0], _prep_dt(raw[1], raw[7]), raw[2], raw[3], raw[4], D, z)
        for reverse in (False, True):
            got = selective_scan_cuda(args, reverse)
            got_s, fin = selective_scan_cuda(args, reverse, initial_state=x0,
                                             return_final_state=True)
            torch.cuda.synchronize()
            want_s, want_fin = selective_scan_plain(args, reverse, initial_state=x0,
                                                    return_final_state=True)
            for name, a, b, tol in (("out", got, selective_scan_plain(args, reverse),
                                     (atol, rtol)),
                                    ("with_state_out", got_s, want_s, (atol, rtol)),
                                    ("final_state", fin, want_fin, XB_TOL)):
                results.append({**compare(a, b, *tol), "kernel": "selective_scan_fwd",
                                "form": "no_gate", "output": name,
                                "direction": "reverse" if reverse else "forward", **tag})
        rev = args[:2] + (args[2] * 0.5,) + args[3:]
        got = selective_scan_dual_cuda(args, rev)
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(got, selective_scan_dual_plain(args, rev))):
            results.append({**compare(a, b, atol, rtol), "kernel": "selective_scan_dual_fwd",
                            "form": "no_gate", "direction": "reverse" if i else "forward",
                            **tag})
        for fused in (False, True):
            kernel = "selective_scan_bwd_fused" if fused else "selective_scan_bwd"
            with scan_switches(AUM_SCAN_BWD_FUSED=fused):
                leaves = [None if t is None else t.detach().requires_grad_() for t in raw[:7]]
                leaves[5], leaves[6] = (leaves[5] if has_d else None), (leaves[6] if has_z
                                                                        else None)
                bias = raw[7].detach().requires_grad_()
                y = selective_scan(*leaves, delta_bias=bias, delta_softplus=True)
                y.backward(gouts[0])
                y_f, y_r = selective_scan_dual(
                    tuple(leaves) + (bias,), tuple(leaves[:2]) + (leaves[2] * 0.5,)
                    + tuple(leaves[3:]) + (bias,))
                torch.autograd.backward((y_f, y_r), gouts)
            torch.cuda.synchronize()
            # The op's grads summed over the three calls (one scan, two
            # directions): against the plain backward of each, summed.
            dirs = [args + (False,), args + (False,), rev + (True,)]
            want = selective_scan_bwd_plain(dirs, [gouts[0], gouts[0], gouts[1]])
            # The first run's y.backward and the dual's share the leaves; the
            # plain grads of the three scans sum the same way (A_b = 0.5 A:
            # the reverse direction's dA counts half).
            sums = []
            for j, name in enumerate(GRAD_NAMES[:7]):
                parts = [w[j] for w in want]
                if parts[0] is None:
                    sums.append(None)
                    continue
                if name == "dA":
                    parts[2] = parts[2] * 0.5
                total = sum(p.float() for p in parts)
                sums.append(total)
            got_grads = [None if t is None else t.grad for t in leaves]
            names = [nm for nm, w in zip(GRAD_NAMES[:7], sums) if w is not None]
            r = _grad_checks(names, [gg for gg, w in zip(got_grads, sums) if w is not None],
                             [w for w in sums if w is not None], GRAD_TOL[dtype])
            bias_want = sum(w[7] for w in want)
            rb = compare_scaled(bias.grad, bias_want, GRAD_TOL[dtype])
            results.append({**r, "ok": r["ok"] and rb["ok"], "dbias": rb, "kernel": kernel,
                            "form": "no_gate_autograd", **tag})
    return results


def _check_combine(label, dims, dtype, slices) -> list[dict]:
    """The combine kernel and its backward alone against their plain
    versions, two directions (one with z, one without D and z)."""
    from aum_tpu_torch.ops.selective_scan import (
        scan_combine_bwd_cuda,
        scan_combine_bwd_plain,
        scan_combine_cuda,
        scan_combine_plain,
    )

    bsz, seqlen, d = dims
    g = torch.Generator(device="cuda").manual_seed(33)  # gigabytes of planes: drawn on the card

    def randn(*shape, dt=torch.float32):
        return torch.randn(shape, generator=g, device="cuda").to(dt)

    u, z, gout = (randn(bsz, seqlen, d, dt=dtype) for _ in range(3))
    D = randn(d)
    parts = [randn(slices, bsz, seqlen, d) for _ in range(5)]
    tag = dict(shape=label, dims=[bsz, seqlen, d], slices=slices, dtype=str(dtype))
    results = []
    got = scan_combine_cuda([(parts[0], u, D, z), (parts[1], u, None, None)])
    torch.cuda.synchronize()
    for i, (a, want) in enumerate(zip(got, (scan_combine_plain(parts[0], u, D, z),
                                            scan_combine_plain(parts[1], u, None, None)))):
        results.append({**compare(a, want, *SCAN_TOL[dtype]), "kernel": "scan_combine_fwd",
                        "gated": i == 0, **tag})
    items = [(parts[2], parts[3], parts[4], gout, z, u, D),
             (parts[2], parts[3], None, gout, None, u, None)]
    got = scan_combine_bwd_cuda(items)
    again = scan_combine_bwd_cuda(items)
    torch.cuda.synchronize()
    # The same bits from run to run (no atomics).
    pairs = [(a, b) for g1, g2 in zip(got, again) for a, b in zip(g1, g2) if a is not None]
    results.append({"kernel": "scan_combine_bwd", "against": "itself",
                    "ok": all(torch.equal(a, b) for a, b in pairs),
                    "max_abs_err": max((a.float() - b.float()).abs().max().item()
                                       for a, b in pairs), **tag})
    wants = (scan_combine_bwd_plain(*items[0]), scan_combine_bwd_plain(*items[1]))
    for i, (a, want) in enumerate(zip(got, wants)):
        names = [nm for nm, w in zip(("du", "ddelta", "dz", "dD", "dbias"), want)
                 if w is not None]
        r = _grad_checks(names, [x for x, w in zip(a, want) if w is not None],
                         [w for w in want if w is not None], GRAD_TOL[dtype])
        results.append({**r, "kernel": "scan_combine_bwd", "gated": i == 0, **tag})
    return results


def _sizes_kernel_checks() -> list[dict]:
    results = []
    for n in SIZES_STATES:
        for dtype in (torch.float32, torch.bfloat16):
            for train in (False, True):
                for shared in (True, False):
                    results += _check_scan("sizes_ragged", SIZES_RAGGED, dtype, shared, train, n)
                for reverse in (False, True):
                    results += _check_scan_single("sizes_ragged", SIZES_RAGGED, dtype, reverse,
                                                  train, n)
            results += _check_bwd_forms("sizes_ragged", SIZES_RAGGED, dtype, n)
            for shared in (True, False):
                results += _check_fdt("sizes_ragged", SIZES_RAGGED, dtype, shared, n, rank=12)
        results += _check_stage("sizes_ragged", SIZES_RAGGED, True, n)
    for n in (5, 16, 40):
        for dtype in (torch.float32, torch.bfloat16):
            results += _check_no_gate("sizes_no_gate", SIZES_RAGGED, dtype, n)
    for dtype in (torch.float32, torch.bfloat16):
        results += _check_combine("sizes_eval", SIZES_EVAL_DIMS, dtype, 4)
        results += _check_combine("sizes_ragged", SIZES_RAGGED, dtype, 8)
        results += _check_combine("sizes_long", SIZES_LONG, dtype, 2)
        results += _check_combine("sizes_odd_d", SIZES_COMBINE_ODD, dtype, 3)
        # N=64 at AuM-Base's eval shapes: the dual forward (v1) and the
        # single-direction one.
        results += _check_scan("sizes_eval", SIZES_EVAL_DIMS, dtype, True, False, SIZES_WIDE_N)
        results += _check_scan_single("sizes_eval", SIZES_EVAL_DIMS, dtype, False, False,
                                      SIZES_WIDE_N)
    # At the train shapes (bf16, the path's dtype): the saving forward and
    # both backward kernels, one and both directions, and the
    # single-direction op under autograd.
    results += _check_scan("sizes_train", TRAIN_DIMS, torch.bfloat16, True, True, SIZES_WIDE_N)
    results += _check_combine("sizes_train", TRAIN_DIMS, torch.bfloat16,
                              math.ceil(SIZES_WIDE_N / 16))
    results += _check_scan_single("sizes_train", TRAIN_DIMS, torch.bfloat16, True, True,
                                  SIZES_WIDE_N)
    for k in SIZES_CONV_WIDTHS:
        for label, (dims, offset) in SIZES_CONV_DIMS.items():
            for dtype in (torch.float32, torch.bfloat16):
                for train in (False, True):
                    results += _check_conv(label, dims, dtype, train, offset, k)
    dims, offset = SIZES_CONV_DIMS["sizes_unaligned"]
    for dtype in (torch.float32, torch.bfloat16):
        for train in (False, True):
            results += _check_conv("sizes_past_l", dims, dtype, train, offset, SIZES_CONV_PAST_L)
    for rank in SIZES_RANKS:
        for dtype in (torch.float32, torch.bfloat16):
            results += _check_fdt("sizes_ragged", SIZES_RAGGED, dtype, False, 16, rank)
            label = "sizes_implied_width" if rank in SIZES_WIDE_RANKS else "sizes_eval"
            results += _check_fdt(label, SIZES_WIDE_RANKS.get(rank, EVAL_DIMS), dtype, True, 16,
                                  rank)
    for rank in SIZES_RAGGED_RANKS:
        for dtype in (torch.float32, torch.bfloat16):
            for shared in (True, False):
                results += _check_fdt("sizes_ragged", SIZES_RAGGED, dtype, shared, 16, rank)
    return results


def _sizes_aum_paths() -> dict:
    """AuM-Base Fo-Bi (bf16, depth 24, random weights from seed 0) with
    d_state=64: a B=64 eval forward and a B=12 train step (split remat),
    each between a reset and a read of every launch counter; ms per
    forward and per step; then its fp32 depth-2 forward and train step
    against the CPU."""
    from aum_tpu_torch.entry import STEPS_PER_EPOCH, TRAIN_BATCH, TRAIN_HP, flagship_config
    from aum_tpu_torch.models import AudioMamba
    from aum_tpu_torch.train import (
        init_train_state,
        make_eval_step,
        make_optimizer,
        make_train_step,
    )

    n = SIZES_WIDE_N
    slices = math.ceil(n / 16)
    cfg = flagship_config(d_state=n)
    depth = cfg.depth
    model = AudioMamba(cfg, device="cuda", seed=0)
    fn = make_eval_step(model)
    x = torch.randn((BENCH_BATCH, 1024, 128), generator=torch.Generator().manual_seed(41))
    x = x.cuda()
    fn(x)
    torch.cuda.synchronize()
    _reset_counters()
    logits = fn(x)
    torch.cuda.synchronize()
    eval_launches = _read_counters()
    eval_ms = cuda_ms(lambda: fn(x), iters=5)
    finite = bool(torch.isfinite(logits.float()).all())
    expected = _launches(selective_scan_dual_fwd=slices * depth,
                         selective_scan_dual_fwd_sliced=slices * depth,
                         scan_combine_fwd=depth, causal_conv1d_fwd=depth)
    out = {"eval": {"batch": BENCH_BATCH, "d_state": n, "ms_per_forward": eval_ms,
                    "clips_per_s": BENCH_BATCH / (eval_ms / 1e3), "launches": eval_launches,
                    "logits_shape": list(logits.shape), "finite": finite}}
    emit({"phase": "sizes_aum_eval", **out["eval"]})
    if tuple(logits.shape) != (BENCH_BATCH, 527) or not finite or eval_launches != expected:
        raise RuntimeError(f"the d_state={n} eval forward gave {tuple(logits.shape)} "
                           f"(finite {finite}) with launches {eval_launches}, expected {expected}")
    del model, fn, logits
    cfg = flagship_config(d_state=n, remat=True)
    model = AudioMamba(cfg, device="cuda", seed=0)
    state = init_train_state(model, make_optimizer(model.parameters(), TRAIN_HP))
    step = make_train_step(TRAIN_HP, STEPS_PER_EPOCH, loss_type="BCE",
                           generator=torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(42)
    batch = {"x": torch.randn((TRAIN_BATCH, 1024, 128), generator=g).cuda(),
             "y": torch.nn.functional.one_hot(torch.arange(TRAIN_BATCH) % 527, 527).float().cuda()}
    state, loss = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    state, loss = step(state, batch)
    torch.cuda.synchronize()
    train_launches = _read_counters()
    losses = [loss.item()]
    step_ms = cuda_ms(lambda: step(state, batch), iters=3, warmup=0)
    expected = _expected_train_launches("Fo-Bi", depth, {}, bf16=True, slices=slices)
    out["train"] = {"batch": TRAIN_BATCH, "d_state": n, "loss": losses, "ms_per_step": step_ms,
                    "clips_per_s": TRAIN_BATCH / (step_ms / 1e3),
                    "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                    "launches": train_launches, "expected_launches": expected}
    emit({"phase": "sizes_aum_train", **out["train"]})
    # One step under AUM_SCAN_BWD_FUSED=1: the fused backward's sliced form.
    fused = {"AUM_SCAN_BWD_FUSED": True}
    with scan_switches(**fused):
        _reset_counters()
        state, loss = step(state, batch)
        torch.cuda.synchronize()
        fused_launches = _read_counters()
    losses.append(loss.item())
    expected_fused = _expected_train_launches("Fo-Bi", depth, fused, bf16=True, slices=slices)
    out["train"].update(loss=losses, fused_launches=fused_launches)
    emit({"phase": "sizes_aum_train_fused", "launches": fused_launches,
          "expected_launches": expected_fused, "loss": losses[-1]})
    if (not all(math.isfinite(v) for v in losses) or train_launches != expected
            or fused_launches != expected_fused):
        raise RuntimeError(f"the d_state={n} train step: loss {losses}, launches "
                           f"{train_launches} and {fused_launches} (fused), expected "
                           f"{expected} and {expected_fused}")
    del model, state, step, batch
    # fp32 at depth 2 on the card against the CPU: the forward's logits (B=2)
    # and a train step.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = flagship_config(dtype="float32", depth=2, d_state=n)
    x = torch.randn((2, 1024, 128), generator=torch.Generator().manual_seed(43))
    with torch.inference_mode():
        got = AudioMamba(cfg32, device="cuda", seed=0)(x.cuda()).cpu()
        want = AudioMamba(cfg32, device="cpu", seed=0)(x)
    r = compare(got, want, *MODEL_FP32_TOL)
    emit({"phase": "sizes_aum_fp32_vs_cpu", "depth": 2, "d_state": n, **r})
    if not r["ok"]:
        raise RuntimeError(f"the d_state={n} fp32 forward on the card disagrees with the CPU")
    out["fp32_logits"] = r
    out["fp32_train"] = _train_fp32_check("Fo-Bi", {"default": {}}, overrides={"d_state": n},
                                          slices=slices)
    return out


def _sizes_lm_path(config: dict, label: str) -> dict:
    """The Mamba LM at mamba-130m's widths with ``config``'s d_state and
    d_conv (SIZES_LM: 64 and 3; SIZES_LM_CONV: 16 and 12, the conv's general
    form) (bf16, random weights from seed 0): a B=8 x 512 prefill and
    SIZES_DECODE_STEPS decode steps (launches of each, ms); then the fp32
    depth-2 checks against the CPU and against stepwise decoding
    (``_lm_fp32_checks``)."""
    from aum_tpu_torch.models.lm import MambaLM, MambaLMConfig, decode_step, prefill
    from aum_tpu_torch.ops.conv1d import UNROLLED_WIDTHS

    cfg = MambaLMConfig(**config)
    slices = math.ceil(cfg.d_state / 16)
    bsz, seqlen, _ = LM_PREFILL_DIMS
    model = MambaLM(cfg, device="cuda", seed=0)
    ids = torch.randint(0, cfg.vocab_size, (bsz, seqlen),
                        generator=torch.Generator().manual_seed(0)).cuda()
    prefill(model, ids)
    torch.cuda.synchronize()
    _reset_counters()
    logits, state = prefill(model, ids)
    torch.cuda.synchronize()
    prefill_launches = _read_counters()
    prefill_ms = cuda_ms(lambda: prefill(model, ids), iters=3)
    _reset_counters()
    token = logits.argmax(dim=-1)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    finite = bool(torch.isfinite(logits.float()).all())
    for _ in range(SIZES_DECODE_STEPS):
        step_logits, state = decode_step(model, token, state)
        token = step_logits.argmax(dim=-1)
        finite = finite and bool(torch.isfinite(step_logits.float()).all())
    end.record()
    end.synchronize()
    decode_launches = _read_counters()
    depth = cfg.n_layer
    sliced = {"selective_scan_fwd_sliced": slices * depth, "scan_combine_fwd": depth}
    expected = _launches(selective_scan_fwd=slices * depth,
                         selective_scan_fwd_with_state=slices * depth,
                         **(sliced if slices > 1 else {}), causal_conv1d_fwd=depth,
                         causal_conv1d_fwd_general=depth * (cfg.d_conv > UNROLLED_WIDTHS))
    out = {"phase": label, "config": config, "batch": bsz, "prompt": seqlen,
           "decode_steps": SIZES_DECODE_STEPS, "logits_shape": list(logits.shape),
           "finite": finite, "prefill_ms": prefill_ms,
           "prefill_tokens_per_s": bsz * seqlen / (prefill_ms / 1e3),
           "decode_step_ms": start.elapsed_time(end) / SIZES_DECODE_STEPS,
           "prefill_launches": prefill_launches, "decode_launches": decode_launches,
           "conv_state_shape": list(state["conv"].shape),
           "ssm_state_shape": list(state["ssm"].shape)}
    emit(out)
    if (tuple(logits.shape) != (bsz, cfg.padded_vocab) or not finite
            or prefill_launches != expected or decode_launches != _launches()
            or tuple(state["ssm"].shape[-1:]) != (cfg.d_state,)
            or tuple(state["conv"].shape[-1:]) != (cfg.d_conv,)):
        raise RuntimeError(f"{label}: logits {tuple(logits.shape)} finite {finite}, "
                           f"prefill launches {prefill_launches} (expected {expected}), "
                           f"decode launches {decode_launches}")
    del model, state
    out["fp32"] = _lm_fp32_checks(cfg)
    return out


def _slice_fwd_bounds(bsz, seqlen, d, n, es, sfu_rate, ndir, state_bytes=0) -> dict:
    """One ungated forward launch on a slice of ``n`` states, ``ndir``
    directions sharing u, dt, B and C (v1): u, dt, the slice's columns of B
    and C read once, per direction its rows of A read and its fp32 partial
    written once (plus ``state_bytes`` of carried states); one exp2 and
    SCAN_FP32_OPS_PER_ELEMENT FP32-pipe instructions per (b, l, d, n) and
    direction."""
    bld, elems = bsz * seqlen * d, ndir * bsz * seqlen * d * n
    nbytes = (2 * bld + 2 * bsz * seqlen * n) * es + ndir * (n * d * 4 + bld * 4) + state_bytes
    return {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
            "operations": exp_floor_s(elems, SCAN_FP32_OPS_PER_ELEMENT * elems, sfu_rate) * 1e3}


def _slice_bwd_bounds(bsz, seqlen, d, n, es, sfu_rate, ndir) -> dict:
    """One ungated backward launch on a slice of ``n`` states, ``ndir``
    directions sharing u, dt, z, B and C (v1): those read once (B and C the
    slice's columns), per direction its cotangent, its saved states and
    rows of A read, its fp32 du, ddelta and y partials, dA rows and dB, dC
    columns written once; SCAN_BWD_FP32_OPS_PER_ELEMENT per (b, l, d, n) and
    direction."""
    from aum_tpu_torch.ops.selective_scan import STATE_CHUNK

    bld, bln = bsz * seqlen * d, bsz * seqlen * n
    xb_bytes = bsz * math.ceil(seqlen / STATE_CHUNK) * n * d * 4
    elems = ndir * bld * n
    nbytes = (3 * bld + 2 * bln) * es + ndir * (bld * es + xb_bytes + n * d * 4
                                               + 3 * bld * 4 + n * d * 4 + 2 * bln * es)
    return {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
            "operations": exp_floor_s(elems, SCAN_BWD_FP32_OPS_PER_ELEMENT * elems,
                                      sfu_rate) * 1e3}


def _sizes_bench(sfu_rate: float) -> dict:
    """ms per launch of the new forms (bf16), each beside its bound and its
    plain version's ms. The sliced forms are timed one launch on one slice
    of 16 states, as the path launches it (its own fp32 planes per
    direction), beside their whole op at N=64: the dual forward at
    AuM-Base's eval shapes; the backward of both directions at the train
    shapes, K2 and the fused kernel in turns; the with_state forward at the
    LM prefill's shapes; the combine and its backward on planes of their
    own per direction. Then the conv at each width and the fuse_dt form at
    each dt rank (N=16)."""
    from aum_tpu_torch.ops.conv1d import causal_conv1d_cuda, causal_conv1d_plain
    from aum_tpu_torch.ops.selective_scan import (
        _bwd_launch,
        _launch_dual,
        _launch_single,
        _prep_dt,
        _scan_dir_args,
        _slice_dir,
        _sliced_lib,
        scan_combine_bwd_cuda,
        scan_combine_bwd_plain,
        scan_combine_cuda,
        scan_combine_plain,
        selective_scan_bwd_cuda,
        selective_scan_bwd_plain,
        selective_scan_cuda,
        selective_scan_dual_cuda,
        selective_scan_dual_fdt_cuda,
        selective_scan_dual_fdt_plain,
        selective_scan_dual_plain,
        selective_scan_plain,
    )

    dtype, es, n, ns = torch.bfloat16, 2, SIZES_WIDE_N, 16
    slices = math.ceil(n / ns)
    out = {}
    bsz, seqlen, d = SIZES_EVAL_DIMS
    bld = bsz * seqlen * d
    u, delta, A, B, C, D, z, bias = scan_inputs(bsz, seqlen, d, n, dtype, seed=44)
    fwd = (u, _prep_dt(delta, bias), A, B, C, D, z)
    rev = fwd[:2] + (A * 0.5,) + fwd[3:]
    op_ms = cuda_ms(lambda: selective_scan_dual_cuda(fwd, rev), iters=20)
    # Each direction its own S fp32 planes, as the path has them; the slice
    # launch writes the first plane of each.
    parts = [torch.randn((slices, bsz, seqlen, d), device="cuda") for _ in range(2)]
    slice_f, slice_r = _slice_dir(fwd, 0, ns), _slice_dir(rev, 0, ns)
    args_f, _, _, _, keep_f = _scan_dir_args(*slice_f, False, out=parts[0][0])
    args_r, _, _, _, keep_r = _scan_dir_args(*slice_r, False, out=parts[1][0])
    slice_ms = cuda_ms(lambda: _launch_dual(_sliced_lib(), "aum_selective_scan_dual_fwd",
                                            args_f, args_r, u, ns), iters=50)
    del keep_f, keep_r
    combine_ms = cuda_ms(lambda: scan_combine_cuda([(parts[0], u, D, z), (parts[1], u, D, z)]),
                         iters=50)
    out["scan_sliced"] = {
        "ms": slice_ms, "op_ms": op_ms, "combine_ms": combine_ms,
        "plain_ms": cuda_ms(lambda: selective_scan_dual_plain(slice_f, slice_r), iters=1,
                            warmup=0),
        "bounds_ms": _slice_fwd_bounds(bsz, seqlen, d, ns, es, sfu_rate, 2),
        "dims": [bsz, seqlen, d, n], "slices": slices}
    # The combine: per direction its S fp32 planes read and its output
    # written, u and z read once for both (v1); S + 4 operations per element.
    cbytes = (2 * slices * bld * 4 + 2 * bld * es + 2 * bld * es) + d * 8
    out["combine"] = {"ms": combine_ms,
                      "plain_ms": cuda_ms(lambda: [scan_combine_plain(p, u, D, z)
                                                   for p in parts], iters=5),
                      "bounds_ms": {"bytes": cbytes / HBM_BYTES_PER_S * 1e3,
                                    "fp32_flops": 2 * bld * (slices + 4) / FP32_FLOPS_PER_S
                                    * 1e3}}
    del fwd, rev, slice_f, slice_r, u, delta, z, B, C, parts
    # The sliced backward at the train shapes, both directions (v1).
    bsz, seqlen, d = TRAIN_DIMS
    bld = bsz * seqlen * d
    u, delta, A, B, C, D, z, bias = scan_inputs(bsz, seqlen, d, n, dtype, seed=45)
    fwd = (u, _prep_dt(delta, bias), A, B, C, D, z)
    rev = fwd[:2] + (A * 0.5,) + fwd[3:]
    save_ms = cuda_ms(lambda: selective_scan_dual_cuda(fwd, rev, save_states=True), iters=20)
    _, _, xb_f, xb_r = selective_scan_dual_cuda(fwd, rev, save_states=True)
    gs = [torch.randn((bsz, seqlen, d), generator=torch.Generator().manual_seed(i)).to(
        "cuda", dtype) for i in range(2)]
    dirs = [fwd + (False,), rev + (True,)]
    # Per direction its own du, ddelta and y planes; the slice launch writes
    # the first of each.
    planes = [[torch.randn((slices, bsz, seqlen, d), device="cuda") for _ in range(3)]
              for _ in range(2)]
    items = [(dr[0], dr[1], dr[2][:, :ns].contiguous(), dr[3][..., :ns], dr[4][..., :ns], None,
              dr[6], g, xb[:, :, :ns].contiguous(), dr[7], None, *(p[0] for p in pl))
             for dr, g, xb, pl in zip(dirs, gs, (xb_f, xb_r), planes)]
    bwd = {"k2": [], "fused": []}
    bwd_slice = {"k2": [], "fused": []}
    for name in ("fused", "k2", "k2", "fused"):
        with scan_switches(AUM_SCAN_BWD_FUSED=name == "fused"):
            bwd[name].append(cuda_ms(lambda: selective_scan_bwd_cuda(dirs, gs, [xb_f, xb_r]),
                                     iters=10))
        bwd_slice[name].append(cuda_ms(lambda: _bwd_launch(
            name == "fused", True, items, bsz, seqlen, d, ns, dtype, softplus=True,
            xminus=False, bf16_partials=False), iters=10))
    cbwd_ms = cuda_ms(lambda: scan_combine_bwd_cuda(
        [(*planes[i], gs[i], z, u, D) for i in range(2)]), iters=20)
    # The slice's function: the ungated backward on its 16 states, from the
    # pre-gate cotangent g silu(z).
    slice_dirs = [_slice_dir(dr, 0, ns) + (dr[7],) for dr in dirs]
    gys = [(g.float() * torch.nn.functional.silu(z.float())).to(dtype) for g in gs]
    bwd_plain_ms = cuda_ms(lambda: selective_scan_bwd_plain(slice_dirs, gys), iters=1,
                           warmup=0)
    for name in ("k2", "fused"):
        out[f"scan_bwd_sliced_{name}"] = {
            "ms": min(bwd_slice[name]), "ms_in_turns": bwd_slice[name],
            "op_ms_in_turns": bwd[name], "plain_ms": bwd_plain_ms,
            "bounds_ms": _slice_bwd_bounds(bsz, seqlen, d, ns, es, sfu_rate, 2),
            "dims": [bsz, seqlen, d, n], "slices": slices}
    out["scan_save_sliced"] = {"op_ms": save_ms, "dims": [bsz, seqlen, d, n]}
    # Per direction its S fp32 du, ddelta and y planes and its cotangent
    # read, du, ddelta and dz written; u and z read once for both (v1).
    cbbytes = 2 * (3 * slices * bld * 4 + bld * es + 3 * bld * es) + 2 * bld * es + d * 20
    out["combine_bwd"] = {"ms": cbwd_ms, "plain_ms": cuda_ms(lambda: [
        scan_combine_bwd_plain(*planes[i], gs[i], z, u, D) for i in range(2)], iters=3),
        "bounds_ms": {"bytes": cbbytes / HBM_BYTES_PER_S * 1e3,
                      "fp32_flops": 2 * bld * (3 * slices + 12) / FP32_FLOPS_PER_S * 1e3}}
    del fwd, rev, dirs, slice_dirs, items, xb_f, xb_r, planes, gys, u, delta, z, B, C
    # The sliced with_state forward at the LM prefill's shapes.
    bsz, seqlen, d = LM_PREFILL_DIMS
    u, delta, A, B, C, D, z, bias = scan_inputs(bsz, seqlen, d, n, dtype, seed=46)
    args = (u, _prep_dt(delta, bias), A, B, C, D, z)
    x0 = torch.zeros((bsz, d, n), device="cuda")
    ws_ms = cuda_ms(lambda: selective_scan_cuda(args, False, initial_state=x0,
                                                return_final_state=True), iters=20)
    parts = torch.randn((slices, bsz, seqlen, d), device="cuda")
    ws_combine = cuda_ms(lambda: scan_combine_cuda([(parts, u, D, z)]), iters=50)
    slice_args = _slice_dir(args, 0, ns)
    kargs, _, _, _, keep = _scan_dir_args(
        *slice_args, False, x0[..., :ns].transpose(1, 2).contiguous(), out=parts[0])
    ws_slice = cuda_ms(lambda: _launch_single(_sliced_lib(), kargs, False, u, ns), iters=50)
    del keep
    out["scan_single_sliced_with_state"] = {
        "ms": ws_slice, "op_ms": ws_ms, "combine_ms": ws_combine,
        "plain_ms": cuda_ms(lambda: selective_scan_plain(
            slice_args, False, initial_state=x0[..., :ns], return_final_state=True),
            iters=1, warmup=0),
        "bounds_ms": _slice_fwd_bounds(bsz, seqlen, d, ns, es, sfu_rate, 1,
                                       2 * bsz * ns * d * 4),
        "dims": [bsz, seqlen, d, n], "slices": slices}
    del args, slice_args, parts, u, delta, z, B, C
    # The conv at each width, at the eval shapes.
    bsz, seqlen, d = SIZES_EVAL_DIMS
    out["conv_by_width"] = {}
    for k in SIZES_CONV_WIDTHS + (4,):
        xc, w, b = conv_inputs(bsz, seqlen, d, k, dtype, seed=47)
        w3 = w[:, None, :]
        out["conv_by_width"][str(k)] = {
            "ms": cuda_ms(lambda: causal_conv1d_cuda(xc, w, b, "silu", False), iters=500),
            "plain_ms": cuda_ms(lambda: causal_conv1d_plain(xc, w, b, "silu", False), iters=5),
            "library_ms": cuda_ms(lambda: torch.nn.functional.silu(torch.nn.functional.conv1d(
                xc.transpose(1, 2), w3, b, padding=k - 1, groups=d)[..., :seqlen]), iters=20),
            "bounds_ms": _conv_bounds(bsz, seqlen, d, k, es)}
        del xc, w, b
    # The fuse_dt form at each dt rank (N=16, v1), at the eval shapes, and
    # past 400 at the width the rank implies.
    n16 = 16

    def fdt_bench(bsz, seqlen, d, rank):
        fold = fold_inputs(bsz, seqlen, d, n16, dtype, seed=48, rank=rank)
        fold_r = fold[:3] + (fold[3] * 0.5,) + fold[4:]
        elems = 2 * bsz * seqlen * d * n16
        sbytes = (3 * bsz * seqlen * d + 2 * bsz * seqlen * n16) * es + 2 * bsz * seqlen * d * es \
            + 2 * d * n16 * 4 + d * 4
        fbytes = sbytes - bsz * seqlen * d * es + bsz * seqlen * rank * es + rank * d * es + d * 4
        product_s = 2 * bsz * seqlen * rank * d / BF16_TENSOR_FLOPS_PER_S
        return {
            "ms": cuda_ms(lambda: selective_scan_dual_fdt_cuda(fold, fold_r), iters=50),
            "plain_ms": cuda_ms(lambda: selective_scan_dual_fdt_plain(fold, fold_r), iters=1,
                                warmup=0),
            "bounds_ms": {"bytes": fbytes / HBM_BYTES_PER_S * 1e3,
                          "operations": (exp_floor_s(elems, SCAN_FP32_OPS_PER_ELEMENT * elems,
                                                     sfu_rate) + product_s) * 1e3},
            "dims": [bsz, seqlen, d, n16]}

    out["fdt_by_rank"] = {str(rank): fdt_bench(bsz, seqlen, d, rank)
                          for rank in SIZES_RANKS + (48,)}
    out["fdt_by_rank_implied_width"] = {str(rank): fdt_bench(*dims, rank)
                                        for rank, dims in SIZES_WIDE_RANKS.items()}
    emit({"phase": "sizes_bench", "dtype": "bfloat16", **out})
    return out


def phase_sizes(device_info: dict) -> dict:
    """The shapes the JAX package's ops take beyond the default paths':
    every new form against its plain version, the wide-state
    AuM-Base and Mamba LM paths, and the new forms' ms."""
    t0 = time.perf_counter()
    from aum_tpu_torch.ops.conv1d import UNROLLED_WIDTHS

    results = _sizes_kernel_checks()
    worst = {}
    for r in results:
        emit({"phase": "sizes_kernels", **r})
        if r["dtype"] == str(torch.bfloat16) and r.get("against", "plain") == "plain":
            key = r["kernel"] + ("_no_gate" if "no_gate" in r.get("form", "") else "")
            if r["kernel"].startswith("causal_conv1d") and r["dims"][3] > UNROLLED_WIDTHS:
                key += "_general"  # the conv's general form
            worst[key] = max(worst.get(key, 0.0), r["max_abs_err"])
    failed = [r for r in results if not r["ok"]]
    emit({"phase": "sizes_kernels_summary", "checks": len(results), "failed": len(failed),
          "worst_bf16_max_abs_err": worst, "seconds": time.perf_counter() - t0})
    if failed:
        raise RuntimeError(f"{len(failed)} sizes checks disagree with the plain version")
    seconds = {"kernels": time.perf_counter() - t0}
    t0 = time.perf_counter()
    aum = _sizes_aum_paths()
    seconds["aum"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lm = _sizes_lm_path(SIZES_LM, "sizes_lm_path")
    seconds["lm"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lm_conv = _sizes_lm_path(SIZES_LM_CONV, "sizes_lm_conv_path")
    seconds["lm_conv"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sfu_rate = device_info["sms"] * SFU_PER_SM_PER_CLOCK * max_sm_clock_hz()
    bench = _sizes_bench(sfu_rate)
    seconds["bench"] = time.perf_counter() - t0
    emit({"phase": "sizes_seconds", **seconds})
    return {"worst": worst, "aum": aum, "lm": lm, "lm_conv": lm_conv, "bench": bench}


def _bound(bounds: dict) -> tuple[float, str]:
    key = max(bounds, key=bounds.get)
    return bounds[key], "bytes" if key == "bytes" else "operations"


def _kernel_entry(name, source, replaces, launches, max_abs_err, bench, library_ms=None):
    bound, by = _bound(bench["bounds_ms"])
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max_abs_err, "ms": bench["ms"],
            "plain_ms": bench["plain_ms"], "bound_ms": bound, "bound_by": by,
            "library_ms": library_ms}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import aum_tpu_torch  # noqa: F401  (fails here, before any output, outside a checkout)

    t0 = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        start = time.perf_counter()
        result = fn(*args)
        seconds[name] = time.perf_counter() - start
        emit({"phase": "seconds", "of": name, "seconds": seconds[name]})
        return result

    # Every phase starts from the default kernels; each switched run sets its
    # switches itself.
    with scan_switches(**dict.fromkeys(SWITCHES, False)):
        device_info = timed("device", phase_device)
        timed("build", phase_build)
        worst = timed("kernels", phase_kernels)
        eval_runs = timed("model", phase_model)
        wav_launches = timed("wav", phase_wav)
        train = timed("train", phase_train)
        recipe = timed("recipe", phase_recipe)
        epic = timed("epic", phase_epic)
        flex = timed("flex", phase_flex, device_info)
        lm = timed("lm", phase_lm)
        sizes = timed("sizes", phase_sizes, device_info)
        porters = timed("porters", phase_porters)
        ast = timed("ast", phase_ast)
        serving = timed("serving", phase_serving)
        ref_oracles = timed("ref_oracles", phase_ref_oracles)
        tools = timed("tools", phase_tools)
        parallel = timed("parallel", phase_parallel)
        bench = timed("bench", phase_bench, device_info)
        timed("profile", phase_profile)
    emit({"phase": "done", "seconds": time.perf_counter() - t0, "by_phase": seconds})
    # The flex phase's kernel checks (L = 2049 and 129) count in the worst errors.
    for key, err in flex["worst"].items():
        worst[key] = max(worst.get(key, 0.0), err)
    eval_launches, eval_direct = eval_runs["default"], eval_runs["direct"]
    train_launches = train["default"]["launches_per_step"]
    train_switched = train["direct_fused"]["launches_per_step"]
    train_fdt = train["fuse_dt"]["launches_per_step"]
    train_opt_k2 = train["opt_in_k2"]["launches_per_step"]
    train_opt_fused = train["opt_in_fused"]["launches_per_step"]
    fofo_launches = train["fofo_check_launches"]["default"]
    fofo_fused = train["fofo_check_launches"]["fused"]
    scan = _kernel_entry(
        "selective_scan_dual_fwd", "aum_tpu_torch/csrc/selective_scan.cu",
        "aum_tpu/ops/selective_scan.py:1648", eval_launches["selective_scan_dual_fwd"],
        worst["selective_scan_dual_fwd"], bench["scan"])
    # The same kernel saving its chunk-entry states, on the train path.
    scan["save_states"] = _kernel_entry(
        "selective_scan_dual_fwd", scan["source"], scan["replaces"],
        train_launches["selective_scan_dual_fwd_save_states"],
        worst["selective_scan_dual_fwd_save_states"], bench["scan_save"])
    scan["launches_by_path"] = {"eval": eval_launches["selective_scan_dual_fwd"],
                                "wav": wav_launches["selective_scan_dual_fwd"],
                                "train": train_launches["selective_scan_dual_fwd"],
                                "eval_fuse_dt": eval_runs["fuse_dt"]["selective_scan_dual_fwd"],
                                "train_fuse_dt": train_fdt["selective_scan_dual_fwd"]}
    # AUM_SCAN_FUSE_DT=1: entry() runs the fuse_dt form (train_entry() the
    # staged saving forward above, with delta formed outside the kernel).
    fdt = _kernel_entry(
        "selective_scan_dual_fdt_fwd", scan["source"],
        "aum_tpu/ops/selective_scan.py:1648 (fuse_dt, :1705-1731)",
        eval_runs["fuse_dt"]["selective_scan_dual_fdt_fwd"], worst["selective_scan_dual_fdt_fwd"],
        bench["scan_fdt"])
    fdt["launches_by_path"] = {
        "eval_fuse_dt": eval_runs["fuse_dt"]["selective_scan_dual_fdt_fwd"],
        "eval_fuse_dt_direct": eval_runs["fuse_dt_direct"]["selective_scan_dual_fdt_fwd"],
        "eval": eval_launches["selective_scan_dual_fdt_fwd"],
        "train_fuse_dt": train_fdt["selective_scan_dual_fdt_fwd"]}
    # AUM_SCAN_BF16_STAGE=1: entry() and the train path's saving forward.
    stage = _kernel_entry(
        "selective_scan_dual_stage_fwd", scan["source"],
        "aum_tpu/ops/selective_scan.py:1648 (bf16_stage, :1689-1702, :1751-1752, :1767-1770)",
        eval_runs["bf16_stage"]["selective_scan_dual_stage_fwd"],
        worst["selective_scan_dual_stage_fwd"], bench["scan_stage"])
    stage["save_states"] = _kernel_entry(
        "selective_scan_dual_stage_fwd", scan["source"], stage["replaces"],
        train_opt_k2["selective_scan_dual_stage_fwd_save_states"],
        worst["selective_scan_dual_stage_fwd_save_states"], bench["scan_save_stage"])
    stage["launches_by_path"] = {
        "eval_bf16_stage": eval_runs["bf16_stage"]["selective_scan_dual_stage_fwd"],
        "train_opt_in": train_opt_k2["selective_scan_dual_stage_fwd"],
        "eval": eval_launches["selective_scan_dual_stage_fwd"],
        "train": train_launches["selective_scan_dual_stage_fwd"]}
    # AUM_SCAN_DIRECT=1: entry() and train_entry() run the direct kernel.
    direct = _kernel_entry(
        "selective_scan_dual_direct_fwd", scan["source"], "aum_tpu/ops/selective_scan.py:1856",
        eval_direct["selective_scan_dual_direct_fwd"], worst["selective_scan_dual_direct_fwd"],
        bench["scan_direct"])
    direct["save_states"] = _kernel_entry(
        "selective_scan_dual_direct_fwd", scan["source"], direct["replaces"],
        train_switched["selective_scan_dual_direct_fwd_save_states"],
        worst["selective_scan_dual_direct_fwd_save_states"], bench["scan_save_direct"])
    direct["launches_by_path"] = {
        "eval_direct": eval_direct["selective_scan_dual_direct_fwd"],
        "train_direct_fused": train_switched["selective_scan_dual_direct_fwd"],
        "eval": eval_launches["selective_scan_dual_direct_fwd"],
        "train": train_launches["selective_scan_dual_direct_fwd"]}
    bwd = _kernel_entry(
        "selective_scan_bwd", "aum_tpu_torch/csrc/selective_scan_bwd.cu",
        "aum_tpu/ops/selective_scan.py:392", train_launches["selective_scan_bwd"],
        worst["selective_scan_bwd"], bench["scan_bwd"])
    bwd["also_replaces"] = "aum_tpu/ops/selective_scan.py:822 (both directions in one launch)"
    bwd["launches_by_path"] = {"eval": 0, "wav": 0, "train": train_launches["selective_scan_bwd"],
                               "fofo_train_check": fofo_launches["selective_scan_bwd"],
                               "train_direct_fused": train_switched["selective_scan_bwd"],
                               "train_fuse_dt": train_fdt["selective_scan_bwd"]}
    # Its opt-in forms on the train path with every opt-in switch on
    # (AUM_SCAN_BWD_XMINUS=1, AUM_SCAN_BWD_BF16_PARTIALS=1).
    bwd["xminus"] = _kernel_entry(
        "selective_scan_bwd", bwd["source"],
        "aum_tpu/ops/selective_scan.py:392 (dla_mode xminus/dbu, :497-537)",
        train_opt_k2["selective_scan_bwd_xminus"], worst["selective_scan_bwd_xminus"],
        bench["scan_bwd_xminus"])
    bwd["bf16_partials"] = _kernel_entry(
        "selective_scan_bwd", bwd["source"],
        "aum_tpu/ops/selective_scan.py:392 (bf16 dB/dC partials, :741-757)",
        train_opt_k2["selective_scan_bwd_bf16_partials"],
        worst["selective_scan_bwd_bf16_partials"], bench["scan_bwd_bf16_partials"])
    # The same kernel on one direction, the form of _bwd_kernel: the Fo-Fo
    # train check launches it (the train path takes both directions at once).
    bwd["one_direction"] = _kernel_entry(
        "selective_scan_bwd", bwd["source"], bwd["replaces"],
        fofo_launches["selective_scan_bwd"], worst["selective_scan_bwd"],
        bench["scan_bwd_one_direction"])
    # Its with_state form, on its entry path: sequence parallelism's train
    # step (one rank's launches; the chained-segment kernel check also runs
    # it through selective_scan under autograd).
    sp_step = parallel["bf16"]["dp_sp"]["launches_per_rank"]
    bwd["with_state"] = _kernel_entry(
        "selective_scan_bwd", bwd["source"], "aum_tpu/ops/selective_scan.py:392 (with_state)",
        sp_step["selective_scan_bwd_with_state"],
        worst["selective_scan_bwd_with_state"], bench["scan_bwd_with_state"])
    bwd["with_state"]["launches_by_path"] = {
        "train": train_launches["selective_scan_bwd_with_state"],
        "parallel_dp_sp_train_step": sp_step["selective_scan_bwd_with_state"],
        "parallel_runner_tp_sp_run": parallel["runner"]["selective_scan_bwd_with_state"],
        "ref_oracles_ops": ref_oracles["ops_launches"]["selective_scan_bwd_with_state"]}
    # AUM_SCAN_BWD_FUSED=1: train_entry() (both directions per launch) and
    # the Fo-Fo train check (one direction) run the fused kernel.
    fused = _kernel_entry(
        "selective_scan_bwd_fused", "aum_tpu_torch/csrc/selective_scan_bwd_fused.cu",
        "aum_tpu/ops/selective_scan.py:553", train_switched["selective_scan_bwd_fused"],
        worst["selective_scan_bwd_fused"], bench["scan_bwd_fused"])
    fused["one_direction"] = _kernel_entry(
        "selective_scan_bwd_fused", fused["source"], fused["replaces"],
        fofo_fused["selective_scan_bwd_fused"], worst["selective_scan_bwd_fused"],
        bench["scan_bwd_fused_one_direction"])
    fused["launches_by_path"] = {"train_direct_fused": train_switched["selective_scan_bwd_fused"],
                                 "fofo_train_check_fused": fofo_fused["selective_scan_bwd_fused"],
                                 "train": train_launches["selective_scan_bwd_fused"]}
    fused["bf16_partials"] = _kernel_entry(
        "selective_scan_bwd_fused", fused["source"],
        "aum_tpu/ops/selective_scan.py:553 (bf16 dB/dC partials, :741-757)",
        train_opt_fused["selective_scan_bwd_bf16_partials"],
        worst["selective_scan_bwd_fused_bf16_partials"], bench["scan_bwd_fused_bf16_partials"])
    single = _kernel_entry(
        "selective_scan_fwd", "aum_tpu_torch/csrc/selective_scan.cu",
        "aum_tpu/ops/selective_scan.py:111", wav_launches["selective_scan_fwd"],
        worst["selective_scan_fwd"], bench["scan_single_eval"])
    # Its saving form, under grad (the Fo-Fo train check), and its with_state
    # form, which the LM prefill runs (timed at its shapes).
    single["save_states"] = _kernel_entry(
        "selective_scan_fwd", single["source"], single["replaces"],
        fofo_launches["selective_scan_fwd_save_states"],
        worst["selective_scan_fwd_save_states"], bench["scan_single_save_states"])
    single["with_state"] = _kernel_entry(
        "selective_scan_fwd", single["source"], single["replaces"],
        lm["prefill_launches"]["selective_scan_fwd_with_state"],
        worst["selective_scan_fwd_with_state"], bench["scan_single_with_state"])
    single["launches_by_path"] = {"eval": eval_launches["selective_scan_fwd"],
                                  "wav": wav_launches["selective_scan_fwd"],
                                  "train": train_launches["selective_scan_fwd"],
                                  "fofo_train_check": fofo_launches["selective_scan_fwd"]}
    conv = _kernel_entry(
        "causal_conv1d_fwd", "aum_tpu_torch/csrc/conv1d.cu", "aum_tpu/ops/conv1d.py:107",
        eval_launches["causal_conv1d_fwd"], worst["causal_conv1d_fwd"], bench["conv"],
        library_ms=bench["conv"]["library_ms"])
    conv["launches_by_path"] = {"eval": eval_launches["causal_conv1d_fwd"],
                                "wav": wav_launches["causal_conv1d_fwd"],
                                "train": train_launches["causal_conv1d_fwd"]}
    # The recipe paths (run.main from WAV files): launches per train step and
    # per validation batch, by the counter each entry is keyed by.
    for entry, counter in ((scan, "selective_scan_dual_fwd"),
                           (direct, "selective_scan_dual_direct_fwd"),
                           (fdt, "selective_scan_dual_fdt_fwd"),
                           (stage, "selective_scan_dual_stage_fwd"),
                           (single, "selective_scan_fwd"), (bwd, "selective_scan_bwd"),
                           (fused, "selective_scan_bwd_fused"), (conv, "causal_conv1d_fwd")):
        for name in ("as20k", "speechcommands"):
            entry["launches_by_path"][f"recipe_{name}_train_step"] = (
                recipe[name]["step_launches"][counter])
            entry["launches_by_path"][f"recipe_{name}_val_batch"] = (
                recipe[name]["val_batch_launches"][counter])
        # EPIC-SOUNDS (run.main on in-memory pipelines), the flexible-patch
        # recipe (run.main from flac; each of its steps launches the same)
        # and the LM.
        entry["launches_by_path"].update({
            "epic_train_step": epic["train"]["step_launches"][counter],
            "epic_val_batch": epic["train"]["val_batch_launches"][counter],
            "flex_train_step": flex["recipe"]["step_launches"][counter],
            "flex_val_batch": flex["recipe"]["val_batch_launches"][counter],
            "lm_prefill": lm["prefill_launches"][counter],
            "lm_decode_step": lm["decode_step_launches"][counter]})
        # The porters' runs (run.main from reference checkpoints), the AST
        # recipe (no kernel of ours) and the serving bundles' B=64 predicts.
        bundles = serving["bundles"]
        entry["launches_by_path"].update({
            "porters_pretrained_train_step": porters["pretrained"]["step_launches"][counter],
            "porters_pretrained_val_batch": porters["pretrained"]["val_batch_launches"][counter],
            "porters_imagenet_bibi_train_step": porters["imagenet"]["step_launches"][counter],
            "porters_imagenet_bibi_val_batch": porters["imagenet"]["val_batch_launches"][counter],
            "porters_pth_eval_batch": porters["pth_eval"]["val_batch_launches"][counter],
            "ast_train_step": ast["recipe"]["step_launches"][counter],
            "ast_val_batch": ast["recipe"]["val_batch_launches"][counter],
            "bundle_predict_b64": bundles["bfloat16"]["launches_b64"][counter],
            "bundle_predict_wav_b64": bundles["bfloat16_wav"]["launches_b64"][counter],
            "bundle_predict_int8_b64": bundles["bfloat16_int8"]["launches_b64"][counter]})
    # The upstream oracles' phase (one AuM-Base mixer layer: each variant's
    # inference forward and train pass in fp32 and bf16; the single ops) and
    # one run of each user tool.
    for entry, counter in ((scan, "selective_scan_dual_fwd"),
                           (direct, "selective_scan_dual_direct_fwd"),
                           (fdt, "selective_scan_dual_fdt_fwd"),
                           (stage, "selective_scan_dual_stage_fwd"),
                           (single, "selective_scan_fwd"), (bwd, "selective_scan_bwd"),
                           (fused, "selective_scan_bwd_fused"), (conv, "causal_conv1d_fwd")):
        for run, counts in ref_oracles["launches_by_run"].items():
            entry["launches_by_path"][f"ref_oracles_mixer_{run}"] = counts[counter]
        entry["launches_by_path"].update({
            "ref_oracles_ops": ref_oracles["ops_launches"][counter],
            "tools_infer": tools["infer"]["launches"].get(counter, 0),
            "tools_verify_ckpt_record": tools["verify_ckpt"]["launches_record"].get(counter, 0),
            "tools_verify_lm": tools["verify_lm"]["launches"].get(counter, 0)})
    scan["save_states"]["launches_by_path_ref_oracles"] = {
        run: counts["selective_scan_dual_fwd_save_states"]
        for run, counts in ref_oracles["launches_by_run"].items()}
    single["launches_by_path"]["lm_prefill_with_state"] = (
        lm["prefill_launches"]["selective_scan_fwd_with_state"])
    single["with_state"]["launches_by_path"] = {
        "lm_prefill": lm["prefill_launches"]["selective_scan_fwd_with_state"],
        "parallel_dp_sp_train_step": sp_step["selective_scan_fwd_with_state"],
        "parallel_runner_tp_sp_run": parallel["runner"]["selective_scan_fwd_with_state"],
        "ref_oracles_ops": ref_oracles["ops_launches"]["selective_scan_fwd_with_state"]}
    # The parallel modes: one rank's launches in one bf16 train step of each
    # layout, and in the runner's whole run (2 steps and a val batch).
    for entry, counter in ((scan, "selective_scan_dual_fwd"),
                           (direct, "selective_scan_dual_direct_fwd"),
                           (fdt, "selective_scan_dual_fdt_fwd"),
                           (stage, "selective_scan_dual_stage_fwd"),
                           (single, "selective_scan_fwd"), (bwd, "selective_scan_bwd"),
                           (fused, "selective_scan_bwd_fused"), (conv, "causal_conv1d_fwd")):
        for name, step in parallel["bf16"].items():
            entry["launches_by_path"][f"parallel_{name}_train_step"] = (
                step["launches_per_rank"][counter])
        entry["launches_by_path"]["parallel_runner_tp_sp_run"] = parallel["runner"][counter]
    # The three kernels of the flexible-patch recipe, timed at its longest
    # and shortest token counts.
    for entry, key in ((scan["save_states"], "scan_save"), (bwd, "scan_bwd"), (conv, "conv")):
        entry["by_length"] = {
            str(b["dims"][1]): {f: b[key][f] for f in ("ms", "plain_ms", "bound_ms", "bound_by")}
            | ({"library_ms": b[key]["library_ms"]} if "library_ms" in b[key] else {})
            for b in flex["bench"].values()}
    scan["save_states"]["launches_by_path"] = {
        "train": train_launches["selective_scan_dual_fwd_save_states"],
        "flex_train_step": flex["recipe"]["step_launches"]["selective_scan_dual_fwd_save_states"]}
    # The sizes phase (d_state 64, d_conv 3, dt ranks past 64): the sliced
    # forms of the scan kernels and the combine, the conv by width and the
    # fuse_dt form by dt rank.
    sw, sb = sizes["worst"], sizes["bench"]
    s_eval, s_train = sizes["aum"]["eval"]["launches"], sizes["aum"]["train"]["launches"]
    s_lm = sizes["lm"]["prefill_launches"]
    sliced_replaces = "aum_tpu/ops/selective_scan.py:{} (d_state above 16: N padded, :1127)"
    scan["sliced"] = _kernel_entry(
        "selective_scan_dual_fwd", scan["source"] + " (selective_scan_sliced)",
        sliced_replaces.format(1648), s_eval["selective_scan_dual_fwd_sliced"],
        sw["selective_scan_dual_fwd"], sb["scan_sliced"])
    bwd["sliced"] = _kernel_entry(
        "selective_scan_bwd", bwd["source"] + " (selective_scan_bwd_sliced)",
        sliced_replaces.format(822), s_train["selective_scan_bwd_sliced"],
        sw["selective_scan_bwd"], sb["scan_bwd_sliced_k2"])
    fused["sliced"] = _kernel_entry(
        "selective_scan_bwd_fused", fused["source"] + " (selective_scan_bwd_fused_sliced)",
        sliced_replaces.format(553),
        sizes["aum"]["train"]["fused_launches"]["selective_scan_bwd_fused"],
        sw["selective_scan_bwd_fused"], sb["scan_bwd_sliced_fused"])
    single["sliced"] = _kernel_entry(
        "selective_scan_fwd", single["source"] + " (selective_scan_sliced)",
        sliced_replaces.format(111), s_lm["selective_scan_fwd_sliced"],
        sw["selective_scan_fwd"], sb["scan_single_sliced_with_state"])
    for entry, counter in ((scan["sliced"], "selective_scan_dual_fwd_sliced"),
                           (bwd["sliced"], "selective_scan_bwd_sliced"),
                           (fused["sliced"], "selective_scan_bwd_fused"),
                           (single["sliced"], "selective_scan_fwd_sliced")):
        entry["launches_by_path"] = {
            "sizes_aum_eval_b64": s_eval[counter], "sizes_aum_train_step": s_train[counter],
            "sizes_aum_train_step_fused": sizes["aum"]["train"]["fused_launches"][counter],
            "sizes_lm_prefill": s_lm[counter], "eval": eval_launches[counter],
            "train": train_launches[counter], "lm_prefill": lm["prefill_launches"][counter]}
    combine = _kernel_entry(
        "scan_combine_fwd", "aum_tpu_torch/csrc/scan_combine.cu",
        "aum_tpu/ops/selective_scan.py:1648 (the y readout summed over the padded states, "
        ":1127; :111 likewise)", s_eval["scan_combine_fwd"], sw["scan_combine_fwd"],
        sb["combine"])
    combine["bwd"] = _kernel_entry(
        "scan_combine_bwd", combine["source"],
        "aum_tpu/ops/selective_scan.py:822 (d_state above 16: dz, dD and the sums over slices)",
        s_train["scan_combine_bwd"], sw["scan_combine_bwd"], sb["combine_bwd"])
    for entry, counter in ((combine, "scan_combine_fwd"), (combine["bwd"], "scan_combine_bwd")):
        entry["launches_by_path"] = {
            "sizes_aum_eval_b64": s_eval[counter], "sizes_aum_train_step": s_train[counter],
            "sizes_lm_prefill": s_lm[counter], "eval": eval_launches[counter],
            "train": train_launches[counter], "lm_prefill": lm["prefill_launches"][counter]}

    def timed_entry(b):
        bound, by = _bound(b["bounds_ms"])
        return {"ms": b["ms"], "plain_ms": b["plain_ms"], "bound_ms": bound, "bound_by": by,
                **({"library_ms": b["library_ms"]} if "library_ms" in b else {})}

    conv["by_width"] = {k: timed_entry(b) for k, b in sb["conv_by_width"].items()}
    conv["by_width"]["3"]["launches_by_path"] = {"sizes_lm_prefill": s_lm["causal_conv1d_fwd"]}
    # The general form (widths past 8), on the LM's d_conv-12 prefill, timed
    # at width 12.
    s_lm_conv = sizes["lm_conv"]["prefill_launches"]
    conv["launches_by_path"]["sizes_lm_conv12_prefill"] = s_lm_conv["causal_conv1d_fwd"]
    conv["general"] = _kernel_entry(
        "causal_conv1d_fwd_general", conv["source"], conv["replaces"] + " (any k)",
        s_lm_conv["causal_conv1d_fwd_general"], sw["causal_conv1d_fwd_general"],
        sb["conv_by_width"]["12"], library_ms=sb["conv_by_width"]["12"]["library_ms"])
    conv["general"]["launches_by_path"] = {
        "sizes_lm_conv12_prefill": s_lm_conv["causal_conv1d_fwd_general"],
        "sizes_lm_prefill": s_lm["causal_conv1d_fwd_general"],
        "eval": eval_launches["causal_conv1d_fwd_general"],
        "train": train_launches["causal_conv1d_fwd_general"],
        "lm_prefill": lm["prefill_launches"]["causal_conv1d_fwd_general"]}
    fdt["by_rank"] = {r: timed_entry(b) for r, b in sb["fdt_by_rank"].items()}
    fdt["by_rank_implied_width"] = {r: timed_entry(b)
                                    for r, b in sb["fdt_by_rank_implied_width"].items()}
    emit({"kernels": [scan, direct, fdt, stage, single, bwd, fused, conv, combine]})
    print(smi("name,power.limit"), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
