"""AudioMamba (AuM): Mamba audio classifier, eval and train forward.

Counterpart of ``aum_tpu/models/audio_mamba.py``:

- input (B, T, F) log-mel, swapped to (B, F, T), then the patch embedding
  -> (B, N, D) tokens, F-major; a run-time ``patch_size`` / ``strides``
  PI-resizes the stored kernel and resamples the pos-embed grid (flexible
  patch sizes);
- a cls token (middle, end, front, the double head/tail pair, or a drawn
  position), then the absolute position embedding;
- optional F-major -> T-major token transpose (``transpose_token_sequence``),
  then the optional token shuffle and sequence flip, tracking the cls
  position(s);
- ``depth`` x [add -> RMSNorm (or LayerNorm) -> Mamba mixer (Fo-Fo, Fo-Bi or
  Bi-Bi)] blocks, starting from a zero residual stream (fp32 by default);
  with ``if_rope`` each unpaired block first rotates its input (and with
  ``if_rope_residual`` the residual); with ``if_bidirectional`` the blocks
  go in pairs, the second of each pair on the sequence reversed (hidden and
  residual flipped in, its outputs flipped back and added to the first's);
- final fused add+norm, cls readout (or mean/max/last pooling), linear head.

Parameters are drawn on the CPU from an explicit ``torch.Generator`` (so a
seed gives the same weights on every device), then moved to the model's
device. Entry points run on CUDA unless ``device`` is given; see
``aum_tpu_torch.utils.resolve_device``.

The forward is differentiable. ``train=True`` turns on the stochastic depth
(``drop_path_rate``) and the pos-embed dropout (``drop_rate``), with masks
drawn from the caller's ``torch.Generator`` outside every checkpointed region
and passed in, so a recompute reuses them (``torch.utils.checkpoint`` replays
only the default CUDA generator). The random cls position, the shuffle's
permutation and the flip are drawn from the same generator on the CPU
(``draw_tokens``) and applied as Python ints; ``forward(token_draws=)``
takes them from the caller instead. Remat (``remat``, ``remat_mode``)
applies only when a grad is being taken: ``"block"`` checkpoints each whole
block, ``"split"`` only each mixer's pre-scan compute, and ``"auto"`` picks
``"split"`` when its memory estimate fits the device's budget
(``resolve_remat_mode``), else ``"block"``.

The parallel modes (``parallel/``): ``seq_axis`` and ``pipe_axis`` name
the mesh axes of sequence and pipeline parallelism, as in the JAX module,
and ``parallel/mesh.py::shard_params`` lays the model out on a mesh after
its whole init (the mixers' d_inner over 'model', each mixer's scans split
in length over 'seq', or the stage's layers under 'pipe'). Under 'pipe' the
block stack runs GPipe-style (``parallel/pipeline.py``) over
``pipe_microbatches`` microbatches (at most; the largest divisor of the
batch); ``if_bidirectional`` pairs stay whole on a stage; pipe and seq
cannot be combined, as in JAX. Under 'data' each rank runs its slice of the
global batch and draws the drop-path and dropout masks of the whole global
batch, keeping its rows, so the masks are those of one process.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from aum_tpu_torch.models.mamba import MambaBlock, _Weights
from aum_tpu_torch.models.rope import apply_rope, rope_freqs_2d
from aum_tpu_torch.models.tokenization import (
    PatchEmbed,
    PosEmbed,
    patch_grid_shape,
    to_2tuple,
    trunc_normal_02_,
)
from aum_tpu_torch.ops import fused_add_norm
from aum_tpu_torch.parallel.pipeline import (
    block_stage_fn,
    block_stage_fn_dp,
    microbatch_count,
    pipeline_apply,
)
from aum_tpu_torch.utils import resolve_device


@dataclasses.dataclass(frozen=True)
class AudioMambaConfig:
    """Static model configuration (the JAX package's fields and defaults)."""

    spectrogram_size: Tuple[int, int] = (128, 1024)  # (F, T)
    patch_size: Tuple[int, int] = (16, 16)
    strides: Tuple[int, int] = (16, 16)
    depth: int = 24
    embed_dim: int = 768
    num_classes: int = 527
    d_state: int = 16
    norm_epsilon: float = 1e-5
    rms_norm: bool = True  # False: LayerNorm, with biases
    residual_in_fp32: bool = True  # False: the residual in the compute dtype
    final_pool_type: str = "mean"
    if_abs_pos_embed: bool = True
    if_cls_token: bool = True
    use_middle_cls_token: bool = True
    use_end_cls_token: bool = False
    use_double_cls_token: bool = False
    bimamba_type: str = "v2"
    if_devide_out: bool = True  # v2: halve the sum of the two branches
    init_layer_scale: Optional[float] = None  # LayerScale gamma's init; None: off
    if_bidirectional: bool = False
    transpose_token_sequence: bool = False
    remat: bool = True
    remat_mode: str = "auto"  # "none" | "block" | "split" | "auto"
    if_rope: bool = False
    if_rope_residual: bool = False
    drop_path_rate: float = 0.0
    drop_rate: float = 0.0
    dtype: str = "float32"

    @property
    def patch_grid(self) -> Tuple[int, int]:
        return patch_grid_shape(self.strides, self.patch_size,
                                self.spectrogram_size[0], self.spectrogram_size[1])

    @property
    def num_patches(self) -> int:
        f, t = self.patch_grid
        return f * t

    @property
    def num_prefix_tokens(self) -> int:
        if not self.if_cls_token:
            return 0
        return 2 if self.use_double_cls_token else 1

    @staticmethod
    def base(**kw) -> "AudioMambaConfig":
        return AudioMambaConfig(**{"depth": 24, "embed_dim": 768, **kw})

    @staticmethod
    def small(**kw) -> "AudioMambaConfig":
        return AudioMambaConfig(**{"depth": 24, "embed_dim": 384, **kw})

    @staticmethod
    def tiny(**kw) -> "AudioMambaConfig":
        return AudioMambaConfig(**{"depth": 24, "embed_dim": 192, **kw})

    @staticmethod
    def from_variant(model_type: str = "base", aum_type: str = "Fo-Bi",
                     **kw) -> "AudioMambaConfig":
        bimamba = {"Fo-Fo": "none", "Fo-Bi": "v1", "Bi-Bi": "v2"}[aum_type]
        ctor = {"base": AudioMambaConfig.base, "small": AudioMambaConfig.small,
                "tiny": AudioMambaConfig.tiny}[model_type]
        return ctor(bimamba_type=bimamba, **kw)


REMAT_MODES = ("none", "block", "split", "auto")

# remat_mode="auto": the device memory that split remat holds per element of
# depth x batch x tokens x d_inner, by the compute dtype's itemsize: the slope
# of the peak memory of a full-width train step (AuM-Base Fo-Bi, B=12, split
# remat, Adam) over the five token counts of patches 8, 12, 16, 24 and 32,
# fitted by ``chip_smoke.py``'s ``flex`` phase on an NVIDIA H100 80GB HBM3
# (700 W): 18.01 bytes in bf16, 29.62 in fp32, each line within 18 MB of
# its five points.
SPLIT_REMAT_BYTES_PER_ELEMENT = {2: 18.0, 4: 29.6}
# The budget leaves this share of the device's memory for the allocator's
# fragmentation and the step's transients beyond the estimate; the
# parameters, their grads and Adam's two moments (4 fp32 copies) come off
# it too.
SPLIT_REMAT_HEADROOM = 0.1


def resolve_remat_mode(cfg: "AudioMambaConfig", batch: int, n_tokens: int,
                       device: torch.device, param_bytes: int) -> str:
    """``remat_mode="auto"``'s rule (the JAX model's): ``"split"`` when its
    estimate, depth x B x L x d_inner x the bytes per element, fits the
    budget, else ``"block"``. The budget is ``AUM_SPLIT_REMAT_BUDGET``
    (bytes) when set; else on a CUDA device its total memory less
    ``SPLIT_REMAT_HEADROOM`` of it and 4x the parameter bytes; on the CPU
    unbounded."""
    budget = os.environ.get("AUM_SPLIT_REMAT_BUDGET")
    if budget is not None:
        budget = float(budget)
    elif device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
        budget = total * (1 - SPLIT_REMAT_HEADROOM) - 4 * param_bytes
    else:
        return "split"
    itemsize = getattr(torch, cfg.dtype).itemsize
    if itemsize not in SPLIT_REMAT_BYTES_PER_ELEMENT:
        raise ValueError(f"remat_mode='auto' has no measured memory figure for {cfg.dtype}; "
                         "pick 'split' or 'block'")
    est = (cfg.depth * batch * n_tokens * 2 * cfg.embed_dim
           * SPLIT_REMAT_BYTES_PER_ELEMENT[itemsize])
    return "split" if est <= budget else "block"


@dataclasses.dataclass(frozen=True)
class TokenDraws:
    """The token order's draws for one forward: the random cls position in
    [0, N] (N patches), the shuffle's permutation of the L tokens, and
    whether the sequence is flipped."""

    cls_position: Optional[int] = None
    perm: Optional[Tuple[int, ...]] = None
    flip: bool = False


def draw_tokens(generator: torch.Generator, n_patches: int, n_tokens: int,
                random_cls: bool, shuffle: bool, flip_prob: float) -> TokenDraws:
    """Draw the cls position, the permutation and the flip on the CPU from
    ``generator``, in that order, each only where asked."""
    pos = (int(torch.randint(0, n_patches + 1, (), generator=generator))
           if random_cls else None)
    perm = (tuple(torch.randperm(n_tokens, generator=generator).tolist())
            if shuffle else None)
    flip = bool(torch.rand((), generator=generator) < flip_prob) if flip_prob > 0 else False
    return TokenDraws(pos, perm, flip)


def drop_path_rates(rate: float, depth: int) -> np.ndarray:
    """Per-layer stochastic-depth rates: [0] + linspace(0, rate, depth)[:-1]
    (layer 0 drops nothing); the final add+norm drops at the full rate."""
    dpr = np.linspace(0.0, rate, depth)
    return np.concatenate([[0.0], dpr[:-1]]).astype(np.float32)


def keep_mask(shape, rate: float, generator: torch.Generator, device):
    """(mask, keep) for drop rate ``rate``: a keep mask of ``shape`` drawn on
    the CPU from ``generator`` (so a seed gives the same masks on every
    device), and the keep probability 1 - rate computed in fp32."""
    keep = float(np.float32(1.0) - np.float32(rate))
    mask = torch.rand(shape, generator=generator) < keep
    return mask.to(device), keep


def _drop(x: torch.Tensor, mask: torch.Tensor, keep: float) -> torch.Tensor:
    """where(mask, x / keep, 0), keep rounded to x's dtype as in the JAX op;
    keep 1 with an all-true mask is an exact identity."""
    scale = torch.tensor(keep, dtype=x.dtype, device=x.device)
    return torch.where(mask, x / scale, torch.zeros((), dtype=x.dtype, device=x.device))


class AudioMamba(nn.Module):
    """AuM classifier."""

    def __init__(self, config: AudioMambaConfig,
                 device: str | torch.device | None = None, seed: int = 0,
                 seq_axis: str | None = None, pipe_axis: str | None = None,
                 pipe_microbatches: int = 4):
        super().__init__()
        device = resolve_device(device)
        cfg = config
        if pipe_axis is not None and seq_axis is not None:
            raise ValueError("pipe_axis and seq_axis cannot be combined")
        self.seq_axis, self.pipe_axis = seq_axis, pipe_axis
        self.pipe_microbatches = pipe_microbatches
        self.mesh = None  # set by parallel/mesh.py::shard_params
        if cfg.if_bidirectional and cfg.depth % 2:
            raise ValueError(f"if_bidirectional pairs the layers: depth {cfg.depth} is odd")
        if cfg.remat_mode not in REMAT_MODES:
            raise ValueError(f"unknown remat_mode: {cfg.remat_mode}")
        self.config = cfg
        self.dtype = getattr(torch, cfg.dtype, None)
        if not isinstance(self.dtype, torch.dtype):
            raise ValueError(f"unknown dtype: {cfg.dtype}")
        d = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.strides, d)
        if cfg.if_cls_token:
            if cfg.use_double_cls_token:
                self.cls_token_head = nn.Parameter(torch.empty((1, 1, d)))
                self.cls_token_tail = nn.Parameter(torch.empty((1, 1, d)))
            else:
                self.cls_token = nn.Parameter(torch.empty((1, 1, d)))
        self.pos_embed = (PosEmbed(cfg.patch_grid, d, cfg.num_prefix_tokens)
                          if cfg.if_abs_pos_embed else None)
        self.layers = nn.ModuleList([
            MambaBlock(d, norm_epsilon=cfg.norm_epsilon,
                       bimamba_type=cfg.bimamba_type, d_state=cfg.d_state,
                       n_layer=cfg.depth, rms_norm=cfg.rms_norm,
                       residual_in_fp32=cfg.residual_in_fp32,
                       if_devide_out=cfg.if_devide_out,
                       init_layer_scale=cfg.init_layer_scale)
            for _ in range(cfg.depth)])
        self.norm_f = _Weights((d,), None if cfg.rms_norm else (d,))
        self.head = _Weights((cfg.num_classes, d), (cfg.num_classes,))
        if cfg.if_rope:
            # Derived from the config: not in the state dict.
            cos, sin = rope_freqs_2d(d // 2, cfg.patch_grid, cfg.patch_grid)
            self.register_buffer("rope_cos", torch.from_numpy(cos), persistent=False)
            self.register_buffer("rope_sin", torch.from_numpy(sin), persistent=False)
        self.reset_parameters(torch.Generator().manual_seed(seed))
        self.to(device)
        self.eval()

    def keep_layers(self, keep) -> None:
        """Keep only the layers of indices ``keep`` (a pipe stage's), under
        their one-card names (``layers.<i>``)."""
        self.layers = nn.ModuleDict({str(i): self.layers[i] for i in keep})

    def _layer_items(self):
        """(index, layer) of the layers this rank holds."""
        if isinstance(self.layers, nn.ModuleDict):
            return [(int(k), v) for k, v in self.layers.items()]
        return list(enumerate(self.layers))

    def _draw_mask(self, shape, rate: float, generator: torch.Generator, device):
        """``keep_mask`` of ``shape``; on a mesh with a 'data' axis the mask of
        the whole global batch is drawn and this rank's rows kept."""
        n = self.mesh.size("data") if self.mesh is not None else 1
        if n == 1:
            return keep_mask(shape, rate, generator, device)
        b = shape[0]
        mask, keep = keep_mask((b * n,) + tuple(shape[1:]), rate, generator, device)
        r = self.mesh.coord("data")
        return mask[r * b:(r + 1) * b], keep

    def _given_mask(self, mask: torch.Tensor, rate: float, bsz: int, device):
        """(mask, keep) from a caller's (B_global,) mask of one layer: this
        rank's rows."""
        r = self.mesh.coord("data") if self.mesh is not None else 0
        keep = float(np.float32(1.0) - np.float32(rate))
        return torch.as_tensor(mask)[r * bsz:(r + 1) * bsz].reshape(bsz, 1, 1).to(device), keep

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.patch_embed.reset_parameters(generator)
        for name in ("cls_token", "cls_token_head", "cls_token_tail"):
            if hasattr(self, name):
                trunc_normal_02_(getattr(self, name), generator)
        if self.pos_embed is not None:
            self.pos_embed.reset_parameters(generator)
        for layer in self.layers:
            layer.reset_parameters(generator)
        nn.init.ones_(self.norm_f.weight)
        if self.norm_f.bias is not None:
            nn.init.zeros_(self.norm_f.bias)
        trunc_normal_02_(self.head.weight, generator)
        nn.init.zeros_(self.head.bias)

    def _insert_cls(self, x: torch.Tensor, position: Optional[int]):
        """Insert the cls token(s): at ``position`` when given (a drawn
        one), else at the config's static place. Returns (tokens, static
        position(s) or None, drawn position or None)."""
        cfg = self.config
        b, n = x.shape[:2]
        if not cfg.if_cls_token:
            return x, None, None
        if cfg.use_double_cls_token:
            head = self.cls_token_head.to(x.dtype).expand(b, -1, -1)
            tail = self.cls_token_tail.to(x.dtype).expand(b, -1, -1)
            return torch.cat([head, x, tail], dim=1), [0, n + 1], None
        if position is not None:
            tp = position
        elif cfg.use_middle_cls_token:
            tp = n // 2
        elif cfg.use_end_cls_token:
            tp = n
        else:
            tp = 0
        cls = self.cls_token.to(x.dtype).expand(b, -1, -1)
        x = torch.cat([x[:, :tp], cls, x[:, tp:]], dim=1)
        return (x, None, tp) if position is not None else (x, tp, None)

    def _block(self, layer, hidden, residual, drop, split_remat, rope=True):
        cfg = self.config
        if rope and cfg.if_rope:
            n_prefix = cfg.num_prefix_tokens
            hidden = apply_rope(hidden, self.rope_cos, self.rope_sin, n_prefix)
            if cfg.if_rope_residual:
                residual = apply_rope(residual, self.rope_cos, self.rope_sin, n_prefix)
        if drop is not None:
            hidden = _drop(hidden, *drop)
        return layer(hidden, residual, self.dtype, split_remat=split_remat)

    def _pair(self, fwd, bwd, hidden, residual, drops, split_remat):
        """``if_bidirectional``'s layer pair: ``bwd`` runs on the reversed
        sequence, each layer dropping its own incoming hidden (the JAX
        ``_BlockPair``; a per-sample mask commutes with the flip; ``drops``
        None: neither drops). No RoPE, as in JAX."""
        drops = drops if drops is not None else (None, None)
        h_f, r_f = self._block(fwd, hidden, residual, drops[0], split_remat, rope=False)
        h_b, r_b = self._block(bwd, hidden.flip(1), residual.flip(1), drops[1], split_remat,
                               rope=False)
        return h_f + h_b.flip(1), r_f + r_b.flip(1)

    def _pipelined(self) -> bool:
        return (self.pipe_axis is not None and self.mesh is not None
                and self.mesh.size(self.pipe_axis) > 1)

    def remat_mode(self, batch: int, n_tokens: int) -> str:
        """The remat mode a grad-taking forward of (batch, n_tokens) runs."""
        cfg = self.config
        if not cfg.remat:
            return "none"
        if cfg.remat_mode != "auto":
            return cfg.remat_mode
        param_bytes = sum(p.numel() * p.element_size() for p in self.parameters())
        return resolve_remat_mode(cfg, batch, n_tokens, self.head.weight.device, param_bytes)

    def forward(self, x: torch.Tensor,
                train: bool = False, patch_size=None, strides=None,
                if_random_cls_token_position: bool = False,
                if_random_token_rank: bool = False,
                flip_sequence_prob: float = 0.0,
                generator: torch.Generator | None = None,
                token_draws: TokenDraws | None = None,
                drop_masks: tuple | None = None) -> torch.Tensor:
        """x: (B, T, F) log-mel -> logits (B, num_classes) in the compute dtype.

        ``patch_size`` / ``strides`` run the model at another patch size
        (the kernel PI-resized, the pos grid resampled; strides default to
        the stored ones in the embedding and to the patch size in the grid,
        as in JAX: pass both). ``train`` turns on drop path and pos dropout
        (when their rates are not 0), with masks drawn from ``generator``.
        The random cls position, the token shuffle and the flip (with
        probability ``flip_sequence_prob``) take ``token_draws``, or draw
        them from ``generator``. ``drop_masks`` = (per-layer (depth,
        B_global) bool, final (B_global,) bool) takes the drop-path masks
        from the caller instead of drawing them. Eval callers run it under
        ``torch.inference_mode()``.
        """
        cfg = self.config
        dtype = self.dtype
        use_dp = train and cfg.drop_path_rate > 0
        use_pos_drop = train and cfg.drop_rate > 0 and self.pos_embed is not None
        random_cls = (if_random_cls_token_position and cfg.if_cls_token
                      and not cfg.use_double_cls_token)
        stochastic = random_cls or if_random_token_rank or flip_sequence_prob > 0
        if ((use_dp and drop_masks is None) or use_pos_drop
                or (stochastic and token_draws is None)) and generator is None:
            raise ValueError("a drop rate or a stochastic token order needs a torch.Generator")
        run_grid = None
        if patch_size is not None or strides is not None:
            rp = to_2tuple(patch_size if patch_size is not None else cfg.patch_size)
            rs = to_2tuple(strides if strides is not None else rp)
            run_grid = patch_grid_shape(rs, rp, *cfg.spectrogram_size)
        x = self.patch_embed(x.transpose(1, 2), dtype, patch_size, strides)
        n = x.shape[1]
        grid = run_grid if run_grid is not None else cfg.patch_grid
        if stochastic and token_draws is None:
            token_draws = draw_tokens(generator, n, n + cfg.num_prefix_tokens, random_cls,
                                      if_random_token_rank, flip_sequence_prob)
        draws = token_draws if stochastic else TokenDraws()
        x, token_position, dyn_position = self._insert_cls(
            x, draws.cls_position if random_cls else None)
        if self.pos_embed is not None:
            x = self.pos_embed(x, token_position if dyn_position is None else dyn_position,
                               run_grid)
            if use_pos_drop:
                x = _drop(x, *self._draw_mask(x.shape, cfg.drop_rate, generator, x.device))
        if cfg.transpose_token_sequence:
            # Before the shuffle and the flip, in the reference's order.
            x = _transpose_tokens(x, grid, token_position)
        if if_random_token_rank:
            perm = list(draws.perm)
            x = x[:, torch.tensor(perm, device=x.device)]
            token_position, dyn_position = _track_shuffle(perm, token_position, dyn_position)
        if flip_sequence_prob > 0 and draws.flip:
            x = x.flip(1)
            token_position, dyn_position = _track_flip(x.shape[1], token_position,
                                                       dyn_position)

        # Every mask is drawn here, outside the checkpointed regions.
        bsz = x.shape[0]
        drops = [None] * cfg.depth
        if use_dp:
            rates = drop_path_rates(cfg.drop_path_rate, cfg.depth)
            if drop_masks is not None:
                drops = [self._given_mask(drop_masks[0][i], r, bsz, x.device)
                         for i, r in enumerate(rates)]
                final_drop = self._given_mask(drop_masks[1], cfg.drop_path_rate, bsz, x.device)
            else:
                drops = [self._draw_mask((bsz, 1, 1), r, generator, x.device) for r in rates]
                final_drop = self._draw_mask((bsz, 1, 1), cfg.drop_path_rate, generator,
                                             x.device)
        mode = self.remat_mode(bsz, x.shape[1]) if torch.is_grad_enabled() else "none"

        hidden = x
        residual = torch.zeros(x.shape, device=x.device,
                               dtype=torch.float32 if cfg.residual_in_fp32 else dtype)
        # One unit per layer, or per layer pair with if_bidirectional.
        items = self._layer_items()
        if cfg.if_bidirectional:
            step = self._pair
            units = [((items[j][1], items[j + 1][1]), drops[items[j][0]:items[j][0] + 2])
                     for j in range(0, len(items), 2)]
        else:
            step = self._block
            units = [((layer,), drops[i]) for i, layer in items]

        def run_unit(unit, hidden, residual, drop):
            if mode == "block":
                return checkpoint(step, *unit, hidden, residual, drop, False,
                                  use_reentrant=False)
            return step(*unit, hidden, residual, drop, mode == "split")

        if self._pipelined():
            mesh = self.mesh
            mods = [u for u, _ in units]
            if use_dp:
                m = microbatch_count(bsz, self.pipe_microbatches)
                stage_fn = block_stage_fn_dp(mods, run_unit, [d for _, d in units], m)
            else:
                stage_fn = block_stage_fn(mods, run_unit)
            hidden, residual = pipeline_apply(stage_fn, (hidden, residual), mesh.group("pipe"),
                                              mesh.group_ranks["pipe"], self.pipe_microbatches)
        else:
            for unit, drop in units:
                hidden, residual = run_unit(unit, hidden, residual, drop)
        if use_dp:
            hidden = _drop(hidden, *final_drop)
        hidden = fused_add_norm(hidden, self.norm_f.weight.to(dtype), self.norm_f.bias,
                                residual=residual, prenorm=False, eps=cfg.norm_epsilon,
                                norm_type="rms" if cfg.rms_norm else "layer",
                                residual_in_fp32=cfg.residual_in_fp32)

        if cfg.if_cls_token:
            if cfg.use_double_cls_token:
                feats = (hidden[:, token_position[0]]
                         + hidden[:, token_position[1]]) / 2
            elif dyn_position is not None:
                feats = hidden[:, dyn_position]
            else:
                feats = hidden[:, token_position]
        elif cfg.final_pool_type == "none":
            feats = hidden[:, -1]
        elif cfg.final_pool_type == "mean":
            feats = hidden.mean(dim=1)
        elif cfg.final_pool_type in ("max", "all"):
            feats = hidden
        else:
            raise NotImplementedError(cfg.final_pool_type)
        logits = (feats.to(dtype) @ self.head.weight.to(dtype).t()
                  + self.head.bias.to(dtype))
        if cfg.final_pool_type == "max" and not cfg.if_cls_token:
            logits = logits.max(dim=1).values
        return logits


def _track_shuffle(perm: Sequence[int], token_position, dyn_position):
    """Positions after ``x -> x[:, perm]``: the token formerly at p now sits
    at perm's index of p. Double-cls list positions are tracked one by one;
    a scalar position (static or drawn; 0 without a cls token) becomes the
    drawn one. Returns (token_position, dyn_position)."""
    where = {p: i for i, p in enumerate(perm)}
    if isinstance(token_position, list):
        return [where[p] for p in token_position], dyn_position
    pos0 = (dyn_position if dyn_position is not None
            else (token_position if token_position is not None else 0))
    return token_position, where[pos0]


def _track_flip(n_tok: int, token_position, dyn_position):
    """Positions after the whole-sequence flip: p -> n_tok - 1 - p. JAX
    leaves the static double-cls pair [0, n_tok - 1] alone and retargets a
    shuffled one; retargeting both is the same, as the pair maps onto itself
    and the readout sums it. Returns (token_position, dyn_position)."""
    if isinstance(token_position, list):
        return [n_tok - 1 - p for p in token_position], dyn_position
    if dyn_position is not None:
        return token_position, n_tok - 1 - dyn_position
    if token_position is not None:
        return token_position, n_tok - 1 - token_position
    return token_position, dyn_position


def _transpose_tokens(x: torch.Tensor, grid, token_position) -> torch.Tensor:
    """Reorder grid tokens from F-major to T-major, keeping the cls token(s)
    at their position(s)."""
    gh, gw = grid

    def flip_grid(body):
        b, n, d = body.shape
        return body.reshape(b, gh, gw, d).transpose(1, 2).reshape(b, n, d)

    if token_position is None:
        return flip_grid(x)
    if isinstance(token_position, (list, tuple)):
        return torch.cat([x[:, :1], flip_grid(x[:, 1:-1]), x[:, -1:]], dim=1)
    tp = int(token_position)
    body = flip_grid(torch.cat([x[:, :tp], x[:, tp + 1:]], dim=1))
    return torch.cat([body[:, :tp], x[:, tp:tp + 1], body[:, tp:]], dim=1)
