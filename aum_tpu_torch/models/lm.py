"""Mamba language model, prefill, decoding and sampling.

Counterpart of ``aum_tpu/models/lm.py`` (the reference's
``mixer_seq_simple.py`` and ``utils/generation.py``):

- ``MambaLM``: embedding -> n_layer x (fused add + RMSNorm with an fp32
  residual -> causal Mamba mixer) -> final norm -> lm head tied to the
  embedding, over the vocabulary padded to a multiple of
  ``pad_vocab_size_multiple``. Its module tree and state-dict keys are the
  reference ``MambaLMHeadModel``'s (``backbone.embedding.weight``,
  ``backbone.layers.{i}.norm.weight``, ``backbone.layers.{i}.mixer.*``,
  ``backbone.norm_f.weight``; the tied ``lm_head.weight`` is not stored).
  The mixer is ``models/mamba.py``'s with ``bimamba_type="none"``: the conv
  kernel and the single-direction scan kernel on the card.
- ``prefill``: one parallel pass over the prompt that builds the decode
  caches: each layer's SSM state is the scan's final state (the carried-state
  form of the single-direction scan kernel, ``return_final_state=True``) and
  its conv cache the last d_conv pre-conv inputs, oldest first, left-padded
  with zeros for a prompt shorter than d_conv.
- ``decode_step``: one token through every layer on the caches, with
  ``ops.causal_conv1d_update`` and ``ops.selective_state_update`` (plain
  PyTorch, as neither is a kernel in the JAX package); the conv, the x and dt
  projections and the state update run in fp32 there, as in the JAX step.
- ``generate``: prefill, then one ``decode_step`` per new token, each token
  drawn by ``sample_token``: the padded vocabulary masked, the repetition
  penalty, then greedy at temperature 0, else temperature, top-k and top-p
  (the ``cum < top_p`` cutoff), and a categorical draw as argmax(logits +
  Gumbel noise), the noise drawn by ``draw_sample_noise`` from an explicit
  ``torch.Generator``.
- ``save_pretrained`` / ``load_pretrained``: the JAX package's directory
  format, ``config.json`` and a ``weights.pkl`` of numpy arrays in its
  stacked parameter tree, so a directory saved by either package loads in
  the other; ``port_lm_state_dict`` maps a reference state dict to that tree,
  ``convert.lm_state_dict_from_jax`` back. ``from_pretrained_hf`` reads a
  local HF-format directory (``config.json`` + ``pytorch_model.bin``), or a
  hub id from the local HF cache (``hub_cached_file``; nothing is
  downloaded).

On a CUDA device the kernels take any d_state (the scan kernels run it in
slices of 16 states) and any d_conv (past 8 the conv kernel's general
form); ``check_kernel_limits`` raises at construction for a size of 0,
which no kernel takes. On the CPU the plain path takes any config.
``MambaLMConfig.use_kernel`` is read from the JAX package's ``config.json``
files and has no effect here: the device decides.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import pickle
from typing import Optional

import numpy as np
import torch
from torch import nn

from aum_tpu_torch.models.mamba import MambaBlock, _Weights
from aum_tpu_torch.ops import (
    causal_conv1d_update,
    fused_add_norm,
    selective_scan,
    selective_state_update,
)
from aum_tpu_torch.utils import resolve_device


@dataclasses.dataclass(frozen=True)
class MambaLMConfig:
    """The reference's ``MambaConfig``; defaults are ``mamba-130m``'s widths."""

    d_model: int = 768
    n_layer: int = 24
    vocab_size: int = 50277
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    pad_vocab_size_multiple: int = 8
    norm_epsilon: float = 1e-5
    dtype: str = "float32"
    # The JAX package's kernel switch, kept so its config.json loads; unused.
    use_kernel: Optional[bool] = None

    @property
    def padded_vocab(self) -> int:
        m = self.pad_vocab_size_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return math.ceil(self.d_model / 16)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def check_kernel_limits(cfg: MambaLMConfig, device: torch.device) -> None:
    """Raise ``ValueError`` on a CUDA device for a config the kernels do not
    take: a d_conv or d_state below 1 (every positive size runs)."""
    if torch.device(device).type != "cuda":
        return
    for name in ("d_conv", "d_state"):
        if getattr(cfg, name) < 1:
            raise ValueError(f"{name}={getattr(cfg, name)}: the kernels take sizes from 1")


class _Backbone(nn.Module):
    def __init__(self, cfg: MambaLMConfig):
        super().__init__()
        self.embedding = _Weights((cfg.padded_vocab, cfg.d_model))
        self.layers = nn.ModuleList(
            MambaBlock(cfg.d_model, cfg.norm_epsilon, bimamba_type="none", d_state=cfg.d_state,
                       n_layer=cfg.n_layer, d_conv=cfg.d_conv, expand=cfg.expand)
            for _ in range(cfg.n_layer))
        self.norm_f = _Weights((cfg.d_model,))


class MambaLM(nn.Module):
    """The Mamba LM with a tied head; weights drawn from ``seed`` on the CPU
    and moved to ``device`` (CUDA unless the caller names another)."""

    def __init__(self, config: MambaLMConfig, device: str | torch.device | None = None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        check_kernel_limits(config, device)
        self.config = config
        self.backbone = _Backbone(config)
        self.reset_parameters(torch.Generator().manual_seed(seed))
        self.to(device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.backbone.embedding.weight, std=0.02, generator=generator)
        for layer in self.backbone.layers:
            layer.reset_parameters(generator)
        nn.init.ones_(self.backbone.norm_f.weight)

    def _embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.backbone.embedding.weight[input_ids].to(self.config.torch_dtype)

    def _head(self, hidden: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        dtype = self.config.torch_dtype
        out = fused_add_norm(hidden, self.backbone.norm_f.weight.to(dtype), residual=residual,
                             prenorm=False, eps=self.config.norm_epsilon)
        return out.to(dtype) @ self.backbone.embedding.weight.to(dtype).t()

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids (B, L) -> logits (B, L, padded_vocab) in the config's dtype."""
        dtype = self.config.torch_dtype
        hidden = self._embed(input_ids)
        residual = None  # the first add starts the fp32 residual stream
        for layer in self.backbone.layers:
            hidden, residual = layer(hidden, residual, dtype)
        return self._head(hidden, residual)


def init_decode_state(cfg: MambaLMConfig, batch: int,
                      device: str | torch.device = "cpu") -> dict:
    """Zero caches: 'conv' (n_layer, B, d_inner, d_conv) and 'ssm' (n_layer,
    B, d_inner, d_state), fp32."""
    return {"conv": torch.zeros((cfg.n_layer, batch, cfg.d_inner, cfg.d_conv), device=device),
            "ssm": torch.zeros((cfg.n_layer, batch, cfg.d_inner, cfg.d_state), device=device)}


@torch.inference_mode()
def prefill(model: MambaLM, input_ids: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """The prompt (B, L) in one parallel pass -> (last-position logits (B,
    padded_vocab), decode state as ``init_decode_state`` gives it)."""
    cfg = model.config
    dtype = cfg.torch_dtype
    seqlen = input_ids.shape[1]
    kpad = max(cfg.d_conv - seqlen, 0)
    d_in = cfg.d_inner
    hidden = model._embed(input_ids)
    residual = None  # the first add starts the fp32 residual stream
    convs, ssms = [], []
    for layer in model.backbone.layers:
        mixer = layer.mixer
        normed, residual = fused_add_norm(hidden, layer.norm.weight.to(dtype), residual=residual,
                                          eps=cfg.norm_epsilon)
        xz = normed @ mixer.in_proj.weight.to(dtype).t()
        xs, z = xz[..., :d_in], xz[..., d_in:]
        u, delta, bm, cm, _ = mixer._branch(xs, "", reverse_conv=False, fold=False)
        y, ssm = selective_scan(u, delta, -torch.exp(mixer.A_log.float()), bm, cm,
                                mixer.D.float(), z, delta_bias=mixer.dt_proj.bias.float(),
                                delta_softplus=True, return_final_state=True)
        # The conv cache: the last d_conv pre-conv inputs, oldest first.
        tail = torch.nn.functional.pad(xs[:, seqlen - (cfg.d_conv - kpad):].float(),
                                       (0, 0, kpad, 0))
        convs.append(tail.transpose(1, 2))
        ssms.append(ssm)
        hidden = y @ mixer.out_proj.weight.to(dtype).t()
    logits = model._head(hidden[:, -1], residual[:, -1])
    return logits, {"conv": torch.stack(convs), "ssm": torch.stack(ssms)}


@torch.inference_mode()
def decode_step(model: MambaLM, token: torch.Tensor, state: dict) -> tuple[torch.Tensor, dict]:
    """One token (B,) on the caches -> (logits (B, padded_vocab), new caches)."""
    cfg = model.config
    dtype = cfg.torch_dtype
    d_in, r, n = cfg.d_inner, cfg.dt_rank, cfg.d_state
    hidden = model._embed(token)
    residual = None  # the first add starts the fp32 residual stream
    convs, ssms = [], []
    for i, layer in enumerate(model.backbone.layers):
        mixer = layer.mixer
        normed, residual = fused_add_norm(hidden, layer.norm.weight.to(dtype), residual=residual,
                                          eps=cfg.norm_epsilon)
        xz = normed @ mixer.in_proj.weight.to(dtype).t()
        xs, z = xz[..., :d_in], xz[..., d_in:]
        xc, conv = causal_conv1d_update(xs.float(), state["conv"][i],
                                        mixer.conv1d.weight[:, 0], mixer.conv1d.bias)
        x_dbl = xc @ mixer.x_proj.weight.t()
        dt = x_dbl[..., :r] @ mixer.dt_proj.weight.t()
        y, ssm = selective_state_update(
            state["ssm"][i], xc, dt, -torch.exp(mixer.A_log.float()), x_dbl[..., r:r + n],
            x_dbl[..., r + n:], mixer.D, z=z, dt_bias=mixer.dt_proj.bias, dt_softplus=True)
        convs.append(conv)
        ssms.append(ssm)
        hidden = y.to(dtype) @ mixer.out_proj.weight.to(dtype).t()
    return model._head(hidden, residual), {"conv": torch.stack(convs), "ssm": torch.stack(ssms)}


def draw_sample_noise(generator: torch.Generator, shape: tuple) -> torch.Tensor:
    """Standard Gumbel noise of ``shape`` (fp32, on the generator's device):
    a categorical draw is argmax(logits + noise)."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(torch.clamp(u, tiny, 1.0 - 2 ** -24)))


def sample_token(logits: torch.Tensor, prev_tokens: torch.Tensor | None,
                 noise: torch.Tensor | None, temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 1.0, repetition_penalty: float = 1.0,
                 vocab_size: int | None = None) -> torch.Tensor:
    """The next token (B,) from logits (B, V): padded-vocab rows (ids >=
    ``vocab_size``) masked, the repetition penalty on the ids in
    ``prev_tokens`` (B, L), then argmax at temperature 0, else temperature,
    top-k, top-p and argmax(logits + ``noise``)."""
    logits = logits.float()
    v = logits.shape[-1]
    if vocab_size is not None and vocab_size < v:
        pad = torch.arange(v, device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad[None], -math.inf)
    if repetition_penalty != 1.0 and prev_tokens is not None:
        seen = torch.zeros_like(logits, dtype=torch.bool).scatter_(1, prev_tokens, True)
        penalized = torch.where(logits > 0, logits / repetition_penalty,
                                logits * repetition_penalty)
        logits = torch.where(seen, penalized, logits)
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    logits = logits / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, -math.inf)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True).clamp_max(v - 1)
        cutoff = torch.gather(sorted_logits, 1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, -math.inf)
    return (logits + noise).argmax(dim=-1)


def generate(model: MambaLM, input_ids: torch.Tensor, max_new_tokens: int,
             generator: torch.Generator | None = None, temperature: float = 1.0,
             top_k: int = 0, top_p: float = 1.0,
             repetition_penalty: float = 1.0) -> torch.Tensor:
    """Prefill, then one decode step per new token. Returns (B, L +
    max_new_tokens) token ids. ``generator`` (on the prompt's device; seeded
    0 when not given) draws the sampling noise; greedy decoding
    (temperature 0) draws none."""
    cfg = model.config
    if generator is None:
        generator = torch.Generator(input_ids.device).manual_seed(0)
    logits, state = prefill(model, input_ids)
    tokens = input_ids
    for i in range(max_new_tokens):
        noise = (None if temperature == 0.0
                 else draw_sample_noise(generator, tuple(logits.shape)))
        nxt = sample_token(logits, tokens, noise, temperature, top_k, top_p,
                           repetition_penalty, cfg.vocab_size)
        tokens = torch.cat([tokens, nxt[:, None]], dim=1)
        if i + 1 < max_new_tokens:
            logits, state = decode_step(model, nxt, state)
    return tokens


# --- checkpoints ---------------------------------------------------------------


def port_lm_state_dict(sd: dict, cfg: MambaLMConfig) -> dict:
    """A reference ``MambaLMHeadModel`` state dict (tensors or arrays; the
    port's own has the same keys) -> the JAX package's parameter tree,
    ``{'params': {...}}`` of fp32 numpy arrays: matmul weights transposed to
    (in, out), the in_proj rows split into the x and z halves, the conv's
    channel axis dropped, the layers stacked on a leading axis."""
    d_in = cfg.d_inner

    def arr(key):
        v = sd[key]
        return (v.detach().float().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v, np.float32))

    def stack(name, f):
        return np.stack([f(arr(f"backbone.layers.{i}.{name}")) for i in range(cfg.n_layer)])

    t = np.transpose
    params = {
        "embedding": arr("backbone.embedding.weight"),
        "norm_f_weight": arr("backbone.norm_f.weight"),
        "norm_weight": stack("norm.weight", lambda w: w),
        "in_proj_x": stack("mixer.in_proj.weight", lambda w: t(w[:d_in])),
        "in_proj_z": stack("mixer.in_proj.weight", lambda w: t(w[d_in:])),
        "conv_w": stack("mixer.conv1d.weight", lambda w: w[:, 0, :]),
        "conv_b": stack("mixer.conv1d.bias", lambda w: w),
        "x_proj": stack("mixer.x_proj.weight", t),
        "dt_w": stack("mixer.dt_proj.weight", t),
        "dt_b": stack("mixer.dt_proj.bias", lambda w: w),
        "A_log": stack("mixer.A_log", lambda w: w),
        "D": stack("mixer.D", lambda w: w),
        "out_proj": stack("mixer.out_proj.weight", t),
    }
    if params["embedding"].shape != (cfg.padded_vocab, cfg.d_model):
        raise ValueError(f"embedding {params['embedding'].shape} is not "
                         f"({cfg.padded_vocab}, {cfg.d_model})")
    return {"params": {k: np.ascontiguousarray(v, np.float32) for k, v in params.items()}}


def save_pretrained(model: MambaLM, directory: str) -> None:
    """config.json + weights.pkl (numpy, the JAX package's tree)."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(model.config), f, indent=2)
    with open(os.path.join(directory, "weights.pkl"), "wb") as f:
        pickle.dump(port_lm_state_dict(model.state_dict(), model.config), f)


def load_pretrained(directory: str, device: str | torch.device | None = None) -> MambaLM:
    """A directory written by ``save_pretrained`` of either package ->
    ``MambaLM`` on ``device``."""
    from aum_tpu_torch.convert import lm_state_dict_from_jax

    with open(os.path.join(directory, "config.json")) as f:
        cfg = MambaLMConfig(**json.load(f))
    with open(os.path.join(directory, "weights.pkl"), "rb") as f:
        params = pickle.load(f)
    model = MambaLM(cfg, device=device)
    model.load_state_dict(lm_state_dict_from_jax(params, cfg))
    return model


CONFIG_NAME = "config.json"
WEIGHTS_NAME = "pytorch_model.bin"


def hub_cache_dir() -> str:
    """The local HF hub cache, in huggingface_hub's order: ``$HF_HUB_CACHE``,
    else ``$HF_HOME/hub``, else ``$XDG_CACHE_HOME/huggingface/hub``, else
    ``~/.cache/huggingface/hub``; read at every call."""
    if os.environ.get("HF_HUB_CACHE"):
        return os.path.expanduser(os.environ["HF_HUB_CACHE"])
    if os.environ.get("HF_HOME"):
        return os.path.join(os.path.expanduser(os.environ["HF_HOME"]), "hub")
    xdg = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return os.path.join(xdg, "huggingface", "hub")


def hub_cached_file(repo_id: str, filename: str) -> str:
    """The path of ``filename`` of model ``repo_id`` in the local HF cache:
    ``models--{org}--{name}/refs/main`` names the snapshot's hash, the file
    is ``snapshots/<hash>/{filename}``. Raises ``FileNotFoundError`` when it
    is not there: nothing is downloaded."""
    repo = os.path.join(hub_cache_dir(), "models--" + repo_id.replace("/", "--"))
    ref = os.path.join(repo, "refs", "main")
    commit = ""
    if os.path.isfile(ref):
        with open(ref) as f:
            commit = f.read().strip()
    path = os.path.join(repo, "snapshots", commit, filename)
    if not commit or not os.path.isfile(path):
        raise FileNotFoundError(
            f"{filename} of {repo_id!r} is not in the local HF cache (looked for {path}); "
            "from_pretrained_hf reads a local directory or this cache and downloads nothing")
    return path


def from_pretrained_hf(path: str, device: str | torch.device | None = None) -> MambaLM:
    """A local HF-format directory (``config.json`` + ``pytorch_model.bin``,
    the reference ``MambaLMHeadModel``'s state dict), or a hub id such as
    ``state-spaces/mamba-130m`` whose two files are in the local HF cache
    (``hub_cached_file``), -> ``MambaLM``. A hub id not in the cache raises
    ``FileNotFoundError``: this package downloads nothing."""
    if os.path.isdir(path):
        config_file = os.path.join(path, CONFIG_NAME)
        weights_file = os.path.join(path, WEIGHTS_NAME)
    else:
        config_file = hub_cached_file(path, CONFIG_NAME)
        weights_file = hub_cached_file(path, WEIGHTS_NAME)
    with open(config_file) as f:
        raw = json.load(f)
    cfg = MambaLMConfig(d_model=raw["d_model"], n_layer=raw["n_layer"],
                        vocab_size=raw["vocab_size"],
                        pad_vocab_size_multiple=raw.get("pad_vocab_size_multiple", 8),
                        **{k: raw[k] for k in ("d_state", "d_conv", "expand") if k in raw})
    sd = torch.load(weights_file, map_location="cpu", weights_only=True)
    sd = {k: v.float() for k, v in sd.items() if k != "lm_head.weight"}  # the head is tied
    model = MambaLM(cfg, device=device)
    model.load_state_dict(sd)
    return model
