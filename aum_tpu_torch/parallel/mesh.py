"""The mesh of ranks and the tensor- and pipeline-parallel parameter layout.

Counterpart of ``aum_tpu/parallel/mesh.py``. JAX lays a device mesh over one
controller; the port runs one process per rank, and ``make_mesh`` gives each
process its place in the mesh: the axis sizes in JAX's order ``('data',
'pipe', 'seq', 'model')``, the innermost axis fastest (rank = ((data · P +
pipe) · S + seq) · T + model), this rank's coordinate on each axis and one
process group per axis (the ranks that differ from this one on that axis
only). Every rank creates every group, in the same order, as
``torch.distributed.new_group`` requires. Without a process group (one
process) every axis has size 1 and no group.

Ranks are laid out node-major, as torchrun numbers them: contiguous ranks
share a node, so the inner axes' groups stay inside one node as long as
their product divides the ranks per node (``node_major_ranks`` raises where
it does not, as JAX's ``_ici_major_order`` does for a slice).

Tensor parallelism shards the Mamba mixers' d_inner over 'model'
(``D_INNER_AXIS``, the counterpart of ``_MIXER_D_INNER_AXIS`` on this
package's reference-layout names). ``in_proj.weight`` is one (2·d_inner,
d_model) tensor with rows [x; z], so a rank's shard is two row blocks,
[r·d/T, (r+1)·d/T) and d + [r·d/T, (r+1)·d/T): the x and z halves stay local
to the rank's channels (JAX stores the halves apart for that reason).
``x_proj`` shards on its input axis, ``dt_proj`` on its output axis, and
``A_log``, ``A_b_log``, ``D``, ``D_b``, the convs and ``out_proj`` (input
axis) on the channels. Pipeline parallelism gives each stage its depth/P
layers (pairs stay whole with ``if_bidirectional``). The model is
initialised whole, exactly as on one card, and then sliced (``shard_params``),
so its init does not depend on the mesh; ``gather_state_dict`` is the
inverse, and ``shard_state_dict`` slices a one-card state dict for this rank.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import re
from typing import Dict, Optional

import torch
import torch.distributed as dist

from aum_tpu_torch.parallel import collectives

AXES = ("data", "pipe", "seq", "model")

# Mixer leaves that carry d_inner: name within the mixer -> the d_inner axis.
D_INNER_AXIS = {
    "in_proj.weight": 0,      # (2·d_inner, d_model): two row blocks, [x; z]
    "conv1d.weight": 0,       # (d_inner, 1, K)
    "conv1d.bias": 0,
    "conv1d_b.weight": 0,
    "conv1d_b.bias": 0,
    "x_proj.weight": 1,       # (R + 2N, d_inner)
    "x_proj_b.weight": 1,
    "dt_proj.weight": 0,      # (d_inner, R)
    "dt_proj_b.weight": 0,
    "dt_proj.bias": 0,
    "dt_proj_b.bias": 0,
    "A_log": 0,               # (d_inner, N)
    "A_b_log": 0,
    "D": 0,
    "D_b": 0,
    "out_proj.weight": 1,     # (d_model, d_inner)
}
_HALVES = {"in_proj.weight"}
_MIXER_KEY = re.compile(r"layers\.(\d+)\.mixer\.(.+)")
_LAYER_KEY = re.compile(r"layers\.(\d+)\.(.+)")


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """How one parameter is split over 'model': along ``dim`` (None:
    replicated), in ``blocks`` equal blocks each split on its own (in_proj's
    x and z). Under 'pipe' a layer's parameters live on its stage."""

    dim: Optional[int] = None
    blocks: int = 1


@dataclasses.dataclass
class Mesh:
    """This rank's place in the mesh: ``shape`` (axis -> size, JAX's order),
    ``coords`` (axis -> this rank's index), ``groups`` (axis -> process
    group, None without ``torch.distributed``) and ``group_ranks`` (axis ->
    the global ranks of that group, in order)."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, object]
    group_ranks: Dict[str, tuple]
    rank: int = 0
    world: int = 1

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def coord(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self.groups[axis]

    @property
    def axis_names(self) -> tuple:
        """The axes JAX's mesh would carry: data and model always, pipe and
        seq when larger than 1."""
        return tuple(a for a in AXES if a in ("data", "model") or self.shape[a] > 1)

    @property
    def distributed(self) -> bool:
        return self.groups["data"] is not None


def rank_of(shape: Dict[str, int], coords: Dict[str, int]) -> int:
    r = 0
    for a in AXES:
        r = r * shape[a] + coords[a]
    return r


def coords_of(shape: Dict[str, int], rank: int) -> Dict[str, int]:
    out = {}
    for a in reversed(AXES):
        out[a] = rank % shape[a]
        rank //= shape[a]
    return {a: out[a] for a in AXES}


def node_major_ranks(world: int, per_node: int, n_inner: int) -> list:
    """The ranks in mesh order: node-major, as torchrun numbers them, so each
    group of ``n_inner`` contiguous ranks shares a node provided
    ``n_inner`` divides the ranks per node. Raises where it does not on a
    run of several nodes: a 'model' group would then span the network."""
    if per_node < world and per_node % n_inner:
        raise ValueError(
            f"n_model={n_inner} does not divide the {per_node} ranks per node: a 'model' group "
            "would span nodes. Pick a model-axis size that fits within one node.")
    return list(range(world))


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, n_seq: int = 1,
              n_pipe: int = 1) -> Mesh:
    """This process's mesh of ``torch.distributed``'s world (one process
    without it). ``n_data`` defaults to the world over the other axes; the
    sizes must multiply to the world."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_data is None:
        n_data = world // (n_model * n_seq * n_pipe)
    if n_data * n_pipe * n_seq * n_model != world or min(n_data, n_pipe, n_seq, n_model) < 1:
        raise ValueError(f"mesh data {n_data} x pipe {n_pipe} x seq {n_seq} x model {n_model} "
                         f"does not cover the world of {world} rank(s)")
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    node_major_ranks(world, per_node, n_model * n_seq * n_pipe)
    shape = {"data": n_data, "pipe": n_pipe, "seq": n_seq, "model": n_model}
    coords = coords_of(shape, rank)
    groups = {a: None for a in AXES}
    group_ranks = {a: (rank,) for a in AXES}
    if dist.is_initialized():
        for axis in AXES:
            others = [a for a in AXES if a != axis]
            for fixed in itertools.product(*(range(shape[a]) for a in others)):
                c = dict(zip(others, fixed))
                ranks = tuple(rank_of(shape, {**c, axis: i}) for i in range(shape[axis]))
                group = dist.new_group(list(ranks))
                if rank in ranks:
                    groups[axis], group_ranks[axis] = group, ranks
    return Mesh(shape, coords, groups, group_ranks, rank, world)


# --- the layout ---------------------------------------------------------------------


def _spec(name: str) -> ShardSpec:
    m = _MIXER_KEY.fullmatch(name)
    if m and m.group(2) in D_INNER_AXIS:
        leaf = m.group(2)
        return ShardSpec(D_INNER_AXIS[leaf], 2 if leaf in _HALVES else 1)
    return ShardSpec()


def param_partition_specs(names) -> Dict[str, ShardSpec]:
    """name -> ShardSpec for state-dict ``names``: TP over d_inner."""
    return {k: _spec(k) for k in names}


def _shard(t: torch.Tensor, spec: ShardSpec, n: int, r: int) -> torch.Tensor:
    if spec.dim is None or n == 1:
        return t
    blocks = t.chunk(spec.blocks, dim=spec.dim)
    return torch.cat([b.chunk(n, dim=spec.dim)[r] for b in blocks], dim=spec.dim)


def _unshard(parts: list, spec: ShardSpec) -> torch.Tensor:
    if spec.dim is None or len(parts) == 1:
        return parts[0]
    per_rank = [p.chunk(spec.blocks, dim=spec.dim) for p in parts]
    return torch.cat([torch.cat([pr[b] for pr in per_rank], dim=spec.dim)
                      for b in range(spec.blocks)], dim=spec.dim)


def stage_layers(depth: int, n_stages: int, stage: int, pair: bool = False) -> range:
    """The layer indices of pipe stage ``stage``: depth/P contiguous layers
    (``pair``: whole layer pairs, depth/2 pairs over P stages)."""
    unit = 2 if pair else 1
    if (depth // unit) % n_stages or depth % unit:
        raise ValueError(f"depth {depth} does not split into {n_stages} stages"
                         + (" of whole layer pairs" if pair else ""))
    n = depth // n_stages
    return range(stage * n, (stage + 1) * n)


def shard_state_dict(full: Dict[str, torch.Tensor], mesh: Mesh, keep=None) -> Dict[str, torch.Tensor]:
    """This rank's slice of a one-card state dict: every d_inner leaf cut to
    its 'model' shard; with ``keep`` (the layer indices of this pipe stage)
    the other layers left out."""
    out = {}
    n, r = mesh.size("model"), mesh.coord("model")
    for k, t in full.items():
        m = _LAYER_KEY.fullmatch(k)
        if keep is not None and m and int(m.group(1)) not in keep:
            continue
        out[k] = _shard(t, _spec(k), n, r)
    return out


def shard_params(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Lay ``model`` (an AudioMamba, initialised whole) out on ``mesh`` in
    place, as JAX's ``shard_params`` places a param tree: each mixer keeps
    its 'model' shard of d_inner and takes the 'model' group; under a 'pipe'
    axis larger than 1 (and the model's ``pipe_axis``) the stage keeps only
    its layers; with the model's ``seq_axis`` each mixer takes the 'seq'
    group. Returns the model."""
    cfg = model.config
    pipe = model.pipe_axis is not None and mesh.size("pipe") > 1
    keep = None
    if pipe:
        keep = stage_layers(cfg.depth, mesh.size("pipe"), mesh.coord("pipe"),
                            pair=cfg.if_bidirectional)
    local = shard_state_dict(model.state_dict(), mesh, keep)
    if pipe:
        model.keep_layers(keep)
    with torch.no_grad():
        for k, p in model.named_parameters():
            if p.shape != local[k].shape:
                p.data = local[k].clone()
    for layer in model.layers.values() if isinstance(model.layers, torch.nn.ModuleDict) \
            else model.layers:
        layer.mixer.tp_group = mesh.group("model") if mesh.distributed else None
        if model.seq_axis is not None:
            layer.mixer.seq_group = mesh.group("seq") if mesh.distributed else None
    model.mesh = mesh
    return model


def full_param_names(model: torch.nn.Module) -> list:
    """The parameter names of the one-card model, in its ``parameters()``
    order, from this rank's model (which may hold a pipe stage's layers)."""
    names = [k for k, _ in model.named_parameters()]
    layer_pos = [i for i, k in enumerate(names) if _LAYER_KEY.fullmatch(k)]
    if not layer_pos:
        return names
    first = int(_LAYER_KEY.fullmatch(names[layer_pos[0]]).group(1))
    per_layer = [_LAYER_KEY.fullmatch(k).group(2) for k in names
                 if _LAYER_KEY.fullmatch(k) and int(_LAYER_KEY.fullmatch(k).group(1)) == first]
    return (names[:layer_pos[0]]
            + [f"layers.{i}.{s}" for i in range(model.config.depth) for s in per_layer]
            + names[layer_pos[-1] + 1:])


def _gather_tensor(name: str, t: Optional[torch.Tensor], like: torch.Tensor, mesh: Mesh,
                   owner: Optional[int]) -> torch.Tensor:
    """One named tensor of the one-card layout on every rank: broadcast from
    its pipe stage ``owner`` (None: every stage holds it), then its 'model'
    shards gathered."""
    t = None if t is None else t.detach()
    if owner is not None:
        # A copy: the broadcast writes into its buffer, never into a parameter.
        buf = t.clone() if t is not None else torch.empty_like(like)
        src = mesh.group_ranks["pipe"][owner]
        t = collectives.broadcast(buf, src, mesh.group("pipe"), tag="gather_state")
    spec = _spec(name)
    if spec.dim is None or mesh.size("model") == 1:
        return t
    whole = collectives.all_gather(t.contiguous(), mesh.group("model"), dim=spec.dim,
                                   tag="gather_state")
    return _unshard(list(whole.chunk(mesh.size("model"), dim=spec.dim)), spec)


def _pipe_owner(model, name: str, mesh: Mesh) -> Optional[int]:
    m = _LAYER_KEY.fullmatch(name)
    if m is None or not isinstance(model.layers, torch.nn.ModuleDict):
        return None
    per_stage = model.config.depth // mesh.size("pipe")
    return int(m.group(1)) // per_stage


def _like(model, name: str, local: Dict[str, torch.Tensor]) -> Optional[torch.Tensor]:
    """A local tensor of the same shape as layer tensor ``name`` (this stage's
    copy of the same leaf in its first layer)."""
    m = _LAYER_KEY.fullmatch(name)
    if m is None:
        return local[name]
    for k in local:
        mk = _LAYER_KEY.fullmatch(k)
        if mk and mk.group(2) == m.group(2):
            return local[k]
    raise KeyError(name)


def gather_named(model: torch.nn.Module, tensors: Dict[str, torch.Tensor], mesh: Optional[Mesh],
                 names, root_only: bool = False) -> Dict[str, torch.Tensor]:
    """``tensors`` (this rank's, by parameter name, in the model's layout)
    in the one-card layout for every name of ``names``, on every rank. With
    ``root_only`` on rank 0 alone, the other ranks get {}: the ranks of the
    other 'data' and 'seq' replicas (which hold the same tensors) move
    nothing, and rank 0's 'pipe' and 'model' peers drop each tensor as soon
    as it is gathered."""
    if mesh is None or mesh.world == 1:
        return {k: tensors[k].detach() for k in names}
    if root_only and (mesh.coord("data") or mesh.coord("seq")):
        return {}
    keep = not root_only or mesh.rank == 0
    out = {}
    for k in names:
        t = _gather_tensor(k, tensors.get(k), _like(model, k, tensors).detach(), mesh,
                           _pipe_owner(model, k, mesh))
        if keep:
            out[k] = t
    return out


def gather_state_dict(model: torch.nn.Module, mesh: Optional[Mesh] = None,
                      root_only: bool = False) -> Dict[str, torch.Tensor]:
    """The one-card state dict of a model laid out by ``shard_params``, on
    every rank (a collective over the 'model' and 'pipe' groups), or with
    ``root_only`` on rank 0 alone ({} elsewhere; see ``gather_named``)."""
    mesh = mesh if mesh is not None else getattr(model, "mesh", None)
    local = model.state_dict()
    if mesh is None or mesh.world == 1:
        return local
    return gather_named(model, local, mesh, full_param_names(model), root_only)


def load_full_state_dict(model: torch.nn.Module, full: Dict[str, torch.Tensor]):
    """Load a one-card state dict into ``model``, sliced for this rank when
    the model is laid out on a mesh."""
    mesh = getattr(model, "mesh", None)
    if mesh is None:
        return model.load_state_dict(full)
    keep = ({int(k) for k in model.layers.keys()}
            if isinstance(model.layers, torch.nn.ModuleDict) else None)
    return model.load_state_dict(shard_state_dict(full, mesh, keep))
