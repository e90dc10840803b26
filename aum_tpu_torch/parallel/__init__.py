"""The parallel modes: the mesh of ranks and the tensor-parallel layout
(``mesh``), the process group and the host gathers (``multihost``), the
explicit collectives (``collectives``), GPipe over the block stack
(``pipeline``) and the spawner of ranks (``launch``)."""

from aum_tpu_torch.parallel.mesh import (
    Mesh,
    gather_state_dict,
    load_full_state_dict,
    make_mesh,
    param_partition_specs,
    shard_params,
    shard_state_dict,
)
from aum_tpu_torch.parallel.multihost import maybe_initialize_distributed
from aum_tpu_torch.parallel.pipeline import block_stage_fn, block_stage_fn_dp, pipeline_apply

__all__ = ["Mesh", "block_stage_fn", "block_stage_fn_dp", "gather_state_dict",
           "load_full_state_dict", "make_mesh", "maybe_initialize_distributed",
           "param_partition_specs", "pipeline_apply", "shard_params", "shard_state_dict"]
