"""Parallelism over process meshes (counterpart of
``pose3d_tpu/parallel``): tensor, FSDP and pipeline layouts of the
training state, sequence parallelism, and the pipeline schedule."""

from pose3d_tpu_torch.parallel.tp import (  # noqa: F401
    tp_param_spec,
    shard_state_for_tp,
)
from pose3d_tpu_torch.parallel.fsdp import (  # noqa: F401
    fsdp_param_spec,
    shard_state_for_fsdp,
)
from pose3d_tpu_torch.parallel.pp import (  # noqa: F401
    gpipe,
    make_pipeline_runner,
    pp_param_spec,
    shard_state_for_pp,
    stack_vit_blocks,
    unstack_vit_blocks,
)
