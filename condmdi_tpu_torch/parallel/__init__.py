"""Data and tensor parallelism on torch.distributed (counterpart of condmdi_tpu/parallel/)."""

from condmdi_tpu_torch.parallel.dp_sample import dp_sample, shard_sample_inputs
from condmdi_tpu_torch.parallel.mesh import (
    data_parallel_spec,
    initialize_distributed,
    make_mesh,
    replicate,
    shard_batch,
    shard_params_fsdp,
)
from condmdi_tpu_torch.parallel.tp import (
    MDM_TP_RULES,
    TP_AXIS,
    UNET_TP_RULES,
    make_mesh_2d,
    shard_params_tp,
    tensor_parallel,
    tp_spec_for_path,
)

__all__ = ["dp_sample", "shard_sample_inputs", "data_parallel_spec", "initialize_distributed",
           "make_mesh", "replicate", "shard_batch", "shard_params_fsdp", "MDM_TP_RULES",
           "TP_AXIS", "UNET_TP_RULES", "make_mesh_2d", "shard_params_tp", "tensor_parallel",
           "tp_spec_for_path"]
