"""Parallelism past one card over ``torch.distributed`` (port of
``lap_tpu/parallel``, without pipeline parallelism: ROADMAP item 13b)."""

from lap_tpu_torch.parallel.mesh import (
    BATCH_AXIS,
    DATA_AXES,
    FSDP_AXIS,
    TP_AXIS,
    activation_sharding_constraint,
    data_sharding,
    get_mesh,
    init_distributed,
    make_mesh,
    pick_fsdp_devices,
    replicated,
    sequence_parallel_enabled,
    set_mesh,
    suspend_mesh,
)
from lap_tpu_torch.parallel.sharding import fsdp_sharding, parallelize_

__all__ = [
    "BATCH_AXIS",
    "DATA_AXES",
    "FSDP_AXIS",
    "TP_AXIS",
    "activation_sharding_constraint",
    "data_sharding",
    "fsdp_sharding",
    "get_mesh",
    "init_distributed",
    "make_mesh",
    "parallelize_",
    "pick_fsdp_devices",
    "replicated",
    "sequence_parallel_enabled",
    "set_mesh",
    "suspend_mesh",
]
