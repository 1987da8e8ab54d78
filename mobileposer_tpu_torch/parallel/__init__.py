"""Data parallelism: device meshes in one process (evaluation, streaming,
serving) and process groups over torch.distributed (training)."""

from mobileposer_tpu_torch.parallel.distributed import (  # noqa: F401
    backend_for,
    broadcast_from_rank0,
    fold_in,
    host_local_batch,
    host_local_batch_slice,
    initialize_distributed,
    join_or_spawn,
    local_device,
    process_mesh,
    rank,
    rank_device,
    spawn,
    world_size,
)
from mobileposer_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    Mesh,
    Replicated,
    Sharded,
    data_parallel_mesh,
    gather,
    make_mesh,
    pad_batch_to_multiple,
    replicate_params,
    shard_batch,
    shard_map,
    shard_stream_state,
    stream_sequence_sharded,
)
