"""Data-parallel training over ``torch.distributed`` (cocodet_tpu/parallel)."""

from .mesh import (DATA_AXIS, SPACE_AXIS, Mesh, batch_sharding_fn, data_sharding,
                   image_sharding, initialize_distributed, make_mesh, make_mesh_2d,
                   process_allgather_detections, replicate, replicated, shard_batch,
                   sync_global_devices)
