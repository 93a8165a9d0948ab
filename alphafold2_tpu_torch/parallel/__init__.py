"""Device meshes and sharded execution on ``torch.distributed`` (the port of
``alphafold2_tpu/parallel``): one process a device, explicit collectives."""

from alphafold2_tpu_torch.parallel.sharding import (
    DATA_AXIS,
    SEQ_AXIS,
    active_mesh,
    describe_mesh,
    make_mesh,
    parse_mesh_spec,
    shard_batch,
    shard_msa,
    shard_pair,
    use_mesh,
)

__all__ = ["DATA_AXIS", "SEQ_AXIS", "active_mesh", "describe_mesh", "make_mesh",
           "parse_mesh_spec", "shard_batch", "shard_msa", "shard_pair", "use_mesh"]
