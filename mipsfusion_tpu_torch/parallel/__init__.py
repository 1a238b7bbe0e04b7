from .sharding import (  # noqa: F401
    Mesh, Sharding, make_mesh, make_sharded_map_step,
    make_sharded_refine_step, ray_sharded, replicate_params, replicated,
    shard_field_params, sharded_map_step, submap_sharded,
)
