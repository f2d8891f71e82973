from monte_carlo_path_tracing_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_SPP, AXIS_TILES, Mesh, gather_rows, init_distributed_if_needed, make_mesh,
    ray_sharding, replicated, shard_rows,
)
from monte_carlo_path_tracing_tpu_torch.parallel.sharded import (  # noqa: F401
    make_train_step, render_rays_sharded,
)
