from pngloss_jax.parallel.mesh import (
    data_mesh,
    optimize_batch_sharded,
    pad_to_multiple,
)

__all__ = ["data_mesh", "optimize_batch_sharded", "pad_to_multiple"]
