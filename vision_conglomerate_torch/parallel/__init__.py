from .mesh import (  # noqa: F401
    maybe_initialize_distributed,
    process_is_primary,
    rank,
    shard_batch,
    shutdown_distributed,
    world_size,
)
from .serving import make_dp_serve  # noqa: F401
