from .mesh import (Mesh, init_from_env, replicate_from_local, replicate_tree,
                   shard_batch)

__all__ = ["Mesh", "init_from_env", "replicate_from_local", "replicate_tree",
           "shard_batch"]
