from .mesh import Mesh, make_mesh, shard_batch, shard_params  # noqa: F401
