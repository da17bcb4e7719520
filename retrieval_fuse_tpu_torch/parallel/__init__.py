from retrieval_fuse_tpu_torch.parallel.mesh import (
    Mesh, data_parallel_jit, get_mesh, initialize_multihost, make_global_batch,
    mesh_for_batch, replicate, shard_batch)

__all__ = ["Mesh", "data_parallel_jit", "get_mesh", "initialize_multihost",
           "make_global_batch", "mesh_for_batch", "replicate", "shard_batch"]
