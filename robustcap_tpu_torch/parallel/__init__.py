r"""Data parallelism on ``torch.distributed``: the mesh, the data-parallel
train step, and the multi-process wiring (port of
``robustcap_tpu/parallel``)."""

from .mesh import (Mesh, make_mesh, replicate, shard_batch,  # noqa: F401
                   make_dp_train_step)
from .distributed import (DistContext, initialize_distributed,  # noqa: F401
                          make_global_mesh, dataset_shard_indices,
                          process_local_batch, global_batch_from_local)

__all__ = ["make_mesh", "replicate", "shard_batch", "make_dp_train_step",
           "DistContext", "initialize_distributed", "make_global_mesh",
           "dataset_shard_indices", "process_local_batch",
           "global_batch_from_local", "Mesh"]
