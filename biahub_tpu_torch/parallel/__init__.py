"""Device mesh, the sharded FFT and multi-process helpers.

Counterpart of ``biahub_tpu/parallel``: :mod:`~biahub_tpu_torch.parallel.
mesh` (the mesh and the batch layouts on it), :mod:`~biahub_tpu_torch.
parallel.distributed` (the process group and its collectives) and
:mod:`~biahub_tpu_torch.parallel.sharded_fft` (one volume's deconvolution
spread over a mesh, or over the processes of a group: kernels A, B or Bc,
and C on z-slab and ky-row shards).
"""

from biahub_tpu_torch.parallel.distributed import (
    all_reduce,
    all_to_all,
    barrier,
    is_coordinator,
    maybe_initialize_distributed,
    process_count,
    process_index,
)
from biahub_tpu_torch.parallel.mesh import (
    GlobalMesh,
    Mesh,
    batch_sharding,
    get_global_mesh,
    get_mesh,
    host_batch_sharding,
    replicated_sharding,
)

__all__ = [
    "GlobalMesh",
    "Mesh",
    "all_reduce",
    "all_to_all",
    "barrier",
    "batch_sharding",
    "get_global_mesh",
    "get_mesh",
    "host_batch_sharding",
    "is_coordinator",
    "maybe_initialize_distributed",
    "process_count",
    "process_index",
    "replicated_sharding",
]
