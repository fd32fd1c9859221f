"""Device mesh, the sharded FFT and multi-process helpers.

Counterpart of ``biahub_tpu/parallel``: :mod:`~biahub_tpu_torch.parallel.
mesh` (the mesh), :mod:`~biahub_tpu_torch.parallel.distributed` (the
process group) and :mod:`~biahub_tpu_torch.parallel.sharded_fft` (one
volume's deconvolution spread over a mesh: kernels A, B or Bc, and C on
z-slab and ky-row shards).
"""

from biahub_tpu_torch.parallel.distributed import (
    barrier,
    is_coordinator,
    maybe_initialize_distributed,
    process_count,
    process_index,
)
from biahub_tpu_torch.parallel.mesh import Mesh, get_mesh

__all__ = [
    "Mesh",
    "barrier",
    "get_mesh",
    "is_coordinator",
    "maybe_initialize_distributed",
    "process_count",
    "process_index",
]
