"""PyTorch and CUDA port of biahub_tpu for one NVIDIA H100.

The JAX package ``biahub_tpu`` stays the reference; this package imports
none of it and no JAX. Every kernel of the ported path is a CUDA kernel
written for ``sm_90a`` (``biahub_tpu_torch/csrc``), built with ``nvcc`` at
first CUDA use, with a plain PyTorch version beside it that CPU tensors
take. Entry points take ``device=`` (default ``"cuda"``) and raise without a
card unless ``device="cpu"`` is asked for.

Ported so far: the main path, deconvolve -> deskew -> one in-plane warp
that does register and stabilize
(:class:`~biahub_tpu_torch.pipeline.DeconvolveDeskewWarp`), and its headline
step deconvolve -> deskew
(:class:`~biahub_tpu_torch.pipeline.DeconvolveDeskew`); the functions are
in :mod:`biahub_tpu_torch.kernels.chain` and
:mod:`biahub_tpu_torch.kernels.affine`.
"""

from biahub_tpu_torch.convert import chain_from_reference, module_from_reference
from biahub_tpu_torch.device import gpu_info, resolve_device
from biahub_tpu_torch.kernels.affine import (
    affine_warp_auto,
    inplane_affine_warp_zyx,
    inplane_affine_warp_zyx_batched,
)
from biahub_tpu_torch.kernels.chain import (
    deconvolve_deskew_warp,
    deconvolve_deskew_warp_batched,
    deskew_then_warp,
)
from biahub_tpu_torch.pipeline import DeconvolveDeskew, DeconvolveDeskewWarp

__all__ = [
    "DeconvolveDeskew",
    "DeconvolveDeskewWarp",
    "module_from_reference",
    "chain_from_reference",
    "affine_warp_auto",
    "inplane_affine_warp_zyx",
    "inplane_affine_warp_zyx_batched",
    "deskew_then_warp",
    "deconvolve_deskew_warp",
    "deconvolve_deskew_warp_batched",
    "gpu_info",
    "resolve_device",
]
