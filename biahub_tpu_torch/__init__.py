"""PyTorch and CUDA port of biahub_tpu for one NVIDIA H100.

The JAX package ``biahub_tpu`` stays the reference; this package imports
none of it and no JAX. Every kernel of the ported path is a CUDA kernel
written for ``sm_90a`` (``biahub_tpu_torch/csrc``), built with ``nvcc`` at
first CUDA use, with a plain PyTorch version beside it that CPU tensors
take. Entry points take ``device=`` (default ``"cuda"``) and raise without a
card unless ``device="cpu"`` is asked for.

Ported so far: the headline deconvolve -> deskew step
(:class:`~biahub_tpu_torch.pipeline.DeconvolveDeskew`,
:mod:`biahub_tpu_torch.kernels.chain`).
"""

from biahub_tpu_torch.convert import module_from_reference
from biahub_tpu_torch.device import gpu_info, resolve_device
from biahub_tpu_torch.pipeline import DeconvolveDeskew

__all__ = ["DeconvolveDeskew", "module_from_reference", "gpu_info", "resolve_device"]
