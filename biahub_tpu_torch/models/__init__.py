"""The networks of the model verbs and their checkpoints.

Counterpart of ``biahub_tpu/models``: :class:`~biahub_tpu_torch.models.
unext2.UNeXt2` and :class:`~biahub_tpu_torch.models.unet25d.UNet25D`
(virtual-stain) and :class:`~biahub_tpu_torch.models.cpnet.CPnet`
(segment), with the state-dict names of the reference's torch twin
(``biahub_tpu/models/torch_twin.py``), so the checkpoints the reference
loads load here as they are (:mod:`biahub_tpu_torch.models.convert`).
The convolutions and dense layers are PyTorch's: the reference runs them as
XLA convolutions and dot products, not as Pallas kernels.

:func:`model_precision` scopes ``BIAHUB_TPU_MODEL_PRECISION`` to one call
of a network, as the reference scopes its matmul precision to its jitted
apply (``biahub_tpu/virtual_stain.py:_jit_model_apply``): ``default`` lets
cuDNN's convolutions and cuBLAS's matmuls round their inputs to TF32 (the
card's counterpart of the TPU's bf16 passes), ``highest`` keeps both in
float32. The flags are restored on exit, so no other verb's library calls
or plain versions see them. On the CPU the flags change nothing.
"""

from __future__ import annotations

import contextlib
import os

import torch

__all__ = ["model_precision", "precision_mode"]


def precision_mode() -> str:
    """``BIAHUB_TPU_MODEL_PRECISION`` lower-cased: ``highest`` or
    ``default`` (any other value reads as ``default``, as in the
    reference)."""
    mode = os.environ.get("BIAHUB_TPU_MODEL_PRECISION", "default").lower()
    return "highest" if mode == "highest" else "default"


@contextlib.contextmanager
def model_precision():
    """TF32 convolutions and matmuls under ``default``, float32 under
    ``highest``, for the body of the ``with`` only; no autograd."""
    tf32 = precision_mode() != "highest"
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=tf32), torch.no_grad():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
