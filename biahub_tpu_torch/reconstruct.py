"""reconstruct on arrays: compute-tf, then apply-inv-tf.

Counterpart of ``biahub_tpu/reconstruct.py`` (:56-69): the transfer
functions are computed for the stack's ZYX shape and applied to its
timepoints, without the transfer-function store between them.
"""

from __future__ import annotations

import torch

from biahub_tpu_torch.apply_inverse_transfer_function import (
    apply_inverse_transfer_function_arrays,
)
from biahub_tpu_torch.compute_transfer_function import compute_transfer_function_arrays
from biahub_tpu_torch.convert import reconstruction_settings_from_reference

__all__ = ["reconstruct_arrays"]


def reconstruct_arrays(
    tczyx,
    channel_names: list[str],
    settings: dict,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Reconstruct ``tczyx`` with a reconstruction settings dict: (T_sel,
    C_out, Z, Y, X) float32 on ``device``, channels as
    :func:`~biahub_tpu_torch.recon.settings.output_channel_names` names
    them."""
    s = reconstruction_settings_from_reference(settings)
    tfs = compute_transfer_function_arrays(tuple(tczyx.shape[2:]), s, device)
    return apply_inverse_transfer_function_arrays(tczyx, channel_names, tfs, s, device)
