"""Flat-field correction: divide out the median-along-Z illumination pattern.

Counterpart of ``biahub_tpu/kernels/flat_field.py`` (:18-22): the static
pattern is the per-(y, x) median over Z, and the output is rescaled by the
pattern's mean. Plain PyTorch, as the reference's is XLA (no Pallas
kernel). ``jnp.median`` averages the two middle values for an even count,
``(lo + hi) * 0.5``; ``torch.median`` returns the lower one, so the median
here sorts along Z and takes the reference's midpoint.
"""

from __future__ import annotations

import torch

from biahub_tpu_torch.device import as_tensor, resolve_device

__all__ = ["median_pattern", "flat_field_zyx"]


def median_pattern(data: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """``jnp.median(data, axis)``: the middle value along ``axis``, or the
    midpoint ``(lo + hi) * 0.5`` of the two middle values for an even count."""
    ordered = torch.sort(data, dim=axis).values
    n = data.shape[axis]
    hi = ordered.select(axis, n // 2)
    if n % 2:
        return hi
    return (ordered.select(axis, n // 2 - 1) + hi) * 0.5


def flat_field_zyx(zyx_data, axis: int = 0,
                   device: str | torch.device = "cuda") -> torch.Tensor:
    """``data / pattern * mean(pattern)`` of one volume in float32, the
    pattern :func:`median_pattern` along ``axis``."""
    data = as_tensor(zyx_data, resolve_device(device))
    pattern = median_pattern(data, axis)
    return data / pattern.unsqueeze(axis) * pattern.mean()
