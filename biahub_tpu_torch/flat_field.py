"""flat-field on arrays in memory.

Counterpart of the compute of ``biahub_tpu/flat_field.py::flat_field``
(:74-147) without its plate I/O: the target channels of every timepoint
are corrected by ``kernels/flat_field.py::flat_field_zyx``, and the other
channels copied as float32 (the reference's output plate is float32).
"""

from __future__ import annotations

import torch

from biahub_tpu_torch.convert import flat_field_settings_from_reference
from biahub_tpu_torch.device import as_tensor, resolve_device
from biahub_tpu_torch.kernels.flat_field import flat_field_zyx

__all__ = ["resolve_target_indices", "flat_field_arrays"]


def resolve_target_indices(
    settings: dict,
    all_channel_names: list[str],
    others_note: str = "Other channels will be copied as-is",
) -> list[int]:
    """The indices of the channels to correct (the reference's
    ``_resolve_target_indices``, :45-72, with its lines on stdout):
    ``channel_names`` None means every channel; a name that is not a
    channel, or an empty list, raises ValueError with the reference's
    message."""
    names = settings.get("channel_names")
    if names is None:
        print(f"Flat fielding ALL channels: {all_channel_names}")
        target = all_channel_names
    elif names:
        for name in names:
            if name not in all_channel_names:
                raise ValueError(
                    f"Channel '{name}' not found in input dataset. "
                    f"Available channels: {all_channel_names}"
                )
        target = names
        print(f"Input channels: {all_channel_names}")
        print(f"Flat field channels: {target}")
        print(others_note)
    else:
        raise ValueError(
            "Must specify either 'channel_names' or set channel_names to null in config."
        )
    return [list(all_channel_names).index(name) for name in target]


def flat_field_arrays(
    tczyx,
    channel_names: list[str],
    settings: dict,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Flat-field a (T, C, Z, Y, X) array -> (T, C, Z, Y, X) float32 on the
    device: the channels the settings name (``FlatFieldCorrectionSettings``
    as a dict, ``settings/example_flat_field_settings.yml`` as loaded)
    corrected volume by volume, the others copied."""
    dev = resolve_device(device)
    targets = set(resolve_target_indices(flat_field_settings_from_reference(settings),
                                         list(channel_names)))
    T, C = tczyx.shape[:2]
    out = torch.empty(tuple(tczyx.shape), dtype=torch.float32, device=dev)
    for t in range(T):
        for c in range(C):
            vol = as_tensor(tczyx[t, c], dev)
            out[t, c] = flat_field_zyx(vol, device=dev) if c in targets else vol
    return out
