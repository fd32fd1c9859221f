"""The output channels of a reconstruction.

Counterpart of ``ReconstructionSettings.output_channel_names``
(``biahub_tpu/recon/settings.py``:97-114). The port reads no YAML and has no
pydantic: :func:`~biahub_tpu_torch.convert.
reconstruction_settings_from_reference` validates a settings dict with the
model's defaults and refusals.
"""

from __future__ import annotations

from biahub_tpu_torch.convert import reconstruction_settings_from_reference

__all__ = ["output_channel_names"]


def output_channel_names(settings: dict) -> list[str]:
    """Reconstructed channel names in waveorder's order: birefringence (4),
    phase (1), then one deconvolved channel per input channel."""
    s = reconstruction_settings_from_reference(settings)
    names: list[str] = []
    if s["birefringence"] is not None:
        names += ["Retardance", "Orientation", "BF", "Pol"]
    if s["phase"] is not None:
        names += [f"Phase{s['reconstruction_dimension']}D"]
    if s["fluorescence"] is not None:
        names += [f"{name}_decon" for name in s["input_channel_names"]]
    return names
