"""reconstruct: compute-tf, then apply-inv-tf.

Counterpart of ``biahub_tpu/reconstruct.py``: on arrays,
:func:`reconstruct_arrays` computes the transfer functions for the stack's
ZYX shape and applies them to its timepoints, without the store between
them; the verb, :func:`reconstruct` (:27-69), computes them from the first
position into ``<output's parent>/transfer_function_<config stem>.zarr``
and applies them to every position.
"""

from __future__ import annotations

from pathlib import Path

import torch

from biahub_tpu_torch.apply_inverse_transfer_function import (
    apply_inverse_transfer_function,
    apply_inverse_transfer_function_arrays,
)
from biahub_tpu_torch.compute_transfer_function import (
    compute_transfer_function,
    compute_transfer_function_arrays,
)
from biahub_tpu_torch.convert import reconstruction_settings_from_reference

__all__ = ["reconstruct_arrays", "reconstruct"]


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


def reconstruct(
    input_position_dirpaths: list[Path],
    config_filepath: Path,
    output_dirpath: Path,
    sbatch_filepath: str | None = None,
    cluster: str = "slurm",
    monitor: bool = True,
    device: str | torch.device = "cuda",
) -> None:
    """The reconstruct verb on plates (module docstring). All positions
    share one TCZYX shape."""
    transfer_function_path = Path(output_dirpath).parent / (
        "transfer_function_" + Path(config_filepath).stem + ".zarr")
    compute_transfer_function(input_position_dirpaths[0], config_filepath,
                              transfer_function_path, device=device)
    apply_inverse_transfer_function(input_position_dirpaths, transfer_function_path,
                                    config_filepath, output_dirpath, sbatch_filepath,
                                    cluster, monitor, device=device)
