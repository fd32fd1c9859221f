"""OME-Zarr HCS plates on numpy and the standard library
(:mod:`biahub_tpu_torch.io.ngff`, its chunk codecs in
:mod:`biahub_tpu_torch.io.codecs`), and the resume records
(:mod:`biahub_tpu_torch.io.progress`)."""

from biahub_tpu_torch.io.ngff import (
    ImageArray,
    Plate,
    Position,
    TransformationMeta,
    create_empty_plate,
    get_ome_zarr_version,
    open_ome_zarr,
)
from biahub_tpu_torch.io.progress import ProgressStore

__all__ = [
    "ImageArray",
    "Plate",
    "Position",
    "TransformationMeta",
    "create_empty_plate",
    "get_ome_zarr_version",
    "open_ome_zarr",
    "ProgressStore",
]
