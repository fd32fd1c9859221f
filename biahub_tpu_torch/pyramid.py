"""The pyramid verb: multiscale levels of each position.

Counterpart of ``biahub_tpu/pyramid.py`` (:20-73): levels ``1 ..
levels - 1`` of each position, each the previous level halved in Y and X
by a 2 x 2 reduction (:meth:`~biahub_tpu_torch.io.ngff.Position.
compute_pyramid`; mean, median, mode, min, max or stride), written beside
level 0 with its scale. Host arithmetic on the store, as the reference's.
"""

from __future__ import annotations

from pathlib import Path

from biahub_tpu_torch.io.ngff import open_ome_zarr
from biahub_tpu_torch.runtime.executor import resolve_cluster
from biahub_tpu_torch.runtime.resources import estimate_resources

__all__ = ["pyramid", "pyramid_verb"]


def pyramid(fov_path: Path, levels: int, method: str) -> None:
    """The pyramid levels of one position."""
    print(f"Computing pyramid for FOV: {fov_path}")
    open_ome_zarr(fov_path, mode="r+").compute_pyramid(levels=levels, method=method)


def pyramid_verb(input_position_dirpaths: list[Path], levels: int = 4, method: str = "mean",
                 sbatch_filepath: Path | None = None, local: bool = False) -> None:
    """The pyramid verb (the reference's ``pyramid_cli``) on each position."""
    if levels <= 1:
        print("No pyramid levels to create (levels must be > 1).")
        return
    estimate_resources(shape=open_ome_zarr(input_position_dirpaths[0]).data.shape,
                       ram_multiplier=5)
    resolve_cluster(None, local)
    for fov_path in input_position_dirpaths:
        pyramid(fov_path=fov_path, levels=levels, method=method)
