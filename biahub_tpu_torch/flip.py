"""The flip verb: positions flipped in X and/or Y in place.

Counterpart of ``biahub_tpu/flip.py`` (:12-35): each (t, c) volume of each
position's array ``"0"`` is read, reversed along X (``-x``) and/or Y
(``-y``), and written back. Data movement only: it runs on the host.
"""

from __future__ import annotations

from pathlib import Path

from biahub_tpu_torch.io.ngff import open_ome_zarr

__all__ = ["flip"]


def flip(input_position_dirpaths: list[Path], x: bool = False, y: bool = False) -> None:
    """Flip every (t, c) volume of each position in place."""
    for input_position_filepath in input_position_dirpaths:
        print(f"Flipping {input_position_filepath}")
        array = open_ome_zarr(input_position_filepath, mode="r+")["0"]
        T, C = array.shape[:2]
        for t in range(T):
            for c in range(C):
                print(f"\tFlipping {t=}, {c=}")
                temp = array[t, c]
                if x:
                    temp = temp[:, :, ::-1]
                if y:
                    temp = temp[:, ::-1, :]
                array[t, c] = temp
