"""Birefringence reconstruction: Stokes inversion from polarization states.

Counterpart of ``biahub_tpu/recon/birefringence.py``. Intensities under N
liquid-crystal states relate to the Stokes vector through the ideal
instrument matrix (:func:`instrument_matrix`, a copy of the reference's);
its float32 pseudo-inverse gives S0..S3, and retardance, slow-axis
orientation, transmittance and degree of polarization follow, in float32
in the reference's order. The reference leaves this to XLA; here it is
torch on the volume's device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["instrument_matrix", "stokes_from_intensities", "birefringence_from_stokes"]


def instrument_matrix(n_states: int, swing: float) -> np.ndarray:
    """Ideal instrument matrix mapping Stokes (S0, S1, S2, S3) to intensities."""
    chi = 2 * np.pi * swing
    if n_states == 5:
        thetas = [0, 45, 90, 135]
    elif n_states == 4:
        thetas = [0, 60, 120]
    else:
        raise ValueError(f"Unsupported number of polarization states: {n_states}")
    rows = [[1.0, 0.0, 0.0, -1.0]]  # extinction state
    for theta_deg in thetas:
        theta = np.deg2rad(theta_deg)
        rows.append(
            [
                1.0,
                np.sin(chi) * np.cos(2 * theta),
                np.sin(chi) * np.sin(2 * theta),
                -np.cos(chi),
            ]
        )
    return np.asarray(rows, dtype=np.float32)


def stokes_from_intensities(czyx: torch.Tensor, swing: float) -> torch.Tensor:
    """(C = N states, Z, Y, X) intensities -> (4, Z, Y, X) Stokes images.
    The pseudo-inverse is float32, taken on the host (a 4x5 matrix), and
    applied as one float32 matrix product on the volume's device."""
    n_states = czyx.shape[0]
    a_inv = torch.linalg.pinv(torch.from_numpy(instrument_matrix(n_states, swing)))
    flat = czyx.reshape(n_states, -1).to(torch.float32)
    return (a_inv.to(flat.device) @ flat).reshape((4,) + tuple(czyx.shape[1:]))


def birefringence_from_stokes(
    stokes: torch.Tensor,
    wavelength_illumination: float = 0.532,
    flip_orientation: bool = False,
    rotate_orientation: bool = False,
) -> torch.Tensor:
    """(4, Z, Y, X) Stokes -> (4, Z, Y, X): Retardance (um), Orientation
    (rad), BF (transmittance), Pol (degree of polarization)."""
    s0, s1, s2, s3 = stokes[0], stokes[1], stokes[2], stokes[3]
    eps = 1e-12
    transverse = torch.sqrt(s1 * s1 + s2 * s2)
    retardance = torch.atan2(transverse, s3) * wavelength_illumination / (2 * math.pi)
    orientation = torch.remainder(0.5 * torch.atan2(s1, s2 + eps), math.pi)
    if rotate_orientation:
        orientation = torch.remainder(orientation + math.pi / 2, math.pi)
    if flip_orientation:
        orientation = math.pi - orientation
    pol = torch.sqrt(s1 * s1 + s2 * s2 + s3 * s3) / (torch.abs(s0) + eps)
    return torch.stack([retardance, orientation, s0, pol])
