"""The main path's steps as modules that hold their per-acquisition state.

- :class:`DeconvolveDeskew`: what ``biahub_tpu/fuse.py:540-600`` and
  bench.py's headline set up around
  ``kernels/chain.py::deconvolve_then_deskew_batched``: the prepared
  Tikhonov filter, hoisted once per acquisition, and the deskew geometry.
- :class:`DeconvolveDeskewWarp`: the full chain of bench.py's end-to-end
  metric (``bench.py:893-901``) and of the fused pipeline with a
  registration block (``fuse.py:604-660``): the same, plus the warp's
  coefficients.

With ``spectral=True`` each takes the spectral engine (kernels A, K, L and
M) where :func:`~biahub_tpu_torch.kernels.spectral.
spectral_deskew_supported` (and, for the chain, an in-plane warp) holds,
and holds its lerp-DFT table as the buffer ``deskew_table``, as
``fuse.py:520-535`` and ``fuse.py:610-628`` hoist ``deskew_table``; the
buffer is None on the other route.

With ``keep_overhang`` and a non-zero ``overhang_fill`` both fill each
deskewed volume's overhang (``kernels/deskew.py::fill_overhang``) after
kernel D, and the chain warps the filled volume from D's zyx store: the
reference composes its stages so when a fill is asked for (fuse.py:
508-511), and takes no spectral engine then.
"""

from __future__ import annotations

import torch
from torch import nn

from biahub_tpu_torch.device import resolve_device
from biahub_tpu_torch.kernels.affine import inplane_coefficients, is_inplane_matrix
from biahub_tpu_torch.kernels.chain import (
    chain_warp_matrix,
    chain_warp_spectral_route,
    run_chain,
    run_chain_warp,
    run_chain_warp_general,
)
from biahub_tpu_torch.kernels.deconvolve import volume_tensor
from biahub_tpu_torch.kernels.deskew import deskew_geometry, overhang_fill_value
from biahub_tpu_torch.kernels.fft import prepare_fourier_filter
from biahub_tpu_torch.kernels.spectral import (
    prepare_spectral_deskew,
    run_spectral,
    run_spectral_warp,
    spectral_deskew_supported,
)

__all__ = ["DeconvolveDeskew", "DeconvolveDeskewWarp"]


class DeconvolveDeskew(nn.Module):
    """``forward(volumes)``: (B, Z, Y, X) uint16 or float32 -> (B, groups,
    Y_out, X_out) float32, deconvolved then deskewed.

    The prepared filter ``tf / (tf^2 + reg)`` is the buffer ``filter`` (so
    ``.to(device)`` moves it); the deskew geometry is the attribute
    ``geometry``, the fill ``overhang_fill``
    (:func:`~biahub_tpu_torch.kernels.deskew.overhang_fill_value`). Volumes
    must have the ``zyx_shape`` the module was built for. ``spectral``:
    take the spectral engine (the buffer ``deskew_table``) where the kernels
    take the geometry and no fill acts.
    """

    def __init__(
        self,
        transfer_function_half,
        zyx_shape: tuple[int, int, int],
        regularization_strength: float,
        ls_angle_deg: float,
        px_to_scan_ratio: float,
        keep_overhang: bool = False,
        average_window: int = 1,
        overhang_fill: str | float = 0,
        skip_flip: bool = False,
        device: str | torch.device = "cuda",
        spectral: bool = False,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.geometry = deskew_geometry(
            zyx_shape, ls_angle_deg, px_to_scan_ratio, keep_overhang,
            average_window, skip_flip,
        )
        self.overhang_fill = overhang_fill_value(keep_overhang, overhang_fill)
        self.register_buffer("filter", prepare_fourier_filter(
            zyx_shape, transfer_function_half, regularization_strength, dev
        ))
        take = spectral and self.overhang_fill is None and spectral_deskew_supported(
            zyx_shape, ls_angle_deg, px_to_scan_ratio, keep_overhang, average_window)
        self.register_buffer("deskew_table", prepare_spectral_deskew(
            zyx_shape, ls_angle_deg, px_to_scan_ratio, keep_overhang, average_window, dev
        ) if take else None)

    def forward(self, volumes) -> torch.Tensor:
        if self.deskew_table is None:
            return run_chain(_batch(self, volumes), self.filter, self.geometry,
                             fill=self.overhang_fill)
        out = run_spectral(_batch(self, volumes), self.filter, self.deskew_table,
                           self.geometry)
        return out if self.geometry.skip_flip else out.flip(2)


def _batch(module: nn.Module, volumes) -> torch.Tensor:
    """``volumes`` on the module's device; raises unless they are a batch of
    the volumes the module was built for."""
    data = volume_tensor(volumes, module.filter.device)
    if tuple(data.shape[1:]) != module.geometry.zyx_shape or data.ndim != 4:
        raise ValueError(f"{type(module).__name__}: built for (B,) + "
                         f"{module.geometry.zyx_shape}, got {tuple(data.shape)}")
    return data


class DeconvolveDeskewWarp(nn.Module):
    """``forward(volumes)``: (B, Z, Y, X) uint16 or float32 -> (B, Zo, Yo,
    Xo) float32, deconvolved, deskewed and warped by ``matrix``, an
    output->input affine of the standard deskewed frame (register and
    stabilize composed, ``M_reg @ M_stab[t]``).

    Buffers: the prepared filter ``filter`` and, for an in-plane matrix,
    the warp's coefficients ``warp`` (kernels E and F). Attributes: the
    warp's ``matrix`` (:func:`~biahub_tpu_torch.kernels.chain.
    chain_warp_matrix`, the deskew's Y flip folded in; a general one takes
    the multipass warp), the deskew ``geometry`` (``skip_flip`` set), the
    warp's logical input ``logical_zyx_shape`` (the deskewed (groups,
    Y_out, X_out)), ``output_shape`` (default the same), ``fill`` and the
    deskew's ``overhang_fill``. ``spectral``: take the spectral engine's xzy
    store into E and F (the buffer ``deskew_table``) where
    :func:`~biahub_tpu_torch.kernels.chain.chain_warp_spectral_route` holds
    and no overhang fill acts.
    """

    def __init__(
        self,
        transfer_function_half,
        zyx_shape: tuple[int, int, int],
        regularization_strength: float,
        ls_angle_deg: float,
        px_to_scan_ratio: float,
        matrix,
        output_shape: tuple[int, int, int] | None = None,
        keep_overhang: bool = False,
        average_window: int = 1,
        fill: float = 0.0,
        overhang_fill: str | float = 0,
        device: str | torch.device = "cuda",
        spectral: bool = False,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.geometry = deskew_geometry(
            zyx_shape, ls_angle_deg, px_to_scan_ratio, keep_overhang,
            average_window, skip_flip=True,
        )
        self.overhang_fill = overhang_fill_value(keep_overhang, overhang_fill)
        self.logical_zyx_shape = self.geometry.out_shape
        self.output_shape = tuple(int(s) for s in (
            output_shape if output_shape is not None else self.logical_zyx_shape))
        self.fill = float(fill)
        self.register_buffer("filter", prepare_fourier_filter(
            zyx_shape, transfer_function_half, regularization_strength, dev
        ))
        self.matrix = chain_warp_matrix(matrix, self.geometry)
        self.register_buffer("warp", inplane_coefficients(self.matrix).to(dev)
                             if is_inplane_matrix(self.matrix) else None)
        take = spectral and self.overhang_fill is None and chain_warp_spectral_route(
            zyx_shape, ls_angle_deg, px_to_scan_ratio, keep_overhang, average_window, matrix)
        self.register_buffer("deskew_table", prepare_spectral_deskew(
            zyx_shape, ls_angle_deg, px_to_scan_ratio, keep_overhang, average_window, dev
        ) if take else None)

    def forward(self, volumes) -> torch.Tensor:
        if self.deskew_table is not None:
            return run_spectral_warp(_batch(self, volumes), self.filter, self.deskew_table,
                                     self.geometry, self.warp, self.output_shape, self.fill)
        if self.warp is None:
            return run_chain_warp_general(_batch(self, volumes), self.filter, self.geometry,
                                          self.matrix, self.output_shape, self.fill,
                                          self.overhang_fill)
        return run_chain_warp(_batch(self, volumes), self.filter, self.geometry,
                              self.warp, self.output_shape, self.fill,
                              overhang_fill=self.overhang_fill)
