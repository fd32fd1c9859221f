"""Computational microscopy reconstruction on the card.

Counterpart of ``biahub_tpu/recon``: the optics models (pupils, the
widefield fluorescence OTF, the weak-object phase transfer function and the
Tikhonov inverse, :mod:`~biahub_tpu_torch.recon.optics`), the Stokes
inversion of polarization states (:mod:`~biahub_tpu_torch.recon.
birefringence`) and the output channels of a settings dict
(:mod:`~biahub_tpu_torch.recon.settings`). The Tikhonov inverse runs kernels
A, Bc and C; the rest is torch, as the reference leaves it to XLA.
"""

from biahub_tpu_torch.recon.settings import output_channel_names

__all__ = ["output_channel_names"]
