"""PyTorch and CUDA port of biahub_tpu for one NVIDIA H100.

The JAX package ``biahub_tpu`` stays the reference; this package imports
none of it and no JAX. Every kernel of the ported path is a CUDA kernel
written for ``sm_90a`` (``biahub_tpu_torch/csrc``), built with ``nvcc`` at
first CUDA use, with a plain PyTorch version beside it that CPU tensors
take. Entry points take ``device=`` (default ``"cuda"``) and raise without a
card unless ``device="cpu"`` is asked for.

Ported so far: the main path, deconvolve -> deskew -> one in-plane warp
that does register and stabilize
(:class:`~biahub_tpu_torch.pipeline.DeconvolveDeskewWarp`), and its headline
step deconvolve -> deskew
(:class:`~biahub_tpu_torch.pipeline.DeconvolveDeskew`); the functions are
in :mod:`biahub_tpu_torch.kernels.chain` and
:mod:`biahub_tpu_torch.kernels.affine`. Beside it, the drift path on
arrays in memory: estimate-stabilization
(:func:`~biahub_tpu_torch.estimate_stabilization.
estimate_stabilization_arrays`: phase cross-correlation through kernels A,
Bx and C, focus finding) and stabilize
(:func:`~biahub_tpu_torch.stabilize.stabilize_tczyx`: kernels E and F with
one matrix per volume, or the multipass warp's kernel H for general 3D
matrices). Bead detection (kernel G, :func:`~biahub_tpu_torch.kernels.peaks.
detect_peaks`) serves estimate-stabilization's ``beads`` method
(:mod:`biahub_tpu_torch.registration.beads`) and estimate-psf
(:func:`~biahub_tpu_torch.estimate_psf.estimate_psf_arrays`). Intensity
registration (:mod:`biahub_tpu_torch.registration.intensity`: Adam through
the traced multipass warp, kernel H forward and kernels I and J backward)
serves optimize-registration
(:func:`~biahub_tpu_torch.optimize_registration.
optimize_registration_arrays`) and estimate-registration's ``ants`` and
``beads`` methods (:func:`~biahub_tpu_torch.estimate_registration.
estimate_registration_arrays`). Reconstruction on arrays:
compute-tf (:func:`~biahub_tpu_torch.compute_transfer_function.
compute_transfer_function_arrays`: the phase WOTF and fluorescence OTF),
apply-inv-tf (:func:`~biahub_tpu_torch.apply_inverse_transfer_function.
apply_inverse_transfer_function_arrays`: birefringence, and phase and
fluorescence as Tikhonov inverses through kernels A, Bc and C) and
reconstruct (:func:`~biahub_tpu_torch.reconstruct.reconstruct_arrays`);
the kernels take axes of any length up to their limits, so the deskewed
FOV (86, 1024, 484) runs as it is. The spectral deconvolve + deskew
(:func:`~biahub_tpu_torch.kernels.spectral.deconvolve_deskew_zyx_spectral`:
kernels A, K, L and M, the deskew's lerp evaluated from the spectrum) is
the other route of the headline step and of the full chain, taken with
``spectral=True``. One volume's deconvolution spread over a mesh of
devices (:mod:`biahub_tpu_torch.parallel.sharded_fft`: kernels A, B or Bc,
and C on z-slab and ky-row shards) serves the deconvolve verb on arrays
(:func:`~biahub_tpu_torch.deconvolve.deconvolve_arrays`, ``sharded=True``),
beside the mesh (:mod:`biahub_tpu_torch.parallel.mesh`) and the process
group (:mod:`biahub_tpu_torch.parallel.distributed`). The fused pipeline
and the deskew, flat-field and register verbs on arrays
(:func:`~biahub_tpu_torch.fuse.fuse_arrays`,
:func:`~biahub_tpu_torch.deskew.deskew_arrays`,
:func:`~biahub_tpu_torch.flat_field.flat_field_arrays`,
:func:`~biahub_tpu_torch.register.register_arrays`) run the same kernels
with the overhang fill, the flat-field correction and, past the batch
budget, the reference's chunked routes (the chunked warps,
:func:`~biahub_tpu_torch.kernels.multipass_warp.chunked_affine_warp_zyx`).
The main path's verbs on OME-Zarr plates, as a user runs them:
``python -m biahub_tpu_torch.cli`` (:mod:`biahub_tpu_torch.cli.main`) with
``fuse``, ``deconvolve``, ``deskew``, ``flat-field``, ``register`` and
``stabilize``, each a store-level function beside its ``*_arrays``
function (e.g. :func:`biahub_tpu_torch.fuse.fuse`), on the port's own
OME-Zarr store (:mod:`biahub_tpu_torch.io`: uncompressed zarr v2 and v3
written; uncompressed, zlib and gzip read) and batch runner
(:mod:`biahub_tpu_torch.runtime.executor`); and the reconstruction and
estimate verbs the same way: ``compute-tf``, ``apply-inv-tf``,
``reconstruct``, ``estimate-stabilization``, ``estimate-psf``,
``estimate-registration`` (``beads``, ``ants``) and
``optimize-registration``, which write the settings YAML (the port's
writer, :mod:`biahub_tpu_torch.cli.yaml_writer`), CSV, ``.npy`` transform
files and, where matplotlib is installed, plots that ``register`` and
``stabilize`` and their users read; and the stitching and assembly verbs:
``estimate-stitch`` (:func:`~biahub_tpu_torch.estimate_stitch.
estimate_stitch`: stage metadata, refined by the strips' phase correlation
on the device, :mod:`biahub_tpu_torch.stitching`), ``stitch``
(:func:`~biahub_tpu_torch.stitch.stitch`: each chunk's FOVs blended on the
device, :mod:`biahub_tpu_torch.kernels.stitch_blend`), ``concatenate``,
``flip`` and ``pyramid`` (host I/O, as the reference's). The deconvolve
verb on plates takes the sharded route under ``BIAHUB_TPU_SHARDED_FFT=1``
(:func:`~biahub_tpu_torch.deconvolve.deconvolve`, ``mesh=``), and
``BIAHUB_TPU_PROFILE`` times every verb and, with a directory, writes its
``torch.profiler`` trace (:mod:`biahub_tpu_torch.runtime.profiling`).
The model verbs: ``virtual-stain`` (:mod:`biahub_tpu_torch.virtual_stain`:
UNeXt2 or UNet25D, :mod:`biahub_tpu_torch.models`, or a TorchScript file,
over sliding z windows on the device), ``segment``
(:mod:`biahub_tpu_torch.segment`: Otsu on the host, CPnet and the flow
following on the device, :mod:`biahub_tpu_torch.segmentation`) and
``track`` (:mod:`biahub_tpu_torch.track`, :mod:`biahub_tpu_torch.tracking`:
on the host, as the reference); ``BIAHUB_TPU_MODEL_PRECISION`` scopes the
networks' TF32 to each call (:func:`biahub_tpu_torch.models.
model_precision`).
"""

from biahub_tpu_torch.apply_inverse_transfer_function import (
    apply_inverse_transfer_function_arrays,
)
from biahub_tpu_torch.compute_transfer_function import compute_transfer_function_arrays
from biahub_tpu_torch.convert import (
    chain_from_reference,
    concatenate_settings_from_reference,
    deconvolve_settings_from_reference,
    deskew_settings_from_reference,
    flat_field_settings_from_reference,
    fuse_settings_from_reference,
    module_from_reference,
    registration_settings_from_reference,
    reconstruction_settings_from_reference,
    registration_estimate_settings_from_reference,
    stabilization_settings_from_reference,
    spectral_table_from_reference,
    segmentation_settings_from_reference,
    stitch_settings_from_reference,
    tracking_settings_from_reference,
    transfer_functions_from_reference,
)
from biahub_tpu_torch.deconvolve import deconvolve_arrays
from biahub_tpu_torch.deskew import deskew_arrays
from biahub_tpu_torch.device import gpu_info, resolve_device
from biahub_tpu_torch.estimate_psf import estimate_psf_arrays
from biahub_tpu_torch.estimate_registration import estimate_registration_arrays
from biahub_tpu_torch.estimate_stabilization import (
    ArrayPosition,
    estimate_stabilization_arrays,
)
from biahub_tpu_torch.flat_field import flat_field_arrays
from biahub_tpu_torch.fuse import fuse_arrays
from biahub_tpu_torch.kernels.affine import (
    affine_warp_auto,
    affine_warp_zyx,
    inplane_affine_warp_zyx,
    inplane_affine_warp_zyx_batched,
    translation_warp_zyx,
    translation_warp_zyx_batched,
)
from biahub_tpu_torch.kernels.chain import (
    chain_warp_spectral_route,
    deconvolve_deskew_warp,
    deconvolve_deskew_warp_batched,
    deconvolve_then_deskew,
    deconvolve_then_deskew_batched,
    deskew_then_warp,
)
from biahub_tpu_torch.kernels.multipass_warp import (
    chunked_affine_warp_zyx,
    make_traced_multipass_warp,
    multipass_affine_warp_zyx,
    multipass_affine_warp_zyx_batched,
)
from biahub_tpu_torch.kernels.pcc import (
    pcc_corr,
    phase_cross_corr,
    phase_cross_corr_padding,
    subpixel_shift_2d,
)
from biahub_tpu_torch.kernels.peaks import detect_peaks
from biahub_tpu_torch.kernels.spectral import (
    deconvolve_deskew_zyx_spectral,
    prepare_spectral_deskew,
    spectral_deskew_supported,
)
from biahub_tpu_torch.optimize_registration import optimize_registration_arrays
from biahub_tpu_torch.parallel.distributed import (
    barrier,
    is_coordinator,
    maybe_initialize_distributed,
    process_count,
    process_index,
)
from biahub_tpu_torch.parallel.mesh import GlobalMesh, Mesh, get_global_mesh, get_mesh
from biahub_tpu_torch.parallel.sharded_fft import (
    ShardedFilter,
    deconvolve_zyx_sharded,
    fourier_filter_zyx_sharded,
    gather,
    prepare_sharded_filter,
    shard_filter,
    sharded_fft_supported,
)
from biahub_tpu_torch.pipeline import DeconvolveDeskew, DeconvolveDeskewWarp
from biahub_tpu_torch.recon.settings import output_channel_names
from biahub_tpu_torch.reconstruct import reconstruct_arrays
from biahub_tpu_torch.register import register_arrays
from biahub_tpu_torch.runtime.executor import stripe_units
from biahub_tpu_torch.stabilize import apply_stabilization_transform, stabilize_tczyx
from biahub_tpu_torch.kernels.stitch_blend import blend_chunk, pad_distance_map

__all__ = [
    "DeconvolveDeskew",
    "DeconvolveDeskewWarp",
    "module_from_reference",
    "chain_from_reference",
    "affine_warp_auto",
    "affine_warp_zyx",
    "multipass_affine_warp_zyx",
    "multipass_affine_warp_zyx_batched",
    "make_traced_multipass_warp",
    "detect_peaks",
    "estimate_psf_arrays",
    "inplane_affine_warp_zyx",
    "inplane_affine_warp_zyx_batched",
    "deskew_then_warp",
    "deconvolve_then_deskew",
    "deconvolve_then_deskew_batched",
    "deconvolve_deskew_warp",
    "deconvolve_deskew_warp_batched",
    "translation_warp_zyx",
    "translation_warp_zyx_batched",
    "pcc_corr",
    "phase_cross_corr",
    "phase_cross_corr_padding",
    "subpixel_shift_2d",
    "ArrayPosition",
    "estimate_stabilization_arrays",
    "stabilization_settings_from_reference",
    "registration_estimate_settings_from_reference",
    "optimize_registration_arrays",
    "estimate_registration_arrays",
    "apply_stabilization_transform",
    "stabilize_tczyx",
    "compute_transfer_function_arrays",
    "apply_inverse_transfer_function_arrays",
    "reconstruct_arrays",
    "reconstruction_settings_from_reference",
    "transfer_functions_from_reference",
    "deconvolve_deskew_zyx_spectral",
    "prepare_spectral_deskew",
    "spectral_deskew_supported",
    "chain_warp_spectral_route",
    "spectral_table_from_reference",
    "output_channel_names",
    "deconvolve_arrays",
    "deconvolve_settings_from_reference",
    "GlobalMesh",
    "Mesh",
    "get_global_mesh",
    "get_mesh",
    "ShardedFilter",
    "deconvolve_zyx_sharded",
    "fourier_filter_zyx_sharded",
    "gather",
    "prepare_sharded_filter",
    "shard_filter",
    "sharded_fft_supported",
    "maybe_initialize_distributed",
    "process_index",
    "process_count",
    "is_coordinator",
    "barrier",
    "stripe_units",
    "gpu_info",
    "resolve_device",
    "deskew_arrays",
    "flat_field_arrays",
    "register_arrays",
    "fuse_arrays",
    "chunked_affine_warp_zyx",
    "deskew_settings_from_reference",
    "flat_field_settings_from_reference",
    "registration_settings_from_reference",
    "fuse_settings_from_reference",
    "stitch_settings_from_reference",
    "segmentation_settings_from_reference",
    "tracking_settings_from_reference",
    "concatenate_settings_from_reference",
    "blend_chunk",
    "pad_distance_map",
]
