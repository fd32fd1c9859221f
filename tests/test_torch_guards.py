"""Guards of the port: no JAX, explicit devices, no silent fallback, no
build at import."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from biahub_tpu_torch import (
    DeconvolveDeskew,
    DeconvolveDeskewWarp,
    Mesh,
    apply_inverse_transfer_function_arrays,
    chain_from_reference,
    compute_transfer_function_arrays,
    deconvolve_arrays,
    get_global_mesh,
    get_mesh,
    module_from_reference,
    reconstruct_arrays,
)
from biahub_tpu_torch.estimate_stabilization import ArrayPosition
from biahub_tpu_torch.estimate_psf import estimate_psf_arrays
from biahub_tpu_torch.estimate_registration import estimate_registration_arrays
from biahub_tpu_torch.kernels import (
    _build,
    affine,
    chain,
    deconvolve,
    deskew,
    fft,
    multipass_warp,
    peaks,
    spectral,
)
from biahub_tpu_torch.kernels.deskew_cuda import deskew as deskew_kernel
from biahub_tpu_torch.kernels.multipass_cuda import (
    resample_pass,
    resample_pass_adjoint,
    resample_pass_deriv,
)
from biahub_tpu_torch.kernels.peaks_cuda import block_max_argmin
from biahub_tpu_torch.kernels.spectral_cuda import lerp_irfft
from biahub_tpu_torch.kernels.warp_cuda import warp_x, warp_zy
from biahub_tpu_torch.optimize_registration import optimize_registration_arrays
from biahub_tpu_torch.parallel import sharded_fft
from biahub_tpu_torch.recon import optics
from biahub_tpu_torch.runtime.executor import BatchRunner
from biahub_tpu_torch.registration import beads, intensity
from biahub_tpu_torch.transforms import Transform
from biahub_tpu_torch.visualize import animation_utils

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "biahub_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "biahub_tpu"}


def imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_reference(path):
    # Exact top-level names: biahub_tpu_torch itself must not match.
    assert not imported_roots(path) & FORBIDDEN


def test_import_scan_matches_names_exactly(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import biahub_tpu_torch\nfrom biahub_tpu.kernels import x\n")
    assert imported_roots(src) & FORBIDDEN == {"biahub_tpu"}


SHAPE = (8, 6, 10)
TF = np.ones((8, 6, 6), np.float32)
RECON = {"input_channel_names": ["BF"], "phase": {}, "fluorescence": {}}
RECON_TFS = {"phase": np.ones(SHAPE, np.complex64), "fluorescence": np.ones(SHAPE, np.complex64)}
VOL = np.zeros(SHAPE, np.float32)
SHIFT = np.eye(4)
SHIFT[:3, 3] = [0.5, -1.0, 2.0]
TILT = np.eye(4)
TILT[0, 2] = TILT[2, 0] = 0.1  # mixes z and x: a general 3D matrix
ENTRY_POINTS = {
    "deconvolve_zyx": lambda: deconvolve.deconvolve_zyx(VOL, TF),
    "deconvolve_czyx": lambda: deconvolve.deconvolve_czyx(VOL[None], TF),
    "deskew_zyx": lambda: deskew.deskew_zyx(VOL, 30.0, 0.4, False),
    "deskew_zyx_batched": lambda: deskew.deskew_zyx_batched(VOL[None], 30.0, 0.4, False),
    "deconvolve_then_deskew": lambda: chain.deconvolve_then_deskew(VOL, TF, 1e-3, 30.0, 0.4),
    "deconvolve_then_deskew_batched": lambda: chain.deconvolve_then_deskew_batched(
        VOL[None], TF, 1e-3, 30.0, 0.4),
    "DeconvolveDeskew": lambda: DeconvolveDeskew(TF, SHAPE, 1e-3, 30.0, 0.4),
    "module_from_reference": lambda: module_from_reference(
        TF, {"pixel_size_um": 0.116, "ls_angle_deg": 30.0, "px_to_scan_ratio": 0.4},
        {}, SHAPE),
    "inplane_affine_warp_zyx": lambda: affine.inplane_affine_warp_zyx(VOL, SHIFT, SHAPE),
    "inplane_affine_warp_zyx_batched": lambda: affine.inplane_affine_warp_zyx_batched(
        VOL[None], SHIFT, SHAPE),
    "affine_warp_auto": lambda: affine.affine_warp_auto(VOL, SHIFT, SHAPE),
    "deskew_then_warp": lambda: chain.deskew_then_warp(VOL, 30.0, 0.4, SHIFT),
    "deconvolve_deskew_warp": lambda: chain.deconvolve_deskew_warp(
        VOL, TF, 1e-3, 30.0, 0.4, SHIFT),
    "deconvolve_deskew_warp_batched": lambda: chain.deconvolve_deskew_warp_batched(
        VOL[None], TF, 1e-3, 30.0, 0.4, SHIFT),
    "DeconvolveDeskewWarp": lambda: DeconvolveDeskewWarp(TF, SHAPE, 1e-3, 30.0, 0.4, SHIFT),
    "affine_warp_zyx": lambda: affine.affine_warp_zyx(VOL, TILT, SHAPE),
    "multipass_affine_warp_zyx": lambda: multipass_warp.multipass_affine_warp_zyx(
        VOL, TILT, SHAPE),
    "multipass_affine_warp_zyx_batched": lambda: (
        multipass_warp.multipass_affine_warp_zyx_batched(VOL[None], TILT[None], SHAPE)),
    "detect_peaks": lambda: peaks.detect_peaks(VOL),
    "estimate_psf_arrays": lambda: estimate_psf_arrays(VOL[None]),
    "beads.estimate": lambda: beads.estimate(VOL, VOL),
    "beads.estimate_tczyx": lambda: beads.estimate_tczyx(VOL[None, None], VOL[None, None], 0),
    "beads.optimize_matches": lambda: beads.optimize_matches(VOL, VOL, SHIFT, {}, {}),
    "Transform.apply": lambda: Transform(TILT).apply(VOL),
    "composite_channels": lambda: animation_utils.composite_channels([VOL[0]], [(0.0, 1.0)]),
    "make_traced_multipass_warp": lambda: multipass_warp.make_traced_multipass_warp(
        SHAPE, SHAPE),
    "intensity.estimate": lambda: intensity.estimate(VOL, VOL),
    "intensity.preprocess_czyx": lambda: intensity.preprocess_czyx(VOL[None], VOL[None],
                                                                   TILT),
    "intensity.estimate_czyx": lambda: intensity.estimate_czyx(VOL[None], VOL[None], TILT),
    "intensity.estimate_tczyx": lambda: intensity.estimate_tczyx(VOL[None, None],
                                                                 VOL[None, None], 0, 0),
    "optimize_registration_arrays": lambda: optimize_registration_arrays(
        VOL[None], VOL[None], TILT),
    "estimate_registration_arrays": lambda: estimate_registration_arrays(
        VOL[None, None], VOL[None, None], ["a"], ["b"],
        {"source_channel_name": "a", "target_channel_name": "b", "estimation_method": "ants"},
        [1.0] * 5),
    "phase_wotf_3d": lambda: optics.phase_wotf_3d(SHAPE, 0.325, 2.0, 0.532, 0.52, 1.2, 1.3),
    "fluorescence_otf_3d": lambda: optics.fluorescence_otf_3d(SHAPE, 0.325, 2.0, 0.507, 1.2,
                                                              1.3),
    "tikhonov_inverse_3d": lambda: optics.tikhonov_inverse_3d(VOL, RECON_TFS["phase"], 1e-3),
    "compute_transfer_function_arrays": lambda: compute_transfer_function_arrays(SHAPE, RECON),
    "apply_inverse_transfer_function_arrays": lambda: apply_inverse_transfer_function_arrays(
        VOL[None, None], ["BF"], RECON_TFS, RECON),
    "reconstruct_arrays": lambda: reconstruct_arrays(VOL[None, None], ["BF"], RECON),
    "deconvolve_deskew_zyx_spectral": lambda: spectral.deconvolve_deskew_zyx_spectral(
        VOL, TF, 1e-3, ls_angle_deg=30.0, px_to_scan_ratio=0.4, keep_overhang=False),
    "prepare_spectral_deskew": lambda: spectral.prepare_spectral_deskew(SHAPE, 30.0, 0.4, False),
    "DeconvolveDeskew(spectral=True)": lambda: DeconvolveDeskew(TF, SHAPE, 1e-3, 30.0, 0.4,
                                                                spectral=True),
    "prepare_fourier_filter": lambda: fft.prepare_fourier_filter(SHAPE, TF, 1e-3),
    "prepare_hermitian_filter": lambda: fft.prepare_hermitian_filter(
        SHAPE, RECON_TFS["phase"], 1e-3),
    "get_mesh": lambda: get_mesh(),
    "Mesh.virtual": lambda: Mesh.virtual("cuda", 2),
    "get_global_mesh": lambda: get_global_mesh(),
    "BatchRunner": lambda: BatchRunner(),
    "deskew_czyx": lambda: deskew.deskew_czyx(VOL[None], 30.0, 0.4, False),
    "deconvolve_arrays": lambda: deconvolve_arrays(
        {"A/1/0": ArrayPosition(VOL[None, None], [1.0] * 5, ["a"])}, np.ones((3, 3, 3)),
        [1.0] * 5, {}),
    "deconvolve_arrays(sharded=True)": lambda: deconvolve_arrays(
        {"A/1/0": ArrayPosition(VOL[None, None], [1.0] * 5, ["a"])}, np.ones((3, 3, 3)),
        [1.0] * 5, {}, sharded=True),
    "chain_from_reference": lambda: chain_from_reference(
        TF, {"deconvolve": {}, "deskew": {"pixel_size_um": 0.116, "ls_angle_deg": 30.0,
                                           "px_to_scan_ratio": 0.4},
             "registration": {"affine_transform_zyx": SHIFT.tolist()}}, SHAPE),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_raises_without_cuda(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()


def test_cpu_path_takes_plain_versions_and_counts_no_launch():
    _build.reset_launch_counts()
    out = chain.deconvolve_then_deskew_batched(VOL[None], TF, 1e-3, 30.0, 0.4,
                                               device="cpu")
    assert out.shape == (1,) + deskew.deskew_geometry(SHAPE, 30.0, 0.4, False).out_shape
    assert _build.launch_counts == {}
    out = chain.deconvolve_deskew_warp_batched(VOL[None], TF, 1e-3, 30.0, 0.4, SHIFT,
                                               device="cpu")
    assert out.shape == (1,) + deskew.deskew_geometry(SHAPE, 30.0, 0.4, False).out_shape
    assert _build.launch_counts == {}
    assert multipass_warp.multipass_affine_warp_zyx(VOL, TILT, SHAPE, device="cpu").shape == SHAPE
    assert peaks.detect_peaks(VOL, device="cpu").shape == (0, 3)
    m = torch.tensor(TILT, dtype=torch.float32, requires_grad=True)
    warp = multipass_warp.make_traced_multipass_warp(SHAPE, SHAPE, order=1, device="cpu")
    warp(torch.ones(SHAPE), m).sum().backward()
    assert m.grad is not None
    out = reconstruct_arrays(VOL[None, None] + 1.0, ["BF"], RECON, device="cpu")
    assert out.shape == (1, 2) + SHAPE
    assert _build.launch_counts == {}


def test_sharded_cpu_path_takes_plain_versions_and_counts_no_launch():
    _build.reset_launch_counts()
    mesh = Mesh.virtual("cpu", 2)
    out = sharded_fft.deconvolve_zyx_sharded(VOL, TF, mesh)
    assert [tuple(s.shape) for s in out] == [(4, 6, 10)] * 2
    out = sharded_fft.fourier_filter_zyx_sharded(VOL, RECON_TFS["phase"][..., :6], mesh)
    assert sharded_fft.gather(out, "cpu").shape == SHAPE
    assert _build.launch_counts == {}


def test_wrappers_raise_on_other_devices():
    meta = torch.empty(SHAPE, device="meta")
    spec = torch.empty((8, 6, 6), dtype=torch.complex64, device="meta")
    geo = deskew.deskew_geometry(SHAPE, 30.0, 0.4, False)
    coeffs = affine.inplane_coefficients(SHIFT).to("meta")
    for call in (
        lambda: fft.fwd_yx(meta),
        lambda: fft.z_filter_(spec, torch.empty((8, 6, 6), device="meta")),
        lambda: fft.z_filter_complex_(spec, spec.clone()),
        lambda: fft.inv_yx(spec),
        lambda: fft.z_fwd_filter_(spec, torch.empty((8, 6, 6), device="meta")),
        lambda: fft.z_fwd_filter_(spec, spec.clone()),
        lambda: fft.y_inv_(spec),
        lambda: lerp_irfft(spec, torch.empty((6, 3, 8), dtype=torch.complex64, device="meta"),
                           10, 1),
        lambda: deskew_kernel(meta[None], geo),
        lambda: deskew_kernel(meta[None], geo._replace(skip_flip=True), "xzy"),
        lambda: warp_zy(meta[None], coeffs, (8, 6)),
        lambda: warp_zy(meta[None], coeffs, (8, 6), input_xzy=True),
        lambda: warp_x(meta[None], coeffs, 10, SHAPE),
        lambda: block_max_argmin(meta),
        lambda: resample_pass(meta[None], torch.empty((7, 3), device="meta"), 0, 1, 0),
        lambda: resample_pass_deriv(meta[None], meta[None], torch.empty((7, 3), device="meta"),
                                    0, 1, 0),
        lambda: resample_pass_adjoint(meta[None], torch.empty((7, 3), device="meta"), 0, 1, 0),
    ):
        with pytest.raises(ValueError, match="no kernel or plain version"):
            call()


@pytest.mark.parametrize("shape", [(16, 16, 4097), (1, 16, 16), (16, 16, 16384)])
def test_cuda_shape_gate_rejects_what_the_kernels_do_not_take(shape):
    with pytest.raises(ValueError, match="when a power of two and 2 to 4096 otherwise"):
        fft._check_cuda_shape(shape, "fwd_yx")


@pytest.mark.parametrize("shape", [(16, 14, 40), (86, 1024, 484), (9, 10, 17),
                                   (2, 8192, 4095)])
def test_cuda_shape_gate_accepts_any_length_within_the_limits(shape):
    fft._check_cuda_shape(shape, "fwd_yx")


def test_import_does_not_build():
    """Importing every module of the port starts no process (no nvcc)."""
    code = (
        "import subprocess\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError(f'process started at import: {a}')\n"
        "subprocess.Popen = refuse\n"
        "import importlib, pkgutil, biahub_tpu_torch\n"
        "for m in pkgutil.walk_packages(biahub_tpu_torch.__path__, 'biahub_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from biahub_tpu_torch.kernels import _build\n"
        "assert not _build._libs\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
