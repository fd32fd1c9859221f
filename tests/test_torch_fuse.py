"""biahub_tpu_torch's fuse_arrays against the reference's fuse verb.

Each case runs ``biahub_tpu.fuse.fuse`` once (a module fixture) on a small
OME-Zarr plate (T 2, C 2, float32 (12, 14, 40), 0.116 um pixels) and
``fuse_arrays`` on the same array, covering the reference's stage routes:
one matrix with no fill (the chain, A-F with the xzy handoff), per-timepoint
matrices (in-plane and general), the overhang fill (one matrix and per
timepoint), flat-field as a prefix and as the only stage, and the
over-budget route (``BIAHUB_TPU_MAX_BATCH_BYTES`` for the reference, the
same number as ``max_batch_bytes`` for the port). The reference runs its
XLA routes here; general matrices are held with its accelerator dispatch
patched in (the multipass warp, as the port always takes; on the CPU the
reference's ``affine_warp_auto`` would take its exact gather).

Tolerance: max |port - ref| <= 1e-5 * max |ref| (the FFT engine's and the
warps' envelope; the deconvolution's gain on this plate is about 4e-6).
"""

import numpy as np
import pytest
import torch
import yaml

from biahub_tpu.io.ngff import TransformationMeta, open_ome_zarr
from biahub_tpu.kernels import affine as jaff
from biahub_tpu.kernels import multipass_warp as jmw
from biahub_tpu.kernels.deconvolve import compute_transfer_function
from biahub_tpu.settings import FusePipelineSettings
from biahub_tpu_torch import fuse_arrays, fuse_settings_from_reference
from biahub_tpu_torch.kernels.spectral import spectral_deskew_supported

RTOL = 1e-5
SHAPE = (2, 2, 12, 14, 40)
SCALE = (1, 1, 1.0, 0.116, 0.116)
NAMES = ["GFP", "RFP"]
OVER = 16384  # bytes: below one fused unit of this plate


def about_centre(angles_zyx_deg, shift, centre=(2.0, 20.0, 20.0)) -> np.ndarray:
    from scipy.spatial.transform import Rotation

    m = np.eye(4)
    r = Rotation.from_euler("zyx", angles_zyx_deg, degrees=True).as_matrix()
    m[:3, :3] = r
    m[:3, 3] = np.asarray(centre) - r @ np.asarray(centre) + np.asarray(shift, float)
    return m


DESKEW = {"pixel_size_um": 0.116, "ls_angle_deg": 36.17, "px_to_scan_ratio": 0.371,
          "keep_overhang": False, "average_n_slices": 3}
FILL = dict(DESKEW, keep_overhang=True, overhang_fill="mean")
DECON = {"regularization_strength": 1e-3}
REG = {"affine_transform_zyx": about_centre([0, 0, 3], [0, -0.5, 1.25]).tolist()}
STAB = {"affine_transform_zyx_list": [
    about_centre([0, 0, 1.0 * t], [0, 0.3 * t, -0.4 * t]).tolist() for t in range(2)]}
STAB_3D = {"affine_transform_zyx_list": [
    about_centre([1.0 + t, 2.0 + 2 * t, 0], [0.2, 0.3 * t, -0.4 * t]).tolist() for t in range(2)]}
SHIFTS = {"affine_transform_zyx_list": [
    [[1, 0, 0, 0.0], [0, 1, 0, 0.5 * t], [0, 0, 1, -0.75 * t], [0, 0, 0, 1]] for t in range(2)]}

# name: (settings, budget or None)
CASES = {
    "chain": (dict(deconvolve=DECON, deskew=DESKEW, registration=REG), None),
    "per_timepoint": (dict(deconvolve=DECON, deskew=DESKEW, registration=REG,
                           stabilization=STAB), None),
    "per_timepoint_general": (dict(deskew=DESKEW, stabilization=STAB_3D,
                                   time_indices=[1], output_shape_zyx=[5, 38, 20]), None),
    "fill": (dict(deconvolve=DECON, deskew=FILL, registration=REG), None),
    "fill_no_warp": (dict(deconvolve=DECON, deskew=FILL), None),
    "flat_field_fill_per_timepoint": (dict(flat_field={"channel_names": ["GFP"]}, deskew=FILL,
                                           stabilization=SHIFTS), None),
    "flat_field_only": (dict(flat_field={"channel_names": ["RFP"]}), None),
    "over_flat_field_fill": (dict(flat_field={"channel_names": ["GFP"]}, deskew=FILL,
                                  stabilization=STAB), OVER),
    "over_general": (dict(deskew=DESKEW, stabilization=STAB_3D), OVER),
    "over_flat_field_only": (dict(flat_field={}), OVER),
}


def psf() -> np.ndarray:
    zz, yy, xx = np.meshgrid(*[np.arange(s) - (s - 1) / 2 for s in (3, 5, 5)], indexing="ij")
    p = np.exp(-(zz ** 2 + yy ** 2 + xx ** 2) / 2).astype(np.float32)
    return p / p.sum()


def tf_half() -> np.ndarray:
    return compute_transfer_function(psf(), SHAPE[2:])[..., : SHAPE[-1] // 2 + 1]


REFERENCE_AUTO = jaff.affine_warp_auto


def accelerator_warp(vol, matrix, output_shape, fill=0.0, order=1, input_xzy=False):
    """The reference's affine_warp_auto as it dispatches on the accelerator
    (affine.py:609-623): general order-1 matrices to the multipass warp."""
    m = np.asarray(matrix, dtype=np.float64)
    if order == 1 and not jaff.is_inplane_matrix(m) and not input_xzy:
        try:
            return jmw.multipass_affine_warp_zyx(vol, m, tuple(output_shape), fill=fill)
        except ValueError:
            pass
    return REFERENCE_AUTO(vol, m, output_shape, fill=fill, order=order, input_xzy=input_xzy)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The plate, and each case's output plate from the reference verb."""
    from biahub_tpu.fuse import fuse

    tmp = tmp_path_factory.mktemp("fuse")
    data = np.random.default_rng(5).uniform(1, 255, SHAPE).astype(np.float32)
    plate = open_ome_zarr(tmp / "in.zarr", layout="hcs", mode="w", channel_names=NAMES)
    plate.create_position("A", "1", "0").create_image(
        "0", data, transform=[TransformationMeta(type="scale", scale=SCALE)])
    psf_plate = open_ome_zarr(tmp / "psf.zarr", layout="hcs", mode="w", channel_names=["PSF"])
    psf_plate.create_position("0", "0", "0").create_image(
        "0", psf()[None, None], transform=[TransformationMeta(type="scale", scale=SCALE)])
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jaff, "affine_warp_auto", accelerator_warp)
        for name, (settings, budget) in CASES.items():
            if budget is None:
                mp.delenv("BIAHUB_TPU_MAX_BATCH_BYTES", raising=False)
            else:
                mp.setenv("BIAHUB_TPU_MAX_BATCH_BYTES", str(budget))
            cfg = tmp / f"{name}.yml"
            cfg.write_text(yaml.safe_dump(settings))
            dest = tmp / name / "out.zarr"
            fuse([tmp / "in.zarr" / "A" / "1" / "0"], cfg, dest,
                 psf_dirpath=tmp / "psf.zarr" if "deconvolve" in settings else None,
                 cluster="debug", monitor=False)
            out[name] = np.asarray(open_ome_zarr(dest / "A" / "1" / "0").data[:])
    return data, out


@pytest.mark.parametrize("name", list(CASES))
def test_fuse_arrays_matches_the_reference_verb(reference, name, capsys):
    data, out = reference
    settings, budget = CASES[name]
    got = fuse_arrays(data, NAMES, settings, tf_half=tf_half(), device="cpu",
                      **({} if budget is None else {"max_batch_bytes": budget}))
    want = out[name]
    assert got.shape == want.shape and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= RTOL * np.abs(want).max()
    assert ("composing the standalone verbs' chunked kernels" in capsys.readouterr().err) \
        == (budget is not None)
    assert got.device.type == "cpu"


def test_fuse_arrays_uint16_and_spectral_routes(reference):
    """uint16 input equals its float32 copy on the chain; the spectral
    engine, where the geometry takes it, agrees with the composition within
    the engine's 2e-4."""
    data, _ = reference
    settings = CASES["chain"][0]
    counts = np.round(data).astype(np.uint16)
    a = fuse_arrays(counts, NAMES, settings, tf_half(), device="cpu")
    b = fuse_arrays(counts.astype(np.float32), NAMES, settings, tf_half(), device="cpu")
    assert torch.equal(a, b)
    assert spectral_deskew_supported(SHAPE[2:], 36.17, 0.371, False, 3)
    c = fuse_arrays(data, NAMES, settings, tf_half(), device="cpu", spectral=True)
    d = fuse_arrays(data, NAMES, settings, tf_half(), device="cpu")
    assert (c - d).abs().max() <= 2e-4 * d.abs().max()


def test_fuse_arrays_raises_as_the_reference(reference):
    data, _ = reference
    chain = CASES["chain"][0]
    with pytest.raises(ValueError, match="One deconvolution volume needs"):
        fuse_arrays(data, NAMES, chain, tf_half(), max_batch_bytes=OVER, device="cpu")
    with pytest.raises(ValueError, match="needs a PSF"):
        fuse_arrays(data, NAMES, chain, device="cpu")
    with pytest.raises(ValueError, match="affine_transform_zyx_list has 2 matrices"):
        fuse_arrays(data, NAMES, dict(CASES["per_timepoint"][0], time_indices=[2]),
                    tf_half(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fuse_arrays(data, NAMES, chain, tf_half())


@pytest.mark.parametrize("settings", [
    {"deskew": DESKEW},
    {"flat_field": {}, "registration": REG, "output_shape_zyx": [4, 5, 6]},
    {"flat_field": {"channel_names": ["GFP"]}, "deconvolve": {}, "deskew": FILL,
     "stabilization": SHIFTS, "time_indices": 1, "output_ome_zarr_version": "0.5"},
])
def test_fuse_settings_read_as_the_model(settings):
    ref = FusePipelineSettings(**settings)
    got = fuse_settings_from_reference(settings)
    for block in ("flat_field", "registration", "stabilization"):
        model = getattr(ref, block)
        assert got[block] == (None if model is None else model.model_dump())
    if ref.deconvolve is not None:
        assert got["deconvolve"] == ref.deconvolve.model_dump()
    if ref.deskew is not None:
        assert got["deskew"]["px_to_scan_ratio"] == ref.deskew.px_to_scan_ratio
        assert got["deskew"]["overhang_fill"] == ref.deskew.overhang_fill
    for field in ("time_indices", "output_shape_zyx", "output_ome_zarr_version"):
        assert got[field] == getattr(ref, field)


@pytest.mark.parametrize("settings", [
    {},
    {"deskew": DESKEW, "output_shape_zyx": [4, 5, 6]},
    {"registration": REG, "output_shape_zyx": [4, 5]},
    {"registration": REG, "extra": 1},
    {"stabilization": {"affine_transform_zyx_list": []}},
    {"flat_field": {"channel_names": "GFP"}},
])
def test_fuse_settings_refused_as_the_model(settings):
    with pytest.raises(ValueError):
        FusePipelineSettings(**settings)
    with pytest.raises(ValueError):
        fuse_settings_from_reference(settings)
