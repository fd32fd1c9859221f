"""biahub_tpu_torch's deskew, flat-field, register and stabilize verbs on
arrays, and the overhang fill and flat-field kernels, against biahub_tpu.

The reference verbs run once per case on small OME-Zarr plates (module
fixtures), in budget and, with ``BIAHUB_TPU_MAX_BATCH_BYTES``, over it; the
port gets the same number as ``max_batch_bytes``. Tolerances, each stated
where it is used:

- the overhang mask exactly, the fill within 1e-6 of max |ref| (the port
  sums the mean in float64, the reference in float32);
- flat-field within 1e-6 of max |ref| (float32 division; the pattern's mean
  summed in another order);
- the deskew within 1e-5 of max |ref| (the kernel tests' envelope); the
  jitted reference deskew is wrong at a few geometries with
  ``keep_overhang`` and averaging (ROADMAP queue 3), and is run there
  under ``jax.disable_jit()``;
- register and stabilize within 1e-5 of max |ref| (the warps' envelope),
  the crop slices and the channel order equal. General matrices are held
  against the reference with its accelerator dispatch patched in (the
  multipass warp; on the CPU it would take its exact gather).
"""

import jax
import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner
from scipy.spatial.transform import Rotation

from biahub_tpu import register as jreg
from biahub_tpu.cli.main import cli
from biahub_tpu.io.ngff import TransformationMeta, open_ome_zarr
from biahub_tpu.kernels import affine as jaff
from biahub_tpu.kernels import deskew as jdk
from biahub_tpu.kernels import multipass_warp as jmw
from biahub_tpu.kernels.flat_field import flat_field_zyx as j_flat_field_zyx
from biahub_tpu.settings import FlatFieldCorrectionSettings, RegistrationSettings
from biahub_tpu_torch import (
    deskew_arrays,
    flat_field_arrays,
    flat_field_settings_from_reference,
    register_arrays,
    registration_settings_from_reference,
    stabilize_tczyx,
)
from biahub_tpu_torch import register as treg
from biahub_tpu_torch.kernels import deskew as tdk
from biahub_tpu_torch.kernels.flat_field import flat_field_zyx

SCALE = (1, 1, 1.0, 0.116, 0.116)
DESKEW_SHAPE = (2, 2, 12, 14, 40)
OVER = 4096  # bytes: below one volume of every plate here


def close(got, want, rtol: float) -> None:
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


def write_plate(path, data, channel_names):
    plate = open_ome_zarr(path, layout="hcs", mode="w", channel_names=list(channel_names))
    plate.create_position("A", "1", "0").create_image(
        "0", data, transform=[TransformationMeta(type="scale", scale=SCALE)])
    return path / "A" / "1" / "0"


def read_plate(path) -> np.ndarray:
    return np.asarray(open_ome_zarr(path / "A" / "1" / "0").data[:])


def accelerator_warp(vol, matrix, output_shape, fill=0.0, order=1, input_xzy=False):
    """The reference's affine_warp_auto as it dispatches on the accelerator
    (affine.py:609-623): general order-1 matrices to the multipass warp."""
    m = np.asarray(matrix, dtype=np.float64)
    if order == 1 and not jaff.is_inplane_matrix(m):
        try:
            return jmw.multipass_affine_warp_zyx(vol, m, tuple(output_shape), fill=fill)
        except ValueError:
            pass
    return REFERENCE_AUTO(vol, m, output_shape, fill=fill, order=order, input_xzy=input_xzy)


REFERENCE_AUTO = jaff.affine_warp_auto


def about_centre(shape, angles_zyx_deg, shift) -> np.ndarray:
    m = np.eye(4)
    r = Rotation.from_euler("zyx", angles_zyx_deg, degrees=True).as_matrix()
    c = (np.asarray(shape, float) - 1) / 2
    m[:3, :3] = r
    m[:3, 3] = c - r @ c + np.asarray(shift, float)
    return m


# -- the overhang fill and the flat-field kernel ------------------------------


def overhang_volume(seed: int) -> np.ndarray:
    """A deskewed-like volume: a zero wedge, a few isolated zeros, signal."""
    rng = np.random.default_rng(seed)
    vol = rng.uniform(0.5, 2.0, (9, 16, 30)).astype(np.float32)
    z, x = np.meshgrid(np.arange(9), np.arange(30), indexing="ij")
    vol[np.broadcast_to((x < 2 * z)[:, None, :], vol.shape)] = 0.0
    vol[rng.random(vol.shape) < 0.01] = 0.0
    return vol


@pytest.mark.parametrize("iterations", [0, 1, 3])
def test_overhang_mask_matches_reference(iterations):
    vol = overhang_volume(1)
    want = np.asarray(jdk.overhang_mask(vol, iterations))
    got = tdk.overhang_mask(torch.from_numpy(vol), iterations).numpy()
    np.testing.assert_array_equal(got, want)
    # A batch takes each volume's own mask.
    both = tdk.overhang_mask(torch.from_numpy(np.stack([vol, overhang_volume(2)])), iterations)
    np.testing.assert_array_equal(both[0].numpy(), want)


@pytest.mark.parametrize("fill", [None, 2.5])
def test_fill_overhang_matches_reference(fill):
    vol = overhang_volume(3)
    want = np.asarray(jdk.fill_overhang(vol, fill_value=fill))
    got = tdk.fill_overhang(torch.from_numpy(vol), fill_value=fill)
    close(got, want, 1e-6)
    mask = np.asarray(jdk.overhang_mask(vol))
    np.testing.assert_array_equal(got.numpy()[~mask], vol[~mask])


# (shape, angle, ratio, average_window): the geometries where the jitted
# reference deskew is wrong on the CPU (ROADMAP queue 3), then the example's.
FILL_GEOMETRIES = [((12, 7, 20), 36.17, 1.0, 3), ((12, 7, 20), 36.17, 1.0, 5),
                   ((7, 5, 33), 60.0, 2.3, 4), ((12, 14, 40), 36.17, 0.371, 3)]
JIT_FAULT = 3  # the first three


@pytest.mark.parametrize("case", range(len(FILL_GEOMETRIES)))
def test_deskew_fill_matches_reference(case):
    shape, angle, ratio, avg = FILL_GEOMETRIES[case]
    vol = np.random.default_rng(case).random(shape, dtype=np.float32)
    for fill in ("mean", 1.5):
        if case < JIT_FAULT:
            with jax.disable_jit():
                want = np.asarray(jdk.deskew_zyx(vol, angle, ratio, True, average_window=avg,
                                                 overhang_fill=fill))
        else:
            want = np.asarray(jdk.deskew_zyx(vol, angle, ratio, True, average_window=avg,
                                             overhang_fill=fill))
        got = tdk.deskew_zyx(vol, angle, ratio, True, avg, overhang_fill=fill, device="cpu")
        close(got, want, 1e-5)
        batched = tdk.deskew_zyx_batched(np.stack([vol, vol]), angle, ratio, True, avg,
                                         overhang_fill=fill, device="cpu")
        assert torch.equal(batched[1], got)


@pytest.mark.parametrize("z", [8, 9])
def test_flat_field_zyx_matches_reference(z):
    """An even Z averages the two middle values, as jnp.median does."""
    vol = np.random.default_rng(z).uniform(10, 200, (z, 6, 7)).astype(np.float32)
    want = np.asarray(j_flat_field_zyx(vol))
    close(flat_field_zyx(vol, device="cpu"), want, 1e-6)
    vol_u16 = np.round(vol).astype(np.uint16)
    close(flat_field_zyx(vol_u16, device="cpu"), np.asarray(j_flat_field_zyx(vol_u16)), 1e-6)


# -- the deskew and flat-field verbs -----------------------------------------


@pytest.fixture(scope="module")
def deskew_plates(tmp_path_factory):
    """The reference deskew verb with settings/example_deskew_settings.yml,
    in budget and over it."""
    from biahub_tpu.deskew import deskew

    tmp = tmp_path_factory.mktemp("deskew")
    data = np.random.default_rng(7).uniform(1, 255, DESKEW_SHAPE).astype(np.float32)
    pos = write_plate(tmp / "in.zarr", data, ["GFP", "RFP"])
    with open("settings/example_deskew_settings.yml") as f:
        settings = yaml.safe_load(f)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, budget in (("in", None), ("over", OVER)):
            if budget is not None:
                mp.setenv("BIAHUB_TPU_MAX_BATCH_BYTES", str(budget))
            deskew([pos], "settings/example_deskew_settings.yml", tmp / f"out_{name}.zarr",
                   cluster="debug", monitor=False)
            out[name] = read_plate(tmp / f"out_{name}.zarr")
    return data, settings, out


@pytest.mark.parametrize("route", ["in", "over"])
def test_deskew_arrays_matches_the_reference_verb(deskew_plates, route, capsys):
    data, settings, want = deskew_plates
    budget = {} if route == "in" else {"max_batch_bytes": OVER}
    got = deskew_arrays(data, settings, device="cpu", **budget)
    close(got, want[route], 1e-5)
    assert ("X-slabs" in capsys.readouterr().err) == (route == "over")


def test_deskew_arrays_needs_a_card_by_default(deskew_plates):
    data, settings, _ = deskew_plates
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deskew_arrays(data, settings)


@pytest.fixture(scope="module")
def flat_field_plates(tmp_path_factory):
    from biahub_tpu.flat_field import flat_field

    tmp = tmp_path_factory.mktemp("flat_field")
    data = np.random.default_rng(8).integers(100, 60000, (2, 3, 8, 6, 10)).astype(np.uint16)
    pos = write_plate(tmp / "in.zarr", data, ["GFP", "RFP", "BF"])
    out = {}
    for name, names in (("two", ["RFP", "BF"]), ("all", None)):
        cfg = tmp / f"{name}.yml"
        cfg.write_text(yaml.safe_dump({"channel_names": names}))
        flat_field([pos], cfg, tmp / f"{name}.zarr", cluster="debug", monitor=False)
        out[name] = (read_plate(tmp / f"{name}.zarr"), names)
    return data, out


@pytest.mark.parametrize("case", ["two", "all"])
def test_flat_field_arrays_matches_the_reference_verb(flat_field_plates, case):
    data, out = flat_field_plates
    want, names = out[case]
    got = flat_field_arrays(data, ["GFP", "RFP", "BF"], {"channel_names": names}, device="cpu")
    close(got, want, 1e-6)
    if names is not None:
        np.testing.assert_array_equal(got[:, 0].numpy(), data[:, 0].astype(np.float32))


def test_flat_field_channel_errors_are_the_reference_messages():
    data = np.ones((1, 2, 3, 4, 5), np.float32)
    with pytest.raises(ValueError, match="Channel 'X' not found in input dataset"):
        flat_field_arrays(data, ["a", "b"], {"channel_names": ["X"]}, device="cpu")
    with pytest.raises(ValueError, match="Must specify either 'channel_names'"):
        flat_field_arrays(data, ["a", "b"], {"channel_names": []}, device="cpu")
    with pytest.raises(ValueError, match="unknown fields"):
        flat_field_arrays(data, ["a", "b"], {"channels": ["a"]}, device="cpu")


# -- the register verb --------------------------------------------------------

REG_SOURCE = (2, 2, 8, 30, 36)
REG_TARGET = (2, 2, 8, 28, 34)
REG_MATRICES = {
    "inplane": about_centre(REG_SOURCE[2:], [0, 0, 4], [0.0, 1.5, -2.25]),
    "general": about_centre(REG_SOURCE[2:], [0, 2, 4], [0.5, 1.5, -2.25]),
}
# (matrix, keep_overhang, budget, time_indices, interpolation)
REG_CASES = {
    "inplane_crop": ("inplane", False, None, "all", "linear"),
    "general_crop": ("general", False, None, [1], "linear"),
    "inplane_keep_nearest": ("inplane", True, None, "all", "nearest"),
    "inplane_crop_over": ("inplane", False, OVER, "all", "linear"),
    "general_crop_over": ("general", False, OVER, 0, "linear"),
}


def reg_settings(case: str) -> dict:
    name, keep, _, times, interp = REG_CASES[case]
    return {"source_channel_names": ["Phase3D", "Retardance"], "target_channel_name": "GFP",
            "affine_transform_zyx": REG_MATRICES[name].tolist(), "keep_overhang": keep,
            "time_indices": times, "interpolation": interp}


@pytest.fixture(scope="module")
def register_plates(tmp_path_factory):
    """register_cli on a source and a target plate, each case once, with the
    reference's accelerator dispatch for general matrices."""
    tmp = tmp_path_factory.mktemp("register")
    rng = np.random.default_rng(9)
    source = rng.uniform(0, 100, REG_SOURCE).astype(np.float32)
    target = rng.uniform(0, 100, REG_TARGET).astype(np.float32)
    src = write_plate(tmp / "source.zarr", source, ["Phase3D", "Retardance"])
    tgt = write_plate(tmp / "target.zarr", target, ["GFP", "Phase3D"])
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jreg, "affine_warp_auto", accelerator_warp)
        mp.setattr(jaff, "affine_warp_auto", accelerator_warp)
        for case, (_, _, budget, _, _) in REG_CASES.items():
            if budget is None:
                mp.delenv("BIAHUB_TPU_MAX_BATCH_BYTES", raising=False)
            else:
                mp.setenv("BIAHUB_TPU_MAX_BATCH_BYTES", str(budget))
            cfg = tmp / f"{case}.yml"
            cfg.write_text(yaml.safe_dump(reg_settings(case)))
            res = CliRunner().invoke(cli, ["register", "-s", str(src), "-t", str(tgt), "-c",
                                           str(cfg), "-o", str(tmp / f"{case}.zarr")])
            assert res.exit_code == 0, res.output
            pos = open_ome_zarr(tmp / f"{case}.zarr" / "A" / "1" / "0")
            out[case] = (np.asarray(pos.data[:]), list(pos.channel_names),
                         [float(s) for s in pos.scale[-3:]])
    return source, target, out


@pytest.mark.parametrize("case", sorted(REG_CASES))
def test_register_arrays_matches_the_reference_verb(register_plates, case):
    source, target, out = register_plates
    want, want_names, want_scale = out[case]
    budget = REG_CASES[case][2]
    got, names, voxel = register_arrays(
        source, ["Phase3D", "Retardance"], reg_settings(case), (1.0, 0.116, 0.116), target,
        ["GFP", "Phase3D"], device="cpu",
        **({} if budget is None else {"max_batch_bytes": budget}))
    assert names == want_names == ["GFP", "Phase3D", "Phase3D", "Retardance"]
    np.testing.assert_allclose(voxel, want_scale, rtol=1e-6)
    close(got, want, 1e-5)
    # The output's Phase3D slot is the target's (the reference's index of the
    # first channel of that name), the source's Phase3D warped into it.
    assert got.device.type == "cpu"


def test_register_arrays_one_store_and_crop_matches_reference():
    """Source and target one array: the output channels are the source's;
    the overlap crop equals the reference's at in-plane and general
    matrices."""
    data = np.random.default_rng(10).uniform(0, 1, REG_SOURCE).astype(np.float32)
    crop_matrices = list(REG_MATRICES.values()) + [
        about_centre(REG_SOURCE[2:], angles, shift)
        for angles in ([0, 0, 30], [1, 3, 5], [5, 5, 5], [2, 0, 10])
        for shift in ([0, 0, 0], [0.5, -1.5, 2.25])]
    for m in crop_matrices:
        want = jreg.find_overlapping_volume(REG_SOURCE[2:], REG_TARGET[2:], m)
        assert treg.find_overlapping_volume(REG_SOURCE[2:], REG_TARGET[2:], m,
                                            device="cpu") == want
    settings = {"source_channel_names": ["Retardance"], "target_channel_name": "Phase3D",
                "affine_transform_zyx": REG_MATRICES["inplane"].tolist()}
    got, names, _ = register_arrays(data, ["Phase3D", "Retardance"], settings, device="cpu")
    assert names == ["Phase3D", "Retardance"]
    crop = jreg.find_overlapping_volume(REG_SOURCE[2:], REG_SOURCE[2:],
                                        REG_MATRICES["inplane"])
    np.testing.assert_array_equal(got[:, 0].numpy(), data[:, 0][(slice(None),) + crop])
    want = jreg.apply_affine_transform(data[1, 1], REG_MATRICES["inplane"], REG_SOURCE[2:],
                                       crop_output_slicing=crop)
    close(got[1, 1], want, 1e-5)


def test_register_matrix_helpers_match_reference():
    shape, end = (8, 30, 36), (8, 20, 24)
    for args in ((shape,), (shape, (1.0, 0.5, 2.0)), (shape, (1.0, 0.5, 2.0), end)):
        np.testing.assert_array_equal(treg.get_3D_rescaling_matrix(*args),
                                      jreg.get_3D_rescaling_matrix(*args))
    for args in ((shape,), (shape, 12.5), (shape, 12.5, end)):
        np.testing.assert_array_equal(treg.get_3D_rotation_matrix(*args),
                                      jreg.get_3D_rotation_matrix(*args))
    for args in ((shape,), (shape, end)):
        np.testing.assert_array_equal(treg.get_3D_fliplr_matrix(*args),
                                      jreg.get_3D_fliplr_matrix(*args))
    m = REG_MATRICES["general"]
    np.testing.assert_array_equal(treg.rescale_voxel_size(m[:3, :3], [2.0, 0.1, 0.1]),
                                  jreg.rescale_voxel_size(m[:3, :3], [2.0, 0.1, 0.1]))
    vol = np.random.default_rng(11).random((2,) + shape).astype(np.float32)
    crop = (slice(1, 7), slice(2, 25), slice(3, 30))
    for interp in ("linear", "nearest"):
        want = jreg.apply_affine_transform(vol, REG_MATRICES["inplane"], shape,
                                           interpolation=interp, crop_output_slicing=crop)
        close(treg.apply_affine_transform(vol, REG_MATRICES["inplane"], shape, interp, crop,
                                          device="cpu"), want, 1e-5)


@pytest.mark.parametrize("settings", [
    {"source_channel_names": ["a"], "target_channel_name": "b",
     "affine_transform_zyx": np.eye(4).tolist()},
    {"source_channel_names": ["a", "c"], "target_channel_name": "b",
     "affine_transform_zyx": np.eye(4).tolist(), "keep_overhang": True,
     "interpolation": "nearest", "time_indices": [0, 2], "verbose": True,
     "output_ome_zarr_version": "0.5"},
])
def test_registration_and_flat_field_settings_read_as_the_models(settings):
    assert registration_settings_from_reference(settings) == \
        RegistrationSettings(**settings).model_dump()
    for ff in ({}, {"channel_names": ["GFP"]}, {"channel_names": None,
                                                 "output_ome_zarr_version": "0.4"}):
        assert flat_field_settings_from_reference(ff) == \
            FlatFieldCorrectionSettings(**ff).model_dump()
    for bad in (dict(settings, extra=1), dict(settings, affine_transform_zyx=[[1, 0]]),
                dict(settings, time_indices=-1)):
        with pytest.raises(ValueError):
            RegistrationSettings(**bad)
        with pytest.raises(ValueError):
            registration_settings_from_reference(bad)


# -- stabilize over the budget -------------------------------------------------


@pytest.mark.parametrize("kind", ["inplane", "general"])
def test_stabilize_over_budget_matches_the_reference_verb(kind, tmp_path, capsys):
    data = np.random.default_rng(12).uniform(0, 50, (2, 2, 8, 30, 36)).astype(np.float32)
    pos = write_plate(tmp_path / "in.zarr", data, ["GFP", "RFP"])
    angles = [0, 0, 3] if kind == "inplane" else [0, 2, 3]
    mats = [about_centre(data.shape[2:], [a * t for a in angles], [0.0, 0.5 * t, -0.5 * t])
            .astype(np.float32).astype(np.float64) for t in range(2)]
    cfg = tmp_path / "stab.yml"
    cfg.write_text(yaml.safe_dump({
        "stabilization_estimation_channel": "GFP", "stabilization_type": "xyz",
        "stabilization_channels": ["GFP"],
        "affine_transform_zyx_list": [m.tolist() for m in mats]}))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BIAHUB_TPU_MAX_BATCH_BYTES", str(OVER))
        mp.setattr(jaff, "affine_warp_auto", accelerator_warp)
        res = CliRunner().invoke(cli, ["stabilize", "-i", str(pos), "-o",
                                       str(tmp_path / "out.zarr"), "-c", str(cfg)])
    assert res.exit_code == 0, res.output
    capsys.readouterr()
    got = stabilize_tczyx(data, mats, max_batch_bytes=OVER, device="cpu")
    assert "stabilizing in output chunks" in capsys.readouterr().err
    assert got.device.type == "cpu"
    close(got, read_plate(tmp_path / "out.zarr"), 1e-5)
