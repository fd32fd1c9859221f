"""The reference's last public names in biahub_tpu_torch, each against its
biahub_tpu counterpart: ``remove_beads_fov_from_path_list``, the beads
wrappers ``estimate_with_propagation`` / ``estimate_independently``,
``deskew_czyx`` and ``uncentered_deskew_matrix``, the ANTs shims and the
plots of estimate-stabilization and characterize-psf (written where
matplotlib is installed, as here). Deskew tolerance: atol 1e-5 on
unit-range data, as ``tests/test_torch_deskew.py``."""

from pathlib import Path

import numpy as np
import pytest

from biahub_tpu import characterize_psf as jpsf
from biahub_tpu import estimate_stabilization as jes
from biahub_tpu import register as jreg
from biahub_tpu.kernels import deskew as jdk
from biahub_tpu_torch import characterize_psf as tpsf
from biahub_tpu_torch import estimate_stabilization as tes
from biahub_tpu_torch import register as treg
from biahub_tpu_torch.kernels import deskew as tdk
from biahub_tpu_torch.registration import beads

ANGLE, RATIO = 36.17, 0.371


@pytest.mark.parametrize("skip", ["0", "B/2/0", "C/9/9"])
def test_remove_beads_fov_from_path_list(skip):
    paths = [Path("p.zarr/A/1/0"), Path("p.zarr/B/2/0"), Path("p.zarr/B/2/1")]
    assert (tes.remove_beads_fov_from_path_list(paths, skip)
            == jes.remove_beads_fov_from_path_list(paths, skip))


@pytest.mark.parametrize("name,flag", [("estimate_with_propagation", True),
                                       ("estimate_independently", False)])
def test_beads_wrappers_set_the_propagation_flag(monkeypatch, name, flag):
    seen = {}

    def fake(*args, **kwargs):
        seen.update(args=args, kwargs=kwargs)
        return ["ok"]

    monkeypatch.setattr(beads, "estimate_tczyx", fake)
    settings = {"use_prev_t_transform": not flag, "t_reference": "first"}
    assert getattr(beads, name)("mov", "ref", 0, affine_transform_settings=settings) == ["ok"]
    assert seen["args"] == ("mov", "ref", 0)
    assert seen["kwargs"]["affine_transform_settings"] == dict(settings,
                                                               use_prev_t_transform=flag)
    assert settings["use_prev_t_transform"] is (not flag)  # the caller's dict is kept
    getattr(beads, name)("mov", "ref", 0)
    assert seen["kwargs"]["affine_transform_settings"] == {"use_prev_t_transform": flag}


@pytest.mark.parametrize("keep_overhang,avg", [(False, 3), (True, 1)])
def test_deskew_czyx_matches_reference(keep_overhang, avg):
    czyx = np.random.default_rng(2).random((3, 12, 14, 40), dtype=np.float32)
    want = np.asarray(jdk.deskew_czyx(czyx, ANGLE, RATIO, keep_overhang, average_window=avg))
    got = tdk.deskew_czyx(czyx, ANGLE, RATIO, keep_overhang, average_window=avg,
                          device="cpu").numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("raw,out", [((12, 14, 40), (5, 14, 33)), ((86, 1024, 256), (86, 1024, 484))])
def test_uncentered_deskew_matrix_equals_reference(raw, out):
    np.testing.assert_array_equal(tdk.uncentered_deskew_matrix(raw, out, ANGLE, RATIO),
                                  jdk.uncentered_deskew_matrix(raw, out, ANGLE, RATIO))


@pytest.mark.parametrize("name", ["convert_transform_to_ants", "convert_transform_to_numpy"])
def test_ants_shims_raise_as_the_reference(name):
    with pytest.raises(ImportError):
        getattr(jreg, name)(np.eye(4))
    with pytest.raises(ImportError, match="4x4"):
        getattr(treg, name)(np.eye(4))


def test_estimate_stabilization_plots(tmp_path):
    t = np.arange(5)
    shifts = {"TimepointID": t, "ShiftZ": 0.1 * t, "ShiftY": -0.2 * t, "ShiftX": 0.3 * t}
    stats = {"TimepointID": t, "corr_max": 1.0 + t, "corr_sum": 2.0 * t}
    corr = np.random.default_rng(0).random((4, 8, 8)).astype(np.float32)
    for module, root in ((jes, tmp_path / "ref"), (tes, tmp_path / "port")):
        module.plot_pcc_drifts(shifts, root / "drifts.png")
        module.plot_corr_max_min_sum(stats, root / "stats.png")
        module.plot_cross_correlation(corr, output_path=root / "corr.png")
    for name in ("drifts.png", "stats.png", "corr.png"):
        assert (tmp_path / "port" / name).stat().st_size > 0
        assert (tmp_path / "ref" / name).exists()
    with pytest.raises(ValueError, match="output_path"):
        tes.plot_cross_correlation(corr)


def test_characterize_psf_plots(tmp_path):
    rng = np.random.default_rng(1)
    beads_ = [rng.random((5, 7, 7)).astype(np.float32) for _ in range(3)]
    x, y, z, amp = (rng.random(6) for _ in range(4))
    fx, fy, fz = (rng.random(6) for _ in range(3))
    labels = ("AXIS0", "AXIS1", "AXIS2")
    (tmp_path / "ref").mkdir()  # the reference's plot_psf_slices does not make it
    ref_slices = jpsf.plot_psf_slices(tmp_path / "ref", beads_, (1, 1, 1), labels, [4, 5, 6])
    got_slices = tpsf.plot_psf_slices(tmp_path / "port", beads_, (1, 1, 1), labels, [4, 5, 6])
    assert got_slices.name == ref_slices.name and got_slices.stat().st_size > 0
    got = tpsf.plot_fwhm_vs_acq_axes(tmp_path / "port", x, y, z, fx, fy, fz, labels)
    assert [p.name for p in got] == [f"fwhm_vs_{label}.png" for label in labels]
    amp_path = tpsf.plot_psf_amp(tmp_path / "port", x, y, z, amp)
    ref_amp = jpsf.plot_psf_amp(tmp_path / "ref", x, y, z, amp)
    assert amp_path.name == ref_amp.name and amp_path.stat().st_size > 0
