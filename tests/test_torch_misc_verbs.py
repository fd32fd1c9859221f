"""The port's last eight entries against biahub_tpu's, through click's runner.

estimate-deskew, estimate-crop, estimate-bleaching, process-with-config,
characterize-psf, check-disk-space, crop-background and nf list-positions:
the reference's verb runs through ``CliRunner`` and the port's through
``cli.main([...], device="cpu")`` on the same inputs, which the reference
writes (its default codecs: the port reads them). For each entry:

- the YAMLs are equal; the CSVs parse to the same columns and values,
  exact for crops and peaks, within 1e-9 relative for fits of the same
  patches;
- the bleaching means within 1e-6 relative of numpy's, the fitted lifetime
  within 1e-4 relative of the reference's fit;
- characterize-psf's peaks are exact on an integer-valued volume;
- process-with-config's plate is bit-equal;
- the refusals (a wrong function or channel, ``--interactive`` without
  napari) are the reference's; the printed lines of the host entries are
  the reference's.
"""

import csv
import pickle

import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner
from scipy.ndimage import gaussian_filter

import biahub_tpu.estimate_bleaching as ref_bleaching
from biahub_tpu.cli.main import cli as reference_cli
from biahub_tpu.io.ngff import TransformationMeta as RefTransform
from biahub_tpu.io.ngff import open_ome_zarr as reference_open
from biahub_tpu_torch import plots
from biahub_tpu_torch.cli.main import main
from biahub_tpu_torch.io.ngff import open_ome_zarr

RTOL_FIT = 1e-9


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run_ref(args) -> str:
    result = CliRunner().invoke(reference_cli, [str(a) for a in args])
    assert result.exit_code == 0, result.output
    return result.output


def run_port(args, capsys) -> str:
    capsys.readouterr()
    assert main([str(a) for a in args], device="cpu") == 0
    return capsys.readouterr().out


def load_yaml(path):
    with open(path) as f:
        return yaml.safe_load(f)


def read_csv(path) -> tuple[list, list]:
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def assert_csv_close(got_path, want_path, rtol: float) -> None:
    got_cols, got = read_csv(got_path)
    want_cols, want = read_csv(want_path)
    assert got_cols == want_cols
    assert len(got) == len(want)
    if got:
        np.testing.assert_allclose(np.array(got, float), np.array(want, float), rtol=rtol,
                                   atol=0)


def write_plate(path, data, names, scale=(1, 1, 1, 1, 1), positions=(("A", "1", "0"),),
                attrs=None):
    plate = reference_open(path, layout="hcs", mode="w", channel_names=names)
    for key in positions:
        plate.create_position(*key).create_image(
            "0", data, transform=[RefTransform(type="scale", scale=list(scale))])
    if attrs:
        plate.update_zattrs(attrs)
    return path


# -- estimate-deskew -----------------------------------------------------------


@pytest.mark.parametrize("route", ["values", "points"])
def test_estimate_deskew(tmp_path, capsys, route):
    plate = write_plate(tmp_path / "p.zarr", np.ones((1, 1, 4, 5, 6), np.float32), ["GFP"])
    args = ["-i", plate / "A/1/0", "--pixel-size-um", "0.116", "--scan-step-um", "0.313"]
    if route == "values":
        args += ["--ls-angle-deg", "36.17"]
    else:
        rect = np.array([[10.0, 0.0, 19.0], [10.0, 0.0, 100.0], [40.0, 0.0, 100.0],
                         [40.0, 0.0, 19.0]])
        np.savetxt(tmp_path / "rect.csv", rect, delimiter=",")
        theta = np.deg2rad(36.17)
        np.save(tmp_path / "line.npy", np.array([[0.0, 0.0], [np.cos(theta) * 0.37, 1.0]]))
        args += ["--rect-points", tmp_path / "rect.csv", "--line-points", tmp_path / "line.npy"]
    ref_out = run_ref(["estimate-deskew", *args, "-o", tmp_path / "ref.yml"])
    port_out = run_port(["estimate-deskew", *args, "-o", tmp_path / "port.yml"], capsys)
    assert load_yaml(tmp_path / "port.yml") == load_yaml(tmp_path / "ref.yml")
    assert (tmp_path / "port.yml").read_text() == (tmp_path / "ref.yml").read_text()
    assert port_out.replace("port.yml", "ref.yml") == ref_out


def test_estimate_deskew_refusals(tmp_path, capsys):
    plate = write_plate(tmp_path / "p.zarr", np.ones((1, 1, 4, 5, 6), np.float32), ["GFP"])
    for extra in (["--interactive", "--pixel-size-um", "0.116", "--scan-step-um", "0.3"],
                  ["--ls-angle-deg", "30"],
                  ["--pixel-size-um", "0.116", "--scan-step-um", "0.3"]):
        args = ["estimate-deskew", "-i", str(plate / "A/1/0"), "-o", str(tmp_path / "x.yml"),
                *extra]
        ref = CliRunner().invoke(reference_cli, args)
        assert ref.exit_code == 1
        capsys.readouterr()
        assert main(args, device="cpu") == 1
        assert capsys.readouterr().err.strip() in ref.output


# -- estimate-crop -------------------------------------------------------------


def crop_arms(tmp_path, t=2, zyx=(10, 24, 20)):
    """Two arms of two positions each, zero outside known boxes; one blank
    frame in the second position of the light-sheet arm."""
    positions = (("A", "1", "0"), ("B", "2", "0"))
    boxes = {"lf": (slice(1, 9), slice(2, 22), slice(3, 18)),
             "ls": (slice(2, 10), slice(1, 20), slice(2, 17))}
    rng = np.random.default_rng(5)
    for arm, box in boxes.items():
        plate = reference_open(tmp_path / f"{arm}.zarr", layout="hcs", mode="w",
                               channel_names=["c0", "c1"])
        for i, key in enumerate(positions):
            data = np.zeros((t, 2) + zyx, np.float32)
            data[(slice(None), slice(None)) + box] = rng.uniform(1, 100, (t, 2) + tuple(
                s.stop - s.start for s in box))
            if arm == "ls" and i == 1:
                data[0] = 0  # a blank frame, dropped by the median filter
            plate.create_position(*key).create_image("0", data)
    config = {"concat_data_paths": ["lf.zarr/*/*/*", "ls.zarr/*/*/*"],
              "time_indices": "all", "channel_names": ["all", "all"]}
    (tmp_path / "concat.yml").write_text(yaml.safe_dump(config))
    return tmp_path / "concat.yml"


@pytest.mark.parametrize("radius", [None, 0.9])
def test_estimate_crop(tmp_path, capsys, radius):
    config = crop_arms(tmp_path)
    extra = [] if radius is None else ["--lf-mask-radius", str(radius)]
    ref_out = run_ref(["estimate-crop", "-c", config, "-o", tmp_path / "ref.yml", "--local",
                       *extra])
    port_out = run_port(["estimate-crop", "-c", config, "-o", tmp_path / "port.yml", "--local",
                         *extra], capsys)
    assert load_yaml(tmp_path / "port.yml") == load_yaml(tmp_path / "ref.yml")
    assert load_yaml(tmp_path / "port.yml")["Z_slice"] == [2, 9]
    assert port_out.replace("port.yml", "ref.yml") == ref_out

    from biahub_tpu.estimate_crop import estimate_crop_one_position as ref_one
    from biahub_tpu_torch.estimate_crop import estimate_crop_one_position as port_one

    args = (tmp_path / "lf.zarr/B/2/0", tmp_path / "ls.zarr/B/2/0", radius)
    assert port_one(*args, output_dir=tmp_path / "port_csv") == ref_one(
        *args, output_dir=tmp_path / "ref_csv")
    assert ((tmp_path / "port_csv/B_2_0.csv").read_text()
            == (tmp_path / "ref_csv/B_2_0.csv").read_text())


# -- estimate-bleaching --------------------------------------------------------


def test_estimate_bleaching(tmp_path, capsys, monkeypatch):
    tau, t_count = 40.0, 6
    times = np.arange(t_count) * 12.0  # Interval_ms 720000: 12 minutes a frame
    rng = np.random.default_rng(3)
    decay = 300 * np.exp(-times / tau) + 200
    data = np.stack([np.stack([rng.poisson(decay[t] * (1 + 0.5 * c), (6, 10, 12))
                               for c in range(2)]) for t in range(t_count)]).astype(np.uint16)
    plate = write_plate(tmp_path / "p.zarr", data, ["GFP", "mCherry"],
                        attrs={"Summary": {"Interval_ms": 720000}})
    fits = []
    curve_fit = ref_bleaching.curve_fit

    def recording(*args, **kwargs):
        popt, pcov = curve_fit(*args, **kwargs)
        fits.append(popt)
        return popt, pcov

    monkeypatch.setattr(ref_bleaching, "curve_fit", recording)
    ref_out = run_ref(["estimate-bleaching", "-i", plate / "A/1/0", "-o", tmp_path / "ref"])
    port_out = run_port(["estimate-bleaching", "-i", plate / "A/1/0", "-o", tmp_path / "port"],
                        capsys)
    assert port_out == ref_out
    assert "Curve fit successful!" in port_out and "GFP - " in port_out

    from biahub_tpu_torch.estimate_bleaching import estimate_bleaching

    got = estimate_bleaching([plate / "A/1/0"], tmp_path / "again", device="cpu")["A/1/0"]
    np.testing.assert_allclose(got[0], times)
    np.testing.assert_allclose(got[1], data.mean(axis=(2, 3, 4), dtype=np.float64), rtol=1e-6)
    np.testing.assert_allclose(got[2], data.astype(np.float64).std(axis=(2, 3, 4)), rtol=1e-6)
    for popt, want in zip(got[3], fits):
        np.testing.assert_allclose(popt[1], want[1], rtol=1e-4)
    assert abs(got[3][0][1] / tau - 1) < 0.2
    assert (tmp_path / "port/A/1/0/bleaching.svg").exists()


# -- process-with-config -------------------------------------------------------


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_process_with_config(tmp_path, capsys, mode):
    data = np.random.default_rng(9).integers(100, 4000, (3, 2, 4, 6, 10), dtype=np.uint16)
    plate = write_plate(tmp_path / "p.zarr", data, ["BF", "GFP"],
                        scale=(1, 1, 2.0, 0.5, 0.25), positions=(("A", "1", "0"), ("A", "2", "0")))
    config = {"processing_functions": [{"function": "biahub.process_data.binning_czyx",
                                        "input_channels": ["BF"],
                                        "kwargs": {"binning_factor_zyx": [1, 2, 2],
                                                   "mode": mode}}]}
    (tmp_path / "proc.yml").write_text(yaml.safe_dump(config))
    inputs = [plate / "A/1/0", plate / "A/2/0"]
    ref_out = run_ref(["process-with-config", "-i", *inputs, "-c", tmp_path / "proc.yml", "-o",
                       tmp_path / "ref.zarr"])
    port_out = run_port(["process-with-config", "-i", *inputs, "-c", tmp_path / "proc.yml", "-o",
                         tmp_path / "port.zarr"], capsys)
    assert port_out.replace("port.zarr", "ref.zarr") == ref_out
    for key in ("A/1/0", "A/2/0"):
        got = open_ome_zarr(tmp_path / "port.zarr" / key)
        want = reference_open(tmp_path / "ref.zarr" / key)
        assert got.data[...].tobytes() == want.data[...].tobytes()
        assert got.data.shape == (3, 2, 4, 3, 5) and got.data.dtype == np.float32
        assert got.zattrs == want.zattrs


def test_process_with_config_refusals(tmp_path):
    data = np.ones((1, 1, 2, 4, 4), np.uint16)
    plate = write_plate(tmp_path / "p.zarr", data, ["BF"])
    for i, (proc, match) in enumerate((
            ({"function": "np.not_a_function", "input_channels": ["BF"]}, "Invalid function"),
            ({"function": "np.sqrt", "input_channels": ["GFP"]}, "not in list"),
            ({"function": "np.sqrt"}, "Channel must be specified"))):
        (tmp_path / "proc.yml").write_text(yaml.safe_dump({"processing_functions": [proc]}))
        args = ["process-with-config", "-i", str(plate / "A/1/0"), "-c",
                str(tmp_path / "proc.yml"), "-o", str(tmp_path / f"out{i}.zarr")]
        ref = CliRunner().invoke(reference_cli, args)
        assert isinstance(ref.exception, ValueError) and match in str(ref.exception)
        with pytest.raises(ValueError, match=match):
            main(args, device="cpu")


# -- characterize-psf ----------------------------------------------------------


def bead_volume(shape=(32, 96, 96), sigma=(1.2, 1.8, 1.8)):
    """Integer-valued beads on a noisy floor (uint16): peaks tie exactly
    between the routes."""
    rng = np.random.default_rng(0)
    vol = np.zeros(shape, np.float32)
    for z, y, x in ((12, 20, 20), (16, 30, 70), (20, 70, 30), (14, 72, 74)):
        vol[z, y, x] = 5000.0
    vol = gaussian_filter(vol, sigma) * 30 + rng.normal(10, 1, shape)
    return np.round(vol).astype(np.uint16)


@pytest.mark.parametrize("plot_type,robust", [("3D", False), ("1D", True)])
def test_characterize_psf(tmp_path, capsys, plot_type, robust):
    plate = write_plate(tmp_path / "beads.zarr", bead_volume()[None, None], ["GFP"],
                        scale=(1, 1, 0.2, 0.1, 0.1), positions=(("0", "0", "0"),))
    config = {"block_size": [16, 16, 16], "blur_kernel_size": 3, "nms_distance": 8,
              "min_distance": 0, "threshold_abs": 50.0, "max_num_peaks": 50,
              "exclude_border": [2, 4, 4], "patch_size": [2.0, 1.6, 1.6],
              "axis_labels": ["SCAN", "TILT", "COVERSLIP"], "offset": 10, "gain": 2,
              "use_robust_1d_fwhm": robust, "fwhm_plot_type": plot_type}
    (tmp_path / "psf.yml").write_text(yaml.safe_dump(config))
    args = ["characterize-psf", "-i", plate / "0/0/0", "-c", tmp_path / "psf.yml", "-o"]
    run_ref(args + [tmp_path / "ref"])
    out = run_port(args + [tmp_path / "port"], capsys)
    assert "Number of peaks detected" in out and f"Report saved to {tmp_path / 'port'}" in out
    with open(tmp_path / "port/peaks.pkl", "rb") as f:
        peaks = pickle.load(f)
    with open(tmp_path / "ref/peaks.pkl", "rb") as f:
        want = pickle.load(f)
    assert peaks.dtype == want.dtype and np.array_equal(peaks, want) and len(peaks) == 4
    for name in ("psf_gaussian_fit.csv", "psf_1d_peak_width.csv"):
        assert_csv_close(tmp_path / "port" / name, tmp_path / "ref" / name, RTOL_FIT)
    html = (tmp_path / "port/psf_analysis_report.html").read_text()
    assert html == (tmp_path / "ref/psf_analysis_report.html").read_text()
    assert sorted(p.name for p in (tmp_path / "port/plots").iterdir()) == sorted(
        p.name for p in (tmp_path / "ref/plots").iterdir())


def test_characterize_psf_without_matplotlib(tmp_path, capsys, monkeypatch):
    plate = write_plate(tmp_path / "beads.zarr", bead_volume()[None, None], ["GFP"],
                        scale=(1, 1, 0.2, 0.1, 0.1), positions=(("0", "0", "0"),))
    config = {"block_size": [16, 16, 16], "nms_distance": 8, "min_distance": 0,
              "threshold_abs": 50.0, "exclude_border": [2, 4, 4], "patch_size": [2.0, 1.6, 1.6]}
    (tmp_path / "psf.yml").write_text(yaml.safe_dump(config))
    monkeypatch.setattr(plots, "pyplot", lambda path: None)
    monkeypatch.setattr("biahub_tpu_torch.characterize_psf.pyplot", lambda path: None)
    run_port(["characterize-psf", "-i", plate / "0/0/0", "-c", tmp_path / "psf.yml", "-o",
              tmp_path / "port"], capsys)
    html = (tmp_path / "port/psf_analysis_report.html").read_text()
    assert "<img" not in html and "Beads: 4, successful fits: 4" in html
    assert not list((tmp_path / "port/plots").iterdir())
    _, rows = read_csv(tmp_path / "port/psf_gaussian_fit.csv")
    assert len(rows) == 4


# -- check-disk-space, crop-background, nf -----------------------------------------


def test_check_disk_space_crop_background_and_nf(tmp_path, capsys):
    plate = write_plate(tmp_path / "p.zarr", np.ones((1, 1, 2, 4, 4), np.float32), ["GFP"],
                        positions=(("A", "1", "0"), ("A", "10", "0"), ("B", "2", "3")))
    for margin in ("1.1", "1e12"):
        args = ["check-disk-space", "-i", plate, "-o", tmp_path / "out.zarr", "--margin",
                margin]
        ref_last = run_ref(args).splitlines()[-1]
        assert run_port(args, capsys).splitlines()[-1] == ref_last
    assert ref_last == "Disk space check failed. Not enough space available."

    videos = tmp_path / "videos"
    videos.mkdir()
    for name in ("b.mp4", "a.mp4", "c.txt"):
        (videos / name).write_bytes(b"not a video")
    args = ["crop-background", videos, tmp_path / "cropped"]
    assert run_port(args, capsys) == run_ref(args)
    assert "No crop detected for" in run_ref(args)

    args = ["nf", "list-positions", plate]
    assert run_port(args, capsys) == run_ref(args)
    assert run_port(args, capsys).split() == ["A/1/0", "A/10/0", "B/2/3"]
    with pytest.raises(SystemExit) as exc:
        main(["nf", "list-positions", str(tmp_path / "missing.zarr")], device="cpu")
    assert exc.value.code == 2
