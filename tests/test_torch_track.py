"""biahub_tpu_torch's tracking engine and track verb against biahub_tpu's.

The engine runs on scenes of tests/test_tracking_accuracy.py (linear
motion, a division, a gap closed with ``max_gap``, contact repaired by the
hierarchy selection): the label frames bit-equal, the tracks table equal to
the reference's frame column for column (values and dtypes) and its CSV
text equal to the frame's ``to_csv(index=False)``. The verb runs on a plate
the port wrote (two positions of moving blobs, the example settings'
``foreground_contour`` route): the reference through click's runner, the
port through ``cli.main([...], device="cpu")``, with a blank-frames CSV;
labels bit-equal, each ``tracks_{fov}.csv`` equal as text, the positions'
attributes equal. The ``cellpose`` route is refused by name, ``--init``
prints the reference's lines, and the settings reader matches the
reference's model dump.
"""

import json
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
import yaml
from click.testing import CliRunner
from scipy.ndimage import gaussian_filter

from biahub_tpu.cli.main import cli as reference_cli
from biahub_tpu.io.ngff import open_ome_zarr as reference_open
from biahub_tpu.settings import TrackingSettings
from biahub_tpu.tracking import engine as reference_engine
from biahub_tpu_torch.cli.main import main
from biahub_tpu_torch.convert import tracking_settings_from_reference
from biahub_tpu_torch.io.ngff import TransformationMeta, open_ome_zarr
from biahub_tpu_torch.track import get_empty_frames_idx_from_csv, read_blank_frames_csv
from biahub_tpu_torch.tracking import engine
from tests.test_tracking_accuracy import _fg_contour_scene, _scene_from_tracks

POSITIONS = ("A/1/0", "B/1/0")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side on one torch thread: the suite runs several test
    processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _linear():
    return _scene_from_tracks({
        1: {"points": {t: (10 + 2 * t, 10 + 4 * t) for t in range(8)}, "radius": 3},
        2: {"points": {t: (50 - 2 * t, 10 + 4 * t) for t in range(8)}, "radius": 4},
        3: {"points": {t: (30, 80 - 3 * t) for t in range(8)}, "radius": 2.5},
    })[0], dict(max_distance=15.0)


def _division():
    return _scene_from_tracks({
        1: {"points": {t: (32.0, 12 + 6 * t) for t in range(4)}, "radius": 4},
        2: {"points": {t: (32 - 6 * (t - 3), 12 + 6 * t) for t in range(4, 8)}, "radius": 3,
            "parent": 1},
        3: {"points": {t: (32 + 6 * (t - 3), 12 + 6 * t) for t in range(4, 8)}, "radius": 3,
            "parent": 1},
    })[0], dict(max_distance=15.0)


def _gap():
    return _scene_from_tracks({
        1: {"points": {0: (15, 10), 1: (15, 20), 2: (15, 30), 5: (15, 60), 6: (15, 70),
                       7: (15, 80)}, "radius": 4},
        2: {"points": {t: (50, 10 + 10 * t) for t in range(8)}, "radius": 4},
    })[0], dict(max_distance=32.0, max_gap=2)


def frame_equal(table: dict, df: pd.DataFrame) -> None:
    assert list(df.columns) == list(engine.TRACK_COLUMNS)
    for col in engine.TRACK_COLUMNS:
        assert table[col].dtype == df[col].dtype, col
        np.testing.assert_array_equal(table[col], df[col].to_numpy(), err_msg=col)
    assert engine.tracks_csv(table) == df.to_csv(index=False)


@pytest.mark.parametrize("scene", [_linear, _division, _gap])
def test_link_labels_matches_the_reference(scene):
    labels, kwargs = scene()
    want_out, want_df = reference_engine.link_labels(labels, **kwargs)
    got_out, got_table = engine.link_labels(labels, **kwargs)
    assert got_out.dtype == want_out.dtype
    np.testing.assert_array_equal(got_out, want_out)
    frame_equal(got_table, want_df)


def test_hierarchy_selection_matches_the_reference():
    ys1 = [16, 20, 24, 27, 27, 24, 20, 16]
    frames = []
    for t in range(8):
        y1, y2 = ys1[t], 64 - ys1[t]
        frames.append({"disks": [(y1, 48, 6), (y2, 48, 6)],
                       "cores": None if y2 - y1 <= 12 else [(y1, 48), (y2, 48)]})
    fg, ct = _fg_contour_scene(frames)
    for hierarchy in (True, False):
        want_out, want_df = reference_engine.track_from_foreground_contour(
            fg, ct, scale=(0.5, 0.25), max_distance=15.0, hierarchy=hierarchy)
        got_out, got_table = engine.track_from_foreground_contour(
            fg, ct, scale=(0.5, 0.25), max_distance=15.0, hierarchy=hierarchy)
        np.testing.assert_array_equal(got_out, want_out)
        frame_equal(got_table, want_df)


def _blobs(T: int, size: tuple, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    starts = rng.uniform(12, np.array(size) - 12, (n, 2))
    velocities = rng.uniform(-2, 2, (n, 2))
    stack = np.zeros((T,) + size, np.float32)
    for t in range(T):
        frame = np.zeros(size, np.float32)
        for i in range(n):
            cy, cx = np.clip(starts[i] + velocities[i] * t, 0, np.array(size) - 1)
            frame[int(cy), int(cx)] = 100.0
        stack[t] = gaussian_filter(frame, 2.5)
    return stack


def track_config(**extra) -> dict:
    step = {"input_channels": ["nuclei_prediction"], "per_timepoint": True}
    return {
        "target_channel": "nuclei_prediction",
        "output_mode": "2D",
        "z_slicing": {"method": "all"},
        "input_images": [
            {"path": None, "channels": {"nuclei_prediction": []}},
            {"path": None, "channels": {
                "foreground": [dict(step, function="ultrack.imgproc.detect_foreground",
                                    kwargs={"sigma": 10.0, "threshold": 0.5})],
                "contour": [dict(step, function="ultrack.imgproc.robust_invert",
                                 kwargs={"sigma": 1.0})]}},
        ],
        "tracking_config": {"linking_config": {"max_distance": 12}},
        "segmentation_method": "foreground_contour",
        **extra,
    }


@pytest.fixture(scope="module")
def plate(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("track")
    plate = open_ome_zarr(tmp / "vs.zarr", layout="hcs", mode="w",
                          channel_names=["nuclei_prediction"])
    for i, name in enumerate(POSITIONS):
        row, col, fov = name.split("/")
        stack = _blobs(5, (40, 52), 3, seed=i)
        plate.create_position(row, col, fov).create_image(
            "0", stack[:, None, None],
            transform=[TransformationMeta(type="scale", scale=[1, 1, 1, 0.5, 0.5])])
    pd.DataFrame({"FOV": ["A/1/0", "B/1/0"], "t": ["[1, 3]", 0]}).to_csv(
        tmp / "blank.csv", index=False)
    return tmp


def run_both(tmp: Path, config: dict, extra=()) -> tuple[Path, Path, str]:
    cfg = tmp / f"track_{len(list(tmp.iterdir()))}.yml"
    cfg.write_text(yaml.safe_dump(json.loads(json.dumps(config))))
    inputs = [str(tmp / "vs.zarr" / p) for p in POSITIONS]
    ref_out, port_out = tmp / f"ref_{cfg.stem}.zarr", tmp / f"port_{cfg.stem}.zarr"
    result = CliRunner().invoke(reference_cli, ["track", "-i", *inputs, "-c", str(cfg), "-o",
                                                str(ref_out), *extra])
    assert result.exit_code == 0, result.output
    assert main(["track", "-i", *inputs, "-c", str(cfg), "-o", str(port_out), *extra],
                device="cpu") == 0
    return ref_out, port_out, result.output


def test_track_verb_matches_the_reference(plate, capsys):
    config = track_config(blank_frames_path=str(plate / "blank.csv"))
    capsys.readouterr()
    ref_out, port_out, ref_text = run_both(plate, config)
    port_text = capsys.readouterr().out
    assert [x for x in port_text.splitlines() if x.startswith(("RESOURCES", "Tracking"))] == [
        x for x in ref_text.splitlines() if x.startswith(("RESOURCES", "Tracking"))]
    for name in POSITIONS:
        want = reference_open(ref_out / name)
        got = open_ome_zarr(port_out / name, mode="r")
        labels = got.data[...]
        assert labels.dtype == np.uint32 and labels.shape == (5, 1, 1, 40, 52)
        np.testing.assert_array_equal(labels, np.asarray(want.data[...]))
        assert labels.max() >= 2
        assert got.zattrs == dict(want.zattrs)
        csv = f"tracks_{name.replace('/', '_')}.csv"
        assert (port_out / name / csv).read_text() == (ref_out / name / csv).read_text()
    # A/1/0's frames 1 and 3 were blank-filled from 0 and 2: the same labels.
    got = open_ome_zarr(port_out / "A/1/0", mode="r").data[:, 0, 0]
    np.testing.assert_array_equal(got[1], got[0])
    np.testing.assert_array_equal(got[3], got[2])


def test_track_init_and_cellpose_refusal(plate, capsys):
    capsys.readouterr()
    _, port_out, ref_text = run_both(plate, track_config(), extra=["--init"])
    got = capsys.readouterr().out.splitlines()[-2:]
    assert got == [line.replace("ref_", "port_") for line in ref_text.splitlines()[-2:]]
    assert "RESOURCES:" in ref_text
    assert not (port_out / "A/1/0/tracks_A_1_0.csv").exists()
    assert open_ome_zarr(port_out / "A/1/0", mode="r").channel_names == [
        "nuclei_prediction_labels"]
    cfg = plate / "cellpose.yml"
    cfg.write_text(yaml.safe_dump(json.loads(json.dumps(track_config(
        segmentation_method="cellpose", cellpose_config={"diameter": 30})))))
    assert main(["track", "-i", str(plate / "vs.zarr/A/1/0"), "-c", str(cfg), "-o",
                 str(plate / "cp.zarr")], device="cpu") == 1
    assert "cellpose is not installed" in capsys.readouterr().err


def test_settings_and_blank_frames_csv(plate):
    config = track_config(z_slicing={"method": "range", "range": [1, 3]},
                          cellpose_config={"diameter": 60}, blank_frames_path="b.csv")
    assert tracking_settings_from_reference(config) == TrackingSettings(
        **config).model_dump(mode="json")
    with pytest.raises(ValueError, match="OME-Zarr"):
        tracking_settings_from_reference(track_config(
            input_images=[{"path": "x.tif", "channels": {}}]))
    with pytest.raises(ValueError, match="unknown fields"):
        tracking_settings_from_reference(track_config(extra_key=1))
    rows = read_blank_frames_csv(plate / "blank.csv")
    assert get_empty_frames_idx_from_csv(rows, "A/1/0") == [1, 3]
    assert get_empty_frames_idx_from_csv(rows, "B/1/0") is None
    assert get_empty_frames_idx_from_csv(rows, "C/1/0") is None
