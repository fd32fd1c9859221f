"""biahub_tpu_torch's concatenate verb against biahub_tpu's.

The port writes two plates (float32 "Phase3D"/"BF" at one position;
uint16 "GFP"/"RFP" at three), and each case of tests/test_concatenate.py
runs the reference verb through click's runner and the port's through
``cli.main([...], device="cpu")`` with the same settings: channels from
two plates (float32 and uint16: cast to float32), duplicate channels,
a crop with a time subset, duplicate positions suffixed, per-path crops,
a glob into OME-Zarr 0.5 with ``chunks_czyx``, resolve mode, ``--init``
then ``--resume``, a sharded OME-Zarr 0.5 output (``shards_ratio``), and a
position with pyramid levels (refused). The data
is bit-equal and the metadata equal (every group's attributes, each
array's shape, chunks and dtype; the codecs differ). The settings reader
and the resolve mode's YAML (its text) equal the reference model's.
"""

from pathlib import Path

import numpy as np
import pytest
import yaml
from click.testing import CliRunner

from biahub_tpu.cli.main import cli as reference_cli
from biahub_tpu.concatenate import get_path_slice_param as ref_path_slice_param
from biahub_tpu.concatenate import get_slice as ref_get_slice
from biahub_tpu.io.ngff import open_ome_zarr as reference_open
from biahub_tpu.settings import ConcatenateSettings
from biahub_tpu_torch.cli.main import main
from biahub_tpu_torch.concatenate import get_path_slice_param, get_slice
from biahub_tpu_torch.convert import concatenate_settings_from_reference
from biahub_tpu_torch.io.ngff import TransformationMeta, open_ome_zarr
from tests.test_torch_plate_verbs import attributes

SHAPE = (3, 2, 4, 8, 10)
SCALE = [1.0, 1.0, 2.0, 0.5, 0.5]


@pytest.fixture(scope="module")
def plates(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("concatenate")
    rng = np.random.default_rng(23)
    one = open_ome_zarr(tmp / "one.zarr", layout="hcs", mode="w",
                        channel_names=["Phase3D", "BF"])
    pos = one.create_position("A", "1", "0")
    data = rng.normal(0, 1, SHAPE).astype(np.float32)
    data[0, 0, 1, 2, 3] = np.nan  # nan_to_num writes 0
    pos.create_image("0", data, transform=[TransformationMeta(type="scale", scale=SCALE)])
    pos.update_zattrs({"biahub-reconstruct": {"note": "one"}, "other": 1})
    two = open_ome_zarr(tmp / "two.zarr", layout="hcs", mode="w", channel_names=["GFP", "RFP"])
    for row, col in (("A", "1"), ("B", "1"), ("B", "2")):
        pos = two.create_position(row, col, "0")
        pos.create_image("0", rng.integers(0, 60000, SHAPE).astype(np.uint16),
                         transform=[TransformationMeta(type="scale", scale=SCALE)])
        pos.update_zattrs({"biahub-deskew": {"row": row}})
    return tmp


def config(**settings) -> dict:
    return {"time_indices": "all", **settings}


CASES = {
    "channels_from_two_plates": lambda t: config(
        concat_data_paths=[str(t / "one.zarr/A/1/0"), str(t / "two.zarr/A/1/0")],
        channel_names=[["Phase3D"], ["RFP"]], output_ome_zarr_version="0.4"),
    "channel_dedup": lambda t: config(
        concat_data_paths=[str(t / "two.zarr/A/1/0"), str(t / "two.zarr/B/1/0")],
        channel_names=[["GFP", "RFP"], ["RFP", "GFP"]], ensure_unique_positions=False,
        output_ome_zarr_version="0.4"),
    "crop_and_time_subset": lambda t: config(
        concat_data_paths=[str(t / "two.zarr/A/1/0")], time_indices=[2, 0],
        channel_names=[["RFP"]], Z_slice=[1, 3], Y_slice=[0, 4], X_slice=[2, 6],
        output_ome_zarr_version="0.4"),
    "duplicate_positions": lambda t: config(
        concat_data_paths=[str(t / "two.zarr/A/1/0"), str(t / "two.zarr/A/1/0")],
        channel_names=[["GFP"], ["RFP"]], ensure_unique_positions=True,
        output_ome_zarr_version="0.4"),
    "per_path_crops": lambda t: config(
        concat_data_paths=[str(t / "one.zarr/A/1/0"), str(t / "two.zarr/B/2/0")],
        channel_names=["all", ["GFP"]], time_indices=1, Y_slice=[[0, 5], [3, 8]],
        X_slice=[1, 9], chunks_czyx=[1, 2, 5, 8], output_ome_zarr_version="0.4"),
    "glob_into_v3": lambda t: config(
        concat_data_paths=[str(t / "two.zarr" / "*" / "*" / "*")], channel_names=["all"],
        chunks_czyx=[1, 2, 4, 5]),
}


def run_both(tmp: Path, name: str, settings: dict, extra=()) -> tuple[Path, Path]:
    path = tmp / f"{name}.yml"
    path.write_text(yaml.safe_dump(settings))
    ref, port = tmp / "ref" / f"{name}.zarr", tmp / "port" / f"{name}.zarr"
    res = CliRunner().invoke(reference_cli, ["concatenate", "-c", str(path), "-o", str(ref),
                                             *extra])
    assert res.exit_code == 0, (res.output, res.exception)
    assert main(["concatenate", "-c", str(path), "-o", str(port), *extra], device="cpu") == 0
    return ref, port


def same_plates(ref: Path, port: Path) -> None:
    ref_plate, port_plate = reference_open(ref), open_ome_zarr(port)
    assert port_plate.position_keys() == ref_plate.position_keys()
    assert port_plate.version == ref_plate.version
    for key in ref_plate.position_keys():
        want = ref_plate["/".join(key)].data[...]
        got = port_plate["/".join(key)].data[...]
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want)
    assert attributes(port) == attributes(ref)


@pytest.mark.parametrize("name", list(CASES))
def test_concatenate_matches_the_reference(plates, name):
    ref, port = run_both(plates, name, CASES[name](plates))
    same_plates(ref, port)
    out = open_ome_zarr(port)
    if name == "glob_into_v3":
        assert out.version == "0.5" and (port / "zarr.json").exists()
        assert len(out.position_keys()) == 3
    if name == "channels_from_two_plates":
        pos = out["A/1/0"]
        assert pos.channel_names == ["Phase3D", "RFP"] and pos.data.dtype == np.float32
        assert pos.data[0, 0, 1, 2, 3] == 0


def test_resolve_mode_writes_the_references_text(plates):
    template = plates / "template.yml"
    template.write_text(yaml.safe_dump({"concat_data_paths": ["placeholder"],
                                        "channel_names": ["all", ["GFP"]],
                                        "X_slice": [[0, 4], "all"]}))
    paths = [str(plates / "one.zarr/*/*/*"), str(plates / "two.zarr/B/*/*")]
    extra = [a for p in paths for a in ("--concat-data-paths", p)]
    ref, port = plates / "resolved_ref.yml", plates / "resolved_port.yml"
    res = CliRunner().invoke(reference_cli, ["concatenate", "-c", str(template), "-o", str(ref),
                                             *extra])
    assert res.exit_code == 0, (res.output, res.exception)
    assert main(["concatenate", "-c", str(template), "-o", str(port), *extra],
                device="cpu") == 0
    assert port.read_text() == ref.read_text()
    assert yaml.safe_load(port.read_text())["concat_data_paths"] == paths


def test_init_then_resume_twice(plates, capsys):
    settings = config(concat_data_paths=[str(plates / "two.zarr/*/*/*")],
                      channel_names=[["RFP", "GFP"]], output_ome_zarr_version="0.5")
    ref, port = run_both(plates, "resume", settings, ["--init"])
    assert "RESOURCES:" in capsys.readouterr().out
    assert not np.any(open_ome_zarr(port)["A/1/0"].data[...])
    same_plates(ref, port)
    ref, port = run_both(plates, "resume", settings, ["--resume"])
    same_plates(ref, port)
    chunks = {p: p.stat().st_mtime_ns for p in port.rglob("*")
              if p.is_file() and "/c/" in str(p)}
    assert main(["concatenate", "-c", str(plates / "resume.yml"), "-o", str(port), "--resume",
                 "--cluster", "debug"], device="cpu") == 0
    assert chunks and all(p.stat().st_mtime_ns == t for p, t in chunks.items())
    same_plates(ref, port)


def test_sharded_output_is_refused_by_name(plates):
    """``shards_ratio`` writes the reference's sharded OME-Zarr 0.5 arrays:
    the same data and metadata, the codecs included; a ratio without one
    entry an axis is refused, naming ``shards_ratio``."""
    settings = config(concat_data_paths=[str(plates / "two.zarr/A/1/0")],
                      channel_names=["all"], chunks_czyx=[1, 2, 4, 5],
                      shards_ratio=[1, 1, 2, 2, 2])
    ref, port = run_both(plates, "sharded", settings)
    same_plates(ref, port)
    assert ((port / "A/1/0/0/zarr.json").read_text()
            == (ref / "A/1/0/0/zarr.json").read_text())
    settings["shards_ratio"] = [1, 2, 2, 2]
    (plates / "sharded_bad.yml").write_text(yaml.safe_dump(settings))
    with pytest.raises(ValueError, match="shards_ratio"):
        main(["concatenate", "-c", str(plates / "sharded_bad.yml"), "-o",
              str(plates / "sharded_bad.zarr")], device="cpu")


SETTINGS = [
    {"concat_data_paths": ["a/*/*/*"], "channel_names": ["all"]},
    {"concat_data_paths": ["a", "b"], "channel_names": [["x"], "all"], "time_indices": 2,
     "X_slice": [[0, 4], "all"], "Y_slice": [1, 5], "Z_slice": [[[0, 2]], "all"],
     "chunks_czyx": [1, 2, 3, 4], "ensure_unique_positions": "yes",
     "output_ome_zarr_version": "0.4", "shards_ratio": [1, 1, 1, 1, 1]},
    {"concat_data_paths": ["a"], "channel_names": ["all"], "time_indices": [0, "1"],
     "ensure_unique_positions": None, "output_ome_zarr_version": None},
]
BAD = [
    ({"concat_data_paths": "a", "channel_names": ["all"]}, None),
    ({"concat_data_paths": ["a"], "channel_names": ["all"], "extra": 1}, None),
    ({"concat_data_paths": ["a"], "channel_names": ["all"], "X_slice": [0, -1]},
     "Slice indices must be non-negative integers."),
    ({"concat_data_paths": ["a"], "channel_names": ["all"], "Y_slice": [[0, 1], 3]},
     "Each item in a per-path slice list"),
    ({"concat_data_paths": ["a", "b", "c"], "channel_names": ["all"],
      "Z_slice": [[0, 1], [2, 3]]}, "Z_slice must be 'all', a single slice specification"),
    ({"concat_data_paths": ["a"], "channel_names": ["all"], "chunks_czyx": [1, 2, 3]},
     "chunks_czyx must be a list of 4 integers"),
    ({"concat_data_paths": ["a"], "channel_names": ["all"], "X_slice": "none"}, None),
]


@pytest.mark.parametrize("case", range(len(SETTINGS) + len(BAD)))
def test_settings_reader_matches_the_model(case):
    if case < len(SETTINGS):
        raw = SETTINGS[case]
        got = concatenate_settings_from_reference(dict(raw))
        want = ConcatenateSettings(**dict(raw)).model_dump()
        assert got == want and list(got) == list(want)
        return
    raw, message = BAD[case - len(SETTINGS)]
    with pytest.raises(ValueError) as ref_exc:
        ConcatenateSettings(**raw)
    with pytest.raises(ValueError) as exc:
        concatenate_settings_from_reference(raw)
    if message is not None:
        assert message in str(ref_exc.value) and message in str(exc.value)


def test_slice_helpers_equal_the_reference():
    for spec, n in (("all", 10), ([2, 8], 10)):
        assert get_slice(spec, n) == ref_get_slice(spec, n)
    for spec, i in (("all", 0), ([2, 8], 1), ([[0, 4], [1, 5]], 1), ([[0, 4], [1, 5]], 3),
                    ([[0, 4], "all"], 1)):
        assert get_path_slice_param(spec, i, 2) == ref_path_slice_param(spec, i, 2)
    with pytest.raises(ValueError, match="Invalid slice parameter"):
        get_slice([[0, 1]], 4)


def test_pyramid_levels_are_refused_as_the_reference_refuses(plates):
    """A position with pyramid levels (``array_names`` beyond "0")."""
    import shutil

    shutil.copytree(plates / "two.zarr", plates / "levels.zarr")
    open_ome_zarr(plates / "levels.zarr/B/1/0", mode="r+").compute_pyramid(levels=2)
    settings = config(concat_data_paths=[str(plates / "levels.zarr/*/*/*")],
                      channel_names=["all"])
    path = plates / "levels.yml"
    path.write_text(yaml.safe_dump(settings))
    res = CliRunner().invoke(reference_cli, ["concatenate", "-c", str(path), "-o",
                                             str(plates / "ref_levels.zarr")])
    assert isinstance(res.exception, ValueError) and "multiple arrays" in str(res.exception)
    with pytest.raises(ValueError, match="multiple arrays \\(pyramid levels\\)"):
        main(["concatenate", "-c", str(path), "-o", str(plates / "levels_out.zarr")],
             device="cpu")
