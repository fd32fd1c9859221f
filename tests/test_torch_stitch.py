"""biahub_tpu_torch's estimate-stitch and stitch against biahub_tpu's.

The port writes one plate: a 2 x 2 well of 48 x 48 tiles (T 2, C 2, Z 3,
float32, 0.5 um pixels) cut from one mosaic of uniform noise at known
offsets (a 40 px pitch with integer jitter), its micromanager stage
positions in the plate's ``Summary.StagePositions`` (both dialects, one
position labelled through its ``omero.name``), about a pixel off. Each
reference verb runs through click's runner, the port's through
``cli.main([...], device="cpu")``. Tolerances:

- the helpers (chunk slices, overlaps, output shape, distance map, grid
  names, stage entries) equal the reference's exactly;
- ``blend_chunk`` is within 1e-6 * max |ref| of the reference's
  ``blend_chunk`` and of the host route (NumPy), at exponents 0, 1 and
  2.5, on ragged edge chunks with fractional corners;
- the strips' PCC shift is equal and its confidence within 1e-5;
- estimate-stitch's YAML has the reference's values (2 decimals) and
  text, with and without the PCC refinement;
- the stitched float16 mosaic is within one float16 ulp of the value of
  the reference's (the blends' float32 sums differ in order: XLA's
  ``einsum`` against torch's), and so is the host route's; the metadata is
  equal.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner

from biahub_tpu import stitch as jst
from biahub_tpu.cli.main import cli as reference_cli
from biahub_tpu.estimate_stitch import extract_stage_position as ref_stage_position
from biahub_tpu.io.ngff import open_ome_zarr as reference_open
from biahub_tpu.kernels import stitch_blend as jsb
from biahub_tpu.stitching import tile as jtile
from biahub_tpu_torch import stitch as tst
from biahub_tpu_torch.cli.main import main
from biahub_tpu_torch.cli.yaml_reader import load_file
from biahub_tpu_torch.estimate_stitch import extract_stage_position
from biahub_tpu_torch.io.ngff import TransformationMeta, open_ome_zarr
from biahub_tpu_torch.kernels.stitch_blend import blend_chunk, pad_distance_map
from biahub_tpu_torch.stitching import tile as ttile
from tests.test_torch_plate_verbs import attributes

TILE = (2, 2, 3, 48, 48)
PITCH = 40
SCALE = [1.0, 1.0, 1.0, 0.5, 0.5]
NAMES = ["GFP", "RFP"]
GRID = [(r, c) for r in range(2) for c in range(2)]
JITTER = {(0, 0): (0, 0), (0, 1): (2, -1), (1, 0): (-1, 2), (1, 1): (1, 1)}
STAGE_ERROR = {(0, 0): (0.5, -0.75), (0, 1): (-1.0, 0.5), (1, 0): (0.75, 1.0),
               (1, 1): (-0.5, -1.25)}  # px


def fov(r: int, c: int) -> str:
    return f"A/1/{r:03d}{c:03d}"


def truth() -> dict:
    """(y, x) of each tile in the mosaic, in pixels."""
    return {fov(r, c): (r * PITCH + JITTER[(r, c)][0], c * PITCH + JITTER[(r, c)][1])
            for r, c in GRID}


def stage_entry(r: int, c: int, label: str) -> dict:
    y, x = (np.asarray(truth()[fov(r, c)]) + STAGE_ERROR[(r, c)]) * SCALE[-1]
    if (r + c) % 2:
        return {"Label": label, "DefaultXYStage": "XY", "DefaultZStage": "Z",
                "XY": [float(x), float(y)], "Z": 3.0}
    return {"Label": label, "DefaultXYStage": "XY", "DevicePositions": [
        {"Device": "XY", "Position_um": [float(x), float(y)]},
        {"Device": "Z1", "Position_um": [2.0]}, {"Device": "Z2", "Position_um": [1.0]}]}


def inputs(tmp: Path) -> list[str]:
    return [str(tmp / "tiles.zarr" / fov(r, c)) for r, c in GRID]


def mosaic() -> np.ndarray:
    extent = np.max(list(truth().values()), axis=0) + TILE[-2:]
    return np.random.default_rng(19).uniform(10, 100, TILE[:3] + tuple(extent)).astype(
        np.float32)


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def plate(tmp_path_factory, one_thread):
    tmp = tmp_path_factory.mktemp("stitch")
    full = mosaic()
    root = open_ome_zarr(tmp / "tiles.zarr", layout="hcs", mode="w", channel_names=NAMES)
    entries = []
    for r, c in GRID:
        y, x = truth()[fov(r, c)]
        pos = root.create_position("A", "1", f"{r:03d}{c:03d}")
        pos.create_image("0", full[..., y:y + TILE[-2], x:x + TILE[-1]],
                         transform=[TransformationMeta(type="scale", scale=SCALE)])
        label = fov(r, c)
        if (r, c) == (1, 0):  # micromanager's label, through omero.name
            label = "Pos2"
            pos.update_zattrs({"omero": {**pos.zattrs["omero"], "name": label}})
        entries.append(stage_entry(r, c, label))
    root.update_zattrs({"Summary": {"StagePositions": entries}})
    return tmp, full


def reference(args: list[str]) -> None:
    res = CliRunner().invoke(reference_cli, args)
    assert res.exit_code == 0, (res.output, res.exception)


def port(args: list[str]) -> None:
    assert main(args, device="cpu") == 0


# -- the helpers, exactly -------------------------------------------------------

OVERLAPS = [
    (np.array([0, 0, 10]), np.array([8, 24, 24]), np.array([0.0, 0.0, 18.6]),
     np.array([8, 24, 24])),
    (np.array([0, 16, 0]), np.array([8, 13, 17]), np.array([0.0, 17.4, 0.0]),
     np.array([8, 24, 24])),
    (np.array([0, 16, 0]), np.array([8, 13, 17]), np.array([0.0, 40.0, 3.0]),
     np.array([8, 24, 24])),
    (np.array([2, 5, 7]), np.array([3, 9, 11]), np.array([1.5, 0.0, 0.0]),
     np.array([4, 10, 12])),
]


@pytest.mark.parametrize("case", range(len(OVERLAPS)))
def test_overlap_helpers_equal_the_reference(case):
    corner, extent, fov_corner, fov_extent = OVERLAPS[case]
    assert tst.overlap_slices(corner, extent, fov_corner, fov_extent) == \
        jst.overlap_slices(corner, extent, fov_corner, fov_extent)
    chunk = tuple(slice(a, a + e) for a, e in zip(corner, extent))
    assert tst.check_overlap(chunk, fov_corner, fov_extent) == \
        jst.check_overlap(chunk, fov_corner, fov_extent)
    shifts = {"a": fov_corner, "b": fov_corner + [0, 30, 0], "c": [0.0, 0.0, 0.0]}
    assert tst.find_contributing_fovs(chunk, shifts, fov_extent) == \
        jst.find_contributing_fovs(chunk, shifts, fov_extent)


@pytest.mark.parametrize("shape,chunk", [((4, 5, 6), (2, 3, 4)), ((16, 97, 88), (16, 48, 48)),
                                         ((3, 10, 10), (10, 10, 10))])
def test_chunk_slices_shapes_and_distance_equal_the_reference(shape, chunk):
    assert tst.list_of_nd_slices_from_array_shape(shape, chunk) == \
        jst.list_of_nd_slices_from_array_shape(shape, chunk)
    shifts = {"a": (0, 0, 0), "b": (0.0, 10.7, 20.2), "c": (1, 3, 41.9)}
    assert tst.get_output_shape(shifts, (1, 1) + shape) == \
        jst.get_output_shape(shifts, (1, 1) + shape)
    assert np.array_equal(tst.fov_edge_distance(shape), jst.fov_edge_distance(shape))


def test_grid_names_and_stage_entries_equal_the_reference(plate):
    tmp, _ = plate
    for name in ("0/2/001000", "000001", "A/1/012034"):
        assert ttile.parse_grid_coords(name) == jtile.parse_grid_coords(name)
    with pytest.raises(ValueError, match="Cannot parse grid coordinates"):
        ttile.parse_grid_coords("A/1/0")
    port_plate, ref_plate = open_ome_zarr(tmp / "tiles.zarr"), reference_open(tmp / "tiles.zarr")
    for label in [fov(0, 0), fov(0, 1), "Pos2", fov(1, 1), "absent"]:
        assert extract_stage_position(port_plate, label) == ref_stage_position(ref_plate, label)


# -- the blend ------------------------------------------------------------------

FOV_EXTENT = np.array([8, 24, 24])
CORNERS = [np.array([0.0, 0.0, 0.0]), np.array([0.0, 0.0, 18.6]),
           np.array([0.0, 17.4, 0.0]), np.array([0.0, 17.4, 18.6])]
CHUNKS = [(np.array([0, 0, 10]), np.array([8, 24, 24])),
          (np.array([0, 16, 0]), np.array([8, 13, 17]))]  # the second one ragged


def blend_inputs(corner, extent):
    rng = np.random.default_rng(7)
    fovs = [rng.random((2, 3) + tuple(FOV_EXTENT), np.float32) for _ in CORNERS]
    pairs = []
    for fov_corner, data in zip(CORNERS, fovs):
        fixed, moving = jst.overlap_slices(corner, extent, fov_corner, FOV_EXTENT)
        if fixed is not None:
            pairs.append((fixed, moving, data))
    offsets = np.array([[m.start - f.start for m, f in zip(moving, fixed)]
                        for fixed, moving, _ in pairs])
    stack = np.zeros((len(pairs), 2, 3) + tuple(extent), np.float32)
    for i, (fixed, moving, data) in enumerate(pairs):
        stack[(i, slice(None), slice(None), *fixed)] = data[(slice(None), slice(None), *moving)]
    return pairs, offsets, stack


def host_blend(extent, pairs, dist, exponent) -> np.ndarray:
    """The reference verb's BIAHUB_TPU_HOST_BLEND=1 arithmetic."""
    maps = np.zeros((len(pairs),) + tuple(extent), np.float32)
    for i, (fixed, moving, _) in enumerate(pairs):
        maps[(i, *fixed)] = dist[moving]
    w = np.zeros_like(maps)
    np.power(maps, exponent, out=w, where=(maps > 0))
    w = w / (np.sum(w, axis=0, keepdims=True) + 1e-8)
    out = np.zeros((2, 3) + tuple(extent), np.float32)
    for i, (fixed, moving, data) in enumerate(pairs):
        out[(slice(None), slice(None), *fixed)] += (
            w[(i, *fixed)] * data[(slice(None), slice(None), *moving)])
    return out


@pytest.mark.parametrize("exponent", [0.0, 1.0, 2.5])
@pytest.mark.parametrize("chunk", range(len(CHUNKS)))
def test_blend_chunk_matches_the_reference_and_the_host_route(exponent, chunk):
    corner, extent = CHUNKS[chunk]
    pairs, offsets, stack = blend_inputs(corner, extent)
    dist = np.ascontiguousarray(jst.fov_edge_distance(FOV_EXTENT), np.float32)
    want = jsb.blend_chunk(jsb.pad_distance_map(dist, tuple(extent)), offsets, stack, exponent)
    host = host_blend(extent, pairs, dist, exponent)
    tol = 1e-6 * np.abs(want).max()
    for pad in (tuple(extent), tuple(FOV_EXTENT)):  # edge chunks reuse the nominal pad
        got = blend_chunk(pad_distance_map(dist, pad, "cpu"), offsets, stack, exponent,
                          pad_extent=pad).numpy()
        assert got.shape == want.shape == (2, 3) + tuple(extent)
        assert np.abs(got - want).max() <= tol
        assert np.abs(got - host).max() <= tol


@pytest.mark.parametrize("axis", [0, 1])
def test_strip_registration_matches_the_reference(axis, one_thread):
    full = mosaic()[0, 0, 0]
    a = full[:48, :48]
    b = full[3:51, 5:53] if axis else full[5:53, 3:51]
    strip_a, strip_b = (a[:, -12:], b[:, :12]) if axis else (a[-12:], b[:12])
    got_shift, got_conf = ttile.register_translation_nd(strip_a, strip_b, device="cpu")
    want_shift, want_conf = jtile.register_translation_nd(strip_a, strip_b)
    assert np.array_equal(got_shift, want_shift)
    assert abs(got_conf - want_conf) <= 1e-5


# -- the verbs ------------------------------------------------------------------

@pytest.mark.parametrize("flags", [[], ["--fliplr"], ["--flipud", "--flipxy"], ["--pcc"]])
def test_estimate_stitch_yaml_equals_the_reference(plate, flags):
    tmp, _ = plate
    name = "_".join(f.strip("-") for f in flags) or "plain"
    args = [a for a in flags if a != "--pcc"]
    if "--pcc" in flags:
        args += ["--pcc-channel-name", "RFP", "--pcc-z-index", "1"]
    ref_out, port_out = tmp / f"ref_{name}.yml", tmp / f"port_{name}.yml"
    reference(["estimate-stitch", "-i", *inputs(tmp), "-o", str(ref_out), *args])
    port(["estimate-stitch", "-i", *inputs(tmp), "-o", str(port_out), *args])
    got, want = load_file(port_out), yaml.safe_load(ref_out.read_text())
    assert got == want
    assert port_out.read_text() == ref_out.read_text()
    assert list(got) == ["total_translation"]
    assert list(got["total_translation"]) == [fov(r, c) for r, c in GRID]
    if "--pcc" in flags:  # the refinement recovers the tiles' relative offsets
        est = {k: np.asarray(v[1:]) for k, v in got["total_translation"].items()}
        for key, yx in truth().items():
            assert np.abs((est[key] - est[fov(0, 0)]) - yx).max() <= 0.5


def ulp_close(got: np.ndarray, want: np.ndarray) -> bool:
    """Within one float16 ulp of the value of ``want``."""
    assert got.dtype == want.dtype == np.float16 and got.shape == want.shape
    ulp = np.spacing(np.abs(want)).astype(np.float32)
    return bool(np.all(np.abs(got.astype(np.float32) - want.astype(np.float32)) <= ulp))


def stitch_config(tmp: Path, name: str, shifts: dict, channels=None) -> Path:
    path = tmp / f"{name}.yml"
    settings = {"total_translation": {k: [float(v) for v in yx] for k, yx in shifts.items()}}
    if channels is not None:
        settings["channels"] = channels
    path.write_text(yaml.safe_dump(settings))
    return path


@pytest.mark.parametrize("exponent", ["0.0", "1.0", "2.5"])
def test_stitch_matches_the_reference_within_a_float16_ulp(plate, exponent, monkeypatch,
                                                           capsys):
    tmp, _ = plate
    # (y, x) entries: a leading z = 0 is added; one corner is fractional.
    shifts = {k: list(v) for k, v in truth().items()}
    shifts[fov(1, 1)] = [shifts[fov(1, 1)][0] + 0.6, shifts[fov(1, 1)][1] + 0.3]
    config = stitch_config(tmp, f"stitch_{exponent}", shifts, channels=["RFP", "GFP"])
    out = {k: tmp / f"stitch_{exponent}_{k}.zarr" for k in ("ref", "port", "host")}
    reference(["stitch", "-i", *inputs(tmp), "-c", str(config), "-o", str(out["ref"]), "-b",
               exponent])
    capsys.readouterr()
    port(["stitch", "-i", *inputs(tmp), "-c", str(config), "-o", str(out["port"]), "-b",
          exponent])
    lines = [json.loads(line.split(":", 1)[1]) for line in capsys.readouterr().out.splitlines()
             if line.startswith("STITCH_STATS:")]
    monkeypatch.setenv("BIAHUB_TPU_HOST_BLEND", "1")
    port(["stitch", "-i", *inputs(tmp), "-c", str(config), "-o", str(out["host"]), "-b",
          exponent])
    want = reference_open(out["ref"] / "A/1/0").data[...]
    got = open_ome_zarr(out["port"] / "A/1/0").data[...]
    host = open_ome_zarr(out["host"] / "A/1/0").data[...]
    assert want.shape == (2, 2, 3) + tuple(np.max(list(truth().values()), axis=0) + 48)
    assert ulp_close(got, want) and ulp_close(host, want) and ulp_close(got, host)
    assert attributes(out["port"]) == attributes(out["ref"])
    assert len(lines) == 1 and lines[0]["chunks"] == 4 and lines[0]["route"] == "cpu"


def test_estimate_then_stitch_round_trip(plate):
    tmp, full = plate
    est = {}
    for pkg, run in (("ref", reference), ("port", port)):
        est[pkg] = tmp / f"round_{pkg}.yml"
        run(["estimate-stitch", "-i", *inputs(tmp), "-o", str(est[pkg]), "--pcc-channel-name",
             "GFP"])
        run(["stitch", "-i", *inputs(tmp), "-c", str(est[pkg]), "-o",
             str(tmp / f"round_{pkg}.zarr")])
    assert load_file(est["port"]) == yaml.safe_load(est["ref"].read_text())
    got = open_ome_zarr(tmp / "round_port.zarr" / "A/1/0").data[...]
    want = reference_open(tmp / "round_ref.zarr" / "A/1/0").data[...]
    assert ulp_close(got, want)
    # The estimate is relative to the solve's anchor: compare away from edges.
    y0, x0 = (int(v) for v in load_file(est["port"])["total_translation"][fov(0, 0)][1:])
    core = got[:, :, :, y0 + 2:y0 + 70, x0 + 2:x0 + 70].astype(np.float32)
    ref_core = full[:, :, :, 2:70, 2:70]
    assert np.median(np.abs(core - ref_core) / ref_core) < 0.01


def test_stitch_refuses_what_the_reference_refuses(plate):
    tmp, _ = plate
    with pytest.raises(ValueError, match="Either affine_transform or total_translation"):
        port(["stitch", "-i", *inputs(tmp), "-c", str(stitch_config(tmp, "empty", {})), "-o",
              str(tmp / "x.zarr")])
    bad = stitch_config(tmp, "bad_channel", truth(), channels=["DAPI"])
    with pytest.raises(ValueError, match="Invalid channel"):
        port(["stitch", "-i", *inputs(tmp), "-c", str(bad), "-o", str(tmp / "x.zarr")])


def test_many_workers_write_the_same_mosaic(plate, monkeypatch, capsys):
    """Sixteen workers (more than the chunks) with a short switch interval:
    the shared stats lose no update and the mosaic equals the one worker's."""
    import sys

    tmp, _ = plate
    config = stitch_config(tmp, "stress", truth())
    out = {}
    interval = sys.getswitchinterval()
    try:
        sys.setswitchinterval(1e-5)
        for workers in ("1", "16"):
            monkeypatch.setenv("BIAHUB_TPU_STITCH_WORKERS", workers)
            capsys.readouterr()
            port(["stitch", "-i", *inputs(tmp), "-c", str(config), "-o",
                  str(tmp / f"stress_{workers}.zarr")])
            line = [json.loads(x.split(":", 1)[1]) for x in capsys.readouterr().out.splitlines()
                    if x.startswith("STITCH_STATS:")][0]
            out[workers] = open_ome_zarr(tmp / f"stress_{workers}.zarr" / "A/1/0").data[...]
            assert line["workers"] == int(workers) and line["chunks"] == 4
            assert line["bytes_written"] == out[workers].nbytes
            assert line["bytes_read"] == 4 * np.prod(TILE) * 4  # every tile read once
    finally:
        sys.setswitchinterval(interval)
    assert np.array_equal(out["1"].view(np.int16), out["16"].view(np.int16))
