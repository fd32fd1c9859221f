"""biahub_tpu_torch's estimate-stabilization, estimate-psf,
estimate-registration and optimize-registration verbs against biahub_tpu's.

The port writes the input plates (the data of tests/test_torch_estimate_
stabilization.py, tests/test_torch_beads.py, tests/test_torch_psf.py and
tests/test_torch_intensity.py); each reference verb runs once through
click's runner (a module fixture, its accelerator routes patched in as
those files patch them, its intensity optimizer shortened as there) and the
port's through ``cli.main([...], device="cpu")``. For each case:

- every file the reference writes exists in the port's folder (plots only
  where matplotlib is installed);
- YAML files read back through ``yaml.safe_load`` (and the port's reader)
  to the same keys in the same order and the same values, the transforms
  within the tolerance of the matching ``*_arrays`` test: PCC and z focus
  equal, xy focus within 1e-4 px, beads within 1e-9, intensity within 0.01
  (linear part) and 0.3 voxel;
- CSVs by their parsed rows, ``.npy`` files by their arrays (as the YAML),
  the PSF plate by its array (1e-6) and metadata;
- each verb's result equals the port's ``*_arrays`` function on the same
  arrays.
"""

import csv
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner

from biahub_tpu.cli.main import cli as reference_cli
from biahub_tpu.io.ngff import open_ome_zarr as reference_open
from biahub_tpu.kernels import affine as jaff
from biahub_tpu.kernels.multipass_warp import make_traced_multipass_warp
from biahub_tpu.registration import beads as jbeads
from biahub_tpu.registration import intensity as ji
from biahub_tpu_torch import estimate_stabilization_arrays
from biahub_tpu_torch.cli.main import main
from biahub_tpu_torch.cli.yaml_reader import load_file
from biahub_tpu_torch.estimate_psf import estimate_psf_arrays
from biahub_tpu_torch.estimate_registration import estimate_registration_arrays
from biahub_tpu_torch.io.ngff import TransformationMeta, open_ome_zarr
from biahub_tpu_torch.optimize_registration import optimize_registration_arrays
from biahub_tpu_torch.registration import intensity as ti
from tests.test_torch_beads import PEAKS, TRUTH, accelerator_warp, render_frames
from tests.test_torch_estimate_stabilization import (
    CHANNELS,
    DRIFTS,
    FOCUS,
    SCALE,
    XY_DRIFTS,
    drift_position,
    focus_position,
)
from tests.test_torch_intensity import SHORT, registration_stack
from tests.test_torch_plate_verbs import attributes
from tests.test_torch_psf import SCALE as PSF_SCALE
from tests.test_torch_psf import beads as psf_beads

ROOT = Path(__file__).resolve().parents[1]
HAS_MATPLOTLIB = True
try:
    import matplotlib  # noqa: F401
except ImportError:
    HAS_MATPLOTLIB = False

REG_SCALE = [1.0, 1.0, 0.174, 0.1494, 0.1494]


def stab(kind, method, verbose=False, **blocks) -> dict:
    return {"stabilization_estimation_channel": "GFP", "stabilization_channels": ["GFP"],
            "stabilization_type": kind, "stabilization_method": method, "verbose": verbose,
            **blocks}


FF = {"center_crop_xy": [40, 32]}
STACK_REG = {"center_crop_xy": [32, 32], "t_reference": "previous", "focus_finding_settings": FF}
PCC = {"normalization": "magnitude", "t_reference": "previous", "Z_slice": [1, 11],
       "X_slice": [2, 38]}
BEADS = yaml.safe_load((ROOT / "settings/example_estimate_stabilization_settings_xyz_beads.yml")
                       .read_text())
BEADS["beads_match_settings"].update(source_peaks_settings=PEAKS, target_peaks_settings=PEAKS)
BEADS["verbose"] = True
BEADS_REG = {"target_channel_name": "GFP", "source_channel_name": "GFP",
             "estimation_method": "beads", "beads_match_settings": BEADS["beads_match_settings"],
             "affine_transform_settings": {"transform_type": "euclidean"}}


def ants(**extra) -> dict:
    return {"target_channel_name": "Phase3D", "source_channel_name": "GFP",
            "estimation_method": "ants",
            "affine_transform_settings": {"use_prev_t_transform": True}, **extra}


# name: (verb, plate(s), config, extra options); the estimate-stabilization
# runs of one folder run in this order ("z_more" merges into "z"'s table)
CASES = {
    "pcc": ("estimate-stabilization", ("drift",), stab("xyz", "phase-cross-corr", True,
                                                        phase_cross_corr_settings=PCC), ()),
    "beads": ("estimate-stabilization", ("beads",), dict(stab("xyz", "beads"), **{
        k: BEADS[k] for k in ("beads_match_settings", "affine_transform_settings",
                              "verbose")}), ()),
    "z": ("estimate-stabilization", ("focus_a",), stab("z", "focus-finding", True,
                                                       focus_finding_settings=dict(
                                                           FF, average_across_wells=True)), ()),
    "z_more": ("estimate-stabilization", ("focus_b",), stab(
        "z", "focus-finding", True, focus_finding_settings=dict(FF, average_across_wells=True)),
        ()),
    "xy": ("estimate-stabilization", ("focus_a", "focus_b"),
           stab("xy", "focus-finding", stack_reg_settings=STACK_REG), ()),
    "xyz": ("estimate-stabilization", ("focus_a", "focus_b"),
            stab("xyz", "focus-finding", stack_reg_settings=STACK_REG,
                 focus_finding_settings=FF), ()),
    "psf": ("estimate-psf", ("psf_a", "psf_b"),
            {"axis0_patch_size": 9, "axis1_patch_size": 15, "axis2_patch_size": 15}, ()),
    "beads_reg": ("estimate-registration", ("beads_t1", "beads_t0"), BEADS_REG, ()),
    "ants1": ("estimate-registration", ("src1", "tgt1"), ants(),
              ("-rt", "DAPI", "-rs", "GFP", "-rs", "BF")),
    "ants2": ("estimate-registration", ("src2", "tgt2"), ants(verbose=True), ()),
    "optimize": ("optimize-registration", ("src2", "tgt2"), None, ("-d",)),
}
FOLDER = {"z_more": "z"}  # cases that write into another case's folder


def optimize_config() -> dict:
    """Timepoint 0 of the two-timepoint pair from its truth at timepoint 1
    (``time_indices: all`` takes timepoint 0, with the reference's line)."""
    return {"source_channel_names": ["GFP"], "target_channel_name": "Phase3D",
            "affine_transform_zyx": registration_stack(2)[2][1].tolist()}


def write_plates(tmp: Path) -> dict:
    """Each plate's position paths, written by the port."""
    def plate(name, arrays, names, scale):
        root = open_ome_zarr(tmp / f"{name}.zarr", layout="hcs", mode="w", channel_names=names)
        paths = []
        for key, arr in arrays.items():
            root.create_position(*key.split("/")).create_image(
                "0", np.asarray(arr, np.float32),
                transform=[TransformationMeta(type="scale", scale=scale)])
            paths.append(str(tmp / f"{name}.zarr" / key))
        return paths

    frames = render_frames(TRUTH)
    paths = {
        "drift": plate("drift", {"A/1/0": drift_position(DRIFTS).data,
                                 "B/2/0": drift_position(DRIFTS, seed=4).data}, CHANNELS, SCALE),
        "beads": plate("beads", {"0/0/0": frames[:, None]}, ["GFP"], [1.0, 1.0, 0.174,
                                                                     0.1494, 0.1494]),
        "beads_t1": plate("beads_t1", {"0/0/0": frames[1:2, None]}, ["GFP"], REG_SCALE),
        "beads_t0": plate("beads_t0", {"0/0/0": frames[0:1, None]}, ["GFP"], REG_SCALE),
    }
    focus = plate("focus", {"A/1/0": focus_position(FOCUS, XY_DRIFTS).data,
                            "B/2/0": focus_position([5, 0, 4, 6], XY_DRIFTS, seed=2).data},
                  CHANNELS, SCALE)
    paths.update(focus_a=focus[:1], focus_b=focus[1:])
    psf = plate("psf", {"0/0/0": psf_beads(1)[None, None], "0/1/0": psf_beads(2)[None, None]},
                ["GFP"], (1, 1) + PSF_SCALE)
    paths.update(psf_a=psf[:1], psf_b=psf[1:])
    for t in (1, 2):
        source, target, _ = registration_stack(t)
        paths[f"src{t}"] = plate(f"src{t}", {"0/0/0": source}, ["GFP", "BF"], REG_SCALE)
        paths[f"tgt{t}"] = plate(f"tgt{t}", {"0/0/0": target}, ["Phase3D", "DAPI"], REG_SCALE)
    return {k: v if isinstance(v, list) else [v] for k, v in paths.items()}


def argv(name: str, tmp: Path, side: str, paths: dict) -> list[str]:
    verb, plates, _, extra = CASES[name]
    config = ["-c", str(tmp / f"{name}.yml")]
    out = tmp / side / FOLDER.get(name, name)
    if verb == "estimate-stabilization":
        return [verb, "-i", *[p for k in plates for p in paths[k]], "-o", str(out), *config]
    if verb == "estimate-psf":
        return [verb, "-i", *[p for k in plates for p in paths[k]], *config, "-o",
                str(out / "psf.zarr")]
    pair = ["-s", *paths[plates[0]], "-t", *paths[plates[1]]]
    if verb == "optimize-registration":
        return [verb, *pair, *config, "-o", str(out / "optimized.yml"), *extra]
    return [verb, *pair, "-o", str(out / "registration.yml"), *config, *extra]


def patch_reference(mp) -> None:
    """The reference's accelerator routes and shortened optimizer levels (as
    tests/test_torch_beads.py and tests/test_torch_intensity.py)."""
    mp.setattr(jbeads, "affine_warp_auto", accelerator_warp)
    warps = {}
    level = ji._optimize_level

    def optimize_level(mov, ref, params0, center, n_iters, out_shape, warp_fn=None):
        key = (tuple(mov.shape), tuple(out_shape))
        if key not in warps:
            warps[key] = make_traced_multipass_warp(mov.shape, out_shape, margin=0.15,
                                                    order=1, use_pallas=False)
        return level(mov, ref, params0, center, n_iters, out_shape, warp_fn=warps[key])

    def warp_auto(zyx, matrix, out_shape, fill=0.0, order=1):
        m = np.asarray(matrix, dtype=np.float64)
        if order == 1 and not jaff.is_inplane_matrix(m):
            from biahub_tpu.kernels.multipass_warp import multipass_affine_warp_zyx

            return multipass_affine_warp_zyx(zyx, m, out_shape, fill=fill)
        return jaff.affine_warp_auto(zyx, m, out_shape, fill=fill, order=order)

    mp.setattr(ji, "_optimize_level", optimize_level)
    mp.setattr(ji, "affine_warp_auto", warp_auto)
    mp.setattr(ji, "DEFAULT_REG_KWARGS", {**ji.DEFAULT_REG_KWARGS, **SHORT})


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one CPU thread: the intensity optimizer's
    thousands of small ops gain nothing from more, and with several test
    workers on the machine extra threads only wait for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The plates, each case's reference output and each case's port output."""
    tmp = tmp_path_factory.mktemp("estimate_verbs")
    paths = write_plates(tmp)
    for name, (_, _, config, _) in CASES.items():
        config = optimize_config() if config is None else json.loads(json.dumps(config))
        (tmp / f"{name}.yml").write_text(yaml.safe_dump(config, sort_keys=False))
    runner = CliRunner()
    with pytest.MonkeyPatch.context() as mp:
        patch_reference(mp)
        mp.setattr(ti, "DEFAULT_REG_KWARGS", {**ti.DEFAULT_REG_KWARGS, **SHORT})
        outputs = {}
        for name in CASES:
            for side in ("ref", "port"):  # optimize-registration makes no folder
                (tmp / side / name).mkdir(parents=True, exist_ok=True)
            res = runner.invoke(reference_cli, argv(name, tmp, "ref", paths))
            assert res.exit_code == 0, (name, res.output, res.exception)
            assert main(argv(name, tmp, "port", paths), device="cpu") == 0, name
            outputs[name] = res.output
    return tmp, paths, outputs


def files(root: Path) -> set[str]:
    return {str(p.relative_to(root)) for p in root.rglob("*") if p.is_file()
            and (HAS_MATPLOTLIB or p.suffix != ".png")}


def rows(path: Path) -> list[dict]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def same(got, want, atol: float) -> bool:
    """Equal keys in equal order and equal values; floats (the transforms)
    within ``atol``."""
    if isinstance(want, dict):
        return isinstance(got, dict) and list(got) == list(want) and all(
            same(got[k], want[k], atol) for k in want)
    if isinstance(want, list):
        return isinstance(got, list) and len(got) == len(want) and all(
            same(g, w, atol) for g, w in zip(got, want))
    if isinstance(want, float) and isinstance(got, (int, float)):
        return math.isclose(got, want, rel_tol=0, abs_tol=atol)
    return type(got) is type(want) and got == want


def read_yaml(path: Path):
    data = yaml.safe_load(path.read_text())
    assert same(load_file(path), data, 0.0)
    return data


def assert_yaml_files_match(root_got: Path, root_want: Path, atol: float) -> None:
    for rel in sorted(files(root_want)):
        if rel.endswith(".yml"):
            assert same(read_yaml(root_got / rel), read_yaml(root_want / rel), atol), rel


STAB_TOL = {"pcc": 0.0, "beads": 1e-9, "z": 0.0, "xy": 1e-4, "xyz": 1e-4}


@pytest.mark.parametrize("name", list(STAB_TOL))
def test_estimate_stabilization_writes_what_the_reference_writes(runs, name):
    tmp, _, _ = runs
    got, want = tmp / "port" / name, tmp / "ref" / name
    assert files(got) == files(want)
    assert_yaml_files_match(got, want, STAB_TOL[name])
    for rel in sorted(files(want)):
        if rel.endswith(".csv"):
            g, w = rows(got / rel), rows(want / rel)
            assert [list(r) for r in g] == [list(r) for r in w], rel
            assert [[float(v) if k != "position" and k != "channel" else v
                     for k, v in r.items()] for r in g] == \
                [[float(v) if k != "position" and k != "channel" else v
                  for k, v in r.items()] for r in w], rel
        elif rel.endswith(".npy"):
            np.testing.assert_allclose(np.load(got / rel), np.load(want / rel), rtol=0,
                                       atol=STAB_TOL[name], err_msg=rel)


def test_a_second_run_merges_the_focus_table(runs):
    """"z" and then "z_more" ran into one folder: the table holds both
    positions, and the second run's well average takes the first run's
    position too, as the reference's."""
    tmp, _, _ = runs
    table = rows(tmp / "port" / "z" / "positions_focus.csv")
    assert {r["position"] for r in table} == {"A/1/0", "B/2/0"} and len(table) == 8
    assert table == rows(tmp / "ref" / "z" / "positions_focus.csv")
    average = read_yaml(tmp / "port" / "z" / "z_stabilization_settings" / "average.yml")
    both = np.nanmean(np.where([FOCUS, [5, 0, 4, 6]] == np.int64(0), np.nan,
                               [FOCUS, [5, 0, 4, 6]]), axis=0)
    np.testing.assert_array_equal(np.asarray(average["affine_transform_zyx_list"])[:, 0, 3],
                                  both - both[0])


def test_estimate_stabilization_equals_its_arrays_function(runs):
    """The verb's transforms are those of estimate_stabilization_arrays on
    the same arrays (the PCC and beads routes; xy and xyz through the focus
    table equal the arrays route's in-memory focus on one run)."""
    tmp, paths, _ = runs
    for name, kind in (("pcc", "xyz"), ("beads", "xyz"), ("xy", "xy"), ("xyz", "xyz")):
        _, plates, config, _ = CASES[name]
        positions = {"/".join(Path(p).parts[-3:]): open_ome_zarr(p)
                     for k in plates for p in paths[k]}
        want = estimate_stabilization_arrays(positions, config, device="cpu")[kind]
        if name == "beads":
            got = {"beads": read_yaml(tmp / "port" / name / "xyz_stabilization_settings.yml")}
            want = {"beads": next(iter(want.values()))}
        else:
            got = {fov: read_yaml(tmp / "port" / name / f"{kind}_stabilization_settings"
                                  / f"{fov}.yml") for fov in want}
        for fov, transforms in want.items():
            assert got[fov]["affine_transform_zyx_list"] == transforms, (name, fov)


def test_estimate_psf_matches_the_reference_and_its_arrays_function(runs):
    tmp, _, _ = runs
    got, want = tmp / "port" / "psf" / "psf.zarr", tmp / "ref" / "psf" / "psf.zarr"
    g = np.asarray(open_ome_zarr(got / "0/0/0").data[...])
    w = np.asarray(reference_open(want / "0/0/0").data[...])
    assert g.shape == w.shape == (1, 1, 9, 15, 15) and g.dtype == np.float32
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    assert attributes(got) == attributes(want)
    arrays = estimate_psf_arrays(np.stack([psf_beads(1), psf_beads(2)]), PSF_SCALE,
                                 (9, 15, 15), device="cpu").numpy()
    assert np.array_equal(g[0, 0], arrays)


def test_estimate_psf_without_beads_is_an_error(runs, tmp_path, capsys):
    tmp, _, _ = runs
    plate = open_ome_zarr(tmp_path / "empty.zarr", layout="hcs", mode="w",
                          channel_names=["GFP"])
    plate.create_position("0", "0", "0").create_zeros("0", (1, 1, 8, 16, 16), np.float32)
    capsys.readouterr()
    assert main(["estimate-psf", "-i", str(tmp_path / "empty.zarr/0/0/0"), "-c",
                 str(tmp / "psf.yml"), "-o", str(tmp_path / "psf.zarr")], device="cpu") == 1
    assert capsys.readouterr().err.strip() == "Error: No beads detected in any input position."


REG_TOL = {"beads_reg": 1e-9}


def assert_transforms_close(got, want, name) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if name in REG_TOL:
        np.testing.assert_allclose(got, want, rtol=0, atol=REG_TOL[name])
    else:  # the intensity optimizer's tolerance (tests/test_torch_intensity.py)
        assert np.abs(got[..., :3, :3] - want[..., :3, :3]).max() < 0.01
        assert np.abs(got[..., :3, 3] - want[..., :3, 3]).max() < 0.3


@pytest.mark.parametrize("name", ["beads_reg", "ants1", "ants2", "optimize"])
def test_registration_verbs_write_what_the_reference_writes(runs, name):
    tmp, _, _ = runs
    got, want = tmp / "port" / name, tmp / "ref" / name
    assert files(got) == files(want)
    yml = "optimized.yml" if name == "optimize" else "registration.yml"
    g, w = read_yaml(got / yml), read_yaml(want / yml)
    key = "affine_transform_zyx_list" if name == "ants2" else "affine_transform_zyx"
    assert_transforms_close(g.pop(key), w.pop(key), name)
    assert g == w and list(g) == list(w)
    for rel in sorted(files(want)):
        if rel.endswith(".npy"):
            assert_transforms_close(np.load(got / rel), np.load(want / rel), name)


def test_registration_verbs_equal_their_arrays_functions(runs, monkeypatch):
    tmp, paths, _ = runs
    monkeypatch.setattr(ti, "DEFAULT_REG_KWARGS", {**ti.DEFAULT_REG_KWARGS, **SHORT})
    for name in ("beads_reg", "ants1", "ants2"):
        _, (src, tgt), config, _ = CASES[name]
        source, target = (open_ome_zarr(paths[k][0]) for k in (src, tgt))
        want = estimate_registration_arrays(
            source.data[...], target.data[...], source.channel_names, target.channel_names,
            config, target.scale, source.scale[-3:], device="cpu")
        got = read_yaml(tmp / "port" / name / "registration.yml")
        if name == "ants1":
            assert got.pop("source_channel_names") == ["GFP", "BF"]
            assert got.pop("target_channel_name") == "DAPI"
            want = {k: v for k, v in want.items() if k not in (
                "source_channel_names", "target_channel_name")}
        assert got == {k: v for k, v in want.items() if v is not None}, name
    source, target = (open_ome_zarr(paths[k][0]) for k in ("src2", "tgt2"))
    want = optimize_registration_arrays(
        source.data[0], target.data[0], np.asarray(optimize_config()["affine_transform_zyx"],
                                                   np.float32), crop=True, device="cpu")
    got = read_yaml(tmp / "port" / "optimize" / "optimized.yml")["affine_transform_zyx"]
    assert got == want.tolist()


def test_optimize_registration_messages(runs):
    _, _, outputs = runs
    assert "Time index 'all' is not supported" in outputs["optimize"]
    assert "napari viewing is unavailable in a headless" in outputs["optimize"]


def test_register_reads_the_estimated_registration(runs, capsys):
    """The YAML the port's estimate-registration wrote for one transform is
    the config of the port's register verb, and reads as the reference's
    reader reads it."""
    tmp, paths, _ = runs
    config = tmp / "port" / "ants1" / "registration.yml"
    assert same(load_file(config), yaml.safe_load(config.read_text()), 0.0)
    out = tmp / "port" / "registered.zarr"
    assert main(["register", "-s", *paths["src1"], "-t", *paths["tgt1"], "-c", str(config),
                 "-o", str(out)], device="cpu") == 0
    registered = open_ome_zarr(out / "0/0/0")
    assert sorted(registered.channel_names) == ["BF", "DAPI", "GFP", "Phase3D"]
    assert np.isfinite(registered.data[...]).all() and registered.data[0, 0].any()


MANUAL = yaml.safe_load((ROOT / "settings/example_estimate_registration_settings_manual.yml")
                        .read_text())
# (N, 3) ZYX point pairs in the frames of the manual plates.
SOURCE_POINTS = np.array([[2.0, 10.5, 12.0], [5.0, 30.25, 8.0], [7.5, 20.0, 33.0],
                          [3.0, 40.0, 40.5], [6.0, 12.0, 44.0]])
TARGET_POINTS = SOURCE_POINTS @ np.array([[1.0, 0.0, 0.0], [0.0, 0.998, -0.05],
                                          [0.0, 0.05, 0.998]]).T + [1.0, -2.0, 3.0]


@pytest.fixture(scope="module")
def manual_plates(tmp_path_factory) -> dict:
    """A source and a target position of other shapes and voxel sizes, the
    channels the manual example settings name among others."""
    tmp = tmp_path_factory.mktemp("manual")
    rng = np.random.default_rng(7)
    paths = {}
    for name, shape, scale, names in (
            ("src", (1, 2, 8, 48, 50), [1.0, 1.0, 0.5, 0.2, 0.2], ["BF", "GFP"]),
            ("tgt", (1, 2, 10, 60, 40), [1.0, 1.0, 0.4, 0.1, 0.1], ["DAPI", "Phase3D"])):
        root = open_ome_zarr(tmp / f"{name}.zarr", layout="hcs", mode="w", channel_names=names)
        root.create_position("0", "0", "0").create_image(
            "0", rng.random(shape).astype(np.float32),
            transform=[TransformationMeta(type="scale", scale=scale)])
        paths[name] = [str(tmp / f"{name}.zarr" / "0" / "0" / "0")]
    return paths


def write_points(path: Path, pts: np.ndarray, fmt: str) -> Path:
    """``pts`` as a ``.npy`` file, a headerless CSV, or napari's "Save
    Points layer" export (a header row and a leading index column)."""
    if fmt == "npy":
        np.save(path.with_suffix(".npy"), pts)
        return path.with_suffix(".npy")
    path = path.with_suffix(".csv")
    if fmt == "csv":
        np.savetxt(path, pts, delimiter=",")
    else:
        rows = [f"{i},{z},{y},{x}" for i, (z, y, x) in enumerate(pts.tolist())]
        path.write_text("\n".join(["index,axis-0,axis-1,axis-2", *rows]) + "\n")
    return path


@pytest.mark.parametrize("fmt", ["npy", "csv", "napari"])
@pytest.mark.parametrize("frame", ["pre_aligned", "original"])
@pytest.mark.parametrize("kind", ["euclidean", "similarity"])
def test_manual_method_from_point_files_writes_the_reference_matrix(manual_plates, tmp_path,
                                                                    fmt, frame, kind):
    """The reference's manual example settings (similarity; euclidean with
    a 90 degree pre-rotation and a flip) and point files: the port's YAML
    equals the reference verb's (click's runner) and the reference's
    ``registration_from_point_pairs`` within 1e-12."""
    from biahub_tpu.estimate_registration import registration_from_point_pairs

    paths = manual_plates
    settings = json.loads(json.dumps(MANUAL))
    settings["affine_transform_settings"]["transform_type"] = kind
    if kind == "euclidean":
        settings["manual_registration_settings"].update(affine_90degree_rotation=1,
                                                        affine_fliplr=True)
    config = tmp_path / "manual.yml"
    config.write_text(yaml.safe_dump(settings, sort_keys=False))
    points = ["--source-points", str(write_points(tmp_path / "src", SOURCE_POINTS, fmt)),
              "--target-points", str(write_points(tmp_path / "tgt", TARGET_POINTS, fmt)),
              "--source-points-frame", frame]
    pair = ["-s", *paths["src"], "-t", *paths["tgt"], "-c", str(config)]
    res = CliRunner().invoke(reference_cli, ["estimate-registration", *pair, "-o",
                                             str(tmp_path / "ref" / "out.yml"), *points])
    assert res.exit_code == 0, (res.output, res.exception)
    assert main(["estimate-registration", *pair, "-o", str(tmp_path / "port" / "out.yml"),
                 *points], device="cpu") == 0
    got, want = read_yaml(tmp_path / "port" / "out.yml"), read_yaml(tmp_path / "ref" / "out.yml")
    assert same(got, want, 1e-12)
    source = reference_open(paths["src"][0])
    target = reference_open(paths["tgt"][0])
    manual = settings["manual_registration_settings"]
    host = registration_from_point_pairs(
        SOURCE_POINTS, TARGET_POINTS, source.data.shape[-3:], target.data.shape[-3:],
        source.scale[-3:], target.scale[-3:], kind == "similarity",
        manual["affine_90degree_rotation"], manual["affine_fliplr"], frame)
    np.testing.assert_allclose(got["affine_transform_zyx"], host, rtol=0, atol=1e-12)
    assert not np.allclose(host, np.eye(4))


def test_estimate_registration_refuses_manual(manual_plates, tmp_path, capsys):
    """Without point files (and without napari) the manual method exits 1
    with the reference's headless message, and so does one point file
    alone with the reference's pairing message; nothing is written."""
    from biahub_tpu.estimate_registration import user_assisted_registration

    paths = manual_plates
    config = tmp_path / "manual.yml"
    config.write_text(yaml.safe_dump(MANUAL, sort_keys=False))
    with pytest.raises(RuntimeError) as headless:
        user_assisted_registration(np.zeros((2, 4, 4)), "GFP", (1, 1, 1), np.zeros((2, 4, 4)),
                                   "Phase3D", (1, 1, 1))
    pair = ["estimate-registration", "-s", *paths["src"], "-t", *paths["tgt"], "-o",
            str(tmp_path / "out.yml"), "-c", str(config)]
    capsys.readouterr()
    assert main(pair, device="cpu") == 1
    assert f"Error: {headless.value}" in capsys.readouterr().err
    one = write_points(tmp_path / "src", SOURCE_POINTS, "npy")
    assert main([*pair, "--source-points", str(one)], device="cpu") == 1
    assert "--source-points and --target-points must be given together" in \
        capsys.readouterr().err
    assert not (tmp_path / "out.yml").exists()


def test_the_port_imports_no_settings_or_table_library_and_plots_lazily():
    """No module of the port imports yaml, pandas, click, pydantic,
    tensorstore or zarr; matplotlib only inside functions."""
    import ast

    for path in sorted((ROOT / "biahub_tpu_torch").rglob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            roots = {n.split(".")[0] for n in names}
            assert not roots & {"yaml", "pandas", "click", "pydantic", "tensorstore",
                                "zarr"}, path
        for node in tree.body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] if isinstance(node, ast.Import) else [
                    node.module or ""]
                assert all(n.split(".")[0] != "matplotlib" for n in names), path


def test_peaks_from_beads_filters_the_reference_peaks_with_a_mask(tmp_path):
    """``mask_path``: a position whose first volume masks (y, x) columns;
    the reference peaks under a masked column are dropped, as the
    reference's (which reads the port's plate)."""
    from biahub_tpu.settings import DetectPeaksSettings
    from biahub_tpu_torch.registration import beads as tbeads

    frames = render_frames(TRUTH[:2])
    mask = np.zeros((1, 1) + frames.shape[1:], np.float32)
    mask[0, 0, 3, :64] = 1.0  # one z slice marks every column with y < 64
    plate = open_ome_zarr(tmp_path / "mask.zarr", layout="hcs", mode="w",
                          channel_names=["mask"])
    plate.create_position("0", "0", "0").create_image("0", mask)
    path = tmp_path / "mask.zarr" / "0" / "0" / "0"
    want = jbeads.peaks_from_beads(frames[1], frames[0], DetectPeaksSettings(**PEAKS),
                                   DetectPeaksSettings(**PEAKS), mask_path=path)
    got = tbeads.peaks_from_beads(frames[1], frames[0], PEAKS, PEAKS, mask_path=path,
                                  device="cpu")
    unmasked = tbeads.peaks_from_beads(frames[1], frames[0], PEAKS, PEAKS, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert len(got[1]) < len(unmasked[1]) and (np.asarray(got[1])[:, 1] >= 64).all()


def test_a_plot_without_matplotlib_is_announced_and_the_rest_written(tmp_path, monkeypatch,
                                                                    capsys):
    import sys

    from biahub_tpu_torch.registration.utils import save_transforms

    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import raises ImportError
    model = {"stabilization_estimation_channel": "GFP", "stabilization_type": "xyz",
             "stabilization_method": "beads", "stabilization_channels": ["GFP"],
             "affine_transform_zyx_list": [], "time_indices": "all",
             "output_voxel_size": [1.0] * 5}
    save_transforms(model, [np.eye(4).tolist()] * 2, tmp_path / "out" / "a.yml",
                    tmp_path / "plots" / "a.png", verbose=True)
    assert load_file(tmp_path / "out" / "a.yml")["affine_transform_zyx_list"] == \
        [np.eye(4).tolist()] * 2
    assert not (tmp_path / "plots" / "a.png").exists()
    assert capsys.readouterr().err.strip() == (
        f"biahub_tpu_torch: matplotlib is not installed; plot {tmp_path / 'plots' / 'a.png'} "
        "not written")
