"""biahub_tpu_torch's verbs on plates against biahub_tpu's.

The port writes the input plate (two positions, T 2, C 2, float32 (12, 14,
40), 0.116 um pixels) and a PSF plate with its own writer; each case runs
the reference verb through click's runner once (a module fixture) and the
port's through ``cli.main([...], device="cpu")`` on the same plates. For
each case:

- the arrays agree within 1e-5 * max |ref| (the ``*_arrays`` functions'
  tolerance: the FFT engine's and the warps' envelope);
- the metadata is equal: every group's attributes, and each array's shape,
  chunks and dtype (the codecs differ: the port writes uncompressed);
- the port's plate equals its ``*_arrays`` function on the same arrays bit
  for bit.

fuse, deskew, register and stabilize run in budget and over it
(``BIAHUB_TPU_MAX_BATCH_BYTES`` for both packages: the chunked routes); deconvolve also compares ``transfer_function.zarr``; flat-field
writes a v0.5 plate from the v0.4 input (provenance copied across). General
matrices do not occur here (in-plane ones only), so the reference's CPU
dispatch needs no patch. flip and pyramid run in place on copies of the
input plate, bit-equal to the reference's and to NumPy; the deconvolve
verb's sharded route (``BIAHUB_TPU_SHARDED_FFT=1``, a virtual mesh of two
CPU shards) is bit-equal to ``deconvolve_arrays(sharded=True)`` on that
mesh and within 2e-5 * max |batched| of the batched verb.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import yaml
from click.testing import CliRunner
from scipy.spatial.transform import Rotation

from biahub_tpu.cli.main import cli as reference_cli
from biahub_tpu.io.ngff import open_ome_zarr as reference_open
from biahub_tpu_torch import (
    deskew_arrays,
    fuse_arrays,
    flat_field_arrays,
    register_arrays,
    stabilize_tczyx,
)
from biahub_tpu_torch.cli.main import main
from biahub_tpu_torch.deconvolve import deconvolve_arrays
from biahub_tpu_torch.estimate_stabilization import ArrayPosition
from biahub_tpu_torch.io.ngff import TransformationMeta, open_ome_zarr
from biahub_tpu_torch.kernels.deconvolve import compute_transfer_function

RTOL = 1e-5
SHAPE = (2, 2, 12, 14, 40)
SCALE = (1, 1, 1.0, 0.116, 0.116)
NAMES = ["GFP", "RFP"]
POSITIONS = ("A/1/0", "B/2/0")
OVER = 16384  # bytes: below one fused unit of this plate


def about_centre(deg: float, shift, centre=(2.0, 20.0, 20.0)) -> list:
    m = np.eye(4)
    r = Rotation.from_euler("zyx", [0, 0, deg], degrees=True).as_matrix()
    m[:3, :3] = r
    m[:3, 3] = np.asarray(centre) - r @ np.asarray(centre) + np.asarray(shift, float)
    return m.tolist()


FILL = {"pixel_size_um": 0.116, "ls_angle_deg": 36.17, "px_to_scan_ratio": 0.371,
        "keep_overhang": True, "overhang_fill": "mean", "average_n_slices": 3}
STAB = {"affine_transform_zyx_list": [about_centre(1.0 * t, [0, 0.3 * t, -0.4 * t])
                                      for t in range(2)]}
FUSE = {"flat_field": {"channel_names": ["GFP"]}, "deconvolve": {"regularization_strength": 1e-3},
        "deskew": FILL, "stabilization": STAB}
FUSE_OVER = {"flat_field": {"channel_names": ["GFP"]}, "deskew": FILL, "stabilization": STAB}
REGISTER = {"source_channel_names": ["GFP"], "target_channel_name": "RFP",
            "affine_transform_zyx": about_centre(3.0, [0, -0.5, 1.25], centre=(6, 7, 20)),
            "keep_overhang": False}
STABILIZE = {"stabilization_estimation_channel": "GFP", "stabilization_type": "xyz",
             "stabilization_channels": ["GFP"],
             "affine_transform_zyx_list": [about_centre(0.5 * t, [0, 0.25 * t, 0.5], (6, 7, 20))
                                           for t in range(2)]}

# name: (verb, settings, budget, needs the PSF)
CASES = {
    "fuse": ("fuse", FUSE, None, True),
    "fuse_over": ("fuse", FUSE_OVER, OVER, False),
    "deconvolve": ("deconvolve", {"regularization_strength": 1e-3}, None, True),
    "deskew": ("deskew", FILL, None, False),
    "deskew_over": ("deskew", FILL, OVER, False),
    "flat_field": ("flat-field", {"channel_names": ["GFP"], "output_ome_zarr_version": "0.5"},
                   None, False),
    "register": ("register", REGISTER, None, False),
    "register_over": ("register", REGISTER, OVER, False),
    "stabilize": ("stabilize", STABILIZE, None, False),
    "stabilize_over": ("stabilize", STABILIZE, OVER, False),
}


def psf() -> np.ndarray:
    zz, yy, xx = np.meshgrid(*[np.arange(s) - (s - 1) / 2 for s in (3, 5, 5)], indexing="ij")
    p = np.exp(-(zz ** 2 + yy ** 2 + xx ** 2) / 2).astype(np.float32)
    return p / p.sum()


def argv(name: str, tmp: Path, out: Path) -> list[str]:
    verb, _, _, needs_psf = CASES[name]
    inputs = [str(tmp / "in.zarr" / p) for p in POSITIONS]
    cfg = ["-c", str(tmp / f"{name}.yml")]
    if verb == "register":
        args = [verb, "-s", *inputs, "-t", *inputs, *cfg, "-o", str(out)]
    else:
        args = [verb, "-i", *inputs, *cfg, "-o", str(out)]
    if needs_psf:
        args += ["-p", str(tmp / "psf.zarr")]
    return args + (["--cluster", "debug"] if verb in ("fuse", "deskew", "flat-field") else [])


@pytest.fixture(scope="module")
def plates(tmp_path_factory):
    """The input plates (written by the port) and each case's reference output."""
    tmp = tmp_path_factory.mktemp("plate_verbs")
    data = np.random.default_rng(11).uniform(1, 255, (len(POSITIONS),) + SHAPE).astype(
        np.float32)
    plate = open_ome_zarr(tmp / "in.zarr", layout="hcs", mode="w", channel_names=NAMES)
    for key, arr in zip(POSITIONS, data):
        pos = plate.create_position(*key.split("/"))
        pos.create_image("0", arr, transform=[TransformationMeta(type="scale", scale=SCALE)])
        pos.update_zattrs({"biahub-acquisition": {"note": key}})
    psf_plate = open_ome_zarr(tmp / "psf.zarr", layout="hcs", mode="w", channel_names=["PSF"])
    psf_plate.create_position("0", "0", "0").create_image(
        "0", psf()[None, None], transform=[TransformationMeta(type="scale", scale=SCALE)])
    runner = CliRunner()
    with pytest.MonkeyPatch.context() as mp:
        for name, (verb, settings, budget, _) in CASES.items():
            (tmp / f"{name}.yml").write_text(yaml.safe_dump(settings))
            if budget is None:
                mp.delenv("BIAHUB_TPU_MAX_BATCH_BYTES", raising=False)
            else:
                mp.setenv("BIAHUB_TPU_MAX_BATCH_BYTES", str(budget))
            res = runner.invoke(reference_cli, argv(name, tmp, tmp / "ref" / name / "out.zarr"))
            assert res.exit_code == 0, (name, res.output, res.exception)
    return tmp, data


def run_port(name: str, tmp: Path, monkeypatch, extra=()) -> Path:
    out = tmp / "port" / name / "out.zarr"
    budget = CASES[name][2]
    if budget is None:
        monkeypatch.delenv("BIAHUB_TPU_MAX_BATCH_BYTES", raising=False)
    else:
        monkeypatch.setenv("BIAHUB_TPU_MAX_BATCH_BYTES", str(budget))
    assert main(argv(name, tmp, out) + list(extra), device="cpu") == 0
    return out


def attributes(root: Path) -> dict:
    """Every group's attributes and every array's shape, chunks and dtype,
    by path relative to ``root``."""
    out = {}
    for f in sorted(root.rglob("*")):
        rel = str(f.parent.relative_to(root))
        if f.name == ".zattrs":
            out[rel] = json.loads(f.read_text())
        elif f.name == ".zarray":
            meta = json.loads(f.read_text())
            out[rel] = {k: meta[k] for k in ("shape", "chunks", "dtype", "fill_value")}
        elif f.name == "zarr.json":
            meta = json.loads(f.read_text())
            keep = ("attributes", "node_type", "shape", "chunk_grid", "data_type", "fill_value")
            out[rel] = {k: meta[k] for k in keep if k in meta}
    return out


def read(root: Path) -> np.ndarray:
    return np.stack([np.asarray(open_ome_zarr(root / p).data[...]) for p in POSITIONS])


def arrays_fn(name: str, data: np.ndarray, tmp: Path) -> np.ndarray:
    """The port's ``*_arrays`` function on each position's array."""
    verb, settings, budget, _ = CASES[name]
    kw = {} if budget is None else {"max_batch_bytes": budget}
    out = []
    for arr in data:
        if verb == "fuse":
            tf = compute_transfer_function(psf(), SHAPE[2:])[..., : SHAPE[-1] // 2 + 1]
            got = fuse_arrays(arr, NAMES, settings, tf_half=tf, device="cpu", **kw)
        elif verb == "deskew":
            got = deskew_arrays(arr, settings, device="cpu", **kw)
        elif verb == "flat-field":
            got = flat_field_arrays(arr, NAMES, settings, device="cpu")
        elif verb == "register":
            got = register_arrays(arr, NAMES, settings, SCALE[2:], device="cpu", **kw)[0]
        elif verb == "stabilize":
            mats = np.asarray(settings["affine_transform_zyx_list"], np.float32)
            got = stabilize_tczyx(arr, mats, device="cpu", **kw)
        else:
            pos = ArrayPosition(arr, list(SCALE), NAMES)
            got = deconvolve_arrays({"A/1/0": pos}, psf(), SCALE, settings,
                                    device="cpu")[0]["A/1/0"]
        out.append(got.cpu().numpy())
    return np.stack(out)


@pytest.mark.parametrize("name", list(CASES))
def test_plate_verb_matches_the_reference_and_its_arrays_function(plates, name, monkeypatch):
    tmp, data = plates
    out = run_port(name, tmp, monkeypatch)
    ref = tmp / "ref" / name / "out.zarr"
    got, want = read(out), np.stack([np.asarray(reference_open(ref / p).data[...])
                                     for p in POSITIONS])
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()
    assert attributes(out) == attributes(ref)
    assert np.array_equal(got, arrays_fn(name, data, tmp))
    if CASES[name][3]:
        tf_got = open_ome_zarr(out.parent / "transfer_function.zarr").data[...]
        tf_want = reference_open(ref.parent / "transfer_function.zarr").data[...]
        assert np.abs(tf_got - tf_want).max() <= 1e-6
        assert attributes(out.parent / "transfer_function.zarr") == \
            attributes(ref.parent / "transfer_function.zarr")


@pytest.mark.parametrize("name", ["fuse", "fuse_over"])
def test_resume_computes_nothing_and_keeps_the_plate(plates, name, monkeypatch, capsys):
    tmp, _ = plates
    out = run_port(name, tmp, monkeypatch, ["--resume"])
    before = read(out)
    stamps = {p: p.stat().st_mtime_ns for p in out.rglob("*") if p.is_file()}
    capsys.readouterr()
    run_port(name, tmp, monkeypatch, ["--resume"])
    text = capsys.readouterr().out
    if CASES[name][2] is None:
        assert text.count("Resume: skipping 4 finished units") == 2  # flat-field and the rest
        assert "Fused flat-field+deconvolve+deskew+stabilize: 0 (t, c) volumes" in text
    else:  # the chunked route counts the finished units as it skips them
        assert "Fused (chunked fallback): 8 (t, c) volumes" in text
    assert np.array_equal(read(out), before)
    chunks = [p for p in stamps if p.name[0].isdigit() or "/c/" in str(p)]
    assert chunks and all(p.stat().st_mtime_ns == stamps[p] for p in chunks)


def test_init_only_creates_the_plate_and_computes_nothing(plates, monkeypatch, capsys):
    tmp, _ = plates
    out = tmp / "port" / "init" / "out.zarr"
    assert main(argv("deskew", tmp, out) + ["--init"], device="cpu") == 0
    assert "RESOURCES:" in capsys.readouterr().out
    assert not np.any(read(out))
    assert open_ome_zarr(out / POSITIONS[0]).data.shape[:2] == SHAPE[:2]


def test_unported_verbs_and_the_device(plates, capsys):
    tmp, _ = plates
    # Every entry is ported: a bad option is the verb's own usage error.
    with pytest.raises(SystemExit) as exc:
        main(["estimate-crop", "-i", "x"], device="cpu")
    assert exc.value.code == 2
    assert "required: --config-filepath/-c" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv("deskew", tmp, tmp / "port" / "nocard.zarr"))
    with pytest.raises(SystemExit) as exc:
        main(["deskew", "-i", str(tmp / "in.zarr"), "-c", str(tmp / "deskew.yml"), "-o",
              str(tmp / "x.zarr")], device="cpu")
    assert exc.value.code == 2
    assert "single position instead of an HCS plate" in capsys.readouterr().err


def test_fuse_without_a_psf_raises(plates):
    tmp, _ = plates
    args = [a for a in argv("fuse", tmp, tmp / "port" / "nopsf.zarr")]
    args = args[:args.index("-p")] + args[args.index("-p") + 2:]
    with pytest.raises(ValueError, match="needs a PSF"):
        main(args, device="cpu")


def test_fuse_flat_field_only_copies_a_time_subset_at_its_output_index(plates):
    """flat-field as the only stage with ``time_indices: [1]``: the other
    channel is copied at output timepoint 0, as ``fuse_arrays`` puts it (the
    reference's ``copy_channels`` writes at the raw timepoint and fails
    here, ROADMAP queue 3)."""
    tmp, data = plates
    settings = {"flat_field": {"channel_names": ["GFP"]}, "time_indices": [1]}
    (tmp / "ff_subset.yml").write_text(yaml.safe_dump(settings))
    out = tmp / "port" / "ff_subset" / "out.zarr"
    assert main(["fuse", "-i", *[str(tmp / "in.zarr" / p) for p in POSITIONS], "-c",
                 str(tmp / "ff_subset.yml"), "-o", str(out), "--cluster", "debug"],
                device="cpu") == 0
    want = np.stack([fuse_arrays(arr, NAMES, settings, device="cpu").numpy() for arr in data])
    got = read(out)
    assert got.shape == (2, 1, 2) + SHAPE[2:]
    assert np.array_equal(got, want)
    assert np.array_equal(got[:, 0, 1], data[:, 1, 1])


# -- flip and pyramid: in place, bit-equal to the reference and to NumPy ------

ASSEMBLY = {
    "flip_x": ["flip", "-x"],
    "flip_y": ["flip", "-y"],
    "flip_xy": ["flip", "-x", "-y"],
    "pyramid_mean": ["pyramid", "--levels", "3"],
    "pyramid_mode": ["pyramid", "-lv", "2", "-m", "mode"],
    "pyramid_median": ["pyramid", "--levels", "4", "--method", "median"],
    "pyramid_stride": ["pyramid", "--levels", "3", "--method", "stride"],
}


def numpy_pyramid(arr: np.ndarray, levels: int, method: str) -> list[np.ndarray]:
    """Each level's 2 x 2 reduction of the one before, in NumPy."""
    out = [arr]
    for _ in range(1, levels):
        prev = out[-1]
        y2, x2 = max(prev.shape[-2] // 2, 1), max(prev.shape[-1] // 2, 1)
        if method == "stride":
            out.append(prev[..., ::2, ::2][..., :y2, :x2])
            continue
        blocks = prev[..., :y2 * 2, :x2 * 2].reshape(prev.shape[:-2] + (y2, 2, x2, 2))
        if method == "mode":
            flat = np.moveaxis(blocks, -3, -2).reshape(prev.shape[:-2] + (y2, x2, 4))
            out.append(np.sort(flat, axis=-1)[..., 1])
        else:
            out.append(getattr(np, method)(blocks, axis=(-3, -1)).astype(prev.dtype))
    return out


@pytest.mark.parametrize("name", list(ASSEMBLY))
def test_flip_and_pyramid_match_the_reference_bit_for_bit(plates, name):
    import shutil

    tmp, data = plates
    roots = {k: tmp / "assembly" / name / k for k in ("ref", "port")}
    for root in roots.values():
        shutil.copytree(tmp / "in.zarr", root)
    args = ASSEMBLY[name]
    res = CliRunner().invoke(reference_cli, [args[0], "-i", *[str(roots["ref"] / p)
                                                            for p in POSITIONS], *args[1:]])
    assert res.exit_code == 0, (res.output, res.exception)
    assert main([args[0], "-i", *[str(roots["port"] / p) for p in POSITIONS], *args[1:]],
                device="cpu") == 0
    assert attributes(roots["port"]) == attributes(roots["ref"])
    for key, arr in zip(POSITIONS, data):
        got, want = open_ome_zarr(roots["port"] / key), reference_open(roots["ref"] / key)
        assert got.array_names() == want.array_names()
        if args[0] == "flip":
            flipped = arr[..., ::-1] if "-x" in args else arr
            flipped = flipped[..., ::-1, :] if "-y" in args else flipped
            assert np.array_equal(got.data[...], flipped)
            assert np.array_equal(got.data[...], want.data[...])
            continue
        levels = int(args[args.index("--levels" if "--levels" in args else "-lv") + 1])
        method = args[-1] if len(args) > 3 else "mean"
        for level, expect in enumerate(numpy_pyramid(arr, levels, method)):
            assert np.array_equal(got[str(level)][...], expect)
            assert np.array_equal(got[str(level)][...], want[str(level)][...])


# -- the deconvolve verb's sharded route on plates -------------------------------

def test_sharded_deconvolve_on_plates(plates, monkeypatch, capsys):
    """Under BIAHUB_TPU_SHARDED_FFT=1 with a mesh of two shards the plate is
    bit-equal to ``deconvolve_arrays(sharded=True)`` on that mesh and within
    2e-5 * max |batched| of the batched verb; a mesh of one shard takes the
    batched route."""
    from biahub_tpu_torch.deconvolve import deconvolve
    from biahub_tpu_torch.parallel.mesh import Mesh

    tmp, data = plates
    mesh = Mesh.virtual("cpu", 2)
    inputs = [tmp / "in.zarr" / p for p in POSITIONS]
    monkeypatch.setenv("BIAHUB_TPU_SHARDED_FFT", "1")
    out = tmp / "port" / "sharded" / "out.zarr"
    deconvolve(inputs, tmp / "psf.zarr", tmp / "deconvolve.yml", out, device="cpu", mesh=mesh)
    text = capsys.readouterr()
    assert "each volume sharded over 2 local devices" in text.out
    assert text.err.count("sharded deconvolve") == 2 * SHAPE[0] * SHAPE[1]
    settings = CASES["deconvolve"][1]
    got = read(out)
    for arr, plate_arr in zip(data, got):
        pos = {"A/1/0": ArrayPosition(arr, list(SCALE), NAMES)}
        want = deconvolve_arrays(pos, psf(), SCALE, settings, mesh=mesh, sharded=True,
                                 device="cpu")[0]["A/1/0"].numpy()
        assert np.array_equal(plate_arr, want)
    batched = tmp / "port" / "sharded_one" / "out.zarr"
    capsys.readouterr()
    deconvolve(inputs, tmp / "psf.zarr", tmp / "deconvolve.yml", batched, device="cpu")
    assert "sharded" not in capsys.readouterr().out
    want = read(batched)
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()
    assert attributes(out) == attributes(batched)
