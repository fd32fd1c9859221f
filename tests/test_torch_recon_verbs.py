"""biahub_tpu_torch's compute-tf, apply-inv-tf and reconstruct verbs on plates
against biahub_tpu's.

The port writes the input plate (two positions, T 2, the five polarization
states and GFP of tests/test_torch_recon.py at (8, 16, 24)); each reference
verb runs once through click's runner (a module fixture, the reference's
XLA route at full FFT precision) and the port's through ``cli.main([...],
device="cpu")`` on the same plate. For each case:

- the reconstructions agree within RTOL x max |ref| per output channel, the
  transfer-function stores within 5e-6 x max |ref| (tests/test_torch_recon.py's
  tolerances);
- the metadata is equal: every group's attributes (provenance and the
  ``biahub-compute-tf`` and ``biahub-reconstruct`` records) and each
  array's shape, chunks and dtype, at the same paths;
- the port's plates equal its ``*_arrays`` functions bit for bit.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner

from biahub_tpu.cli.main import cli as reference_cli
from biahub_tpu.io.ngff import open_ome_zarr as reference_open
from biahub_tpu_torch import (
    apply_inverse_transfer_function_arrays,
    compute_transfer_function_arrays,
    output_channel_names,
    reconstruct_arrays,
)
from biahub_tpu_torch.apply_inverse_transfer_function import _load_transfer_functions
from biahub_tpu_torch.cli.main import main
from biahub_tpu_torch.io.ngff import TransformationMeta, open_ome_zarr
from tests.test_torch_plate_verbs import attributes
from tests.test_torch_recon import CHANNELS, FULL, RTOL, polarization_stack

SHAPE = (8, 16, 24)
SCALE = [1.0, 1.0, 2.0, 0.325, 0.325]
POSITIONS = ("A/1/0", "B/2/0")
PHASE_T1 = {"input_channel_names": ["State0"], "time_indices": [1],
            "phase": {"transfer_function": {"invert_phase_contrast": True}}}
FLUOR = {"input_channel_names": ["GFP"], "fluorescence": {}}
CONFIGS = {"full": FULL, "phase_t1": PHASE_T1, "fluor": FLUOR}
# name: (verb, config); the transfer function of apply-inv-tf is the
# compute-tf case's store of the same config
CASES = {
    "compute_tf": ("compute-tf", "full"),
    "compute_tf_fluor": ("compute-tf", "fluor"),
    "apply_inv_tf": ("apply-inv-tf", "full"),
    "apply_inv_tf_init": ("apply-inv-tf", "full"),
    "reconstruct": ("reconstruct", "phase_t1"),
}


def argv(name: str, tmp: Path, side: str) -> list[str]:
    verb, config = CASES[name]
    inputs = [str(tmp / "in.zarr" / p) for p in POSITIONS]
    out = tmp / side / name / "out.zarr"
    args = [verb, "-i", *(inputs[:1] if verb == "compute-tf" else inputs), "-c",
            str(tmp / f"{config}.yml"), "-o", str(out)]
    if verb == "apply-inv-tf":
        args[4:4] = ["-t", str(tmp / side / "compute_tf" / "out.zarr")]
        args += ["--cluster", "debug"] + (["--init"] if name.endswith("init") else [])
    return args


@pytest.fixture(scope="module")
def plates(tmp_path_factory):
    """The input plate (written by the port) and each case's reference output."""
    tmp = tmp_path_factory.mktemp("recon_verbs")
    data = np.stack([polarization_stack(SHAPE, t=2, seed=s) for s in range(len(POSITIONS))])
    plate = open_ome_zarr(tmp / "in.zarr", layout="hcs", mode="w", channel_names=CHANNELS)
    for key, arr in zip(POSITIONS, data):
        pos = plate.create_position(*key.split("/"))
        pos.create_image("0", arr, transform=[TransformationMeta(type="scale", scale=SCALE)])
        pos.update_zattrs({"biahub-acquisition": {"note": key}})
    for name, config in CONFIGS.items():
        (tmp / f"{name}.yml").write_text(yaml.safe_dump(config))
    runner = CliRunner()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BIAHUB_TPU_NO_PALLAS", "1")
        mp.setenv("BIAHUB_TPU_FFT_PRECISION", "highest")
        for name in CASES:
            res = runner.invoke(reference_cli, argv(name, tmp, "ref"))
            assert res.exit_code == 0, (name, res.output, res.exception)
    return tmp, data


def run_port(name: str, tmp: Path) -> Path:
    assert main(argv(name, tmp, "port"), device="cpu") == 0
    return tmp / "port" / name / "out.zarr"


def read(root: Path, keys=POSITIONS) -> np.ndarray:
    return np.stack([np.asarray(open_ome_zarr(root / k).data[...]) for k in keys])


def read_reference(root: Path, keys=POSITIONS) -> np.ndarray:
    return np.stack([np.asarray(reference_open(root / k).data[...]) for k in keys])


@pytest.mark.parametrize("name", ["compute_tf", "compute_tf_fluor"])
def test_compute_tf_matches_the_reference_and_its_arrays_function(plates, name):
    tmp, _ = plates
    out = run_port(name, tmp)
    ref = tmp / "ref" / name / "out.zarr"
    got, want = read(out, ["0/0/0"]), read_reference(ref, ["0/0/0"])
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    assert np.abs(got - want).max() <= 5e-6 * np.abs(want).max()
    assert attributes(out) == attributes(ref)
    tfs = compute_transfer_function_arrays(SHAPE, CONFIGS[CASES[name][1]], device="cpu")
    parts = [p for tf in tfs.values() for p in (tf.real, tf.imag)]
    assert np.array_equal(got[0, 0], torch.stack(parts).numpy())


def test_apply_inv_tf_matches_the_reference_and_its_arrays_function(plates):
    tmp, data = plates
    run_port("compute_tf", tmp)
    out = run_port("apply_inv_tf", tmp)
    ref = tmp / "ref" / "apply_inv_tf" / "out.zarr"
    got, want = read(out), read_reference(ref)
    assert got.shape == want.shape == (2, 2, 10) + SHAPE and got.dtype == np.float32
    for c, channel in enumerate(output_channel_names(FULL)):
        err = np.abs(got[:, :, c] - want[:, :, c]).max()
        assert err <= RTOL * np.abs(want[:, :, c]).max(), channel
    assert attributes(out) == attributes(ref)
    tfs = _load_transfer_functions(tmp / "port" / "compute_tf" / "out.zarr")
    for got_p, arr in zip(got, data):
        assert np.array_equal(got_p, apply_inverse_transfer_function_arrays(
            arr, CHANNELS, tfs, FULL, device="cpu").numpy())


def test_apply_inv_tf_init_only_creates_the_plate_and_computes_nothing(plates, capsys):
    tmp, _ = plates
    run_port("compute_tf", tmp)
    out = run_port("apply_inv_tf_init", tmp)
    assert "Initialized" in capsys.readouterr().out
    assert not np.any(read(out))
    assert attributes(out) == attributes(tmp / "ref" / "apply_inv_tf_init" / "out.zarr")


def test_reconstruct_matches_the_reference_and_its_arrays_function(plates):
    tmp, data = plates
    out = run_port("reconstruct", tmp)
    ref = tmp / "ref" / "reconstruct" / "out.zarr"
    got, want = read(out), read_reference(ref)
    assert got.shape == want.shape == (2, 1, 1) + SHAPE
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()
    assert attributes(out) == attributes(ref)
    store = "transfer_function_phase_t1.zarr"
    assert attributes(out.parent / store) == attributes(ref.parent / store)
    for got_p, arr in zip(got, data):
        assert np.array_equal(got_p, reconstruct_arrays(arr, CHANNELS, PHASE_T1,
                                                        device="cpu").numpy())


def test_apply_inv_tf_refuses_a_store_without_the_modality(plates, capsys):
    """A fluorescence-only store for a config that asks for phase: the
    reference's message and exit status 1, as its ClickException."""
    tmp, _ = plates
    run_port("compute_tf_fluor", tmp)
    args = argv("apply_inv_tf", tmp, "port")
    args[args.index("-t") + 1] = str(tmp / "port" / "compute_tf_fluor" / "out.zarr")
    args[args.index("-o") + 1] = str(tmp / "port" / "refused.zarr")
    capsys.readouterr()
    assert main(args, device="cpu") == 1
    err = capsys.readouterr().err
    want = CliRunner().invoke(reference_cli, args[:args.index("-o") + 1] + [
        str(tmp / "ref" / "refused.zarr"), "--cluster", "debug"])
    assert want.exit_code == 1
    assert err.strip() == want.output.strip().splitlines()[-1]
    assert "no phase transfer function" in err
