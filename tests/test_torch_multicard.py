"""biahub_tpu_torch's batch runner over several shards against biahub_tpu's
runner over several devices.

The port runs its verbs over ``Mesh.virtual("cpu", n)`` (n shards on the one
CPU device, each shard's kernel on its own rows of the batch); the reference
runs the same verbs through click's runner with its ``BatchRunner`` on
``get_mesh(n)``, n of the conftest's 8 virtual CPU devices. Plates: two
positions, T 3, C 2 (12 units), deconvolve on uint16 input, fuse with
per-timepoint matrices (flat-field, deconvolve, deskew, stabilize), deskew
with the overhang kept and filled. A budget of five units a batch makes
the batch plan round up (B a multiple of n, the last chunk padded).

For each verb and n:

- the batch sizes both runners chose are equal, and multiples of n;
- the plate is within the verb's tolerance of the reference's (1e-5 *
  max |ref|, as ``tests/test_torch_plate_verbs.py``), and bit-equal to the
  port's one-shard plate (the padding dropped, every unit where it
  belongs).

The runner alone: each shard's kernel gets its device's broadcast copy
(one copy a device), per-unit parameters split along B, a group of fewer
units than shards, ``--resume`` and the stats' shard count.
"""

import functools

import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner

from biahub_tpu.cli.main import cli as reference_cli
from biahub_tpu.parallel.mesh import get_mesh as reference_mesh
from biahub_tpu.runtime import executor as reference_executor
from biahub_tpu_torch import deconvolve as port_deconvolve
from biahub_tpu_torch import deskew as port_deskew
from biahub_tpu_torch import fuse as port_fuse
from biahub_tpu_torch.io.ngff import TransformationMeta, open_ome_zarr
from biahub_tpu_torch.io.progress import ProgressStore
from biahub_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    replicated_sharding,
)
from biahub_tpu_torch.runtime import executor as port_executor
from biahub_tpu_torch.runtime.executor import BatchRunner, WorkUnit

RTOL = 1e-5
SHAPE = (3, 2, 6, 10, 24)
SCALE = (1, 1, 1.0, 0.116, 0.116)
NAMES = ["GFP", "RFP"]
POSITIONS = ("A/1/0", "B/2/0")
N_UNITS = 2 * 3 * 2
SHARDS = (2, 3, 4)
FILL = {"pixel_size_um": 0.116, "ls_angle_deg": 36.17, "px_to_scan_ratio": 0.371,
        "keep_overhang": True, "overhang_fill": "mean", "average_n_slices": 3}
STAB = {"affine_transform_zyx_list": [
    [[1, 0, 0, 0], [0, 1, 0, 0.3 * t], [0, 0, 1, -0.4 * t], [0, 0, 0, 1]] for t in range(3)]}
SETTINGS = {
    "deconvolve": {"regularization_strength": 1e-3},
    "fuse": {"flat_field": {"channel_names": ["GFP"]},
             "deconvolve": {"regularization_strength": 1e-3}, "deskew": FILL,
             "stabilization": STAB},
    "deskew": FILL,
}


def psf() -> np.ndarray:
    zz, yy, xx = np.meshgrid(*[np.arange(s) - (s - 1) / 2 for s in (3, 5, 5)], indexing="ij")
    p = np.exp(-(zz ** 2 + yy ** 2 + xx ** 2) / 2).astype(np.float32)
    return p / p.sum()


def unit_bytes(verb: str) -> int:
    """One unit's bytes in the port's and the reference's batch plan (both
    runners count the same input, output and workspace)."""
    zyx = int(np.prod(SHAPE[2:]))
    if verb == "deconvolve":
        return zyx * (2 + 4) + 4 * zyx
    return 0


def spy_batch_sizes(monkeypatch, cls, record: list) -> None:
    original = cls._batch_size

    def spy(self, *args, **kwargs):
        b = original(self, *args, **kwargs)
        record.append((self.n_devices, b))
        return b

    monkeypatch.setattr(cls, "_batch_size", spy)


def argv(verb: str, tmp, out) -> list[str]:
    args = [verb, "-i", *[str(tmp / "in.zarr" / p) for p in POSITIONS], "-c",
            str(tmp / f"{verb}.yml"), "-o", str(out)]
    if verb in ("deconvolve", "fuse"):
        args += ["-p", str(tmp / "psf.zarr")]
    return args + (["--cluster", "debug"] if verb != "deconvolve" else [])


@pytest.fixture(scope="module")
def plates(tmp_path_factory):
    """The input plates (uint16, written by the port), a budget of five
    deconvolve units, and the reference's plates and batch sizes of every
    verb and shard count."""
    tmp = tmp_path_factory.mktemp("multicard")
    data = np.random.default_rng(5).integers(1, 4000, (len(POSITIONS),) + SHAPE).astype(
        np.uint16)
    plate = open_ome_zarr(tmp / "in.zarr", layout="hcs", mode="w", channel_names=NAMES)
    for key, arr in zip(POSITIONS, data):
        plate.create_position(*key.split("/")).create_image(
            "0", arr, transform=[TransformationMeta(type="scale", scale=SCALE)])
    psf_plate = open_ome_zarr(tmp / "psf.zarr", layout="hcs", mode="w", channel_names=["PSF"])
    psf_plate.create_position("0", "0", "0").create_image(
        "0", psf()[None, None], transform=[TransformationMeta(type="scale", scale=SCALE)])
    for verb, settings in SETTINGS.items():
        (tmp / f"{verb}.yml").write_text(yaml.safe_dump(settings))
    budget = 5 * unit_bytes("deconvolve")
    sizes: dict = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BIAHUB_TPU_MAX_BATCH_BYTES", str(budget))
        for n in SHARDS:
            runner = functools.partial(reference_executor.BatchRunner, mesh=reference_mesh(n))
            for verb in SETTINGS:
                mp.setattr(f"biahub_tpu.{verb}.BatchRunner", runner)
                record: list = []
                with pytest.MonkeyPatch.context() as spy:
                    spy_batch_sizes(spy, reference_executor.BatchRunner, record)
                    res = CliRunner().invoke(reference_cli,
                                             argv(verb, tmp, tmp / "ref" / f"{verb}-{n}.zarr"))
                assert res.exit_code == 0, (verb, n, res.output, res.exception)
                sizes[verb, n] = record
    return tmp, budget, sizes


def run_port(verb: str, tmp, budget: int, n: int, monkeypatch, record: list):
    out = tmp / "port" / f"{verb}-{n}.zarr"
    monkeypatch.setenv("BIAHUB_TPU_MAX_BATCH_BYTES", str(budget))
    spy_batch_sizes(monkeypatch, port_executor.BatchRunner, record)
    positions = [tmp / "in.zarr" / p for p in POSITIONS]
    mesh = Mesh.virtual("cpu", n)
    torch.set_num_threads(1)
    if verb == "deconvolve":
        port_deconvolve.deconvolve(positions, tmp / "psf.zarr", tmp / "deconvolve.yml", out,
                                   monitor=False, device="cpu", mesh=mesh)
    elif verb == "fuse":
        port_fuse.fuse(positions, tmp / "fuse.yml", out, psf_dirpath=tmp / "psf.zarr",
                       cluster="debug", monitor=False, device="cpu", mesh=mesh)
    else:
        port_deskew.deskew(positions, tmp / "deskew.yml", out, cluster="debug", monitor=False,
                           device="cpu", mesh=mesh)
    return out


def read(root) -> np.ndarray:
    return np.stack([open_ome_zarr(root / p).data[...] for p in POSITIONS])


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("verb", list(SETTINGS))
def test_verb_over_shards_matches_the_reference_runner(plates, verb, n, monkeypatch):
    tmp, budget, sizes = plates
    record: list = []
    got = read(run_port(verb, tmp, budget, n, monkeypatch, record))
    want = read(tmp / "ref" / f"{verb}-{n}.zarr")
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()
    # The reference's batch plan: the same batch sizes, multiples of n.
    assert [b for _, b in record] == [b for _, b in sizes[verb, n]]
    assert record and all(nd == n and b % n == 0 for nd, b in record)
    # The shards change no bit: the one-shard plate, padding dropped.
    one = tmp / "port" / f"{verb}-1.zarr"
    if not one.exists():
        run_port(verb, tmp, budget, 1, monkeypatch, [])
    np.testing.assert_array_equal(got.view(np.int32), read(one).view(np.int32))


def test_deconvolve_batch_plan_pads_the_last_chunk(plates, monkeypatch):
    """Five units' budget over 4 shards: B 8, chunks of 8 and 4 units, the
    second padded to 8 with copies of its last unit, which nothing writes."""
    tmp, budget, sizes = plates
    assert [b for _, b in sizes["deconvolve", 4]] == [8]
    runner = BatchRunner(cluster="debug", max_batch_bytes=budget, mesh=Mesh.virtual("cpu", 4))
    assert runner._batch_size(SHAPE[2:], N_UNITS, 4 * int(np.prod(SHAPE[2:])),
                              in_itemsize=2) == 8


def _plate(tmp_path, name, shape, dtype=np.float32):
    plate = open_ome_zarr(tmp_path / name, layout="hcs", mode="w",
                          channel_names=[f"c{i}" for i in range(shape[1])])
    data = np.random.default_rng(0).random(shape).astype(dtype)
    pos = plate.create_position("A", "1", "0")
    pos.create_image("0", data)
    return pos, data


def _out(tmp_path, name, shape):
    plate = open_ome_zarr(tmp_path / name, layout="hcs", mode="w",
                          channel_names=[f"c{i}" for i in range(shape[1])])
    pos = plate.create_position("A", "1", "0")
    pos.create_zeros("0", shape, np.float32)
    return pos


@pytest.mark.parametrize("n", SHARDS)
def test_each_shard_gets_its_rows_params_and_broadcast_copy(tmp_path, n):
    shape = (5, 1, 2, 4, 6)
    in_pos, data = _plate(tmp_path, "in.zarr", shape)
    out_pos = _out(tmp_path, "out.zarr", shape)
    seen = []
    offset = np.full((2, 4, 6), 0.5, np.float32)

    def kernel(v, gain, offset):
        seen.append((len(v), tuple(gain.tolist()), offset.device, offset.data_ptr(), v.device))
        return v * torch.from_numpy(gain)[:, None, None, None] + offset

    runner = BatchRunner(cluster="debug", device="cpu", mesh=Mesh.virtual("cpu", n))
    units = [WorkUnit(0, t, 0, 0) for t in range(5)]
    assert runner.run_units(kernel, units, [in_pos], [out_pos],
                            per_unit_params=lambda u: {"gain": np.float32(u.t + 1)},
                            broadcast_params={"offset": offset}) == 5
    b = -(-5 // n)
    # One batch of 5 units padded to n * b: each shard b rows, the padding
    # the last unit's copies; one broadcast copy on the (one) device.
    assert [s[0] for s in seen] == [b] * n
    gains = [g for s in seen for g in s[1]]
    assert gains == [1.0, 2.0, 3.0, 4.0, 5.0] + [5.0] * (n * b - 5)
    assert all(s[2] == s[4] for s in seen) and len({s[3] for s in seen}) == 1
    want = data * np.arange(1, 6, dtype=np.float32)[:, None, None, None, None] + offset
    np.testing.assert_array_equal(out_pos.data[...], want)
    assert runner.last_stats["n_shards"] == n and runner.last_stats["n_units"] == 5


def test_fewer_units_than_shards(tmp_path):
    in_pos, data = _plate(tmp_path, "in.zarr", (1, 1, 2, 4, 6))
    out_pos = _out(tmp_path, "out.zarr", (1, 1, 2, 4, 6))
    sizes = []

    def kernel(v):
        sizes.append(len(v))
        return v + 1.0

    runner = BatchRunner(cluster="local", device="cpu", mesh=Mesh.virtual("cpu", 4))
    assert runner.run_zyx(kernel, [in_pos], [out_pos]) == 1
    assert sizes == [1, 1, 1, 1]
    np.testing.assert_array_equal(out_pos.data[...], data + 1.0)


def test_resume_skips_finished_units_over_shards(tmp_path):
    shape = (6, 1, 2, 4, 6)
    in_pos, data = _plate(tmp_path, "in.zarr", shape)
    out_pos = _out(tmp_path, "out.zarr", shape)
    ProgressStore(out_pos.path, "tok").mark_done(2, 0)
    ProgressStore(out_pos.path, "tok").mark_done(4, 0)
    runner = BatchRunner(cluster="local", device="cpu", mesh=Mesh.virtual("cpu", 3),
                         max_batch_bytes=2 * 2 * 4 * 6 * 4 * 2)
    assert runner.run_zyx(lambda v: v * 2.0, [in_pos], [out_pos], resume=True,
                          resume_token="tok") == 4
    got = out_pos.data[...]
    for t in range(6):
        want = np.zeros_like(data[t]) if t in (2, 4) else data[t] * 2.0
        np.testing.assert_array_equal(got[t], want)
    assert runner.run_zyx(lambda v: v * 2.0, [in_pos], [out_pos], resume=True,
                          resume_token="tok") == 0


def test_layouts():
    mesh = Mesh.virtual("cpu", 3)
    assert batch_sharding(mesh, 6) == [slice(0, 2), slice(2, 4), slice(4, 6)]
    with pytest.raises(ValueError, match="does not split"):
        batch_sharding(mesh, 5)
    copies = replicated_sharding(mesh, np.ones(3, np.float32))
    assert list(copies) == [torch.device("cpu")] and copies[torch.device("cpu")].sum() == 3
    assert mesh.unique_devices == (torch.device("cpu"),)
