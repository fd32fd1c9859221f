"""biahub_tpu_torch across processes: the process-group sharded FFT, the
cross-process mean and the striped batch runner, each as two processes on
gloo over the CPU (``tests/torch_multiprocess_worker.py``, torch and the
port only).

Every spawned process has a limit (``communicate(timeout=LIMIT_S)``) and is
killed past it; a failed group is retried once on a fresh port, as
``tests/test_multihost.py`` does. The sharded FFT (2 processes x 2 virtual
shards) is held within 1e-5 * max |ref| of the reference's
``deconvolve_zyx_sharded`` over 4 virtual devices in this process (with
full float32 DFT precision, ``BIAHUB_TPU_FFT_PRECISION=highest``), and
each rank's slabs bit-equal to the port's unsharded route; the runner
striped over 2 processes x 2 shards writes the plate of 1 process x 1
shard bit for bit, as the reference's dry run checks its own.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from biahub_tpu.kernels.deconvolve import compute_transfer_function as jax_tf
from biahub_tpu.parallel import sharded_fft as jsf
from biahub_tpu_torch.io.ngff import open_ome_zarr
from biahub_tpu_torch.parallel import distributed

WORKER = Path(__file__).parent / "torch_multiprocess_worker.py"
LIMIT_S = 120
RTOL = 1e-5
REG = 1e-3


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_group(mode: str, nproc: int, tmp: Path) -> list[str]:
    """Each rank's output; one retry on a fresh port when a rank fails."""
    for attempt in range(2):
        port = free_port()
        env = dict(os.environ, OMP_NUM_THREADS="1")
        for name in ("BIAHUB_TPU_COORDINATOR", "BIAHUB_TPU_DISTRIBUTED"):
            env.pop(name, None)
        procs = [subprocess.Popen(
            [sys.executable, str(WORKER), mode, str(rank), str(nproc), str(port), str(tmp)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for rank in range(nproc)]
        outputs = []
        for p in procs:
            try:
                outputs.append(p.communicate(timeout=LIMIT_S)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outputs.append(p.communicate()[0] + "\n<timed out>")
        if all(p.returncode == 0 for p in procs) or attempt == 1:
            break
    for rank, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"{mode} rank {rank} failed:\n{out}"
        assert f"WORKER-OK {mode} {rank}" in out, out
    return outputs


def psf3() -> np.ndarray:
    return np.exp(-np.sum(np.square(np.mgrid[-1:2, -1:2, -1:2] / 1.2), axis=0)).astype(
        np.float32)


@pytest.mark.parametrize("shape", [(16, 16, 32), (8, 24, 20)], ids=["16x16x32", "y24-x20"])
def test_process_group_sharded_fft_matches_the_reference(tmp_path, shape, monkeypatch):
    monkeypatch.setenv("BIAHUB_TPU_FFT_PRECISION", "highest")
    vol = np.random.default_rng(13).standard_normal(shape, dtype=np.float32)
    tf = jax_tf(psf3(), shape)[..., : shape[-1] // 2 + 1]
    np.save(tmp_path / "volume.npy", vol)
    np.save(tmp_path / "tf_half.npy", np.asarray(tf, np.float32))
    run_group("fft", 2, tmp_path)
    got = np.concatenate([np.load(tmp_path / f"fft-{rank}.npy") for rank in range(2)])
    mesh = JaxMesh(np.asarray(jax.devices()[:4]), ("space",))
    want = np.asarray(jsf.deconvolve_zyx_sharded(jnp.asarray(vol), jnp.asarray(tf), mesh,
                                                 regularization_strength=REG))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()


def test_cross_process_mean(tmp_path):
    run_group("mean", 2, tmp_path)


def test_runner_striped_over_processes_and_shards_equals_one_process(tmp_path):
    wells = [("A", "1"), ("B", "1")]
    plate = open_ome_zarr(tmp_path / "in.zarr", layout="hcs", mode="w", channel_names=["raw"])
    rng = np.random.default_rng(3)
    for r, c in wells:
        plate.create_position(r, c, "0").create_image(
            "0", rng.random((3, 1, 8, 16, 32)).astype(np.float32))
    outputs = run_group("runner", 2, tmp_path)
    assert any("process 1/2 owns 3/6 units" in o for o in outputs)
    run_group("runner", 1, tmp_path)
    for r, c in wells:
        one = open_ome_zarr(tmp_path / "out-1proc.zarr" / r / c / "0").data[...]
        two = open_ome_zarr(tmp_path / "out-2proc.zarr" / r / c / "0").data[...]
        np.testing.assert_array_equal(two.view(np.int32), one.view(np.int32))
        assert np.isfinite(one).all() and one.std() > 0


def test_collectives_refuse_a_device_their_backend_does_not_carry(tmp_path):
    """In one process, a group of one on gloo: a CPU tensor goes through,
    a card tensor raises naming the backend."""
    store = torch.distributed.FileStore(str(tmp_path / "store"), 1)
    torch.distributed.init_process_group("gloo", store=store, world_size=1, rank=0)
    try:
        t = torch.arange(4.0)
        assert distributed.all_reduce(t).tolist() == [0.0, 1.0, 2.0, 3.0]
        out = torch.empty(2, 3, dtype=torch.complex64)
        src = torch.randn(2, 3, dtype=torch.complex64)
        assert torch.equal(distributed.all_to_all(out, src), src)

        class Card:
            device = torch.device("cuda", 0)

        with pytest.raises(RuntimeError, match="a cuda tensor on a gloo group"):
            distributed.all_reduce(Card())
    finally:
        torch.distributed.destroy_process_group()
    with pytest.raises(RuntimeError, match="no process group"):
        distributed.all_reduce(torch.zeros(1))
