"""One process of tests/test_torch_multiprocess.py (not collected by pytest).

Imports torch and biahub_tpu_torch only. Invoked as
``worker.py <mode> <rank> <nproc> <port> <tmpdir>``; with ``nproc > 1`` it
starts a gloo group on ``tcp://localhost:<port>`` first. Modes:

- ``fft``: the process-group sharded FFT over a global mesh of ``nproc``
  processes x 2 virtual CPU shards, on this rank's rows of
  ``<tmpdir>/volume.npy`` with ``<tmpdir>/tf_half.npy``; writes its slabs to
  ``<tmpdir>/fft-<rank>.npy`` and checks them bit-equal to the unsharded
  route. A card tensor on the gloo group raises, naming the backend.
- ``mean``: the cross-process mean of ``tests/multihost_worker.py`` over the
  global ``("host", "batch")`` mesh of 4 virtual shards a process.
- ``runner``: the batch runner over ``Mesh.virtual("cpu", 2)`` (or one shard
  when ``nproc == 1``), its units striped over the processes, writing
  ``<tmpdir>/out-<nproc>proc.zarr`` from ``<tmpdir>/in.zarr``.

Prints ``WORKER-OK <mode> <rank>`` at the end.
"""

import sys
import types
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from biahub_tpu_torch.parallel import distributed  # noqa: E402
from biahub_tpu_torch.parallel.mesh import (  # noqa: E402
    Mesh,
    get_global_mesh,
    host_batch_sharding,
)

REG = 1e-3


def fft(rank: int, nproc: int, tmp: Path) -> None:
    from biahub_tpu_torch.kernels.deconvolve import deconvolve_zyx
    from biahub_tpu_torch.parallel.sharded_fft import deconvolve_zyx_sharded, gather

    vol = np.load(tmp / "volume.npy")
    tf_half = np.load(tmp / "tf_half.npy")
    mesh = get_global_mesh(Mesh.virtual("cpu", 2))
    assert mesh.shape == (nproc, 2) and mesh.first_shard == 2 * rank
    rows = vol.shape[0] // nproc
    mine = vol[rank * rows:(rank + 1) * rows]
    slabs = deconvolve_zyx_sharded(mine, tf_half, mesh, REG)
    assert [tuple(s.shape) for s in slabs] == [(rows // 2,) + vol.shape[1:]] * 2
    got = gather(slabs, "cpu")
    np.save(tmp / f"fft-{rank}.npy", got.numpy())
    whole = deconvolve_zyx(vol, tf_half, REG, device="cpu")
    assert torch.equal(got.view(torch.int32),
                       whole[rank * rows:(rank + 1) * rows].contiguous().view(torch.int32))
    card = types.SimpleNamespace(device=torch.device("cuda", 0))
    try:
        distributed.all_to_all(card, card)
    except RuntimeError as exc:
        assert "cuda tensor on a gloo group" in str(exc), exc
    else:
        raise AssertionError("a card tensor on a gloo group did not raise")


def mean(rank: int, nproc: int) -> None:
    mesh = get_global_mesh(Mesh.virtual("cpu", 4))
    assert mesh.axis_names == ("host", "batch") and mesh.shape == (nproc, 4)
    full = np.random.default_rng(0).random((8 * nproc, 4, 8), np.float32)
    total = torch.zeros((), dtype=torch.float64)
    for rows in host_batch_sharding(mesh, full.shape[0]):
        total += (torch.from_numpy(full[rows]) * 2.0 + 1.0).to(torch.float64).sum()
    distributed.all_reduce(total)
    got = float(total) / full.size
    want = float(np.mean(full * 2.0 + 1.0))
    assert abs(got - want) < 1e-6, (got, want)


def runner(rank: int, nproc: int, tmp: Path) -> None:
    from biahub_tpu_torch.io.ngff import create_empty_plate, open_ome_zarr
    from biahub_tpu_torch.kernels.chain import deconvolve_then_deskew_batched
    from biahub_tpu_torch.kernels.deconvolve import compute_transfer_function
    from biahub_tpu_torch.kernels.deskew import get_deskewed_data_shape
    from biahub_tpu_torch.runtime.executor import BatchRunner, WorkUnit

    shape = (8, 16, 32)
    ls_angle, px_to_scan = 30.0, 0.5
    dshape, _ = get_deskewed_data_shape(shape, ls_angle, px_to_scan, False)
    wells = [("A", "1"), ("B", "1")]
    out_path = tmp / f"out-{nproc}proc.zarr"
    create_empty_plate(out_path, position_keys=[(r, c, "0") for r, c in wells],
                       channel_names=["raw"], shape=(3, 1) + tuple(dshape))
    psf = np.zeros((3, 3, 3), np.float32)
    psf[1, 1, 1] = 0.5
    psf[0, 1, 1] = psf[2, 1, 1] = 0.25
    tf_half = compute_transfer_function(psf, shape)[..., : shape[-1] // 2 + 1]

    def kernel(vols, tf_half):
        return deconvolve_then_deskew_batched(vols, tf_half, REG, ls_angle, px_to_scan,
                                              skip_flip=True, device=vols.device)

    in_pos = [open_ome_zarr(tmp / "in.zarr" / r / c / "0") for r, c in wells]
    out_pos = [open_ome_zarr(out_path / r / c / "0", mode="r+") for r, c in wells]
    mesh = Mesh.virtual("cpu", 2 if nproc > 1 else 1)
    batch_runner = BatchRunner(cluster="local", max_batch_bytes=3 * 4 * 3 * 8 * 16 * 32,
                               mesh=mesh)
    units = [WorkUnit(p, t, 0, 0) for p in range(len(wells)) for t in range(3)]
    n = batch_runner.run_units(kernel, units, in_pos, out_pos, resume=True,
                               resume_token="dryrun", post_fetch=lambda a: a[:, ::-1],
                               broadcast_params={"tf_half": tf_half})
    assert n == len(units) // nproc, (n, nproc)
    assert batch_runner.last_stats["n_shards"] == mesh.size
    distributed.barrier("runner-writes-done")


def main() -> None:
    mode, rank, nproc, port, tmp = sys.argv[1:6]
    rank, nproc, tmp = int(rank), int(nproc), Path(tmp)
    torch.set_num_threads(1)
    if nproc > 1:
        assert distributed.maybe_initialize_distributed(f"tcp://localhost:{port}", nproc, rank)
        assert distributed.process_count() == nproc
    if mode == "fft":
        fft(rank, nproc, tmp)
    elif mode == "mean":
        mean(rank, nproc)
    else:
        runner(rank, nproc, tmp)
    print(f"WORKER-OK {mode} {rank}", flush=True)


if __name__ == "__main__":
    main()
