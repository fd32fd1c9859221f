"""biahub_tpu_torch's batch runner, after biahub_tpu's tests/test_runtime.py.

Plates are written and read with the port's store; kernels are torch
callables on (B, ...) batches on the CPU. Batch sizing is held against the
reference runner's ``_batch_size`` on one device.
"""

import threading

import numpy as np
import pytest
import torch

from biahub_tpu.parallel.mesh import get_mesh
from biahub_tpu.runtime.executor import BatchRunner as ReferenceRunner
from biahub_tpu_torch.io.ngff import open_ome_zarr
from biahub_tpu_torch.io.progress import ProgressStore
from biahub_tpu_torch.runtime.executor import (
    BatchRunner,
    PositionJob,
    WorkUnit,
    resolve_cluster,
    sbatch_to_overrides,
)


def _plate(tmp_path, name, shape=(3, 2, 4, 8, 16), channels=("a", "b"), dtype=np.float32):
    plate = open_ome_zarr(tmp_path / name, layout="hcs", mode="w", channel_names=list(channels))
    rng = np.random.default_rng(0)
    data = (rng.random(shape) if dtype == np.float32
            else rng.integers(0, 65535, size=shape)).astype(dtype)
    plate.create_position("A", "1", "0").create_image("0", data)
    return open_ome_zarr(tmp_path / name)["A/1/0"]


def _out(tmp_path, name, shape, channels=("a", "b")):
    plate = open_ome_zarr(tmp_path / name, layout="hcs", mode="w", channel_names=list(channels))
    pos = plate.create_position("A", "1", "0")
    pos.create_zeros("0", shape, np.float32)
    return pos


def runner(**kw):
    return BatchRunner(device="cpu", **kw)


def test_run_zyx_all_units(tmp_path):
    in_pos = _plate(tmp_path, "in.zarr")
    out_pos = _out(tmp_path, "out.zarr", (3, 2, 4, 8, 16))
    n = runner(cluster="debug").run_zyx(lambda v: v * 2.0, [in_pos], [out_pos])
    assert n == 6
    np.testing.assert_array_equal(out_pos.data[...], in_pos.data[...] * 2.0)


def test_run_units_per_unit_params(tmp_path):
    in_pos = _plate(tmp_path, "in.zarr", shape=(4, 1, 2, 8, 16), channels=("a",))
    out_pos = _out(tmp_path, "o.zarr", (4, 1, 2, 8, 16), ("a",))
    gains = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    seen = []

    def kernel(v, gain):
        seen.append(gain.shape)
        return v * torch.from_numpy(gain)[:, None, None, None]

    units = [WorkUnit(0, t, 0, 0) for t in range(4)]
    runner(cluster="debug").run_units(kernel, units, [in_pos], [out_pos],
                                      per_unit_params=lambda u: {"gain": gains[u.t]})
    assert seen == [(4,)]  # one batch, the parameters stacked along it
    for t in range(4):
        np.testing.assert_array_equal(out_pos.data[t, 0], in_pos.data[t, 0] * gains[t])


def test_broadcast_params_reach_the_kernel_once(tmp_path):
    in_pos = _plate(tmp_path, "in.zarr")
    out_pos = _out(tmp_path, "o.zarr", (3, 2, 4, 8, 16))
    offset = np.float32(0.5) * np.ones((4, 8, 16), np.float32)
    r = runner(cluster="local", max_batch_bytes=4 * 2 * 4 * 8 * 16 * 4)
    n = r.run_zyx(lambda v, offset: v + offset, [in_pos], [out_pos],
                  broadcast_params={"offset": offset})
    assert n == 6
    np.testing.assert_array_equal(out_pos.data[...], in_pos.data[...] + offset)


def test_resume_skips_done_units(tmp_path):
    in_pos = _plate(tmp_path, "in.zarr", shape=(3, 1, 2, 8, 16), channels=("a",))
    out_pos = _out(tmp_path, "o.zarr", (3, 1, 2, 8, 16), ("a",))
    ProgressStore(out_pos.path, "tok").mark_done(1, 0)
    r = runner(cluster="debug")
    n = r.run_zyx(lambda v: v * 10.0, [in_pos], [out_pos], resume=True, resume_token="tok")
    assert n == 2
    assert np.all(out_pos.data[1, 0] == 0)
    np.testing.assert_array_equal(out_pos.data[0, 0], in_pos.data[0, 0] * 10)
    # A different token invalidates the records.
    assert r.run_zyx(lambda v: v * 10.0, [in_pos], [out_pos], resume=True,
                     resume_token="tok2") == 3


def test_czyx_units(tmp_path):
    in_pos = _plate(tmp_path, "in.zarr", shape=(2, 2, 2, 8, 16))
    out_pos = _out(tmp_path, "o.zarr", (2, 1, 2, 8, 16), ("s",))
    units = [WorkUnit(0, t, (0, 1), (0,)) for t in range(2)]
    runner(cluster="debug").run_units(lambda czyx: czyx.sum(dim=1, keepdim=True), units,
                                      [in_pos], [out_pos])
    np.testing.assert_allclose(out_pos.data[0, 0], in_pos.data[0].sum(axis=0), rtol=1e-6)


def test_uint16_ingest_is_bit_equal_to_a_host_cast(tmp_path):
    raw = _plate(tmp_path, "u16.zarr", dtype=np.uint16)
    f32_plate = open_ome_zarr(tmp_path / "f32.zarr", layout="hcs", mode="w",
                              channel_names=["a", "b"])
    f32_plate.create_position("A", "1", "0").create_image("0", raw.data[...].astype(np.float32))
    seen, outs = {}, {}
    for name in ("u16.zarr", "f32.zarr"):
        out_pos = _out(tmp_path, f"out-{name}", (3, 2, 4, 8, 16))

        def kernel(v):
            seen[name] = v.dtype
            return torch.sqrt(v) * 0.5 + 1.0

        r = runner(cluster="debug")
        assert r.run_zyx(kernel, [open_ome_zarr(tmp_path / name / "A/1/0")], [out_pos]) == 6
        assert r.last_stats["n_units"] == 6
        assert r.last_stats["bytes_read"] == 6 * 4 * 8 * 16 * (2 if name == "u16.zarr" else 4)
        outs[name] = out_pos.data[...]
    assert seen == {"u16.zarr": torch.float32, "f32.zarr": torch.float32}
    np.testing.assert_array_equal(outs["u16.zarr"], outs["f32.zarr"])


def test_native_ingest_kernel_takes_the_stored_dtype(tmp_path):
    in_pos = _plate(tmp_path, "in.zarr", shape=(2, 1, 4, 8, 16), channels=("a",),
                    dtype=np.uint16)
    seen = {}

    def native(v):
        seen["dtype"] = v.dtype
        return torch.sqrt(v.to(torch.float32)) * 0.5

    native.native_ingest_dtypes = ("uint16",)
    outs = {}
    for name, kern in (("native", native), ("cast", lambda v: torch.sqrt(v) * 0.5)):
        out_pos = _out(tmp_path, f"out-{name}.zarr", (2, 1, 4, 8, 16), ("a",))
        assert runner(cluster="debug").run_zyx(kern, [in_pos], [out_pos]) == 2
        outs[name] = out_pos.data[...]
    assert seen["dtype"] == torch.uint16
    np.testing.assert_array_equal(outs["native"], outs["cast"])


def test_post_fetch_applies_to_the_host_result(tmp_path):
    in_pos = _plate(tmp_path, "in.zarr")
    out_pos = _out(tmp_path, "out.zarr", (3, 2, 4, 8, 16))
    runner(cluster="local").run_zyx(lambda v: v + 1.0, [in_pos], [out_pos],
                                    post_fetch=lambda a: a[:, ::-1])
    np.testing.assert_array_equal(out_pos.data[...], (in_pos.data[...] + 1.0)[:, :, :, ::-1])


@pytest.mark.parametrize("cluster,in_itemsize,out_bytes,workspace", [
    ("debug", 4, 0, 0), ("local", 4, 16 * 64 * 64 * 4 * 16, 0), ("local", 2, 0, 3 << 20),
    ("debug", 2, 16 * 64 * 64 * 4, 1 << 20)])
def test_batch_size_equals_the_reference_on_one_device(cluster, in_itemsize, out_bytes,
                                                       workspace):
    budget = 10 * 2**20
    ref = ReferenceRunner(cluster=cluster, max_batch_bytes=budget, mesh=get_mesh(1))
    port = runner(cluster=cluster, max_batch_bytes=budget)
    for n_units in (1, 3, 1000):
        args = ((16, 64, 64), n_units, out_bytes, workspace)
        assert port._batch_size(*args, in_itemsize=in_itemsize) == \
            ref._batch_size(*args, in_itemsize=in_itemsize)


def test_multiple_batches_in_both_modes_are_equal(tmp_path):
    """Several batches (a small budget): the pipelined mode, which keeps one
    batch in flight while the next is read and dispatched, writes what the
    synchronous mode writes."""
    in_pos = _plate(tmp_path, "in.zarr", shape=(6, 2, 4, 8, 16))
    outs = {}
    for mode in ("debug", "local"):
        out_pos = _out(tmp_path, f"out-{mode}.zarr", (6, 2, 4, 8, 16))
        r = runner(cluster=mode, max_batch_bytes=3 * 4 * 8 * 16 * 4 * 2)
        assert r.run_zyx(lambda v: torch.cumsum(v, dim=1), [in_pos], [out_pos]) == 12
        outs[mode] = out_pos.data[...]
        s = r.last_stats
        assert s["bytes_read"] == s["bytes_written"] == 12 * 4 * 8 * 16 * 4
        for key in ("read_s", "h2d_s", "device_s", "d2h_s", "write_s"):
            assert 0 <= s[key] <= s["wall_s"]
    np.testing.assert_array_equal(outs["debug"], outs["local"])
    np.testing.assert_allclose(outs["debug"], np.cumsum(in_pos.data[...], axis=2), rtol=1e-6)


def test_bounded_drain_commits_progress_mid_run(tmp_path):
    """A crash mid-run loses at most the batches in flight: the resume
    records of the batches flushed before it are already written."""
    T = 64
    in_pos = _plate(tmp_path, "in.zarr", shape=(T, 1, 2, 8, 16), channels=("a",))
    out_pos = _out(tmp_path, "o.zarr", (T, 1, 2, 8, 16), ("a",))
    unit_bytes = 2 * 8 * 16 * 4
    r = runner(cluster="local", max_batch_bytes=8 * 2048)
    B = r._batch_size((2, 8, 16), T, out_bytes=unit_bytes)
    assert B * 6 <= T
    calls = {"n": 0}

    def param_fn(u):
        calls["n"] += 1
        if calls["n"] > 4 * B:
            raise RuntimeError("simulated crash mid-run")
        return {"gain": np.float32(2.0)}

    kernel = lambda v, gain: v * torch.from_numpy(gain)[:, None, None, None]  # noqa: E731
    units = [WorkUnit(0, t, 0, 0) for t in range(T)]
    with pytest.raises(RuntimeError, match="simulated crash"):
        r.run_units(kernel, units, [in_pos], [out_pos], resume=True, resume_token="tok",
                    per_unit_params=param_fn)
    done = sum(ProgressStore(out_pos.path, "tok").is_done(t, 0) for t in range(T))
    assert B <= done < T
    n = runner(cluster="local", max_batch_bytes=8 * 2048).run_units(
        kernel, units, [in_pos], [out_pos], resume=True, resume_token="tok",
        per_unit_params=lambda u: {"gain": np.float32(2.0)})
    assert n == T - done
    np.testing.assert_array_equal(out_pos.data[...], in_pos.data[...] * 2.0)


def test_monitor_renders_the_job_table(tmp_path, capsys):
    in_pos = _plate(tmp_path, "in.zarr", shape=(3, 1, 2, 8, 16), channels=("a",))
    out_pos = _out(tmp_path, "o.zarr", (3, 1, 2, 8, 16), ("a",))
    r = runner(cluster="local")
    assert r.run_zyx(lambda v: v * 3.0, [in_pos], [out_pos], monitor=True) == 3
    assert all(j.state == "COMPLETED" for j in r.jobs.values())
    out = capsys.readouterr().out
    assert "A/1/0" in out and "COMPLETED" in out


def test_monitor_marks_failed_and_reraises(tmp_path, capsys):
    in_pos = _plate(tmp_path, "in.zarr", shape=(3, 1, 2, 8, 16), channels=("a",))
    out_pos = _out(tmp_path, "f.zarr", (3, 1, 2, 8, 16), ("a",))

    def param_fn(u):
        raise RuntimeError("boom-unit")

    r = runner(cluster="local")
    with pytest.raises(RuntimeError, match="boom-unit"):
        r.run_units(lambda v, gain: v, [WorkUnit(0, t, 0, 0) for t in range(3)], [in_pos],
                    [out_pos], per_unit_params=param_fn, monitor=True)
    assert "FAILED" in {j.state for j in r.jobs.values()}
    out = capsys.readouterr().out
    assert "FAILED" in out and "boom-unit" in out


def test_a_cancelled_job_stops_the_run(tmp_path):
    """cancel() on any job sets the run's event; the run stops at the next
    batch boundary with RunCancelled, its finished writes landed."""
    from biahub_tpu_torch.runtime.executor import RunCancelled

    ev = threading.Event()
    a, b = PositionJob("A/1/0", 4, ev), PositionJob("B/1/0", 4, ev)
    a.state = "RUNNING"
    b.cancel()
    assert ev.is_set() and b.state == "CANCELLED" and not a.done()

    in_pos = _plate(tmp_path, "in.zarr", shape=(8, 1, 2, 8, 16), channels=("a",))
    out_pos = _out(tmp_path, "o.zarr", (8, 1, 2, 8, 16), ("a",))
    r = runner(cluster="debug", max_batch_bytes=2 * 2048)
    batches = []

    def kernel(v):
        batches.append(len(v))
        if len(batches) == 2:
            next(iter(r.jobs.values())).cancel()
        return v + 1.0

    with pytest.raises(RunCancelled):
        r.run_zyx(kernel, [in_pos], [out_pos])
    assert len(batches) == 2
    done = sum(batches)
    np.testing.assert_array_equal(out_pos.data[:done], in_pos.data[:done] + 1.0)
    assert not np.any(out_pos.data[done:])


def test_ragged_positions_in_two_shape_groups(tmp_path):
    rng = np.random.default_rng(7)
    in_plate = open_ome_zarr(tmp_path / "plate.zarr", layout="hcs", mode="w",
                             channel_names=["a", "b"])
    out_plate = open_ome_zarr(tmp_path / "out.zarr", layout="hcs", mode="w",
                              channel_names=["a", "b"])
    ins, outs, data = [], [], []
    for i in range(12):
        row, col = chr(ord("A") + i // 6), str(i % 6 + 1)
        shape = (2, 2, 4, 8, 16) if i % 3 else (2, 2, 6, 10, 12)
        arr = rng.random(shape).astype(np.float32)
        ins.append(in_plate.create_position(row, col, "0"))
        ins[-1].create_image("0", arr)
        outs.append(out_plate.create_position(row, col, "0"))
        outs[-1].create_zeros("0", shape, np.float32)
        data.append(arr)
    r = runner(cluster="local", max_batch_bytes=1 << 16)
    assert r.run_zyx(lambda v: v * 3.0 + 1.0, ins, outs) == 12 * 4
    for arr, out_pos in zip(data, outs):
        np.testing.assert_array_equal(out_pos.data[...], arr * 3.0 + 1.0)
    assert all(job.state == "COMPLETED" for job in r.jobs.values())


def test_copy_channels_crops_or_pads(tmp_path):
    in_pos = _plate(tmp_path, "in.zarr", shape=(2, 2, 4, 8, 16))
    out_pos = _out(tmp_path, "o.zarr", (2, 2, 6, 6, 16))
    runner(cluster="debug").copy_channels([in_pos], [out_pos], [(1, 0)])
    got = out_pos.data[:, 0]
    np.testing.assert_array_equal(got[:, 1:5], in_pos.data[:, 1, :, 1:7])
    assert not np.any(got[:, [0, 5]]) and not np.any(out_pos.data[:, 1])


def test_sbatch_overrides_and_cluster(tmp_path, monkeypatch):
    f = tmp_path / "sbatch.sh"
    f.write_text("#SBATCH --cpus-per-task=1\n#SBATCH --array-parallelism=2\n"
                 "#LOCAL --cpus-per-task=1\n#LOCAL --timeout-min=1\n")
    assert sbatch_to_overrides(f) == {"slurm_cpus_per_task": 1, "slurm_array_parallelism": 2,
                                      "cpus_per_task": 1, "timeout_min": 1}
    monkeypatch.setenv("CI", "false")
    with pytest.warns(UserWarning, match="slurm"):
        assert resolve_cluster("slurm") == "local"
    assert resolve_cluster("debug") == "debug" and resolve_cluster(None, True) == "local"
    monkeypatch.setenv("CI", "true")
    assert resolve_cluster("local") == "debug"


def test_the_device_is_the_card_unless_asked():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchRunner()
