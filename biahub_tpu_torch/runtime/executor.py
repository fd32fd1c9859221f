"""The batch runner: plate work units through a kernel in device batches.

Counterpart of ``biahub_tpu/runtime/executor.py``. The caller enumerates
(position, t, c) work units; the runner groups them by input volume shape
and dtype, sizes batches to the device budget, and runs each batch through
a plain torch callable on (b, ...) shards of it on the devices of a
:class:`~biahub_tpu_torch.parallel.mesh.Mesh` (default: every card of the
process, :func:`~biahub_tpu_torch.parallel.mesh.get_mesh`):

- **reads** run one batch ahead on the I/O threads, straight into pinned
  host buffers that are allocated once per shape group and reused;
- **shards**: a batch of B units (a multiple of the mesh size, as the
  reference's ``_batch_size`` rounds it) splits along B into one shard a
  mesh device (:func:`~biahub_tpu_torch.parallel.mesh.batch_sharding`); a
  short chunk is padded with copies of its last unit, as the reference
  pads it, and the padding is dropped after the fetch. Each shard is copied
  to its device, computed and copied back on its own stream (on one
  device: the device's current stream), with its own events and its own
  rows of the pinned buffers; one controller thread launches every shard,
  and the launches are asynchronous. ``broadcast_params`` are copied once
  to each device (:func:`~biahub_tpu_torch.parallel.mesh.
  replicated_sharding`) and a shard's kernel gets its device's copy;
- the copy to the card is ``non_blocking``; volumes go as the store keeps
  them and are cast to float32 there (uint16 -> float32 is exact, so the
  result is bit-equal to a host cast), unless the kernel takes the dtype
  itself (``kernel.native_ingest_dtypes``);
- results come back into pinned buffers, ``post_fetch`` is applied to each
  unit's host result, and the writes are asynchronous; ``_drain`` bounds
  the writes in flight to one batch and commits each unit's resume record
  as its write lands;
- in a run of several processes the units are striped before the resume
  filter (:func:`stripe_units`).

``cluster="debug"`` synchronizes after every batch; ``"local"`` (and
``"slurm"``, accepted and run locally) keeps one batch in flight while the
next one is read and dispatched. ``last_stats`` holds the wall-time split of
the last ``run_units``: time the host waited on reads and on writes, the
stream time of the host-to-device copies, of the kernel and of the
device-to-host copies (CUDA events, the slowest shard of each batch; host
clock on the CPU), the bytes, and the mesh's shard count (``n_shards``);
``total_stats`` sums them over the runner's runs.

Budget: ``BIAHUB_TPU_MAX_BATCH_BYTES`` (default 4 GiB), as the reference
reads it; a batch's budget covers all of its shards.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import traceback
import warnings
from collections.abc import Callable, Sequence
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import numpy as np
import torch

from biahub_tpu_torch.device import resolve_device
from biahub_tpu_torch.io.ngff import Position
from biahub_tpu_torch.io.progress import ProgressStore
from biahub_tpu_torch.parallel.distributed import process_count, process_index
from biahub_tpu_torch.parallel.mesh import Mesh, batch_sharding, get_mesh, replicated_sharding
from biahub_tpu_torch.runtime.profiling import batch_timer

__all__ = [
    "DEFAULT_MAX_BATCH_BYTES",
    "stripe_units",
    "resolve_cluster",
    "sbatch_to_overrides",
    "WorkUnit",
    "PositionJob",
    "RunCancelled",
    "BatchRunner",
]

# The device batch budget: input, output and workspace of one batch.
DEFAULT_MAX_BATCH_BYTES = 4 * 2**30

_STAT_KEYS = ("read_s", "h2d_s", "device_s", "d2h_s", "write_s", "wall_s", "bytes_read",
              "bytes_written", "n_units")


def stripe_units(units: Sequence, label: str = "units") -> list:
    """This process's share of a deterministically enumerated work list:
    ``units[rank::world]`` of the same caller-enumerated sequence on every
    process, so the shares are disjoint and cover the list."""
    units = list(units)
    n_proc = process_count()
    if n_proc <= 1:
        return units
    pidx = process_index()
    share = units[pidx::n_proc]
    print(f"multi-host: process {pidx + 1}/{n_proc} owns {len(share)}/{len(units)} {label}")
    return share


def resolve_cluster(cluster: str | None = None, local: bool = False) -> str:
    """The execution mode: ``debug`` under ``CI=true``; ``slurm`` is
    accepted with a warning and runs locally; the default is ``local``."""
    if os.environ.get("CI") == "true":
        return "debug"
    if cluster is not None:
        if cluster == "slurm":
            warnings.warn(
                "cluster='slurm' is accepted for compatibility but biahub-tpu "
                "runs on-device batches from a single controller; running locally.",
                stacklevel=2,
            )
            return "local"
        return cluster
    return "local"


def sbatch_to_overrides(filepath: str | Path) -> dict:
    """Parse '#SBATCH --key=value' / '#LOCAL --key=value' override lines
    (printed for compatibility; no scheduler reads them)."""
    overrides: dict[str, Any] = {}
    with open(filepath) as f:
        for line in f:
            for keyword in ("SBATCH", "LOCAL"):
                prefix = f"#{keyword} --"
                if line.startswith(prefix):
                    key, value = line[len(prefix):].strip().split("=", 1)
                    key = key.replace("-", "_").strip()
                    try:
                        parsed: Any = int(value.strip())
                    except ValueError:
                        parsed = value.strip()
                    overrides[("slurm_" + key) if keyword == "SBATCH" else key] = parsed
    return overrides


@dataclass(frozen=True)
class WorkUnit:
    """One ZYX (or CZYX) volume to process: a (position, t, c) coordinate.

    ``t_out`` lets verbs that select a subset of timepoints write them
    contiguously; None means t_out == t.
    """

    pos_idx: int
    t: int
    c_in: int | tuple[int, ...]
    c_out: int | tuple[int, ...]
    t_out: int | None = None

    @property
    def out_t(self) -> int:
        return self.t if self.t_out is None else self.t_out


@dataclass
class _Group:
    shape: tuple[int, ...]
    dtype: np.dtype
    units: list[WorkUnit] = field(default_factory=list)


class PositionJob:
    """One position's work units as a job: PENDING -> RUNNING ->
    COMPLETED / FAILED / CANCELLED. ``cancel()`` stops the whole run at the
    next batch boundary."""

    def __init__(self, name: str, n_units: int, cancel_event: threading.Event):
        self.name = name
        self.n_units = n_units
        self.n_done = 0
        self.state = "PENDING"
        self.error: str | None = None
        self._cancel_event = cancel_event

    def done(self) -> bool:
        return self.state in ("COMPLETED", "FAILED", "CANCELLED")

    def cancel(self) -> None:
        self._cancel_event.set()
        if not self.done():
            self.state = "CANCELLED"

    def _unit_done(self) -> None:
        self.n_done += 1
        if self.n_done >= self.n_units:
            self.state = "COMPLETED"

    def __repr__(self) -> str:
        return f"PositionJob({self.name}, {self.state}, {self.n_done}/{self.n_units})"


class RunCancelled(RuntimeError):
    """Raised when a monitored run is cancelled (ctrl-C, ``job.cancel()``)."""


class _Clock:
    """Stage times of one batch: CUDA events on the card, the host clock
    (everything synchronous) on the CPU."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.marks: list = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def wait(self) -> None:
        if self.cuda:
            self.marks[-1].synchronize()

    def spans_s(self) -> list[float]:
        """Seconds between consecutive marks (after :meth:`wait`)."""
        a, b = self.marks[:-1], self.marks[1:]
        if self.cuda:
            return [x.elapsed_time(y) / 1e3 for x, y in zip(a, b)]
        return [y - x for x, y in zip(a, b)]


def _on_shard(dev: torch.device, stream) -> contextlib.AbstractContextManager:
    """The shard's device and stream as the current ones (nothing on the
    CPU)."""
    if dev.type != "cuda":
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.cuda.device(dev))
    stack.enter_context(torch.cuda.stream(stream))
    return stack


@dataclass
class _Batch:
    """A batch between its dispatch and its flush."""

    units: list[WorkUnit]
    result: torch.Tensor       # host (pinned on the card) result, padding dropped
    clocks: list[_Clock]       # one a shard
    slot: int
    unit_bytes: int


class BatchRunner:
    """Runs a kernel on (B, ...) batches of plate work units, each batch
    split along B over the devices of a mesh.

    Parameters
    ----------
    cluster : 'debug' | 'local'
        'debug' synchronizes after every batch; 'local' pipelines reads,
        compute and writes.
    max_batch_bytes : int
        Device budget for one batch (input, output and workspace, all
        shards); default ``BIAHUB_TPU_MAX_BATCH_BYTES`` or 4 GiB.
    device : str or torch.device
        ``"cuda"`` (default; raises without a card): every card of the
        process (``get_mesh()``), or the one card an index names; ``"cpu"``:
        the CPU. Read only when ``mesh`` is None.
    mesh : Mesh, optional
        The devices the batch's leading axis is split over, the
        reference's ``mesh=`` (``Mesh.virtual(device, n)``: n shards on one
        device).
    """

    def __init__(self, cluster: str = "local", max_batch_bytes: int | None = None,
                 device: str | torch.device = "cuda", mesh: Mesh | None = None):
        self.cluster = cluster
        if max_batch_bytes is None:
            max_batch_bytes = int(os.environ.get("BIAHUB_TPU_MAX_BATCH_BYTES",
                                                 DEFAULT_MAX_BATCH_BYTES))
        self.max_batch_bytes = max_batch_bytes
        if mesh is None:
            dev = resolve_device(device)
            mesh = Mesh((dev,)) if dev.index is not None else get_mesh(device=dev)
        self.mesh = mesh
        self.device = mesh.devices[0]
        self.jobs: dict[int, PositionJob] = {}
        self._cancel = threading.Event()
        self._streams: list | None = None
        self.last_stats: dict | None = None
        self.total_stats = self._new_stats()

    @property
    def n_devices(self) -> int:
        return self.mesh.size

    @property
    def devices(self) -> tuple[torch.device, ...]:
        """The mesh's devices, each once: where a verb builds state that is
        not a tensor, it builds it once for each of these."""
        return self.mesh.unique_devices

    def _new_stats(self) -> dict:
        return dict.fromkeys(_STAT_KEYS, 0) | {"n_shards": self.mesh.size}

    # -- planning ------------------------------------------------------------

    def _batch_size(self, unit_shape: tuple[int, ...], n_units: int, out_bytes: int = 0,
                    workspace_bytes: int = 0, in_itemsize: int = 4) -> int:
        """Units per batch: the budget (halved unless ``debug``, since a
        dispatched batch and the next one coexist) over one unit's input
        (a non-float32 input costs its itemsize plus 4 bytes a voxel: the
        float32 copy lives beside it), output and workspace bytes, rounded
        up to a multiple of the mesh size (at most the units rounded up)."""
        in_bpv = in_itemsize + (4 if in_itemsize != 4 else 0)
        unit_bytes = int(np.prod(unit_shape)) * in_bpv + int(out_bytes) + int(workspace_bytes)
        budget = self.max_batch_bytes
        if self.cluster != "debug":
            budget //= 2
        by_mem = max(1, budget // max(unit_bytes, 1))
        b = int(min(n_units, by_mem))
        # A multiple of the shard count, so that every shard gets as many.
        nd = self.n_devices
        if b % nd:
            b = min(-(-b // nd) * nd, -(-n_units // nd) * nd)
        return max(b, 1)

    # -- execution -----------------------------------------------------------

    def run_units(
        self,
        kernel: Callable,
        units: Sequence[WorkUnit],
        input_positions: Sequence[Position],
        output_positions: Sequence[Position],
        out_dtype=None,
        resume: bool = False,
        resume_token: str = "",
        per_unit_params: Callable[[WorkUnit], dict[str, np.ndarray]] | None = None,
        monitor: bool = False,
        unit_workspace_bytes: int = 0,
        post_fetch: Callable[[np.ndarray], np.ndarray] | None = None,
        broadcast_params: dict | None = None,
    ) -> int:
        """Process work units; returns the number of units computed.

        ``kernel(volumes, **params, **broadcast)`` maps a (B, Z, Y, X) batch
        (c_in an int) or (B, C, Z, Y, X) batch (c_in a tuple) on the device
        to its (B, ...) results. ``per_unit_params(unit)`` gives a unit's
        parameters, passed stacked along B as numpy arrays;
        ``broadcast_params`` are shared by every unit and moved to the
        device once. ``unit_workspace_bytes`` declares the kernel's
        per-unit working set beyond its input and output (a deconvolution's
        spectrum, the multipass warp's frames), so batches fit the budget.
        ``post_fetch`` transforms each unit's host result before its write.

        ``monitor=True`` runs the batches on a worker thread while this
        thread renders the job table (``self.jobs``); ctrl-C cancels the
        run at the next batch boundary.
        """
        # Striping precedes the resume filter: filtering first would let a
        # process that sees another's fresh records take another stripe.
        units = stripe_units(units)
        all_units = units
        progress: dict[int, ProgressStore] = {}
        if resume:
            for u in units:
                if u.pos_idx not in progress:
                    progress[u.pos_idx] = ProgressStore(output_positions[u.pos_idx].path,
                                                        resume_token)
            remaining = [u for u in units
                         if not progress[u.pos_idx].is_done(u.out_t, _c_key(u.c_out))]
            skipped = len(units) - len(remaining)
            if skipped:
                print(f"Resume: skipping {skipped} finished units")
            units = remaining

        self._cancel = threading.Event()
        remaining_per_pos: dict[int, int] = {}
        for u in units:
            remaining_per_pos[u.pos_idx] = remaining_per_pos.get(u.pos_idx, 0) + 1
        self.jobs = {}
        for u in all_units:
            if u.pos_idx in self.jobs:
                continue
            n_rem = remaining_per_pos.get(u.pos_idx, 0)
            job = PositionJob(_position_name(output_positions[u.pos_idx]), n_rem, self._cancel)
            if n_rem == 0:
                job.state = "COMPLETED"
            self.jobs[u.pos_idx] = job

        self.last_stats = self._new_stats()
        if not units:
            return 0
        args = (kernel, units, input_positions, output_positions, out_dtype, resume, progress,
                per_unit_params, int(unit_workspace_bytes), post_fetch, broadcast_params)
        if not monitor:
            return self._execute(*args)

        from biahub_tpu_torch.cli.monitor import monitor_jobs

        result: dict[str, Any] = {}

        def work():
            try:
                result["n"] = self._execute(*args)
            except RunCancelled:
                result["n"] = 0
            except Exception as exc:  # surfaced through the table, re-raised below
                result["error"] = exc
                self._fail_jobs(traceback.format_exc())

        worker = threading.Thread(target=work, name="biahub-batch-runner")
        worker.start()
        try:
            monitor_jobs(list(self.jobs.values()), [j.name for j in self.jobs.values()],
                         poll_seconds=0.2)
        finally:
            if any(j.state == "CANCELLED" for j in self.jobs.values()):
                self._cancel.set()
            worker.join()
        if "error" in result:
            raise result["error"]
        return int(result.get("n", 0))

    def _fail_jobs(self, tb: str) -> None:
        """A failed run: the running jobs FAILED (or the first pending one,
        when none ran yet), the others CANCELLED."""
        failed_any = False
        for job in self.jobs.values():
            if job.state == "RUNNING":
                job.state, job.error, failed_any = "FAILED", tb, True
        for job in self.jobs.values():
            if not job.done():
                if not failed_any:
                    job.state, job.error, failed_any = "FAILED", tb, True
                else:
                    job.state = "CANCELLED"

    def _execute(self, kernel, units, input_positions, output_positions, out_dtype, resume,
                 progress, per_unit_params, unit_workspace_bytes, post_fetch,
                 broadcast_params) -> int:
        mesh = self.mesh
        n_shards = mesh.size
        pin = self.device.type == "cuda"
        # One copy of each broadcast array a device; a shard gets its device's.
        copies = {k: None if v is None else replicated_sharding(mesh, v)
                  for k, v in (broadcast_params or {}).items()}
        broadcast = {dev: {k: None if c is None else c[dev] for k, c in copies.items()}
                     for dev in mesh.unique_devices}
        # One device keeps its current stream; shards each take a stream of
        # their own (the runner's, so that the caching allocator reuses
        # their blocks run after run), which first waits for the broadcast
        # copies.
        if not pin:
            streams = [None] * n_shards
        elif n_shards == 1:
            streams = [torch.cuda.current_stream(self.device)]
        else:
            if self._streams is None:
                self._streams = [torch.cuda.Stream(dev) for dev in mesh.devices]
            streams = self._streams
            for st, dev in zip(streams, mesh.devices):
                st.wait_stream(torch.cuda.current_stream(dev))
        native = {np.dtype(d) for d in getattr(kernel, "native_ingest_dtypes", ())}
        groups: dict[tuple, _Group] = {}
        for u in units:
            shape = _unit_shape(input_positions[u.pos_idx], u)
            dtype = np.dtype(input_positions[u.pos_idx].data.dtype)
            groups.setdefault((shape, dtype), _Group(shape, dtype)).units.append(u)

        stats = self.last_stats
        wall_t0 = time.perf_counter()
        pending: list[tuple[Any, WorkUnit]] = []
        n_done = 0

        def flush(batch: _Batch, out_slots: list) -> None:
            nonlocal n_done, pending
            with batch_timer(f"batch of {len(batch.units)}", len(batch.units),
                             batch.unit_bytes):
                for clock in batch.clocks:
                    clock.wait()
            # The slowest shard's span of each stage.
            spans = [clock.spans_s() for clock in batch.clocks]
            for i, key in enumerate(("h2d_s", "device_s", "d2h_s")):
                stats[key] += max(sp[i] for sp in spans)
            host = batch.result.numpy()
            futures = []
            for i, u in enumerate(batch.units):
                out_arr = output_positions[u.pos_idx]["0"]
                data = host[i] if post_fetch is None else post_fetch(host[i])
                data = np.asarray(data, dtype=out_dtype or out_arr.dtype)
                future = out_arr.write_async((u.out_t, _c_index(u.c_out)), data)
                stats["bytes_written"] += data.nbytes
                futures.append(future)
                pending.append((future, u))
            # The pinned result buffer is reused once these writes land.
            out_slots[batch.slot] = futures
            n_done += len(batch.units)
            t0 = time.perf_counter()
            pending = self._drain(pending, progress, resume,
                                  keep=len(batch.units) if self.cluster != "debug" else 0)
            stats["write_s"] += time.perf_counter() - t0

        def wait_writes(futures) -> None:
            t0 = time.perf_counter()
            for f in futures:
                f.result()
            stats["write_s"] += time.perf_counter() - t0

        for group in groups.values():
            out_shape = _unit_shape(output_positions[group.units[0].pos_idx], group.units[0],
                                    out=True)
            out_bytes = 4 * int(np.prod(out_shape))
            B = self._batch_size(group.shape, len(group.units), out_bytes,
                                 unit_workspace_bytes, in_itemsize=group.dtype.itemsize)
            chunks = [group.units[i:i + B] for i in range(0, len(group.units), B)]
            in_bufs = [torch.empty((B,) + group.shape, dtype=_torch_dtype(group.dtype),
                                   pin_memory=pin) for _ in range(min(2, len(chunks)))]
            # Events a buffer: the shards' copies of it to their devices are done.
            in_free: list[list] = [[] for _ in in_bufs]
            # Results come back into two pinned buffers in turn; a buffer is
            # reused once the writes from it have landed (``out_slots``).
            out_bufs = [torch.empty((B,) + out_shape, dtype=torch.float32, pin_memory=pin)
                        for _ in range(min(2, len(chunks)))]
            out_slots: list = [[] for _ in out_bufs]
            unit_bytes = int(np.prod(group.shape)) * group.dtype.itemsize
            reads = _start_reads(chunks[0], input_positions, in_bufs[0])
            inflight: _Batch | None = None
            for ci, chunk in enumerate(chunks):
                if self._cancel.is_set():
                    if inflight is not None:
                        flush(inflight, out_slots)
                    self._drain(pending, progress, resume)
                    raise RunCancelled("batch run cancelled")
                for u in chunk:
                    job = self.jobs.get(u.pos_idx)
                    if job is not None and job.state == "PENDING":
                        job.state = "RUNNING"
                t0 = time.perf_counter()
                for f in reads:
                    f.result()
                stats["read_s"] += time.perf_counter() - t0
                stats["bytes_read"] += len(chunk) * unit_bytes
                slot = ci % len(in_bufs)
                # Several shards: every chunk padded to B (the reference's
                # :716-724), then to a multiple of the shard count, with
                # copies of the chunk's last unit.
                n_rows = len(chunk)
                if n_shards > 1:
                    n_rows = B if len(chunks) > 1 else -(-n_rows // n_shards) * n_shards
                    in_bufs[slot][len(chunk):n_rows] = in_bufs[slot][len(chunk) - 1]
                vols_host = in_bufs[slot][:n_rows]
                if ci + 1 < len(chunks):
                    nxt = (ci + 1) % len(in_bufs)
                    for ev in in_free[nxt]:
                        ev.synchronize()
                    reads = _start_reads(chunks[ci + 1], input_positions, in_bufs[nxt])

                params = {}
                if per_unit_params is not None:
                    per_unit = [per_unit_params(u) for u in chunk]
                    per_unit += per_unit[-1:] * (n_rows - len(chunk))
                    params = {k: np.stack([np.asarray(p[k]) for p in per_unit])
                              for k in per_unit[0]}
                out_slot = ci % len(out_bufs)
                wait_writes(out_slots[out_slot])
                clocks, in_free[slot] = [], []
                buf = out_bufs[out_slot]
                for s, rows in enumerate(batch_sharding(mesh, n_rows)):
                    dev = mesh.devices[s]
                    with _on_shard(dev, streams[s]):
                        clock = _Clock(dev)
                        clock.mark()
                        vols = vols_host[rows].to(dev, non_blocking=True)
                        if pin:
                            in_free[slot].append(torch.cuda.Event())
                            in_free[slot][-1].record()
                        clock.mark()
                        if group.dtype not in native:
                            vols = vols.to(torch.float32)
                        result = kernel(vols, **{k: v[rows] for k, v in params.items()},
                                        **broadcast[dev])
                        clock.mark()
                        if buf.shape[1:] != result.shape[1:] or buf.dtype != result.dtype:
                            if s:
                                raise ValueError(
                                    f"shard {s} returned {tuple(result.shape[1:])} "
                                    f"{result.dtype}, shard 0 {tuple(buf.shape[1:])} "
                                    f"{buf.dtype}")
                            buf = torch.empty((B,) + tuple(result.shape[1:]),
                                              dtype=result.dtype, pin_memory=pin)
                            out_bufs[out_slot] = buf
                        buf[rows].copy_(result, non_blocking=True)
                        clock.mark()
                        del vols, result
                    clocks.append(clock)
                batch = _Batch(chunk, buf[:len(chunk)], clocks, out_slot, unit_bytes)
                if inflight is not None:
                    flush(inflight, out_slots)
                inflight = batch
                if self.cluster == "debug":
                    flush(inflight, out_slots)
                    inflight = None
            if inflight is not None:
                flush(inflight, out_slots)
            for futures in out_slots:
                wait_writes(futures)

        t0 = time.perf_counter()
        self._drain(pending, progress, resume)
        stats["write_s"] += time.perf_counter() - t0
        stats["wall_s"] = time.perf_counter() - wall_t0
        stats["n_units"] = n_done
        for k in _STAT_KEYS:
            self.total_stats[k] += stats[k]
        return n_done

    def echo_stats(self) -> None:
        """Print ``total_stats`` as one ``RUN_STATS:{json}`` line."""
        print("RUN_STATS:" + json.dumps(self.total_stats))

    def _drain(self, pending, progress, resume, keep: int = 0):
        """Resolve pending writes oldest-first until ``keep`` remain,
        marking each unit's resume record only after its write landed."""
        n_drain = max(0, len(pending) - keep)
        for future, u in pending[:n_drain]:
            future.result()
            if resume and u.pos_idx in progress:
                progress[u.pos_idx].mark_done(u.out_t, _c_key(u.c_out))
            job = self.jobs.get(u.pos_idx)
            if job is not None:
                job._unit_done()
        return pending[n_drain:]

    # -- conveniences --------------------------------------------------------

    def run_zyx(self, kernel: Callable, input_positions: Sequence[Position],
                output_positions: Sequence[Position],
                channel_pairs: Sequence[tuple[int, int]] | None = None,
                time_indices: Sequence[int] | str = "all", **kwargs) -> int:
        """Run a ZYX kernel over every (t, c) unit of each position."""
        units = []
        for p_idx, in_pos in enumerate(input_positions):
            T, C = in_pos.data.shape[:2]
            ts = range(T) if time_indices == "all" else time_indices
            pairs = channel_pairs if channel_pairs is not None else [(c, c) for c in range(C)]
            for t_out, t in enumerate(ts):
                for c_in, c_out in pairs:
                    units.append(WorkUnit(p_idx, int(t), int(c_in), int(c_out), int(t_out)))
        return self.run_units(kernel, units, input_positions, output_positions, **kwargs)

    def copy_channels(self, input_positions: Sequence[Position],
                      output_positions: Sequence[Position],
                      channel_pairs: Sequence[tuple[int, int]],
                      time_indices: Sequence[int] | str = "all") -> None:
        """Host-side copy of untouched channels into the output plate,
        centre-cropped or zero-padded where the shapes differ; in a run of
        several processes striped by position."""
        futures = []
        pairs = list(zip(input_positions, output_positions))
        if process_count() > 1:
            pairs = pairs[process_index()::process_count()]
        for in_pos, out_pos in pairs:
            ts = range(in_pos.data.shape[0]) if time_indices == "all" else time_indices
            out_arr = out_pos["0"]
            out_zyx = out_arr.shape[2:]
            for t_out, t in enumerate(ts):
                for c_in, c_out in channel_pairs:
                    data = in_pos.data[int(t), int(c_in)]
                    if data.shape != tuple(out_zyx):
                        data = _match_shape(data, out_zyx)
                    futures.append(out_arr.write_async((int(t_out), int(c_out)),
                                                       data.astype(out_arr.dtype)))
        for f in futures:
            f.result()


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype)).dtype


def _position_name(position: Position) -> str:
    return "/".join(Path(str(position.path)).parts[-3:])


def _c_key(c_out) -> int:
    return c_out if isinstance(c_out, int) else c_out[0]


def _c_index(c_out):
    return c_out if isinstance(c_out, int) else list(c_out)


def _unit_shape(position: Position, unit: WorkUnit, out: bool = False) -> tuple[int, ...]:
    zyx = tuple(position.data.shape[2:])
    c = unit.c_out if out else unit.c_in
    return (len(c),) + zyx if isinstance(c, tuple) else zyx


def _start_reads(chunk: Sequence[WorkUnit], input_positions: Sequence[Position],
                 buf: torch.Tensor) -> list:
    """Start the reads of a batch into the rows of ``buf``."""
    host = buf.numpy()
    return [input_positions[u.pos_idx]["0"].read_into_async((u.t, _c_index(u.c_in)), host[i])
            for i, u in enumerate(chunk)]


def _match_shape(data: np.ndarray, target: Sequence[int]) -> np.ndarray:
    """Center-crop or zero-pad a ZYX array to the target shape."""
    out = np.zeros(tuple(target), dtype=data.dtype)
    src, dst = [], []
    for s, t in zip(data.shape, target):
        if s >= t:
            start = (s - t) // 2
            src.append(slice(start, start + t))
            dst.append(slice(0, t))
        else:
            start = (t - s) // 2
            src.append(slice(0, s))
            dst.append(slice(start, start + s))
    out[tuple(dst)] = data[tuple(src)]
    return out
