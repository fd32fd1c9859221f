"""The device mesh: the cards one volume or one batch is spread over, and the
layouts of a batch on them.

Counterpart of ``biahub_tpu/parallel/mesh.py``. JAX's ``Mesh`` names a grid
of devices that ``shard_map`` and ``NamedSharding`` partition arrays over;
PyTorch has no such object, so :class:`Mesh` is a tuple of
``torch.device``s and one axis name, and the layouts are plain functions
on it:

- :func:`batch_sharding` (``PartitionSpec("batch")``): the rows of a batch's
  leading axis each shard holds;
- :func:`replicated_sharding` (``PartitionSpec()``): one copy of a tensor on
  each device of the mesh;
- :func:`get_global_mesh` (the ``("host", "batch")`` mesh): the
  (process, local shards) grid of a started process group, and
  :func:`host_batch_sharding` (``PartitionSpec(("host", "batch"))``): the
  rows of a global batch, host-major, that this process's shards hold.

The batch runner (:mod:`biahub_tpu_torch.runtime.executor`) splits its
batches with these; the sharded FFT (:mod:`biahub_tpu_torch.parallel.
sharded_fft`) spreads one volume over a :class:`Mesh` or a
:class:`GlobalMesh`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from biahub_tpu_torch.device import resolve_device
from biahub_tpu_torch.parallel.distributed import process_count, process_index

__all__ = [
    "GlobalMesh",
    "Mesh",
    "batch_sharding",
    "get_global_mesh",
    "get_mesh",
    "host_batch_sharding",
    "replicated_sharding",
]


def _indexed(device: str | torch.device) -> torch.device:
    """``device`` resolved, a card named without its index as the current
    one, so that it compares equal to a tensor's ``.device``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(frozen=True)
class Mesh:
    """``devices[i]`` holds shard i of the one mesh axis ``axis_name``.

    A device may appear more than once (:meth:`virtual`): its shards then
    share it, the counterpart of the reference tests' virtual CPU devices
    (``--xla_force_host_platform_device_count``)."""

    devices: tuple[torch.device, ...]
    axis_name: str = "batch"

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", tuple(_indexed(d) for d in self.devices))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def unique_devices(self) -> tuple[torch.device, ...]:
        """The mesh's devices, each once, in the order they first appear."""
        return tuple(dict.fromkeys(self.devices))

    @classmethod
    def virtual(cls, device: str | torch.device, n: int) -> Mesh:
        """``n`` shards on the one ``device``; asked for by name, never put
        in place of cards that are missing."""
        if n < 1:
            raise ValueError(f"a mesh needs at least one shard, got {n}")
        return cls((_indexed(device),) * n)


def get_mesh(n_devices: int | None = None, device: str | torch.device = "cuda") -> Mesh:
    """A mesh over this process's first ``n_devices`` cards (default: all of
    them); raises without a card. ``device="cpu"`` gives the host's one CPU
    device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devices = [dev]
    if n_devices is not None:
        if not 1 <= n_devices <= len(devices):
            raise ValueError(f"asked for {n_devices} devices of type {dev.type}, "
                             f"this process has {len(devices)}")
        devices = devices[:n_devices]
    return Mesh(tuple(devices))


def batch_sharding(mesh: Mesh, n: int) -> list[slice]:
    """The rows of a batch of ``n`` that each shard of ``mesh`` holds, in
    mesh order: ``n / mesh.size`` contiguous rows each (``n`` a multiple of
    the mesh size, as the reference's ``NamedSharding`` requires)."""
    if n % mesh.size:
        raise ValueError(f"a batch of {n} does not split over {mesh.size} shards")
    b = n // mesh.size
    return [slice(i * b, (i + 1) * b) for i in range(mesh.size)]


def replicated_sharding(mesh: Mesh, value) -> dict[torch.device, torch.Tensor]:
    """One copy of ``value`` (numpy array, tensor or scalar) on each device
    of ``mesh``, keyed by device; shards that share a device share its
    copy."""
    t = torch.as_tensor(value)
    return {dev: t.to(dev) for dev in mesh.unique_devices}


@dataclass(frozen=True)
class GlobalMesh:
    """The ``("host", "batch")`` grid of a run of several processes: row p
    holds process p's ``local.size`` shards, and this process is row
    ``process_index``. Shard (p, i) is global shard ``p * local.size + i``;
    every process has the same number of local shards. ``processes == 1``
    is one process's own mesh."""

    processes: int
    process_index: int
    local: Mesh

    axis_names = ("host", "batch")

    @property
    def shape(self) -> tuple[int, int]:
        return (self.processes, self.local.size)

    @property
    def size(self) -> int:
        return self.processes * self.local.size

    @property
    def first_shard(self) -> int:
        """The global index of this process's first shard."""
        return self.process_index * self.local.size


def get_global_mesh(local: Mesh | None = None) -> GlobalMesh:
    """This process's place in the started process group (one process when
    none is started) over its ``local`` mesh (default :func:`get_mesh`:
    every card of the process)."""
    return GlobalMesh(process_count(), process_index(),
                      local if local is not None else get_mesh())


def host_batch_sharding(mesh: GlobalMesh, n: int) -> list[slice]:
    """The rows of a global batch of ``n`` that this process's shards hold,
    host-major: shard (p, i) holds block ``p * local.size + i`` of
    ``mesh.size`` equal blocks."""
    if n % mesh.size:
        raise ValueError(f"a batch of {n} does not split over {mesh.size} shards")
    b = n // mesh.size
    return [slice((mesh.first_shard + i) * b, (mesh.first_shard + i + 1) * b)
            for i in range(mesh.local.size)]
