"""The device mesh: the cards one volume or one batch is spread over.

Counterpart of ``biahub_tpu/parallel/mesh.py``. JAX's ``Mesh`` names a grid
of devices that ``shard_map`` partitions arrays over; PyTorch has no such
object, so :class:`Mesh` is a tuple of ``torch.device``s and one axis name,
and the sharded functions (:mod:`biahub_tpu_torch.parallel.sharded_fft`)
place one shard on each entry themselves. The reference's
``batch_sharding``, ``host_batch_sharding`` and ``replicated_sharding``
(``NamedSharding``s for its batch executor) and ``get_global_mesh`` (the
multi-process mesh) wait for the port's batch executor.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from biahub_tpu_torch.device import resolve_device

__all__ = ["Mesh", "get_mesh"]


@dataclass(frozen=True)
class Mesh:
    """``devices[i]`` holds shard i of the one mesh axis ``axis_name``.

    A device may appear more than once (:meth:`virtual`): its shards then
    run one after another on it, the counterpart of the reference tests'
    virtual CPU devices (``--xla_force_host_platform_device_count``)."""

    devices: tuple[torch.device, ...]
    axis_name: str = "batch"

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", tuple(resolve_device(d) for d in self.devices))

    @property
    def size(self) -> int:
        return len(self.devices)

    @classmethod
    def virtual(cls, device: str | torch.device, n: int) -> Mesh:
        """``n`` shards on the one ``device``; asked for by name, never put
        in place of cards that are missing."""
        if n < 1:
            raise ValueError(f"a mesh needs at least one shard, got {n}")
        return cls((resolve_device(device),) * n)


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
