"""Multi-process execution: the plate-scale counterpart of the Slurm array.

Counterpart of ``biahub_tpu/parallel/distributed.py`` on
``torch.distributed``. Every process runs the same verb and owns a
deterministic stripe of the (position, t, c) work units
(:func:`biahub_tpu_torch.runtime.executor.stripe_units`); processes share
nothing but the output store, and meet only at :func:`barrier`.

Launch with explicit coordinates, read from the same variables as the
reference::

    BIAHUB_TPU_COORDINATOR=tcp://host0:8476 \\
    BIAHUB_TPU_NUM_PROCESSES=4 \\
    BIAHUB_TPU_PROCESS_ID=$SLURM_PROCID  python ...

(``host:port`` without a scheme is read as ``tcp://host:port``), or set
``BIAHUB_TPU_DISTRIBUTED=auto`` under ``torchrun``, whose variables
``init_method="env://"`` reads. The backend is NCCL in a process that has a
card, gloo otherwise.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

__all__ = [
    "maybe_initialize_distributed",
    "process_index",
    "process_count",
    "is_coordinator",
    "barrier",
]


def _int_env(name: str) -> int | None:
    value = os.environ.get(name)
    return int(value) if value is not None else None


def _timeout_s() -> float:
    return float(os.environ.get("BIAHUB_TPU_BARRIER_TIMEOUT_S", "600"))


def maybe_initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Start the process group once, from arguments or the environment.

    Environment: ``BIAHUB_TPU_COORDINATOR`` (``tcp://host:port``),
    ``BIAHUB_TPU_NUM_PROCESSES``, ``BIAHUB_TPU_PROCESS_ID``; or
    ``BIAHUB_TPU_DISTRIBUTED=auto`` for ``env://``. A group that is already
    up (a test harness, an embedding application, an earlier call) is
    adopted. The group's timeout is ``BIAHUB_TPU_BARRIER_TIMEOUT_S`` (600
    s), which bounds :func:`barrier` on NCCL. Returns True when more than
    one process takes part.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator_address = coordinator_address or os.environ.get("BIAHUB_TPU_COORDINATOR")
    num_processes = (num_processes if num_processes is not None
                     else _int_env("BIAHUB_TPU_NUM_PROCESSES"))
    process_id = process_id if process_id is not None else _int_env("BIAHUB_TPU_PROCESS_ID")
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    timeout = datetime.timedelta(seconds=_timeout_s())
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise RuntimeError(
                "BIAHUB_TPU_COORDINATOR is set but the process coordinates "
                "are incomplete: also export BIAHUB_TPU_NUM_PROCESSES and "
                "BIAHUB_TPU_PROCESS_ID (or unset the coordinator for a "
                "single-host run)."
            )
        if "://" not in coordinator_address:
            coordinator_address = f"tcp://{coordinator_address}"
        dist.init_process_group(backend, init_method=coordinator_address,
                                world_size=num_processes, rank=process_id, timeout=timeout)
    elif os.environ.get("BIAHUB_TPU_DISTRIBUTED") == "auto":
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
    else:
        return False
    return dist.get_world_size() > 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator() -> bool:
    """True on the process that does once-per-run work (plate creation,
    config echo)."""
    return process_index() == 0


def barrier(name: str = "biahub-barrier", timeout_s: float | None = None) -> None:
    """Block until every process reaches this point (no-op in one process).

    Bounded: when a peer dies, the survivors fail fast after ``timeout_s``
    (default ``BIAHUB_TPU_BARRIER_TIMEOUT_S``, 600 s) instead of hanging the
    fleet. On gloo that is ``monitored_barrier``'s own timeout; on NCCL the
    group's, set when it started (``timeout_s`` is not read there).
    """
    if process_count() <= 1:
        return
    if timeout_s is None:
        timeout_s = _timeout_s()
    try:
        if dist.get_backend() == "gloo":
            dist.monitored_barrier(timeout=datetime.timedelta(seconds=timeout_s))
        else:
            dist.barrier()
    except RuntimeError as exc:
        msg = str(exc)
        if "DEADLINE" in msg.upper() or "TIME" in msg.upper():
            raise RuntimeError(
                f"barrier {name!r} timed out after {timeout_s:.0f} s — a "
                f"peer process likely died (preempted/OOM). This process is "
                f"exiting so the fleet fails fast instead of hanging; "
                f"restart the run on all hosts and finished units will be "
                f"skipped via the resume records. (Tune with "
                f"BIAHUB_TPU_BARRIER_TIMEOUT_S.)"
            ) from exc
        # Other failures (a connection reset, a bad group) keep the real
        # error in front: calling them a peer's death misleads the operator.
        raise RuntimeError(f"barrier {name!r} failed: {msg}") from exc
