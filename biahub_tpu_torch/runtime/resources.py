"""Resource estimation, the ``RESOURCES:`` stdout line and the resume token.

Counterpart of ``biahub_tpu/runtime/resources.py``: ``estimate_resources``
and ``echo_resources`` give the reference's numbers and line, which
pipeline runners parse from ``--init`` runs. ``settings_fingerprint`` is a
sha256 of the validated settings dict in sorted-key JSON: a changed setting
changes it, and so invalidates the resume records.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

__all__ = ["echo_resources", "estimate_resources", "settings_fingerprint"]


def echo_resources(num_cpus: int, mem_gb: int, time_minutes: int) -> None:
    """Print the per-position resource request consumed by pipeline runners."""
    payload = {"cpus": int(num_cpus), "mem_gb": int(mem_gb), "time_minutes": int(time_minutes)}
    print("RESOURCES:" + json.dumps(payload))


def settings_fingerprint(settings: dict) -> str:
    """Stable short hash of a validated settings dict, used as the resume token."""
    payload = json.dumps(settings, sort_keys=True, default=str)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def estimate_resources(
    shape: tuple[int, int, int, int, int],
    dtype=np.float32,
    ram_multiplier: float = 1.0,
    time_multiplier: float = 1.0,
    max_num_cpus: int = 64,
    min_ram_per_cpu: int = 4,
    min_time_minutes: int = 30,
) -> tuple[int, int, int]:
    """Estimate (time_minutes, num_cpus, gb_ram_per_cpu) for a (T, C, Z, Y, X)
    volume: RAM from one ZYX volume times ``ram_multiplier``, wall time from
    the T * C volumes times ``time_multiplier`` minutes, rounded up to 10."""
    if len(shape) != 5:
        raise ValueError("The shape must be a 5-tuple (T, C, Z, Y, X).")
    if ram_multiplier <= 0 or time_multiplier <= 0:
        raise ValueError("ram_multiplier and time_multiplier must be > 0.")
    T, C, Z, Y, X = shape
    gb_per_element = np.dtype(dtype).itemsize / 2**30
    num_cpus = 1 if os.environ.get("CI") == "true" else min(T * C, max_num_cpus)
    gb_ram_per_volume = Z * Y * X * gb_per_element
    gb_ram_per_cpu = np.ceil(max(min_ram_per_cpu, gb_ram_per_volume * ram_multiplier))
    minutes = max(min_time_minutes, T * C * time_multiplier)
    time_minutes = int(np.ceil(minutes / 10.0) * 10)
    return time_minutes, int(num_cpus), int(gb_ram_per_cpu)
