"""The work units' ownership across processes.

Counterpart of ``biahub_tpu/runtime/executor.py``'s ``stripe_units``
(:87-105); its ``BatchRunner`` is not ported yet.
"""

from __future__ import annotations

from collections.abc import Sequence

from biahub_tpu_torch.parallel.distributed import process_count, process_index

__all__ = ["stripe_units"]


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
