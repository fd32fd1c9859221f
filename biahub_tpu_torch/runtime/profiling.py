"""Per-batch timing lines.

Counterpart of ``biahub_tpu/runtime/profiling.py::batch_timer``: with
``BIAHUB_TPU_PROFILE`` set, each batch of the runner prints one line on
stderr (units, wall time, input bandwidth). The reference's device-trace
helpers are not ported.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

__all__ = ["profiling_enabled", "batch_timer"]


def profiling_enabled() -> bool:
    return bool(os.environ.get("BIAHUB_TPU_PROFILE"))


@contextlib.contextmanager
def batch_timer(label: str, n_units: int, unit_bytes: int):
    """Per-batch timing line: units, effective bandwidth, wall time."""
    if not profiling_enabled():
        yield
        return
    start = time.perf_counter()
    yield
    elapsed = time.perf_counter() - start
    gbps = n_units * unit_bytes / max(elapsed, 1e-9) / 2**30
    print(f"[biahub-tpu profile] {label}: {n_units} units in {elapsed:.3f}s "
          f"({gbps:.2f} GiB/s input)", file=sys.stderr)
