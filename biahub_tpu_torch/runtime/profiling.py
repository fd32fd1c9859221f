"""Opt-in timing lines and device traces.

Counterpart of ``biahub_tpu/runtime/profiling.py`` (:32-124), on
``torch.profiler``. One environment variable turns it on:

    BIAHUB_TPU_PROFILE=1            # timing lines on stderr
    BIAHUB_TPU_PROFILE=/tmp/trace   # the lines, and a trace written there

With a directory, :func:`profiled_section` records CPU and, where a card
is present, CUDA activity, writes a Chrome trace ``*.trace.json.gz`` under
the directory, and prints :func:`summarize_device_trace`'s table of device
operations by total time (the CUDA kernels, memcpys and memsets of the
newest trace; the reference's table lists the TPU process's operations).
:func:`batch_timer` prints one line per batch of the runner (units, wall
time, input bandwidth).
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import socket
import sys
import time

__all__ = [
    "profiled_section",
    "profiling_enabled",
    "batch_timer",
    "summarize_device_trace",
]

#: The trace event categories of device work in ``torch.profiler``'s Chrome
#: trace.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def profiling_enabled() -> bool:
    return bool(os.environ.get("BIAHUB_TPU_PROFILE"))


def _trace_dir() -> str | None:
    value = os.environ.get("BIAHUB_TPU_PROFILE", "")
    return value if value and value != "1" else None


@contextlib.contextmanager
def profiled_section(name: str):
    """Wrap a whole verb run: its wall time on stderr and, with a trace
    directory, its trace and device-time table."""
    if not profiling_enabled():
        yield
        return
    trace_dir = _trace_dir()
    start = time.perf_counter()
    if trace_dir is not None:
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            yield
        os.makedirs(trace_dir, exist_ok=True)
        # Names sort by time, so the newest trace sorts last.
        stamp = time.strftime("%Y%m%d_%H%M%S") + f"_{time.time_ns() % 10**9:09d}"
        prof.export_chrome_trace(os.path.join(
            trace_dir, f"{stamp}.{socket.gethostname()}_{os.getpid()}.pt.trace.json.gz"))
    else:
        yield
    print(f"[biahub-tpu profile] {name}: {time.perf_counter() - start:.3f}s", file=sys.stderr)
    if trace_dir is not None:
        try:
            summarize_device_trace(trace_dir)
        except Exception as exc:  # pragma: no cover - trace format drift
            print(f"[biahub-tpu profile] trace summary failed: {exc!r}", file=sys.stderr)


def summarize_device_trace(trace_dir: str, top: int = 15, file=None) -> list:
    """The device operations of the newest ``*.trace.json.gz`` under
    ``trace_dir`` (by name, recursively) by total time.

    Prints the ``top`` rows (to ``file``, default stderr) and returns every
    ``(name, total_ms, count)`` row, longest first; the rows are the
    trace's complete events of the categories ``kernel``, ``gpu_memcpy``
    and ``gpu_memset``. Raises ``FileNotFoundError`` when there is no
    trace."""
    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.trace.json.gz"), recursive=True))
    if not paths:
        raise FileNotFoundError(f"no *.trace.json.gz under {trace_dir}")
    with gzip.open(paths[-1]) as f:
        trace = json.load(f)
    totals: dict[str, float] = collections.defaultdict(float)
    counts: dict[str, int] = collections.defaultdict(int)
    for e in trace.get("traceEvents", []):
        if e.get("ph") == "X" and "dur" in e and e.get("cat") in DEVICE_CATEGORIES:
            totals[e["name"]] += e["dur"] / 1000.0
            counts[e["name"]] += 1
    rows = sorted(((name, ms, counts[name]) for name, ms in totals.items()), key=lambda r: -r[1])
    out = file or sys.stderr
    print("[biahub-tpu profile] device time by op:", file=out)
    for name, ms, count in rows[:top]:
        print(f"  {ms:9.2f} ms  x{count:4d}  {name[:80]}", file=out)
    return rows


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
