"""Build, load and count the CUDA kernels of ``biahub_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` holds kernels and a plain C interface. At first CUDA
use it is compiled with ``nvcc`` into ``build/biahub_tpu_torch/`` beside the
package (one shared library per source, named by the hash of the source,
of the ``csrc`` headers it includes and of the flags, so an edited source or
header rebuilds) and loaded with ``ctypes``. Nothing
here runs at import: the CPU path never looks for ``nvcc``. The compiler's
output, ``ptxas -v``'s registers, shared memory and spills of every kernel
included, is kept beside each library (:func:`build_log`).

Every C entry returns a ``cudaError_t``; :func:`check` raises on a non-zero
one. Every pointer and the stream cross as ``ctypes.c_void_p``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ["SOURCES", "build", "build_log", "library", "check", "on_card", "launch_counts",
           "count_launch", "reset_launch_counts", "ptr", "stream_of"]

SOURCES = ("fft", "deskew", "warp", "peaks", "multipass", "spectral")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "biahub_tpu_torch"

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()

# Kernel launches since the last reset, by kernel name. Each wrapper adds one
# where it launches its kernel, and nowhere else (the plain versions do not
# count), so a run can show that its path went through the kernels.
launch_counts: dict[str, int] = {}


def count_launch(name: str) -> None:
    launch_counts[name] = launch_counts.get(name, 0) + 1


def reset_launch_counts() -> None:
    launch_counts.clear()


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("biahub_tpu_torch: nvcc not found (set CUDA_HOME)")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _sources(path: Path, seen: list[Path]) -> list[Path]:
    """``path`` and every file it includes with ``#include "..."``,
    transitively, each once, in the order they are first met."""
    if path not in seen:
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            _sources(path.parent / inc.decode(), seen)
    return seen


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for path in _sources(_CSRC / f"{name}.cu", []):
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> float:
    """Compile every source in ``names`` that has no current library, all
    ``nvcc`` processes at once; returns the wall seconds spent. Raises with
    the compiler's output if one fails."""
    t0 = time.perf_counter()
    _BUILD.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs.append((name, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, target, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{out}")
            continue
        target.with_suffix(".log").write_text(out)
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """The compiler's output for ``csrc/<name>.cu``'s current library (built
    first if needed)."""
    build((name,))
    return _target(name).with_suffix(".log").read_text()


def library(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.

    ``signatures`` maps each C entry to its ``argtypes``; every entry returns
    an int (a ``cudaError_t``)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(_target(name)))
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
    return lib


def on_card(t: torch.Tensor, what: str) -> bool:
    """True when a wrapper must launch its kernel (a CUDA tensor), False when
    it takes its plain version (a CPU tensor); raises for any other device.
    There is no fallback from the kernel to the plain version."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: no kernel or plain version for device {t.device}")


def check(rc: int, lib: ctypes.CDLL, what: str) -> None:
    """Raise if a C entry reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if rc != 0:
        raise RuntimeError(
            f"{what}: CUDA error {rc} ({lib.error_string(rc).decode()})"
        )


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
