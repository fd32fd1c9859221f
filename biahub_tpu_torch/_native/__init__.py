"""Host-side helpers compiled from C++ (``fastops.cpp``), loaded with ctypes.

Counterpart of ``biahub_tpu/_native``: the largest interior rectangle of a
mask (:func:`lir_2d`, the register verb's overlap crop) and the graph
matcher's sorted-assignment cost matrix (:func:`edge_consistency_costs`).
At first use ``fastops.cpp`` is compiled with ``$CXX`` (``c++`` when unset)
into ``build/biahub_tpu_torch/`` beside the package, named by the hash of
the source, the compiler's version and the flags; it is written under a
name of its own process and then renamed into place, so processes that
build at once do not read each other's half-written library. Nothing is
built at import.

Where the build fails this raises with the compiler's output: the port has
no quiet fallback to the Python loop (``transforms/lir.py`` keeps the loop
as the plain version the tests hold the helper against).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["library", "lir_2d", "edge_consistency_costs"]

_SOURCE = Path(__file__).with_name("fastops.cpp")
_BUILD = Path(__file__).resolve().parents[2] / "build" / "biahub_tpu_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def _compiler() -> str:
    return os.environ.get("CXX") or "c++"


def _run(cmd: list[str]) -> subprocess.CompletedProcess:
    try:
        return subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except FileNotFoundError:
        raise RuntimeError(f"biahub_tpu_torch: C++ compiler {cmd[0]!r} not found (set CXX) to "
                           f"build {_SOURCE.name}") from None


def _target(cxx: str) -> Path:
    """The library's path: named by the source, the compiler (its
    ``--version``, so a tree copied to another machine rebuilds) and the
    flags."""
    h = hashlib.sha256(_SOURCE.read_bytes())
    h.update(_run([cxx, "--version"]).stdout.encode())
    h.update(" ".join((cxx,) + CXX_FLAGS).encode())
    return _BUILD / f"fastops-{h.hexdigest()[:16]}.so"


def _build(cxx: str, target: Path) -> None:
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, str(_SOURCE), "-o", str(tmp)]
    proc = _run(cmd)
    if proc.returncode != 0:
        raise RuntimeError(f"biahub_tpu_torch: {' '.join(cmd)} failed ({proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, target)


def library() -> ctypes.CDLL:
    """The loaded helper library, built first if it has no current build."""
    global _lib
    with _lock:
        if _lib is None:
            cxx = _compiler()
            target = _target(cxx)
            if not target.exists():
                _build(cxx, target)
            lib = ctypes.CDLL(str(target))
            i64p = ctypes.POINTER(ctypes.c_int64)
            f64p = ctypes.POINTER(ctypes.c_double)
            lib.lir_2d.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                                   ctypes.c_int64, i64p]
            lib.lir_2d.restype = None
            lib.edge_consistency_costs.argtypes = [f64p, i64p, ctypes.c_int64, f64p, i64p,
                                                   ctypes.c_int64, ctypes.c_double, f64p]
            lib.edge_consistency_costs.restype = None
            _lib = lib
    return _lib


def lir_2d(mask: np.ndarray) -> tuple[int, int, int, int]:
    """(x, y, width, height) of the largest all-True rectangle of a 2D
    mask, the first of the largest area in row-major scan order."""
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    if mask.ndim != 2:
        raise ValueError(f"lir_2d: want a 2D mask, got shape {mask.shape}")
    out = np.zeros(4, dtype=np.int64)
    library().lir_2d(mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), mask.shape[0],
                     mask.shape[1], out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return tuple(int(v) for v in out)


def _ragged(lists) -> tuple[np.ndarray, np.ndarray]:
    """The lists concatenated as float64, and their (len + 1) offsets."""
    flat = np.ascontiguousarray(np.concatenate([np.asarray(a, np.float64).ravel()
                                                for a in lists]) if lists else np.zeros(0),
                                dtype=np.float64)
    offsets = np.zeros(len(lists) + 1, dtype=np.int64)
    np.cumsum([len(a) for a in lists], out=offsets[1:])
    return flat, offsets


def edge_consistency_costs(mov_lists, ref_lists, default_cost: float) -> np.ndarray:
    """(N, M) float64: the mean optimal-assignment cost of every pair of
    sorted lists (the shorter aligned into the longer), ``default_cost``
    where a list is empty."""
    mov_flat, mov_off = _ragged(mov_lists)
    ref_flat, ref_off = _ragged(ref_lists)
    out = np.empty((len(mov_lists), len(ref_lists)), dtype=np.float64)
    f64p = ctypes.POINTER(ctypes.c_double)
    i64p = ctypes.POINTER(ctypes.c_int64)
    library().edge_consistency_costs(
        mov_flat.ctypes.data_as(f64p), mov_off.ctypes.data_as(i64p), len(mov_lists),
        ref_flat.ctypes.data_as(f64p), ref_off.ctypes.data_as(i64p), len(ref_lists),
        float(default_cost), out.ctypes.data_as(f64p))
    return out
