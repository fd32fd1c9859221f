"""OME-Zarr (NGFF 0.4 / 0.5) HCS plates and positions, on numpy and the
standard library.

Counterpart of ``biahub_tpu/io/ngff.py``: the same plate / position model,
``open_ome_zarr``, the idempotent ``create_empty_plate`` and the same
metadata, key for key. Positions are ``plate.zarr/<row>/<col>/<fov>``
groups holding 5D (T, C, Z, Y, X) arrays; OME-Zarr 0.4 stores are zarr v2,
0.5 stores zarr v3.

The zarr layer is this module's own:

- **v2**: ``.zgroup``, ``.zattrs``, ``.zarray`` (``dimension_separator``
  ``.`` or ``/``, ``fill_value`` for chunks that are absent, ``<`` or ``>``
  byte order, C order; no compressor, ``blosc``, ``zlib`` or ``gzip``);
- **v3**: ``zarr.json`` (``chunk_key_encoding`` ``default`` or ``v2``; the
  ``bytes`` codec, then at most one of ``blosc``, ``zstd`` or ``gzip``, then
  optionally ``crc32c``; or ``sharding_indexed`` over such a chain, a box
  reading only the inner chunks it touches).

The codecs are :mod:`biahub_tpu_torch.io.codecs`'; any other codec,
filter or chain raises an error that names it. Chunks are written
uncompressed unless the creator is given ``compressor="zstd"``: the
reference's layouts, blosc (zstd level 1, byte shuffle) for v2 and
``bytes`` then ``zstd`` level 1 for v3; ``shards_ratio`` writes the
reference's ``sharding_indexed`` v3 arrays (inner ``bytes`` then ``zstd``
level 1, the index ``bytes`` then ``crc32c`` at the shard's end).
Uncompressed chunks are read in place (a box that covers part of a chunk
through a memory map of its file, so that only the pages it touches are
read). Each chunk or shard is written to a temporary name and renamed over
its key (``os.replace``), so a run that is killed leaves none torn.
``read_async`` and ``write_async`` run on a thread pool (file reads and
writes, ``zlib`` and the ``ctypes`` calls into ``libzstd`` release the
GIL).
"""

from __future__ import annotations

import io
import itertools
import json
import math
import os
import shutil
import threading
import uuid
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Literal, Sequence

import numpy as np

from biahub_tpu_torch.io.codecs import Chain, ShardLayout, chain_from_v2, chain_from_v3

__all__ = [
    "TransformationMeta",
    "ImageArray",
    "Position",
    "Plate",
    "open_ome_zarr",
    "create_empty_plate",
    "get_ome_zarr_version",
]

AXES_5D = [
    {"name": "t", "type": "time"},
    {"name": "c", "type": "channel"},
    {"name": "z", "type": "space", "unit": "micrometer"},
    {"name": "y", "type": "space", "unit": "micrometer"},
    {"name": "x", "type": "space", "unit": "micrometer"},
]

# Default cap on a single zarr chunk, in bytes: one chunk per (t, c) ZYX
# volume, split along Z above this.
MAX_CHUNK_BYTES = 128 * 2**20

_IO_WORKERS = 8
_pool_lock = threading.Lock()
_pool: ThreadPoolExecutor | None = None


def _io_pool() -> ThreadPoolExecutor:
    """The thread pool of ``read_async`` and ``write_async``, started at
    its first use."""
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(_IO_WORKERS, thread_name_prefix="ngff-io")
        return _pool


@dataclass
class TransformationMeta:
    """Coordinate transformation metadata (scale/translation) for a dataset level."""

    type: Literal["scale", "translation", "identity"]
    scale: Sequence[float] | None = None
    translation: Sequence[float] | None = None

    def to_ngff(self) -> dict:
        out: dict = {"type": self.type}
        if self.type == "scale":
            out["scale"] = [float(s) for s in (self.scale or [])]
        elif self.type == "translation":
            out["translation"] = [float(t) for t in (self.translation or [])]
        return out


def _default_chunks(shape: Sequence[int], dtype) -> list[int]:
    """One chunk per (t, c) ZYX volume, split along Z if above MAX_CHUNK_BYTES."""
    shape = list(shape)
    itemsize = np.dtype(dtype).itemsize
    if len(shape) == 5:
        t, c, z, y, x = shape
        zc = z
        while zc > 1 and zc * y * x * itemsize > MAX_CHUNK_BYTES:
            zc = math.ceil(zc / 2)
        return [1, 1, zc, y, x]
    lead = [1] * max(0, len(shape) - 3)
    return lead + shape[len(lead):]


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _write_json(path: Path, payload: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)


def _replace_bytes(path: Path, data) -> None:
    """Write ``data`` to ``path`` through a temporary name in its directory
    and ``os.replace``: readers see the old file or the whole new one."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.parent / f".{path.name}.{uuid.uuid4().hex}.tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise


# -- zarr arrays ------------------------------------------------------------

_EMPTY = 2**64 - 1  # a sharding_indexed index entry of an empty inner chunk

_V3_DTYPES = {"bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
              "uint64", "float16", "float32", "float64", "complex64", "complex128"}


def _fill_value(value, dtype: np.dtype):
    if value is None:
        return np.zeros((), dtype)[()]
    if isinstance(value, str):
        value = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}.get(value, value)
    return np.asarray(value).astype(dtype)[()]


@dataclass(frozen=True)
class _ArrayMeta:
    """What reading and writing an array needs from its metadata."""

    shape: tuple[int, ...]
    chunks: tuple[int, ...]  # the read and write grid: a shard's inner chunks
    dtype: np.dtype          # in the stored byte order
    fill: object
    compressor: Chain        # the chunks' codecs after ``bytes``
    key_prefix: str          # "c/" for v3 default keys, else ""
    separator: str
    shard: ShardLayout | None = None
    shard_shape: tuple[int, ...] | None = None

    @property
    def raw(self) -> bool:
        """Chunk files that are the chunks' bytes."""
        return self.compressor.raw and self.shard is None


def _v2_meta(meta: dict, path: Path) -> _ArrayMeta:
    if meta.get("order", "C") != "C":
        raise ValueError(f"{path}: zarr v2 order {meta['order']!r} is not supported")
    dtype = np.dtype(meta["dtype"])
    chain = chain_from_v2(meta.get("compressor"), meta.get("filters"), dtype, path)
    return _ArrayMeta(tuple(meta["shape"]), tuple(meta["chunks"]), dtype,
                      _fill_value(meta.get("fill_value"), dtype), chain, "",
                      meta.get("dimension_separator", "."))


def _v3_meta(meta: dict, path: Path) -> _ArrayMeta:
    name = meta["data_type"]
    if name not in _V3_DTYPES:
        raise ValueError(f"{path}: zarr v3 data type {name!r} is not supported")
    endian, chain, shard = chain_from_v3(meta.get("codecs", []), np.dtype(name), path)
    dtype = np.dtype(name).newbyteorder("<" if endian == "little" else ">")
    grid = meta["chunk_grid"]
    if grid.get("name") != "regular":
        raise ValueError(f"{path}: zarr v3 chunk grid {grid.get('name')!r} is not supported")
    enc = meta.get("chunk_key_encoding", {"name": "default"})
    sep = (enc.get("configuration") or {}).get("separator")
    if enc.get("name") == "default":
        prefix, sep = "c/", sep or "/"
    elif enc.get("name") == "v2":
        prefix, sep = "", sep or "."
    else:
        raise ValueError(f"{path}: zarr v3 chunk key encoding {enc.get('name')!r} is not "
                         "supported")
    grid_shape = tuple(grid["configuration"]["chunk_shape"])
    chunks, shard_shape = grid_shape, None
    if shard is not None:
        chunks, shard_shape = shard.chunk_shape, grid_shape
        if len(chunks) != len(grid_shape) or any(
                s % c for s, c in zip(grid_shape, chunks)):
            raise ValueError(f"{path}: sharding_indexed inner chunks {list(chunks)} do not "
                             f"tile the shard {list(grid_shape)}")
    return _ArrayMeta(tuple(meta["shape"]), chunks, dtype,
                      _fill_value(meta.get("fill_value"), dtype), chain, prefix, sep,
                      shard, shard_shape)


_V3_BYTES = {"configuration": {"endian": "little"}, "name": "bytes"}
_V3_ZSTD = {"configuration": {"checksum": False, "level": 1}, "name": "zstd"}


def _array_metadata(shape, dtype, chunks, version: str, compressor: str | None = None,
                    shards_ratio: Sequence[int] | None = None) -> dict:
    """The metadata this module writes, little endian: uncompressed chunks,
    or with ``compressor="zstd"`` the reference's (v2 blosc with zstd level
    1 and byte shuffle; v3 ``bytes`` then ``zstd`` level 1); a v3 array
    with ``shards_ratio`` is the reference's ``sharding_indexed`` one
    (``shards_ratio`` x ``chunks`` a shard, cut to the shape)."""
    if compressor not in (None, "zstd"):
        raise ValueError(f"compressor {compressor!r}: chunks are written uncompressed (None) "
                         "or as the reference's zstd layouts ('zstd')")
    dtype = np.dtype(dtype)
    chunks = [int(c) for c in (chunks if chunks is not None else _default_chunks(shape, dtype))]
    fill = 0.0 if dtype.kind in "fc" else (False if dtype.kind == "b" else 0)
    if version == "0.5":
        codecs = [_V3_BYTES] + ([_V3_ZSTD] if compressor else [])
        grid = chunks
        if shards_ratio is not None:
            if len(shards_ratio) != len(chunks):
                raise ValueError(f"shards_ratio {list(shards_ratio)} wants one ratio per axis "
                                 f"of {list(shape)}")
            grid = [min(c * int(r), int(n)) for c, r, n in zip(chunks, shards_ratio, shape)]
            codecs = [{"configuration": {
                "chunk_shape": chunks, "codecs": [_V3_BYTES, _V3_ZSTD],
                "index_codecs": [_V3_BYTES, {"name": "crc32c"}]},
                "name": "sharding_indexed"}]
        return {
            "chunk_grid": {"configuration": {"chunk_shape": grid}, "name": "regular"},
            "chunk_key_encoding": {"name": "default"},
            "codecs": codecs,
            "data_type": dtype.name,
            "fill_value": fill,
            "node_type": "array",
            "shape": [int(s) for s in shape],
            "zarr_format": 3,
        }
    return {
        "chunks": chunks,
        "compressor": ({"blocksize": 0, "clevel": 1, "cname": "zstd", "id": "blosc",
                        "shuffle": 1} if compressor else None),
        "dimension_separator": ".",
        "dtype": dtype.newbyteorder("<").str,
        "fill_value": fill,
        "filters": None,
        "order": "C",
        "shape": [int(s) for s in shape],
        "zarr_format": 2,
    }


def _normalize(key, shape) -> list:
    """Per axis an int, a ``(start, stop)`` range or a list of ints."""
    if not isinstance(key, tuple):
        key = (key,)
    if any(k is Ellipsis for k in key):
        i = key.index(Ellipsis)
        key = key[:i] + (slice(None),) * (len(shape) - len(key) + 1) + key[i + 1:]
    if len(key) > len(shape):
        raise IndexError(f"too many indices ({len(key)}) for an array of {len(shape)} axes")
    key = key + (slice(None),) * (len(shape) - len(key))
    out = []
    for k, n in zip(key, shape):
        if isinstance(k, slice):
            start, stop, step = k.indices(n)
            if step != 1:
                raise IndexError("only slices of step 1 are supported")
            out.append((start, max(start, stop)))
        elif isinstance(k, (list, tuple, np.ndarray)):
            idx = [int(i) + n if int(i) < 0 else int(i) for i in np.asarray(k).ravel()]
            if any(not 0 <= i < n for i in idx):
                raise IndexError(f"index out of range for an axis of {n}")
            out.append(idx)
        else:
            i = int(k)
            i = i + n if i < 0 else i
            if not 0 <= i < n:
                raise IndexError(f"index {k} out of range for an axis of {n}")
            out.append(i)
    return out


def _box(sel) -> list[tuple[int, int]]:
    return [(s, s + 1) if isinstance(s, int) else
            (min(s), max(s) + 1) if isinstance(s, list) else s for s in sel]


class ImageArray:
    """One multiscale level: a 5D (T, C, Z, Y, X) zarr array.

    Slicing reads return numpy arrays; slice assignment writes through.
    Indices are ints, slices of step 1, ``...`` and lists of ints.
    """

    def __init__(self, path: Path):
        self.path = Path(path)
        if (self.path / "zarr.json").exists():
            self._meta = _v3_meta(_read_json(self.path / "zarr.json"), self.path)
        elif (self.path / ".zarray").exists():
            self._meta = _v2_meta(_read_json(self.path / ".zarray"), self.path)
        else:
            raise FileNotFoundError(f"no zarr array at {self.path}")
        # Partial chunk writes read, modify and replace the chunk.
        self._lock = threading.Lock()

    @property
    def shape(self) -> tuple[int, ...]:
        return self._meta.shape

    @property
    def dtype(self) -> np.dtype:
        return self._meta.dtype.newbyteorder("=")

    @property
    def chunks(self) -> tuple[int, ...]:
        return self._meta.chunks

    # -- chunks -------------------------------------------------------------

    def _chunk_path(self, idx) -> Path:
        m = self._meta
        name = m.separator.join(str(i) for i in idx) if idx else "0"
        return self.path / (m.key_prefix + name if m.key_prefix else name)

    def _chunk_bounds(self, idx) -> list[tuple[int, int]]:
        return [(i * c, min((i + 1) * c, n)) for i, c, n in zip(idx, self.chunks, self.shape)]

    def _decode(self, raw, out: np.ndarray | None = None) -> np.ndarray:
        """A stored chunk's values (decoded into ``out``, a C-contiguous
        array of the chunk's shape and stored dtype, where given)."""
        m = self._meta
        nbytes = math.prod(m.chunks) * m.dtype.itemsize
        buf = m.compressor.decode(raw, nbytes, None if out is None else
                                  out.reshape(-1).view(np.uint8))
        return out if out is not None else buf.view(m.dtype).reshape(m.chunks)

    def _shard_of(self, idx) -> tuple[tuple[int, ...], int]:
        """The shard holding inner chunk ``idx``, and the chunk's entry in
        the shard's index."""
        m = self._meta
        per = m.shard.per_shard(m.shard_shape)
        shard = tuple(i // p for i, p in zip(idx, per))
        return shard, int(np.ravel_multi_index(tuple(i % p for i, p in zip(idx, per)), per))

    def _read_stored(self, idx, indexes: dict | None = None):
        """Chunk ``idx``'s stored bytes, None where it is absent; a sharded
        array's shard indexes are kept in ``indexes`` across calls."""
        m = self._meta
        if m.shard is None:
            try:
                with open(self._chunk_path(idx), "rb") as f:
                    return f.read()
            except FileNotFoundError:
                return None
        shard, entry = self._shard_of(idx)
        indexes = {} if indexes is None else indexes
        if indexes.get(shard, ()) is None:
            return None
        try:
            with open(self._chunk_path(shard), "rb") as f:
                if shard not in indexes:
                    indexes[shard] = m.shard.read_index(
                        f, math.prod(m.shard.per_shard(m.shard_shape)))
                offset, nbytes = (int(v) for v in indexes[shard][entry])
                if offset == _EMPTY and nbytes == _EMPTY:
                    return None
                f.seek(offset)
                return f.read(nbytes)
        except FileNotFoundError:
            indexes[shard] = None
            return None

    def _read_chunk(self, idx, indexes: dict | None = None) -> np.ndarray | None:
        raw = self._read_stored(idx, indexes)
        return None if raw is None else self._decode(raw)

    def _chunk_ranges(self, box) -> Iterator[tuple]:
        return itertools.product(*[range(a // c, (b - 1) // c + 1) if b > a else range(0)
                                   for (a, b), c in zip(box, self.chunks)])

    # -- reads --------------------------------------------------------------

    def _read_box(self, box, out: np.ndarray) -> None:
        """Fill ``out`` (the box's shape) with the box ``[(start, stop)]``."""
        m = self._meta
        raw_ok = m.raw and m.dtype.isnative
        indexes: dict = {}
        for idx in self._chunk_ranges(box):
            bounds = self._chunk_bounds(idx)
            inter = [(max(a, lo), min(b, hi)) for (a, b), (lo, hi) in zip(box, bounds)]
            dest = out[tuple(slice(lo - a, hi - a) for (lo, hi), (a, _) in zip(inter, box))]
            whole = all(lo == blo and hi == bhi and bhi - blo == c for (lo, hi), (blo, bhi), c
                        in zip(inter, bounds, self.chunks))
            if raw_ok and whole and dest.flags.c_contiguous:
                # The chunk is the destination's bytes: read it in place.
                try:
                    with open(self._chunk_path(idx), "rb") as f:
                        n = f.readinto(memoryview(dest).cast("B"))
                    if n == dest.nbytes:
                        continue
                except FileNotFoundError:
                    dest[...] = m.fill
                    continue
            inner = tuple(slice(lo - blo, hi - blo) for (lo, hi), (blo, _) in zip(inter, bounds))
            if raw_ok and not whole:
                # Part of an uncompressed chunk: map the file, so that only
                # the pages the box touches are read.
                try:
                    dest[...] = np.memmap(self._chunk_path(idx), m.dtype, "r",
                                          shape=m.chunks)[inner]
                except FileNotFoundError:
                    dest[...] = m.fill
                continue
            raw = self._read_stored(idx, indexes)
            if raw is None:
                dest[...] = m.fill
            elif whole and dest.flags.c_contiguous and m.dtype.isnative:
                self._decode(raw, out=dest)
            else:
                dest[...] = self._decode(raw)[inner]

    def read_into(self, key, out: np.ndarray) -> np.ndarray:
        """Read the selection ``key`` into ``out`` (its shape, any dtype the
        values cast to) and return ``out``; a selection without lists is
        read straight into ``out`` where it is C-contiguous and of the
        array's dtype."""
        sel = _normalize(key, self.shape)
        box = _box(sel)
        box_shape = tuple(b - a for a, b in box)
        if not any(isinstance(s, list) for s in sel) and out.dtype == self.dtype:
            self._read_box(box, out.reshape(box_shape))
            return out
        full = np.empty(box_shape, self.dtype)
        self._read_box(box, full)
        take = tuple(0 if isinstance(s, int) else
                     [i - a for i in s] if isinstance(s, list) else slice(None)
                     for s, (a, _) in zip(sel, box))
        out[...] = full[take]
        return out

    def __getitem__(self, key) -> np.ndarray:
        sel = _normalize(key, self.shape)
        shape = tuple(len(s) if isinstance(s, list) else s[1] - s[0]
                      for s in sel if not isinstance(s, int))
        return self.read_into(key, np.empty(shape, self.dtype))

    def read_async(self, key) -> Future:
        """Start a read; the future's result is the numpy array."""
        return _io_pool().submit(self.__getitem__, key)

    def read_into_async(self, key, out: np.ndarray) -> Future:
        """Start :meth:`read_into`; the future's result is ``out``."""
        return _io_pool().submit(self.read_into, key, out)

    def __array__(self, dtype=None, copy=None):
        out = self[...]
        return out.astype(dtype) if dtype is not None else out

    # -- writes -------------------------------------------------------------

    def _encode(self, chunk: np.ndarray) -> bytes | memoryview:
        return self._meta.compressor.encode(np.ascontiguousarray(chunk, dtype=self._meta.dtype))

    def _write_box(self, box, value: np.ndarray) -> None:
        m = self._meta
        if m.shard is not None:
            self._write_shards(box, value)
            return
        for idx in self._chunk_ranges(box):
            bounds = self._chunk_bounds(idx)
            inter = [(max(a, lo), min(b, hi)) for (a, b), (lo, hi) in zip(box, bounds)]
            src = value[tuple(slice(lo - a, hi - a) for (lo, hi), (a, _) in zip(inter, box))]
            inner = tuple(slice(lo - blo, hi - blo) for (lo, hi), (blo, _) in zip(inter, bounds))
            covered = all(lo == blo and hi == bhi for (lo, hi), (blo, bhi) in zip(inter, bounds))
            if covered:
                # The write decides the whole chunk (an edge chunk's rest is
                # past the array, fill): no read, no lock.
                if all(b - a == c for (a, b), c in zip(bounds, m.chunks)):
                    _replace_bytes(self._chunk_path(idx), self._encode(src))
                else:
                    chunk = np.full(m.chunks, m.fill, m.dtype)
                    chunk[inner] = src
                    _replace_bytes(self._chunk_path(idx), self._encode(chunk))
                continue
            with self._lock:
                old = self._read_chunk(idx)
                chunk = np.full(m.chunks, m.fill, m.dtype) if old is None else old.copy()
                chunk[inner] = src
                _replace_bytes(self._chunk_path(idx), self._encode(chunk))

    def _write_shards(self, box, value: np.ndarray) -> None:
        """Write the box into each shard it touches: a shard the box covers
        is encoded from ``value`` alone; any other is read, its untouched
        inner chunks kept as stored, under the array's lock."""
        m = self._meta
        for shard in itertools.product(*[range(a // s, (b - 1) // s + 1)
                                         for (a, b), s in zip(box, m.shard_shape)]):
            bounds = [(i * s, min((i + 1) * s, n)) for i, s, n in
                      zip(shard, m.shard_shape, m.shape)]
            if all(a <= lo and hi <= b for (a, b), (lo, hi) in zip(box, bounds)):
                self._write_shard(shard, box, value, None)
                continue
            with self._lock:
                try:
                    with open(self._chunk_path(shard), "rb") as f:
                        old = f.read()
                except FileNotFoundError:
                    old = None
                self._write_shard(shard, box, value, old)

    def _write_shard(self, shard, box, value: np.ndarray, old: bytes | None) -> None:
        m = self._meta
        per = m.shard.per_shard(m.shard_shape)
        index = None
        if old is not None:
            index = m.shard.read_index(io.BytesIO(old), math.prod(per))
        encoded = []
        for entry, idx in enumerate(itertools.product(
                *[range(i * p, (i + 1) * p) for i, p in zip(shard, per)])):
            bounds = self._chunk_bounds(idx)
            inter = [(max(a, lo), min(b, hi)) for (a, b), (lo, hi) in zip(box, bounds)]
            stored = None
            if index is not None and int(index[entry][0]) != _EMPTY:
                offset, nbytes = (int(v) for v in index[entry])
                stored = old[offset:offset + nbytes]
            if any(lo >= hi for lo, hi in bounds) or any(lo >= hi for lo, hi in inter):
                encoded.append(stored)  # past the array, or not written now
                continue
            src = value[tuple(slice(lo - a, hi - a) for (lo, hi), (a, _) in zip(inter, box))]
            inner = tuple(slice(lo - blo, hi - blo) for (lo, hi), (blo, _) in zip(inter, bounds))
            if all(lo == blo and hi == blo + c for (lo, hi), (blo, _), c
                   in zip(inter, bounds, m.chunks)):
                chunk = src
            else:
                chunk = (np.full(m.chunks, m.fill, m.dtype) if stored is None
                         else self._decode(stored).copy())
                chunk[inner] = src
            encoded.append(bytes(self._encode(chunk)))
        _replace_bytes(self._chunk_path(shard), m.shard.assemble(encoded))

    def __setitem__(self, key, value) -> None:
        sel = _normalize(key, self.shape)
        lists = [i for i, s in enumerate(sel) if isinstance(s, list)]
        out_axes = [i for i, s in enumerate(sel) if not isinstance(s, int)]
        shape = tuple(len(s) if isinstance(s, list) else s[1] - s[0]
                      for s in sel if not isinstance(s, int))
        value = np.broadcast_to(np.asarray(value, dtype=self.dtype), shape)
        if lists:
            # One write per element of the first list axis.
            ax = lists[0]
            pos = out_axes.index(ax)
            for j, i in enumerate(sel[ax]):
                sub = list(sel)
                sub[ax] = i
                self[tuple(s if isinstance(s, (int, list)) else slice(*s) for s in sub)] = \
                    np.take(value, j, axis=pos)
            return
        box = _box(sel)
        self._write_box(box, value.reshape(tuple(b - a for a, b in box)))

    def write_async(self, key, value) -> Future:
        """Start a write of ``value`` (kept by reference until the future
        resolves: do not change it before) and return its future."""
        return _io_pool().submit(self.__setitem__, key, value)


def _create_array(path: Path, version: str, shape, dtype, chunks, compressor=None,
                  shards_ratio=None) -> ImageArray:
    """Create the array at ``path``, or open it when it exists with the
    same metadata; an array there with other metadata is replaced."""
    meta = _array_metadata(shape, dtype, chunks, version, compressor, shards_ratio)
    name = "zarr.json" if version == "0.5" else ".zarray"
    target = path / name
    if target.exists():
        try:
            if _read_json(target) == meta:
                return ImageArray(path)
        except (OSError, json.JSONDecodeError):
            pass
        shutil.rmtree(path)
    path.mkdir(parents=True, exist_ok=True)
    target.write_text(json.dumps(meta, separators=(",", ":"), sort_keys=True))
    return ImageArray(path)


# -- groups -----------------------------------------------------------------


class _Group:
    """A zarr v2 or v3 group directory with JSON attributes."""

    def __init__(self, path: Path, version: str):
        self.path = Path(path)
        self.version = version  # OME-Zarr version: "0.4" (zarr v2) or "0.5" (zarr v3)

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def _is_v3(self) -> bool:
        return self.version == "0.5"

    def ensure_group(self) -> None:
        if self._is_v3:
            meta = self.path / "zarr.json"
            if not meta.exists():
                _write_json(meta, {"zarr_format": 3, "node_type": "group", "attributes": {}})
        else:
            meta = self.path / ".zgroup"
            if not meta.exists():
                _write_json(meta, {"zarr_format": 2})

    @property
    def zattrs(self) -> dict:
        if self._is_v3:
            meta = self.path / "zarr.json"
            if meta.exists():
                attrs = _read_json(meta).get("attributes", {})
                # OME-Zarr 0.5 nests NGFF metadata under "ome"; exposed flat.
                if "ome" in attrs:
                    flat = dict(attrs)
                    ome = flat.pop("ome")
                    flat.update(ome)
                    return flat
                return attrs
            return {}
        meta = self.path / ".zattrs"
        return _read_json(meta) if meta.exists() else {}

    def update_zattrs(self, updates: dict) -> None:
        if self._is_v3:
            meta = self.path / "zarr.json"
            payload = (_read_json(meta) if meta.exists()
                       else {"zarr_format": 3, "node_type": "group", "attributes": {}})
            attrs = payload.setdefault("attributes", {})
            ngff_keys = {"multiscales", "omero", "plate", "well"}
            for k, v in updates.items():
                if k in ngff_keys:
                    ome = attrs.setdefault("ome", {"version": "0.5"})
                    ome[k] = v
                else:
                    attrs[k] = v
            _write_json(meta, payload)
        else:
            meta = self.path / ".zattrs"
            payload = _read_json(meta) if meta.exists() else {}
            payload.update(updates)
            _write_json(meta, payload)


class Position(_Group):
    """One field of view: a group holding multiscale image arrays ("0", "1", ...)."""

    def __init__(self, path: Path, version: str = "0.4"):
        super().__init__(path, version)
        self._arrays: dict[str, ImageArray] = {}

    @property
    def channel_names(self) -> list[str]:
        omero = self.zattrs.get("omero", {})
        return [ch.get("label", str(i)) for i, ch in enumerate(omero.get("channels", []))]

    @property
    def scale(self) -> list[float]:
        """Voxel size for the highest-resolution level, as a 5-element list."""
        ms = self.zattrs.get("multiscales", [])
        if ms:
            for tf in ms[0]["datasets"][0].get("coordinateTransformations", []):
                if tf.get("type") == "scale":
                    return [float(s) for s in tf["scale"]]
        return [1.0] * 5

    def set_scale(self, scale: Sequence[float]) -> None:
        attrs = self.zattrs
        ms = attrs.get("multiscales")
        if ms:
            ms[0]["datasets"][0]["coordinateTransformations"] = [
                {"type": "scale", "scale": [float(s) for s in scale]}
            ]
            self.update_zattrs({"multiscales": ms})

    def _init_metadata(self, channel_names: Sequence[str],
                       datasets: list[dict] | None = None) -> None:
        self.ensure_group()
        v4 = {"version": self.version} if self.version == "0.4" else {}
        multiscales = [{
            "axes": AXES_5D,
            "datasets": datasets or [{
                "path": "0",
                "coordinateTransformations": [{"type": "scale", "scale": [1.0] * 5}],
            }],
            "name": "",
            **v4,
        }]
        omero = {
            "channels": [{"label": str(n), "active": True} for n in channel_names],
            "id": 1,
            **v4,
        }
        self.update_zattrs({"multiscales": multiscales, "omero": omero})

    def __getitem__(self, name: str) -> ImageArray:
        if name not in self._arrays:
            self._arrays[name] = ImageArray(self.path / name)
        return self._arrays[name]

    def __setitem__(self, name: str, data: np.ndarray) -> None:
        self.create_image(name, np.asarray(data))

    def __contains__(self, name: str) -> bool:
        child = self.path / name
        return (child / ".zarray").exists() or (child / "zarr.json").exists()

    @property
    def data(self) -> ImageArray:
        return self["0"]

    def array_names(self) -> list[str]:
        names = []
        for child in sorted(self.path.iterdir()):
            if (child / ".zarray").exists() or (
                (child / "zarr.json").exists()
                and _read_json(child / "zarr.json").get("node_type") == "array"
            ):
                names.append(child.name)
        return names

    def create_image(self, name: str, data: np.ndarray, chunks: Sequence[int] | None = None,
                     transform: list[TransformationMeta] | None = None,
                     shards_ratio: Sequence[int] | None = None,
                     compressor: str | None = None) -> ImageArray:
        data = np.asarray(data)
        arr = self.create_zeros(name, data.shape, data.dtype, chunks=chunks, transform=transform,
                                shards_ratio=shards_ratio, compressor=compressor)
        arr[...] = data
        return arr

    def create_zeros(self, name: str, shape: Sequence[int], dtype,
                     chunks: Sequence[int] | None = None,
                     transform: list[TransformationMeta] | None = None,
                     shards_ratio: Sequence[int] | None = None,
                     compressor: str | None = None) -> ImageArray:
        """Create (or open, when its metadata is the same) the array
        ``name``: uncompressed chunks, the reference's zstd layout with
        ``compressor="zstd"``, the reference's shards (OME-Zarr 0.5 only, as
        the reference ignores the ratio for 0.4) with ``shards_ratio``."""
        arr = _create_array(self.path / name, self.version, shape, dtype, chunks, compressor,
                            shards_ratio if self.version == "0.5" else None)
        self._arrays[name] = arr
        ms = self.zattrs.get("multiscales")
        tforms = ([t.to_ngff() for t in transform] if transform
                  else [{"type": "scale", "scale": [1.0] * len(shape)}])
        entry = {"path": name, "coordinateTransformations": tforms}
        if not ms:
            self._init_metadata(self.channel_names, datasets=[entry])
        else:
            datasets = ms[0]["datasets"]
            for i, d in enumerate(datasets):
                if d["path"] == name:
                    datasets[i] = entry
                    break
            else:
                datasets.append(entry)
            self.update_zattrs({"multiscales": ms})
        return arr

    def compute_pyramid(self, levels: int, method: str = "mean") -> None:
        """Create cascade-downsampled levels "1" .. "levels-1", each halving
        Y and X of the previous one by a 2x2 reduction (mean, max, min,
        median, mode or stride)."""
        if levels <= 1:
            return
        scale = self.scale
        for lv in range(1, levels):
            prev = self[str(lv - 1)]
            T, C, Z, Y, X = prev.shape
            lv_scale = list(scale)
            lv_scale[-2] = scale[-2] * (2**lv)
            lv_scale[-1] = scale[-1] * (2**lv)
            arr = self.create_zeros(str(lv), (T, C, Z, max(Y // 2, 1), max(X // 2, 1)),
                                    prev.dtype,
                                    transform=[TransformationMeta(type="scale", scale=lv_scale)])
            for t in range(T):
                for c in range(C):
                    arr[t, c] = _downsample_yx_2x(prev[t, c], method)

    def append_channel(self, name: str) -> None:
        """Register an extra channel label (the array is resized separately)."""
        omero = self.zattrs.get("omero", {"channels": []})
        omero["channels"].append({"label": str(name), "active": True})
        self.update_zattrs({"omero": omero})


class Plate(_Group):
    """An HCS plate: rows / columns / fields-of-view of 5D positions."""

    # channel names given at plate creation, used for new positions
    _channels: Sequence[str] | None = None

    def __init__(self, path: Path, version: str = "0.4"):
        super().__init__(path, version)

    @property
    def channel_names(self) -> list[str]:
        _, pos = next(iter(self.positions()), (None, None))
        return pos.channel_names if pos is not None else []

    def _plate_meta(self) -> dict:
        return self.zattrs.get("plate", {})

    def _set_plate_meta(self, meta: dict) -> None:
        self.update_zattrs({"plate": meta})

    def position_keys(self) -> list[tuple[str, str, str]]:
        keys = []
        for well in self._plate_meta().get("wells", []):
            row, col = well["path"].split("/")
            well_group = _Group(self.path / row / col, self.version)
            for img in well_group.zattrs.get("well", {}).get("images", []):
                keys.append((row, col, img["path"]))
        return keys

    def positions(self) -> Iterator[tuple[str, Position]]:
        for row, col, fov in self.position_keys():
            yield f"{row}/{col}/{fov}", Position(self.path / row / col / fov, self.version)

    def __getitem__(self, name: str) -> Position:
        parts = str(name).strip("/").split("/")
        if len(parts) != 3:
            raise KeyError(f"Position key must be row/col/fov, got {name!r}")
        return Position(self.path.joinpath(*parts), self.version)

    def create_position(self, row: str, col: str, fov: str,
                        channel_names: Sequence[str] | None = None) -> Position:
        row, col, fov = str(row), str(col), str(fov)
        self.ensure_group()
        _Group(self.path / row, self.version).ensure_group()
        well_group = _Group(self.path / row / col, self.version)
        well_group.ensure_group()

        meta = self._plate_meta() or {
            "acquisitions": [{"id": 0}],
            "rows": [],
            "columns": [],
            "wells": [],
            "field_count": 0,
            **({"version": self.version} if self.version == "0.4" else {}),
        }
        if row not in [r["name"] for r in meta["rows"]]:
            meta["rows"].append({"name": row})
        if col not in [c["name"] for c in meta["columns"]]:
            meta["columns"].append({"name": col})
        well_path = f"{row}/{col}"
        if well_path not in [w["path"] for w in meta["wells"]]:
            meta["wells"].append({
                "path": well_path,
                "rowIndex": [r["name"] for r in meta["rows"]].index(row),
                "columnIndex": [c["name"] for c in meta["columns"]].index(col),
            })
        self._set_plate_meta(meta)

        well_meta = well_group.zattrs.get("well", {"images": []})
        if self.version == "0.4":
            well_meta.setdefault("version", "0.4")
        existed = fov in [img["path"] for img in well_meta["images"]]
        if not existed:
            well_meta["images"].append({"path": fov})
            well_group.update_zattrs({"well": well_meta})
            meta["field_count"] = meta.get("field_count", 0) + 1
            self._set_plate_meta(meta)

        position = Position(self.path / row / col / fov, self.version)
        if not existed:
            names = channel_names if channel_names is not None else self._channels or []
            position._init_metadata(names)
        return position

    def print_tree(self) -> None:
        for name, pos in self.positions():
            print(f"{name}: { {n: pos[n].shape for n in pos.array_names()} }")


def _downsample_yx_2x(zyx: np.ndarray, method: str) -> np.ndarray:
    """Downsample the trailing (Y, X) axes by 2 with the given reduction."""
    Z, Y, X = zyx.shape
    if method == "stride":
        return zyx[:, ::2, ::2][:, : max(Y // 2, 1), : max(X // 2, 1)]
    Y2, X2 = max(Y // 2, 1), max(X // 2, 1)
    blocks = zyx[:, : Y2 * 2, : X2 * 2].reshape(Z, Y2, 2, X2, 2)
    if method == "mean":
        out = blocks.mean(axis=(2, 4))
    elif method == "max":
        out = blocks.max(axis=(2, 4))
    elif method == "min":
        out = blocks.min(axis=(2, 4))
    elif method == "median":
        out = np.median(blocks, axis=(2, 4))
    elif method == "mode":
        flat = blocks.transpose(0, 1, 3, 2, 4).reshape(Z, Y2, X2, 4)
        out = np.sort(flat, axis=-1)[..., 1]
    else:
        raise ValueError(f"Unknown pyramid method: {method}")
    return out.astype(zyx.dtype)


def _detect_version(path: Path) -> str:
    return "0.5" if (path / "zarr.json").exists() else "0.4"


def _is_position(path: Path) -> bool:
    return "multiscales" in _Group(path, _detect_version(path)).zattrs


def open_ome_zarr(
    path: str | Path,
    layout: Literal["auto", "hcs", "fov"] = "auto",
    mode: Literal["r", "r+", "a", "w", "w-"] = "r",
    channel_names: Sequence[str] | None = None,
    version: Literal["0.4", "0.5"] = "0.4",
):
    """Open (or create, modes ``w`` and ``w-``) an OME-Zarr HCS plate or a
    single position (``layout="fov"``)."""
    path = Path(path)
    if mode in ("w", "w-"):
        if path.exists():
            if mode == "w-":
                raise FileExistsError(path)
            shutil.rmtree(path)
        if layout in ("auto", "hcs"):
            plate = Plate(path, version)
            plate.ensure_group()
            plate._channels = list(channel_names or [])
            return plate
        position = Position(path, version)
        position._init_metadata(channel_names or [])
        return position
    if not path.exists():
        raise FileNotFoundError(path)
    detected = _detect_version(path)
    if _is_position(path):
        return Position(path, detected)
    plate = Plate(path, detected)
    plate._channels = list(channel_names) if channel_names else None
    return plate


def get_ome_zarr_version(path: str | Path) -> str:
    """The OME-Zarr version of an existing store."""
    return _detect_version(Path(path))


def create_empty_plate(
    store_path: str | Path,
    position_keys: Sequence[Sequence[str]],
    channel_names: Sequence[str],
    shape: Sequence[int],
    chunks: Sequence[int] | None = None,
    shards_ratio: Sequence[int] | None = None,
    scale: Sequence[float] | None = None,
    dtype=np.float32,
    version: Literal["0.4", "0.5"] = "0.4",
    metadata_sources: str | Path | None = None,
    metadata_keys: Sequence[str] | None = None,
    compressor: str | None = None,
) -> Plate:
    """Idempotently create an output plate with empty arrays for each position.

    Re-running with the same positions changes nothing; new positions are
    appended. Attributes whose keys match the ``metadata_keys`` fnmatch
    allowlist are copied from the same position of ``metadata_sources``
    (which may be of the other OME-Zarr version). ``shards_ratio`` and
    ``compressor`` are :meth:`Position.create_zeros`'. In a run of several
    processes the coordinator creates the plate while the others wait at a
    barrier.
    """
    from biahub_tpu_torch.parallel.distributed import barrier, is_coordinator, process_count

    args = (store_path, position_keys, channel_names, shape, chunks, shards_ratio, scale, dtype,
            version, metadata_sources, metadata_keys, compressor)
    if process_count() > 1:
        if not is_coordinator():
            barrier(f"plate-create:{store_path}")
            return open_ome_zarr(store_path, mode="r+")
        try:
            return _create_empty_plate_local(*args)
        finally:
            barrier(f"plate-create:{store_path}")
    return _create_empty_plate_local(*args)


def _create_empty_plate_local(store_path, position_keys, channel_names, shape, chunks,
                              shards_ratio, scale, dtype, version, metadata_sources,
                              metadata_keys, compressor) -> Plate:
    import fnmatch

    store_path = Path(store_path)
    plate = Plate(store_path, _detect_version(store_path) if store_path.exists() else version)
    plate.ensure_group()
    scale = list(scale) if scale is not None else [1.0] * len(shape)
    source_plate = None
    if metadata_sources is not None and Path(metadata_sources).exists():
        source_plate = open_ome_zarr(metadata_sources, mode="r")
    for key in position_keys:
        row, col, fov = (str(k) for k in key)
        position = plate.create_position(row, col, fov, channel_names=channel_names)
        if "0" not in position:
            position.create_zeros("0", shape, np.dtype(dtype), chunks=chunks,
                                  transform=[TransformationMeta(type="scale", scale=scale)],
                                  shards_ratio=shards_ratio, compressor=compressor)
        if source_plate is not None and metadata_keys:
            try:
                src_attrs = source_plate[f"{row}/{col}/{fov}"].zattrs
            except (KeyError, FileNotFoundError):
                src_attrs = {}
            carried = {k: v for k, v in src_attrs.items()
                       if any(fnmatch.fnmatch(k, pat) for pat in metadata_keys)}
            if carried:
                position.update_zattrs(carried)
    return plate
