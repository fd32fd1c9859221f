"""The zarr chunk codecs of the port's store, on numpy, ``ctypes`` and the
standard library.

- **zstd** through ``libzstd`` (found once by ``ctypes.util.find_library``;
  there is no fallback). ``ctypes`` releases the GIL during a call, so the
  store's thread pool compresses and decompresses chunks in parallel.
- **blosc1** chunks: this module's own reader (the 16-byte header, byte
  shuffle, bitshuffle, memcpyed chunks, split and unsplit streams, zstd and
  zlib inside) and writer (zstd, byte shuffle, one stream a block, a
  memcpyed chunk where compression does not pay). A chunk compressed with
  blosclz, lz4, lz4hc or snappy goes to ``libblosc``'s
  ``blosc_decompress_ctx`` where that library is found.
- **crc32c** (Castagnoli), table-driven.
- **zlib** and **gzip** through Python's modules.
- **sharding_indexed** (zarr v3): a shard holds inner chunks, each encoded
  by the inner chain, and an index of (offset, nbytes) uint64 pairs (C order
  of the inner grid, ``2**64 - 1`` for an empty chunk) encoded by ``bytes``
  then ``crc32c``, at the end of the shard or at its start.

A :class:`Chain` is one array's codecs after the ``bytes`` step (the dtype's
byte order is the caller's): ``decode(raw, nbytes)`` returns the chunk's
``nbytes`` bytes as a uint8 array, ``encode(buffer)`` the stored bytes.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import gzip
import struct
import threading
import zlib

import numpy as np

__all__ = [
    "Chain",
    "ShardLayout",
    "blosc_decode",
    "blosc_encode",
    "chain_from_v2",
    "chain_from_v3",
    "crc32c",
    "zstd_compress",
    "zstd_decompress",
]

_load_lock = threading.Lock()
_libs: dict = {}


def _library(name: str):
    """``lib<name>`` through ``ctypes``, loaded once; None where
    ``find_library`` finds none."""
    with _load_lock:
        if name not in _libs:
            path = ctypes.util.find_library(name)
            _libs[name] = None if path is None else ctypes.CDLL(path)
            if name == "zstd" and _libs[name] is not None:
                lib = _libs[name]
                size_t, vp = ctypes.c_size_t, ctypes.c_void_p
                lib.ZSTD_getFrameContentSize.argtypes = [vp, size_t]
                lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
                lib.ZSTD_decompress.argtypes = [vp, size_t, vp, size_t]
                lib.ZSTD_decompress.restype = size_t
                lib.ZSTD_compressBound.argtypes = [size_t]
                lib.ZSTD_compressBound.restype = size_t
                lib.ZSTD_compress.argtypes = [vp, size_t, vp, size_t, ctypes.c_int]
                lib.ZSTD_compress.restype = size_t
                lib.ZSTD_isError.argtypes = [size_t]
                lib.ZSTD_isError.restype = ctypes.c_uint
                lib.ZSTD_getErrorName.argtypes = [size_t]
                lib.ZSTD_getErrorName.restype = ctypes.c_char_p
            if name == "blosc" and _libs[name] is not None:
                lib = _libs[name]
                lib.blosc_decompress_ctx.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                                     ctypes.c_size_t, ctypes.c_int]
                lib.blosc_decompress_ctx.restype = ctypes.c_int
        return _libs[name]


def _zstd():
    lib = _library("zstd")
    if lib is None:
        raise RuntimeError("zstd chunks need the zstd library (libzstd), which "
                           "ctypes.util.find_library('zstd') does not find")
    return lib


def _address(buf) -> tuple[np.ndarray, int]:
    """``buf`` as a uint8 array (no copy) and the address of its first byte."""
    arr = np.frombuffer(buf, np.uint8) if not isinstance(buf, np.ndarray) else buf
    return arr, arr.ctypes.data


def _zstd_check(lib, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise ValueError(f"zstd {what}: {lib.ZSTD_getErrorName(code).decode()}")
    return code


_CONTENTSIZE_UNKNOWN = 2**64 - 1
_CONTENTSIZE_ERROR = 2**64 - 2


def zstd_decompress(src, nbytes: int, out: np.ndarray | None = None) -> np.ndarray:
    """The ``nbytes`` bytes that the zstd frames ``src`` hold, as a uint8
    array (``out`` where given: a contiguous uint8 array of ``nbytes``)."""
    lib = _zstd()
    src_arr, src_ptr = _address(src)
    size = lib.ZSTD_getFrameContentSize(src_ptr, src_arr.size)
    if size == _CONTENTSIZE_ERROR:
        raise ValueError("zstd decompress: not a zstd frame")
    if size != _CONTENTSIZE_UNKNOWN and size > nbytes:
        raise ValueError(f"zstd decompress: the frame holds {size} bytes, want {nbytes}")
    if out is None:
        out = np.empty(nbytes, np.uint8)
    n = _zstd_check(lib, lib.ZSTD_decompress(out.ctypes.data, nbytes, src_ptr, src_arr.size),
                    "decompress")
    if n != nbytes:
        raise ValueError(f"zstd decompress: {n} bytes, want {nbytes}")
    return out


def zstd_compress(src, level: int) -> bytes:
    """The zstd frame of ``src`` (a bytes-like object) at ``level``."""
    lib = _zstd()
    src_arr, src_ptr = _address(src)
    cap = lib.ZSTD_compressBound(src_arr.size)
    dst = np.empty(cap, np.uint8)
    n = _zstd_check(lib, lib.ZSTD_compress(dst.ctypes.data, cap, src_ptr, src_arr.size,
                                           int(level)), "compress")
    return dst[:n].tobytes()


# -- crc32c -------------------------------------------------------------------

def _crc_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data) -> int:
    """CRC-32C (Castagnoli, reflected polynomial 0x82F63B78) of ``data``."""
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in bytes(data):
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _strip_crc32c(raw, what: str):
    raw = memoryview(raw)
    if len(raw) < 4:
        raise ValueError(f"crc32c: the {what} is too short to hold its checksum")
    body, (stored,) = raw[:-4], struct.unpack("<I", raw[-4:])
    if crc32c(body) != stored:
        raise ValueError(f"crc32c: the {what}'s checksum does not match its bytes")
    return body


# -- blosc1 -------------------------------------------------------------------

_BLOSC_SHUFFLE, _BLOSC_MEMCPYED, _BLOSC_BITSHUFFLE, _BLOSC_NOSPLIT = 0x1, 0x2, 0x4, 0x10
_BLOSC_CODECS = {0: "blosclz", 1: "lz4", 2: "snappy", 3: "zlib", 4: "zstd"}
_BLOSC_OVERHEAD = 16
#: The writer's block: 256 KiB (rounded down to whole items).
BLOSC_BLOCK = 1 << 18


def _unshuffle(blocks: np.ndarray, typesize: int, out: np.ndarray) -> None:
    """Undo blosc's byte shuffle of the rows of ``blocks`` (blocks of one
    size) into ``out``: a block's whole items were stored byte plane by
    byte plane, its leftover bytes as they were. One strided copy a plane."""
    nb, bsize = blocks.shape
    n = bsize // typesize
    items = out[:, : n * typesize].reshape(nb, n, typesize)
    planes = blocks[:, : n * typesize].reshape(nb, typesize, n)
    for j in range(typesize):
        items[:, :, j] = planes[:, j, :]
    out[:, n * typesize:] = blocks[:, n * typesize:]


def _shuffle(blocks: np.ndarray, typesize: int, out: np.ndarray) -> None:
    """blosc's byte shuffle of the rows of ``blocks`` into ``out`` (the
    inverse of :func:`_unshuffle`)."""
    nb, bsize = blocks.shape
    n = bsize // typesize
    items = blocks[:, : n * typesize].reshape(nb, n, typesize)
    planes = out[:, : n * typesize].reshape(nb, typesize, n)
    for j in range(typesize):
        planes[:, j, :] = items[:, :, j]
    out[:, n * typesize:] = blocks[:, n * typesize:]


def _bitunshuffle(blocks: np.ndarray, typesize: int, out: np.ndarray) -> None:
    """Undo blosc's bitshuffle of the rows of ``blocks`` into ``out``: for
    each byte of an item and each of its bits, a row of that bit of every
    item (LSB first), over the block's whole items; the rest as it was. A
    block whose item count is not a multiple of 8 was stored as it was
    (c-blosc 1)."""
    nb, bsize = blocks.shape
    n = bsize // typesize
    if n % 8:
        out[...] = blocks
        return
    rows = blocks[:, : n * typesize].reshape(nb, typesize, 8, n // 8)
    bits = np.unpackbits(rows, axis=-1, bitorder="little")          # (nb, typesize, 8, n)
    out[:, : n * typesize] = np.packbits(bits.transpose(0, 3, 1, 2), axis=-1,
                                         bitorder="little").reshape(nb, n * typesize)
    out[:, n * typesize:] = blocks[:, n * typesize:]


def _blosc_header(raw) -> tuple[int, int, int, int, int, int]:
    if len(raw) < _BLOSC_OVERHEAD:
        raise ValueError("blosc: the chunk is shorter than its 16-byte header")
    version, _, flags, typesize, nbytes, blocksize, cbytes = struct.unpack_from(
        "<BBBBiii", raw, 0)
    if version == 0 or version > 2:
        raise ValueError(f"blosc: header version {version} is not blosc1's")
    if typesize == 0:
        raise ValueError("blosc: header typesize 0")
    return flags, typesize, nbytes, blocksize, cbytes, version


def _blosc_library_decode(raw, nbytes: int, codec: str) -> np.ndarray:
    lib = _library("blosc")
    if lib is None:
        raise ValueError(f"blosc: a chunk compressed with {codec} needs the blosc library "
                         "(libblosc), which ctypes.util.find_library('blosc') does not find")
    src, ptr = _address(raw)
    out = np.empty(nbytes, np.uint8)
    n = lib.blosc_decompress_ctx(ptr, out.ctypes.data, nbytes, 1)
    if n != nbytes:
        raise ValueError(f"blosc: libblosc could not decompress a {codec} chunk ({n})")
    return out


def blosc_decode(raw, typesize: int | None = None) -> np.ndarray:
    """The bytes of a blosc1 chunk, as a uint8 array. ``typesize``, where
    the metadata gives one, must agree with the header's where the chunk is
    shuffled."""
    flags, htype, nbytes, blocksize, cbytes, _ = _blosc_header(raw)
    if cbytes > len(raw):
        raise ValueError(f"blosc: the header says {cbytes} bytes, the chunk has {len(raw)}")
    if (typesize is not None and typesize != htype
            and flags & (_BLOSC_SHUFFLE | _BLOSC_BITSHUFFLE)):
        raise ValueError(f"blosc: the metadata's typesize {typesize} contradicts the "
                         f"header's {htype}")
    src = np.frombuffer(raw, np.uint8, count=cbytes)
    if flags & _BLOSC_MEMCPYED:
        if cbytes < _BLOSC_OVERHEAD + nbytes:
            raise ValueError("blosc: a memcpyed chunk shorter than its bytes")
        return src[_BLOSC_OVERHEAD:_BLOSC_OVERHEAD + nbytes].copy()
    if nbytes == 0:
        return np.empty(0, np.uint8)
    codec = _BLOSC_CODECS.get(flags >> 5, f"code {flags >> 5}")
    if codec not in ("zstd", "zlib"):
        return _blosc_library_decode(raw, nbytes, codec)
    if blocksize <= 0:
        raise ValueError(f"blosc: block size {blocksize}")
    nfull, leftover = divmod(nbytes, blocksize)
    nblocks = nfull + bool(leftover)
    starts = np.frombuffer(raw, "<i4", count=nblocks, offset=_BLOSC_OVERHEAD)
    doshuffle = bool(flags & _BLOSC_SHUFFLE) and htype > 1
    dobitshuffle = bool(flags & _BLOSC_BITSHUFFLE)
    # The streams' bytes (still shuffled), block after block.
    stored = np.empty(nbytes, np.uint8)
    for b in range(nblocks):
        last = b == nfull
        bsize = leftover if last else blocksize
        nsplits = htype if not (flags & _BLOSC_NOSPLIT) and not last else 1
        neblock = bsize // nsplits
        pos = int(starts[b])
        for j in range(nsplits):
            (clen,) = struct.unpack_from("<i", raw, pos)
            pos += 4
            if not 0 <= clen <= cbytes - pos:
                raise ValueError(f"blosc: a stream of {clen} bytes past the chunk's end")
            stream = src[pos:pos + clen]
            dest = stored[b * blocksize + j * neblock:b * blocksize + (j + 1) * neblock]
            if clen == neblock:
                dest[...] = stream
            elif codec == "zstd":
                zstd_decompress(stream, neblock, out=dest)
            else:
                dest[...] = np.frombuffer(zlib.decompress(stream), np.uint8, count=neblock)
            pos += clen
    if not (doshuffle or (dobitshuffle and blocksize >= htype)):
        return stored
    undo = _unshuffle if doshuffle else _bitunshuffle
    out = np.empty_like(stored)
    full = nfull * blocksize
    if nfull:
        undo(stored[:full].reshape(nfull, blocksize), htype, out[:full].reshape(nfull, blocksize))
    if leftover and (doshuffle or leftover >= htype):
        undo(stored[full:][None], htype, out[full:][None])
    elif leftover:
        out[full:] = stored[full:]
    return out


def blosc_encode(data, typesize: int, level: int = 1, shuffle: bool = True,
                 blocksize: int = BLOSC_BLOCK) -> bytes:
    """A blosc1 chunk of ``data``'s bytes as the reference writes them:
    zstd at ``level`` inside, byte shuffle over ``typesize``-byte items, one
    stream a block; memcpyed where that is no larger."""
    src = np.frombuffer(data, np.uint8)
    nbytes = src.size
    typesize = int(typesize)
    blocksize = max(typesize, min(blocksize, nbytes) // typesize * typesize)
    flags = (4 << 5) | _BLOSC_NOSPLIT | (_BLOSC_SHUFFLE if shuffle and typesize > 1 else 0)
    nfull, leftover = divmod(nbytes, blocksize)
    shuffled = src
    if flags & _BLOSC_SHUFFLE:
        shuffled = np.empty_like(src)
        full = nfull * blocksize
        _shuffle(src[:full].reshape(nfull, blocksize), typesize,
                 shuffled[:full].reshape(nfull, blocksize))
        _shuffle(src[full:][None], typesize, shuffled[full:][None])
    nblocks = nfull + bool(leftover)
    offset = _BLOSC_OVERHEAD + 4 * nblocks
    starts, streams = [], []
    for b in range(nblocks):
        block = shuffled[b * blocksize:(b + 1) * blocksize]
        packed = zstd_compress(block, level)
        if len(packed) >= block.size:
            packed = block.tobytes()
        starts.append(offset)
        streams += [struct.pack("<i", len(packed)), packed]
        offset += 4 + len(packed)
        if offset >= _BLOSC_OVERHEAD + nbytes:
            break
    if nbytes == 0 or offset >= _BLOSC_OVERHEAD + nbytes:
        head = struct.pack("<BBBBiii", 2, 1, flags | _BLOSC_MEMCPYED, typesize, nbytes,
                           blocksize, _BLOSC_OVERHEAD + nbytes)
        return b"".join([head, src])
    head = struct.pack("<BBBBiii", 2, 1, flags, typesize, nbytes, blocksize, offset)
    return b"".join([head, np.asarray(starts, "<i4").tobytes(), *streams])


# -- codec chains ----------------------------------------------------------------

class Chain:
    """The codecs of one array after its ``bytes`` step: ``steps`` is a
    list of (name, configuration) pairs, applied in order on write and in
    reverse on read; ``raw`` is True for a chain of none."""

    def __init__(self, steps: list[tuple[str, dict]]):
        self.steps = list(steps)

    @property
    def raw(self) -> bool:
        return not self.steps

    def __repr__(self) -> str:
        return f"Chain({[name for name, _ in self.steps]})"

    def decode(self, raw, nbytes: int, out: np.ndarray | None = None) -> np.ndarray:
        """The ``nbytes`` bytes of a stored chunk as a uint8 array (written
        into ``out`` where the last step can)."""
        buf = raw
        for i, (name, cfg) in enumerate(reversed(self.steps)):
            last = i == len(self.steps) - 1
            if name == "crc32c":
                buf = _strip_crc32c(buf, "chunk")
            elif name == "zstd":
                buf = zstd_decompress(buf, nbytes, out=out if last else None)
            elif name == "blosc":
                buf = blosc_decode(buf, cfg.get("typesize"))
            elif name == "zlib":
                buf = zlib.decompress(buf)
            elif name == "gzip":
                buf = gzip.decompress(buf)
        arr = np.frombuffer(buf, np.uint8) if not isinstance(buf, np.ndarray) else buf
        if arr.size != nbytes:
            raise ValueError(f"{self!r}: a chunk of {arr.size} bytes, want {nbytes}")
        if out is not None and arr is not out:
            out[...] = arr
            return out
        return arr

    def encode(self, data: np.ndarray) -> bytes | memoryview:
        """The stored bytes of a C-contiguous chunk ``data``."""
        buf = memoryview(data).cast("B")
        for name, cfg in self.steps:
            if name == "zstd":
                buf = zstd_compress(buf, cfg.get("level", 0))
            elif name == "blosc":
                buf = blosc_encode(buf, cfg["typesize"], cfg.get("clevel", 1),
                                   cfg.get("shuffle", 1) != 0)
            elif name == "zlib":
                buf = zlib.compress(bytes(buf), cfg.get("level", 1))
            elif name == "gzip":
                buf = gzip.compress(bytes(buf), cfg.get("level", 1))
            elif name == "crc32c":
                buf = bytes(buf) + struct.pack("<I", crc32c(buf))
        return buf


def chain_from_v2(compressor: dict | None, filters, dtype: np.dtype, path) -> Chain:
    """The chain of a zarr v2 array: no compressor, ``blosc``, ``zlib`` or
    ``gzip``; filters and other compressors raise with their names."""
    for flt in filters or []:
        raise ValueError(f"{path}: zarr v2 filter {flt.get('id')!r} is not supported")
    if compressor is None:
        return Chain([])
    name = compressor.get("id")
    if name == "blosc":
        shuffle = compressor.get("shuffle", 1)
        if shuffle == -1:  # numcodecs' AUTOSHUFFLE
            shuffle = 2 if dtype.itemsize == 1 else 1
        return Chain([("blosc", {"typesize": dtype.itemsize, "shuffle": shuffle,
                                 "clevel": compressor.get("clevel", 5),
                                 "cname": compressor.get("cname", "lz4")})])
    if name in ("zlib", "gzip"):
        return Chain([(name, {"level": compressor.get("level", 1)})])
    raise ValueError(f"{path}: zarr v2 compressor {name!r} is not supported (uncompressed, "
                     "blosc, zlib and gzip chunks are read)")


_V3_COMPRESSORS = ("blosc", "zstd", "gzip")
_V3_SHUFFLE = {"noshuffle": 0, "shuffle": 1, "bitshuffle": 2}


def _v3_steps(codecs: list, dtype: np.dtype, path, where: str) -> tuple[str, list]:
    """The endian of a v3 chain ``bytes``, at most one of ``blosc``,
    ``zstd`` or ``gzip``, optionally ``crc32c``; and its steps."""
    names = [c.get("name") for c in codecs]
    compressors = [n for n in names[1:2] if n in _V3_COMPRESSORS]
    rest = names[1 + len(compressors):]
    if names[:1] != ["bytes"] or rest not in ([], ["crc32c"]):
        raise ValueError(f"{path}: zarr v3 {where}codecs {names} are not supported: bytes, "
                         "then at most one of blosc, zstd or gzip, then optionally crc32c")
    endian = (codecs[0].get("configuration") or {}).get("endian", "little")
    steps = []
    for codec in codecs[1:]:
        cfg = dict(codec.get("configuration") or {})
        if codec["name"] == "blosc":
            shuffle = cfg.get("shuffle", "noshuffle")
            cfg["shuffle"] = _V3_SHUFFLE.get(shuffle, shuffle)
            cfg.setdefault("typesize", dtype.itemsize)
        steps.append((codec["name"], cfg))
    return endian, steps


class ShardLayout:
    """A ``sharding_indexed`` codec: the inner chunk shape, where the index
    lies and whether a crc32c checks it (the inner chain is the array's
    :class:`Chain`)."""

    def __init__(self, chunk_shape, index_crc: bool, at_end: bool):
        self.chunk_shape = tuple(int(c) for c in chunk_shape)
        self.index_crc = index_crc
        self.at_end = at_end

    def per_shard(self, shard_shape) -> tuple[int, ...]:
        return tuple(s // c for s, c in zip(shard_shape, self.chunk_shape))

    def index_nbytes(self, n: int) -> int:
        return 16 * n + (4 if self.index_crc else 0)

    def read_index(self, f, n: int) -> np.ndarray:
        """The (n, 2) uint64 index of the open shard ``f``."""
        size = self.index_nbytes(n)
        if self.at_end:
            f.seek(-size, 2)
        else:
            f.seek(0)
        raw = f.read(size)
        if len(raw) != size:
            raise ValueError(f"sharding_indexed: a shard too short for its index of {n}")
        body = _strip_crc32c(raw, "shard index") if self.index_crc else raw
        return np.frombuffer(body, "<u8").reshape(n, 2)

    def assemble(self, encoded: list) -> bytes:
        """A shard of the encoded inner chunks (None: empty), C order."""
        n = len(encoded)
        index = np.full((n, 2), np.uint64(2**64 - 1), "<u8")
        offset = 0 if self.at_end else self.index_nbytes(n)
        parts = []
        for i, chunk in enumerate(encoded):
            if chunk is None:
                continue
            index[i] = (offset, len(chunk))
            parts.append(chunk)
            offset += len(chunk)
        head = index.tobytes()
        if self.index_crc:
            head += struct.pack("<I", crc32c(head))
        return b"".join(parts + [head] if self.at_end else [head] + parts)


def chain_from_v3(codecs: list, dtype: np.dtype, path) -> tuple[str, Chain, ShardLayout | None]:
    """The endian, the chain (of the inner chunks where sharded) and the
    shard layout (None: unsharded) of a zarr v3 array's codecs; anything outside the supported chains raises
    with its name."""
    names = [c.get("name") for c in codecs]
    if names == ["sharding_indexed"]:
        cfg = codecs[0].get("configuration") or {}
        endian, steps = _v3_steps(cfg.get("codecs", []), dtype, path, "sharding_indexed inner ")
        index_names = [c.get("name") for c in cfg.get("index_codecs", [])]
        index_endian = ((cfg.get("index_codecs") or [{}])[0].get("configuration")
                        or {}).get("endian", "little")
        if index_names not in (["bytes"], ["bytes", "crc32c"]) or index_endian != "little":
            raise ValueError(f"{path}: zarr v3 sharding_indexed index_codecs {index_names} are "
                             "not supported: little-endian bytes, then optionally crc32c")
        location = cfg.get("index_location", "end")
        if location not in ("end", "start"):
            raise ValueError(f"{path}: sharding_indexed index_location {location!r}")
        return endian, Chain(steps), ShardLayout(cfg["chunk_shape"], index_names[-1] == "crc32c",
                                                 location == "end")
    if "sharding_indexed" in names:
        raise ValueError(f"{path}: zarr v3 codecs {names}: sharding_indexed must be the only "
                         "codec")
    endian, steps = _v3_steps(codecs, dtype, path, "")
    return endian, Chain(steps), None
