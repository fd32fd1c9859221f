"""biahub_tpu_torch's chunk codecs and its store against tensorstore and the
reference's plates.

- The port reads, bit-equal, the chunks tensorstore writes: zarr v2 blosc
  (zstd under each shuffle, zlib, lz4 through libblosc), v3 ``bytes`` +
  ``zstd``, v3 ``blosc`` and v3 ``sharding_indexed`` at two shard ratios,
  with chunks left absent and inner chunks left empty, over four dtypes,
  incompressible (memcpyed) and compressible data.
- blosc chunks that libblosc itself writes, split and unsplit, each
  shuffle, each item size and a leftover block, read bit-equal.
- tensorstore reads the port's three written layouts bit-equal, and their
  metadata is the reference's, codecs included.
- crc32c's known value; a corrupted shard index fails naming crc32c.
- The reference's own plates (its defaults, both versions) go through the
  port's deskew and fuse verbs bit-equal to an uncompressed copy.
- Without libblosc, an lz4 chunk raises naming lz4; without libzstd, a zstd
  chunk raises naming zstd and libzstd; a blosc typesize that the chunk's
  header contradicts raises.
- Threads writing disjoint parts of the same shards lose nothing.
"""

import ctypes
import ctypes.util
import json
import sys

import numpy as np
import pytest
import tensorstore as ts
import torch
import yaml

from biahub_tpu.io import ngff as ref
from biahub_tpu_torch.cli.main import main
from biahub_tpu_torch.io import codecs, ngff

SHAPE = (2, 1, 5, 12, 20)
CHUNKS = [1, 1, 2, 12, 20]
DTYPES = ["uint8", "uint16", "float32", "float64"]

V2 = {
    "blosc-zstd-noshuffle": {"id": "blosc", "cname": "zstd", "clevel": 1, "shuffle": 0,
                             "blocksize": 0},
    "blosc-zstd-shuffle": {"id": "blosc", "cname": "zstd", "clevel": 1, "shuffle": 1,
                           "blocksize": 1000},
    "blosc-zstd-bitshuffle": {"id": "blosc", "cname": "zstd", "clevel": 3, "shuffle": 2,
                              "blocksize": 1000},
    "blosc-zlib": {"id": "blosc", "cname": "zlib", "clevel": 5, "shuffle": 1, "blocksize": 0},
    "blosc-lz4": {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 1, "blocksize": 0},
}
BYTES = {"name": "bytes", "configuration": {"endian": "little"}}
V3 = {
    "bytes-zstd": [BYTES, {"name": "zstd", "configuration": {"level": 3, "checksum": True}}],
    "bytes-blosc": [BYTES, {"name": "blosc", "configuration": {
        "cname": "zstd", "clevel": 1, "shuffle": "bitshuffle", "blocksize": 0}}],
}
SHARDS = {"shards-11111": ([1, 1, 1, 1, 1], CHUNKS), "shards-11222": ([1, 1, 2, 2, 2],
                                                                     [1, 1, 2, 6, 10])}


def sample(dtype: str, kind: str, shape=SHAPE) -> np.ndarray:
    """Uniform random bytes (blosc's memcpyed route) or a camera-like field:
    Poisson noise around a smooth field with an offset of 100."""
    rng = np.random.default_rng(7)
    dt = np.dtype(dtype)
    if kind == "random":
        return rng.integers(0, 256, size=shape + (dt.itemsize,), dtype=np.uint8).view(
            dt).reshape(shape)
    zz, yy, xx = np.meshgrid(*[np.linspace(0, 1, n) for n in shape[2:]], indexing="ij")
    field = 100 + 40 * np.sin(3 * yy) * np.cos(2 * xx) + 10 * zz
    return (rng.poisson(np.broadcast_to(field, shape)) % 250).astype(dt)


def same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def ts_spec(path, version, dtype, codec, chunks=CHUNKS, shards=None) -> dict:
    if version == "0.4":
        meta = {"shape": list(SHAPE), "chunks": chunks, "dtype": np.dtype(dtype).str,
                "compressor": codec, "fill_value": 0}
        return {"driver": "zarr", "kvstore": {"driver": "file", "path": str(path)},
                "metadata": meta}
    codecs_ = codec
    grid = chunks
    if shards is not None:
        grid = [c * r for c, r in zip(chunks, shards)]
        codecs_ = [{"name": "sharding_indexed", "configuration": {
            "chunk_shape": chunks,
            "codecs": [BYTES, {"name": "zstd", "configuration": {"level": 1}}],
            "index_codecs": [BYTES, {"name": "crc32c"}]}}]
    meta = {"shape": list(SHAPE), "data_type": dtype, "codecs": codecs_,
            "chunk_grid": {"name": "regular", "configuration": {"chunk_shape": grid}}}
    return {"driver": "zarr3", "kvstore": {"driver": "file", "path": str(path)},
            "metadata": meta}


CASES = ([("0.4", name, codec, None, CHUNKS) for name, codec in V2.items()]
         + [("0.5", name, codec, None, CHUNKS) for name, codec in V3.items()]
         + [("0.5", name, None, ratio, chunks) for name, (ratio, chunks) in SHARDS.items()])


@pytest.mark.parametrize("kind", ["random", "smooth"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("version,name,codec,shards,chunks", CASES, ids=[c[1] for c in CASES])
def test_reads_what_tensorstore_writes(tmp_path, version, name, codec, shards, chunks, dtype,
                                       kind):
    data = sample(dtype, kind)
    store = ts.open(ts_spec(tmp_path / "a", version, dtype, codec, chunks, shards),
                    create=True, delete_existing=True).result()
    # All of t 0, and the first two Z slices of t 1: the rest of t 1 is
    # absent chunks (or a whole absent shard and empty inner chunks).
    store[0].write(data[0]).result()
    store[1, :, :2].write(data[1, :, :2]).result()
    want = data.copy()
    want[1, :, 2:] = 0
    arr = ngff.ImageArray(tmp_path / "a")
    assert arr.chunks == tuple(chunks) and arr.dtype == np.dtype(dtype)
    assert same_bits(arr[...], want)
    assert same_bits(arr[1, 0, 1:4, 3:9, 5:17], want[1, 0, 1:4, 3:9, 5:17])
    if shards == [1, 1, 2, 2, 2]:
        # A box of one inner chunk of a shard.
        assert same_bits(arr[0, 0, 0:2, 0:6, 0:10], want[0, 0, 0:2, 0:6, 0:10])


def _libblosc_chunk(data: np.ndarray, typesize: int, cname: str, shuffle: int, split: bool,
                    blocksize: int) -> bytes:
    lib = ctypes.CDLL(ctypes.util.find_library("blosc"))
    lib.blosc_init()
    lib.blosc_set_compressor(cname.encode())
    lib.blosc_set_blocksize(ctypes.c_size_t(blocksize))
    lib.blosc_set_splitmode(1 if split else 2)  # BLOSC_ALWAYS_SPLIT, BLOSC_NEVER_SPLIT
    lib.blosc_set_nthreads(1)
    src = np.ascontiguousarray(data).view(np.uint8).ravel()
    dest = np.empty(src.size + 16, np.uint8)
    n = lib.blosc_compress(5, shuffle, ctypes.c_size_t(typesize), ctypes.c_size_t(src.size),
                           src.ctypes.data_as(ctypes.c_void_p),
                           dest.ctypes.data_as(ctypes.c_void_p), ctypes.c_size_t(dest.size))
    lib.blosc_set_splitmode(4)  # back to c-blosc's default
    assert n > 0
    return dest[:n].tobytes()


@pytest.mark.parametrize("split", [True, False], ids=["split", "unsplit"])
@pytest.mark.parametrize("cname", ["zstd", "zlib"])
def test_reads_libblosc_chunks_split_and_unsplit(cname, split):
    for dtype in DTYPES:
        for kind in ("random", "smooth"):
            data = sample(dtype, kind, (1, 1, 3, 17, 23))  # leftover bytes at 1000 a block
            for shuffle in (0, 1, 2):
                for blocksize in (0, 1000):
                    raw = _libblosc_chunk(data, data.itemsize, cname, shuffle, split, blocksize)
                    got = codecs.blosc_decode(raw)
                    assert got.tobytes() == data.tobytes(), (dtype, kind, shuffle, blocksize)


@pytest.mark.parametrize("kind", ["random", "smooth"])
@pytest.mark.parametrize("dtype", ["uint16", "float32"])
@pytest.mark.parametrize("layout", ["0.4 zstd", "0.5 zstd", "0.5 shards-11111",
                                    "0.5 shards-11222"])
def test_tensorstore_reads_what_the_port_writes(tmp_path, layout, dtype, kind):
    version, name = layout.split()
    ratio, chunks = SHARDS.get(name, (None, CHUNKS))
    data = sample(dtype, kind)
    for mod, root in ((ngff, "port"), (ref, "ref")):
        pos = mod.open_ome_zarr(tmp_path / f"{root}.zarr", layout="fov", mode="w",
                                channel_names=["a"], version=version)
        if mod is ngff:
            arr = pos.create_zeros("0", SHAPE, dtype, chunks=chunks, shards_ratio=ratio,
                                   compressor=None if ratio else "zstd")
        else:
            arr = pos.create_zeros("0", SHAPE, dtype, chunks=chunks, shards_ratio=ratio)
        arr[0] = data[0]
        arr[1, :, 1:4] = data[1, :, 1:4]  # a partial shard: read, modified, written
        arr[1, :, :1] = data[1, :, :1]
    want = data.copy()
    want[1, :, 4:] = 0
    meta = ".zarray" if version == "0.4" else "zarr.json"
    assert (json.loads((tmp_path / "port.zarr" / "0" / meta).read_text())
            == json.loads((tmp_path / "ref.zarr" / "0" / meta).read_text()))
    got = ts.open({"driver": "zarr3" if version == "0.5" else "zarr",
                   "kvstore": {"driver": "file", "path": str(tmp_path / "port.zarr" / "0")}},
                  open=True).result().read().result()
    assert same_bits(np.asarray(got), want)
    assert same_bits(ngff.open_ome_zarr(tmp_path / "port.zarr").data[...], want)
    assert same_bits(ngff.open_ome_zarr(tmp_path / "ref.zarr").data[...], want)


def test_crc32c_and_a_corrupted_shard_index(tmp_path):
    assert codecs.crc32c(b"123456789") == 0xE3069283
    assert codecs.crc32c(b"") == 0
    data = sample("uint16", "smooth")
    pos = ngff.open_ome_zarr(tmp_path / "p.zarr", layout="fov", mode="w", channel_names=["a"],
                             version="0.5")
    pos.create_image("0", data, chunks=[1, 1, 2, 6, 10], shards_ratio=[1, 1, 2, 2, 2])
    shard = tmp_path / "p.zarr" / "0" / "c" / "0" / "0" / "0" / "0" / "0"
    raw = bytearray(shard.read_bytes())
    raw[-10] ^= 0x40  # a bit of the index's last entry
    shard.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="crc32c"):
        ngff.open_ome_zarr(tmp_path / "p.zarr").data[0, 0, :2]
    np.testing.assert_array_equal(ngff.open_ome_zarr(tmp_path / "p.zarr").data[1], data[1])


@pytest.mark.parametrize("hidden", ["blosc", "zstd"])
def test_lz4_without_libblosc_raises_with_its_name(tmp_path, monkeypatch, hidden):
    """A missing library is named: an lz4 blosc chunk without libblosc, any
    zstd chunk without libzstd; there is no fallback."""
    codec = V2["blosc-lz4"] if hidden == "blosc" else {"id": "blosc", "cname": "zstd",
                                                         "clevel": 1, "shuffle": 1}
    store = ts.open(ts_spec(tmp_path / "a", "0.4", "uint16", codec), create=True,
                    delete_existing=True).result()
    data = sample("uint16", "smooth")
    store.write(data).result()
    assert same_bits(ngff.ImageArray(tmp_path / "a")[...], data)
    find = ctypes.util.find_library
    monkeypatch.setattr(codecs, "_libs", {})
    monkeypatch.setattr(ctypes.util, "find_library",
                        lambda name: None if name == hidden else find(name))
    with pytest.raises((ValueError, RuntimeError),
                       match="lz4.*libblosc" if hidden == "blosc" else "zstd.*libzstd"):
        ngff.ImageArray(tmp_path / "a")[...]


def test_a_typesize_the_header_contradicts_raises(tmp_path):
    spec = ts_spec(tmp_path / "a", "0.5", "uint16", V3["bytes-blosc"])
    ts.open(spec, create=True, delete_existing=True).result().write(
        sample("uint16", "smooth")).result()
    meta_path = tmp_path / "a" / "zarr.json"
    meta = json.loads(meta_path.read_text())
    meta["codecs"][1]["configuration"]["typesize"] = 4
    meta_path.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="typesize 4 contradicts"):
        ngff.ImageArray(tmp_path / "a")[...]


def test_concurrent_partial_writes_to_one_shard(tmp_path):
    """Threads writing disjoint parts of the same shards (each write reads,
    modifies and replaces its shard under the array's lock) lose nothing."""
    data = sample("float32", "random", (1, 1, 16, 12, 20))
    pos = ngff.open_ome_zarr(tmp_path / "p.zarr", layout="fov", mode="w", channel_names=["a"],
                             version="0.5")
    arr = pos.create_zeros("0", data.shape, np.float32, chunks=[1, 1, 1, 6, 10],
                           shards_ratio=[1, 1, 8, 2, 2])
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        futures = [arr.write_async((0, 0, z), data[0, 0, z]) for z in range(16)]
        for f in futures:
            f.result(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert same_bits(ngff.open_ome_zarr(tmp_path / "p.zarr").data[...], data)


FILL = {"pixel_size_um": 0.116, "ls_angle_deg": 36.17, "px_to_scan_ratio": 0.371,
        "keep_overhang": True, "overhang_fill": "mean", "average_n_slices": 3}
FUSE = {"flat_field": {"channel_names": ["GFP"]},
        "deconvolve": {"regularization_strength": 1e-3}, "deskew": FILL}
SCALE = [1.0, 1.0, 1.0, 0.116, 0.116]


@pytest.mark.parametrize("version", ["0.4", "0.5"])
def test_reference_plates_through_the_port_verbs(tmp_path, version):
    """The reference's default layout (v2 blosc zstd, v3 bytes + zstd) as
    the deskew and fuse verbs' input: bit-equal to an uncompressed copy."""
    data = sample("uint16", "smooth", (2, 2, 8, 12, 24))
    zz, yy, xx = np.meshgrid(*[np.arange(s) - (s - 1) / 2 for s in (3, 5, 5)], indexing="ij")
    psf = np.exp(-(zz ** 2 + yy ** 2 + xx ** 2) / 2).astype(np.float32)
    for mod, root in ((ref, "ref"), (ngff, "port")):
        plate = mod.open_ome_zarr(tmp_path / f"{root}.zarr", layout="hcs", mode="w",
                                  channel_names=["GFP", "RFP"], version=version)
        plate.create_position("A", "1", "0").create_image(
            "0", data, transform=[mod.TransformationMeta(type="scale", scale=SCALE)])
        psf_plate = mod.open_ome_zarr(tmp_path / f"{root}_psf.zarr", layout="hcs", mode="w",
                                      channel_names=["PSF"], version=version)
        psf_plate.create_position("0", "0", "0").create_image(
            "0", psf[None, None], transform=[mod.TransformationMeta(type="scale", scale=SCALE)])
    assert ngff.ImageArray(tmp_path / "ref.zarr" / "A/1/0/0")._meta.compressor.steps
    for name, settings in (("deskew", FILL), ("fuse", FUSE)):
        (tmp_path / f"{name}.yml").write_text(yaml.safe_dump(settings))
        outs = []
        for root in ("ref", "port"):
            out = tmp_path / f"{name}_{root}_out.zarr"
            args = [name, "-i", str(tmp_path / f"{root}.zarr" / "A/1/0"), "-c",
                    str(tmp_path / f"{name}.yml"), "-o", str(out), "--cluster", "debug"]
            if name == "fuse":
                args += ["-p", str(tmp_path / f"{root}_psf.zarr")]
            threads = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                assert main(args, device="cpu") == 0
            finally:
                torch.set_num_threads(threads)
            outs.append(ngff.open_ome_zarr(out / "A/1/0").data[...])
        assert same_bits(outs[0], outs[1]), name
