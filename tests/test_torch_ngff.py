"""biahub_tpu_torch's OME-Zarr store against biahub_tpu's (tensorstore).

The port writes uncompressed zarr v2 (OME-Zarr 0.4) and v3 (0.5) plates
that the reference reads back equal, with the reference's attributes;
it reads uncompressed, zlib (v2) and gzip (v3) chunks that tensorstore
wrote, and raises on a codec outside its chains, naming it. Resume records follow
the reference's layout and rules.
"""

import json

import numpy as np
import pytest
import tensorstore as ts

from biahub_tpu.io import ngff as ref
from biahub_tpu_torch.io import ngff
from biahub_tpu_torch.io.progress import ProgressStore

SCALE = [1.0, 1.0, 2.0, 0.5, 0.25]


def write_same(mod, path, version, data, layout="hcs"):
    """The same calls through either package."""
    if layout == "fov":
        pos = mod.open_ome_zarr(path, layout="fov", mode="w", channel_names=["PSF"],
                                version=version)
        pos.create_image("0", data, chunks=(1, 1, 2) + data.shape[3:],
                         transform=[mod.TransformationMeta(type="scale", scale=SCALE)])
        return pos
    plate = mod.open_ome_zarr(path, layout="hcs", mode="w", channel_names=["a", "b"],
                              version=version)
    for row, col in (("A", "1"), ("B", "3")):
        pos = plate.create_position(row, col, "0")
        pos.create_image("0", data, transform=[mod.TransformationMeta(type="scale",
                                                                      scale=SCALE)])
        pos.update_zattrs({"biahub-test": {"row": row}})
    return plate


def metadata(root):
    """Every JSON document under ``root`` by path, the array codecs left out."""
    out = {}
    for f in sorted(root.rglob("*")):
        if f.name in (".zattrs", ".zgroup", ".zarray", "zarr.json"):
            doc = json.loads(f.read_text())
            for key in ("compressor", "codecs", "filters", "dimension_separator", "order",
                        "chunk_key_encoding"):
                doc.pop(key, None)
            out[str(f.relative_to(root))] = doc
    return out


@pytest.mark.parametrize("version", ["0.4", "0.5"])
@pytest.mark.parametrize("dtype", [np.float32, np.uint16])
@pytest.mark.parametrize("layout", ["hcs", "fov"])
def test_port_plates_read_back_equal_by_the_reference(tmp_path, monkeypatch, version, dtype,
                                                      layout):
    # 7 Z slices of 20 x 24: chunks of 4 then 3 slices (the Z split).
    data = (np.random.default_rng(1).random((2, 2, 7, 20, 24)) * 1000).astype(dtype)
    monkeypatch.setattr(ngff, "MAX_CHUNK_BYTES", 4 * 20 * 24 * np.dtype(dtype).itemsize)
    monkeypatch.setattr(ref, "MAX_CHUNK_BYTES", 4 * 20 * 24 * np.dtype(dtype).itemsize)
    write_same(ngff, tmp_path / "port.zarr", version, data, layout)
    write_same(ref, tmp_path / "ref.zarr", version, data, layout)
    keys = ["A/1/0", "B/3/0"] if layout == "hcs" else [""]
    for key in keys:
        arr = ref.open_ome_zarr(tmp_path / "port.zarr" / key).data
        if layout == "hcs":
            assert arr.chunks == (1, 1, 4, 20, 24)
        np.testing.assert_array_equal(arr[...], data)
        np.testing.assert_array_equal(ngff.open_ome_zarr(tmp_path / "port.zarr" / key).data[...],
                                      data)
    assert metadata(tmp_path / "port.zarr") == metadata(tmp_path / "ref.zarr")
    assert ngff.get_ome_zarr_version(tmp_path / "port.zarr") == version


def test_selections_and_partial_writes(tmp_path):
    data = np.arange(2 * 3 * 5 * 6 * 7, dtype=np.float32).reshape(2, 3, 5, 6, 7)
    pos = ngff.open_ome_zarr(tmp_path / "p.zarr", layout="fov", mode="w",
                             channel_names=["a", "b", "c"])
    arr = pos.create_zeros("0", data.shape, np.float32, chunks=(1, 1, 2, 4, 3))
    assert not np.any(arr[...])  # absent chunks read as the fill value
    arr[...] = data
    for key in [(1, 2), (0, [0, 2], slice(1, 4)), (Ellipsis, slice(2, 5)), (-1, 1, 4, -1),
                (slice(None), [2, 1], 0, slice(3, 6), slice(1, 7))]:
        np.testing.assert_array_equal(arr[key], data[key])
    arr[1, [0, 2], 1:4, 2:5, 1:6] = -1.0
    data[1, [0, 2], 1:4, 2:5, 1:6] = -1.0
    arr.write_async((0, 1), data[0, 1] * 3).result()
    data[0, 1] *= 3
    np.testing.assert_array_equal(arr[...], data)
    out = np.empty((5, 6, 7), np.float32)
    assert arr.read_into_async((1, 1), out).result() is out
    np.testing.assert_array_equal(out, data[1, 1])
    np.testing.assert_array_equal(ref.open_ome_zarr(tmp_path / "p.zarr").data[...], data)
    assert not list(tmp_path.rglob("*.tmp"))  # every chunk renamed over its key


@pytest.mark.parametrize("version,codec", [("0.4", {"id": "zlib", "level": 5}),
                                           ("0.4", {"id": "gzip", "level": 5}),
                                           ("0.5", {"name": "gzip",
                                                    "configuration": {"level": 5}})])
def test_reads_zlib_and_gzip_chunks_written_by_tensorstore(tmp_path, version, codec):
    data = np.random.default_rng(2).random((2, 1, 3, 8, 10)).astype(np.float32)
    pos = ngff.open_ome_zarr(tmp_path / "p.zarr", layout="fov", mode="w",
                             channel_names=["a"], version=version)
    pos.create_zeros("0", data.shape, np.float32, chunks=(1, 1, 2, 8, 10))
    path = str(tmp_path / "p.zarr" / "0")
    if version == "0.4":
        meta = {"shape": list(data.shape), "chunks": [1, 1, 2, 8, 10], "dtype": "<f4",
                "compressor": codec, "fill_value": 0}
        spec = {"driver": "zarr", "kvstore": {"driver": "file", "path": path}, "metadata": meta}
    else:
        meta = {"shape": list(data.shape), "data_type": "float32",
                "chunk_grid": {"name": "regular",
                               "configuration": {"chunk_shape": [1, 1, 2, 8, 10]}},
                "codecs": [{"name": "bytes", "configuration": {"endian": "little"}}, codec]}
        spec = {"driver": "zarr3", "kvstore": {"driver": "file", "path": path},
                "metadata": meta}
    store = ts.open(spec, create=True, delete_existing=True).result()
    store.write(data).result()
    np.testing.assert_array_equal(ngff.open_ome_zarr(tmp_path / "p.zarr").data[...], data)


_V3_INNER = [{"name": "transpose", "configuration": {"order": [4, 3, 2, 1, 0]}},
             {"name": "bytes", "configuration": {"endian": "little"}}]


@pytest.mark.parametrize("version,names", [
    ("0.4", (("filters", [{"id": "delta", "dtype": "<f4"}], "delta"),
             ("compressor", {"id": "lz4", "acceleration": 1}, "lz4"))),
    ("0.5", (("codecs", _V3_INNER, "transpose"),
             ("codecs", [{"name": "sharding_indexed", "configuration": {
                 "chunk_shape": [1, 1, 2, 4, 4], "codecs": _V3_INNER,
                 "index_codecs": [{"name": "bytes", "configuration": {"endian": "little"}},
                                  {"name": "crc32c"}]}}], "transpose")))])
def test_other_codecs_raise_with_their_name(tmp_path, version, names):
    """Codecs, filters and chains outside the store's raise, naming them
    (the reference's own layouts are read: tests/test_torch_codecs.py)."""
    data = np.ones((1, 1, 2, 4, 4), np.float32)
    write_same(ref, tmp_path / "ref.zarr", version, data)
    np.testing.assert_array_equal(ngff.open_ome_zarr(tmp_path / "ref.zarr" / "A/1/0").data[...],
                                  data)
    meta_name = "zarr.json" if version == "0.5" else ".zarray"
    meta_path = tmp_path / "ref.zarr" / "A/1/0/0" / meta_name
    written = json.loads(meta_path.read_text())
    for key, value, name in names:
        meta = dict(written, **{key: value})
        meta_path.write_text(json.dumps(meta))
        with pytest.raises(ValueError, match=name):
            ngff.open_ome_zarr(tmp_path / "ref.zarr" / "A/1/0").data[...]


def test_big_endian_and_nested_v2_chunks(tmp_path):
    data = np.random.default_rng(3).random((1, 1, 2, 3, 4))
    pos = ngff.open_ome_zarr(tmp_path / "p.zarr", layout="fov", mode="w", channel_names=["a"])
    pos.create_zeros("0", data.shape, np.float64)
    spec = {"driver": "zarr", "kvstore": {"driver": "file", "path": str(tmp_path / "p.zarr/0")},
            "metadata": {"shape": list(data.shape), "chunks": [1, 1, 1, 3, 4], "dtype": ">f8",
                         "compressor": None, "dimension_separator": "/"}}
    ts.open(spec, create=True, delete_existing=True).result().write(data).result()
    got = ngff.open_ome_zarr(tmp_path / "p.zarr").data
    np.testing.assert_array_equal(got[...], data)
    assert got.dtype == np.float64


@pytest.mark.parametrize("version", ["0.4", "0.5"])
def test_create_empty_plate_is_idempotent_appends_and_copies_provenance(tmp_path, version):
    src = ngff.open_ome_zarr(tmp_path / "src.zarr", layout="hcs", mode="w",
                             channel_names=["a"], version="0.5" if version == "0.4" else "0.4")
    src_pos = src.create_position("A", "1", "0")
    src_pos.create_zeros("0", (1, 1, 2, 3, 4), np.float32)
    src_pos.update_zattrs({"biahub-deskew": {"x": 1}, "waveorder": 2, "other": 3})
    kw = dict(channel_names=["a", "b"], shape=(1, 2, 2, 3, 4), scale=SCALE, version=version,
              metadata_sources=tmp_path / "src.zarr", metadata_keys=("biahub-*", "waveorder"))
    out = tmp_path / "out.zarr"
    ngff.create_empty_plate(out, [("A", "1", "0")], **kw)
    ngff.open_ome_zarr(out / "A/1/0").data[0, 1] = 7.0
    first = metadata(out)
    ngff.create_empty_plate(out, [("A", "1", "0")], **kw)
    assert metadata(out) == first
    assert np.all(ngff.open_ome_zarr(out / "A/1/0").data[0, 1] == 7.0)
    ngff.create_empty_plate(out, [("A", "1", "0"), ("B", "2", "0")], **kw)
    plate = ngff.open_ome_zarr(out)
    assert plate.position_keys() == [("A", "1", "0"), ("B", "2", "0")]
    assert plate.zattrs["plate"]["field_count"] == 2
    attrs = plate["A/1/0"].zattrs
    assert attrs["biahub-deskew"] == {"x": 1} and attrs["waveorder"] == 2
    assert "other" not in attrs and plate["A/1/0"].scale == SCALE
    assert plate.channel_names == ["a", "b"]
    # The same calls through the reference give the same metadata.
    ref.create_empty_plate(tmp_path / "ref.zarr", [("A", "1", "0"), ("B", "2", "0")], **kw)
    assert metadata(out) == metadata(tmp_path / "ref.zarr")


def test_pyramid_and_append_channel(tmp_path):
    data = np.random.default_rng(4).random((1, 1, 2, 8, 8)).astype(np.float32)
    for mod, name in ((ngff, "port"), (ref, "ref")):
        pos = mod.open_ome_zarr(tmp_path / f"{name}.zarr", layout="fov", mode="w",
                                channel_names=["a"])
        pos.create_image("0", data, transform=[mod.TransformationMeta(type="scale",
                                                                      scale=SCALE)])
        pos.compute_pyramid(3, method="mean")
        pos.append_channel("b")
    port, want = ngff.open_ome_zarr(tmp_path / "port.zarr"), ref.open_ome_zarr(tmp_path /
                                                                                "ref.zarr")
    for level in ("1", "2"):
        np.testing.assert_allclose(port[level][...], want[level][...], rtol=1e-6)
    assert port.channel_names == ["a", "b"]
    assert metadata(tmp_path / "port.zarr") == metadata(tmp_path / "ref.zarr")


def test_progress_records_do_not_leak_across_prefix_positions(tmp_path):
    plate = tmp_path / "p.zarr"
    long_store = ProgressStore(plate / "A" / "1" / "01", token="tok")
    long_store.mark_many_done([(0, 0), (1, 0)])
    short_store = ProgressStore(plate / "A" / "1" / "0", token="tok")
    assert not short_store.is_done(0, 0) and not short_store.is_done(1, 0)
    reloaded = ProgressStore(plate / "A" / "1" / "01", token="tok")
    assert reloaded.is_done(0, 0) and reloaded.is_done(1, 0)
    assert reloaded.path.name == "A_1_01.p0.json"


def test_progress_records_drop_on_a_changed_token(tmp_path):
    store = ProgressStore(tmp_path / "p.zarr" / "A" / "1" / "0", token="tok")
    store.mark_done(0, 1)
    assert json.loads(store.path.read_text()) == {"token": "tok", "done": ["0.1"]}
    assert ProgressStore(tmp_path / "p.zarr" / "A" / "1" / "0", token="tok").is_done(0, 1)
    assert not ProgressStore(tmp_path / "p.zarr" / "A" / "1" / "0", token="new").is_done(0, 1)
