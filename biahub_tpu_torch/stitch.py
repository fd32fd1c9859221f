"""The stitch verb: each well's FOVs blended into one mosaic.

Counterpart of ``biahub_tpu/stitch.py`` (:39-358): one output position per
well, of the well's ZYX extent (the largest shift plus the tile, per
axis), float16, in chunks ``(1, 1, min(10, Z), cy, cx)`` with (cy, cx)
the input's chunk. The mosaic is computed in (Z, cy, cx) chunks, each by a
worker of a thread pool (``BIAHUB_TPU_STITCH_WORKERS``, 8): every
(FOV, channel) read of the chunk's contributing FOVs is started up front,
each read is copied into its box of a dense (n, T, C, cz, cy, cx) float32
stack on the verb's device, and the stack is blended there
(:func:`~biahub_tpu_torch.kernels.stitch_blend.blend_chunk`, the distance
map padded and sent there once per well), cast to float16 there, copied
back and written. At most ``CARD_CHUNKS`` chunks are on the device at a
time. ``BIAHUB_TPU_HOST_BLEND=1`` takes the reference's NumPy blend on the
host instead. FOV corners are truncated to ints as the reference's
``overlap_slices`` truncates them. The verb prints one ``STITCH_STATS:``
JSON line per well: the workers' seconds waiting on reads, allocating the
stacks, copying the reads to the device, blending, copying back (the last
three by CUDA events on the card: the reads land in pinned buffers and
are copied asynchronously) and writing; the chunks and the bytes read
(all of them copied to the device on its route) and written.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from itertools import product
from pathlib import Path

import numpy as np
import torch

from biahub_tpu_torch.cli.utils import yaml_to_model
from biahub_tpu_torch.convert import stitch_settings_from_reference
from biahub_tpu_torch.device import resolve_device
from biahub_tpu_torch.io.ngff import TransformationMeta, get_ome_zarr_version, open_ome_zarr
from biahub_tpu_torch.kernels.stitch_blend import blend_chunk, pad_distance_map
from biahub_tpu_torch.runtime.executor import resolve_cluster
from biahub_tpu_torch.runtime.resources import estimate_resources

__all__ = ["stitch", "write_output_chunk", "get_output_shape", "chunk_stack",
           "list_of_nd_slices_from_array_shape", "check_overlap", "overlap_slices",
           "find_contributing_fovs", "fov_edge_distance", "CARD_CHUNKS"]

#: Chunks whose stacks may be on the device at once: a stack is n_fov x T x
#: C x the chunk in float32 (about 2.4 GB for 9 FOVs of a (2, 2, 16, 1024,
#: 1024) chunk), so eight workers at once could hold 20 GB.
CARD_CHUNKS = 2
_TIMES = ("read_s", "stack_s", "h2d_s", "blend_s", "d2h_s", "write_s")


def list_of_nd_slices_from_array_shape(array_shape, chunk_shape) -> list[tuple]:
    """The slices that divide an array of ``array_shape`` into
    ``chunk_shape`` chunks, in C order."""
    return [tuple(slice(i, min(i + c, s)) for i, c, s in zip(idx, chunk_shape, array_shape))
            for idx in product(*[range(0, s, c) for s, c in zip(array_shape, chunk_shape)])]


def check_overlap(chunk, fov_shift, fov_extent) -> bool:
    for dim in range(3):
        if (chunk[dim].start >= fov_shift[dim] + fov_extent[dim]
                or chunk[dim].stop <= fov_shift[dim]):
            return False
    return True


def overlap_slices(chunk_corner, chunk_extent, fov_corner, fov_extent):
    """(fixed, moving) slice triplets of the chunk/FOV overlap in chunk and
    FOV coordinates, or (None, None); float corners are truncated to ints
    and both slices take the longer of the two lengths."""
    fixed, moving = [], []
    for d in range(3):
        start = max(chunk_corner[d], fov_corner[d])
        stop = min(chunk_corner[d] + chunk_extent[d], fov_corner[d] + fov_extent[d])
        if stop <= start:
            return None, None
        fixed_slice = slice(int(start - chunk_corner[d]), int(stop - chunk_corner[d]))
        moving_slice = slice(int(start - fov_corner[d]), int(stop - fov_corner[d]))
        max_len = max(fixed_slice.stop - fixed_slice.start,
                      moving_slice.stop - moving_slice.start)
        fixed.append(slice(fixed_slice.start, fixed_slice.start + max_len))
        moving.append(slice(moving_slice.start, moving_slice.start + max_len))
    return tuple(fixed), tuple(moving)


def find_contributing_fovs(chunk, fov_shifts, fov_extent) -> list[str]:
    return [name for name, shift in fov_shifts.items()
            if check_overlap(chunk, shift, fov_extent)]


def get_output_shape(shifts: dict, tile_shape) -> tuple[int, int, int]:
    """The mosaic's ZYX shape: the largest shift (truncated) plus the tile
    extent, per axis."""
    arr = np.asarray(list(shifts.values()))
    return tuple(int(arr[:, i].max()) + tile_shape[i - 3] for i in range(3))


def fov_edge_distance(fov_extent) -> np.ndarray:
    """The distance of each YX pixel of a FOV to its edge (the outer frame
    is 0), broadcast over Z; every FOV of a well shares it."""
    import scipy.ndimage

    fov_extent = np.asarray(fov_extent)
    mask_2d = np.zeros(tuple(fov_extent[1:]), dtype=bool)
    mask_2d[1:-1, 1:-1] = True
    distance_2d = scipy.ndimage.distance_transform_edt(mask_2d)
    return np.broadcast_to(distance_2d[None], (int(fov_extent[0]),) + distance_2d.shape)


def _overlaps(output_chunk_slices, fov_shifts, fov_extent):
    """The contributing FOVs' names and their (fixed, moving) slices."""
    chunk_corner = np.array([s.start for s in output_chunk_slices])
    chunk_extent = np.array([s.stop - s.start for s in output_chunk_slices])
    kept, fixed_slices, moving_slices = [], [], []
    for name in find_contributing_fovs(output_chunk_slices, fov_shifts, fov_extent):
        fixed, moving = overlap_slices(chunk_corner, chunk_extent,
                                       np.asarray(fov_shifts[name], dtype=np.float64),
                                       fov_extent)
        if fixed is not None:
            kept.append(name)
            fixed_slices.append(fixed)
            moving_slices.append(moving)
    return kept, fixed_slices, moving_slices, tuple(int(c) for c in chunk_extent)


def _start_reads(kept, fixed_slices, moving_slices, channel_idx, input_plate,
                 pinned: bool = False) -> list:
    """Every (FOV, channel) read of a chunk, started; ``pinned``: each read
    goes straight into a page-locked buffer (its result), from which the
    copy to the card is asynchronous."""
    reads = []
    for i, (name, fixed, moving) in enumerate(zip(kept, fixed_slices, moving_slices)):
        arr = input_plate[name]["0"]
        for ci, c in enumerate(channel_idx):
            key = (slice(None), int(c), *moving)
            if pinned:
                shape = (arr.shape[0],) + tuple(len(range(*s.indices(n)))
                                                for s, n in zip(moving, arr.shape[2:]))
                buf = torch.empty(shape, dtype=_torch_dtype(arr.dtype), pin_memory=True)
                reads.append((i, ci, name, fixed, (arr.read_into_async(key, buf.numpy()), buf)))
            else:
                reads.append((i, ci, name, fixed, arr.read_async(key)))
    return reads


def _fill_stack(reads, n_fov: int, T: int, n_channels: int, chunk_extent, device,
                verbose: bool, times: dict | None, copy_events: list | None = None
                ) -> torch.Tensor:
    """The (n, T, C, cz, cy, cx) float32 stack on ``device``: zeros, and each
    read copied into its box as it arrives (asynchronously from a pinned
    buffer). ``copy_events``: where a CUDA event pair around each copy is
    put (their spans are the copies' device time); without it the copies
    are timed by the host clock."""
    t0 = time.perf_counter()
    stack = torch.zeros((n_fov, T, n_channels) + tuple(chunk_extent), dtype=torch.float32,
                        device=device)
    stack_s, read_s, copy_s = time.perf_counter() - t0, 0.0, 0.0
    for i, ci, name, fixed, future in reads:
        if verbose:
            print(f"\t\tStacking {name}")
        t0 = time.perf_counter()
        if isinstance(future, tuple):
            future, data = future
            future.result()
        else:
            data = torch.from_numpy(future.result())
        t1 = time.perf_counter()
        if copy_events is not None:
            pair = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            pair[0].record()
        stack[(i, slice(None), ci, *fixed)].copy_(data, non_blocking=data.is_pinned())
        if copy_events is not None:
            pair[1].record()
            copy_events.append(pair)
        read_s, copy_s = read_s + t1 - t0, copy_s + time.perf_counter() - t1
        if times is not None:
            times["bytes_read"] += data.nbytes
    if times is not None:
        times["stack_s"] += stack_s
        times["read_s"] += read_s
        if copy_events is None:
            times["h2d_s"] += copy_s
    return stack


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype)).dtype


def _offsets(fixed_slices, moving_slices) -> np.ndarray:
    return np.array([[m.start - f.start for m, f in zip(moving, fixed)]
                     for fixed, moving in zip(fixed_slices, moving_slices)], np.int64)


def chunk_stack(output_chunk_slices, fov_shifts: dict, channel_idx, input_plate,
                input_fov_shape, device: str | torch.device = "cuda"):
    """The contributing FOVs of one output chunk: ``(offsets, stack)``,
    ``offsets`` (n, 3) ints (each FOV's ``moving.start - fixed.start``) and
    ``stack`` the (n, T, C, cz, cy, cx) float32 tensor of their reads on
    ``device``, each in its box and zeros elsewhere (the input of
    :func:`~biahub_tpu_torch.kernels.stitch_blend.blend_chunk`);
    ``(None, None)`` when no FOV overlaps."""
    kept, fixed_slices, moving_slices, chunk_extent = _overlaps(
        output_chunk_slices, fov_shifts, np.array(input_fov_shape[-3:]))
    if not kept:
        return None, None
    reads = _start_reads(kept, fixed_slices, moving_slices, channel_idx, input_plate)
    stack = _fill_stack(reads, len(kept), int(input_fov_shape[0]), len(channel_idx),
                        chunk_extent, resolve_device(device), False, None)
    return _offsets(fixed_slices, moving_slices), stack


def _host_blend(output_chunk_slices, fov_shifts, channel_idx, input_plate, input_fov_shape,
                centered_distance, blending_exponent, verbose, T, times) -> np.ndarray:
    """The reference's NumPy blend (``BIAHUB_TPU_HOST_BLEND=1``)."""
    fov_extent = np.array(input_fov_shape[-3:])
    kept, fixed_slices, moving_slices, chunk_extent = _overlaps(
        output_chunk_slices, fov_shifts, fov_extent)
    output_chunk = np.zeros((T, len(channel_idx)) + chunk_extent, dtype=np.float32)
    if not kept:
        return output_chunk
    reads = _start_reads(kept, fixed_slices, moving_slices, channel_idx, input_plate)
    t0 = time.perf_counter()
    distance_maps = np.zeros((len(kept),) + chunk_extent, dtype=np.float32)
    for i, (fixed, moving) in enumerate(zip(fixed_slices, moving_slices)):
        distance_maps[(i, *fixed)] = centered_distance[moving]
    w = np.zeros_like(distance_maps)
    np.power(distance_maps, blending_exponent, out=w, where=(distance_maps > 0))
    weight_maps = w / (np.sum(w, axis=0, keepdims=True) + 1e-8)
    read_s = 0.0
    for i, ci, name, fixed, future in reads:
        if verbose:
            print(f"\t\tApplying weight maps to {name}")
        r0 = time.perf_counter()
        data = np.asarray(future.result(), dtype=np.float32)
        read_s += time.perf_counter() - r0
        times["bytes_read"] += data.nbytes
        output_chunk[(slice(None), ci, *fixed)] += data * weight_maps[(i, *fixed)]
    times["read_s"] += read_s
    times["blend_s"] += time.perf_counter() - t0 - read_s
    return output_chunk


def _device_blend(output_chunk_slices, fov_shifts, channel_idx, input_plate, input_fov_shape,
                  padded, pad, blending_exponent, out_dtype, verbose, times,
                  card_slots) -> np.ndarray:
    """The chunk's reads stacked on ``padded``'s device, blended there, cast
    to the output dtype and copied back, holding one of ``card_slots``
    meanwhile. On the card the reads land in pinned buffers, and the copies
    and the blend run on a stream of their own, timed by CUDA events."""
    dev = padded.device
    T = int(input_fov_shape[0])
    kept, fixed_slices, moving_slices, chunk_extent = _overlaps(
        output_chunk_slices, fov_shifts, np.array(input_fov_shape[-3:]))
    if not kept:
        return np.zeros((T, len(channel_idx)) + chunk_extent, out_dtype)
    reads = _start_reads(kept, fixed_slices, moving_slices, channel_idx, input_plate,
                         pinned=dev.type == "cuda")
    offsets = _offsets(fixed_slices, moving_slices)
    torch_dtype = _torch_dtype(out_dtype)
    with card_slots:
        if dev.type == "cuda":
            stream = torch.cuda.Stream(dev)
            # The padded map was made on the default stream.
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                copies: list = []
                stack = _fill_stack(reads, len(kept), T, len(channel_idx), chunk_extent, dev,
                                    verbose, times, copies)
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                ev[0].record()
                out = blend_chunk(padded, offsets, stack, blending_exponent, pad).to(
                    torch_dtype)
                ev[1].record()
                del stack
                host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
                host.copy_(out, non_blocking=True)
                ev[2].record()
            stream.synchronize()
            times["h2d_s"] += sum(a.elapsed_time(b) for a, b in copies) / 1e3
            times["blend_s"] += ev[0].elapsed_time(ev[1]) / 1e3
            times["d2h_s"] += ev[1].elapsed_time(ev[2]) / 1e3
        else:
            stack = _fill_stack(reads, len(kept), T, len(channel_idx), chunk_extent, dev,
                                verbose, times)
            t0 = time.perf_counter()
            host = blend_chunk(padded, offsets, stack, blending_exponent, pad).to(torch_dtype)
            times["blend_s"] += time.perf_counter() - t0
    return host.numpy()


def write_output_chunk(
    output_chunk_slices,
    fov_shifts: dict,
    channel_idx,
    input_plate,
    input_fov_shape,
    output_position,
    verbose: bool,
    blending_exponent: float = 1.0,
    centered_distance=None,
    distance_pad: tuple[int, int, int] | None = None,
    device: str | torch.device = "cuda",
    stats: dict | None = None,
    card_slots: threading.Semaphore | None = None,
) -> None:
    """Blend every contributing FOV into one output chunk and write it.

    ``centered_distance``: the FOVs' :func:`fov_edge_distance` map (computed
    here when None); on the device route it may instead be the
    :func:`~biahub_tpu_torch.kernels.stitch_blend.pad_distance_map` tensor
    padded by ``distance_pad`` (the verb pads once per well). ``stats``:
    a dict the chunk adds its seconds, bytes and one to ``chunks`` to,
    under its ``"lock"``. ``card_slots``: a semaphore the chunk holds while
    its stack is on the device (the verb's allows ``CARD_CHUNKS``)."""
    times = {**dict.fromkeys(_TIMES, 0.0), "bytes_read": 0}
    output_array = output_position["0"]
    T = output_array.shape[0]
    fov_extent = tuple(int(s) for s in input_fov_shape[-3:])
    chunk_extent = tuple(s.stop - s.start for s in output_chunk_slices)
    host_route = os.environ.get("BIAHUB_TPU_HOST_BLEND") == "1"
    if centered_distance is None:
        centered_distance = fov_edge_distance(fov_extent)
    if host_route:
        out = _host_blend(output_chunk_slices, fov_shifts, channel_idx, input_plate,
                          input_fov_shape, centered_distance, blending_exponent, verbose, T,
                          times).astype(output_array.dtype)
    else:
        if isinstance(centered_distance, torch.Tensor):
            padded, pad = centered_distance, distance_pad
        else:
            padded = pad_distance_map(centered_distance, chunk_extent, resolve_device(device))
            pad = chunk_extent
        out = _device_blend(output_chunk_slices, fov_shifts, channel_idx, input_plate,
                            input_fov_shape, padded, pad, blending_exponent,
                            output_array.dtype, verbose, times,
                            card_slots or contextlib.nullcontext())
    if verbose:
        print(f"\t\tWriting chunk to output array: {output_chunk_slices}")
    w0 = time.perf_counter()
    output_array[(slice(None), slice(None), *output_chunk_slices)] = out
    times["write_s"] += time.perf_counter() - w0
    if stats is not None:
        with stats["lock"]:
            for k, v in times.items():
                stats[k] += v
            stats["chunks"] += 1
            stats["bytes_written"] += out.nbytes


def stitch(
    input_position_dirpaths: list[Path],
    config_filepath: Path,
    output_dirpath: Path,
    sbatch_filepath: str | None = None,
    local: bool = False,
    verbose: bool = False,
    blending_exponent: float = 1.0,
    debug: bool = False,
    monitor: bool = False,
    device: str | torch.device = "cuda",
) -> None:
    """The stitch verb (the reference's ``stitch_cli``) on the positions
    of one plate, with the shifts of an estimate-stitch YAML."""
    print("Starting stitching...")
    dev = None if os.environ.get("BIAHUB_TPU_HOST_BLEND") == "1" else resolve_device(device)
    settings = yaml_to_model(config_filepath, stitch_settings_from_reference)
    input_plate_path = Path(input_position_dirpaths[0]).parents[2]
    input_plate = open_ome_zarr(input_plate_path, mode="r")
    input_channels = input_plate.channel_names
    channels = settings["channels"] if settings["channels"] is not None else input_channels
    if not all(ch in input_channels for ch in channels):
        raise ValueError("Invalid channel(s) provided.")
    channel_idx = np.asarray([input_channels.index(ch) for ch in channels])
    version = settings["output_ome_zarr_version"] or get_ome_zarr_version(input_plate_path)
    output_plate = open_ome_zarr(output_dirpath, layout="hcs", mode="w",
                                 channel_names=channels, version=version)

    shifts_by_well: dict[str, dict] = defaultdict(dict)
    for key, value in settings["total_translation"].items():
        shifts_by_well["/".join(key.split("/")[:2])][key] = value

    resolve_cluster(None, local)
    n_workers = int(os.environ.get("BIAHUB_TPU_STITCH_WORKERS", "8"))
    for well_name, fov_shifts in shifts_by_well.items():
        if verbose:
            print(f"Processing well {well_name}")
        first_fov_name = next(iter(fov_shifts))
        first = input_plate[first_fov_name]
        input_fov_shape = first.data.shape
        output_shape_zyx = get_output_shape(fov_shifts, input_fov_shape)
        input_chunks = first.data.chunks
        output_chunk_zyx = (output_shape_zyx[0], input_chunks[-2], input_chunks[-1])
        output_position = output_plate.create_position(*first_fov_name.split("/")[:2], "0")
        output_position.create_zeros(
            "0", shape=(input_fov_shape[0], len(channel_idx)) + output_shape_zyx,
            dtype=np.float16,
            chunks=(1, 1, min(10, output_shape_zyx[0]), output_chunk_zyx[-2],
                    output_chunk_zyx[-1]),
            transform=[TransformationMeta(type="scale", scale=first.scale)])
        estimate_resources(shape=input_fov_shape, ram_multiplier=25, max_num_cpus=16)

        chunks = list_of_nd_slices_from_array_shape(output_shape_zyx, output_chunk_zyx)
        t0 = time.perf_counter()
        centered_distance = fov_edge_distance(input_fov_shape[-3:])
        distance_pad = None
        if dev is not None:
            distance_pad = tuple(int(c) for c in output_chunk_zyx)
            centered_distance = pad_distance_map(centered_distance, distance_pad, dev)
        stats = {"lock": threading.Lock(), "chunks": 0, "bytes_read": 0, "bytes_written": 0,
                 **dict.fromkeys(_TIMES, 0.0)}
        slots = threading.BoundedSemaphore(CARD_CHUNKS)
        with ThreadPoolExecutor(max_workers=max(1, n_workers)) as pool:
            futures = [pool.submit(write_output_chunk, chunk, fov_shifts, channel_idx,
                                   input_plate, input_fov_shape, output_position, verbose,
                                   blending_exponent, centered_distance, distance_pad,
                                   dev, stats, slots)
                       for chunk in chunks]
            for f in futures:
                f.result()
        del stats["lock"]
        stats.update(well=well_name, wall_s=time.perf_counter() - t0,
                     route="host" if dev is None else dev.type, workers=max(1, n_workers))
        print("STITCH_STATS:" + json.dumps(stats))
        print(f"Stitched well {well_name} -> {output_shape_zyx}")
