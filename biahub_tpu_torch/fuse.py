"""The fuse verb: flat-field -> deconvolve -> deskew -> register/stabilize,
stage by stage on the device, on arrays in memory (:func:`fuse_arrays`)
and on plates (:func:`fuse`).

Counterpart of ``biahub_tpu/fuse.py::fuse`` (:376-868). Each stage is the
standalone verb's computation, and the routes are the reference's:

- **no fill, one matrix**, with deconvolve and deskew: the main path's
  chain as :class:`~biahub_tpu_torch.pipeline.DeconvolveDeskewWarp` runs it
  (kernels A, B, C, D in the xzy store, E and F; the deskew's Y flip folded
  into the warp's matrix), or the multipass warp for a general matrix (with
  a fill, the same from D's zyx store);
- **per-timepoint matrices** (a stabilization block): the deskew keeps Y
  reversed and the flip is folded into every matrix
  (``chain.flip_y_matrix``); the warp's kernel is chosen from all of them
  (``affine.make_batched_warp``: E and F with a (B, 21) table, or H in one
  union frame);
- **fill needed** (``keep_overhang`` and a non-zero ``overhang_fill``,
  :508-511): deconvolve, deskew in D's zyx store, the overhang fill
  (``kernels/deskew.py::fill_overhang``), then the warp, with no xzy
  handoff;
- **flat-field**: a per-channel prefix on the raw volume (:708-739,
  ``kernels/flat_field.py``); the other channels run the rest of the chain,
  or are copied when flat-field is the only stage. uint16 volumes go into
  kernel A as they are only where no flat-field precedes it (:746-747).

Volumes run in batches of as many units as ``max_batch_bytes`` holds (input
and output, a deconvolution's spectrum and the multipass frames counted,
:751-760). When one unit does not fit, each (t, c) runs the standalone
verbs' chunked routes in turn (the reference's ``_fuse_over_budget``,
:275-373): flat-field in Y slabs, the deconvolution whole (a deconvolution
that cannot fit raises the reference's error), the deskew in X slabs and
its fill in Y slabs, the warp whole or in output chunks; that result is in
host memory, as the reference's is on its plate. ``spectral=True`` takes the
spectral engine where the chain takes it (no fill), as the reference's
``BIAHUB_TPU_SPECTRAL_DESKEW=1`` does.

:func:`fuse` runs the same plan (:class:`_Plan`) on the batches the batch
runner hands it, the flat-field channels and the others as two runs, so
its plate equals :func:`fuse_arrays` on the same arrays bit for bit.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

from biahub_tpu_torch.apply_inverse_transfer_function import time_indices
from biahub_tpu_torch.cli.utils import PROVENANCE_METADATA_KEYS, get_output_paths, yaml_to_model
from biahub_tpu_torch.convert import fuse_settings_dump, fuse_settings_from_reference
from biahub_tpu_torch.deskew import deskew_slabbed, fill_overhang_chunked
from biahub_tpu_torch.device import as_tensor, resolve_device
from biahub_tpu_torch.estimate_stabilization import DEFAULT_MAX_BATCH_BYTES
from biahub_tpu_torch.flat_field import resolve_target_indices
from biahub_tpu_torch.io.ngff import (
    TransformationMeta,
    create_empty_plate,
    get_ome_zarr_version,
    open_ome_zarr,
)
from biahub_tpu_torch.io.progress import ProgressStore
from biahub_tpu_torch.kernels.affine import (
    affine_warp_auto,
    affine_warp_auto_batched,
    inplane_coefficients,
    is_inplane_matrix,
    make_batched_warp,
)
from biahub_tpu_torch.kernels.chain import (
    chain_warp_matrix,
    chain_warp_spectral_route,
    flip_y_matrix,
    run_chain,
    run_chain_warp,
    run_chain_warp_general,
)
from biahub_tpu_torch.kernels.deconvolve import (
    compute_transfer_function,
    deconvolve_zyx,
    volume_tensor,
)
from biahub_tpu_torch.kernels.deskew import (
    deskew_geometry,
    fill_overhang,
    fill_overhang_,
    get_deskewed_data_shape,
    overhang_fill_value,
)
from biahub_tpu_torch.kernels.deskew_cuda import deskew
from biahub_tpu_torch.kernels.fft import prepare_fourier_filter
from biahub_tpu_torch.kernels.flat_field import flat_field_zyx, median_pattern
from biahub_tpu_torch.kernels.multipass_warp import chunked_affine_warp_zyx, common_frame_bytes
from biahub_tpu_torch.kernels.spectral import (
    prepare_spectral_deskew,
    run_spectral,
    run_spectral_warp,
    spectral_deskew_supported,
)
from biahub_tpu_torch.runtime.executor import (
    BatchRunner,
    WorkUnit,
    resolve_cluster,
    sbatch_to_overrides,
    stripe_units,
)
from biahub_tpu_torch.runtime.resources import (
    echo_resources,
    estimate_resources,
    settings_fingerprint,
)

__all__ = ["fuse_arrays", "warp_matrices", "fuse"]


def warp_matrices(fs: dict, time_indices: list[int]):
    """(one matrix, per-raw-timepoint matrices) of the warp stage, as the
    reference's ``_warp_matrices`` (:84-114): ``M_reg @ M_stab[t]`` (the
    stabilize map runs first on an output coordinate). At most one is not
    None; both are None without a warp stage. ``fs``: the settings as
    ``convert.fuse_settings_from_reference`` reads them."""
    reg, stab = fs["registration"], fs["stabilization"]
    m_reg = None if reg is None else np.asarray(reg["affine_transform_zyx"], dtype=np.float64)
    if stab is None:
        return m_reg, None
    mats = [np.asarray(m, dtype=np.float64) for m in stab["affine_transform_zyx_list"]]
    needed = max(time_indices) + 1
    if len(mats) < needed:
        raise ValueError(
            f"stabilization.affine_transform_zyx_list has {len(mats)} matrices "
            f"but timepoint {needed - 1} is processed (one matrix per raw "
            "timepoint, like StabilizationSettings)"
        )
    if m_reg is not None:
        mats = [m_reg @ m for m in mats]
    return None, mats


class _Plan:
    """One acquisition's stages, resolved once: the prepared filter, the
    deskew geometry and fill, the warp and its matrices."""

    def __init__(self, fs, zyx, tf_half, times, dev, spectral):
        self.dev = dev
        self.decon = fs["deconvolve"]
        self.dk = fs["deskew"]
        self.m_single, self.mats_per_t = warp_matrices(fs, times)
        self.warped = self.m_single is not None or self.mats_per_t is not None
        if self.decon is not None and tf_half is None:
            raise ValueError("the deconvolve stage needs a PSF: pass its transfer "
                             "function half (tf_half)")
        self.filt = None if self.decon is None else prepare_fourier_filter(
            zyx, tf_half, self.decon["regularization_strength"], dev)
        dk = self.dk
        if dk is not None:
            self.frame, _ = get_deskewed_data_shape(zyx, dk["ls_angle_deg"],
                                                    dk["px_to_scan_ratio"],
                                                    dk["keep_overhang"], dk["average_window"])
            self.fill = overhang_fill_value(dk["keep_overhang"], dk["overhang_fill"])
            # The deskew keeps Y reversed where a warp folds the flip in.
            self.geo = deskew_geometry(zyx, dk["ls_angle_deg"], dk["px_to_scan_ratio"],
                                       dk["keep_overhang"], dk["average_window"],
                                       skip_flip=self.warped)
            self.flip = flip_y_matrix(int(self.frame[1]))
        else:
            self.frame, self.fill, self.geo, self.flip = tuple(zyx), None, None, np.eye(4)
        self.frame = tuple(int(s) for s in self.frame)
        out = fs["output_shape_zyx"]
        self.out_zyx = tuple(int(s) for s in out) if out is not None else self.frame
        self.chain = self.decon is not None and dk is not None
        self.table = None
        self.workspace = 0
        if self.mats_per_t is not None:
            self.all_mats = np.stack([self.flip @ m for m in self.mats_per_t])
            self.warp, self.workspace = make_batched_warp(self.all_mats, self.frame,
                                                          self.out_zyx, dev)
        if self.chain and self.fill is None and spectral:
            args = (zyx, dk["ls_angle_deg"], dk["px_to_scan_ratio"], dk["keep_overhang"],
                    dk["average_window"])
            take = (chain_warp_spectral_route(*args, self.m_single)
                    if self.m_single is not None else spectral_deskew_supported(*args))
            if take:
                self.table = prepare_spectral_deskew(*args, dev)
        if self.decon is not None:
            self.workspace += 4 * int(np.prod(zyx))

    def prefix(self, vols: torch.Tensor) -> torch.Tensor:
        """The (deconvolve?, deskew?, fill?) stages of a batch; Y reversed
        after a deskew when a warp follows."""
        if self.chain:
            if self.table is not None:
                out = run_spectral(vols, self.filt, self.table, self.geo)
                return out if self.geo.skip_flip else out.flip(2)
            return run_chain(vols, self.filt, self.geo, fill=self.fill)
        if self.decon is not None:
            return torch.stack([deconvolve_zyx(v, prepared=self.filt, device=self.dev)
                                for v in vols])
        if self.dk is not None:
            vols = deskew(vols.to(torch.float32).contiguous(), self.geo)
            return fill_overhang_(vols, self.fill)
        return vols

    def run(self, vols: torch.Tensor, times: list[int]) -> torch.Tensor:
        """Every stage after the flat-field of a batch whose volumes are of
        raw timepoints ``times``."""
        if self.m_single is not None and self.chain:
            m = chain_warp_matrix(self.m_single, self.geo)
            if self.table is not None:
                return run_spectral_warp(vols, self.filt, self.table, self.geo,
                                         inplane_coefficients(m).to(self.dev), self.out_zyx)
            if is_inplane_matrix(m):
                return run_chain_warp(vols, self.filt, self.geo,
                                      inplane_coefficients(m).to(self.dev), self.out_zyx,
                                      out_layout="xzy", overhang_fill=self.fill)
            return run_chain_warp_general(vols, self.filt, self.geo, m, self.out_zyx,
                                          overhang_fill=self.fill)
        pre = self.prefix(vols)
        if self.m_single is not None:
            return affine_warp_auto_batched(pre, self.flip @ self.m_single, self.out_zyx,
                                            device=self.dev)
        if self.mats_per_t is not None:
            return self.warp(pre, self.all_mats[times])
        return pre


def fuse_arrays(
    tczyx,
    channel_names: list[str],
    settings: dict,
    tf_half=None,
    max_batch_bytes: int = DEFAULT_MAX_BATCH_BYTES,
    device: str | torch.device = "cuda",
    spectral: bool = False,
) -> torch.Tensor:
    """Run the fused pipeline's stages on a (T, C, Z, Y, X) array ->
    (len(time_indices), C, Zo, Yo, Xo) float32. ``settings``: the fused
    pipeline's settings as a dict (``settings/example_fuse_pipeline_
    settings.yml`` as loaded); ``tf_half``: the deconvolve stage's half
    transfer function (``compute_transfer_function(psf, (Z, Y, X))[...,
    :X // 2 + 1]``). The output is on the device, or in host memory when
    one unit exceeds ``max_batch_bytes`` (the chunked route)."""
    dev = resolve_device(device)
    fs = fuse_settings_from_reference(settings)
    T, C, Z, Y, X = (int(s) for s in tczyx.shape)
    times = time_indices(fs, T)
    plan = _Plan(fs, (Z, Y, X), tf_half, times, dev, spectral)
    ff = fs["flat_field"]
    other_stages = plan.decon is not None or plan.dk is not None or plan.warped
    targets = set()
    if ff is not None:
        targets = set(resolve_target_indices(
            ff, list(channel_names),
            others_note=("Other channels skip the correction but run the rest of the chain"
                         if other_stages else "Other channels will be copied as-is")))
    unit_bytes = 4 * (Z * Y * X + int(np.prod(plan.out_zyx))) + plan.workspace
    if _over_budget(plan, (Z, Y, X), unit_bytes, max_batch_bytes, sys.stderr):
        return _fuse_over_budget(tczyx, plan, times, C, targets, max_batch_bytes)
    out = torch.empty((len(times), C) + plan.out_zyx, dtype=torch.float32, device=dev)
    units = [(t_out, t, c) for t_out, t in enumerate(times) for c in range(C)]
    step = max(1, min(len(units), max_batch_bytes // unit_bytes))
    ff_units = [u for u in units if u[2] in targets]
    plain_units = [u for u in units if u[2] not in targets]
    for group, flat in ((ff_units, True), (plain_units, False)):
        for i in range(0, len(group), step):
            batch = group[i:i + step]
            tc = [(t, c) for _, t, c in batch]
            vols = torch.stack([volume_tensor(tczyx[t, c], dev) for t, c in tc])
            res = _fuse_batch(plan, vols, [t for t, _ in tc], flat, other_stages)
            for (t_out, _, c), r in zip(batch, res):
                out[t_out, c] = r
    return out


def _over_budget(plan: _Plan, zyx, unit_bytes: int, budget: int, file) -> bool:
    """Whether one fused unit exceeds the budget (said on ``file``); raises
    the reference's error when a deconvolution cannot fit at all."""
    if unit_bytes <= budget:
        return False
    decon_bytes = 4 * 4 * int(np.prod(zyx))
    if plan.decon is not None and decon_bytes > budget:
        raise ValueError(
            f"One deconvolution volume needs ~{decon_bytes / 2**30:.1f} "
            f"GiB on device, over the batch budget "
            f"({budget / 2**30:.1f} GiB; "
            "BIAHUB_TPU_MAX_BATCH_BYTES). An FFT has no exact spatial "
            "split on one chip — raise the budget or shard the FFT "
            "across chips (BIAHUB_TPU_SHARDED_FFT=1)."
        )
    print(f"One fused (t, c) volume needs ~{unit_bytes / 2**30:.1f} GiB, over the device "
          f"batch budget ({budget / 2**30:.1f} GiB); composing the standalone "
          "verbs' chunked kernels per unit instead.", file=file)
    return True


def _fuse_batch(plan: _Plan, vols: torch.Tensor, times: list[int], flat: bool,
                other_stages: bool) -> torch.Tensor:
    """Every stage of a batch of raw volumes (uint16 or float32) of raw
    timepoints ``times``: the flat-field when ``flat``, then the plan's
    stages, or nothing but the cast when flat-field is the only stage."""
    # uint16 goes into kernel A as it is; flat-field, a deskew or a warp
    # that comes first takes float32.
    if flat:
        vols = torch.stack([flat_field_zyx(v, device=plan.dev) for v in vols])
    elif plan.decon is None:
        vols = vols.to(torch.float32)
    return plan.run(vols, times) if (flat or other_stages) else vols


def _flat_field_slabbed(vol: torch.Tensor, budget: int, dev) -> torch.Tensor:
    """flat_field_zyx of a host volume in Y slabs when twice the volume does
    not fit the budget: the median is per (y, x), so slab-exact, and the
    pattern's mean is taken over the whole pattern (the reference's
    :179-200)."""
    if 2 * 4 * vol.numel() <= budget:
        return flat_field_zyx(as_tensor(vol, dev), device=dev).cpu()
    Z, Y, X = vol.shape
    y_chunk = max(1, int(budget // (2 * 4 * Z * X)))
    pattern = torch.cat([median_pattern(as_tensor(vol[:, y0:y0 + y_chunk], dev))
                         for y0 in range(0, Y, y_chunk)])
    mean = pattern.mean()
    out = torch.empty_like(vol)
    for y0 in range(0, Y, y_chunk):
        y1 = min(y0 + y_chunk, Y)
        out[:, y0:y1] = (as_tensor(vol[:, y0:y1], dev) / pattern[y0:y1] * mean).cpu()
    return out


def _deskew_slabbed(vol: torch.Tensor, plan: _Plan, budget: int, dev) -> torch.Tensor:
    """The deskew stage of a host volume in the standard frame: whole when
    input and output fit the budget, else in X slabs; then the fill, whole
    when twice the output fits, else in Y slabs (the reference's
    :203-272)."""
    dk = plan.dk
    Z, Y, X = vol.shape
    geo = deskew_geometry((Z, Y, X), dk["ls_angle_deg"], dk["px_to_scan_ratio"],
                          dk["keep_overhang"], dk["average_window"])
    volume_bytes = 4 * (Z * Y * X + int(np.prod(geo.out_shape)))
    if volume_bytes <= budget:
        out = deskew(as_tensor(vol, dev)[None], geo)[0].cpu()
    else:
        n_splits = -(-volume_bytes // budget)
        out = deskew_slabbed(vol, dk, max(1, -(-X // int(n_splits))), dev)
    if plan.fill is None:
        return out
    if 2 * 4 * out.numel() <= budget:
        return fill_overhang(as_tensor(out, dev), None if plan.fill == "mean"
                             else plan.fill).cpu()
    y_chunk = max(8, int(budget // (4 * 4 * out.shape[0] * out.shape[2])))
    return fill_overhang_chunked(out, plan.fill, y_chunk, dev)


def _fuse_over_budget(tczyx, plan: _Plan, times, C: int, targets: set,
                      budget: int) -> torch.Tensor:
    """Each (t, c) through the standalone verbs' chunked routes in turn (the
    reference's ``_fuse_over_budget``, :275-373). Host memory in and out."""
    out = torch.empty((len(times), C) + plan.out_zyx, dtype=torch.float32)
    for t_out, t in enumerate(times):
        for c in range(C):
            out[t_out, c] = _fuse_unit_over_budget(
                as_tensor(tczyx[t, c], torch.device("cpu")), plan, t, c in targets, budget)
    return out


def _fuse_unit_over_budget(vol: torch.Tensor, plan: _Plan, t: int, flat: bool,
                           budget: int) -> torch.Tensor:
    """One float32 host volume of raw timepoint ``t`` through the standalone
    verbs' chunked routes, in the standard deskewed frame with the warp
    matrices as given -> its host output."""
    dev = plan.dev
    if flat:
        vol = _flat_field_slabbed(vol, budget, dev)
    if plan.decon is not None:
        vol = deconvolve_zyx(as_tensor(vol, dev), prepared=plan.filt, device=dev).cpu()
    if plan.dk is not None:
        vol = _deskew_slabbed(vol, plan, budget, dev)
    m = plan.m_single if plan.m_single is not None else (
        plan.mats_per_t[t] if plan.mats_per_t is not None else None)
    if m is None:
        return vol
    shape = tuple(vol.shape)
    warp_bytes = (4 * (vol.numel() + int(np.prod(plan.out_zyx)))
                  + common_frame_bytes(m, shape, plan.out_zyx))
    if warp_bytes <= budget:
        return affine_warp_auto(as_tensor(vol, dev), m, plan.out_zyx, device=dev).cpu()
    chunk = tuple(max(32, s // max(1, int(np.ceil(warp_bytes / budget))))
                  for s in plan.out_zyx)
    out = torch.empty(plan.out_zyx, dtype=torch.float32)

    def write_fn(zs, ys, xs, data):
        out[zs, ys, xs] = data.cpu()

    chunked_affine_warp_zyx(lambda zs, ys, xs: vol[zs, ys, xs], m, shape, plan.out_zyx, chunk,
                            write_fn=write_fn, order=1, device=dev)
    return out


def fuse(
    input_position_dirpaths: list[Path],
    config_filepath: Path,
    output_dirpath: Path,
    psf_dirpath: Path | None = None,
    sbatch_filepath: str | None = None,
    cluster: str = "slurm",
    monitor: bool = True,
    init_only: bool = False,
    resume: bool = False,
    device: str | torch.device = "cuda",
) -> None:
    """The fuse verb on plates (the reference's ``fuse``, :376-749): the
    output plate (the deskewed frame's shape and voxel size, or
    ``output_shape_zyx``; provenance copied from the input plate), the
    transfer function of ``psf.zarr/0/0/0`` written to
    ``transfer_function.zarr`` when a deconvolve stage is set, then every
    (t, c) unit of ``time_indices`` through :func:`_fuse_batch` in device
    batches, or, when one unit exceeds the budget, through the standalone
    verbs' chunked routes one unit at a time. ``--resume`` skips the units
    recorded under this settings' fingerprint."""
    dev = resolve_device(device)
    output_dirpath = Path(output_dirpath)
    settings = yaml_to_model(config_filepath, fuse_settings_dump)
    fs = fuse_settings_from_reference(settings)
    if fs["deconvolve"] is not None and psf_dirpath is None:
        raise ValueError("the deconvolve stage needs a PSF: pass -p/--psf-dirpath psf.zarr")
    input_dataset = open_ome_zarr(str(input_position_dirpaths[0]), mode="r")
    channel_names = input_dataset.channel_names
    T, C, Z, Y, X = input_dataset.data.shape
    in_scale = input_dataset.scale
    times = time_indices(fs, T)
    dk = fs["deskew"]
    if dk is not None:
        frame, voxel_size = get_deskewed_data_shape(
            (Z, Y, X), dk["ls_angle_deg"], dk["px_to_scan_ratio"], dk["keep_overhang"],
            dk["average_window"], settings["deskew"]["pixel_size_um"])
        out_scale = (1, 1) + tuple(voxel_size)
    else:
        frame, out_scale = (Z, Y, X), tuple(in_scale)
    warp_matrices(fs, times)  # the reference's check of the matrix count
    out_zyx = (tuple(int(s) for s in fs["output_shape_zyx"])
               if fs["output_shape_zyx"] is not None else tuple(int(s) for s in frame))
    input_plate = Path(input_position_dirpaths[0]).parents[2]
    create_empty_plate(
        store_path=output_dirpath,
        position_keys=[Path(p).parts[-3:] for p in input_position_dirpaths],
        channel_names=channel_names,
        shape=(len(times), C) + out_zyx,
        scale=out_scale,
        version=fs["output_ome_zarr_version"] or get_ome_zarr_version(input_plate),
        metadata_sources=input_plate,
        metadata_keys=PROVENANCE_METADATA_KEYS,
    )
    n_stages = sum(fs[k] is not None for k in ("flat_field", "deconvolve", "deskew",
                                                "registration", "stabilization"))
    time_minutes, num_cpus, gb_ram_per_cpu = estimate_resources(
        shape=(T, C, Z, Y, X), ram_multiplier=8 + 4 * n_stages, time_multiplier=0.5,
        max_num_cpus=16)
    echo_resources(num_cpus, num_cpus * gb_ram_per_cpu, time_minutes)
    if init_only:
        print(f"Initialized {output_dirpath} ({len(input_position_dirpaths)} positions)")
        return
    if sbatch_filepath:
        print(f"Resource overrides (compatibility): {sbatch_to_overrides(sbatch_filepath)}")
    resolved = resolve_cluster(cluster=cluster)
    print(f"Running on-device batches (mode='{resolved}')")

    tf_half = None
    if fs["deconvolve"] is not None:
        psf_dataset = open_ome_zarr(Path(psf_dirpath, "0/0/0"), mode="r")
        if list(in_scale[-3:]) != list(psf_dataset.scale[-3:]):
            print(f"Warning: PSF scale: {psf_dataset.scale[-3:]} does not match "
                  f"data scale: {in_scale[-3:]}. Consider resampling the PSF.")
        transfer_function = compute_transfer_function(psf_dataset.data[0, 0], (Z, Y, X))
        tf_store = open_ome_zarr(output_dirpath.parent / "transfer_function.zarr",
                                 layout="fov", mode="w", channel_names=["PSF"])
        tf_store.create_image("0", transfer_function[None, None],
                              chunks=(1, 1, min(Z, 256), Y, X),
                              transform=[TransformationMeta(type="scale",
                                                            scale=psf_dataset.scale)])
        tf_half = transfer_function[..., : X // 2 + 1]
    plan = _Plan(fs, (Z, Y, X), tf_half, times, dev, spectral=False)
    other_stages = plan.decon is not None or plan.dk is not None or plan.warped
    targets: set[int] = set()
    if fs["flat_field"] is not None:
        targets = set(resolve_target_indices(
            fs["flat_field"], channel_names,
            others_note=("Other channels skip the correction but run the rest of the chain"
                         if other_stages else "Other channels will be copied as-is")))
    input_positions = [open_ome_zarr(p, mode="r") for p in input_position_dirpaths]
    output_positions = [open_ome_zarr(p, mode="r+")
                        for p in get_output_paths(input_position_dirpaths, output_dirpath)]
    for out_pos in output_positions:
        out_pos.update_zattrs({"biahub-fuse": settings})
    token = settings_fingerprint(settings)
    runner = BatchRunner(cluster=resolved, device=dev)
    units = [WorkUnit(p, int(t), c, c, int(t_out)) for p in range(len(input_positions))
             for t_out, t in enumerate(times) for c in range(C)]
    unit_bytes = 4 * (Z * Y * X + int(np.prod(out_zyx))) + plan.workspace
    if _over_budget(plan, (Z, Y, X), unit_bytes, runner.max_batch_bytes, sys.stdout):
        progress: dict[int, ProgressStore] = {}
        n = 0
        for u in stripe_units(units):
            out_pos = output_positions[u.pos_idx]
            if resume and u.pos_idx not in progress:
                progress[u.pos_idx] = ProgressStore(out_pos.path, token)
            if u.pos_idx in progress and progress[u.pos_idx].is_done(u.out_t, u.c_out):
                n += 1
                continue
            vol = torch.from_numpy(np.asarray(input_positions[u.pos_idx].data[u.t, u.c_in],
                                              dtype=np.float32))
            out_pos["0"][u.out_t, u.c_out] = _fuse_unit_over_budget(
                vol, plan, u.t, u.c_in in targets, runner.max_batch_bytes).numpy()
            if u.pos_idx in progress:
                progress[u.pos_idx].mark_done(u.out_t, u.c_out)
            n += 1
        print(f"Fused (chunked fallback): {n} (t, c) volumes across "
              f"{len(input_position_dirpaths)} positions")
        return

    def make_kernel(flat: bool):
        def kernel(vols: torch.Tensor, t: np.ndarray) -> torch.Tensor:
            return _fuse_batch(plan, vols, [int(x) for x in t], flat, other_stages)

        # uint16 volumes go to the card as they are (kernel A, or the cast).
        kernel.native_ingest_dtypes = ("uint16",)
        return kernel

    run_kwargs = dict(resume=resume, resume_token=token,
                      per_unit_params=lambda u: {"t": np.int64(u.t)},
                      monitor=monitor and resolved != "debug",
                      unit_workspace_bytes=plan.workspace)
    ff_units = [u for u in units if u.c_in in targets]
    plain_units = [u for u in units if u.c_in not in targets]
    n = 0
    if ff_units:
        n += runner.run_units(make_kernel(True), ff_units, input_positions, output_positions,
                              **run_kwargs)
    if plain_units and not other_stages:
        # flat-field is the only stage: the other channels are copied.
        runner.copy_channels(input_positions, output_positions,
                             sorted({(u.c_in, u.c_out) for u in plain_units}),
                             time_indices=times)
        n += len(plain_units)
    elif plain_units:
        n += runner.run_units(make_kernel(False), plain_units, input_positions,
                              output_positions, **run_kwargs)
    stages = [name for name, key in (("flat-field", "flat_field"), ("deconvolve", "deconvolve"),
                                     ("deskew", "deskew"), ("register", "registration"),
                                     ("stabilize", "stabilization")) if fs[key] is not None]
    print(f"Fused {'+'.join(stages)}: {n} (t, c) volumes across {len(input_positions)} "
          "positions")
    runner.echo_stats()
