"""fuse on arrays in memory: flat-field -> deconvolve -> deskew ->
register/stabilize, stage by stage on the device.

Counterpart of the compute of ``biahub_tpu/fuse.py::fuse`` (:376-868)
without its plate I/O. Each stage is the standalone verb's computation, and
the routes are the reference's:

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
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from biahub_tpu_torch.apply_inverse_transfer_function import time_indices
from biahub_tpu_torch.convert import fuse_settings_from_reference
from biahub_tpu_torch.deskew import deskew_slabbed, fill_overhang_chunked
from biahub_tpu_torch.device import as_tensor, resolve_device
from biahub_tpu_torch.estimate_stabilization import DEFAULT_MAX_BATCH_BYTES
from biahub_tpu_torch.flat_field import resolve_target_indices
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
from biahub_tpu_torch.kernels.deconvolve import deconvolve_zyx, volume_tensor
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

__all__ = ["fuse_arrays", "warp_matrices"]


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
    if unit_bytes > max_batch_bytes:
        decon_bytes = 4 * 4 * Z * Y * X
        if plan.decon is not None and decon_bytes > max_batch_bytes:
            raise ValueError(
                f"One deconvolution volume needs ~{decon_bytes / 2**30:.1f} "
                f"GiB on device, over the batch budget "
                f"({max_batch_bytes / 2**30:.1f} GiB; "
                "BIAHUB_TPU_MAX_BATCH_BYTES). An FFT has no exact spatial "
                "split on one chip — raise the budget or shard the FFT "
                "across chips (BIAHUB_TPU_SHARDED_FFT=1)."
            )
        print(f"One fused (t, c) volume needs ~{unit_bytes / 2**30:.1f} GiB, over the device "
              f"batch budget ({max_batch_bytes / 2**30:.1f} GiB); composing the standalone "
              "verbs' chunked kernels per unit instead.", file=sys.stderr)
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
            # uint16 goes into kernel A as it is; flat-field, a deskew or a
            # warp that comes first takes float32.
            vols = torch.stack([volume_tensor(tczyx[t, c], dev) for t, c in tc])
            if flat:
                vols = torch.stack([flat_field_zyx(v, device=dev) for v in vols])
            elif plan.decon is None:
                vols = vols.to(torch.float32)
            res = plan.run(vols, [t for t, _ in tc]) if (flat or other_stages) else vols
            for (t_out, _, c), r in zip(batch, res):
                out[t_out, c] = r
    return out


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
    """Each (t, c) through the standalone verbs' chunked routes in turn, in
    the standard deskewed frame with the warp matrices as given (the
    reference's ``_fuse_over_budget``, :275-373). Host memory in and out."""
    dev = plan.dev
    out = torch.empty((len(times), C) + plan.out_zyx, dtype=torch.float32)
    for t_out, t in enumerate(times):
        for c in range(C):
            vol = as_tensor(tczyx[t, c], torch.device("cpu"))
            if c in targets:
                vol = _flat_field_slabbed(vol, budget, dev)
            if plan.decon is not None:
                vol = deconvolve_zyx(as_tensor(vol, dev), prepared=plan.filt,
                                     device=dev).cpu()
            if plan.dk is not None:
                vol = _deskew_slabbed(vol, plan, budget, dev)
            m = plan.m_single if plan.m_single is not None else (
                plan.mats_per_t[t] if plan.mats_per_t is not None else None)
            if m is None:
                out[t_out, c] = vol
                continue
            shape = tuple(vol.shape)
            warp_bytes = (4 * (vol.numel() + int(np.prod(plan.out_zyx)))
                          + common_frame_bytes(m, shape, plan.out_zyx))
            if warp_bytes <= budget:
                out[t_out, c] = affine_warp_auto(as_tensor(vol, dev), m, plan.out_zyx,
                                                 device=dev).cpu()
                continue
            chunk = tuple(max(32, s // max(1, int(np.ceil(warp_bytes / budget))))
                          for s in plan.out_zyx)

            def read_fn(zs, ys, xs, _v=vol):
                return _v[zs, ys, xs]

            def write_fn(zs, ys, xs, data, _t=t_out, _c=c):
                out[_t, _c, zs, ys, xs] = data.cpu()

            chunked_affine_warp_zyx(read_fn, m, shape, plan.out_zyx, chunk,
                                    write_fn=write_fn, order=1, device=dev)
    return out
