"""The virtual-stain verb: a staining network over a plate, on the card.

Counterpart of ``biahub_tpu/virtual_stain.py``. Each timepoint's source
channels are normalized on the host as the reference does
(:func:`normalize_with_stats`: the position's ``normalization`` statistics,
else the volume's median and IQR with NumPy's interpolation), moved to the
device once, and run through :func:`sliding_window_predict`: z windows
with a linear feather, optional rotation test-time augmentation, the
window's sum and weight kept on the device, and one copy of each finished
timepoint back to the host. The network comes from :func:`load_model`:

- ``architecture: fcmae`` (``UNeXt2``, ``unext2``) runs
  :class:`~biahub_tpu_torch.models.unext2.UNeXt2`, ``2.5D`` (``2.5d``,
  ``unet25d``, ``25D``) :class:`~biahub_tpu_torch.models.unet25d.UNet25D`,
  from ``model_config`` (or viscy's nested ``model.init_args``) and the
  torch/Lightning state dict at ``ckpt_path``
  (:mod:`biahub_tpu_torch.models.convert`); each window is edge-padded to
  the encoder's divisor in Y and X and to the model's depth when the stack
  is shallower, and cropped back (:func:`make_padded_predict`);
- without an architecture, a TorchScript file (``.pt``, ``.pts``,
  ``.torchscript``) through ``torch.jit.load`` on the device, with
  ``sliding_window_z`` (5) and ``n_output_channels`` (1) from the settings.

Every call of a network runs under :func:`~biahub_tpu_torch.models.
model_precision` (``BIAHUB_TPU_MODEL_PRECISION``). The model is loaded once
per call of the verb, not once per position. Failures the reference reports
as ``click.ClickException`` raise :class:`~biahub_tpu_torch.cli.parsing.
CommandError` with its message.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from biahub_tpu_torch.cli.parsing import CommandError
from biahub_tpu_torch.cli.utils import get_output_paths
from biahub_tpu_torch.cli.yaml_reader import load_file
from biahub_tpu_torch.device import resolve_device
from biahub_tpu_torch.io.ngff import create_empty_plate, get_ome_zarr_version, open_ome_zarr
from biahub_tpu_torch.models import model_precision
from biahub_tpu_torch.runtime.executor import resolve_cluster
from biahub_tpu_torch.runtime.resources import estimate_resources

__all__ = [
    "normalize_with_stats",
    "sliding_window_predict",
    "make_padded_predict",
    "load_model",
    "predict_timepoint",
    "virtual_stain_arrays",
    "virtual_stain_position",
    "virtual_stain",
]


def normalize_with_stats(zyx, norm_meta: dict | None) -> np.ndarray:
    """``(zyx - median) / iqr`` in float32, on the host: the store's
    ``fov_statistics`` when they hold ``median`` and ``iqr``, else the
    volume's own (``np.median``, ``np.percentile``; an IQR of 0 reads as
    1)."""
    zyx = np.asarray(zyx, dtype=np.float32)
    if norm_meta and "median" in norm_meta and "iqr" in norm_meta:
        median, iqr = norm_meta["median"], norm_meta["iqr"]
    else:
        median = float(np.median(zyx))
        q75, q25 = np.percentile(zyx, [75, 25])
        iqr = float(q75 - q25) or 1.0
    return (zyx - median) / iqr


def _feather(z_out: int) -> np.ndarray:
    feather = np.ones(z_out, np.float32)
    if z_out > 2:
        ramp = np.linspace(0.1, 1.0, z_out // 2, endpoint=False)
        feather[: len(ramp)] = ramp
        feather[-len(ramp):] = ramp[::-1]
    return feather


def sliding_window_predict(predict_fn, czyx: torch.Tensor, window_z: int, step: int = 1,
                           rotation_tta: bool = False) -> torch.Tensor:
    """Sliding z-window inference with a linear feather, on ``czyx``'s
    device: ``predict_fn`` maps a (C, window_z, Y, X) tensor to (C_out,
    z_out, Y, X) with z_out <= window_z. Output placements step by
    ``step`` (clamped to z_out when a model emits fewer slices than its
    window and the step would leave gaps), each window centred on its
    placement and clamped to the volume; with ``rotation_tta`` each window
    is also predicted rotated by 90, 180 and 270 degrees in YX and the four
    predictions averaged. Returns (C_out, Z, Y, X) float32."""
    _, Z, Y, X = czyx.shape
    window_z = min(window_z, Z)
    probe = predict_fn(czyx[:, :window_z])
    c_out, z_out = probe.shape[:2]
    if z_out > window_z:
        raise ValueError(
            f"model emits {z_out} z slices per {window_z}-deep window; "
            "out_stack_depth must not exceed the sliding window depth"
        )
    out = torch.zeros((c_out, Z, Y, X), dtype=torch.float32, device=czyx.device)
    weight = torch.zeros((1, Z, 1, 1), dtype=torch.float32, device=czyx.device)
    feather = torch.from_numpy(_feather(z_out)).to(czyx.device)
    offset = (window_z - z_out) // 2
    if z_out < window_z and step > z_out:
        print(f"sliding_window_step {step} > model z output {z_out}; "
              f"clamping to {z_out} for gapless coverage")
        step = z_out
    places = list(range(0, max(Z - z_out, 0) + 1, step))
    if places[-1] != Z - z_out:
        places.append(Z - z_out)
    for place in places:
        wstart = min(max(place - offset, 0), Z - window_z)
        window = czyx[:, wstart:wstart + window_z]
        pred = probe if wstart == 0 else predict_fn(window)
        if rotation_tta:
            # np.mean over the stack of four: a running sum, then one divide.
            for k in (1, 2, 3):
                rotated = torch.rot90(window, k, dims=(-2, -1)).contiguous()
                pred = pred + torch.rot90(predict_fn(rotated), -k, dims=(-2, -1))
            pred = pred / 4
        out[:, place:place + z_out] += pred * feather[None, :, None, None]
        weight[0, place:place + z_out, 0, 0] += feather
    return out / torch.clamp(weight, min=1e-6)


def make_padded_predict(model: torch.nn.Module, d_in: int, div_h: int, div_w: int):
    """A window predictor around ``model``: edge-pad Y and X up to the
    divisors and a shallower stack up to ``d_in``, run the model under
    :func:`~biahub_tpu_torch.models.model_precision`, crop the output back
    (a padded, or full-depth, output on a shallow stack keeps its first
    slices when the depth was padded, else its centre)."""
    def predict_fn(window: torch.Tensor) -> torch.Tensor:
        _, z, y, x = window.shape
        pad_z, pad_y, pad_x = max(d_in - z, 0), -y % div_h, -x % div_w
        batch = window[None].contiguous()
        if pad_z or pad_y or pad_x:
            batch = F.pad(batch, (0, pad_x, 0, pad_y, 0, pad_z), mode="replicate")
        with model_precision():
            out = model(batch)[0]
        if out.shape[1] > z:
            start = 0 if out.shape[1] == d_in and pad_z else (out.shape[1] - z) // 2
            out = out[:, start:start + z]
        return out[..., :y, :x]

    return predict_fn


_UNEXT2_KEYS = ("in_channels", "out_channels", "in_stack_depth", "out_stack_depth",
                "encoder_blocks", "dims", "decoder_conv_blocks", "stem_kernel_size")
_UNET25D_KEYS = ("in_channels", "out_channels", "in_stack_depth", "out_stack_depth",
                 "num_filters")


def _state_dict_model(cfg: dict, model_config: dict, kind: str, device: torch.device):
    from biahub_tpu_torch.models.convert import load_into, load_torch_checkpoint

    if kind == "unext2":
        from biahub_tpu_torch.models.unext2 import UNeXt2 as Net
        keys = _UNEXT2_KEYS
    else:
        from biahub_tpu_torch.models.unet25d import UNet25D as Net
        keys = _UNET25D_KEYS
    model = Net(**{k: model_config[k] for k in keys if k in model_config})
    ckpt_path = cfg.get("ckpt_path")
    if ckpt_path is None:
        raise CommandError("Config must provide ckpt_path")
    model = load_into(model, load_torch_checkpoint(str(ckpt_path))).to(device).eval()
    if kind == "unext2":
        _, kh, kw = model.stem_kernel_size
        div_h, div_w = kh * 8, kw * 8
    else:
        div_h = div_w = 2 ** (len(model.num_filters) - 1)
    predict_fn = make_padded_predict(model, model.in_stack_depth, div_h, div_w)
    return predict_fn, model.in_stack_depth, model.out_channels


def load_model(cfg: dict, device="cuda"):
    """The configured model as ``(predict_fn, window_z, n_out)`` on
    ``device``: the routes of the module docstring, with the reference's
    errors."""
    device = resolve_device(device)
    arch = cfg.get("architecture")
    model_config = dict(cfg.get("model_config") or {})
    if isinstance(cfg.get("model"), dict):  # viscy predict schema
        init_args = cfg["model"].get("init_args", {})
        arch = arch or init_args.get("architecture")
        model_config = dict(init_args.get("model_config") or model_config)
    if arch in ("fcmae", "UNeXt2", "unext2"):
        return _state_dict_model(cfg, model_config, "unext2", device)
    if arch in ("2.5D", "2.5d", "unet25d", "25D"):
        return _state_dict_model(cfg, model_config, "unet25d", device)
    if arch is not None:
        raise CommandError(
            f"unknown architecture {arch!r}; TPU-native choices: fcmae/unext2 "
            "or 2.5D/unet25d"
        )
    ckpt_path = cfg.get("ckpt_path")
    if ckpt_path is None:
        raise CommandError("Config must provide ckpt_path")
    window_z = int(cfg.get("sliding_window_z", cfg.get("window_z", 5)))
    n_out = int(cfg.get("n_output_channels", 1))
    if not str(ckpt_path).endswith((".pt", ".pts", ".torchscript")):
        raise CommandError(
            "VisCy/cytoland is not installed; provide a TorchScript checkpoint "
            "(.pt) in ckpt_path to run virtual staining with the bundled torch "
            "runtime, or install the viscy extra."
        )
    model = torch.jit.load(str(ckpt_path), map_location=device)
    model.eval()

    def predict_fn(window: torch.Tensor) -> torch.Tensor:
        with model_precision():
            return model(window[None].contiguous())[0]

    return predict_fn, window_z, n_out


def _source_indices(cfg: dict, names: list[str]) -> list[int]:
    source_channel = cfg.get("source_channel")
    if source_channel is None:
        return [0]
    if isinstance(source_channel, str):
        return [names.index(source_channel)]
    return [names.index(c) for c in source_channel]


def predict_timepoint(sources, source_names: list[str], cfg: dict, model, norm_meta=None,
                      device="cuda") -> np.ndarray:
    """One timepoint: the source channels ``sources`` (C_src, Z, Y, X),
    named ``source_names``, normalized on the host, moved to ``device`` and
    run through :func:`sliding_window_predict` with ``model``
    (:func:`load_model`'s triple) -> (C_out, Z, Y, X) float32 in host
    memory."""
    predict_fn, window_z, _ = model
    stats = norm_meta if isinstance(norm_meta, dict) else None
    normalized = np.stack([
        normalize_with_stats(zyx, stats.get(name, {}).get("fov_statistics")
                             if stats is not None else None)
        for zyx, name in zip(sources, source_names)])
    pred = sliding_window_predict(
        predict_fn, torch.from_numpy(normalized).to(resolve_device(device)), window_z,
        step=int(cfg.get("sliding_window_step", 1)),
        rotation_tta=bool(cfg.get("rotation_tta", False)))
    return pred.cpu().numpy()


def virtual_stain_arrays(tczyx, channel_names: list[str], cfg: dict, norm_meta=None,
                         device="cuda", model=None) -> np.ndarray:
    """The verb's compute on a (T, C, Z, Y, X) array in memory -> (T, C_out,
    Z, Y, X) float32; ``cfg`` is the settings as loaded."""
    model = model or load_model(cfg, device)
    indices = _source_indices(cfg, list(channel_names))
    names = [channel_names[c] for c in indices]
    return np.stack([predict_timepoint(np.stack([tczyx[t, c] for c in indices]), names, cfg,
                                       model, norm_meta, device)
                     for t in range(tczyx.shape[0])])


def virtual_stain_position(config_filepath, input_position_path, output_position_path,
                           device="cuda", model=None) -> None:
    """One position, timepoint by timepoint, into its output array."""
    cfg = load_file(config_filepath)
    model = model or load_model(cfg, device)
    in_pos = open_ome_zarr(input_position_path, mode="r")
    out_arr = open_ome_zarr(output_position_path, mode="r+")["0"]
    names = in_pos.channel_names
    indices = _source_indices(cfg, names)
    norm_meta = in_pos.zattrs.get("normalization", {})
    for t in range(in_pos.data.shape[0]):
        t0 = time.perf_counter()
        sources = np.stack([in_pos.data[t, c] for c in indices])
        out_arr[t] = predict_timepoint(sources, [names[c] for c in indices], cfg, model,
                                       norm_meta, device)
        print(f"t={t}: {time.perf_counter() - t0:.2f}s")


def virtual_stain(input_position_dirpaths, config_filepath, output_dirpath,
                  sbatch_filepath=None, cluster=None, local=False, monitor=True,
                  init_only=False, device="cuda") -> None:
    """The verb on plates: an output plate of ``output_channels`` (default
    ``["virtual_stain"]``) float32 at the input's shape and scale, each
    position stamped with the settings (``biahub-virtual_stain``). As the
    reference, ``--init`` creates the plate and prints nothing more."""
    device = resolve_device(device)
    output_dirpath = Path(output_dirpath)
    cfg = load_file(config_filepath)
    output_channels = cfg.get("output_channels", ["virtual_stain"])
    input_dataset = open_ome_zarr(input_position_dirpaths[0], mode="r")
    T, C, Z, Y, X = input_dataset.data.shape
    create_empty_plate(
        store_path=output_dirpath,
        position_keys=[Path(p).parts[-3:] for p in input_position_dirpaths],
        channel_names=list(output_channels),
        shape=(T, len(output_channels), Z, Y, X),
        scale=input_dataset.scale,
        dtype=np.float32,
        version=get_ome_zarr_version(Path(input_position_dirpaths[0]).parents[2]),
    )
    estimate_resources(shape=(T, C, Z, Y, X), ram_multiplier=8, max_num_cpus=16)
    if init_only:
        return
    resolve_cluster(cluster, local)
    model = load_model(cfg, device)
    for in_path, out_path in zip(input_position_dirpaths,
                                 get_output_paths(input_position_dirpaths, output_dirpath)):
        open_ome_zarr(out_path, mode="r+").update_zattrs({"biahub-virtual_stain": cfg})
        virtual_stain_position(config_filepath, in_path, out_path, device, model)
        print(f"Virtual staining complete: {in_path}")
