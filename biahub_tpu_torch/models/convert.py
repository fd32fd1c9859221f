"""Checkpoints of the model verbs, and the reference's weights carried over.

Counterpart of ``biahub_tpu/models/convert.py``. The reference reads a torch
checkpoint and turns it into flax variables; the port's networks keep the
torch layout, so loading is the reference's reading without the layout
change:

- :func:`load_torch_checkpoint` (UNeXt2 and UNet25D) takes a bare state dict
  or a Lightning payload (weights under ``state_dict``), strips the
  ``state_dict.`` and ``model.`` prefixes, refuses a VisCy/timm schema with
  the reference's message (:func:`_reject_foreign_schema`) and any leaf the
  reference does not convert;
- :func:`load_cpnet_checkpoint` takes a cellpose-schema CPnet state dict
  (bare, or under ``state_dict`` or ``model``), strips ``state_dict.``,
  ``model.`` and ``net.``, refuses a file without the schema's marker key
  with the reference's message, and infers ``(nbase, nout, sz)``
  (:func:`cpnet_config_from_state_dict`).

Both read with ``torch.load(..., map_location="cpu", weights_only=True)``,
as the reference does. :func:`state_dict_from_flax` and
:func:`cpnet_state_dict_from_flax` invert the reference's
``torch_state_dict_to_flax`` and ``torch_cpnet_to_flax``: flax variables as
nested dicts of numpy arrays become the port's state dicts (HWIO -> OIHW,
DHWIO -> OIDHW, Dense (in, out) -> Linear (out, in), LayerNorm and
BatchNorm ``scale`` -> ``weight``, BatchNorm ``mean`` / ``var`` -> running
statistics), so both packages can run the same weights.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

__all__ = [
    "load_torch_checkpoint",
    "load_cpnet_checkpoint",
    "cpnet_config_from_state_dict",
    "state_dict_from_flax",
    "cpnet_state_dict_from_flax",
    "load_into",
]

_CPNET_MARKER = "downsample.down.res_down_0.conv.conv_0.0.weight"


def _reject_foreign_schema(keys) -> None:
    """Refuse VisCy/timm module paths, with the reference's message."""
    markers = (".stages.", ".blocks.", "conv_dw", "mlp.fc", "downsample_layers")
    hits = sorted({k for k in keys for m in markers if m in k})[:3]
    if hits:
        raise ValueError(
            "checkpoint uses a VisCy/timm module schema (e.g. "
            + ", ".join(repr(h) for h in hits)
            + "); only the in-repo twin schema (models/torch_twin.py) converts "
            "to flax. For production VisCy checkpoints, export the model with "
            "torch.jit.script/trace and point ckpt_path at the TorchScript "
            "file WITHOUT setting `architecture` in the settings YAML — "
            "virtual-stain then runs it via the TorchScript fallback."
        )


def _strip(key: str, prefixes) -> str:
    for prefix in prefixes:
        if key.startswith(prefix):
            key = key[len(prefix):]
    return key


def _tensor(value: Any) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.asarray(value, dtype=np.float32))


def state_dict_from_checkpoint(state_dict: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A UNeXt2/UNet25D-schema state dict with its prefixes stripped and GRN
    parameters flattened, checked as the reference's converter checks it."""
    _reject_foreign_schema(state_dict.keys())
    out = {}
    for key, value in state_dict.items():
        key = _strip(key, ("state_dict.", "model."))
        leaf = key.split(".")[-1]
        w = _tensor(value)
        if leaf in ("gamma", "beta") and w.ndim > 1:
            w = w.reshape(-1)
        if leaf == "weight" and w.ndim not in (1, 2, 4, 5):
            raise ValueError(f"unexpected weight rank for {key}: {tuple(w.shape)}")
        if leaf not in ("weight", "bias", "gamma", "beta"):
            raise ValueError(f"unrecognized parameter {key}")
        out[key] = w
    return out


def load_torch_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """The state dict of a ``.pt``/``.ckpt``/``.pth`` file (bare, or a
    Lightning payload), for :class:`~biahub_tpu_torch.models.unext2.UNeXt2`
    or :class:`~biahub_tpu_torch.models.unet25d.UNet25D`."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(payload, dict) and "state_dict" in payload:
        payload = payload["state_dict"]
    return state_dict_from_checkpoint(payload)


def _is_cpnet_state_dict(keys) -> bool:
    return any(k.endswith(_CPNET_MARKER) for k in keys)


def cpnet_config_from_state_dict(state_dict: Mapping[str, Any]) -> dict:
    """``{"nbase", "nout", "sz"}`` of a cellpose-schema state dict."""
    def find(suffix):
        for k in state_dict:
            if k.endswith(suffix):
                return k
        raise KeyError(suffix)

    n_down = len({m.group(1) for k in state_dict
                  for m in [re.search(r"res_down_(\d+)\.", k)] if m})
    nbase = []
    sz = 0
    for n in range(n_down):
        o, i, sz, _ = tuple(state_dict[find(f"res_down_{n}.conv.conv_0.2.weight")].shape)
        if n == 0:
            nbase.append(int(i))
        nbase.append(int(o))
    nout = tuple(state_dict[find("output.2.weight")].shape)[0]
    return {"nbase": tuple(nbase), "nout": int(nout), "sz": int(sz)}


def load_cpnet_checkpoint(path: str) -> tuple[dict[str, torch.Tensor], dict]:
    """(state dict, config) of a cellpose-schema CPnet ``.pt`` file."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(payload, dict) and "state_dict" in payload:
        payload = payload["state_dict"]
    if isinstance(payload, dict) and "model" in payload and not _is_cpnet_state_dict(payload):
        payload = payload["model"]
    if not _is_cpnet_state_dict(payload):
        raise ValueError(
            f"{path} is not a cellpose-schema CPnet state dict (missing "
            f"'{_CPNET_MARKER}'); native TPU segmentation needs a CPnet "
            "checkpoint (e.g. saved by the cellpose package). Built-in "
            "'threshold_otsu' runs without any checkpoint."
        )
    out = {}
    for key, value in payload.items():
        key = _strip(key, ("state_dict.", "model.", "net."))
        leaf = key.split(".")[-1]
        if leaf == "num_batches_tracked":
            continue
        if leaf not in ("weight", "bias", "running_mean", "running_var"):
            raise ValueError(f"unrecognized CPnet parameter {key}")
        out[key] = _tensor(value)
    return out, cpnet_config_from_state_dict(out)


def load_into(module: torch.nn.Module, state_dict: Mapping[str, torch.Tensor]):
    """Load ``state_dict`` into ``module``: every parameter and buffer must
    be given (BatchNorm's ``num_batches_tracked`` aside) and nothing else."""
    missing, unexpected = module.load_state_dict(dict(state_dict), strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError(f"checkpoint does not fit the network: missing {missing[:5]}, "
                         f"unexpected {list(unexpected)[:5]}")
    return module


def _leaves(tree: Mapping, path=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, path + (str(key),))
        else:
            yield path + (str(key),), value


def _torch_weight(kernel) -> torch.Tensor:
    w = np.asarray(kernel, dtype=np.float32)
    if w.ndim == 5:
        w = w.transpose(4, 3, 0, 1, 2)
    elif w.ndim == 4:
        w = w.transpose(3, 2, 0, 1)
    elif w.ndim == 2:
        w = w.T
    else:
        raise ValueError(f"unexpected kernel rank {w.shape}")
    return torch.from_numpy(np.ascontiguousarray(w))


def state_dict_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """The UNeXt2 or UNet25D state dict of the reference's flax variables
    (``{"params": tree}``)."""
    out = {}
    for path, value in _leaves(variables["params"]):
        *parents, leaf = path
        if leaf == "kernel":
            w, leaf = _torch_weight(value), "weight"
        else:
            w = torch.from_numpy(np.array(value, dtype=np.float32))
            leaf = "weight" if leaf == "scale" else leaf
        out[".".join([*parents, leaf])] = w
    return out


def _cpnet_path(parts) -> list[str]:
    """The flax path of a CPnet leaf's module with cellpose's containers put
    back: ``down`` / ``up`` under ``downsample`` / ``upsample`` and ``conv``
    before each ``conv_T``."""
    out = []
    for part in parts:
        if re.fullmatch(r"conv_\d", part):
            out.append("conv")
        out.append(part)
        if part in ("downsample", "upsample") and len(out) == 1:
            out.append("down" if part == "downsample" else "up")
    return out


def cpnet_state_dict_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """The CPnet state dict of the reference's flax variables
    (``{"params": ..., "batch_stats": ...}``)."""
    out = {}
    names = {"kernel": "weight", "scale": "weight", "bias": "bias", "mean": "running_mean",
             "var": "running_var"}
    for collection in ("params", "batch_stats"):
        for path, value in _leaves(variables[collection]):
            *parents, leaf = path
            w = _torch_weight(value) if leaf == "kernel" else torch.from_numpy(
                np.array(value, dtype=np.float32))
            out[".".join(_cpnet_path(parents) + [names[leaf]])] = w
    return out
