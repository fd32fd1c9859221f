"""Device resolution and card identification.

Every entry point of the port takes ``device=`` (default ``"cuda"``). A
request for CUDA without a card raises: the port never drops to the CPU on
its own. ``device="cpu"`` runs each kernel's plain PyTorch version.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

__all__ = ["resolve_device", "as_tensor", "gpu_info"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no
    card is present, or names a device type the port has no path for."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "biahub_tpu_torch: no CUDA device is available; pass "
                "device='cpu' to run the plain PyTorch versions"
            )
    elif dev.type != "cpu":
        raise ValueError(f"biahub_tpu_torch runs on 'cuda' or 'cpu', not {dev}")
    return dev


def as_tensor(data, device: torch.device, dtypes=(torch.float32,)) -> torch.Tensor:
    """``data`` (numpy array or tensor) as a contiguous tensor on ``device``.

    Dtypes in ``dtypes`` are kept as they are; any other dtype is cast to
    float32 (the kernels take float32, and pass A also uint16).
    """
    t = torch.from_numpy(np.ascontiguousarray(data)) if isinstance(
        data, np.ndarray
    ) else data
    if t.dtype not in dtypes:
        t = t.to(torch.float32)
    return t.to(device).contiguous()


def gpu_info() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them
    (``--query-gpu=name,power.limit --format=csv,noheader``)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
