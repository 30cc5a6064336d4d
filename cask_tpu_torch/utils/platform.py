"""The CUDA device and its published memory bandwidth.

The PyTorch counterpart of :mod:`cask_tpu.utils.platform`.  There is no
silent fallback: :func:`default_device` raises without a CUDA device, so a
measurement can never be taken on the CPU under a GPU's name.
"""

from __future__ import annotations

from typing import Optional

import torch

# Published HBM bandwidth (bytes/s) by ``torch.cuda.get_device_name()``
# substring, from NVIDIA's H100 data sheet; longest match wins.
_HBM_BW_SPEC = {
    "H100 80GB HBM3": 3.35e12,  # H100 SXM5 80 GB
    "H100 PCIe": 2.0e12,
    "H100 NVL": 3.9e12,
}


def default_device() -> torch.device:
    """``torch.device("cuda")``; raises when no CUDA device is visible."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    return torch.device("cuda")


def plan_device(x, device=None) -> torch.device:
    """Where a plan or operator built from a matrix whose array is ``x``
    lives: ``device`` when given, else ``x``'s device when it is a tensor,
    else (host numpy) :func:`default_device`, which raises without CUDA.
    The CPU is used only when the caller asks for it."""
    if device is not None:
        return torch.device(device)
    if isinstance(x, torch.Tensor):
        return x.device
    return default_device()


def hbm_bandwidth(name: Optional[str] = None) -> tuple:
    """``(bytes_per_second, known)`` for the card called ``name``
    (default: CUDA device 0).  An unknown card gives ``(None, False)``."""
    if name is None:
        name = torch.cuda.get_device_name(default_device())
    for key in sorted(_HBM_BW_SPEC, key=len, reverse=True):
        if key in name:
            return _HBM_BW_SPEC[key], True
    return None, False
