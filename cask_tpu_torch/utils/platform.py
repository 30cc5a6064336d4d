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


def hbm_bandwidth(name: Optional[str] = None) -> tuple:
    """``(bytes_per_second, known)`` for the card called ``name``
    (default: CUDA device 0).  An unknown card gives ``(None, False)``."""
    if name is None:
        name = torch.cuda.get_device_name(default_device())
    for key in sorted(_HBM_BW_SPEC, key=len, reverse=True):
        if key in name:
            return _HBM_BW_SPEC[key], True
    return None, False
