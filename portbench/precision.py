"""The precisions the reference computes in: ``exact`` (float64, the
comparison's yardstick), and the steps below a configuration's stated type
that the control takes (``float32`` below float64; ``tf32`` below float32
with TF32 off: a 10-bit significand, round to nearest even, summed in
float32, as a TF32 tensor-core product sums)."""

from __future__ import annotations

import torch

WORKING = {"exact": torch.float64, "float32": torch.float32, "tf32": torch.float32}


def control_precision(cfg) -> str:
    """The nearest precision below the one the configuration states."""
    if cfg["dtype"] == "float64":
        return "float32"
    if cfg["dtype"] == "float32" and not cfg.get("tf32", False):
        return "tf32"
    raise ValueError(f"no control precision below {cfg['dtype']} (tf32={cfg.get('tf32')})")


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32's 10-bit significand, to nearest even."""
    bits = t.abs().view(torch.int32).to(torch.int64)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.to(torch.int32).view(torch.float32).copysign(t)


def as_precision(t: torch.Tensor, precision: str):
    """``t`` in ``precision``'s working type, rounded to it; and that type."""
    dt = WORKING[precision]
    out = t.to(dt)
    if precision == "tf32":
        out = round_tf32(out)
    return out, dt
