"""Timing on the device (the autotuner itself is not ported yet)."""

from cask_tpu_torch.tune.timing import CudaTiming, time_cuda  # noqa: F401
