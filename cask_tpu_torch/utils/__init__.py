"""Device and platform helpers, checkpoints, structural checks and profiling."""

from cask_tpu_torch.utils import checkpoint, debug, profiling  # noqa: F401
