"""Per-matrix autotuner: variant search, timing on the device, and a cache
keyed on sparsity signature."""

from cask_tpu_torch.tune.cache import TunerCache, default_cache  # noqa: F401
from cask_tpu_torch.tune.timing import CudaTiming, Measurement, measure, time_cuda  # noqa: F401
from cask_tpu_torch.tune.tuner import TunedSpmv, Variant, tune  # noqa: F401
