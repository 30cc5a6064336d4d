"""Hand-written CUDA kernels (sources in ``cask_tpu_torch/csrc``), their
wrappers, launch counters and plain PyTorch twins."""
