"""Benchmark harness and CLI over the tuner (``python -m cask_tpu_torch.bench.cli``)."""

from cask_tpu_torch.bench.harness import bench_matrix, bench_suite  # noqa: F401
from cask_tpu_torch.bench.roofline import OpTraffic, chip_bandwidth, spmv_traffic  # noqa: F401
