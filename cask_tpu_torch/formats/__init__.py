"""Sparse formats: containers, conversions, generators."""

from cask_tpu_torch.formats.matrix import BSR, COO, CSR  # noqa: F401
