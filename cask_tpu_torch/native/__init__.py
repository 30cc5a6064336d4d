"""The port's copy of the native C++ preprocessing core.

Use :mod:`cask_tpu_torch.native.binding`; the callers with a numpy path
take it when the toolchain is absent."""

from cask_tpu_torch.native.binding import NativeUnavailable, available  # noqa: F401
