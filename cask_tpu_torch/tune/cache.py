"""Persistent autotuner cache, keyed on sparsity signature.

The PyTorch counterpart of :mod:`cask_tpu.tune.cache`, in the same JSON
format: one object of entries, written to a temporary file and moved into
place, under a lock.  It records the winning kernel variant and its
timings, so a later process skips the search.  The default file is the
port's own (``~/.cache/cask_tpu_torch/tuner.json``, or
``$CASK_TPU_TORCH_TUNER_CACHE``), apart from the JAX package's: a winner
timed on another accelerator does not steer this one.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Any, Dict, Optional


class TunerCache:
    def __init__(self, path: Optional[str] = None):
        self.path = path or os.environ.get(
            "CASK_TPU_TORCH_TUNER_CACHE", os.path.expanduser("~/.cache/cask_tpu_torch/tuner.json"))
        self._lock = threading.Lock()
        self._mem: Dict[str, Any] = {}
        self._loaded = False

    def _load(self):
        if self._loaded:
            return
        self._loaded = True
        try:
            with open(self.path) as f:
                self._mem.update(json.load(f))
        except (OSError, ValueError):
            pass

    def get(self, key: str) -> Optional[dict]:
        with self._lock:
            self._load()
            return self._mem.get(key)

    def put(self, key: str, value: dict) -> None:
        with self._lock:
            self._load()
            self._mem[key] = value
            d = os.path.dirname(self.path)
            try:
                if d:
                    os.makedirs(d, exist_ok=True)
                fd, tmp = tempfile.mkstemp(dir=d or ".", suffix=".tmp")
                with os.fdopen(fd, "w") as f:
                    json.dump(self._mem, f, indent=1, sort_keys=True)
                os.replace(tmp, self.path)
            except OSError:
                pass  # the cache is best-effort; the in-memory copy still works


_global_cache: Optional[TunerCache] = None


def default_cache() -> TunerCache:
    global _global_cache
    if _global_cache is None:
        _global_cache = TunerCache()
    return _global_cache
