"""Checkpoint and resume of expensive preprocessing.

The PyTorch counterpart of :mod:`cask_tpu.utils.checkpoint`: a CSR matrix,
an ILU(0) factorization (its combined LU values on A's pattern) and a DIA
plan saved as ``.npz`` files, so that a long job resumes without running
its host preprocessing again.  Each function writes the reference's
``.npz`` keys and JSON ``meta``, so each package loads the other's files.
Values are saved from host copies (a bfloat16 plan's values as their exact
float32, numpy having no bfloat16).
"""

from __future__ import annotations

import json
from typing import Tuple

import numpy as np

from cask_tpu_torch.formats.matrix import CSR, host, to_device
from cask_tpu_torch.utils.platform import plan_device


def save_csr(path: str, a: CSR, **extra_meta) -> None:
    np.savez_compressed(
        path,
        data=host(a.data),
        indices=host(a.indices),
        indptr=host(a.indptr),
        meta=json.dumps({"shape": list(a.shape), **extra_meta}),
    )


def load_csr(path: str) -> Tuple[CSR, dict]:
    """The saved matrix as a host CSR, and the rest of its ``meta``."""
    z = np.load(path, allow_pickle=False)
    meta = json.loads(str(z["meta"]))
    a = CSR(data=z["data"], indices=z["indices"], indptr=z["indptr"],
            shape=tuple(meta.pop("shape")))
    return a, meta


def save_ilu0(path: str, factors) -> None:
    """Persist an ILU(0) factorization (pattern and combined LU values)."""
    save_csr(path, factors.lu, kind="ilu0")


def load_ilu0(path: str, *, device=None):
    """Rebuild :class:`~cask_tpu_torch.ops.ilu.ILU0Factors` from disk: the
    values load as they are, the two triangles' solve plans are rebuilt from
    the pattern on ``device`` (the CUDA device unless given; raises without
    one)."""
    from cask_tpu_torch.ops.ilu import ilu0_factors

    lu, meta = load_csr(path)
    if meta.get("kind") != "ilu0":
        raise ValueError(f"{path} is not an ilu0 checkpoint")
    return ilu0_factors(lu, device=plan_device(None, device))


def save_dia(path: str, dia) -> None:
    np.savez_compressed(
        path,
        vals=host(dia.vals),
        rem_data=host(dia.rem_data),
        rem_row=host(dia.rem_row),
        rem_col=host(dia.rem_col),
        meta=json.dumps({"shape": list(dia.shape), "offsets": list(dia.offsets),
                         "kind": "dia"}),
    )


def load_dia(path: str, *, device=None):
    """The saved :class:`~cask_tpu_torch.ops.dia.DiaMatrix` on ``device`` (the
    CUDA device unless given; raises without one)."""
    from cask_tpu_torch.ops.dia import DiaMatrix

    z = np.load(path, allow_pickle=False)
    meta = json.loads(str(z["meta"]))
    if meta.get("kind") != "dia":
        raise ValueError(f"{path} is not a dia checkpoint")
    dev = plan_device(None, device)
    return DiaMatrix(
        vals=to_device(z["vals"], dev),
        rem_data=to_device(z["rem_data"], dev),
        rem_row=to_device(z["rem_row"], dev),
        rem_col=to_device(z["rem_col"], dev),
        vals_t=None,
        offsets=tuple(meta["offsets"]),
        shape=tuple(meta["shape"]),
    )
