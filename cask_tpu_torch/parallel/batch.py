"""Run a batch of distributed products and solves on every rank, numpy in and
numpy out: the rank program behind ``launch(run_batch, P, jobs)``.

A job is a dict with a ``name``, an ``op`` and its inputs (host numpy and
partitions, which pickle).  Every rank runs every job in order, so the
collectives and subgroups match across ranks, and returns
``{name: result}``:

- ``"call"``: ``DistSpmv(plan, **kw)(x)``, the global y, and the interiors
  the executor resolved;
- ``"solve"``: ``solver(padded_op, padded(b), **kw)`` for ``solver`` in
  ``cg``, ``pipelined_cg`` or ``block_cg``, with ``solve_kw`` (and ``ilu``: preconditioned by
  :func:`~cask_tpu_torch.solvers.precond.shard_ilu0` of the global CSR
  ``a``); ``kw`` is the executor's: this rank's shard of x, the iterations, the operator
  applications and the ``all_reduce`` calls;
- ``"ilu"``: :func:`shard_ilu0` of ``a``: this rank's triangular-solve
  plans and its apply to ``padded(r)``;
- ``"call2d"``, ``"solve2d"``: the same over a ``Dist2DSpmv`` of a
  ``Coo2DPartition`` (``cg`` over its ``padded_op``; x comes back as this
  rank's block).
"""

from __future__ import annotations

import numpy as np
import torch

from cask_tpu_torch.parallel.dist import Dist2DSpmv, DistSpmv
from cask_tpu_torch.parallel.mesh import mesh_2d, row_mesh


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _counted(obj, name: str):
    """Wrap ``obj.name`` to count its calls; returns the one-element counter."""
    count = [0]
    fn = getattr(obj, name)

    def wrapped(*args, **kwargs):
        count[0] += 1
        return fn(*args, **kwargs)

    setattr(obj, name, wrapped)
    return count


def _solve(op, b, job):
    from cask_tpu_torch import solvers

    solver = getattr(solvers, job.get("solver", "cg"))
    M = solvers.shard_ilu0(job["a"], op) if job.get("ilu") else None
    reduces = _counted(op.padded_op.mesh, "all_reduce")
    products = _counted(op.padded_op, "_apply")
    res = solver(op.padded_op, b, M=M, **job.get("solve_kw", {}))
    return {"x": _np(res.x), "iterations": res.iterations, "converged": res.converged,
            "residual_norm": res.residual_norm, "all_reduce": reduces[0],
            "products": products[0]}


_OPS = ("call", "solve", "ilu", "call2d", "solve2d")


def _run(job, device):
    op_name = job["op"]
    if op_name not in _OPS:
        raise ValueError(f"unknown job op {op_name!r} (one of {', '.join(_OPS)})")
    if op_name in ("call2d", "solve2d"):
        plan = job["plan"]
        op = Dist2DSpmv(plan, mesh_2d(plan.pr, plan.pc, device=device))
        if op_name == "call2d":
            return _np(op(job["x"]))
        return _solve(op, op.padded_x(job["b"]), job)
    op = DistSpmv(job["plan"], row_mesh(device=device), **job.get("kw", {}))
    if op_name == "call":
        return {"y": _np(op(job["x"])), "interior": op.interior,
                "mm_interior": op.mm_interior}
    if op_name == "solve":
        return _solve(op, op.padded(job["b"]), job)
    if op_name == "ilu":
        from cask_tpu_torch.solvers import shard_ilu0

        M = shard_ilu0(job["a"], op)
        f = M.__self__
        plans = {}
        for side, plan, data in (("lower", f._lower_plan, f._lower_data),
                                 ("upper", f._upper_plan, f._upper_data)):
            plans[side] = {k: getattr(plan, k) for k in (
                "n", "nlevels", "max_rows", "max_ents", "lvl_rows", "lvl_diag_idx",
                "lvl_ent_local", "lvl_ent_col", "lvl_ent_idx", "lvl_ent_valid")}
            plans[side]["data"] = _np(data)
        return {"plans": plans, "apply": _np(M(op.padded(job["r"])))}


def run_batch(jobs, device=None) -> dict:
    """Run ``jobs`` in order on this rank (see the module docstring)."""
    return {job["name"]: _run(job, device) for job in jobs}
