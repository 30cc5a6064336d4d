"""Process groups, the three collectives of the distributed executors, and a
launcher for a world of ranks on one host.

The PyTorch counterpart of the JAX package's device meshes
(``row_mesh``/``mesh_2d`` in :mod:`cask_tpu.parallel.dist`): one shard per
rank of a ``torch.distributed`` group, NCCL on the card (each rank on
``cuda:{LOCAL_RANK}``, as ``torchrun`` sets it) and gloo when the caller
asks for the CPU.  The reference's three collectives become:

- ``ppermute`` of the edge slices (``_ring_halo``) → :meth:`RowMesh.ring_halo`,
  one ``batch_isend_irecv`` with both ring neighbours;
- ``all_gather(..., tiled=True)`` → :meth:`RowMesh.all_gather`
  (``all_gather_into_tensor``);
- ``psum`` → :meth:`RowMesh.all_reduce`.

Each returns a :class:`Pending` at once; its :meth:`Pending.wait` gives the
result.  On NCCL the exchange runs on the communicator's own stream, so the
kernel enqueued between the call and the wait overlaps it.  Where the
group's backend cannot take CUDA tensors (gloo, whose point-to-point and
gathers are CPU-only), every collective stages its slice through the host:
:attr:`RowMesh.staged` says so.

:func:`launch` runs a function on ``P`` spawned ranks of one host: the
counterpart of the reference's one-host fake mesh, used by the tests, the
scaling job's ``--cpu`` mode and the smoke run's four-rank phase.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

# all_gather_single is the newer name of the same call
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


class Pending:
    """A collective in flight: :meth:`wait` blocks (NCCL: makes the current
    stream wait) and returns the received tensors."""

    def __init__(self, works: Sequence, finish: Callable, keep=()):
        self._works = list(works)
        self._finish = finish
        self._keep = keep  # send buffers, alive until the exchange is done
        self._result = None
        self._done = False

    def wait(self):
        if not self._done:
            for w in self._works:
                w.wait()
            self._result = self._finish()
            self._works, self._keep, self._done = [], (), True
        return self._result


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


class RowMesh:
    """One axis of ranks: a process group, this rank's place in it and the
    device its shard lives on.  ``staged`` is true where the backend cannot
    take CUDA tensors (gloo with a CUDA device): every collective then
    copies its slice to the host and back."""

    def __init__(self, group=None, device=None):
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialized: call "
                               "init_process_group (torchrun sets its environment) or run "
                               "through cask_tpu_torch.parallel.launch")
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = dist.get_backend(group)
        if device is None:
            device = (torch.device("cuda", _local_rank() % torch.cuda.device_count())
                      if self.backend == "nccl" else torch.device("cpu"))
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
            torch.cuda.set_device(self.device)
        elif self.backend == "nccl":
            raise ValueError("an NCCL group needs a CUDA device")
        self.staged = self.backend == "gloo" and self.device.type == "cuda"

    def __repr__(self) -> str:
        return (f"RowMesh(rank {self.rank} of {self.size}, {self.backend}, {self.device}"
                f"{', staged through the host' if self.staged else ''})")

    def _global(self, r: int) -> int:
        """The global rank of this group's rank ``r`` (point-to-point peers)."""
        return r if self.group is None else dist.get_global_rank(self.group, r)

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` where the backend takes it (the host when staged)."""
        return t.cpu() if self.staged else t.contiguous()

    def _back(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device, non_blocking=False) if self.staged else t

    def ring_halo(self, x: torch.Tensor, lo: int, hi: int) -> Pending:
        """Exchange edge slices with the ring neighbours (``_ring_halo``):

            left[j]  = x of global row (base − lo + j)    (from rank p−1)
            right[j] = x of global row (base + mloc + j)  (from rank p+1)

        ``wait()`` gives ``(left, right)``, None where ``lo`` or ``hi`` is 0.
        The wraparound ranks receive the far end's slice: every matrix value
        that refers past the global edge is a structural zero.  One rank
        exchanges with itself, locally."""
        if self.size == 1 or not (lo or hi):
            left = x[x.shape[0] - lo:].clone() if lo else None
            right = x[:hi].clone() if hi else None
            return Pending((), lambda: (left, right))
        p, P = self.rank, self.size
        nxt, prv = self._global((p + 1) % P), self._global((p - 1) % P)
        ops, keep, recv = [], [], {}
        # tag 1: my last lo rows become the next rank's left; tag 2: my
        # first hi rows become the previous rank's right
        if lo:
            s = self._out(x[x.shape[0] - lo:])
            recv["left"] = torch.empty_like(s)
            keep.append(s)
            ops += [dist.P2POp(dist.isend, s, nxt, self.group, tag=1),
                    dist.P2POp(dist.irecv, recv["left"], prv, self.group, tag=1)]
        if hi:
            s = self._out(x[:hi])
            recv["right"] = torch.empty_like(s)
            keep.append(s)
            ops += [dist.P2POp(dist.isend, s, prv, self.group, tag=2),
                    dist.P2POp(dist.irecv, recv["right"], nxt, self.group, tag=2)]
        works = dist.batch_isend_irecv(ops)

        def finish():
            return tuple(self._back(recv[k]) if k in recv else None for k in ("left", "right"))

        return Pending(works, finish, keep)

    def all_gather(self, x: torch.Tensor) -> Pending:
        """The tiled all-gather: ``wait()`` gives the ``(P·rows, ...)``
        concatenation of every rank's ``x`` in rank order."""
        s = self._out(x)
        out = s.new_empty((self.size * s.shape[0],) + tuple(s.shape[1:]))
        work = _all_gather(out, s, group=self.group, async_op=True)
        return Pending((work,), lambda: self._back(out), (s,))

    def all_reduce(self, t: torch.Tensor) -> Pending:
        """The sum over the group (``psum``): ``wait()`` gives it."""
        s = t.cpu() if self.staged else t.clone()
        work = dist.all_reduce(s, group=self.group, async_op=True)
        return Pending((work,), lambda: self._back(s))


def row_mesh(nshards: Optional[int] = None, *, group=None, device=None) -> RowMesh:
    """The 1-D mesh of the row partition: the default group (or ``group``),
    one shard a rank.  ``nshards``, when given, must equal the group's size.
    ``device`` defaults to ``cuda:{LOCAL_RANK}`` on NCCL and the CPU on
    gloo."""
    mesh = RowMesh(group, device)
    if nshards is not None and nshards != mesh.size:
        raise ValueError(f"{nshards} shards asked for, but the group has {mesh.size} ranks")
    return mesh


class Mesh2D:
    """A ``pr × pc`` grid of ranks for :class:`~cask_tpu_torch.parallel.dist.Dist2DSpmv`:
    rank ``i·pc + j`` sits at ``(i, j)``.  ``cols`` is the axis along a grid
    row (the ranks sharing ``i``, over which the partial products are
    summed); ``rows`` the axis along a grid column (sharing ``j``)."""

    def __init__(self, pr: int, pc: int, rows: RowMesh, cols: RowMesh):
        self.pr, self.pc = pr, pc
        self.rows, self.cols = rows, cols
        self.device, self.staged = cols.device, cols.staged
        self.i, self.j = divmod(dist.get_rank(), pc)

    @property
    def shape(self):
        return (self.pr, self.pc)


def mesh_2d(pr: int, pc: int, *, device=None) -> Mesh2D:
    """The ``pr × pc`` grid over the default group (its size must be
    ``pr·pc``), its row and column subgroups from ``dist.new_group``, which
    every rank calls in the same order."""
    if not dist.is_initialized():
        RowMesh()  # raises with the message that says how to start
    world = dist.get_world_size()
    if world != pr * pc:
        raise ValueError(f"need {pr * pc} ranks, have {world}")
    i, j = divmod(dist.get_rank(), pc)
    col_groups = [dist.new_group([a * pc + b for b in range(pc)]) for a in range(pr)]
    row_groups = [dist.new_group([a * pc + b for a in range(pr)]) for b in range(pc)]
    return Mesh2D(pr, pc, rows=RowMesh(row_groups[j], device),
                  cols=RowMesh(col_groups[i], device))


def init_world(backend: Optional[str] = None) -> None:
    """Join the world ``torchrun`` describes (``env://``), or a world of this
    one rank when the environment names none; nothing when already joined.
    ``backend`` defaults to NCCL with a CUDA device, gloo without."""
    if dist.is_initialized():
        return
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


# -- a world of ranks on one host --------------------------------------------


def _rank_main(rank: int, world: int, backend: str, tmp: str, timeout: float) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))  # the host's cores, shared
    with open(os.path.join(tmp, "call.pkl"), "rb") as f:
        fn, args = pickle.load(f)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        result = fn(*args)
        with open(os.path.join(tmp, f"result{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(tmp, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, nprocs: int, *args, backend: str = "gloo",
           timeout: float = 300.0) -> List:
    """Run ``fn(*args)`` on ``nprocs`` ranks spawned on this host; return
    their results in rank order.

    Each rank joins a ``backend`` group through a ``FileStore`` in a
    temporary directory, with ``RANK``, ``LOCAL_RANK`` and ``WORLD_SIZE``
    set as ``torchrun`` sets them.  ``fn`` and ``args`` are pickled once;
    ``fn`` must live in a module the children can import.  The ranks are
    joined within ``timeout`` seconds; a rank that fails raises here with
    its traceback, and one that outlives the timeout is killed and raises
    ``TimeoutError``."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="cask_launch_") as tmp:
        with open(os.path.join(tmp, "call.pkl"), "wb") as f:
            pickle.dump((fn, args), f)
        ctx = mp.start_processes(_rank_main, args=(nprocs, backend, tmp, timeout),
                                 nprocs=nprocs, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{nprocs} ranks of {getattr(fn, '__name__', fn)} did "
                                       f"not finish within {timeout:.0f} s")
        except Exception as e:
            errors = [open(os.path.join(tmp, n)).read() for n in sorted(os.listdir(tmp))
                      if n.startswith("error")]
            if isinstance(e, TimeoutError):
                raise
            raise RuntimeError("a rank failed:\n" + ("\n".join(errors) or str(e))) from None
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        results = []
        for r in range(nprocs):
            with open(os.path.join(tmp, f"result{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
