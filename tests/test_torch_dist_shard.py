"""A rank-local BDIA shard (``interop.bdia_shard_from_arrays``,
:class:`cask_tpu_torch.parallel.BdiaRankShard`) on the CPU.

Each rank's block rows of the FEM block matrix are built here from those
rows alone, as a user holds them (:func:`_rank_rows`): they equal the host
partitions' shard (``fem_bdia_partition``, ``partition_bdia``), and the
edge windows cut from them equal the host's bit for bit, for P ∈ {1, 2, 3,
4}, uneven last shards and shards that are not a whole tile.  On spawned
gloo worlds of 2 and 4 ranks, ``DistSpmv`` over such shards equals the plain
reference (:mod:`plain_block_rows`, float64) within 1e-12 and the host
partition's ``DistSpmv`` to the bit, with the overlap on and off; its
counters count the ring's bytes.  On a world of one: the spans of a product
and of a build, none opened with no profiler running, and the refusals.

No JAX here: the spawned ranks import this module.
"""

import collections
import glob
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import cask_tpu_torch as ct
import cask_tpu_torch.formats.convert as tconv
import cask_tpu_torch.parallel as tpar
from cask_tpu_torch import interop
from cask_tpu_torch.parallel.partition import (_fem_formula_val, fem_bdia_partition,
                                               fem_formula_bsr, partition_bdia)
from cask_tpu_torch.utils.profiling import trace
from plain_block_rows import block_rows_product, neighbours

DOF = 4
GRIDS = [(7, 5), (40, 30)]  # 35 block rows (no shard a whole tile); 1200 (two tiles at P = 1)
WORLDS = (2, 4)
DIST_SPANS = ("dist.exchange", "dist.interior", "dist.fixup")


def _offsets(ny):
    return (-ny, -1, 0, 1, ny)


def _block(ny, dof=DOF):
    """The blocks of the formulaic FEM matrix (``fem_bdia_partition``'s values)."""
    offs = _offsets(ny)

    def block(i, d):
        dpos = offs.index(d)
        out = torch.empty((len(i), dof, dof), dtype=torch.float64)
        for r in range(dof):
            for c in range(dof):
                v = torch.from_numpy(_fem_formula_val(i.numpy(), dpos, r, c, dof))
                out[:, r, c] = v + (4.0 * dof if d == 0 and r == c else 0.0)
        return out

    return block


def _geometry(nx, ny, P, ts):
    nbr = nx * ny
    nbloc = -(-nbr // P)
    tiles = -(-nbloc // (ts * 128))
    return nbr, nbloc, tiles


def _rank_rows(nx, ny, P, p, ts, dtype=torch.float32):
    """Rank ``p``'s block rows ``[p·nbloc, (p+1)·nbloc)`` in the
    ``bdia_from_arrays`` layout, made from those rows alone."""
    nbr, nbloc, tiles = _geometry(nx, ny, P, ts)
    i = p * nbloc + torch.arange(tiles * ts * 128)
    real = (i < p * nbloc + nbloc) & (i < nbr)
    vals = torch.zeros((DOF, tiles, 5 * DOF, ts, 128), dtype=torch.float64)
    block = _block(ny)
    for dpos, d in enumerate(_offsets(ny)):
        ok = real.clone()
        ok[real] = neighbours(i[real], d, nx, ny)
        b = torch.zeros((len(i), DOF, DOF), dtype=torch.float64)
        b[ok] = block(i[ok], d)
        for c in range(DOF):
            vals[:, :, dpos * DOF + c] = b[:, :, c].T.reshape(DOF, tiles, ts, 128)
    return vals.to(dtype)


def _shard(vals, nx, ny, P, p, ts):
    return interop.bdia_shard_from_arrays(vals, block_offsets=_offsets(ny),
                                          shape=(nx * ny * DOF,) * 2, blocksize=(DOF, DOF),
                                          ts=ts, rank=p, nshards=P)


def _same_bits(a: torch.Tensor, b: np.ndarray):
    assert tuple(a.shape) == b.shape and a.dtype == torch.from_numpy(b[:0]).dtype
    assert a.numpy().tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# the shard against the host partitions, in process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P", [1, 2, 3, 4])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_shard_equals_fem_bdia_partition(grid, P):
    nx, ny = grid
    plan = fem_bdia_partition(nx, ny, dof=DOF, nshards=P)
    for p in range(P):
        vals = _rank_rows(nx, ny, P, p, plan.ts)
        _same_bits(vals, plan.vals[p])
        sh = _shard(vals, nx, ny, P, p, plan.ts)
        _same_bits(sh.head_vals, plan.head_vals[p])
        _same_bits(sh.tail_vals, plan.tail_vals[p])
        assert (sh.nbloc, sh.mloc, sh.shape, sh.block_offsets) == \
            (plan.nbloc, plan.mloc, plan.shape, plan.block_offsets)
        assert (sh.halo_lo_b, sh.halo_hi_b, sh.pairs, sh.npairs) == \
            (plan.halo_lo_b, plan.halo_hi_b, plan.pairs, plan.npairs)


@pytest.mark.parametrize("P", [1, 2, 3, 4])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_shard_equals_partition_bdia(grid, P):
    nx, ny = grid
    bsr = fem_formula_bsr(nx, ny, dof=DOF, dtype=np.float32)
    plan = partition_bdia(bsr, P)
    assert plan.remainder is None and plan.block_offsets == _offsets(ny)
    for p in range(P):
        vals = _rank_rows(nx, ny, P, p, plan.ts)
        _same_bits(vals, plan.vals[p])
        sh = _shard(vals, nx, ny, P, p, plan.ts)
        _same_bits(sh.head_vals, plan.head_vals[p])
        _same_bits(sh.tail_vals, plan.tail_vals[p])


def test_edge_windows_keep_signed_zeros_and_other_dtypes():
    """The windows are the pack's values multiplied by 1 or 0, as the host
    multiplies them: −0.0 and the products with 0 keep their signs."""
    nx, ny, P = 7, 5, 2
    plan = fem_bdia_partition(nx, ny, dof=DOF, nshards=P, dtype=np.float64)
    vals = torch.from_numpy(-np.abs(plan.vals[1]))  # every value negative, zeros −0.0
    sh = _shard(vals, nx, ny, P, 1, plan.ts)
    from cask_tpu_torch.parallel.partition import _bdia_edge_windows

    head, tail = _bdia_edge_windows(vals.numpy()[None], np.asarray(_offsets(ny)), DOF,
                                    plan.nbloc, plan.ts, vals.shape[1])
    _same_bits(sh.head_vals, head[0])
    _same_bits(sh.tail_vals, tail[0])
    half = _shard(vals.to(torch.bfloat16), nx, ny, P, 1, plan.ts)
    assert half.head_vals.dtype == torch.bfloat16
    assert torch.equal(half.head_vals, sh.head_vals.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# the refusals
# ---------------------------------------------------------------------------


def _args(nx=7, ny=5, P=2, p=0, ts=8):
    return dict(block_offsets=_offsets(ny), shape=(nx * ny * DOF,) * 2, blocksize=(DOF, DOF),
                ts=ts, rank=p, nshards=P)


def test_constructor_refuses_a_wrong_layout():
    vals = _rank_rows(7, 5, 2, 0, 8)
    with pytest.raises(ValueError, match="is not \\(br, T, npairs, ts, 128\\)"):
        interop.bdia_shard_from_arrays(vals[:, :, :-1], **_args())  # a pair short
    with pytest.raises(ValueError, match="is not \\(br, T, npairs, ts, 128\\)"):
        interop.bdia_shard_from_arrays(vals, **dict(_args(), ts=16))
    with pytest.raises(ValueError, match="is not \\(br, T, npairs, ts, 128\\)"):
        interop.bdia_shard_from_arrays(torch.cat([vals, vals], 1), **_args())  # a tile more
    with pytest.raises(TypeError, match="tensor"):
        interop.bdia_shard_from_arrays(vals.numpy(), **_args())
    with pytest.raises(ValueError, match="square"):
        interop.bdia_shard_from_arrays(vals, **dict(_args(), blocksize=(DOF, 2)))


def test_constructor_refuses_a_multi_hop_offset():
    # 35 block rows over 4 shards of 9: an offset of 10 reaches two shards on
    vals = torch.zeros((DOF, 1, 5 * DOF, 8, 128))
    with pytest.raises(ValueError, match="multi-hop"):
        interop.bdia_shard_from_arrays(vals, **dict(_args(P=4), block_offsets=(-10, -1, 0, 1,
                                                                                 10)))


def test_constructor_refuses_a_wrong_nbloc_and_an_empty_shard():
    vals = _rank_rows(7, 5, 2, 0, 8)
    with pytest.raises(ValueError, match="nbloc 17 is not ceil"):
        interop.bdia_shard_from_arrays(vals, **_args(), nbloc=17)
    assert interop.bdia_shard_from_arrays(vals, **_args(), nbloc=18).nbloc == 18
    with pytest.raises(ValueError, match="no rows"):  # 5 block rows over 4 shards of 2
        interop.bdia_shard_from_arrays(torch.zeros((DOF, 1, 3 * DOF, 8, 128)),
                                       **dict(_args(nx=5, ny=1, P=4),
                                              block_offsets=(-1, 0, 1)))
    with pytest.raises(ValueError, match="rank 2 is not one of 2"):
        interop.bdia_shard_from_arrays(vals, **_args(p=2))


@pytest.fixture()
def one_rank():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield tpar.row_mesh()
    finally:
        dist.destroy_process_group()


def test_distspmv_refuses_a_shard_of_another_world(one_rank):
    vals = _rank_rows(7, 5, 2, 0, 8)
    with pytest.raises(ValueError, match="2 shards but the mesh has 1"):
        tpar.DistSpmv(_shard(vals, 7, 5, 2, 0, 8), one_rank)


# ---------------------------------------------------------------------------
# one rank: products, spans and counters
# ---------------------------------------------------------------------------


def _x(nx, ny, k=None, seed=5):
    n = nx * ny * DOF
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n,) if k is None else (n, k), generator=g, dtype=torch.float64)


@pytest.mark.parametrize("overlap", [True, False])
def test_one_rank_equals_the_plain_reference(one_rank, overlap):
    nx, ny = GRIDS[1]
    op = tpar.DistSpmv(_shard(_rank_rows(nx, ny, 1, 0, 8, torch.float64), nx, ny, 1, 0, 8),
                       one_rank, overlap=overlap)
    assert (op.interior, op.mm_interior) == ("plain", "plain")
    for k in (None, 3):
        x = _x(nx, ny, k)
        want = block_rows_product(nx, ny, DOF, 0, nx * ny, x, _block(ny))
        got = (ct.spmv if k is None else ct.spmm)(op.padded_op, op.padded(x))
        assert float((got - want).norm() / want.norm()) <= 1e-12
        assert torch.equal(got, op(x))
    assert op.calls == 4 and op.halo_bytes == 0  # one rank sends nothing


def test_spmv_takes_a_shard_operator_by_the_automatic_route_only(one_rank):
    nx, ny = GRIDS[0]
    op = tpar.DistSpmv(_shard(_rank_rows(nx, ny, 1, 0, 8), nx, ny, 1, 0, 8), one_rank)
    x = op.padded(_x(nx, ny).float())
    with pytest.raises(ValueError, match="automatic product only"):
        ct.spmv(op.padded_op, x, transpose=True)
    with pytest.raises(ValueError, match="automatic product only"):
        ct.spmm(op.padded_op, x[:, None], method="xla")
    with pytest.raises(TypeError, match="unsupported matrix type"):
        ct.spmv(lambda v: v, x)  # a callable is no matrix
    assert op.calls == 0


def _user_spans(logdir):
    (path,) = glob.glob(os.path.join(logdir, "*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def test_spans_and_counters_of_a_build_and_a_product(one_rank, tmp_path):
    nx, ny = GRIDS[0]
    vals = _rank_rows(nx, ny, 1, 0, 8)
    builds, build_s = interop.bdia_shard_from_arrays.builds, interop.bdia_shard_from_arrays.build_s
    with trace(str(tmp_path / "build")) as d:
        sh = _shard(vals, nx, ny, 1, 0, 8)
    spans = _user_spans(d)
    assert [e["name"] for e in spans] == ["dist.shard_build"]
    assert interop.bdia_shard_from_arrays.builds == builds + 1
    took = interop.bdia_shard_from_arrays.build_s - build_s
    assert 0 < took <= spans[0]["dur"] * 1e-6 + 0.05  # host seconds around the span
    op = tpar.DistSpmv(sh, one_rank)
    x = op.padded(_x(nx, ny).float())
    with trace(str(tmp_path / "product")) as d:
        y = ct.spmv(op.padded_op, x)
    spans = {e["name"]: e for e in _user_spans(d)}
    assert collections.Counter(e["name"] for e in _user_spans(d)) == \
        collections.Counter(DIST_SPANS)
    # in program order, each after the one before
    starts = [spans[n]["ts"] for n in DIST_SPANS]
    assert starts == sorted(starts)
    assert op.calls == 1 and op.halo_bytes == 0
    assert torch.equal(y, op.padded_op(x))


def test_no_range_without_a_profiler(one_rank, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    nx, ny = GRIDS[0]
    op = tpar.DistSpmv(_shard(_rank_rows(nx, ny, 1, 0, 8), nx, ny, 1, 0, 8), one_rank)
    op.padded_op(op.padded(_x(nx, ny).float()))
    assert op.calls == 1


# ---------------------------------------------------------------------------
# worlds of gloo ranks, each building its shard from its own rows
# ---------------------------------------------------------------------------


def _rank_program(grids, k):
    """Every rank: its shard from its own rows, then ``DistSpmv`` over it and
    over the host partition, overlap on and off, SpMV and SpMM (``k``
    columns); the counters; the refusal of a neighbour's shard."""
    mesh = tpar.row_mesh()
    P, p = mesh.size, mesh.rank
    out = {}
    for nx, ny in grids:
        sh = _shard(_rank_rows(nx, ny, P, p, 8, torch.float64), nx, ny, P, p, 8)
        host = fem_bdia_partition(nx, ny, dof=DOF, nshards=P, dtype=np.float64)
        for overlap in (True, False):
            op = tpar.DistSpmv(sh, mesh, overlap=overlap)
            hop = tpar.DistSpmv(host, mesh, overlap=overlap)
            for kk in (None, k):
                x = _x(nx, ny, kk)
                y = (ct.spmv if kk is None else ct.spmm)(op.padded_op, op.padded(x))
                out[(nx, ny, overlap, kk)] = (y.numpy(), hop.padded_op(hop.padded(x)).numpy())
            out[(nx, ny, overlap, "counters")] = (op.calls, op.halo_bytes)
        other = _shard(_rank_rows(nx, ny, P, (p + 1) % P, 8), nx, ny, P, (p + 1) % P, 8)
        try:
            tpar.DistSpmv(other, mesh)
        except ValueError as e:
            out[(nx, ny, "refused")] = str(e)
    return out


@pytest.fixture(scope="module")
def worlds():
    return {P: tpar.launch(_rank_program, P, GRIDS, 3, timeout=300.0) for P in WORLDS}


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("k", [None, 3])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("P", WORLDS)
def test_ranks_equal_the_plain_reference_and_the_host_partition(worlds, P, grid, k, overlap):
    nx, ny = grid
    nbr, nbloc, _ = _geometry(nx, ny, P, 8)
    x = _x(nx, ny, k)
    for p, res in enumerate(worlds[P]):
        y, y_host = res[(nx, ny, overlap, k)]
        assert y.tobytes() == y_host.tobytes()  # the same program on the same values
        r0, r1 = p * nbloc, min((p + 1) * nbloc, nbr)
        want = block_rows_product(nx, ny, DOF, r0, r1, x, _block(ny))
        got = torch.from_numpy(y[: (r1 - r0) * DOF])
        assert float((got - want).norm() / want.norm()) <= 1e-12
        assert not y[(r1 - r0) * DOF:].any()  # the padding rows stay zero


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("P", WORLDS)
def test_ranks_count_calls_and_ring_bytes(worlds, P, grid):
    nx, ny = grid
    for p, res in enumerate(worlds[P]):
        for overlap in (True, False):
            calls, halo_bytes = res[(nx, ny, overlap, "counters")]
            assert calls == 2
            # each call sends ny block rows to each neighbour, 8-byte values, 1 and 3 columns
            assert halo_bytes == 2 * ny * DOF * 8 * (1 + 3)
        assert f"the shard of rank {(p + 1) % P}" in res[(nx, ny, "refused")]
        assert f"given to rank {p}" in res[(nx, ny, "refused")]


def test_plain_reference_against_a_dense_product():
    """The reference itself against the port's host BSR of the same matrix,
    densified: the grid's couplings, read from another code path."""
    nx, ny = GRIDS[0]
    dense = torch.from_numpy(tconv.to_scipy(fem_formula_bsr(nx, ny, dof=DOF)).toarray())
    x = _x(nx, ny, 2)
    want = dense @ x
    got = block_rows_product(nx, ny, DOF, 0, nx * ny, x, _block(ny))
    assert float((got - want).norm() / want.norm()) <= 1e-14
    rows = block_rows_product(nx, ny, DOF, 3, 9, x, _block(ny))
    assert float((rows - want[3 * DOF:9 * DOF]).norm() / want[3 * DOF:9 * DOF].norm()) <= 1e-14
