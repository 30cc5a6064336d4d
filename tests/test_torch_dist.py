"""The port's distributed executors (``cask_tpu_torch.parallel``) against the
JAX package's on its 8-device CPU mesh.

The port runs on worlds of gloo ranks spawned once for the module (2 and 4
ranks; the 2×2 grid runs in the 4-rank world) through
:func:`cask_tpu_torch.parallel.launch`, each rank running
:func:`cask_tpu_torch.parallel.batch.run_batch` on numpy inputs and handing
numpy results back; one-rank cases run in process.  The reference's
``DistSpmv``/``Dist2DSpmv`` runs on ``row_mesh(P)``/``mesh_2d`` with its
plain ("xla") interiors and the same partition, built from the same scipy
matrix: the reference's partition crosses to the port through
``interop`` (``*_partition_from_arrays``), so both run the same plan on the
same numpy operands.

Tolerances: y within 1e-12 normwise (f64) of the reference's and of scipy's,
1e-5 in f32; solves: iterations within ±1 of the reference's distributed
solve and x within 1e-9 relative (f64); ``shard_ilu0``: each rank's level
arrays equal the reference's stacked arrays over their unpadded extent, its
apply within 1e-12.
"""

import json
import os
import runpy
import time

import jax  # noqa: F401  (kept on the CPU with x64 by conftest)
import numpy as np
import pytest
import scipy.sparse as sp
import torch
import torch.distributed as dist

import cask_tpu.formats.convert as jconv
import cask_tpu.formats.generate as jgen
import cask_tpu.parallel as jpar
import cask_tpu.solvers as jsol
import cask_tpu_torch.formats.convert as tconv
import cask_tpu_torch.parallel as tpar
from cask_tpu.solvers.precond import _stack_tri_plans
from cask_tpu.solvers.precond import shard_ilu0 as jshard_ilu0
from cask_tpu_torch.parallel.batch import run_batch
from test_torch_partition import cross_partition

RANKS = (2, 4)
TOL = {np.float64: 1e-12, np.float32: 1e-5}
X_TOL = 1e-9
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fem_far(nx=16, seed=3):
    """fem_blocks plus far blocks on block diagonals too sparse to keep."""
    s = jconv.to_scipy(jgen.fem_blocks(nx, dof=4, seed=seed)).tolil()
    rng = np.random.default_rng(seed)
    nb = s.shape[0] // 4
    for _ in range(12):
        bi, bj = (int(v) for v in rng.integers(0, nb, 2))
        s[bi * 4: bi * 4 + 4, bj * 4: bj * 4 + 4] = rng.standard_normal((4, 4))
    return s.tocsr()


MATRICES = {
    "banded": lambda: jconv.to_scipy(jgen.banded(1000, 4, seed=1)),
    "stencil": lambda: jconv.to_scipy(jgen.stencil_2d(33)),
    "stencil32": lambda: jconv.to_scipy(jgen.stencil_2d(33, dtype=np.float32)),
    "powerlaw": lambda: jconv.to_scipy(jgen.power_law(800, avg_degree=5, seed=2)),
    "remainder": lambda: jconv.to_scipy(jgen.power_law(600, avg_degree=5, seed=3)),
    "fem": lambda: jconv.to_scipy(jgen.fem_blocks(16, dof=4, seed=0)),
    "fem32": lambda: jconv.to_scipy(jgen.fem_blocks(16, dof=4, seed=0)).astype(np.float32),
    "femfar": _fem_far,
    "rect": lambda: jconv.to_scipy(jgen.random_uniform(200, 310, density=0.02, seed=2)),
}

# name: (matrix, partition, partition kwargs, k (None: SpMV), the port's executor kwargs)
CASES = {
    "coo_banded": ("banded", "coo", {}, None, {}),
    "coo_powerlaw_spmm": ("powerlaw", "coo", {}, 16, {}),
    "dia_stencil": ("stencil", "dia", {}, None, {}),
    "dia_stencil_serialized": ("stencil", "dia", {}, None, {"overlap": False}),
    "dia_banded_spmm": ("banded", "dia", {}, 8, {}),
    "dia_remainder": ("remainder", "dia", {"min_density": 0.4}, None, {}),
    "dia_remainder_spmm_serialized": ("remainder", "dia", {"min_density": 0.4}, 4,
                                      {"overlap": False}),
    "dia_f32": ("stencil32", "dia", {}, None, {}),
    "bdia": ("fem", "bdia", {}, None, {}),
    "bdia_serialized": ("fem", "bdia", {}, None, {"overlap": False}),
    "bdia_spmm": ("fem", "bdia", {}, 8, {}),
    "bdia_far": ("femfar", "bdia", {}, None, {}),
    "bdia_far_spmm_serialized": ("femfar", "bdia", {}, 4, {"overlap": False}),
    "bdia_fused": ("fem", "bdia", {}, None, {"interior": "fused"}),
    "bdia_slab": ("femfar", "bdia", {}, 8, {"mm_interior": "slab"}),
    "bdia_f32": ("fem32", "bdia", {}, None, {}),
    "poh": ("powerlaw", "poh", {}, None, {}),
    "poh_spmm_serialized": ("powerlaw", "poh", {}, 8, {"overlap": False}),
}
CASES_2D = {"2d_spmv": ("powerlaw", None), "2d_rect_spmm": ("rect", 8)}
SOLVES = {"cg": ("cg", 1), "pipelined_cg": ("pipelined_cg", 1), "block_cg": ("block_cg", 4),
          "ilu_cg": ("cg", 1)}
SOLVE_KW = dict(tol=1e-10, maxiter=600)


def _pair(s):
    s = sp.csr_matrix(s)
    s.sort_indices()
    return jconv.from_scipy(s), tconv.from_scipy(s)


def _partitions(mat, part, p, kw):
    """(reference partition, the same crossed to the port, scipy matrix)."""
    s = MATRICES[mat]()
    j, _ = _pair(s)
    if part == "bdia":
        j = jconv.csr_to_bsr(j, (4, 4))
    build = {"coo": "partition_coo", "dia": "partition_dia", "bdia": "partition_bdia",
             "poh": "partition_poh"}[part]
    ref = getattr(jpar, build)(j, p, **kw)
    return ref, cross_partition(ref), s


def _operand(s, k, seed):
    rng = np.random.default_rng(seed)
    shape = (s.shape[1],) if k is None else (s.shape[1], k)
    return rng.standard_normal(shape).astype(s.dtype)


def _relerr(y, ref):
    return float(np.linalg.norm(np.asarray(y, np.float64) - ref) / np.linalg.norm(ref))


def _solve_system():
    s = jconv.to_scipy(jgen.stencil_2d(20))  # 400 rows, SPD (the reference's test system)
    return s, _pair(s)


def _jobs(p):
    jobs = []
    for i, (name, (mat, part, pkw, k, kw)) in enumerate(CASES.items()):
        _, plan, s = _partitions(mat, part, p, pkw)
        jobs.append(dict(name=name, op="call", plan=plan, x=_operand(s, k, i), kw=kw))
    sys_s, (sys_j, t) = _solve_system()
    for i, (name, (solver, nrhs)) in enumerate(SOLVES.items()):
        b = _operand(sys_s, None if nrhs == 1 else nrhs, 100 + i)
        jobs.append(dict(name=name, op="solve", plan=cross_partition(jpar.partition_dia(sys_j, p)),
                         b=b,
                         solver=solver, ilu=name.startswith("ilu"), a=t, solve_kw=SOLVE_KW))
    ja, ta = _pair(jconv.to_scipy(jgen.banded(512, 3, seed=3, spd=True)))
    jobs.append(dict(name="ilu_plans", op="ilu", plan=cross_partition(jpar.partition_coo(ja, p)),
                     a=ta,
                     r=_operand(jconv.to_scipy(jgen.banded(512, 3, seed=3, spd=True)), None, 7)))
    if p == 4:
        for i, (name, (mat, k)) in enumerate(CASES_2D.items()):
            s = MATRICES[mat]()
            jobs.append(dict(name=name, op="call2d",
                             plan=cross_partition(jpar.partition_2d(_pair(s)[0], 2, 2)),
                             x=_operand(s, k, 50 + i)))
        jobs.append(dict(name="2d_cg", op="solve2d",
                         plan=cross_partition(jpar.partition_2d(sys_j, 2, 2)),
                         b=_operand(sys_s, None, 60), solve_kw=SOLVE_KW))
    return jobs


@pytest.fixture(scope="module")
def world():
    """Each world's per-rank results, one spawn a world."""
    return {p: tpar.launch(run_batch, p, _jobs(p), timeout=300.0) for p in RANKS}


def _ref_y(ref_plan, p, x, kw):
    op = jpar.DistSpmv(ref_plan, jpar.row_mesh(p), interior="xla", mm_interior="xla",
                       overlap=kw.get("overlap", True))
    return np.asarray(op(x))


@pytest.mark.parametrize("p", RANKS)
@pytest.mark.parametrize("case", list(CASES))
def test_distspmv_matches_the_reference(world, p, case):
    mat, part, pkw, k, kw = CASES[case]
    ref_plan, _, s = _partitions(mat, part, p, pkw)
    x = _operand(s, k, list(CASES).index(case))
    got = [r[case] for r in world[p]]
    y = got[0]["y"]
    for other in got[1:]:  # every rank returns the same global y
        np.testing.assert_array_equal(other["y"], y)
    tol = TOL[s.dtype.type]
    assert y.dtype == s.dtype and y.shape == (s @ x).shape
    assert _relerr(y, _ref_y(ref_plan, p, x, kw)) <= tol
    assert _relerr(y, s.astype(np.float64) @ x.astype(np.float64)) <= tol
    # on the CPU an automatic interior is the plain formulation (or POH's own)
    want = kw.get("interior", {"poh": "poh"}.get(part, "plain"))
    assert got[0]["interior"] == want
    assert got[0]["mm_interior"] == kw.get("mm_interior", "plain")


@pytest.mark.parametrize("case", list(CASES_2D))
def test_dist2d_matches_the_reference(world, case):
    mat, k = CASES_2D[case]
    s = MATRICES[mat]()
    x = _operand(s, k, 50 + list(CASES_2D).index(case))
    ref = np.asarray(jpar.Dist2DSpmv(jpar.partition_2d(_pair(s)[0], 2, 2),
                                     jpar.mesh_2d(2, 2))(x))
    for r in world[4]:
        assert _relerr(r[case], ref) <= 1e-12
        assert _relerr(r[case], s @ x) <= 1e-12


def _gathered(results, name, rows):
    return np.concatenate([r[name]["x"] for r in results])[:rows]


@pytest.mark.parametrize("p", RANKS)
@pytest.mark.parametrize("name", list(SOLVES))
def test_solvers_over_the_distributed_operator(world, p, name):
    solver, nrhs = SOLVES[name]
    s, (j, _) = _solve_system()
    b = _operand(s, None if nrhs == 1 else nrhs, 100 + list(SOLVES).index(name))
    op = jpar.DistSpmv(jpar.partition_dia(j, p), jpar.row_mesh(p))
    M = jshard_ilu0(j, op) if name.startswith("ilu") else None
    ref = getattr(jsol, solver)(op.padded_op, op.padded(b), M=M, **SOLVE_KW)
    got = world[p][0][name]
    assert got["converged"] and bool(ref.converged)
    assert abs(got["iterations"] - int(ref.iterations)) <= 1
    x = _gathered(world[p], name, s.shape[0])
    x_ref = np.asarray(ref.x)[: s.shape[0]]
    assert np.linalg.norm(x - x_ref) <= X_TOL * np.linalg.norm(x_ref)
    assert all(r[name]["iterations"] == got["iterations"] for r in world[p])


@pytest.mark.parametrize("p", RANKS)
def test_pipelined_cg_reduces_once_an_iteration(world, p):
    got = world[p][0]["pipelined_cg"]
    # ‖b‖ before the loop, one fused (‖r‖², γ, δ) an iteration and at the
    # exit test, the true residual after the loop
    assert got["all_reduce"] == got["iterations"] + 3
    assert got["products"] == got["iterations"] + 4  # one product at the exit test
    cg_ = world[p][0]["cg"]
    assert cg_["all_reduce"] == 3 * cg_["iterations"] + 4


@pytest.mark.parametrize("p", RANKS)
def test_shard_ilu0_fewer_iterations_than_plain_cg(world, p):
    assert world[p][0]["ilu_cg"]["iterations"] < world[p][0]["cg"]["iterations"]


@pytest.mark.parametrize("p", RANKS)
def test_shard_ilu0_plans_are_the_reference_slices(world, p):
    s = jconv.to_scipy(jgen.banded(512, 3, seed=3, spd=True))
    j, _ = _pair(s)
    op = jpar.DistSpmv(jpar.partition_coo(j, p), jpar.row_mesh(p))
    M = jshard_ilu0(j, op)
    r = _operand(s, None, 7)
    want_apply = np.asarray(M(op.padded(r)))
    mloc = op.plan.mloc
    # the reference's per-shard factors, as shard_ilu0 builds them
    from cask_tpu.ops.ilu import ilu0

    for rank, res in enumerate(world[p]):
        got = res["ilu_plans"]
        np.testing.assert_allclose(got["apply"], want_apply[rank * mloc: (rank + 1) * mloc],
                                   rtol=0, atol=1e-12 * np.abs(want_apply).max())
        r0, r1 = rank * mloc, min((rank + 1) * mloc, s.shape[0])
        blk = s.tocsr()[r0:r1, r0:r1].tocsr()
        if mloc - blk.shape[0]:
            blk = sp.block_diag([blk, sp.identity(mloc - blk.shape[0], format="csr")],
                                format="csr")
        blk.sort_indices()
        f = ilu0(jconv.from_scipy(blk, format="csr"))
        for side, plan, data in (("lower", f._lower_plan, f._lower_data),
                                 ("upper", f._upper_plan, f._upper_data)):
            arrs, _ = _stack_tri_plans([plan], [np.asarray(data)])
            mine = got["plans"][side]
            nl, mr, me = mine["nlevels"], mine["max_rows"], mine["max_ents"]
            assert (nl, mr, me, mine["n"]) == (plan.nlevels, plan.max_rows, plan.max_ents,
                                               plan.n)
            np.testing.assert_array_equal(mine["lvl_rows"], arrs["rows"][0, :nl, :mr])
            np.testing.assert_array_equal(mine["lvl_diag_idx"], arrs["diag"][0, :nl, :mr])
            valid = mine["lvl_ent_valid"]
            np.testing.assert_array_equal(valid, arrs["entv"][0, :nl, :me])
            for key, ref_key in (("lvl_ent_local", "entl"), ("lvl_ent_col", "entc"),
                                 ("lvl_ent_idx", "enti")):
                np.testing.assert_array_equal(mine[key][valid], arrs[ref_key][0, :nl, :me][valid])
            np.testing.assert_allclose(mine["data"], arrs["data"][0, : mine["data"].shape[0]],
                                       rtol=1e-12, atol=0)


def test_2d_cg_matches_the_reference(world):
    s, (j, _) = _solve_system()
    b = _operand(s, None, 60)
    op = jpar.Dist2DSpmv(jpar.partition_2d(j, 2, 2), jpar.mesh_2d(2, 2))
    ref = jsol.cg(op.padded_op, op.padded_x(b), **SOLVE_KW)
    got = world[4]
    assert abs(got[0]["2d_cg"]["iterations"] - int(ref.iterations)) <= 1
    # ranks (i, j) hold x block j: ranks 0 and 1 hold the whole vector
    x = np.concatenate([got[0]["2d_cg"]["x"], got[1]["2d_cg"]["x"]])[: s.shape[0]]
    x_ref = np.asarray(ref.x)[: s.shape[0]]
    assert np.linalg.norm(x - x_ref) <= X_TOL * np.linalg.norm(x_ref)
    np.testing.assert_array_equal(got[2]["2d_cg"]["x"], got[0]["2d_cg"]["x"])


# -- one rank, in process ------------------------------------------------------


@pytest.fixture()
def one_rank():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield tpar.row_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("case", ["coo_banded", "dia_remainder", "bdia_far", "bdia_slab",
                                  "poh"])
def test_one_rank_matches_the_reference(one_rank, case):
    mat, part, pkw, k, kw = CASES[case]
    ref_plan, plan, s = _partitions(mat, part, 1, pkw)
    x = _operand(s, k, 3)
    y = tpar.DistSpmv(plan, one_rank, **kw)(x).numpy()
    assert _relerr(y, _ref_y(ref_plan, 1, x, kw)) <= 1e-12
    assert _relerr(y, s @ x) <= 1e-12


def test_interior_pallas_needs_8192_row_shards(one_rank):
    s = MATRICES["stencil"]()
    _, t = _pair(s)
    with pytest.raises(ValueError, match="align=8192"):
        tpar.DistSpmv(tpar.partition_dia(t, 1), one_rank, interior="pallas")
    op = tpar.DistSpmv(tpar.partition_dia(t, 1, align=8192), one_rank, interior="pallas")
    x = _operand(s, None, 4)
    assert _relerr(op(x).numpy(), s @ x) <= 1e-12  # the kernel's CPU twin


def test_executors_refuse_what_they_do_not_take(one_rank):
    _, t = _pair(MATRICES["stencil"]())
    dia = tpar.partition_dia(t, 1)
    with pytest.raises(ValueError, match="needs a BdiaPartition"):
        tpar.DistSpmv(dia, one_rank, mm_interior="slab")
    with pytest.raises(ValueError, match="unknown DIA interior"):
        tpar.DistSpmv(dia, one_rank, interior="fused")
    with pytest.raises(ValueError, match="2 shards"):
        tpar.DistSpmv(tpar.partition_dia(t, 2), one_rank)
    with pytest.raises(TypeError, match="Dist2DSpmv"):
        tpar.DistSpmv(tpar.partition_2d(t, 1, 1), one_rank)


def test_slab_byte_cap_queue_c2(monkeypatch):
    """``mm_interior='auto'`` takes the slab on the card only while each
    shard's slab pack stays under SLAB_MAX_BYTES; above it the plain
    formulation, and an explicit ``'slab'`` is refused with its bytes."""
    from cask_tpu_torch.ops import bdia_slab

    _, plan, _ = _partitions("fem", "bdia", 2, {})
    g, nbytes = tpar.slab_choice(plan)
    assert g == 16 and nbytes > 0
    assert tpar.resolve_interiors(plan, "cuda")[1] == "slab"
    assert tpar.resolve_interiors(plan, "cpu")[1] == "plain"
    monkeypatch.setattr(bdia_slab, "SLAB_MAX_BYTES", nbytes - 1)
    g2, smallest = tpar.slab_choice(plan)  # a smaller g shrinks the far segments
    assert g2 in (8, 4) and smallest < nbytes
    monkeypatch.setattr(bdia_slab, "SLAB_MAX_BYTES", 1024)
    assert tpar.slab_choice(plan)[0] is None
    assert tpar.resolve_interiors(plan, "cuda") == ("fused", "plain")
    with pytest.raises(ValueError, match=r"bytes, over the cap SLAB_MAX_BYTES = 1024"):
        tpar.resolve_interiors(plan, "cuda", mm_interior="slab")


def test_bdia_interiors_resolve_as_the_reference():
    _, plan, _ = _partitions("fem", "bdia", 2, {})
    assert tpar.resolve_interiors(plan, "cuda") == ("fused", "slab")
    assert tpar.resolve_interiors(plan, "cpu") == ("plain", "plain")
    assert tpar.resolve_interiors(plan, "cpu", "pallas")[0] == "pallas"
    _, poh, _ = _partitions("powerlaw", "poh", 2, {})
    assert tpar.resolve_interiors(poh, "cuda") == ("poh", "plain")
    with pytest.raises(ValueError, match="one interior"):
        tpar.resolve_interiors(poh, "cpu", "fused")


def test_launch_raises_with_the_rank_traceback():
    with pytest.raises(RuntimeError, match="unknown job op 'nothing'"):
        tpar.launch(run_batch, 2, [{"name": "x", "op": "nothing"}], timeout=120.0)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        tpar.launch(time.sleep, 2, 60, timeout=3.0)
    assert time.monotonic() - t0 < 30


# -- the examples beside the reference's -----------------------------------------


def test_distributed_spmv_example(capsys):
    from cask_tpu_torch.examples import distributed_spmv

    distributed_spmv.main(device="cpu")
    out = capsys.readouterr().out
    runpy.run_path(os.path.join(_REPO, "examples", "distributed_spmv.py"), run_name="__main__")
    ref = capsys.readouterr().out
    lines, ref_lines = out.splitlines(), ref.splitlines()
    assert lines[:2] == ref_lines[:2]  # eight ranks, the same partition
    err, ref_err = (float(t.split("= ")[1]) for t in (lines[2], ref_lines[2]))
    assert err < 1e-5 and ref_err < 1e-5
    iters = [int(t.split(": ")[1].split()[0]) for t in (lines[3], ref_lines[3])]
    assert abs(iters[0] - iters[1]) <= 1 and "converged=True" in lines[3]


def test_scaling_job_emits_the_reference_records(tmp_path):
    from cask_tpu_torch.examples import scaling_job

    argv = ["--rows-per-shard", "60000", "--shards", "1,2"]
    out = tmp_path / "port.json"
    assert scaling_job.main(["--cpu", *argv, "--out", str(out)]) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    ref_out = tmp_path / "ref.json"
    ns = runpy.run_path(os.path.join(_REPO, "examples", "scaling_job.py"))
    assert ns["main"]([*argv, "--out", str(ref_out)]) == 0
    ref = [json.loads(line) for line in ref_out.read_text().splitlines()]
    key = lambda r: (r["op"], r.get("variant"), r.get("nshards"), r.get("rows"))  # noqa: E731
    assert [key(r) for r in recs] == [key(r) for r in ref]
    assert recs[0]["efficiency"] == 1.0 and recs[-1]["target"] == 0.70
    assert recs[-1]["weak_scaling_efficiency_at_max_shards"] is not None
    assert all(r["seconds_per_op"] > 0 for r in recs if "seconds_per_op" in r)


def test_dryrun_multichip_twin():
    from cask_tpu_torch.examples.dryrun_multichip import dryrun_multichip

    lines = dryrun_multichip(4)
    assert lines == [f"rank {r} of 4 (cpu): dryrun ok" for r in range(4)]
