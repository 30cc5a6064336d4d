"""The port's utilities against the JAX package's, on the CPU: checkpoints
written by either package load in the other (CSR, ILU(0) and DIA, f32 and
f64), the debug checks raise the reference's exceptions on the
reference's own bad inputs (tests/test_utils.py), a profile's Chrome trace
carries an annotated range, and ``bench_solve`` gives the reference's
records.

Tolerances: a reloaded matrix or plan is exact (equal arrays); a reloaded
ILU(0)'s ``apply`` equals the original's within 1e-12 (f64) or 1e-5 (f32)
normwise, the reference's within the same.
"""

import glob
import io
import json
import os

import jax  # noqa: F401  (kept on the CPU with x64 by conftest)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cask_tpu.formats.generate as jgen
from cask_tpu.ops.dia import dia_plan as jdia_plan
from cask_tpu.ops.ilu import ilu0 as jilu0
from cask_tpu.utils import checkpoint as jck
from cask_tpu.utils import debug as jdebug
import cask_tpu_torch.formats.generate as tgen
from cask_tpu_torch.ops.dia import dia_plan
from cask_tpu_torch.ops.ilu import ilu0
from cask_tpu_torch.utils import checkpoint as tck
from cask_tpu_torch.utils import debug as tdebug
from cask_tpu_torch.utils.profiling import annotate, trace

CPU = torch.device("cpu")
TOL = {np.float32: 1e-5, np.float64: 1e-12}
DTYPES = [np.float32, np.float64]
# the reference's record keys (cask_tpu/bench/harness.py:222-230)
SOLVE_KEYS = {"op", "solver", "matrix", "rows", "operator_mode", "us_per_iteration",
              "iterations_per_s"}
SOLVE_SIDE = 96  # 9,216 rows: CG's f32 residual stays above 0 for the ladder's 600 iterations


def _relerr(y, ref) -> float:
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(y - ref) / np.linalg.norm(ref))


def _same_csr(a, b):
    for f in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)))
    assert tuple(a.shape) == tuple(b.shape)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("direction", ["port_to_reference", "reference_to_port"])
def test_csr_checkpoint_crosses(tmp_path, dtype, direction):
    path = str(tmp_path / "a.npz")
    a = tgen.stencil_2d(10, dtype=dtype)
    if direction == "port_to_reference":
        tck.save_csr(path, a, note="test")
        b, meta = jck.load_csr(path)
    else:
        jck.save_csr(path, jgen.stencil_2d(10, dtype=dtype), note="test")
        b, meta = tck.load_csr(path)
        assert isinstance(b.data, np.ndarray)  # a host CSR, as the reference's
    assert meta == {"note": "test"}
    _same_csr(a, b)
    assert np.asarray(b.data).dtype == dtype


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("direction", ["port_to_reference", "reference_to_port"])
def test_ilu0_checkpoint_crosses(tmp_path, dtype, direction):
    path = str(tmp_path / "ilu.npz")
    b = np.random.default_rng(0).standard_normal(81).astype(dtype)
    t = ilu0(tgen.stencil_2d(9, dtype=dtype), use_native=False, device=CPU)
    j = jilu0(jgen.stencil_2d(9, dtype=dtype), use_native=False)
    if direction == "port_to_reference":
        tck.save_ilu0(path, t)
        g = jck.load_ilu0(path)
        y = np.asarray(g.apply(jnp.asarray(b)))
    else:
        jck.save_ilu0(path, j)
        g = tck.load_ilu0(path, device=CPU)
        _same_csr(g.lu, j.lu)
        y = g.apply(torch.from_numpy(b)).numpy()
    assert _relerr(y, t.apply(torch.from_numpy(b)).numpy()) <= TOL[dtype]
    assert _relerr(y, np.asarray(j.apply(jnp.asarray(b)))) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("direction", ["port_to_reference", "reference_to_port"])
def test_dia_checkpoint_crosses(tmp_path, dtype, direction):
    path = str(tmp_path / "dia.npz")
    # a band plus scattered entries: a plan with a COO remainder
    a = tgen.banded(300, 4, seed=1, dtype=dtype)
    s = tgen.random_uniform(300, density=0.01, seed=2, dtype=dtype)
    from cask_tpu_torch.formats.convert import from_scipy, to_scipy

    a = from_scipy((to_scipy(a) + to_scipy(s)).tocsr())
    t = dia_plan(a, device=CPU)
    assert t.rem_data.numel() > 0
    x = np.random.default_rng(1).standard_normal(300).astype(dtype)
    if direction == "port_to_reference":
        tck.save_dia(path, t)
        d = jck.load_dia(path)
        fields = {f: np.asarray(getattr(d, f)) for f in ("vals", "rem_data", "rem_row",
                                                         "rem_col")}
        y = np.asarray(d._spmv_xla(jnp.asarray(x)))
    else:
        from cask_tpu.formats.convert import from_scipy as jfrom_scipy

        jck.save_dia(path, jdia_plan(jfrom_scipy(to_scipy(a))))
        d = tck.load_dia(path, device=CPU)
        assert d.vals.device == CPU
        fields = {f: getattr(d, f).numpy() for f in ("vals", "rem_data", "rem_row", "rem_col")}
        y = d._spmv_reference(torch.from_numpy(x)).numpy()
    assert (d.offsets, tuple(d.shape)) == (t.offsets, t.shape)
    for f, v in fields.items():
        np.testing.assert_array_equal(v, getattr(t, f).numpy(), err_msg=f)
        assert v.dtype == getattr(t, f).numpy().dtype, f
    assert _relerr(y, t._spmv_reference(torch.from_numpy(x)).numpy()) <= TOL[dtype]


def test_checkpoint_kind_is_checked(tmp_path):
    path = str(tmp_path / "a.npz")
    tck.save_csr(path, tgen.stencil_2d(4))
    with pytest.raises(ValueError, match="not an ilu0"):
        tck.load_ilu0(path, device=CPU)
    with pytest.raises(ValueError, match="not a dia"):
        tck.load_dia(path, device=CPU)


def test_load_on_the_card_without_one_raises(tmp_path, monkeypatch):
    path = str(tmp_path / "dia.npz")
    tck.save_dia(path, dia_plan(tgen.banded(100, 2), device=CPU))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tck.load_dia(path)


def _oob(mod):
    gen = jgen if mod is jdebug else tgen
    a = gen.stencil_2d(8)
    indices = np.asarray(a.indices).copy()
    indices[0] = 64  # out of bounds
    return type(a)(data=np.asarray(a.data), indices=indices, indptr=a.indptr, shape=a.shape)


def _short_indptr(mod):
    gen = jgen if mod is jdebug else tgen
    a = gen.stencil_2d(8)
    return type(a)(data=a.data, indices=a.indices, indptr=np.asarray(a.indptr)[:-1],
                   shape=a.shape)


BAD = {  # name -> (check, the bad input's maker, exception)
    "csr_oob": ("check_csr", _oob, AssertionError),
    "csr_short_indptr": ("check_csr", _short_indptr, AssertionError),
    "not_a_permutation": ("check_permutation", lambda mod: np.array([0, 0, 2]),
                          AssertionError),
}


@pytest.mark.parametrize("name", list(BAD))
def test_debug_checks_raise_what_the_reference_raises(name):
    check, make, exc = BAD[name]
    with pytest.raises(exc):
        getattr(jdebug, check)(make(jdebug))
    with pytest.raises(exc):
        getattr(tdebug, check)(make(tdebug))


def test_debug_checks_pass_good_inputs():
    from cask_tpu_torch.formats.reorder import rcm_permutation

    a = tgen.stencil_2d(8)
    tdebug.check_csr(a)
    tdebug.check_csr(a.to(CPU))  # tensors too
    perm = rcm_permutation(tgen.stencil_2d(9))
    jdebug.check_permutation(perm)
    tdebug.check_permutation(perm)
    tdebug.check_permutation(torch.from_numpy(np.asarray(perm)))


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
@pytest.mark.parametrize("as_tuple", [False, True])
def test_nan_guard_raises_on_a_non_finite_output(bad, as_tuple):
    def op(x):
        y = x * 2.0
        return (y, 1) if as_tuple else y

    good = torch.ones(4)
    out = tdebug.nan_guard(op)(good)
    torch.testing.assert_close(out[0] if as_tuple else out, 2.0 * good)
    with pytest.raises(FloatingPointError, match="op: non-finite output"):
        tdebug.nan_guard(op)(torch.tensor([1.0, bad]))
    with pytest.raises(FloatingPointError):  # the reference on the same input
        jdebug.nan_guard(op)(np.array([1.0, bad]))


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    with trace(str(tmp_path)) as logdir:
        with annotate("cask_test_range"):
            x = torch.randn(64, 64)
            (x @ x).sum()
    assert logdir == str(tmp_path)
    files = glob.glob(os.path.join(logdir, "*.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    assert any(e.get("name") == "cask_test_range" for e in events)


def test_trace_reads_the_reference_variable(tmp_path, monkeypatch):
    monkeypatch.setenv("CASK_TPU_TRACE_DIR", str(tmp_path / "d"))
    with trace() as logdir:
        torch.ones(3).sum()
    assert logdir == str(tmp_path / "d") and glob.glob(os.path.join(logdir, "*.json"))


def _check_solve_records(recs, lines):
    assert [r["solver"] for r in recs] == ["cg", "pipelined_cg"]
    assert [json.loads(line) for line in lines] == recs
    for r in recs:
        assert set(r) == SOLVE_KEYS | {"device"}
        assert r["op"] == "pcg_per_iteration" and r["device"] == "cpu"
        assert r["matrix"] == f"stencil5_{SOLVE_SIDE}x{SOLVE_SIDE}"
        assert r["rows"] == SOLVE_SIDE ** 2 and r["operator_mode"] == "reference"
        assert r["us_per_iteration"] > 0 and r["iterations_per_s"] > 0


def test_bench_solve_gives_the_reference_records():
    from cask_tpu_torch.bench.harness import bench_solve

    buf = io.StringIO()
    recs = bench_solve(side=SOLVE_SIDE, out=buf, device="cpu")
    _check_solve_records(recs, buf.getvalue().splitlines())


def test_bench_solve_raises_when_a_solve_stops_short():
    """On 256 rows f32 CG's residual reaches exactly 0 after 127 iterations:
    the ladder's 600 cannot be run, and a slope over them would not be a
    cost per iteration."""
    from cask_tpu_torch.bench.harness import bench_solve

    with pytest.raises(RuntimeError, match="cg stopped after"):
        bench_solve(side=16, out=io.StringIO(), device="cpu")


def test_cli_solve(tmp_path):
    from cask_tpu_torch.bench import cli

    out = tmp_path / "solve.jsonl"
    assert cli.main(["--cpu", "--out", str(out), "solve", "--side", str(SOLVE_SIDE)]) == 0
    lines = out.read_text().splitlines()
    _check_solve_records([json.loads(line) for line in lines], lines)


def test_the_new_modules_import_no_jax():
    import subprocess
    import sys

    code = ("import sys; import cask_tpu_torch.formats.device_gen, cask_tpu_torch.utils, "
            "cask_tpu_torch.utils.checkpoint, cask_tpu_torch.utils.profiling, "
            "cask_tpu_torch.bench.harness, cask_tpu_torch.examples.entry, "
            "cask_tpu_torch.examples.solver_resident_cg, "
            "cask_tpu_torch.examples.unstructured_spmv, cask_tpu_torch.examples.autotune_bench; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')) "
            "or m == 'cask_tpu' or m.startswith('cask_tpu.')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
