"""CG's fused vector updates on the CPU: the plain twins of
``ops/kernels/cg_kernels.py`` against the unfused lines they replace, and
``cg``'s choice of branch.

Without ``M``, on real f32 or f64 vectors, ``cg`` updates ``x``, ``r`` and
``p`` in place through :func:`cg_update_xr` and :func:`cg_update_p` (on the
CPU their twins, which round as the unfused lines do): the solve equals the
plain recurrence bit for bit and leaves the caller's ``b`` and ``x0`` alone.
A preconditioned, complex or half-precision solve keeps the unfused lines.
"""

import importlib

import numpy as np
import pytest
import torch

import cask_tpu_torch.formats.generate as tgen
from cask_tpu_torch.ops.kernels import cg_kernels as ck
from cask_tpu_torch.ops.spmv import spmv
from cask_tpu_torch.solvers import cg, jacobi

krylov = importlib.import_module("cask_tpu_torch.solvers.krylov")
DTYPES = (torch.float32, torch.float64)
LENGTHS = (0, 1, 2, 3, 7, 255, 1001)


def _vectors(n, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(n, generator=g, dtype=torch.float64).to(dtype) for _ in range(4)]


def _scalar(v, dtype):
    return torch.tensor(v, dtype=dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", LENGTHS)
def test_update_xr_twin_is_the_unfused_lines(n, dtype):
    x, p, r, ap = _vectors(n, dtype)
    rz, pap = _scalar(1.7, dtype), _scalar(-0.3, dtype)
    alpha = rz / pap
    want_x, want_r = x + alpha * p, r - alpha * ap
    want_rz = torch.vdot(want_r, want_r)
    for fn in (ck.cg_update_xr, ck.cg_update_xr_reference):
        xi, ri = x.clone(), r.clone()
        rz_new = fn(xi, p, ri, ap, rz, pap)
        assert torch.equal(xi, want_x) and torch.equal(ri, want_r)
        assert rz_new.shape == () and rz_new.dtype == dtype and torch.equal(rz_new, want_rz)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", LENGTHS)
def test_update_p_twin_is_the_unfused_lines(n, dtype):
    _, p, r, _ = _vectors(n, dtype, 1)
    rz_new, rz = _scalar(0.25, dtype), _scalar(3.1, dtype)
    want = r + (rz_new / rz) * p
    for fn in (ck.cg_update_p, ck.cg_update_p_reference):
        pi = p.clone()
        assert fn(pi, r, rz_new, rz) is None
        assert torch.equal(pi, want)


@pytest.mark.parametrize("case", ["dtype", "complex", "2d", "length", "strided", "scalar",
                                  "alias"])
def test_wrappers_raise_on_what_the_kernels_do_not_take(case):
    x, p, r, ap = _vectors(8, torch.float64)
    rz, pap = _scalar(1.0, torch.float64), _scalar(2.0, torch.float64)
    if case == "dtype":
        p = p.float()
    elif case == "complex":
        x, p, r, ap = (v.to(torch.complex128) for v in (x, p, r, ap))
    elif case == "2d":
        x, p, r, ap = (v[:, None] for v in (x, p, r, ap))
    elif case == "length":
        ap = ap[:7]
    elif case == "strided":
        p = torch.randn(16, dtype=torch.float64)[::2]
    elif case == "scalar":
        pap = pap.float()
    else:
        p = r
    with pytest.raises(ValueError):
        ck.cg_update_xr(x, p, r, ap, rz, pap)
    with pytest.raises(ValueError):
        ck.cg_update_p(p, ap if case == "length" else r, rz, pap)


@pytest.mark.parametrize("case", ["x_r", "x_p", "r_ap", "rz_in_r", "pap_in_x", "p_r",
                                  "rz_new_in_p"])
def test_wrappers_raise_on_partly_overlapping_memory(case):
    """A written vector may share no byte with another operand, also where
    the two start apart (the kernels' pointers are ``__restrict__``)."""
    buf = torch.randn(40, dtype=torch.float64)
    x, p, r, ap = buf[0:8], buf[10:18], buf[20:28], buf[30:38]
    rz, pap = _scalar(1.0, torch.float64), _scalar(2.0, torch.float64)
    if case == "x_r":
        r = buf[4:12]
    elif case == "x_p":
        p = buf[7:15]
    elif case == "r_ap":
        ap = buf[27:35]
    elif case == "rz_in_r":
        rz = r[3]
    elif case == "pap_in_x":
        pap = x[7]
    if case in ("p_r", "rz_new_in_p"):
        rz_new = p[0] if case == "rz_new_in_p" else rz
        r = buf[14:22] if case == "p_r" else r
        with pytest.raises(ValueError, match="overlap"):
            ck.cg_update_p(p, r, rz_new, pap)
        return
    was = buf.clone()
    with pytest.raises(ValueError, match="overlap"):
        ck.cg_update_xr(x, p, r, ap, rz, pap)
    assert torch.equal(buf, was)


def test_reading_one_vector_twice_is_no_overlap():
    """Only written memory counts: ``ap`` may be ``p`` (an operator that
    hands back its argument), and two scalars may be one."""
    x, p, r, _ = _vectors(9, torch.float64, 4)
    rz = _scalar(0.5, torch.float64)
    want_x, want_r = x + (rz / rz) * p, r - (rz / rz) * p
    ck.cg_update_xr(x, p, r, p, rz, rz)
    assert torch.equal(x, want_x) and torch.equal(r, want_r)


def _system(side=24, dtype=torch.float64, seed=3):
    a = tgen.stencil_2d(side, dtype=np.float32 if dtype == torch.float32 else np.float64)
    b = torch.from_numpy(np.random.default_rng(seed).standard_normal(a.shape[0])).to(dtype)
    return a, b


def _plain_cg(op, b, x0, tol, maxiter):
    """``cg``'s unfused lines for ``M = None``, as they stood before the fused
    branch: the plain recurrence the fused one must equal bit for bit."""
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    target = torch.clamp(tol * torch.linalg.vector_norm(b), min=0.0)
    r = b - op(x)
    p = r
    rz = torch.vdot(r, r)
    k = 0
    while k < maxiter and bool(torch.linalg.vector_norm(r) > target):
        ap = op(p)
        alpha = rz / torch.vdot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rz_new = torch.vdot(r, r)
        p = r + (rz_new / rz) * p
        rz = rz_new
        k += 1
    return x, k, float(torch.linalg.vector_norm(r))


class _Spy:
    """Counts calls to a wrapper and passes them on."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args):
        self.calls += 1
        return self.fn(*args)


@pytest.fixture()
def spies(monkeypatch):
    xr, p = _Spy(ck.cg_update_xr), _Spy(ck.cg_update_p)
    monkeypatch.setattr(krylov, "cg_update_xr", xr)
    monkeypatch.setattr(krylov, "cg_update_p", p)
    return xr, p


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tol,maxiter,with_x0", [(1e-6, 500, False), (0.0, 13, True),
                                                  (1e-4, 500, True)])
def test_fused_cg_is_the_plain_recurrence(spies, dtype, tol, maxiter, with_x0):
    a, b = _system(dtype=dtype)
    x0 = torch.linspace(-1, 1, b.shape[0], dtype=dtype) if with_x0 else None
    res = cg(a, b, x0=x0, tol=tol, maxiter=maxiter)
    x, k, rn = _plain_cg(lambda v: spmv(a, v), b, x0, tol, maxiter)
    assert torch.equal(res.x, x)
    assert res.iterations == k and res.residual_norm == rn
    assert spies[0].calls == spies[1].calls == k > 0


def test_fused_cg_leaves_the_callers_b_and_x0_alone(spies):
    a, b = _system()
    x0 = torch.full_like(b, 0.5)
    b_was, x0_was = b.clone(), x0.clone()
    res = cg(a, b, x0=x0, tol=1e-8, maxiter=50)
    assert spies[0].calls == res.iterations > 0
    assert torch.equal(b, b_was) and torch.equal(x0, x0_was)
    assert res.x.data_ptr() not in (b.data_ptr(), x0.data_ptr())
    # an operator that hands back its argument (ap is p's memory) writes through nothing
    res = cg(lambda v: v, b, x0=x0, tol=1e-12, maxiter=5)
    assert res.iterations == 1 and torch.allclose(res.x, b)
    assert torch.equal(b, b_was) and torch.equal(x0, x0_was)


def test_fused_cg_on_a_numpy_x0_leaves_it_alone(spies):
    a, b = _system()
    x0 = np.full(b.shape[0], 0.25)
    cg(a, b, x0=x0, tol=1e-8, maxiter=20)
    assert spies[0].calls > 0 and np.all(x0 == 0.25)


@pytest.mark.parametrize("case", ["jacobi", "complex", "bf16", "f16", "x0_f32", "strided_b"])
def test_other_solves_keep_the_unfused_lines(spies, case):
    a, b = _system()
    kw = {}
    if case == "jacobi":
        kw["M"] = jacobi(a, device="cpu")
    elif case == "complex":  # the real SPD operator on complex vectors: Hermitian PD
        b = b.to(torch.complex128) * (1 + 0.5j)
        real = a
        a = lambda v: torch.complex(spmv(real, v.real), spmv(real, v.imag))  # noqa: E731
    elif case in ("bf16", "f16"):
        b = b.to(torch.bfloat16 if case == "bf16" else torch.float16)
        a = a.to("cpu").astype(b.dtype)
    elif case == "x0_f32":
        kw["x0"] = torch.zeros(b.shape[0], dtype=torch.float32)
    else:
        b = torch.stack([b, b], 1)[:, 0]
    res = cg(a, b, tol=1e-3, maxiter=30, **kw)
    assert res.iterations > 0
    assert spies[0].calls == spies[1].calls == 0


def test_the_branch_is_chosen_once_a_solve(spies):
    """The first product decides: an operator whose later products the
    kernels do not take raises, and never drops to the unfused lines
    partway through a solve."""
    a, b = _system()
    calls = []

    def op(v):
        calls.append(1)
        y = spmv(a, v)
        return y if len(calls) == 1 else torch.stack([y, y], 1)[:, 0]  # strided later

    with pytest.raises(ValueError, match="CG kernels"):
        cg(op, b, tol=1e-8, maxiter=20)
    assert spies[0].calls == 1 and spies[1].calls == 0


def test_counters_start_at_zero_and_are_ints():
    assert isinstance(ck.cg_update_xr.launches, int)
    assert isinstance(ck.cg_update_p.launches, int)
