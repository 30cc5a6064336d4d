"""CG's fused vector kernels (``csrc/cg_vector.cu``) on the card, against
their plain twins.

x, r and p equal the twins' bit for bit: the kernels round each product
and sum as the unfused PyTorch lines do.  ``r·r`` is summed in another order
than ``torch.vdot``'s, so it agrees within the working type's rounding
(f64 1e-12, f32 1e-5 relative), and is the same on every run.  Every test
needs a CUDA device and skips without one; the file imports neither JAX nor
the JAX package:

    python -m pytest tests/test_torch_gpu_cg.py --noconftest -q
"""

import re

import pytest
import torch

from cask_tpu_torch.formats.generate import stencil_2d
from cask_tpu_torch.ops.kernels import build
from cask_tpu_torch.ops.kernels import cg_kernels as ck
from cask_tpu_torch.solvers import cg

pytestmark = pytest.mark.gpu
DTYPES = (torch.float32, torch.float64)
RZ_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _vectors(n, dtype, device, seed, misaligned):
    """Four vectors of n; with ``misaligned`` each starts one element past a
    16-byte boundary, so the kernels take their scalar loop."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = []
    for _ in range(4):
        v = torch.randn(n + misaligned, generator=g, device=device, dtype=dtype)
        out.append(v[misaligned:])
    return out


@pytest.mark.parametrize("misaligned", [0, 1])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 255, 2 ** 20 + 3])
def test_kernels_equal_their_twins(cuda, n, dtype, misaligned):
    x, p, r, ap = _vectors(n, dtype, cuda, n, misaligned)
    rz = torch.tensor(1.7, dtype=dtype, device=cuda)
    pap = torch.tensor(-0.3, dtype=dtype, device=cuda)
    xt, rt = x.clone(), r.clone()
    want = ck.cg_update_xr_reference(xt, p, rt, ap, rz, pap)
    before = ck.cg_update_xr.launches
    got = ck.cg_update_xr(x, p, r, ap, rz, pap)
    torch.cuda.synchronize()
    assert ck.cg_update_xr.launches == before + 1
    assert torch.equal(x, xt) and torch.equal(r, rt)
    assert got.shape == () and got.dtype == dtype
    assert abs(float(got) - float(want)) <= RZ_TOL[dtype] * float(want)

    pt = p.clone()
    ck.cg_update_p_reference(pt, r, got, rz)
    before = ck.cg_update_p.launches
    ck.cg_update_p(p, r, got, rz)
    torch.cuda.synchronize()
    assert ck.cg_update_p.launches == before + 1
    assert torch.equal(p, pt)


@pytest.mark.parametrize("dtype", DTYPES)
def test_the_sum_is_the_same_on_every_launch(cuda, dtype):
    x, p, r, ap = _vectors(3 * 2 ** 20 + 1, dtype, cuda, 5, 0)
    rz = torch.tensor(2.0, dtype=dtype, device=cuda)
    pap = torch.tensor(7.0, dtype=dtype, device=cuda)
    sums = []
    for _ in range(3):
        sums.append(ck.cg_update_xr(x.clone(), p, r.clone(), ap, rz, pap))
        torch.cuda.synchronize()
    assert all(torch.equal(s, sums[0]) for s in sums)


def test_launches_on_two_streams_share_nothing(cuda):
    """Each launch takes its own partial sums and counter from the caching
    allocator: two launches at once, on two streams, each sum their own r."""
    n = 2 ** 22 + 5
    rz = torch.tensor(1.5, dtype=torch.float64, device=cuda)
    pap = torch.tensor(4.0, dtype=torch.float64, device=cuda)
    sets = [_vectors(n, torch.float64, cuda, seed, 0) for seed in (7, 8)]
    wants = [ck.cg_update_xr_reference(x.clone(), p, r.clone(), ap, rz, pap)
             for x, p, r, ap in sets]
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    got = []
    for (x, p, r, ap), stream in zip(sets, (torch.cuda.current_stream(cuda), side)):
        with torch.cuda.stream(stream):
            got.append(ck.cg_update_xr(x, p, r, ap, rz, pap))
    torch.cuda.synchronize()
    for g, w in zip(got, wants):
        assert abs(float(g) - float(w)) <= RZ_TOL[torch.float64] * float(w)


def test_an_empty_vector_sums_to_zero(cuda):
    x, p, r, ap = (torch.empty(0, dtype=torch.float64, device=cuda) for _ in range(4))
    one = torch.ones((), dtype=torch.float64, device=cuda)
    assert float(ck.cg_update_xr(x, p, r, ap, one, one)) == 0.0
    ck.cg_update_p(p, r, one, one)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_cg_on_the_card(cuda, dtype):
    """Launches once each an iteration; two solves give the same x to the
    bit; x agrees with the same solve on the CPU (the twins)."""
    np_dtype = {torch.float32: "float32", torch.float64: "float64"}[dtype]
    a = stencil_2d(64, dtype=np_dtype)
    b = torch.linspace(-1.0, 2.0, a.shape[0], dtype=dtype)
    xr0, p0 = ck.cg_update_xr.launches, ck.cg_update_p.launches
    res = cg(a.to(cuda), b.to(cuda), tol=0.0, maxiter=40)
    torch.cuda.synchronize()
    assert res.iterations == 40
    assert ck.cg_update_xr.launches - xr0 == ck.cg_update_p.launches - p0 == 40
    again = cg(a.to(cuda), b.to(cuda), tol=0.0, maxiter=40)
    assert torch.equal(res.x, again.x)
    ref = cg(a.to("cpu"), b, tol=0.0, maxiter=40)
    err = float((res.x.cpu().double() - ref.x.double()).norm() / ref.x.double().norm())
    assert err <= {torch.float32: 1e-4, torch.float64: 1e-10}[dtype]


def test_no_spills(cuda):
    ck._lib()
    log = build.library_path("cg_vector").with_suffix(".log").read_text()
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", log)]
    assert spills and not any(spills), log
