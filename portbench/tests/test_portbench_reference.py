"""The plain references against dense products built from each family's
definition on tiny grids, and the inputs they are made in against the same."""

import itertools

import pytest
import torch

from portbench import spec
from portbench.precision import round_tf32


def _cfg(family, **sizes):
    base = {"stencil27": {"family": "stencil27", "dtype": "float64", "center": 26.0,
                          "neighbor": -1.0},
            "fem_bdia": {"family": "fem_bdia", "dtype": "float32", "dof": 4,
                         "diag_shift": 16.0}}[family]
    return {**base, **sizes}


def _dense_stencil(nx, ny, nz):
    """The 27-point operator from the grid's coordinates."""
    m = nx * ny * nz
    a = torch.zeros((m, m), dtype=torch.float64)
    for z, y, x in itertools.product(range(nz), range(ny), range(nx)):
        r = (z * ny + y) * nx + x
        for dz, dy, dx in itertools.product((-1, 0, 1), repeat=3):
            if 0 <= z + dz < nz and 0 <= y + dy < ny and 0 <= x + dx < nx:
                c = ((z + dz) * ny + y + dy) * nx + x + dx
                a[r, c] = 26.0 if c == r else -1.0
    return a


def _dense_from_dia(inputs, m):
    a = torch.zeros((m, m), dtype=torch.float64)
    for d, off in enumerate(inputs["offsets"]):
        for r in range(m):
            if 0 <= r + off < m:
                a[r, r + off] = inputs["vals"][d, r]
    return a


def _dense_fem(inputs, nx, ny, b):
    """The FEM matrix from its grid graph, reading each block from the layout."""
    nbr = nx * ny
    v = inputs["vals"]  # (br, T, npairs, ts, 128)
    ts = inputs["ts"]
    offs = inputs["offsets"]
    a = torch.zeros((nbr * b, nbr * b), dtype=torch.float64)
    for gx, gy in itertools.product(range(nx), range(ny)):
        i = gx * ny + gy
        t, s, lane = i // (ts * 128), (i // 128) % ts, i % 128
        for nbx, nby in ((gx, gy), (gx - 1, gy), (gx + 1, gy), (gx, gy - 1), (gx, gy + 1)):
            if 0 <= nbx < nx and 0 <= nby < ny:
                j = nbx * ny + nby
                d = offs.index(j - i)
                for r, c in itertools.product(range(b), range(b)):
                    a[i * b + r, j * b + c] = v[r, t, d * b + c, s, lane]
    return a


@pytest.mark.parametrize("dims", [(5, 4, 3), (3, 3, 3), (7, 3, 4)])
def test_stencil_inputs_and_reference(dims):
    nx, ny, nz = dims
    cfg = _cfg("stencil27", nx=nx, ny=ny, nz=nz)
    fam = spec._module("families", "stencil27")
    inputs = fam.make(cfg, 1, "cpu")
    dense = _dense_stencil(nx, ny, nz)
    m = nx * ny * nz
    assert torch.equal(_dense_from_dia(inputs, m), dense)
    assert fam.counts(cfg, 1)["entries"] == int((dense != 0).sum())
    x = torch.randn(m, dtype=torch.float64, generator=torch.Generator().manual_seed(3))
    ref = fam.Reference(cfg, inputs)
    torch.testing.assert_close(ref.apply(x), dense @ x, rtol=1e-13, atol=1e-13)
    (_, _, ys, scale), = ref.blocks(x, ("exact", "float32"))
    torch.testing.assert_close(scale[:, 0], dense.abs() @ x.abs(), rtol=1e-13, atol=1e-13)
    torch.testing.assert_close(ys["float32"][:, 0], dense @ x, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dims, ts, block_rows", [((12, 10), 8, 1 << 18), ((40, 30), 8, 1024),
                                                  ((9, 2), 16, 1 << 18)])
def test_fem_inputs_and_reference(dims, ts, block_rows):
    nx, ny = dims
    cfg = _cfg("fem_bdia", nx=nx, ny=ny, ts=ts)
    fam = spec._module("families", "fem_bdia")
    inputs = fam.make(cfg, 7, "cpu")
    dense = _dense_fem(inputs, nx, ny, 4)
    assert fam.counts(cfg, 1)["entries"] == int((dense != 0).sum())
    # no value outside the grid's couplings: the layout holds exactly the entries
    assert int((inputs["vals"] != 0).sum()) == fam.counts(cfg, 1)["entries"]
    ref = fam.Reference(cfg, inputs, block_rows=block_rows)
    n = nx * ny * 4
    for k in (None, 5):
        x = torch.randn((n,) if k is None else (n, k), generator=torch.Generator().manual_seed(4))
        want = dense @ x.double()
        torch.testing.assert_close(ref.apply(x).double(), want, rtol=1e-13, atol=1e-12)
        rows, scale = [], []
        for r0, r1, ys, s in ref.blocks(x, ("exact", "tf32")):
            rows.append(ys["tf32"])
            scale.append(s)
        torch.testing.assert_close(torch.cat(scale).reshape(want.shape),
                                   dense.abs() @ x.double().abs(), rtol=1e-13, atol=1e-12)
        tf = torch.cat(rows).reshape(want.shape)
        exact_tf = round_tf32(dense.float()).double() @ round_tf32(x).double()
        torch.testing.assert_close(tf, exact_tf, rtol=1e-5, atol=1e-5)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -(1.0 + 2 ** -10 + 2 ** -12)])
    assert round_tf32(x).tolist() == [1.0, 1.0, 1.0 + 2 ** -9, -(1.0 + 2 ** -10)]
