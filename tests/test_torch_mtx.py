"""The port's Matrix Market reader and writer, and the generators the
unstructured path's tests draw on, against the JAX package's, on the CPU.

Every fixture in tests/data/ (complex, pattern symmetric, skew-symmetric,
real symmetric) must parse to the same CSR and COO arrays as the
reference's reader, and round-trip through the port's writer.
"""

import gzip
import io
from pathlib import Path

import numpy as np
import pytest

import cask_tpu.formats.generate as jgen
from cask_tpu.formats.mtx import read_mtx as jread
from cask_tpu.formats.mtx import write_mtx as jwrite
import cask_tpu_torch as ct
import cask_tpu_torch.formats.generate as tgen
from cask_tpu_torch.formats.convert import to_scipy
from cask_tpu_torch.formats.mtx import read_mtx, write_mtx

DATA = Path(__file__).parent / "data"
FIXTURES = sorted(p.name for p in DATA.glob("*.mtx"))


def _same(t, j, fields):
    for f in fields:
        a, b = np.asarray(getattr(j, f)), np.asarray(getattr(t, f))
        np.testing.assert_array_equal(b, a, err_msg=f)
        assert b.dtype == a.dtype, f
    assert t.shape == j.shape


def test_every_fixture_is_found():
    assert {"complex_30x40.mtx", "graph_pattern_120.mtx", "skew_6.mtx",
            "stiff2d_576.mtx"} <= set(FIXTURES)


@pytest.mark.parametrize("name", FIXTURES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_read_equals_the_reference(name, dtype):
    _same(read_mtx(DATA / name, dtype=dtype), jread(str(DATA / name), dtype=dtype),
          ("data", "indices", "indptr"))
    _same(read_mtx(DATA / name, format="coo"), jread(str(DATA / name), format="coo"),
          ("data", "row", "col"))


@pytest.mark.parametrize("name", FIXTURES)
def test_write_round_trips(name, tmp_path):
    a = read_mtx(DATA / name)
    out = tmp_path / "a.mtx"
    write_mtx(out, a, comment="written by the port\nsecond line")
    _same(read_mtx(out), a, ("data", "indices", "indptr"))
    _same(jread(str(out)), a, ("data", "indices", "indptr"))
    # and the reference's writer's file reads the same in the port
    ref_out = tmp_path / "b.mtx"
    jwrite(str(ref_out), jread(str(DATA / name)))
    _same(read_mtx(ref_out), a, ("data", "indices", "indptr"))


def test_gzip_and_file_objects(tmp_path):
    a = read_mtx(DATA / "stiff2d_576.mtx")
    gz = tmp_path / "a.mtx.gz"
    with gzip.open(gz, "wt") as f:
        write_mtx(f, a)
    _same(read_mtx(gz), a, ("data", "indices", "indptr"))
    buf = io.StringIO()
    write_mtx(buf, ct.csr_to_coo(a))
    buf.seek(0)
    _same(read_mtx(buf), a, ("data", "indices", "indptr"))


@pytest.mark.parametrize("symmetry", ["general", "symmetric", "skew-symmetric"])
def test_dense_array_layout_equals_the_reference(symmetry):
    body = "\n".join(str(v) for v in (1.5, 2.0, 0.0, 4.0, 0.0, 6.0, 7.0, 0.0, 9.0))
    text = f"%%MatrixMarket matrix array real {symmetry}\n% c\n3 3\n{body}\n"
    _same(read_mtx(io.StringIO(text)), jread(io.StringIO(text)),
          ("data", "indices", "indptr"))


@pytest.mark.parametrize("text", [
    "not a header\n1 1 1\n1 1 1.0\n",
    "%%MatrixMarket tensor coordinate real general\n1 1 1\n1 1 1.0\n",
    "%%MatrixMarket matrix coordinate real general\n2 2 3\n1 1 1.0\n",
    "%%MatrixMarket matrix coordinate real general\n2 2 1\n0 1 1.0\n",
    "%%MatrixMarket matrix coordinate quaternion general\n1 1 1\n1 1 1.0\n",
])
def test_malformed_files_raise(text):
    with pytest.raises(ValueError):
        read_mtx(io.StringIO(text))


def test_write_refuses_other_objects():
    with pytest.raises(TypeError):
        write_mtx(io.StringIO(), np.eye(3))


def test_mtx_graph_through_poh_matches_scipy():
    # the quick-start path: read_mtx → poh_plan → spmv (CPU twin)
    import torch

    a = ct.read_mtx(DATA / "graph_pattern_120.mtx")
    p = ct.poh_plan(a, device="cpu")
    x = np.random.default_rng(0).standard_normal(a.shape[1])
    y = ct.spmv(p, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, to_scipy(a) @ x, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("args,kw", [((2000,), dict(density=0.005, seed=3)),
                                     ((300, 700), dict(density=0.02, seed=5)),
                                     ((700, 300), dict(density=0.02, dtype=np.float32,
                                                       seed=6))])
def test_random_uniform_is_bit_identical(args, kw):
    _same(tgen.random_uniform(*args, **kw), jgen.random_uniform(*args, **kw),
          ("data", "indices", "indptr"))


def test_stencil_3d_is_bit_identical():
    _same(tgen.stencil_3d(7, 5, 4), jgen.stencil_3d(7, 5, 4), ("data", "indices", "indptr"))


def test_small_suite_is_bit_identical():
    t, j = tgen.suite("small"), jgen.suite("small")
    assert list(t) == list(j)
    for name in t:
        _same(t[name], j[name], ("data", "indices", "indptr"))
    with pytest.raises(ValueError):
        tgen.suite("huge")
