"""The port's example twins (``cask_tpu_torch/examples``) against the
reference's ``examples/*.py``, both run on the CPU.

Each twin's ``main(device="cpu")`` runs beside the reference example on the
same matrices and seeds (the reference as a script, ``__main__``: its
``eigenvalues.py`` has no ``main``), and the numbers both print are held
together: iteration counts equal, within ±2 for LOBPCG's (its rounding
separates the two packages near tol), Ritz values within 1e-8, residuals
under the example's own bound.  The preconditioner tour's spectrum estimate
starts from another random vector than the reference's, which moves only
the Chebyshev line's last digits; the twin's AMG line has no reference row.

The later twins: ``solver_resident_cg`` within one iteration of the
reference and in its residual class; ``unstructured_spmv``'s errors and
pack line, the reference's tune run without its interpreted POH kernels
(with them its script takes minutes on the CPU); ``autotune_bench`` at a
small time budget, its winners and records held to the reference's
enumeration and records on the same matrices (the reference's whole
script takes about a minute on the CPU, mostly planning and interpreting
POH variants its harness then refuses); ``entry()``'s output within 1e-5
of ``__graft_entry__.entry()``'s on the same plan and x.
"""

import importlib
import importlib.util
import io
import json
import os
import re
import runpy
import sys

import numpy as np
import pytest
import torch

from cask_tpu_torch.examples import (autotune_bench, cg_solver, eigenvalues, least_squares,
                                     preconditioners, solver_resident_cg, unstructured_spmv)
from cask_tpu_torch.examples import entry as entry_twin

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_EXAMPLES = os.path.join(_ROOT, "examples")


def _run(module, capsys) -> str:
    module.main(device="cpu")
    return capsys.readouterr().out


def _reference(name: str, capsys) -> str:
    capsys.readouterr()
    runpy.run_path(os.path.join(_EXAMPLES, f"{name}.py"), run_name="__main__")
    return capsys.readouterr().out


def _numbers(pattern: str, out: str):
    m = re.search(pattern, out, re.M)
    assert m, (pattern, out)
    return m.groups()


def test_cg_solver(capsys):
    out, ref = _run(cg_solver, capsys), _reference("cg_solver", capsys)
    for pattern in (r"plain CG:\s+(\d+) iterations", r"ILU\(0\)-CG:\s+(\d+) iterations"):
        assert _numbers(pattern, out) == _numbers(pattern, ref)
    assert _numbers(r"plain CG:\s+(\d+)", out) == ("227",)
    for text in (out, ref):
        assert float(_numbers(r"‖Ax − b‖∞ = (\S+)", text)[0]) < 1e-8


def _table(out: str) -> dict:
    return {m.group(1).strip(): (int(m.group(2)), m.group(3))
            for m in re.finditer(r"^(.{28}) iters=\s*(\d+) .* converged=(\w+)$", out, re.M)}


def test_preconditioners(capsys):
    out, ref = _run(preconditioners, capsys), _reference("preconditioners", capsys)
    iters, want = _table(out), _table(ref)
    assert len(want) == 6
    assert {k: v for k, v in iters.items() if k != "smoothed_aggregation_amg"} == want
    assert all(conv == "True" for _, conv in iters.values())
    assert iters["smoothed_aggregation_amg"][0] < 20  # the V-cycle: 14 on this system


def test_eigenvalues(capsys):
    out, ref = _run(eigenvalues, capsys), _reference("eigenvalues", capsys)
    small = r"smallest 4: \[([^\]]*)\]\s+\((\d+) iters, converged=(\w+)\)"
    large = r"largest 4:\s+\[([^\]]*)\]\s+\((\d+) iters\)"
    (s_th, s_it, s_conv), (r_th, r_it, r_conv) = _numbers(small, out), _numbers(small, ref)
    assert s_conv == r_conv == "True"
    assert [float(v) for v in s_th.split()] == pytest.approx(
        [float(v) for v in r_th.split()], abs=1e-8)
    assert abs(int(s_it) - int(r_it)) <= 2
    (l_th, l_it), (rl_th, rl_it) = _numbers(large, out), _numbers(large, ref)
    assert [float(v) for v in l_th.split()] == pytest.approx(
        [float(v) for v in rl_th.split()], abs=1e-8)
    pcg = r"-PCG: (\d+) iters vs plain CG (\d+)"
    assert _numbers(pcg, out) == _numbers(pcg, ref)


def test_least_squares(capsys):
    out, ref = _run(least_squares, capsys), _reference("least_squares", capsys)
    conv = r"converged=(\w+) iters=(\d+)"
    assert _numbers(conv, out) == _numbers(conv, ref) == ("True", "44")
    for text in (out, ref):
        assert float(_numbers(r"‖Aᵀ\(b−Ax\)‖ = (\S+)", text)[0]) < 1e-6


@pytest.fixture()
def tuner_caches(tmp_path, monkeypatch):
    """Both packages' default tuner caches in a temporary directory."""
    from cask_tpu.tune import cache as jcache

    monkeypatch.setenv("CASK_TPU_TORCH_TUNER_CACHE", str(tmp_path / "port.json"))
    monkeypatch.setattr(importlib.import_module("cask_tpu_torch.tune.cache"), "_global_cache",
                        None)
    monkeypatch.setattr(jcache, "_global_cache", jcache.TunerCache(path=str(tmp_path / "j.json")))


def test_solver_resident_cg(capsys):
    out, ref = _run(solver_resident_cg, capsys), _reference("solver_resident_cg", capsys)
    offsets = r"operator mode: \w+ \(offsets (.*)\)$"
    assert _numbers(offsets, out) == _numbers(offsets, ref)
    cg = r"CG: (\d+) iterations, converged=(\w+), ‖Ax−b‖∞ = (\S+)"
    (it, conv, err), (r_it, r_conv, r_err) = _numbers(cg, out), _numbers(cg, ref)
    assert conv == r_conv == "True" and abs(int(it) - int(r_it)) <= 1
    # tol 1e-8 on ‖b‖ ≈ 95: both land within two decades of each other, under 1e-6
    assert float(err) < 1e-6 and float(r_err) < 1e-6
    assert 1e-2 < float(err) / float(r_err) < 1e2


def test_unstructured_spmv(capsys, monkeypatch, tuner_caches):
    import cask_tpu.tune  # noqa: F401  (the script imports its tune from here)

    jtune = sys.modules["cask_tpu.tune"].tune
    monkeypatch.setattr(sys.modules["cask_tpu.tune"], "tune",
                        lambda a, **kw: jtune(a, **{**kw, "include_pallas": False}))
    out, ref = _run(unstructured_spmv, capsys), _reference("unstructured_spmv", capsys)
    errs = {}
    for text, who in ((out, "port"), (ref, "reference")):
        errs[who] = [float(_numbers(rf"poh {mode}\s+relerr: (\S+)", text)[0])
                     for mode in ("split", "fast")]
        assert max(errs[who]) <= 1e-5  # the reference's split class
    assert errs["port"][0] == errs["port"][1]  # the same FMAs on the card and its twin
    fill = r"^(pack fill: .*)$"
    assert _numbers(fill, out) == _numbers(fill, ref)  # the same pack
    assert _numbers(r"tuned variant: (\S+)", out)


def test_autotune_bench(capsys, tuner_caches):
    import cask_tpu
    from cask_tpu.bench.harness import bench_matrix as jbench
    from cask_tpu.formats.signature import signature as jsig
    from cask_tpu.tune.tuner import enumerate_variants as jenum

    autotune_bench.main(device="cpu", time_budget=1)
    out = capsys.readouterr().out
    mats = {
        "banded_20k": cask_tpu.generate.banded(20000, 8, seed=0),
        "stencil_158": cask_tpu.generate.stencil_2d(158),
        "fem_dof4": cask_tpu.generate.fem_blocks(60, dof=4),
        "powerlaw_20k": cask_tpu.generate.power_law(20000, avg_degree=8, seed=1),
    }
    winners = re.findall(r"^(\S+)\s+→ (\S+)\s+(\S+) s/op$", out, re.M)
    assert [w[0] for w in winners] == list(mats)
    recs = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    assert sorted({r["matrix"] for r in recs}) == sorted(mats)
    for (name, variant, secs), a in zip(winners, mats.values()):
        names = {v.name for v in jenum(a, jsig(a), None, include_pallas=False)}
        assert variant in names and float(secs) > 0
        mine = [r for r in recs if r["matrix"] == name]
        assert 1 <= len(mine) <= 3 and all(r["seconds_per_op"] > 0 for r in mine)
        theirs = jbench(name, a, variants=[mine[0]["variant"]], out=io.StringIO())[0]
        for key in ("matrix", "op", "variant", "rows", "nnz", "dtype"):
            assert mine[0][key] == theirs[key], key


def test_entry():
    spec = importlib.util.spec_from_file_location("__graft_entry__",
                                                  os.path.join(_ROOT, "__graft_entry__.py"))
    graft = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(graft)
    jfn, (jplan, jx) = graft.entry()
    fn, (plan, x) = entry_twin.entry(device="cpu")
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(plan.vals.numpy(), np.asarray(jplan.vals))
    y, ref = fn(plan, x).numpy(), np.asarray(jfn(jplan, jx))
    assert y.shape == ref.shape == (4096,)
    assert np.linalg.norm(y - ref) / np.linalg.norm(ref) <= 1e-5
    assert plan.vals.device == torch.device("cpu")
