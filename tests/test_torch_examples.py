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
"""

import os
import re
import runpy

import pytest

from cask_tpu_torch.examples import cg_solver, eigenvalues, least_squares, preconditioners

_EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "examples")


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
