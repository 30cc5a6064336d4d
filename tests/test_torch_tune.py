"""The port's autotuner against the JAX package's, on the CPU.

Mirrors ``tests/test_tuner.py``: ``enumerate_variants`` gives the
reference's names and modeled bytes (rel 1e-12) from the same calibration
record; every variant builds on the CPU, where the kernel variants run their
plain twins, and agrees with scipy f64 (f64 within 1e-10, f32 normwise within
1e-5); ``tune`` is correct and cached, its cache entries cross between the
two packages both ways; the plausibility gate and the wall budget act on a
faked ``measure``; a gate's refusal is recorded, any other build error
propagates.  Also the POH calibration's model, the bench harness and CLI.
"""

import dataclasses
import importlib
import io
import json

import jax  # noqa: F401  (kept on the CPU with x64 by conftest)
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cask_tpu.formats.generate as jgen
import cask_tpu_torch as ct
import cask_tpu_torch.formats.convert as tconv
import cask_tpu_torch.formats.generate as tgen
from cask_tpu.formats.signature import signature as jsignature
from cask_tpu.tune import tune as jtune
from cask_tpu.tune.cache import TunerCache as JCache
from cask_tpu.tune.calibrate import SEED_EQUIV_BYTES as J_SEEDS
from cask_tpu.tune.tuner import enumerate_variants as j_enumerate
from cask_tpu_torch.formats.signature import signature
from cask_tpu_torch.tune import Measurement, TunedSpmv, TunerCache, Variant, measure, tune
from cask_tpu_torch.tune import calibrate as cal
from cask_tpu_torch.tune.tuner import enumerate_variants

tuner_mod = importlib.import_module("cask_tpu_torch.tune.tuner")
CPU = "cpu"


@pytest.fixture()
def cache(tmp_path):
    return TunerCache(path=str(tmp_path / "tuner.json"))


def _scipy(a):
    return tconv.to_scipy(a).astype(np.float64)


def _check(y, ref, dtype):
    y = y.double().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
    if dtype == np.float64:
        np.testing.assert_allclose(y, ref, rtol=1e-10, atol=1e-10)
    else:
        assert np.linalg.norm(y - ref) <= 1e-5 * np.linalg.norm(ref)


# generator name, args, kwargs: the same matrix in both packages
ENUM_CASES = {
    "fem_blocks dof 4": ("fem_blocks", (10,), {"dof": 4}),
    "fem_blocks(23, dof=4)": ("fem_blocks", (23,), {"dof": 4}),
    "stencil_2d": ("stencil_2d", (20,), {}),
    "banded": ("banded", (500, 3), {"seed": 2}),
    "power_law": ("power_law", (600,), {"avg_degree": 6, "seed": 4}),
    "random_uniform": ("random_uniform", (300,), {"density": 0.02, "seed": 1}),
    "shuffled band": None,
    "shuffled stencil": None,  # RCM narrows its band, but leaves no DIA split
}


def _enum_pair(name, dtype):
    if name.startswith("shuffled"):
        s = tconv.to_scipy(tgen.banded(700, 4, seed=2) if name == "shuffled band"
                           else tgen.stencil_2d(40))
        p = np.random.default_rng(0).permutation(s.shape[0])
        s = s.tocsr()[p][:, p].tocsr().astype(dtype)
        from cask_tpu.formats.convert import from_scipy

        return from_scipy(s, format="csr"), tconv.from_scipy(s, format="csr")
    fn, args, kw = ENUM_CASES[name]
    return (getattr(jgen, fn)(*args, dtype=dtype, **kw),
            getattr(tgen, fn)(*args, dtype=dtype, **kw))


class TestEnumerateParity:
    @pytest.mark.parametrize("name", sorted(ENUM_CASES))
    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_names_and_bytes_equal_the_reference(self, name, dtype):
        ja, ta = _enum_pair(name, dtype)
        js, ts = jsignature(ja), signature(ta)
        for k in (None, 32, 128):
            for include in (True, False):
                want = j_enumerate(ja, js, k, include_pallas=include, calib=dict(J_SEEDS))
                got = enumerate_variants(ta, ts, k, include_pallas=include,
                                         calib=dict(J_SEEDS))
                assert [v.name for v in got] == [v.name for v in want], (k, include)
                for g, w in zip(got, want):
                    assert g.est_bytes == pytest.approx(w.est_bytes, rel=1e-12), g.name


class TestEnumerate:
    def test_always_has_fallback(self):
        for mat in (tgen.stencil_2d(10), tgen.power_law(300, seed=1)):
            vs = enumerate_variants(mat, signature(mat), None)
            assert any(v.name == "csr_xla" for v in vs)

    def test_banded_proposes_dia_first(self):
        a = tgen.banded(500, 3, seed=2)
        vs = enumerate_variants(a, signature(a), None)
        assert min(vs, key=lambda v: v.est_bytes).name == "dia_pallas"

    def test_powerlaw_skips_dia(self):
        a = tgen.power_law(500, avg_degree=5, seed=3)
        vs = enumerate_variants(a, signature(a), None)
        assert not any(v.name == "dia_pallas" for v in vs)

    def test_fem_spmv_ranks_bdia_first(self):
        a = tgen.fem_blocks(23, dof=4)
        vs = enumerate_variants(a, signature(a), None, include_pallas=True)
        assert min(vs, key=lambda v: v.est_bytes).name == "bsr_pallas:4"

    def test_lell_not_enumerated(self):
        a = tgen.power_law(500, avg_degree=5, seed=3, dtype=np.float32)
        vs = enumerate_variants(a, signature(a), None)
        assert not any(v.name.startswith("lell:") for v in vs)

    def test_rcm_enumerated_only_without_a_band(self):
        _, a = _enum_pair("shuffled band", np.float64)
        names = {v.name for v in enumerate_variants(a, signature(a), None)}
        assert {"rcm:dia_pallas", "rcm:dia_xla"} <= names
        # a shuffled 2-D stencil: RCM's level sets leave no dense diagonals
        _, a = _enum_pair("shuffled stencil", np.float64)
        names = {v.name for v in enumerate_variants(a, signature(a), None)}
        assert not any(n.startswith(("rcm:", "dia")) for n in names)
        b = tgen.banded(1000, 3, seed=1)
        names = {v.name for v in enumerate_variants(b, signature(b), None)}
        assert "dia_pallas" in names and not any(n.startswith("rcm:") for n in names)


# every variant name the tuner can build, with a matrix and the ks it takes
BUILD_CASES = [
    ("csr_xla", "fem", (None, 8, 72)),
    ("bsr_xla:4", "fem", (None, 8, 72)),
    ("bsr_xla:8", "fem", (None, 8)),
    ("dia_xla", "band", (None, 8)),
    ("dia_pallas", "band", (None, 8, 72)),
    ("bsr_pallas:4", "fem", (None, 8, 72)),  # BDIA SpMV; BSR SpMM; the wide-k chain
    ("bsr_pallas:8", "fem", (None, 8, 72)),
    ("bsr_pallas:32", "fem", (72,)),  # the ring's gate refuses: the BSR SpMM kernel
    ("poh", "power", (None,)),
    ("poh:8192", "power", (None,)),
    ("poh_fast:2048", "power", (None,)),
    ("poh_fast:8192", "power", (None,)),
    ("poh_mm", "power", (8,)),
    ("poh_mm_fast", "power", (8,)),
    ("lell:8", "power", (None,)),
    ("rcm:dia_pallas", "shuffled", (None, 8)),
    ("rcm:dia_xla", "shuffled", (None, 8)),
]


def _build_matrix(kind, dtype):
    if kind == "fem":
        return tgen.fem_blocks(6, dof=4, dtype=dtype)
    if kind == "band":
        return tgen.banded(300, 3, seed=1, dtype=dtype)
    if kind == "power":
        return tgen.power_law(700, avg_degree=6, seed=4, dtype=dtype)
    return _enum_pair("shuffled band", dtype)[1]


class TestBuild:
    @pytest.mark.parametrize("name,kind,ks", BUILD_CASES, ids=[c[0] for c in BUILD_CASES])
    @pytest.mark.parametrize("dtype", [np.float64, np.float32])
    def test_every_variant_matches_scipy(self, name, kind, ks, dtype):
        a = _build_matrix(kind, dtype)
        s = _scipy(a)
        rng = np.random.default_rng(0)
        for k in ks:
            x = rng.standard_normal((a.shape[1], k) if k else a.shape[1]).astype(dtype)
            _, fn = Variant(name, 0.0).build(a, k, CPU)
            _check(fn(torch.from_numpy(x)), s @ x, dtype)
            _, fn_full, info = Variant(name, 0.0).build_full(a, k, CPU)
            _check(fn_full(torch.from_numpy(x)), s @ x, dtype)
            assert bool(info) == name.startswith("rcm:")

    def test_kernel_variants_build_their_kernels_plans(self):
        from cask_tpu_torch.ops.bdia import BdiaMatrix
        from cask_tpu_torch.ops.bsr_spmm import BsrSpmmKernel
        from cask_tpu_torch.ops.dia import DiaMatrix
        from cask_tpu_torch.ops.poh import PohMatrix

        a = tgen.fem_blocks(6, dof=4)
        assert isinstance(Variant("bsr_pallas:4", 0).build(a, None, CPU)[0], BdiaMatrix)
        assert isinstance(Variant("bsr_pallas:4", 0).build(a, 8, CPU)[0], BsrSpmmKernel)
        assert isinstance(Variant("bsr_pallas:4", 0).build(a, 128, CPU)[0], BdiaMatrix)
        assert isinstance(Variant("bsr_pallas:32", 0).build(a, 128, CPU)[0], BsrSpmmKernel)
        assert isinstance(Variant("dia_pallas", 0).build(a, None, CPU)[0], DiaMatrix)
        assert isinstance(Variant("poh_mm", 0).build(a, 8, CPU)[0], PohMatrix)

    def test_shared_plans(self):
        a = tgen.power_law(700, avg_degree=6, seed=4, dtype=np.float32)
        plans = {}
        p1, _ = Variant("poh:8192", 0).build(a, None, CPU, plans)
        p2, _ = Variant("poh_fast:8192", 0).build(a, None, CPU, plans)
        p3, _ = Variant("poh", 0).build(a, None, CPU, plans)
        assert p1 is p2 and p3 is not p1

    def test_unknown_variant_raises(self):
        with pytest.raises(ValueError):
            Variant("nope", 0.0).build(tgen.stencil_2d(4), None, CPU)

    def test_host_matrix_needs_a_device_or_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the build goes there")
        with pytest.raises(RuntimeError):
            Variant("csr_xla", 0.0).build(tgen.stencil_2d(4), None)


class TestTune:
    def test_result_correct_and_cached(self, cache):
        a = tgen.stencil_2d(16)
        t1 = tune(a, cache=cache, time_budget=2, device=CPU)
        x = np.random.default_rng(0).standard_normal(a.shape[1])
        _check(t1(torch.from_numpy(x)), _scipy(a) @ x, np.float64)
        t2 = tune(a, cache=cache, device=CPU)
        assert t2.variant == t1.variant
        assert cache.get(t1.signature_key) is not None

    def test_spmm_mode(self, cache):
        a = tgen.fem_blocks(8, dof=4)
        t = tune(a, k=32, cache=cache, time_budget=2, device=CPU)
        x = np.random.default_rng(1).standard_normal((a.shape[1], 32))
        _check(t(torch.from_numpy(x)), _scipy(a) @ x, np.float64)

    def test_kernel_variants_on_cpu_tensors(self, cache):
        # the caller asks for the CPU with a matrix of CPU tensors: the kernel
        # variants compete through their plain twins
        a = tgen.fem_blocks(8, dof=4, dtype=np.float32).to(CPU)
        t = tune(a, cache=cache, time_budget=20, include_pallas=True)
        timings = cache.get(t.signature_key)["timings"]
        assert {"bsr_pallas:4", "dia_pallas", "poh"} <= set(timings)
        x = np.random.default_rng(2).standard_normal(a.shape[1]).astype(np.float32)
        _check(t(torch.from_numpy(x)), _scipy(a) @ x, np.float32)

    def test_cache_distinguishes_k(self, cache):
        a = tgen.stencil_2d(12)
        t1 = tune(a, cache=cache, time_budget=1, device=CPU)
        t2 = tune(a, k=32, cache=cache, time_budget=1, device=CPU)
        assert t1.signature_key != t2.signature_key

    def test_diversity_rule_times_best_xla(self, cache):
        a = tgen.fem_blocks(8, dof=4)
        t = tune(a, cache=cache, time_budget=1, include_pallas=True, device=CPU)
        timings = cache.get(t.signature_key)["timings"]
        assert any("_xla" in name for name in timings)
        assert len(timings) >= 2
        for rec in timings.values():
            assert "seconds_per_op" in rec and "reliable" in rec and "plausible" in rec

    def test_no_budget_not_truncated(self, cache):
        t = tune(tgen.stencil_2d(10), cache=cache, time_budget=2, device=CPU)
        assert cache.get(t.signature_key)["truncated"] is False

    def test_tunes_a_coo_and_a_bsr_under_the_csr_key(self, cache):
        a = tgen.fem_blocks(6, dof=4)
        t = tune(a, cache=cache, time_budget=1, device=CPU)
        assert tune(tconv.csr_to_coo(a), cache=cache, device=CPU).signature_key \
            == t.signature_key
        with pytest.raises(TypeError):
            tune(np.eye(3), cache=cache, device=CPU)


class TestCacheAcrossPackages:
    """The state carried across: one cache file serves both packages."""

    def test_reference_entry_is_hit_by_the_port(self, tmp_path, monkeypatch):
        path = str(tmp_path / "shared.json")
        ja = jgen.fem_blocks(8, dof=4)
        jt = jtune(ja, cache=JCache(path=path), time_budget=2, include_pallas=False)
        monkeypatch.setattr(tuner_mod, "measure", _never_measure)
        ta = tgen.fem_blocks(8, dof=4)
        tt = tune(ta, cache=TunerCache(path=path), device=CPU)
        assert tt.signature_key == jt.signature_key
        assert tt.variant == jt.variant
        x = np.random.default_rng(3).standard_normal(ta.shape[1])
        _check(tt(torch.from_numpy(x)), _scipy(ta) @ x, np.float64)

    def test_port_entry_is_hit_by_the_reference(self, tmp_path):
        path = str(tmp_path / "shared.json")
        ta = tgen.stencil_2d(14)
        tt = tune(ta, cache=TunerCache(path=path), time_budget=2, device=CPU)
        entry = JCache(path=path).get(tt.signature_key)
        assert entry["variant"] == tt.variant
        jt = jtune(jgen.stencil_2d(14), cache=JCache(path=path), include_pallas=False)
        assert jt.variant == tt.variant and jt.signature_key == tt.signature_key

    @pytest.mark.parametrize("variant,k", [("bsr_pallas:4", None), ("dia_pallas", None),
                                           ("bsr_pallas:4", 32)])
    def test_reference_kernel_entry_builds_the_port_kernel_variant(self, tmp_path, variant, k,
                                                                   monkeypatch):
        from cask_tpu_torch.ops.bdia import BdiaMatrix
        from cask_tpu_torch.ops.bsr_spmm import BsrSpmmKernel
        from cask_tpu_torch.ops.dia import DiaMatrix

        path = str(tmp_path / "shared.json")
        ja = jgen.fem_blocks(8, dof=4)
        key = f"{jsignature(ja).key()}:k={k or 0}"
        JCache(path=path).put(key, {"variant": variant, "seconds_per_op": 1e-5})
        monkeypatch.setattr(tuner_mod, "measure", _never_measure)
        ta = tgen.fem_blocks(8, dof=4)
        tt = tune(ta, k=k, cache=TunerCache(path=path), device=CPU)
        assert tt.variant == variant and tt.seconds_per_op == 1e-5
        want = {("bsr_pallas:4", None): BdiaMatrix, ("dia_pallas", None): DiaMatrix,
                ("bsr_pallas:4", 32): BsrSpmmKernel}[(variant, k)]
        assert isinstance(tt.matrix, want)
        x = np.random.default_rng(4).standard_normal((ta.shape[1], k) if k else ta.shape[1])
        _check(tt(torch.from_numpy(x)), _scipy(ta) @ x, np.float64)


def _never_measure(*args, **kw):
    raise AssertionError("a cache hit times nothing")


class TestRefusalsAndErrors:
    def test_a_gate_refusal_is_recorded(self, cache, monkeypatch):
        def refuse_bdia(self, a, k, device=None, plans=None):
            if self.name.startswith("bsr_pallas"):
                raise ValueError("plan has 96 (d, c) pairs; the kernel takes at most 80")
            return orig(self, a, k, device, plans)

        orig = Variant.build
        monkeypatch.setattr(Variant, "build", refuse_bdia)
        a = tgen.fem_blocks(8, dof=4)
        t = tune(a, cache=cache, time_budget=20, include_pallas=True, device=CPU)
        timings = cache.get(t.signature_key)["timings"]
        assert "refused" in timings["bsr_pallas:4"] and "96" in timings["bsr_pallas:4"]["refused"]
        assert not t.variant.startswith("bsr_pallas")

    def test_a_build_error_propagates(self, cache, monkeypatch):
        def broken(self, a, k, device=None, plans=None):
            if self.name == "dia_pallas":
                raise RuntimeError("nvcc failed")
            return orig(self, a, k, device, plans)

        orig = Variant.build
        monkeypatch.setattr(Variant, "build", broken)
        with pytest.raises(RuntimeError, match="nvcc"):
            tune(tgen.banded(200, 2, seed=1), cache=cache, time_budget=20,
                 include_pallas=True, device=CPU)

    def test_a_launch_error_propagates(self, cache, monkeypatch):
        def failing_measure(fn, x0, **kw):
            raise RuntimeError("bdia_spmv kernel launch failed: cudaError 700")

        monkeypatch.setattr(tuner_mod, "measure", failing_measure)
        with pytest.raises(RuntimeError, match="launch failed"):
            tune(tgen.fem_blocks(6, dof=4), cache=cache, include_pallas=True, device=CPU)


def _non_finite_for(names):
    """A ``measure`` whose reading of the variants in ``names`` has a
    non-finite checksum (a broken kernel), the others a finite one."""
    built = {}
    build_full = Variant.build_full

    def tracking_build(self, *args, **kw):
        dev, fn, info = build_full(self, *args, **kw)
        built[id(fn)] = self.name
        return dev, fn, info

    def fake_measure(fn, x0, **kw):
        bad = built[id(fn)] in names
        return Measurement(seconds_per_iter=1e-3, reliable=True,
                           checksum=float("nan") if bad else 1.0)

    return tracking_build, fake_measure


class TestNonFiniteProducts:
    def test_skipped_and_recorded_on_the_cpu(self, cache, monkeypatch):
        build, fake = _non_finite_for({"dia_pallas"})
        monkeypatch.setattr(Variant, "build_full", build)
        monkeypatch.setattr(tuner_mod, "measure", fake)
        t = tune(tgen.banded(200, 2, seed=1), cache=cache, time_budget=20,
                 include_pallas=True, device=CPU)
        timings = cache.get(t.signature_key)["timings"]
        assert timings["dia_pallas"]["non_finite"] is True
        assert t.variant != "dia_pallas"
        assert not any(r.get("non_finite") for n, r in timings.items() if n != "dia_pallas")

    def test_raises_where_the_gate_is_on(self, cache, monkeypatch):
        build, fake = _non_finite_for({"dia_pallas"})
        monkeypatch.setattr(Variant, "build_full", build)
        monkeypatch.setattr(tuner_mod, "measure", fake)
        monkeypatch.setattr(tuner_mod, "_gated", lambda device: True)
        monkeypatch.setattr(tuner_mod, "hbm_bandwidth", lambda: (3.35e12, True))
        with pytest.raises(RuntimeError, match="dia_pallas gave a non-finite product"):
            tune(tgen.banded(200, 2, seed=1), cache=cache, time_budget=20,
                 include_pallas=True, device=CPU)

    def test_an_overflowing_product_is_data(self, cache, monkeypatch):
        # the exact product exceeds f16's range: no variant is at fault
        a = tgen.stencil_2d(20, dtype=np.float16)
        a = dataclasses.replace(a, data=a.data * np.float16(16000.0))  # 64000 on the diagonal
        assert np.isfinite(a.data).all()
        build, fake = _non_finite_for({"csr_xla", "dia_pallas", "dia_xla"})
        monkeypatch.setattr(Variant, "build_full", build)
        monkeypatch.setattr(tuner_mod, "measure", fake)
        monkeypatch.setattr(tuner_mod, "_gated", lambda device: True)
        monkeypatch.setattr(tuner_mod, "hbm_bandwidth", lambda: (3.35e12, True))
        t = tune(a, cache=cache, time_budget=20, include_pallas=True, device=CPU)
        timings = cache.get(t.signature_key)["timings"]
        assert timings["csr_xla"]["non_finite"] is True


class TestSameCallable:
    @pytest.mark.parametrize("name, first", [
        ("dia_xla", "csr_xla"), ("poh_fast:2048", "poh"), ("poh:2048", "poh"),
        ("poh_fast:8192", "poh:8192"), ("poh_mm_fast", "poh_mm"), ("poh_mm", "poh_mm"),
        ("rcm:dia_xla", "rcm:dia_xla"), ("bsr_pallas:4", "bsr_pallas:4")])
    def test_names(self, name, first):
        assert tuner_mod._same_callable(name) == first

    def test_timed_once_under_the_first_name(self, cache, monkeypatch):
        timed = set()  # the callables measured (an unreliable reading is measured again)
        measure_ = tuner_mod.measure

        def counting(fn, x0, **kw):
            timed.add(id(fn))
            return measure_(fn, x0, runs=2, reps=1)

        monkeypatch.setattr(tuner_mod, "measure", counting)
        a = tgen.power_law(600, avg_degree=6, seed=9, dtype=np.float32)
        t = tune(a, cache=cache, time_budget=20, include_pallas=True, device=CPU)
        timings = cache.get(t.signature_key)["timings"]
        names = {v.name for v in enumerate_variants(a, signature(a), None)}
        assert set(timings) == names
        aliases = {n: r["same_as"] for n, r in timings.items() if "same_as" in r}
        assert aliases and all(tuner_mod._same_callable(n) == tuner_mod._same_callable(f)
                               for n, f in aliases.items())
        assert all(timings[n]["seconds_per_op"] == timings[f]["seconds_per_op"]
                   for n, f in aliases.items())
        assert len(timed) == len(names) - len(aliases)
        assert t.variant not in aliases


class TestMeasure:
    def test_cpu_reading(self):
        a = tgen.stencil_2d(40)
        x0 = torch.from_numpy(np.random.default_rng(2).standard_normal(a.shape[1]))
        m = measure(lambda v: ct.spmv(a.to(CPU), v), x0)
        assert m.seconds_per_iter > 0 and isinstance(m.reliable, bool)
        assert m.checksum == pytest.approx(np.abs(_scipy(a) @ x0.numpy()).sum())

    def test_non_finite_output(self):
        m = measure(lambda v: v * float("inf"), torch.ones(8), runs=3, reps=1)
        assert not np.isfinite(m.checksum)

    def test_needs_no_card_for_cpu_and_raises_without_one_for_cuda(self):
        from cask_tpu_torch.tune.timing import time_cuda

        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError):
            time_cuda(lambda: None)


@dataclasses.dataclass
class FakeMeas:
    seconds_per_iter: float
    reliable: bool
    checksum: float = 1.0


def _scripted(monkeypatch, script, bw=3.35e12, known=True):
    """The gate on (as on a CUDA device) with a known bandwidth, and
    ``measure`` replaced by the readings of ``script`` in call order."""
    calls = {"n": 0}

    def fake_measure(fn, x0, **kw):
        i = min(calls["n"], len(script) - 1)
        calls["n"] += 1
        return script[i]

    monkeypatch.setattr(tuner_mod, "_gated", lambda device: True)
    monkeypatch.setattr(tuner_mod, "hbm_bandwidth", lambda: (bw, known))
    monkeypatch.setattr(tuner_mod, "measure", fake_measure)
    return calls


class TestPlausibilityGate:
    def test_physics_beats_blind_reliability(self, cache, monkeypatch):
        a = tgen.fem_blocks(158, dof=4, dtype=np.float32)
        _scripted(monkeypatch, [FakeMeas(1e-9, False),  # below half its floor
                                FakeMeas(5e-2, True),  # reliable, far slower
                                FakeMeas(3e-4, False)])  # plausible, the true winner
        t = tune(a, cache=cache, include_pallas=False, time_budget=3, device=CPU)
        assert abs(t.seconds_per_op - 3e-4) < 1e-12, t.seconds_per_op
        timings = cache.get(t.signature_key)["timings"]
        assert [r["plausible"] for r in timings.values()].count(False) == 1
        assert all(r["floor_seconds"] > 0 for r in timings.values())

    def test_reliable_plausible_still_wins_close_races(self, cache, monkeypatch):
        a = tgen.stencil_2d(512, dtype=np.float32)
        _scripted(monkeypatch, [FakeMeas(4e-5, False), FakeMeas(6e-5, True),
                                FakeMeas(9e-5, True)])
        t = tune(a, cache=cache, include_pallas=False, time_budget=3, device=CPU)
        assert abs(t.seconds_per_op - 6e-5) < 1e-12, t.seconds_per_op

    def test_unknown_card_loosens_the_cut(self, cache, monkeypatch):
        a = tgen.stencil_2d(512, dtype=np.float32)
        floor = (a.nnz * 4 + 2 * a.shape[0] * 4) / 3.35e12
        _scripted(monkeypatch, [FakeMeas(0.2 * floor, True)], bw=None, known=False)
        t = tune(a, cache=cache, include_pallas=False, time_budget=1, device=CPU)
        rec = cache.get(t.signature_key)["timings"][t.variant]
        assert rec["plausible"] is True  # above 0.125 of the floor

    def test_the_floor_is_the_products_bytes(self, cache, monkeypatch):
        # each stored value read once, x read and y written once: the
        # modeled bytes' ranking terms (the gather penalty, POH's
        # time-equivalent bytes) are no floor
        a = tgen.power_law(3000, avg_degree=6, seed=2, dtype=np.float32)
        _scripted(monkeypatch, [FakeMeas(1e-3, True)])
        t = tune(a, k=8, cache=cache, include_pallas=True, time_budget=20, device=CPU)
        timings = cache.get(t.signature_key)["timings"]
        assert {"csr_xla", "poh_mm"} <= set(timings)
        (m, n), want = a.shape, (a.nnz * 4 + (a.shape[0] + a.shape[1]) * 4 * 8) / 3.35e12
        assert m == n and all(r["floor_seconds"] == pytest.approx(want, rel=1e-12)
                              for r in timings.values())

    def test_cpu_readings_are_not_gated(self, cache):
        t = tune(tgen.stencil_2d(12), cache=cache, time_budget=2, device=CPU)
        for rec in cache.get(t.signature_key)["timings"].values():
            assert rec["floor_seconds"] == 0.0 and rec["plausible"] is True


class TestTuneWallBudget:
    def test_wall_budget_truncates_and_records(self, cache, monkeypatch):
        import time as time_mod

        calls = {"n": 0}

        def slow_measure(fn, x0, **kw):
            calls["n"] += 1
            time_mod.sleep(0.25)
            fn(x0)
            return Measurement(seconds_per_iter=1e-3 * calls["n"], reliable=True,
                               checksum=1.0)

        monkeypatch.setattr(tuner_mod, "measure", slow_measure)
        a = tgen.fem_blocks(8, dof=4)
        t = tune(a, cache=cache, time_budget=4, include_pallas=False, wall_budget_s=0.1,
                 device=CPU)
        entry = cache.get(t.signature_key)
        assert entry["truncated"] is True
        assert calls["n"] == 1 and len(entry["timings"]) == 1


class TestTunePrecisionConstraint:
    def test_f32_excludes_fast_variants(self, cache):
        a = tgen.power_law(600, avg_degree=6, seed=9, dtype=np.float32)
        names_any = {v.name for v in enumerate_variants(a, signature(a), None,
                                                         include_pallas=True)}
        assert any("_fast" in n for n in names_any)
        t = tune(a, cache=cache, time_budget=2, precision="f32", include_pallas=True,
                 device=CPU)
        assert "_fast" not in t.variant
        assert t.signature_key.endswith(":f32")
        assert not any("_fast" in n for n in cache.get(t.signature_key)["timings"])
        t2 = tune(a, cache=cache, time_budget=2, device=CPU)
        assert t2.signature_key != t.signature_key

    def test_unknown_precision_rejected(self, cache):
        with pytest.raises(ValueError):
            tune(tgen.stencil_2d(8), cache=cache, precision="bf16", device=CPU)


class TestReorderedApi:
    def test_build_full_exposes_reordered_kernel(self):
        rng = np.random.default_rng(7)
        p = rng.permutation(120)
        s = tconv.to_scipy(tgen.banded(120, 3, seed=5)).toarray()[np.ix_(p, p)]
        a = tconv.from_scipy(sp.csr_matrix(s))
        for name in ("rcm:dia_xla", "rcm:dia_pallas"):
            dev, fn, info = Variant(name, 0.0).build_full(a, None, CPU)
            perm, inner = info["perm"], info["inner_fn"]
            x = rng.standard_normal(120)
            _check(fn(torch.from_numpy(x)), s @ x, np.float64)
            xr = torch.from_numpy(x[perm])
            for _ in range(3):
                xr = inner(xr)
            ref = x.copy()
            for _ in range(3):
                ref = s @ ref
            assert sorted(perm) == list(range(len(x)))
            _check(xr.numpy()[np.argsort(perm)], ref, np.float64)
            tuned = TunedSpmv(variant=name, matrix=dev, _fn=fn, signature_key="t", perm=perm,
                              _inner_fn=inner)
            assert tuned.is_reordered
            rfn, rperm = tuned.reordered()
            _check(rfn(torch.from_numpy(x[rperm])).numpy()[np.argsort(rperm)], s @ x,
                   np.float64)

    def test_reordered_raises_on_plain_variant(self):
        t = TunedSpmv(variant="csr_xla", matrix=None, _fn=lambda x: x, signature_key="t")
        assert not t.is_reordered
        with pytest.raises(ValueError):
            t.reordered()


class TestCalibration:
    def test_defaults_without_record(self, cache):
        assert cal.poh_equiv_bytes(cache) == cal.SEED_EQUIV_BYTES

    def test_cached_record_overrides(self, cache):
        cache.put(cal._key(), {"equiv_bytes": {"poh:2048": 111.0}})
        eb = cal.poh_equiv_bytes(cache)
        assert eb["poh:2048"] == 111.0 and eb["poh_mm"] == cal.SEED_EQUIV_BYTES["poh_mm"]

    def test_a_cpu_record_is_not_the_cards(self, cache):
        cache.put(cal._key(CPU), {"equiv_bytes": {"poh:2048": 7.0}})
        assert cal._key(CPU) == "calibration:poh:cpu"
        assert cal.poh_equiv_bytes(cache, CPU)["poh:2048"] == 7.0

    def test_enumeration_uses_calibration(self):
        a = tgen.power_law(600, avg_degree=6, seed=4, dtype=np.float32)
        cheap = {"poh:2048": 1.0, "poh:8192": 2.0, "poh_fast:8192": 3.0, "poh_mm": 1.0,
                 "poh_mm_fast": 1.0}
        vs = enumerate_variants(a, signature(a), None, include_pallas=True, calib=cheap)
        assert min(vs, key=lambda v: v.est_bytes).name.split(":")[0] == "poh"

    def test_model_constants_are_the_references(self):
        from cask_tpu.tune import calibrate as jcal

        assert (cal.POH_ALPHA, cal.POH_TILE_EQUIV, cal.POH_FILL) \
            == (jcal.POH_ALPHA, jcal.POH_TILE_EQUIV, jcal.POH_FILL)
        assert set(cal.SEED_EQUIV_BYTES) == set(jcal.SEED_EQUIV_BYTES)

    def test_calibrate_on_the_cpu_records_under_cpu(self, cache):
        eb = cal.calibrate_poh(cache, n=2000, avg_degree=8, k=4, force=True, device=CPU)
        rec = cache.get(cal._key(CPU))
        assert set(rec["equiv_bytes"]) == set(cal.SEED_EQUIV_BYTES)
        assert eb["_c_ref"] == cal.poh_auto_window(2000, 2000, rec["nnz"], 2048)
        assert all(v > 0 for v in rec["pack_bytes"].values())
        assert cal.calibrate_poh(cache, n=2000, device=CPU) == eb  # a hit: no probe

    def test_default_probe_exceeds_the_l2_and_anchors_at_2048(self):
        # the default probe's packs are larger than the H100's 50 MB L2, and
        # its auto window at 2048-slot tiles is 2048 (the reference's anchor)
        import inspect

        kw = inspect.signature(cal.calibrate_poh).parameters
        n, deg = kw["n"].default, kw["avg_degree"].default
        nnz = tgen.power_law(n, avg_degree=deg, seed=0).nnz
        assert nnz * 12 > 50 * 2**20
        assert cal.poh_auto_window(n, n, nnz, 2048) == 2048
        assert cal.poh_auto_window(n, n, nnz, 8192) == 8192


class TestAnalyticPohCost:
    @pytest.mark.parametrize("n,deg,ts", [(3000, 6, 2048), (8000, 12, 2048), (3000, 6, 8192)])
    def test_auto_window_matches_the_ports_plan(self, n, deg, ts):
        a = tgen.power_law(n, avg_degree=deg, seed=1, dtype=np.float32)
        p = ct.poh_plan(a, tile_slots=ts, device=CPU)
        assert cal.poh_auto_window(a.shape[0], a.shape[1], a.nnz, ts) == p.col_window

    def test_equals_the_reference_model(self):
        from cask_tpu.tune import calibrate as jcal

        for m, n, nnz in ((50_000, 50_000, 1_170_000), (1_200_000, 400_000, 1_200_000),
                          (700, 900, 4000)):
            for ts in (2048, 8192):
                assert cal.poh_auto_window(m, n, nnz, ts) == jcal.poh_auto_window(m, n, nnz, ts)
                for fast in (False, True):
                    assert cal.poh_equiv_bytes_analytic(
                        m, n, nnz, ts, fast=fast, calib=dict(J_SEEDS)) == pytest.approx(
                        jcal.poh_equiv_bytes_analytic(m, n, nnz, ts, fast=fast,
                                                      calib=dict(J_SEEDS)), rel=1e-12)


class TestBenchHarness:
    def test_bench_matrix_records(self):
        from cask_tpu_torch.bench import bench_matrix

        buf = io.StringIO()
        recs = bench_matrix("fem", tgen.fem_blocks(6, dof=4), out=buf, device=CPU)
        lines = [json.loads(line) for line in buf.getvalue().splitlines()]
        assert lines == recs and len(recs) == 3
        for r in recs:
            assert r["device"] == "cpu" and r["seconds_per_op"] > 0
            assert "roofline_frac" not in r  # no device bandwidth on the CPU
            assert "error" not in r and "non_finite" not in r

    def test_bench_matrix_flags_a_non_finite_product(self, monkeypatch):
        from cask_tpu_torch.bench import bench_matrix

        harness = importlib.import_module("cask_tpu_torch.bench.harness")
        monkeypatch.setattr(harness, "measure", lambda fn, x0, **kw: Measurement(
            seconds_per_iter=1e-3, reliable=True, checksum=float("inf")))
        recs = bench_matrix("fem", tgen.fem_blocks(4, dof=4), variants=["csr_xla"],
                            out=io.StringIO(), device=CPU)
        assert recs[0]["non_finite"] is True

    def test_bench_matrix_records_a_refusal(self, monkeypatch):
        from cask_tpu_torch.bench import bench_matrix

        def refuse(self, a, k, device=None, plans=None):
            raise ValueError("the ring's gate refuses the plan")

        monkeypatch.setattr(Variant, "build", refuse)
        recs = bench_matrix("fem", tgen.fem_blocks(4, dof=4), variants=["bsr_pallas:4"],
                            k=128, out=io.StringIO(), device=CPU)
        assert "refused" in recs[0] and "error" not in recs[0]

    def test_spmv_traffic(self):
        from cask_tpu_torch.bench import OpTraffic, spmv_traffic

        a = tgen.fem_blocks(6, dof=4, dtype=np.float32)
        m, n = a.shape
        assert spmv_traffic(a, "csr_xla").bytes_per_op == a.nnz * 8 + (m + n) * 4
        plan = ct.bdia_plan(a, (4, 4), device=CPU)
        t = spmv_traffic(plan, "bsr_pallas:4", k=3)
        assert t.bytes_per_op == plan.traffic_bytes + (m + n) * 4 * 3
        assert t.nnz == a.nnz and t.flops_per_op == 2 * a.nnz * 3
        poh = ct.poh_plan(a, device=CPU)
        assert spmv_traffic(poh, "poh").bytes_per_op == poh.traffic_bytes
        rec = OpTraffic(1000, 10, 5).record(1e-6, bandwidth=2e9)
        assert rec["roofline_frac"] == 0.5
        with pytest.raises(TypeError):
            spmv_traffic(object(), "x")

    def test_cli_spmv_tune_and_the_paths_not_yet_ported(self, tmp_path, monkeypatch, capsys):
        from cask_tpu_torch.bench import cli

        monkeypatch.setenv("CASK_TPU_TORCH_TUNER_CACHE", str(tmp_path / "t.json"))
        monkeypatch.setattr(importlib.import_module("cask_tpu_torch.tune.cache"),
                            "_global_cache", None)  # the default cache, under that path
        mtx = tmp_path / "a.mtx"
        ct.write_mtx(str(mtx), tgen.stencil_2d(8))
        out = tmp_path / "out.jsonl"
        assert cli.main(["--cpu", "--out", str(out), "spmv", "--mtx", str(mtx),
                         "--variants", "csr_xla,dia_pallas"]) == 0
        recs = [json.loads(line) for line in out.read_text().splitlines()]
        assert [r["variant"] for r in recs] == ["csr_xla", "dia_pallas"]
        assert cli.main(["--cpu", "tune", "--mtx", str(mtx)]) == 0
        assert "s/op" in capsys.readouterr().err
        assert (tmp_path / "t.json").exists()
        # scaling and overlap run on spawned gloo ranks
        dist_out = tmp_path / "dist.jsonl"
        assert cli.main(["--cpu", "--out", str(dist_out), "scaling", "--side", "24",
                         "--shards", "1,2"]) == 0
        assert cli.main(["--cpu", "--out", str(dist_out), "overlap", "--side", "24",
                         "--shards", "2"]) == 0
        recs = [json.loads(line) for line in dist_out.read_text().splitlines()]
        assert [(r["op"], r.get("nshards")) for r in recs] == [
            ("dist_spmv_weak_scaling", 1), ("dist_spmv_weak_scaling", 2),
            ("dist_spmv_overlap_ab", 2), ("dist_spmv_overlap_ab", 2),
            ("dist_spmv_overlap_ab", 2)]
        assert recs[0]["efficiency"] == 1.0 and recs[0]["interior"] == "plain"
        assert all(r["seconds_per_op"] > 0 for r in recs[:4])
        # solve: the k-ladder needs 600 CG iterations with a nonzero f32
        # residual, which 96² rows give (at 16² CG reaches 0 after 127)
        solve_out = tmp_path / "solve.jsonl"
        assert cli.main(["--cpu", "--out", str(solve_out), "solve", "--side", "96"]) == 0
        recs = [json.loads(line) for line in solve_out.read_text().splitlines()]
        assert [(r["op"], r["solver"], r["rows"], r["device"]) for r in recs] == [
            ("pcg_per_iteration", "cg", 9216, "cpu"),
            ("pcg_per_iteration", "pipelined_cg", 9216, "cpu")]
        assert all(r["us_per_iteration"] > 0 for r in recs)


def test_import_keeps_jax_out():
    import subprocess
    import sys

    code = ("import sys, cask_tpu_torch, cask_tpu_torch.bench.cli; "
            "import cask_tpu_torch.tune.calibrate; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'cask_tpu' or m.startswith('cask_tpu.')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
