"""Port parity for the paper's cycle model, power model and ShiftAddLLM
baseline: every case of ``tests/test_simulator.py`` run on the port's
``core.simulator``, ``core.energy`` and ``core.shiftadd``, each held to
the paper's figures as the JAX test holds them AND equal to the JAX
module's numbers on the same inputs.

Both packages run the same numpy arithmetic on the same codes, so counts
and cycle totals must be equal and floats equal to the last bit; the one
exception is ``shiftadd_matmul``, which takes tensors in the port (float64
einsum in torch against numpy's: rtol 1e-12). The simulator also takes
tensors and QTensors, which give the numbers of their numpy codes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import energy as JE
from repro.core import reuse as JR
from repro.core import shiftadd as JSA
from repro.core import simulator as JS
from repro_torch.core import energy as TE
from repro_torch.core import reuse as TR
from repro_torch.core import shiftadd as TSA
from repro_torch.core import simulator as TS
from repro_torch.core.quantization import QuantConfig, quantize


def _same_report(t, j):
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.speedup, t.reuse_rate, t.hazard_rate) == \
        (j.speedup, j.reuse_rate, j.hazard_rate)


@pytest.fixture(scope="module")
def distilbert_reports():
    return (TS.simulate_model(TS.PAPER_MODELS["distilbert"], TS.SimConfig()),
            JS.simulate_model(JS.PAPER_MODELS["distilbert"], JS.SimConfig()))


# ---------------------------------------------------------------------------
# Paper validation
# ---------------------------------------------------------------------------

def test_distilbert_absolute_cycles(distilbert_reports):
    """Paper: AxLLM 85.11M vs baseline 159.34M cycles."""
    t, j = distilbert_reports
    _same_report(t, j)
    assert t.cycles_axllm / 1e6 == pytest.approx(85.11, rel=0.03)
    assert t.cycles_baseline / 1e6 == pytest.approx(159.34, rel=0.03)


def test_distilbert_speedup(distilbert_reports):
    t, j = distilbert_reports
    assert t.speedup == j.speedup == pytest.approx(1.87, rel=0.03)


def test_reuse_rate_bands(distilbert_reports):
    """Paper Fig. 8: >=87% min with unbounded buffers; ~70% avg at 256."""
    t, j = distilbert_reports
    assert t.reuse_rate == j.reuse_rate == pytest.approx(0.70, abs=0.04)
    tc = TS.gaussian_codes(np.random.default_rng(0), 768, 768)
    np.testing.assert_array_equal(
        tc, JS.gaussian_codes(np.random.default_rng(0), 768, 768))
    assert TR.reuse_rate(tc, None) == JR.reuse_rate(tc, None) >= 0.85
    llama = TS.gaussian_codes(np.random.default_rng(0), 4096, 4096)
    assert TR.reuse_rate(llama, None) == JR.reuse_rate(llama, None) >= 0.95


def test_speedups_converge_across_models():
    sps = []
    for name in ("distilbert", "bert-base", "bert-large"):
        t = TS.simulate_model(TS.PAPER_MODELS[name], TS.SimConfig())
        _same_report(t, JS.simulate_model(JS.PAPER_MODELS[name],
                                          JS.SimConfig()))
        sps.append(t.speedup)
    assert max(sps) - min(sps) < 0.15
    assert all(1.6 <= s <= 2.0 for s in sps)


def test_power_reduction_matches_paper(distilbert_reports):
    """Paper §V: 0.94 W -> 0.67 W (28% power reduction)."""
    t, j = distilbert_reports
    pr = TE.power_report(t)
    assert pr == JE.power_report(j)
    assert pr["power_baseline_w"] == pytest.approx(0.94, abs=1e-6)
    assert pr["power_reduction"] == pytest.approx(0.287, abs=0.035)
    assert dataclasses.asdict(TE.calibrated_model(t)) == \
        dataclasses.asdict(JE.calibrated_model(j))


def test_shiftadd_comparison_matches_paper():
    """Paper §V: AxLLM 29% faster than ShiftAddLLM on DistilBERT."""
    r = TSA.compare_vs_axllm(TS.PAPER_MODELS["distilbert"])
    assert r == JSA.compare_vs_axllm(JS.PAPER_MODELS["distilbert"])
    assert r["axllm_over_shiftadd"] == pytest.approx(1.29, abs=0.05)


def test_lora_adapter_speedup_and_overlap():
    """Paper §V: ~90% A-row overlap; adapter speedup ~1.8x."""
    rng = np.random.default_rng(0)
    w = TS.gaussian_codes(rng, 768, 768)
    a = TS.gaussian_codes(rng, 768, 16)
    out = TS.simulate_lora(w, a, TS.SimConfig())
    assert out == JS.simulate_lora(w, a, JS.SimConfig())
    assert out["row_overlap"] > 0.85
    assert out["adapter_speedup"] == pytest.approx(1.8, abs=0.4)


def test_hazard_rate_small():
    """Paper §IV: RAW-hazard likelihood ~2%."""
    codes = TS.gaussian_codes(np.random.default_rng(0), 256, 768)
    rep = TS.simulate_matrix(codes, TS.SimConfig(), measure_hazards=True)
    _same_report(rep, JS.simulate_matrix(codes, JS.SimConfig(),
                                         measure_hazards=True))
    assert rep.hazard_rate < 0.08


# ---------------------------------------------------------------------------
# Structural invariants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [64, 256, 1024])
def test_axllm_never_slower_than_baseline(m):
    codes = TS.gaussian_codes(np.random.default_rng(m), 64, m)
    rep = TS.simulate_matrix(codes, TS.SimConfig())
    _same_report(rep, JS.simulate_matrix(codes, JS.SimConfig()))
    assert rep.cycles_axllm <= rep.cycles_baseline
    assert rep.mults + rep.rc_hits == rep.total_ops


def test_cycles_lower_bounded_by_uniques():
    codes = TS.gaussian_codes(np.random.default_rng(2), 64, 256)
    cfg = TS.SimConfig()
    rep = TS.simulate_matrix(codes, cfg)
    uniq = TR.segment_unique_counts(codes, cfg.buf)
    np.testing.assert_array_equal(uniq, JR.segment_unique_counts(codes,
                                                                 cfg.buf))
    assert rep.cycles_axllm >= uniq.max()


def test_exact_event_model_brackets_analytic():
    """The queue-level event model falls between the ideal overlap and
    the fully serial bound, with the JAX module's cycle count."""
    cfg = TS.SimConfig()
    codes = TS.gaussian_codes(np.random.default_rng(3), 64, 256)
    cells = TR.fold_codes(codes, True)
    np.testing.assert_array_equal(cells, JR.fold_codes(codes, True))
    for row in cells[:8]:
        u = len(set(row.tolist()))
        exact = TS.simulate_segment_exact(row, cfg)
        assert exact == JS.simulate_segment_exact(row, JS.SimConfig())
        lo = max(len(row) / cfg.slices, u)
        hi = len(row) + cfg.drain + u * cfg.mult_latency
        assert lo <= exact <= hi


def test_degenerate_single_value_reverts_to_serial():
    cells = np.full(256, 5, dtype=np.int64)
    exact = TS.simulate_segment_exact(cells, TS.SimConfig())
    assert exact == JS.simulate_segment_exact(cells, JS.SimConfig()) >= 250


def test_calibration_stability():
    cfg, jcfg = TS.SimConfig(), JS.SimConfig()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.collision_efficiency == pytest.approx(0.86)
    assert cfg.hit_throughput == jcfg.hit_throughput == pytest.approx(3.44)
    assert cfg.hit_throughput_ballsbins == jcfg.hit_throughput_ballsbins \
        == pytest.approx(2.734, abs=0.01)
    assert cfg.drain == jcfg.drain
    assert dataclasses.asdict(TSA.ShiftAddConfig()) == \
        dataclasses.asdict(JSA.ShiftAddConfig())


def test_paper_model_specs_equal_jax():
    assert list(TS.PAPER_MODELS) == list(JS.PAPER_MODELS)
    for name, spec in TS.PAPER_MODELS.items():
        assert dataclasses.asdict(spec) == \
            dataclasses.asdict(JS.PAPER_MODELS[name])
        assert TSA.shiftadd_model_cycles(spec) == \
            JSA.shiftadd_model_cycles(JS.PAPER_MODELS[name])


# ---------------------------------------------------------------------------
# The simulator on the port's own types
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 4])
def test_simulate_matrix_takes_qtensors_and_tensors(bits):
    """A QTensor's codes (int4 packed) and a tensor of codes give the
    numbers of the same codes as numpy, on the JAX module too."""
    w = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (128, 512)).astype(np.float32))
    qt = quantize(w, QuantConfig(bits=bits))
    codes = TR._as_numpy_codes(qt)
    assert codes.shape == (128, 512)
    want = JS.simulate_matrix(codes, JS.SimConfig(), tokens=8)
    for given in (qt, torch.from_numpy(codes), codes):
        _same_report(TS.simulate_matrix(given, TS.SimConfig(), tokens=8),
                     want)


def test_simulate_model_with_codes_by_name():
    rng = np.random.default_rng(9)
    spec = TS.ModelSpec("tiny", 2, (TS.MatrixSpec("wq", 64, 64),
                                    TS.MatrixSpec("up", 64, 256, count=2)),
                        tokens=3)
    jspec = JS.ModelSpec("tiny", 2, (JS.MatrixSpec("wq", 64, 64),
                                     JS.MatrixSpec("up", 64, 256, count=2)),
                         tokens=3)
    codes = {"wq": TS.gaussian_codes(rng, 64, 64)}
    _same_report(TS.simulate_model(spec, codes_by_name=codes),
                 JS.simulate_model(jspec, codes_by_name=codes))


# ---------------------------------------------------------------------------
# ShiftAdd numeric baseline
# ---------------------------------------------------------------------------

def test_shiftadd_reconstruction_converges_with_bits():
    w = np.random.default_rng(4).standard_normal((64, 64)).astype(np.float32)
    errs = [TSA.reconstruction_error(w, q) for q in (2, 4, 8)]
    assert errs == [JSA.reconstruction_error(w, q) for q in (2, 4, 8)]
    assert errs[0] > errs[1] > errs[2]


def test_shiftadd_matmul_matches_reconstruction():
    rng = np.random.default_rng(5)
    w = rng.standard_normal((32, 16))
    x = rng.standard_normal((4, 32))
    alphas, bits = TSA.binarize(w, 8)
    ja, jb = JSA.binarize(w, 8)
    np.testing.assert_array_equal(alphas, ja)
    np.testing.assert_array_equal(bits, jb)
    np.testing.assert_array_equal(TSA.reconstruct(alphas, bits),
                                  JSA.reconstruct(ja, jb))
    y1 = TSA.shiftadd_matmul(torch.from_numpy(x), torch.from_numpy(alphas),
                             torch.from_numpy(bits))
    assert y1.dtype == torch.float64
    y2 = x @ TSA.reconstruct(alphas, bits)
    np.testing.assert_allclose(y1.numpy(), y2, rtol=1e-10)
    np.testing.assert_allclose(y1.numpy(), JSA.shiftadd_matmul(x, ja, jb),
                               rtol=1e-12)


def test_axllm_exactness_advantage():
    """AxLLM is exact w.r.t. the int8 model; ShiftAdd approximates."""
    w = np.random.default_rng(6).standard_normal((128, 128)).astype(
        np.float32)
    sa_err = TSA.reconstruction_error(w, 8)
    assert sa_err == JSA.reconstruction_error(w, 8)
    scale = np.abs(w).max(axis=0) / 127
    int8_err = np.linalg.norm(w - np.round(w / scale) * scale) \
        / np.linalg.norm(w)
    assert int8_err < sa_err / 3


def test_shiftadd_cycles_equal_jax():
    for n, m, tokens in ((768, 768, 236), (4096, 11008, 1), (64, 8, 3)):
        assert TSA.shiftadd_cycles(n, m, tokens) == \
            JSA.shiftadd_cycles(n, m, tokens)
