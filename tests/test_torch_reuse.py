"""Port parity for the reuse (LUT) path: the port's ``core/reuse.py``
analytics, ``ops.reuse_matmul`` (the plain version, reached through ops and
through the CUDA wrapper's CPU path) and the ``impl="reuse"`` engine,
against the JAX package on the same numpy inputs.

Tolerances: in the dyadic regime (integer activations, dyadic scales)
every product and partial sum is exact in float32, so the port must be
bit-identical to JAX's ``reuse_matmul_ref`` and to the int64 product.
Elsewhere float32 sums in another order agree to about 1e-6 relative;
the bound used is rtol 1e-5 with an atol of 1e-5 times the output scale.
Multiply counts are integers and must be equal.
"""

import hypothesis.strategies as st
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings

from repro.configs.base import ModelConfig as JModelConfig
from repro.core import quantization as JQ
from repro.core import reuse as JR
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.model import get_model as j_get_model
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import ModelConfig
from repro_torch.core import quantization as TQ
from repro_torch.core import reuse as TR
from repro_torch.kernels import ops, ref
from repro_torch.kernels.reuse_matmul import reuse_matmul_cuda, segment
from repro_torch.serve.engine import ServeEngine
from test_torch_engine import jax_tree_to_numpy

K, N = 256, 128
ALPHABETS = [(8, "affine"), (4, "affine"), (8, "codebook"), (4, "codebook")]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, rtol=1e-5):
    want = np.asarray(want, np.float32)
    atol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               rtol=rtol, atol=atol)


def _codes(seed, bits, mode, shape=(K, N)):
    rng = np.random.default_rng(seed)
    lo, hi = (-7, 8) if bits == 4 else (-127, 128)
    if mode == "codebook":
        lo, hi = (-8, 8) if bits == 4 else (-128, 128)
    return rng.integers(lo, hi, size=shape).astype(np.int8)


def _qpair(codes, scale, bits, mode, packed=False, granularity=None):
    """The same codes and scale as a JAX and a port QTensor."""
    gran = granularity or ("per_group" if scale.shape[0] > 1
                           else "per_channel")
    fields = dict(codebook=None, bits=bits, mode=mode, granularity=gran,
                  group_size=128, packed=packed, shape=codes.shape)
    jc = JQ.pack_int4(jnp.asarray(codes)) if packed else jnp.asarray(codes)
    tc = TQ.pack_int4(_t(codes)) if packed else _t(codes)
    return (JQ.QTensor(codes=jc, scale=jnp.asarray(scale), **fields),
            TQ.QTensor(codes=tc, scale=_t(scale), **fields))


# ---------------------------------------------------------------------------
# analytics: core/reuse.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits,mode", ALPHABETS)
def test_rc_alphabet_matches_jax(bits, mode):
    tl, tf = TR.rc_alphabet(bits, mode)
    jl, jf = JR.rc_alphabet(bits, mode)
    assert tf == jf and tl.dtype == np.float32
    np.testing.assert_array_equal(tl, np.asarray(jl))
    assert len(tl) == {(8, "affine"): 128, (4, "affine"): 8,
                       (8, "codebook"): 256, (4, "codebook"): 16}[bits, mode]


@pytest.mark.parametrize("bits,mode", ALPHABETS)
@pytest.mark.parametrize("seg", [None, 256, 32])
def test_segment_counts_and_rate_match_jax(bits, mode, seg):
    codes = _codes(bits * 7 + len(mode), bits, mode, (64, 512))
    fold = mode == "affine"
    np.testing.assert_array_equal(TR.fold_codes(codes, fold),
                                  JR.fold_codes(codes, fold))
    np.testing.assert_array_equal(
        TR.segment_unique_counts(codes, seg, fold),
        JR.segment_unique_counts(codes, seg, fold))
    assert TR.reuse_rate(codes, seg, fold) == JR.reuse_rate(codes, seg, fold)
    assert TR.per_matrix_report(codes, fold_sign=fold) == \
        JR.per_matrix_report(codes, fold_sign=fold)


def test_qtensor_counts_unpack_first_and_packed_bytes_raise():
    codes = _codes(3, 4, "affine")
    jq, tq = _qpair(codes, np.ones((1, N), np.float32), 4, "affine",
                    packed=True)
    assert TR.reuse_rate(tq) == JR.reuse_rate(jq) == JR.reuse_rate(codes)
    raw = tq.codes.numpy()                      # packed uint8 bytes
    assert raw.max() > 128
    with pytest.raises(ValueError, match="packed-int4"):
        TR.fold_codes(raw)
    with pytest.raises(ValueError, match="packed-int4"):
        TR.fold_codes(raw.astype(np.int32) + 200, fold_sign=False)


def test_expected_rates_and_lora_overlap_match_jax():
    for seg, cells, dist in ((256, 128, "gaussian"), (512, 128, "uniform"),
                             (64, 8, "gaussian")):
        assert TR.expected_unique(seg, cells, dist) == \
            JR.expected_unique(seg, cells, dist)
        assert TR.expected_reuse_rate(seg, cells, dist) == \
            JR.expected_reuse_rate(seg, cells, dist)
    w = _codes(5, 8, "affine", (64, 256))
    a = _codes(6, 8, "affine", (64, 8))
    assert TR.lora_row_overlap(w, a) == JR.lora_row_overlap(w, a)


@st.composite
def _code_cases(draw):
    bits, mode = draw(st.sampled_from(ALPHABETS))
    seed = draw(st.integers(0, 2 ** 16))
    return bits, mode, _codes(seed, bits, mode)


@given(_code_cases())
@settings(deadline=None, max_examples=12)
def test_mult_count_matches_jax_property(case):
    """The port's count (plain path and the CUDA wrapper's CPU path) equals
    the JAX kernel's count contract, ``reuse_matmul(with_stats=True)``."""
    bits, mode, codes = case
    jq, tq = _qpair(codes, np.ones((1, N), np.float32), bits, mode)
    x = np.ones((4, K), np.float32)
    _, jm = jops.reuse_matmul(jnp.asarray(x), jq, impl="reuse_ref",
                              with_stats=True)
    _, tm = ops.reuse_matmul(_t(x), tq, impl="reuse_ref", with_stats=True)
    _, cm = reuse_matmul_cuda(_t(x), tq, with_stats=True)
    levels, fold = TR.rc_alphabet(bits, mode)
    assert segment(N) == jops.pick_blocks(4, K, N,
                                          reuse_levels=len(levels))[2]
    assert tm == cm == int(jm) == ref.reuse_mult_count(tq, segment(N))


@pytest.mark.parametrize("n", [768, 256, 2048, 96, 12])
def test_segment_follows_jax_pick_blocks(n):
    for levels in (8, 16, 128, 256):
        assert segment(n) == jops.pick_blocks(8, 768, n,
                                              reuse_levels=levels)[2]


# ---------------------------------------------------------------------------
# reuse_matmul
# ---------------------------------------------------------------------------

def _int_x(seed, m=16):
    rng = np.random.default_rng(seed)
    return rng.integers(-8, 9, size=(m, K)).astype(np.float32)


DYADIC = [
    # (bits, packed, per_group)
    (8, False, False), (4, False, False), (4, True, False), (8, False, True)]


@pytest.mark.parametrize("bits,packed,per_group", DYADIC,
                         ids=["int8", "int4", "int4-packed", "int8-group"])
def test_reuse_dyadic_bit_exact(bits, packed, per_group):
    x = _int_x(bits + packed)
    codes = _codes(bits + 2 * per_group, bits, "affine")
    qmax = (1 << (bits - 1)) - 1
    rng = np.random.default_rng(9)
    exps = rng.integers(-4, 1, size=(K // 128 if per_group else 1, N))
    scale = (qmax * 2.0 ** exps).astype(np.float32)
    jq, tq = _qpair(codes, scale, bits, "affine", packed=packed)
    want = np.asarray(jref.reuse_matmul_ref(jnp.asarray(x), jq))
    xi = x.astype(np.int64)
    exact = np.zeros((x.shape[0], N), np.float64)
    for g in range(exps.shape[0]):
        rows = slice(g * K // exps.shape[0], (g + 1) * K // exps.shape[0])
        exact += (xi[:, rows] @ codes[rows].astype(np.int64)) \
            * (2.0 ** exps[g])[None, :]
    np.testing.assert_array_equal(want, exact.astype(np.float32))
    for got in (ops.reuse_matmul(_t(x), tq, impl="reuse_ref")[0],
                ops.axllm_matmul(_t(x), tq, impl="reuse"),
                reuse_matmul_cuda(_t(x), tq)[0]):
        np.testing.assert_array_equal(got.numpy(), want)


QCFGS = [(8, "affine", "per_channel"), (8, "affine", "per_group"),
         (8, "affine", "per_tensor"), (8, "codebook", "per_channel"),
         (4, "affine", "per_channel"), (4, "codebook", "per_channel")]


@pytest.mark.parametrize("m", [8, 37])
@pytest.mark.parametrize("bits,mode,gran", QCFGS,
                         ids=["-".join(map(str, c)) for c in QCFGS])
def test_reuse_float_matches_jax(m, bits, mode, gran):
    rng = np.random.default_rng(bits + m)
    x = rng.standard_normal((m, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    qc = dict(bits=bits, mode=mode, granularity=gran, group_size=64)
    jq = JQ.quantize(jnp.asarray(w), JQ.QuantConfig(**qc))
    tq = TQ.quantize(_t(w), TQ.QuantConfig(**qc))
    want = np.asarray(jref.reuse_matmul_ref(jnp.asarray(x), jq))
    _close(ops.reuse_matmul(_t(x), tq)[0], want)
    _close(reuse_matmul_cuda(_t(x), tq)[0], want)
    # same function as the multiply path, up to the association
    _close(ops.axllm_matmul(_t(x), tq, impl="reuse_ref"),
           np.asarray(jref.axllm_matmul_ref(jnp.asarray(x), jq)), rtol=1e-4)


@pytest.mark.parametrize("bits,mode", [(8, "affine"), (4, "codebook")])
def test_reuse_matches_jax_interpret_kernel(bits, mode):
    rng = np.random.default_rng(21)
    x = rng.standard_normal((2, 4, K)).astype(np.float32)
    w = rng.standard_normal((K, 256)).astype(np.float32)
    jq = JQ.quantize(jnp.asarray(w), JQ.QuantConfig(bits, mode))
    tq = TQ.quantize(_t(w), TQ.QuantConfig(bits, mode))
    want, jm = jops.reuse_matmul(jnp.asarray(x), jq, impl="reuse_interpret",
                                 with_stats=True)
    got, tm = ops.reuse_matmul(_t(x), tq, impl="reuse", with_stats=True)
    assert got.shape == (2, 4, 256)
    _close(got, np.asarray(want))
    assert tm == int(jm)


def test_reuse_dispatch():
    qt = TQ.quantize(torch.ones(64, 32), TQ.QuantConfig())
    x = torch.randn(3, 64)
    with pytest.raises(ValueError, match="interpret"):
        ops.reuse_matmul(x, qt, impl="reuse_interpret")
    y, mults = ops.reuse_matmul(x, qt, impl="reuse")
    assert mults is None and y.dtype == x.dtype
    assert ops._base_impl("reuse") == "auto"
    assert ops._base_impl("reuse_ref") == "ref"
    q = torch.randn(1, 8, 2, 32)
    for impl in ("reuse", "reuse_ref"):
        torch.testing.assert_close(ops.flash_attention(q, q, q, impl=impl),
                                   ops.flash_attention(q, q, q, impl="ref"))


# ---------------------------------------------------------------------------
# engine: impl="reuse" against the JAX engine
# ---------------------------------------------------------------------------

CFG_FIELDS = dict(name="s", family="dense", n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
                  head_dim=16, vocab_pad_multiple=64, dtype="float32")
MIXED = [np.arange(8), np.arange(12) + 3, np.arange(31) + 7,
         np.arange(12) + 40, np.arange(8) + 60, np.arange(31) + 90]
SHARED = [np.concatenate([np.arange(16) + 5, np.arange(4) + 100 + 7 * i])
          for i in range(4)]


@pytest.fixture(scope="module")
def weights():
    jcfg = JModelConfig(**CFG_FIELDS)
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    return (jcfg, jparams, ModelConfig(**CFG_FIELDS),
            params_from_numpy(jax_tree_to_numpy(jparams), "cpu"))


@pytest.mark.parametrize("bits,mode", [(8, "affine"), (4, "affine"),
                                       (4, "codebook")],
                         ids=["int8", "int4", "nf4"])
def test_reuse_engine_matches_jax(weights, bits, mode):
    jcfg, jparams, tcfg, tparams = weights
    kw = dict(n_slots=2, max_len=64, quantize=True, quant_bits=bits,
              quant_mode=mode, impl="reuse")
    want = JServeEngine(jcfg, jparams, **kw).generate(MIXED + SHARED,
                                                      max_new=6)
    got = ServeEngine(tcfg, tparams, device="cpu", **kw).generate(
        MIXED + SHARED, max_new=6)
    assert got == want
