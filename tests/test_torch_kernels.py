"""Port parity: the plain versions of the three slice-1 kernels
(``repro_torch.kernels.ref``, reached through ``ops`` and through each
CUDA wrapper's CPU path) against the JAX package's oracles and against
its Pallas kernels run in interpret mode, on the same numpy inputs.

Tolerances: float32 sums in another order than XLA's agree to about
1e-6 relative; the bound used is rtol 1e-5 with an atol of 1e-5 times the
output scale. In the dyadic regime (integer activations, dyadic scales)
every product and partial sum is exact in float32, so results must be
bit-identical to each other and to the int64 product.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as JQ
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import quantization as TQ
from repro_torch.kernels import ops, ref
from repro_torch.kernels.axllm_matmul import axllm_matmul_cuda
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda

RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float32)
    atol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               rtol=rtol, atol=atol)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _qpair(w, bits, mode, gran, group_size=128):
    qj = JQ.quantize(jnp.asarray(w), JQ.QuantConfig(bits, mode, gran,
                                                     group_size=group_size))
    qt = TQ.quantize(_t(w), TQ.QuantConfig(bits, mode, gran,
                                           group_size=group_size))
    return qj, qt


# ---------------------------------------------------------------------------
# axllm_matmul
# ---------------------------------------------------------------------------

QMODES = [(8, "affine", "per_channel"), (8, "affine", "per_group"),
          (8, "affine", "per_tensor"), (8, "codebook", "per_channel"),
          (4, "affine", "per_channel"), (4, "codebook", "per_channel")]


@pytest.mark.parametrize("m", [8, 37], ids=["skinny8", "ragged37"])
@pytest.mark.parametrize("bits,mode,gran", QMODES,
                         ids=["-".join(map(str, c)) for c in QMODES])
def test_axllm_matmul_plain_matches_jax(m, bits, mode, gran):
    rng = np.random.default_rng(bits + m)
    x = rng.standard_normal((m, 256)).astype(np.float32)
    w = rng.standard_normal((256, 128)).astype(np.float32)
    qj, qt = _qpair(w, bits, mode, gran, group_size=64)
    want = np.asarray(jref.axllm_matmul_ref(jnp.asarray(x), qj))
    _close(ops.axllm_matmul(_t(x), qt, impl="ref"), want)
    _close(ops.axllm_matmul(_t(x), qt), want)            # auto on CPU
    _close(axllm_matmul_cuda(_t(x), qt), want)           # wrapper, CPU path


@pytest.mark.parametrize("bits,mode", [(8, "affine"), (4, "codebook")])
def test_axllm_matmul_plain_matches_pallas_interpret(bits, mode):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 4, 512)).astype(np.float32)
    w = rng.standard_normal((512, 256)).astype(np.float32)
    qj, qt = _qpair(w, bits, mode, "per_channel")
    want = np.asarray(jops.axllm_matmul(jnp.asarray(x), qj,
                                        impl="pallas_interpret"))
    got = ops.axllm_matmul(_t(x), qt, impl="ref")
    assert got.shape == (2, 4, 256)
    _close(got, want)


def test_kernel_scale_folds_qmax_like_jax():
    rng = np.random.default_rng(12)
    w = rng.standard_normal((256, 64)).astype(np.float32)
    for gran in ("per_channel", "per_tensor", "per_group"):
        qj, qt = _qpair(w, 8, "affine", gran, group_size=64)
        np.testing.assert_array_equal(qt.kernel_scale.numpy(),
                                      np.asarray(jops._kernel_scale(qj)))


def _dyadic(seed, bits, mode, packed):
    rng = np.random.default_rng(seed)
    qmax = (1 << (bits - 1)) - 1
    x = rng.integers(-8, 9, size=(16, 256)).astype(np.float32)
    codes = rng.integers(-qmax, qmax + 1, size=(256, 64)).astype(np.int8)
    scale = np.full((1, 64), qmax * 2.0 ** -3, np.float32)
    if mode == "codebook":
        scale = (2.0 ** rng.integers(-4, 3, size=(1, 64))).astype(np.float32)
    fields = dict(codebook=None, bits=bits, mode=mode,
                  granularity="per_channel", group_size=128, packed=packed,
                  shape=codes.shape)
    jc = JQ.pack_int4(jnp.asarray(codes)) if packed else jnp.asarray(codes)
    tc = TQ.pack_int4(_t(codes)) if packed else _t(codes)
    qj = JQ.QTensor(codes=jc, scale=jnp.asarray(scale), **fields)
    qt = TQ.QTensor(codes=tc, scale=_t(scale), **fields)
    return x, codes, qj, qt


@pytest.mark.parametrize("bits,mode,packed", [
    (8, "affine", False), (4, "affine", True), (8, "codebook", False),
    (4, "codebook", True)])
def test_axllm_matmul_dyadic_bit_exact(bits, mode, packed):
    x, codes, qj, qt = _dyadic(bits * 3 + packed, bits, mode, packed)
    got = ops.axllm_matmul(_t(x), qt, impl="ref").numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jops.axllm_matmul(jnp.asarray(x), qj, impl="ref")))
    if mode == "affine":
        exact = ((x.astype(np.int64) @ codes.astype(np.int64))
                 * 2.0 ** -3).astype(np.float32)
        np.testing.assert_array_equal(got, exact)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

ATTN_CASES = [
    # (B, Sq, Sk, H, Hk, d, causal)
    (2, 64, 64, 4, 2, 32, True),        # GQA, the prefill shape
    (2, 64, 64, 4, 4, 32, False),
    (1, 32, 96, 4, 2, 32, True),        # Sq < Sk: queries at the end
    (1, 32, 96, 4, 1, 32, False),
]


def _attn_inputs(case, seed=5):
    b, sq, sk, h, hk, d, _ = case
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, hk, d)).astype(np.float32),
            rng.standard_normal((b, sk, hk, d)).astype(np.float32))


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_flash_attention_plain_matches_jax(case):
    causal = case[-1]
    q, k, v = _attn_inputs(case)
    want = np.asarray(jref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=causal))
    _close(ops.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                               impl="ref"), want)
    _close(flash_attention_cuda(_t(q), _t(k), _t(v), causal), want)
    _close(ref.chunked_attention_ref(_t(q), _t(k), _t(v), causal=causal,
                                     chunk=32), want)


@pytest.mark.parametrize("case", ATTN_CASES[:3], ids=str)
def test_flash_attention_plain_matches_pallas_interpret(case):
    causal = case[-1]
    q, k, v = _attn_inputs(case, seed=6)
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        impl="pallas_interpret"))
    _close(ops.flash_attention(_t(q), _t(k), _t(v), causal=causal), want)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

def _decode_inputs(quant, seed=9, b=4, s=64, h=4, hk=2, d=32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    # lengths: empty row, partial rows, and a row past the cache end
    length = np.array([0, 5, s, s + 9], np.int32)[:b]
    if quant:
        kc = rng.integers(-127, 128, (b, s, hk, d)).astype(np.int8)
        vc = rng.integers(-127, 128, (b, s, hk, d)).astype(np.int8)
        ks = (rng.random((b, s, hk, 1)) * 0.02).astype(np.float32)
        vs = (rng.random((b, s, hk, 1)) * 0.02).astype(np.float32)
        return q, kc, vc, length, ks, vs
    kc = rng.standard_normal((b, s, hk, d)).astype(np.float32)
    vc = rng.standard_normal((b, s, hk, d)).astype(np.float32)
    return q, kc, vc, length, None, None


def _opt(a, conv):
    return None if a is None else conv(a)


@pytest.mark.parametrize("quant", [False, True], ids=["f32kv", "int8kv"])
def test_decode_attention_plain_matches_jax(quant):
    q, kc, vc, length, ks, vs = _decode_inputs(quant)
    want = np.asarray(jref.decode_attention_ref(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(length), _opt(ks, jnp.asarray), _opt(vs, jnp.asarray)))
    args = (_t(q), _t(kc), _t(vc), _t(length))
    kw = dict(k_scale=_opt(ks, _t), v_scale=_opt(vs, _t))
    got = ops.decode_attention(*args, impl="ref", **kw)
    _close(got, want)
    _close(decode_attention_cuda(*args, **kw), want)
    assert torch.count_nonzero(got[0]) == 0          # length 0 -> exactly 0


@pytest.mark.parametrize("quant", [False, True], ids=["f32kv", "int8kv"])
def test_decode_attention_plain_matches_pallas_interpret(quant):
    q, kc, vc, length, ks, vs = _decode_inputs(quant, seed=10)
    want = np.asarray(jops.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(length), k_scale=_opt(ks, jnp.asarray),
        v_scale=_opt(vs, jnp.asarray), impl="pallas_interpret"))
    got = ops.decode_attention(_t(q), _t(kc), _t(vc), _t(length),
                               k_scale=_opt(ks, _t), v_scale=_opt(vs, _t))
    _close(got, want)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def test_cuda_impl_on_cpu_tensor_raises():
    x = torch.zeros(2, 64)
    qt = TQ.quantize(torch.ones(64, 32), TQ.QuantConfig())
    with pytest.raises(ValueError, match="card"):
        ops.axllm_matmul(x, qt, impl="cuda")
    q = torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError, match="card"):
        ops.flash_attention(q, q, q, impl="cuda")
    with pytest.raises(ValueError, match="card"):
        ops.decode_attention(q[:, 0], q, q, torch.ones(1, dtype=torch.int32),
                             impl="cuda")


@pytest.mark.parametrize("impl", ["reuse", "reuse_interpret", "reuse_ref"])
def test_reuse_impls_not_ported(impl):
    """The reuse impls are ported now (tests/test_torch_reuse.py); the
    JAX package's interpret impl has no counterpart and is refused."""
    x = torch.randn(2, 64)
    qt = TQ.quantize(torch.randn(64, 32), TQ.QuantConfig())
    if impl == "reuse_interpret":
        with pytest.raises(ValueError, match="interpret"):
            ops.axllm_matmul(x, qt, impl=impl)
        return
    torch.testing.assert_close(ops.axllm_matmul(x, qt, impl=impl),
                               ref.reuse_matmul_ref(x, qt))


def test_unported_ops_raise_not_implemented():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.quantize_channels(torch.zeros(8, 8))
    q = torch.zeros(1, 4, 2, 32)
    with pytest.raises(NotImplementedError, match="no CUDA kernel"):
        ops.prefix_attention(q, q, q, torch.ones(1, dtype=torch.int32), q, q,
                             impl="cuda")
