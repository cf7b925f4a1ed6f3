"""Port parity for fused projections: ``qconcat`` and ``concat_weights``,
the fused quantized matmul against separate ones, ``fuse_params`` on the
model's forward, and a fused engine, against the JAX package on the same
numpy inputs and weights.

Tolerances: ``qconcat`` moves codes and scales without requantizing, so
dequantized weights are exactly equal. One fused matmul against separate
ones over the same columns sums each output in the same order on the
plain path; the bound stated is rtol 1e-5 with an atol of 1e-5 times the
output scale, which also covers another blocking of the float32 product
(the JAX package's own dense case compares at rtol 1e-6 and fails on the
reference). Fused forward logits against JAX's fused forward: rtol 1e-4
with an atol of 1e-4 times the logit scale, the model tests' bound (the
frameworks sum in other orders). Tokens must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.repro_100m import CONFIG as J_100M
from repro.core import axllm_linear as JAL
from repro.core import quantization as JQ
from repro.kernels import ops as jops
from repro.models.model import get_model as j_get_model
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.repro_100m import CONFIG as T_100M
from repro_torch.core import axllm_linear as AL
from repro_torch.core import quantization as TQ
from repro_torch.kernels import ops
from repro_torch.kernels.axllm_matmul import axllm_matmul_cuda
from repro_torch.kernels.reuse_matmul import reuse_matmul_cuda
from repro_torch.models.model import get_model
from repro_torch.serve.engine import ServeEngine
from test_torch_engine import jax_tree_to_numpy
from test_torch_reuse import CFG_FIELDS


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, rtol=1e-5):
    want = np.asarray(want, np.float32)
    atol = rtol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=atol)


def _pair(w, qcfg):
    """The same weight quantized by both packages."""
    return (JQ.quantize(jnp.asarray(w), JQ.QuantConfig(**qcfg)),
            TQ.quantize(torch.from_numpy(w), TQ.QuantConfig(**qcfg)))


# ---------------------------------------------------------------------------
# qconcat
# ---------------------------------------------------------------------------

QCFGS = [
    dict(bits=8, mode="affine", granularity="per_channel"),
    dict(bits=8, mode="affine", granularity="per_tensor"),
    dict(bits=8, mode="affine", granularity="per_group", group_size=64),
    dict(bits=8, mode="codebook", granularity="per_channel"),
    dict(bits=4, mode="affine", granularity="per_channel", pack=True),
    dict(bits=4, mode="codebook", granularity="per_channel", pack=True),
    dict(bits=4, mode="affine", granularity="per_channel", pack=False),
]


@pytest.mark.parametrize("qcfg", QCFGS, ids=lambda c: "-".join(
    str(c[k]) for k in ("bits", "mode", "granularity")) + (
        "-unpacked" if c.get("pack") is False else ""))
def test_qconcat_dequant_exact(qcfg):
    """dequantize(qconcat(a, b, c)) == concat(dequantize each), exactly,
    and equal to JAX's; the fused kernel scale is derived anew."""
    rng = np.random.default_rng(0)
    pairs = [_pair(_rand(rng, (128, n)), qcfg) for n in (64, 32, 32)]
    jf = JQ.qconcat([p[0] for p in pairs])
    tf = TQ.qconcat([p[1] for p in pairs])
    assert tf.shape == jf.shape == (128, 128)
    assert tf.granularity == jf.granularity
    want = torch.cat([TQ.dequantize(p[1]) for p in pairs], dim=-1)
    assert torch.equal(TQ.dequantize(tf), want)
    np.testing.assert_array_equal(TQ.dequantize(tf).numpy(),
                                  np.asarray(JQ.dequantize(jf)))
    assert torch.equal(tf.kernel_scale,
                       torch.cat([p[1].kernel_scale for p in pairs], dim=-1))


def test_qconcat_per_tensor_becomes_per_channel():
    rng = np.random.default_rng(1)
    qcfg = dict(bits=8, mode="affine", granularity="per_tensor")
    ja, ta = _pair(_rand(rng, (64, 32)), qcfg)
    jb, tb = _pair(_rand(rng, (64, 16)) * 5.0, qcfg)   # another scale
    tf = TQ.qconcat([ta, tb])
    assert tf.granularity == "per_channel"
    assert tuple(tf.scale.shape) == (1, 48)
    want = torch.cat([TQ.dequantize(ta), TQ.dequantize(tb)], dim=-1)
    assert torch.equal(TQ.dequantize(tf), want)
    np.testing.assert_array_equal(
        TQ.dequantize(tf).numpy(), np.asarray(JQ.dequantize(JQ.qconcat(
            [ja, jb]))))
    # each part's columns keep their own kernel scale (none carries over
    # from the first input)
    assert torch.equal(tf.kernel_scale,
                       torch.cat([ta.kernel_scale, tb.kernel_scale], -1))
    assert float(tf.kernel_scale[0, 40]) != float(ta.kernel_scale[0, 0])


def test_qconcat_stacked_leading_dims():
    rng = np.random.default_rng(2)
    qcfg = dict(bits=8, mode="affine", granularity="per_channel")
    ja, ta = _pair(_rand(rng, (3, 64, 32)), qcfg)
    jb, tb = _pair(_rand(rng, (3, 64, 16)), qcfg)
    tf = TQ.qconcat([ta, tb])
    assert tf.shape == (3, 64, 48)
    np.testing.assert_array_equal(
        TQ.dequantize(tf).numpy(),
        np.asarray(JQ.dequantize(JQ.qconcat([ja, jb]))))
    for i in range(3):       # per-layer slices keep their columns' scales
        assert torch.equal(TQ.dequantize(tf.index(i)),
                           torch.cat([TQ.dequantize(ta.index(i)),
                                      TQ.dequantize(tb.index(i))], -1))


def test_qconcat_rejects_mismatches():
    rng = np.random.default_rng(3)
    a8 = TQ.quantize(torch.from_numpy(_rand(rng, (64, 32))),
                     TQ.QuantConfig(8, "affine", "per_channel"))
    a4 = TQ.quantize(torch.from_numpy(_rand(rng, (64, 32))),
                     TQ.QuantConfig(4, "affine", "per_channel"))
    ag = TQ.quantize(torch.from_numpy(_rand(rng, (64, 32))),
                     TQ.QuantConfig(8, "affine", "per_group", group_size=32))
    ak = TQ.quantize(torch.from_numpy(_rand(rng, (128, 32))),
                     TQ.QuantConfig(8, "affine", "per_channel"))
    ag2 = TQ.quantize(torch.from_numpy(_rand(rng, (64, 32))),
                      TQ.QuantConfig(8, "affine", "per_group", group_size=16))
    with pytest.raises(ValueError, match="mismatch"):
        TQ.qconcat([a8, a4])
    with pytest.raises(ValueError, match="per_group"):
        TQ.qconcat([a8, ag])
    with pytest.raises(ValueError, match="group_size"):
        TQ.qconcat([ag, ag2])
    with pytest.raises(ValueError, match="K/leading"):
        TQ.qconcat([a8, ak])
    with pytest.raises(ValueError, match="at least two"):
        TQ.qconcat([a8])
    odd = TQ.quantize(torch.from_numpy(_rand(rng, (64, 3))),
                      TQ.QuantConfig(4, "affine", "per_channel", pack=False))
    packed = dataclasses.replace(odd, packed=True)
    with pytest.raises(ValueError, match="even"):
        TQ.qconcat([packed, packed])
    with pytest.raises(TypeError, match="quantize first"):
        AL.concat_weights([a8, torch.from_numpy(_rand(rng, (64, 32)))])


def test_concat_weights_mixed_and_dense():
    rng = np.random.default_rng(4)
    da, db = (torch.from_numpy(_rand(rng, s)) for s in ((64, 32), (64, 16)))
    qt = TQ.quantize(da, TQ.QuantConfig(8, "affine", "per_channel"))
    for mix in ([qt, db], [db, qt], [da, qt, db]):
        with pytest.raises(TypeError, match="mix of QTensor and dense"):
            AL.concat_weights(mix)
    fused = AL.concat_weights([da, db])
    np.testing.assert_array_equal(fused.numpy(), np.asarray(
        JAL.concat_weights([jnp.asarray(da.numpy()),
                            jnp.asarray(db.numpy())])))


# ---------------------------------------------------------------------------
# fused matmul: one [K, N1+N2+N3] product == three separate products
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["ref", "reuse_ref", "cuda-wrapper"])
@pytest.mark.parametrize("qcfg", [
    dict(bits=8, mode="affine", granularity="per_channel"),
    dict(bits=4, mode="affine", granularity="per_channel", pack=True)],
    ids=["int8", "int4-packed"])
def test_fused_matmul_matches_separate(impl, qcfg):
    rng = np.random.default_rng(4)
    k = 256
    x = _rand(rng, (8, k))
    pairs = [_pair(_rand(rng, (k, n)), qcfg) for n in (128, 64, 64)]
    fused = TQ.qconcat([p[1] for p in pairs])
    tx = torch.from_numpy(x)
    if impl == "cuda-wrapper":      # the wrappers' CPU path
        mm = [lambda w: axllm_matmul_cuda(tx, w),
              lambda w: reuse_matmul_cuda(tx, w)[0]]
    else:
        mm = [lambda w: ops.axllm_matmul(tx, w, impl=impl)]
    for f in mm:
        _close(f(fused), torch.cat([f(p[1]) for p in pairs], dim=-1))
    jfused = JQ.qconcat([p[0] for p in pairs])
    jimpl = "reuse_ref" if impl == "reuse_ref" else "ref"
    _close(mm[0](fused), jops.axllm_matmul(jnp.asarray(x), jfused,
                                           impl=jimpl))


def test_fused_dense_matmul_matches_separate():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(_rand(rng, (8, 64)))
    ws = [torch.from_numpy(_rand(rng, (64, n))) for n in (32, 16, 16)]
    _close(AL.linear(x, AL.concat_weights(ws)),
           torch.cat([AL.linear(x, w) for w in ws], dim=-1))


# ---------------------------------------------------------------------------
# model: fuse_params keeps the forward, and matches JAX's fused forward
# ---------------------------------------------------------------------------

def _weights(fields, quantized):
    jcfg = JModelConfig(**fields)
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    if fields.get("qkv_bias"):     # non-zero biases, so the test has teeth
        attn = jparams["layers"]["attn"]
        for name in ("wq_bias", "wk_bias", "wv_bias"):
            attn[name] = attn[name] + 0.1
    if quantized:
        jparams = JAL.deploy_quantize(jparams, JQ.QuantConfig(
            bits=8, mode="affine", granularity="per_channel"))
    tparams = params_from_numpy(jax_tree_to_numpy(jparams), "cpu")
    return jcfg, jparams, ModelConfig(**fields), tparams


@pytest.mark.parametrize("extra", [{}, dict(qkv_bias=True, qk_norm=True)],
                         ids=["plain", "qkv_bias-qk_norm"])
@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_fuse_params_forward_matches_jax(quantized, extra):
    fields = dict(CFG_FIELDS, **extra)
    jcfg, jparams, tcfg, tparams = _weights(fields, quantized)
    japi, tapi = j_get_model(jcfg), get_model(tcfg)
    jfused, tfused = japi.fuse_params(jparams), tapi.fuse_params(tparams)
    attn = tfused["layers"]["attn"]
    assert "wqkv" in attn and "wq" not in attn
    assert ("wqkv_bias" in attn) == bool(extra)
    assert "gate_up" in tfused["layers"]["ffn"]
    if quantized:
        np.testing.assert_array_equal(
            TQ.dequantize(attn["wqkv"]).numpy(),
            np.asarray(JQ.dequantize(jfused["layers"]["attn"]["wqkv"])))
    tokens = np.random.default_rng(7).integers(0, 256, (2, 8)).astype(
        np.int32)
    want = np.asarray(japi.forward(jfused, {"tokens": jnp.asarray(tokens)}))
    got = tapi.forward(tfused, {"tokens": torch.from_numpy(tokens)})
    _close(got, want, rtol=1e-4)
    unfused = tapi.forward(tparams, {"tokens": torch.from_numpy(tokens)})
    _close(got, unfused, rtol=1e-4)


def test_fuse_params_is_idempotent_and_keeps_gelu():
    tcfg = ModelConfig(**dict(CFG_FIELDS, act="gelu"))
    api = get_model(tcfg)
    params = api.init(seed=0, device="cpu")
    fused = api.fuse_params(params)
    assert "gate_up" not in fused["layers"]["ffn"]
    assert fused["layers"]["ffn"] is params["layers"]["ffn"]
    assert api.fuse_params(fused)["layers"]["attn"] is \
        fused["layers"]["attn"]


# ---------------------------------------------------------------------------
# engine: a fused engine serves the JAX fused engine's tokens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["auto", "reuse"])
def test_fused_engine_matches_jax(impl):
    overrides = dict(dtype="float32", remat=False)
    jcfg, tcfg = J_100M.reduced(**overrides), T_100M.reduced(**overrides)
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax_tree_to_numpy(jparams), "cpu")
    prompts = [np.arange(8), np.arange(12) + 3, np.arange(31) + 7]
    kw = dict(n_slots=2, max_len=64, quantize=True, decode_chunk=8,
              fuse_qkv=True, impl=impl)
    want = JServeEngine(jcfg, jparams, **kw).generate(prompts, max_new=6)
    eng = ServeEngine(tcfg, tparams, device="cpu", **kw)
    assert "wqkv" in eng.params["layers"]["attn"]
    assert eng.generate(prompts, max_new=6) == want
    unfused = ServeEngine(tcfg, tparams, device="cpu",
                          **dict(kw, fuse_qkv=False, decode_chunk=1))
    assert unfused.generate(prompts, max_new=6) == want
