"""Port parity: repro_torch.core.quantization against the JAX package.

The same weights, made with numpy from a seed, go through both
``quantize`` functions. Codes must agree byte for byte and scales exactly
(both frameworks round half to even and divide in f32); dequantized
weights exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as JQ
from repro_torch.core import quantization as TQ
from repro_torch.core.axllm_linear import deploy_quantize

GRANS = ("per_channel", "per_tensor", "per_group")
# (bits, mode, granularity, pack): int8 codes are never packed
CASES = [(8, mode, g, True) for mode in ("affine", "codebook") for g in GRANS] \
    + [(4, mode, g, pack) for mode in ("affine", "codebook") for g in GRANS
       for pack in (True, False)]


def _weights(seed, shape):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    # exact ties at +-0.5 code steps exercise round-half-to-even
    w.flat[:4] = [0.5 / 127, -1.5 / 127, 2.5 / 127, 0.0]
    return w


@pytest.mark.parametrize("bits,mode,gran,pack", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
@pytest.mark.parametrize("shape", [(64, 48), (2, 64, 48)],
                         ids=["2d", "stacked"])
def test_quantize_matches_jax(bits, mode, gran, pack, shape):
    w = _weights(bits * 7 + len(shape), shape)
    cj = JQ.QuantConfig(bits, mode, gran, group_size=16, pack=pack)
    ct = TQ.QuantConfig(bits, mode, gran, group_size=16, pack=pack)
    qj = JQ.quantize(jnp.asarray(w), cj)
    qt = TQ.quantize(torch.from_numpy(w), ct)
    assert qt.packed == qj.packed and qt.shape == tuple(qj.shape)
    codes_j = np.asarray(qj.codes)
    assert qt.codes.numpy().dtype == codes_j.dtype
    np.testing.assert_array_equal(qt.codes.numpy(), codes_j)
    np.testing.assert_array_equal(qt.scale.numpy(), np.asarray(qj.scale))
    np.testing.assert_array_equal(TQ.decode_codes(qt).numpy(),
                                  np.asarray(JQ.decode_codes(qj)))
    np.testing.assert_array_equal(TQ.dequantize(qt).numpy(),
                                  np.asarray(JQ.dequantize(qj)))


def test_codebooks_match_jax():
    np.testing.assert_array_equal(TQ.nf4_codebook().numpy(),
                                  np.asarray(JQ.nf4_codebook()))
    for bits in (4, 8):
        np.testing.assert_array_equal(TQ.identity_codebook(bits).numpy(),
                                      np.asarray(JQ.identity_codebook(bits)))


def test_pack_unpack_int4_low_nibble_first():
    codes = np.arange(-8, 8, dtype=np.int8).reshape(2, 8)
    packed = TQ.pack_int4(torch.from_numpy(codes))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(JQ.pack_int4(jnp.asarray(codes))))
    assert packed[0, 0].item() == (0x8 | (0x9 << 4))   # -8 low, -7 high
    np.testing.assert_array_equal(TQ.unpack_int4(packed, 8).numpy(), codes)


def test_quantize_tree_keeps_embedding_and_norms_dense():
    rng = np.random.default_rng(0)
    tree = {"embed": {"embedding": rng.standard_normal((32, 16))},
            "layers": {"ln1": {"scale": np.ones((2, 16))},
                       "attn": {"wq": rng.standard_normal((2, 16, 16)),
                                "wq_bias": rng.standard_normal((2, 16))},
                       "ffn": {"down": rng.standard_normal((2, 32, 16))}}}
    t_tree = {"embed": {"embedding": torch.tensor(tree["embed"]["embedding"])},
              "layers": {k: {n: torch.tensor(a) for n, a in v.items()}
                         for k, v in tree["layers"].items()}}
    q = deploy_quantize(t_tree, TQ.QuantConfig())
    assert isinstance(q["layers"]["attn"]["wq"], TQ.QTensor)
    assert isinstance(q["layers"]["ffn"]["down"], TQ.QTensor)
    assert q["layers"]["attn"]["wq"].scale.shape == (2, 1, 16)
    for dense in (q["embed"]["embedding"], q["layers"]["ln1"]["scale"],
                  q["layers"]["attn"]["wq_bias"]):
        assert isinstance(dense, torch.Tensor)


def test_quant_config_rejects_unknown_values():
    with pytest.raises(ValueError):
        TQ.QuantConfig(bits=3)
    with pytest.raises(ValueError):
        TQ.QuantConfig(mode="lut")
    with pytest.raises(ValueError):
        TQ.QuantConfig(granularity="per_row")


@pytest.mark.parametrize("gran", GRANS)
@pytest.mark.parametrize("mode", ["affine", "codebook"])
def test_kernel_scale_made_once_and_sliced_per_layer(gran, mode):
    """A stacked QTensor folds its scale once; each layer's view is a slice
    of it (no recomputation per forward) and equals the JAX kernels'
    folded scale of that layer quantized alone."""
    from repro.kernels import ops as jops
    w = _weights(7, (3, 64, 48))
    cfg = TQ.QuantConfig(8, mode, gran, group_size=16)
    qt = TQ.quantize(torch.from_numpy(w), cfg)
    g = 64 // 16 if gran == "per_group" else 1
    assert qt.kernel_scale.shape == (3, g, 48)
    assert qt.kernel_scale.dtype == torch.float32
    for i in range(3):
        layer = qt.index(i)
        assert layer.kernel_scale.data_ptr() == qt.kernel_scale[i].data_ptr()
        assert layer.kernel_scale.is_contiguous()
        qj = JQ.quantize(jnp.asarray(w[i]), JQ.QuantConfig(
            bits=8, mode=mode, granularity=gran, group_size=16))
        np.testing.assert_array_equal(layer.kernel_scale.numpy(),
                                      np.asarray(jops._kernel_scale(qj)))


@pytest.mark.parametrize("bits,mode", [(8, "affine"), (4, "codebook")])
def test_tree_reuse_surface_matches_jax(bits, mode):
    """``tests/test_quantization.py``'s predicate tree (a stacked layer,
    a router, a conv, norms and an embedding that stay dense): both
    packages quantize the same leaves and count the same surface."""
    tree = {"layers": {"ln1": {"scale": np.ones((4,), np.float32)},
                       "attn": {"wq": np.ones((4, 4), np.float32),
                                "wq_bias": np.zeros((4,), np.float32)},
                       "ffn": {"gate": np.ones((2, 4, 8), np.float32),
                               "conv_w": np.ones((4, 4), np.float32)},
                       "router": np.ones((4, 2), np.float32)},
            "embed": {"embedding": np.ones((10, 4), np.float32)}}

    def walk(fn, t):
        return {k: walk(fn, v) for k, v in t.items()} if isinstance(t, dict) \
            else fn(t)

    cfg = dict(bits=bits, mode=mode)
    jq = JQ.quantize_tree(walk(jnp.asarray, tree), JQ.QuantConfig(**cfg))
    tq = TQ.quantize_tree(walk(torch.from_numpy, tree), TQ.QuantConfig(**cfg))
    assert TQ.tree_reuse_surface(tq) == JQ.tree_reuse_surface(jq) \
        == 4 * 4 + 2 * 4 * 8
    assert TQ.tree_reuse_surface(walk(torch.from_numpy, tree)) == 0
    assert TQ.tree_reuse_surface((tq, [tq])) == 2 * (4 * 4 + 2 * 4 * 8)
