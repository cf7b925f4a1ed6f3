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
