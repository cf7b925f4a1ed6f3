"""Port parity for per-channel quantization: the port's plain version
(``ref.quantize_ref``, reached through ``ops.quantize_channels`` and
through the CUDA wrapper's CPU path) against the JAX package's
``ops.quantize_channels`` with its plain version and with the Pallas
kernel in interpret mode, on the same numpy inputs.

Codes and scales must be exactly equal to JAX's plain version: both take
the column maximum, divide in IEEE float32 and round half to even. The
JAX Pallas kernel is not bit-equal to JAX's own plain version: under
``jax.jit`` XLA turns its division by the constant qmax into a multiply
by ``float32(1 / qmax)``, which differs by one unit in the last place in
6% (qmax 127) to 60% (qmax 7) of columns (the JAX package's own test
compares those scales at rtol 1e-6), and on bfloat16 inputs, whose
quotients often land on a half, that flips some codes. So against interpret mode the scale is held
exactly to that product and to the port's within one unit in the last
place, the codes exactly to the port's in every column where the two
scales agree, and the kernel's codes exactly to the port's rounding of
``w / scale`` with the kernel's own scale.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref
from repro_torch.kernels.quantize import quantize_cuda

SHAPES = [(512, 512), (1024, 256), (128, 1024)]


def _weights(shape, dtype, seed=9):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        w = w.astype(ml_dtypes.bfloat16).astype(np.float32)
        return (jnp.asarray(w, jnp.bfloat16),
                torch.from_numpy(w).to(torch.bfloat16))
    return jnp.asarray(w), torch.from_numpy(w)


@pytest.mark.parametrize("jimpl", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_quantize_matches_jax(shape, bits, dtype, jimpl):
    jw, tw = _weights(shape, dtype)
    jc, js = jops.quantize_channels(jw, bits=bits, impl=jimpl)
    jc, js = np.asarray(jc), np.asarray(js)
    tc, ts = ops.quantize_channels(tw, bits=bits)
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == (1, shape[1])
    qmax = (1 << (bits - 1)) - 1
    assert int(tc.abs().max()) == qmax
    if jimpl == "ref":
        np.testing.assert_array_equal(tc.numpy(), jc)
        np.testing.assert_array_equal(ts.numpy(), js)
        return
    wf = tw.to(torch.float32)
    absmax = wf.abs().amax(-2, keepdim=True).numpy()
    np.testing.assert_array_equal(
        js, np.maximum(absmax, np.float32(1e-8)) * np.float32(1 / qmax))
    np.testing.assert_array_max_ulp(ts.numpy(), js, maxulp=1)
    same = (ts.numpy() == js)[0]
    np.testing.assert_array_equal(tc.numpy()[:, same], jc[:, same])
    rounded = torch.clamp(torch.round(wf / torch.from_numpy(js.copy())),
                          -qmax, qmax)
    np.testing.assert_array_equal(rounded.to(torch.int8).numpy(), jc)


def test_round_half_to_even():
    """A column with absmax 127 has scale exactly 1.0: 2.5, 3.5 and -0.5
    round to 2, 4 and 0 (half to even), as in JAX."""
    w = np.zeros((8, 4), np.float32)
    w[:4, 1] = [127.0, 2.5, 3.5, -0.5]
    w[:, 0] = np.linspace(-1.0, 1.0, 8)
    tc, ts = ops.quantize_channels(torch.from_numpy(w))
    assert float(ts[0, 1]) == 1.0
    assert tc[:4, 1].tolist() == [127, 2, 4, 0]
    for jimpl in ("ref", "pallas_interpret"):
        jc, _ = jops.quantize_channels(jnp.asarray(w), impl=jimpl)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    _, js = jops.quantize_channels(jnp.asarray(w), impl="ref")
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # an all-zero column takes the 1e-8 floor and codes 0
    assert float(ts[0, 3]) == np.float32(1e-8) / np.float32(127)
    assert not tc[:, 3].any()


def test_leading_dims_and_cpu_wrapper():
    """A stacked [L, K, N] leaf quantizes per matrix; the CUDA wrapper
    takes the plain version for a CPU tensor."""
    _, tw = _weights((3, 256, 96), "float32", seed=3)
    codes, scale = quantize_cuda(tw, 8)
    assert codes.shape == (3, 256, 96) and scale.shape == (3, 1, 96)
    for i in range(3):
        ci, si = ref.quantize_ref(tw[i])
        assert torch.equal(codes[i], ci) and torch.equal(scale[i], si)
        jc, js = jops.quantize_channels(jnp.asarray(tw[i].numpy()),
                                        impl="ref")
        np.testing.assert_array_equal(codes[i].numpy(), np.asarray(jc))
        np.testing.assert_array_equal(scale[i].numpy(), np.asarray(js))


def test_dispatch():
    w = torch.randn(16, 8)
    with pytest.raises(ValueError, match="card"):
        ops.quantize_channels(w, impl="cuda")
    with pytest.raises(ValueError, match="interpret"):
        ops.quantize_channels(w, impl="pallas_interpret")
    for bits in (1, 9):
        with pytest.raises(ValueError, match="bits"):
            ops.quantize_channels(w, bits=bits)
    c, s = ops.quantize_channels(w, impl="reuse")
    assert torch.equal(c, ref.quantize_ref(w)[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nan_inf_zero_columns_match_jax(dtype):
    """A NaN anywhere in a column gives a NaN scale and codes 0, an inf (or
    -inf) an inf scale and codes 0 (finite / inf is 0, inf / inf is NaN),
    a column of zeros the 1e-8 floor and codes 0: the port's plain version
    and JAX's oracle alike (the card tests hold the kernel to the former)."""
    w = np.random.default_rng(4).standard_normal((64, 8)).astype(np.float32)
    w[5, 0] = np.nan
    w[0, 1] = np.inf
    w[7, 2] = -np.inf
    w[3, 5] = np.nan
    w[9, 5] = np.inf
    w[:, 4] = 0.0
    if dtype == "bfloat16":
        w = w.astype(ml_dtypes.bfloat16).astype(np.float32)
        jw, tw = jnp.asarray(w, jnp.bfloat16), torch.from_numpy(w).to(
            torch.bfloat16)
    else:
        jw, tw = jnp.asarray(w), torch.from_numpy(w)
    for bits in (8, 4):
        tc, ts = ops.quantize_channels(tw, bits=bits)
        jc, js = jops.quantize_channels(jw, bits=bits, impl="ref")
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        assert np.isnan(ts[0, [0, 5]].numpy()).all()
        assert np.isposinf(ts[0, [1, 2]].numpy()).all()
        assert float(ts[0, 4]) == np.float32(1e-8) / np.float32(
            (1 << (bits - 1)) - 1)
        assert not tc[:, [0, 1, 2, 4, 5]].any()
        assert tc[:, [3, 6, 7]].abs().max() == (1 << (bits - 1)) - 1


def _all_bf16() -> torch.Tensor:
    """Every finite bfloat16 value, as float32."""
    bits = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16)
    v = bits.view(torch.bfloat16).to(torch.float32)
    return v[torch.isfinite(v)]


@pytest.mark.parametrize("bits", [8, 7, 4, 3, 2])
def test_rcp_rounding_equals_division_on_every_bf16(bits):
    """The kernel's codes (``ref.quantize_rcp_ref``: a product by the
    reciprocal where it decides the rounding, the division elsewhere) equal
    the division's for every finite bfloat16 weight under column maxima
    that make many quotients land on halves (a power of two times qmax),
    on thirds and sevenths, at the 1e-8 floor and near the float32 top."""
    x = _all_bf16()
    qmax = (1 << (bits - 1)) - 1
    maxima = [qmax * 2.0 ** e for e in (-7, 0, 3)] + [
        0.0, 3e-9, 1e-8, 7 * 2.0 ** -9, 3 * 2.0 ** -5, 1.0, 0.7, 6.5e4,
        3e38]
    maxima += list(np.random.default_rng(bits).standard_normal(8) * 0.05)
    cols = []
    for a in maxima:
        a = float(torch.tensor(abs(a)).to(torch.bfloat16))
        cols.append(torch.cat([torch.tensor([a]),
                               torch.where(x.abs() <= a, x, 0.0)]))
    w = torch.stack(cols, 1)
    codes, scale = ref.quantize_ref(w, bits)
    got, decided = ref.quantize_rcp_ref(w, scale, bits)
    assert torch.equal(got, codes)
    assert bool(decided.float().mean() > 0.9)   # the division is rare
    assert not bool(decided.all())              # and it is taken


def test_rcp_rounding_equals_division_near_halves():
    """float32 weights placed on and one or two ulps either side of
    (k + 1/2) s for every k: the kernel's rounding (product where decided,
    division elsewhere) still equals the division's."""
    rng = np.random.default_rng(8)
    for bits in (8, 4, 2):
        qmax = (1 << (bits - 1)) - 1
        for a in rng.uniform(1e-3, 10.0, 6).astype(np.float32):
            s = np.float32(a) / np.float32(qmax)
            ks = np.arange(-qmax, qmax, dtype=np.float32) + np.float32(0.5)
            base = (ks * s).astype(np.float32)
            vals = [base]
            for step in (1, 2):
                vals.append(np.nextafter(base, np.float32(np.inf)))
                vals.append(np.nextafter(base, np.float32(-np.inf)))
                base = vals[-2]
            col = np.concatenate([[a]] + vals).astype(np.float32)
            col = np.clip(col, -a, a)
            w = torch.from_numpy(col[:, None].copy())
            codes, scale = ref.quantize_ref(w, bits)
            got, decided = ref.quantize_rcp_ref(w, scale, bits)
            assert torch.equal(got, codes)
            assert not bool(decided.all())
