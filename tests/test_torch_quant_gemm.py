"""The tensor-core path of the two quantized matmuls
(``csrc/quant_gemm_sm90.cuh``) on the CPU: its arithmetic, emulated step
by step in plain PyTorch (``ref.quant_gemm_ref``: bf16 x times the codes
cast to bf16, f32 sums per 64-row K tile, each group's sum scaled at its
boundary), against the JAX package on the same numpy inputs; the choice,
made before a launch, of which calls take that path; and what the
wrappers and the build do around it.

Tolerances: with bf16-valued activations every product is exact in f32,
so the emulation differs from JAX's reuse kernel (interpret mode) and
multiply-path oracle only in the order of f32 additions and in where the
scale is applied: within 1e-5 of the output scale. In the dyadic regime
(integer activations, dyadic scales) every sum is exact in f32, so all
three must equal the int64 product bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as JQ
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import quantization as TQ
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.axllm_matmul import (TC_MIN_M, axllm_matmul_cuda,
                                              tensor_core_path)
from repro_torch.kernels.reuse_matmul import reuse_matmul_cuda

K, N = 256, 128
AFFINE = [
    dict(bits=8),
    dict(bits=4, pack=True),
    dict(bits=4, pack=False),
    dict(bits=8, granularity="per_group", group_size=64),
    dict(bits=8, granularity="per_group", group_size=128),
    dict(bits=4, granularity="per_group", group_size=64, pack=True),
]
AFFINE_IDS = ["int8", "int4", "int4-unpacked", "int8-group64",
              "int8-group128", "int4-group64"]


def _bf16_valued(rng, shape):
    """f32 numpy values that bf16 holds exactly."""
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.to(torch.bfloat16).to(torch.float32).numpy()


def _qpair(w, **fields):
    """``w`` quantized by both packages with one config."""
    return (JQ.quantize(jnp.asarray(w), JQ.QuantConfig(**fields)),
            TQ.quantize(torch.from_numpy(w), TQ.QuantConfig(**fields)))


def _within_scale(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


@pytest.mark.parametrize("fields", AFFINE, ids=AFFINE_IDS)
@pytest.mark.parametrize("m", [37, 300])
def test_emulation_matches_jax(m, fields):
    rng = np.random.default_rng(m + fields["bits"])
    x = _bf16_valued(rng, (m, K))
    w = rng.standard_normal((K, N)).astype(np.float32)
    jq, tq = _qpair(w, **fields)
    got = ref.quant_gemm_ref(torch.from_numpy(x).to(torch.bfloat16), tq)
    assert got.dtype == torch.float32
    y_reuse, _ = jops.reuse_matmul(jnp.asarray(x), jq, impl="reuse_interpret")
    _within_scale(got.numpy(), y_reuse)
    _within_scale(got.numpy(), jref.axllm_matmul_ref(jnp.asarray(x), jq))
    # and the port's own oracles, which the card holds the kernels to
    _within_scale(got.numpy(), ref.reuse_matmul_ref(torch.from_numpy(x), tq))
    _within_scale(got.numpy(), ref.axllm_matmul_ref(torch.from_numpy(x), tq))


def _dyadic_case(seed, bits, packed, group_rows):
    """Integer x in [-8, 8], integer codes, scale qmax * 2^-e per (group,
    column): every product and partial sum is exact in f32."""
    rng = np.random.default_rng(seed)
    qmax = (1 << (bits - 1)) - 1
    x = rng.integers(-8, 9, size=(37, K)).astype(np.float32)
    codes = rng.integers(-qmax, qmax + 1, size=(K, N)).astype(np.int8)
    groups = K // group_rows
    exps = rng.integers(-4, 1, size=(groups, N))
    scale = (qmax * 2.0 ** exps).astype(np.float32)
    exact = np.zeros((37, N), np.float64)
    for g in range(groups):
        rows = slice(g * group_rows, (g + 1) * group_rows)
        exact += (x[:, rows].astype(np.int64) @ codes[rows].astype(np.int64)
                  ) * (2.0 ** exps[g])[None, :]
    gran = "per_group" if groups > 1 else "per_channel"
    fields = dict(codebook=None, bits=bits, mode="affine", granularity=gran,
                  group_size=group_rows, packed=packed, shape=codes.shape)
    jc = JQ.pack_int4(jnp.asarray(codes)) if packed else jnp.asarray(codes)
    tc = TQ.pack_int4(torch.from_numpy(codes)) if packed else \
        torch.from_numpy(codes)
    jscale = scale.reshape(groups, 1, N) if groups > 1 else scale
    jq = JQ.QTensor(codes=jc, scale=jnp.asarray(jscale), **fields)
    tq = TQ.QTensor(codes=tc, scale=torch.from_numpy(jscale), **fields)
    return x, jq, tq, exact.astype(np.float32)


@pytest.mark.parametrize("bits,packed,group_rows", [
    (8, False, K), (4, True, K), (4, False, K), (8, False, 64),
    (8, False, 128), (4, True, 64)],
    ids=["int8", "int4", "int4-unpacked", "int8-group64", "int8-group128",
         "int4-group64"])
def test_emulation_bit_exact_in_dyadic_regime(bits, packed, group_rows):
    x, jq, tq, exact = _dyadic_case(bits + group_rows, bits, packed,
                                    group_rows)
    got = ref.quant_gemm_ref(torch.from_numpy(x).to(torch.bfloat16), tq)
    np.testing.assert_array_equal(got.numpy(), exact)
    y_jax, _ = jops.reuse_matmul(jnp.asarray(x), jq, impl="reuse_interpret")
    np.testing.assert_array_equal(got.numpy(), np.asarray(y_jax))
    np.testing.assert_array_equal(
        got.numpy(), ref.reuse_matmul_ref(torch.from_numpy(x), tq).numpy())


def test_emulation_rejects_codebooks():
    w = torch.randn(64, 32)
    with pytest.raises(ValueError):
        ref.quant_gemm_ref(w[:4].to(torch.bfloat16),
                           TQ.quantize(w, TQ.QuantConfig(4, "codebook")))


def _qt(k=768, n=2048, **fields):
    return TQ.quantize(torch.randn(k, n) * 0.05, TQ.QuantConfig(**fields))


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("m,dtype,qt_fields,want", [
    (4096, BF16, dict(bits=8), True),                      # prefill wave
    (TC_MIN_M, BF16, dict(bits=8), True),                  # at the threshold
    (TC_MIN_M - 1, BF16, dict(bits=8), False),             # below it
    (8, BF16, dict(bits=8), False),                        # decode
    (4096, F32, dict(bits=8), False),                      # fp32 engine
    (4096, BF16, dict(bits=4, pack=True), True),
    (4096, BF16, dict(bits=4, pack=False), True),
    (4096, BF16, dict(bits=8, granularity="per_tensor"), True),
    (4096, BF16, dict(bits=8, granularity="per_group", group_size=64), True),
    (4096, BF16, dict(bits=8, granularity="per_group", group_size=128), True),
    (4096, BF16, dict(bits=8, granularity="per_group", group_size=32), False),
    (4096, BF16, dict(bits=8, granularity="per_group", group_size=96), False),
    (4096, BF16, dict(bits=4, mode="codebook"), False),    # NF4
    (4096, BF16, dict(bits=8, mode="codebook"), False),    # identity-8
    (4096, BF16, dict(k=200, bits=8), True),               # ragged K, TMA rows
    (4096, BF16, dict(k=196, bits=8), False),              # rows not 16 B
    (4096, BF16, dict(n=80, bits=8), True),
    (4096, BF16, dict(n=88, bits=8), False),
    (4096, BF16, dict(n=80, bits=4, pack=True), False),    # 40-byte rows
    (4096, BF16, dict(n=96, bits=4, pack=True), True),
], ids=["prefill", "threshold", "below-threshold", "decode", "f32", "int4",
        "int4-unpacked", "per-tensor", "group64", "group128", "group32",
        "group96", "nf4", "cb8", "k200", "k196", "n80", "n88",
        "n80-packed", "n96-packed"])
def test_tensor_core_path_choice(m, dtype, qt_fields, want):
    assert tensor_core_path(m, dtype, _qt(**qt_fields)) is want


@pytest.mark.parametrize("out_dtype", [F32, BF16])
@pytest.mark.parametrize("fields", AFFINE[:2] + AFFINE[3:4],
                         ids=AFFINE_IDS[:2] + AFFINE_IDS[3:4])
def test_cpu_wrappers_write_out_dtype(fields, out_dtype):
    """On the CPU the wrappers take their plain versions and return the
    caller's dtype: what ``ops`` returned before it passed the dtype on
    (the plain f32 result, rounded once)."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(_bf16_valued(rng, (70, K))).to(BF16)
    qt = TQ.quantize(torch.from_numpy(
        rng.standard_normal((K, N)).astype(np.float32)),
        TQ.QuantConfig(**fields))
    y = axllm_matmul_cuda(x, qt, out_dtype)
    assert y.dtype == out_dtype
    assert torch.equal(y, ref.axllm_matmul_ref(x, qt).to(out_dtype))
    y, mults = reuse_matmul_cuda(x, qt, with_stats=True, out_dtype=out_dtype)
    assert y.dtype == out_dtype and mults == ref.reuse_mult_count(qt, 128)
    assert torch.equal(y, ref.reuse_matmul_ref(x, qt).to(out_dtype))
    x3 = x.reshape(7, 10, K)
    for impl in ("auto", "reuse"):
        y = ops.axllm_matmul(x3, qt, impl=impl, out_dtype=out_dtype)
        assert y.shape == (7, 10, N) and y.dtype == out_dtype
    assert ops.axllm_matmul(x3, qt).dtype == BF16


def test_every_entry_point_belongs_to_a_library():
    """``<library>.<path>`` names a second entry point of a library built
    from ``csrc/<library>.cu``; the tensor-core paths of both matmuls are
    such entry points."""
    sources = {p.stem for p in _build.CSRC.glob("*.cu")}
    assert set(_build.LIBRARIES) == sources
    for name in _build.SIGNATURES:
        assert name.split(".")[0] in _build.LIBRARIES
    assert {"axllm_matmul.wgmma", "reuse_matmul.wgmma"} <= set(
        _build.SIGNATURES)


def test_shared_header_edit_rebuilds_both_matmuls(tmp_path, monkeypatch):
    """Every ``*.cuh`` is part of each library's build hash, so an edit of
    the shared mainloop gives both matmul libraries new targets."""
    for p in _build.CSRC.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {lib: _build.target(lib) for lib in _build.LIBRARIES}
    header = tmp_path / "quant_gemm_sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {lib: _build.target(lib) for lib in _build.LIBRARIES}
    for lib in ("axllm_matmul", "reuse_matmul"):
        assert after[lib] != before[lib]

