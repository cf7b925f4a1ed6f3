"""The split-K decode kernels of the two quantized matmuls
(``csrc/quant_gemv.cuh``: ``axllm_matmul.gemv``, ``reuse_matmul.gemv``)
on the CPU: their plan (``gemv_plan``, a function of shapes), their
arithmetic emulated split by split (``ref.quant_gemv_split_ref``) against
the JAX package on the same numpy inputs, the choice of kernel made before
a launch, and the teacher-forced token gate the card runs hold the decode
path to.

Tolerances: with bf16-valued activations every product is exact in f32,
so the emulation differs from JAX's reference and interpret-mode kernels
only in the order of f32 additions and in where the scale is applied:
within 1e-5 of the output scale. In the dyadic regime (integer
activations, dyadic scales) every sum is exact in f32, so the emulation
must equal the int64 product and JAX's kernels bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as JQ
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.configs.repro_100m import CONFIG
from repro_torch.core import quantization as TQ
from repro_torch.kernels import ref
from repro_torch.kernels.axllm_matmul import (GEMV_MAX_M, GEMV_SMEM, TC_MIN_M,
                                              gemv_path, gemv_plan,
                                              matmul_path)
from repro_torch.kernels.reuse_matmul import segment
from repro_torch.models.model import get_model
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.token_gate import token_gate

SMS = 132   # an H100's SMs

# K x N of every full-width repro-100m projection: wq/wo, wk/wv, wqkv,
# gate/up, gate_up, down
FULL = [(768, 768), (768, 256), (768, 1280), (768, 2048), (768, 4096),
        (2048, 768)]
# (packed, group rows or None for one scale row): every alphabet's layout
LAYOUTS = [(False, None), (True, None), (False, 64), (False, 128),
           (True, 64), (True, 128)]
LAYOUT_IDS = ["int8", "int4", "int8-group64", "int8-group128",
              "int4-group64", "int4-group128"]


def _check_plan(p, m, k, n, group_rows, reuse, packed):
    """What every plan must satisfy."""
    ranges = p.k_ranges()
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(a < b for a, b in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0]
               for i in range(len(ranges) - 1))
    if group_rows < k and p.splits > 1:
        # no split straddles a group boundary
        assert (p.k_per_split % group_rows == 0
                or group_rows % p.k_per_split == 0)
        for a, b in ranges:     # inside one group, or whole groups
            assert a // group_rows == (b - 1) // group_rows or (
                a % group_rows == 0 and (b % group_rows == 0 or b == k))
    assert p.n_tiles * p.bn >= n and (p.n_tiles - 1) * p.bn < n
    assert p.m_tiles * p.mt >= m and (p.m_tiles - 1) * p.mt < m
    if reuse:
        assert p.bn % segment(n) == 0
        assert p.mt in (1, 2, 4)
    else:
        assert p.mt == (8 if m <= 8 else 16)
    row_bytes = p.bn // 2 if packed else p.bn
    assert p.k_per_split * (row_bytes + 4 * p.mt) <= GEMV_SMEM or \
        p.k_per_split == 1


@pytest.mark.parametrize("reuse", [False, True], ids=["axllm", "reuse"])
@pytest.mark.parametrize("layout", LAYOUTS, ids=LAYOUT_IDS)
@pytest.mark.parametrize("kn", FULL, ids=lambda kn: f"K{kn[0]}N{kn[1]}")
def test_plan_fills_the_card_at_full_width(kn, layout, reuse):
    (k, n), (packed, group) = kn, layout
    for m in (8, 16):           # n_slots, and the largest decode M
        p = gemv_plan(m, k, n, group or k, SMS, reuse=reuse, packed=packed)
        _check_plan(p, m, k, n, group or k, reuse, packed)
        assert p.blocks >= SMS
        assert p.splits > 1


@pytest.mark.parametrize("reuse", [False, True], ids=["axllm", "reuse"])
def test_plan_valid_at_every_decode_m_and_reduced_shapes(reuse):
    cfg = CONFIG.reduced(dtype="float32", remat=False)
    d, f = cfg.d_model, cfg.d_ff
    hd = cfg.d_model // cfg.n_heads
    reduced = [(d, d), (d, cfg.n_kv_heads * hd), (d, f), (f, d),
               (d, d + 2 * cfg.n_kv_heads * hd), (d, 2 * f)]
    for m in range(1, GEMV_MAX_M + 1):
        for k, n in FULL + reduced + [(200, 96), (64, 64), (8192, 2048)]:
            for packed, group in LAYOUTS + [(False, 8)]:
                g = group or k
                if k % g:
                    continue
                p = gemv_plan(m, k, n, g, SMS, reuse=reuse, packed=packed)
                _check_plan(p, m, k, n, g, reuse, packed)
    with pytest.raises(ValueError):
        gemv_plan(GEMV_MAX_M + 1, 768, 2048, 768, SMS)


def _bf16_valued(rng, shape):
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.to(torch.bfloat16).to(torch.float32).numpy()


def _within_scale(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


ALPHABETS = [dict(bits=8), dict(bits=4, pack=True),
             dict(bits=8, granularity="per_group", group_size=64),
             dict(bits=8, granularity="per_group", group_size=128),
             dict(bits=4, mode="codebook", pack=True)]
ALPHABET_IDS = ["int8", "int4", "int8-group64", "int8-group128", "nf4"]
K, N = 512, 256


@pytest.mark.parametrize("reuse", [False, True], ids=["axllm", "reuse"])
@pytest.mark.parametrize("fields", ALPHABETS, ids=ALPHABET_IDS)
@pytest.mark.parametrize("m", [1, 8, 16])
def test_split_emulation_matches_jax(m, fields, reuse):
    rng = np.random.default_rng(m + fields["bits"] + reuse)
    x = _bf16_valued(rng, (m, K))
    w = rng.standard_normal((K, N)).astype(np.float32)
    cfg = dict(fields)
    jq = JQ.quantize(jnp.asarray(w), JQ.QuantConfig(**cfg))
    tq = TQ.quantize(torch.from_numpy(w), TQ.QuantConfig(**cfg))
    group = K // tq.kernel_scale.shape[0]
    plan = gemv_plan(m, K, N, group, SMS, reuse=reuse, packed=tq.packed)
    assert plan.splits > 1
    got = ref.quant_gemv_split_ref(torch.from_numpy(x), tq, plan, reuse)
    assert got.dtype == torch.float32
    _within_scale(got.numpy(), jref.axllm_matmul_ref(jnp.asarray(x), jq))
    if reuse:
        y_jax, _ = jops.reuse_matmul(jnp.asarray(x), jq,
                                     impl="reuse_interpret")
    else:
        y_jax = jops.axllm_matmul(jnp.asarray(x), jq,
                                  impl="pallas_interpret")
    _within_scale(got.numpy(), y_jax)
    # and the port's plain versions, which the card holds the kernels to
    xt = torch.from_numpy(x)
    _within_scale(got.numpy(), ref.axllm_matmul_ref(xt, tq).numpy())
    _within_scale(got.numpy(), ref.reuse_matmul_ref(xt, tq).numpy())
    # a bf16 output is the f32 output rounded once
    assert torch.equal(
        ref.quant_gemv_split_ref(xt.to(torch.bfloat16), tq, plan, reuse,
                                 torch.bfloat16), got.to(torch.bfloat16))


def _dyadic_case(seed, m, bits, packed, group_rows):
    """Integer x in [-8, 8], integer codes, scale qmax * 2^-e per (group,
    column): every product and partial sum is exact in f32."""
    rng = np.random.default_rng(seed)
    qmax = (1 << (bits - 1)) - 1
    x = rng.integers(-8, 9, size=(m, K)).astype(np.float32)
    codes = rng.integers(-qmax, qmax + 1, size=(K, N)).astype(np.int8)
    groups = K // group_rows
    exps = rng.integers(-4, 1, size=(groups, N))
    scale = (qmax * 2.0 ** exps).astype(np.float32)
    exact = np.zeros((m, N), np.float64)
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


@pytest.mark.parametrize("reuse", [False, True], ids=["axllm", "reuse"])
@pytest.mark.parametrize("bits,packed,group_rows", [
    (8, False, K), (4, True, K), (8, False, 64), (8, False, 128),
    (4, True, 64)],
    ids=["int8", "int4", "int8-group64", "int8-group128", "int4-group64"])
def test_split_emulation_bit_exact_in_dyadic_regime(bits, packed, group_rows,
                                                     reuse):
    x, jq, tq, exact = _dyadic_case(bits + group_rows, 8, bits, packed,
                                    group_rows)
    plan = gemv_plan(8, K, N, group_rows, SMS, reuse=reuse, packed=packed)
    got = ref.quant_gemv_split_ref(torch.from_numpy(x), tq, plan, reuse)
    np.testing.assert_array_equal(got.numpy(), exact)
    if reuse:
        y_jax, _ = jops.reuse_matmul(jnp.asarray(x), jq,
                                     impl="reuse_interpret")
    else:
        y_jax = jops.axllm_matmul(jnp.asarray(x), jq,
                                  impl="pallas_interpret")
    np.testing.assert_array_equal(got.numpy(), np.asarray(y_jax))


def test_split_emulation_defers_the_scale_inside_a_group():
    """Splits inside one scale group leave their sums unscaled: the merge
    scales the group's total once, as the kernels do, and a plan whose
    splits hold whole groups scales each group in its split."""
    x, _, tq, exact = _dyadic_case(5, 8, 8, False, 128)
    inside = gemv_plan(8, K, N, 128, SMS)
    whole = dataclasses.replace(inside, splits=2, k_per_split=256)
    assert inside.defer and not whole.defer
    for plan in (inside, whole):
        got = ref.quant_gemv_split_ref(torch.from_numpy(x), tq, plan)
        np.testing.assert_array_equal(got.numpy(), exact)


def _qt(k=768, n=2048, **fields):
    return TQ.quantize(torch.randn(k, n) * 0.05, TQ.QuantConfig(**fields))


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("m,dtype,qt_fields,want", [
    (8, BF16, dict(bits=8), "gemv"),                     # serving decode
    (1, BF16, dict(bits=8), "gemv"),
    (GEMV_MAX_M, BF16, dict(bits=8), "gemv"),
    (GEMV_MAX_M + 1, F32, dict(bits=8), "tile"),
    (GEMV_MAX_M + 1, BF16, dict(bits=4, mode="codebook"), "wgmma"),
    (TC_MIN_M, BF16, dict(bits=8), "wgmma"),             # prefill
    (0, BF16, dict(bits=8), "tile"),                     # count only
    (8, F32, dict(bits=8), "gemv"),                      # fp32 engine
    (4096, F32, dict(bits=8), "tile"),                   # fp32 prefill
    (8, BF16, dict(bits=4, pack=True), "gemv"),
    (8, BF16, dict(bits=4, pack=False), "gemv"),
    (8, BF16, dict(bits=8, granularity="per_tensor"), "gemv"),
    (8, BF16, dict(bits=8, granularity="per_group", group_size=64), "gemv"),
    (8, BF16, dict(bits=8, granularity="per_group", group_size=96), "gemv"),
    (8, BF16, dict(bits=4, mode="codebook"), "gemv"),    # NF4
    (8, BF16, dict(bits=8, mode="codebook"), "gemv"),    # identity-8
    (4096, BF16, dict(bits=4, mode="codebook"), "wgmma"),  # NF4 prefill
    (8, BF16, dict(n=80, bits=8), "gemv"),               # 80-byte rows
    (8, BF16, dict(n=88, bits=8), "tile"),               # rows not 16 B
    (8, BF16, dict(n=80, bits=4, pack=True), "tile"),    # 40-byte rows
    (8, BF16, dict(n=96, bits=4, pack=True), "gemv"),
], ids=["decode", "m1", "m16", "m17-f32", "m17-nf4", "prefill", "m0", "f32",
         "f32-prefill",
        "int4", "int4-unpacked", "per-tensor", "group64", "group96", "nf4",
        "cb8", "nf4-prefill", "n80", "n88", "n80-packed", "n96-packed"])
def test_kernel_choice(m, dtype, qt_fields, want):
    qt = _qt(**qt_fields)
    assert matmul_path(m, dtype, qt) == want
    assert gemv_path(m, qt) == (want == "gemv")


def test_kernel_choice_reads_code_alignment():
    """Codes that do not start on a 16-byte boundary take the tile kernel
    at decode, and an x that TMA cannot read takes it at prefill."""
    qt = _qt(n=256, bits=8)
    buf = torch.zeros(qt.codes.numel() + 1, dtype=torch.int8)
    off = buf[1:].view(qt.codes.shape)
    off.copy_(qt.codes)
    assert off.data_ptr() % 16
    shifted = dataclasses.replace(qt, codes=off)
    assert matmul_path(8, BF16, qt) == "gemv"
    assert matmul_path(8, BF16, shifted) == "tile"
    assert matmul_path(4096, BF16, qt, x_aligned=False) == "tile"


def _corrupt_down(params, factor):
    """``params`` with every layer's down projection scaled by ``factor``:
    a defect of the kind a wrong scale in a kernel would make."""
    layers = dict(params["layers"])
    ffn = dict(layers["ffn"])
    qt = ffn["down"]
    ffn["down"] = dataclasses.replace(qt, scale=qt.scale * factor,
                                      kernel_scale=None)
    layers["ffn"] = ffn
    return dict(params, layers=layers)


@pytest.mark.parametrize("impl", ["ref", "reuse_ref"])
def test_token_gate_trips_on_a_corrupted_path(impl):
    """The gate passes the tokens of the path it is held to, and fails the
    tokens of a path whose down projection's scale is off by a factor."""
    cfg = CONFIG.reduced(dtype="float32", remat=False)
    params = get_model(cfg).init(seed=0, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (8, 12, 31, 5)]
    eng = ServeEngine(cfg, params, n_slots=2, max_len=64, quantize=True,
                      impl=impl, device="cpu")
    toks = eng.generate(prompts, max_new=16)
    good = token_gate(cfg, eng.params, prompts, toks, impl=impl,
                      tol_rel=5e-2, device="cpu")
    assert good.ok and good.positions == 64 and good.differ == 0
    assert good.min_slack > 0
    bad_eng = ServeEngine(cfg, _corrupt_down(eng.params, 4.0), n_slots=2,
                          max_len=64, quantize=False, impl=impl,
                          device="cpu")
    bad = token_gate(cfg, eng.params, prompts,
                     bad_eng.generate(prompts, max_new=16), impl=impl,
                     tol_rel=5e-2, device="cpu")
    assert not bad.ok and bad.min_slack < 0 and bad.differ > 0
    assert bad.positions == 64
