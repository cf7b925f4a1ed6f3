"""Card tests: each hand-written CUDA kernel against its plain version on
an NVIDIA GPU, and the engine's kernel path against its plain path.

Marked ``cuda``; each test decides inside the ``card`` fixture whether a
card exists and skips with the reason where none does. Run them on the
card with ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.

Tolerances: float32 kernels agree with the plain versions to 1e-5
relative to the output scale (other summation orders); bfloat16 outputs
to 1e-2 of the scale (one bfloat16 rounding of the result, 2^-8). The
redesigned attention kernels are also held to their emulations
(``ref.flash_attention_tc_ref``, ``ref.decode_attention_split_ref``):
within 2^-8 of the scale for a bf16 output (its one rounding), 1e-5 for
f32. Flash takes its tensor-core kernel for bf16 (``tensor_core_path``)
and is tested on both paths; decode lengths sit at split boundaries. The
quantized matmuls take their tensor-core kernel where
``tensor_core_path`` says so (bf16, affine, M >= TC_MIN_M) and their SIMT
kernel elsewhere; the M values cross that threshold, K = 200 is ragged
against the 64-row K tile, and a bf16 output must equal the f32 output
rounded once. The
split-K decode kernels (``axllm_matmul.gemv``, ``reuse_matmul.gemv``, M
<= 16) are also held to their emulation (``ref.quant_gemv_split_ref``)
within 1e-5 of the output scale, must give the same bits on a second
launch and be one kernel launch a call. The
reuse kernel's multiply count is an integer and must equal
``reuse_mult_count``. The tensor-core path's codebook route (NF4, packed
or not, and identity-8, each level three bf16 terms) is held to its plain
version and its emulation (``ref.quant_gemm_ref``) within 1e-5 of the
output scale. The engines' greedy tokens on a bf16 model are held
to the teacher-forced token gate (``serve/token_gate.py``), also under
overload (preemption, chunked prefill), and the chaos scenarios run
through the kernels. The speculative engine (an int4 draft, dense and
paged) must give the target-only engine's tokens on the card, exactly. The
quantization kernel's codes and scales must equal its plain version's
exactly, on every route of its plan and on columns that hold a NaN, an
inf or only zeros. The decode kernels also run at 16 query heads a KV
head (two groups) and head dim 16, flash's SIMT kernel at head dim 16,
and a reduced moe engine (paged, reuse, speculating) against its plain
path. Training: the flash backward kernel against its plain version
(``ref.flash_attention_bwd_ref``) at GQA ratios 1 to 16, head dims 16 to
128, causal and not, Sq > Sk, bit-equal on relaunch; ``FlashAttentionFn``
gradients against autograd of the plain path (2e-2 of the scale in
bf16: the tensor-core forward rounds P to bf16 and the backward
recomputes it in f32; 1e-5 in f32); the backward wrapper's refusals; and
a reduced bf16 training step against the plain path, per leaf, and
repeating bit for bit under the launcher's deterministic mode. Tensor
parallel serving, two ranks sharing the card over gloo: the
sequence-sharded decode against the same ranks on the CPU, and a reduced
bf16 engine at mesh 1x2 whose ranks agree, launch the kernels at their
shapes and pass the token gate on the unsharded model.
"""

import dataclasses

import numpy as np

import pytest
import torch

from repro_torch.configs.repro_100m import CONFIG
from repro_torch.core.quantization import QuantConfig, quantize
from repro_torch.kernels import _build, ref
from repro_torch.kernels import axllm_matmul as axllm_kernel
from repro_torch.kernels import reuse_matmul as reuse_kernel
from repro_torch.kernels.axllm_matmul import (axllm_matmul_cuda, gemv_buffers,
                                              tensor_core_path)
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import decode_attention_cuda, \
    plan_rows
from repro_torch.kernels.decode_attention import \
    split_plan as decode_split_plan
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.flash_attention import launch as \
    flash_attention_launch
from repro_torch.kernels.flash_attention import \
    tensor_core_path as flash_attention_tensor_core_path
from repro_torch.kernels.paged_decode_attention import \
    paged_decode_attention_cuda
from repro_torch.kernels.quantize import quantize_cuda
from repro_torch.kernels.reuse_matmul import reuse_matmul_cuda, segment
from repro_torch.models.model import get_model
from repro_torch.serve.adapters import AdapterRegistry, target_dims
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.token_gate import token_gate

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _rel_err(got, want):
    want = want.float()
    return float((got.float() - want).abs().max()) / max(
        1.0, float(want.abs().max()))


def _tol(dtype):
    return 1e-5 if dtype == torch.float32 else 1e-2


def _fit_group(qcfg, k):
    """A per-group config whose groups divide ``k``: K = 200 takes groups
    of 8 rows, which 64 does not divide (the SIMT kernels' case)."""
    if qcfg.granularity == "per_group" and k % qcfg.group_size:
        return dataclasses.replace(qcfg, group_size=8)
    return qcfg


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qcfg", [
    QuantConfig(8), QuantConfig(8, "affine", "per_group", group_size=64),
    QuantConfig(4, "affine", pack=True), QuantConfig(4, "codebook")],
    ids=["int8", "int8-group", "int4", "nf4"])
@pytest.mark.parametrize("k", [192, 200])
@pytest.mark.parametrize("m", [8, 37, 63, 64, 65, 300, 1000])
def test_axllm_matmul_kernel(card, m, k, qcfg, dtype):
    g = torch.Generator(device=card).manual_seed(m + k)
    qcfg = _fit_group(qcfg, k)
    x = torch.randn(m, k, generator=g, device=card).to(dtype)
    qt = quantize(torch.randn(k, 96, generator=g, device=card), qcfg)
    before = dict(_build.LAUNCHES)
    y = axllm_matmul_cuda(x, qt)
    torch.cuda.synchronize()
    tc = int(tensor_core_path(m, dtype, qt))
    assert _build.LAUNCHES["axllm_matmul"] == before.get("axllm_matmul",
                                                         0) + 1
    assert _build.LAUNCHES["axllm_matmul.wgmma"] == before.get(
        "axllm_matmul.wgmma", 0) + tc
    # f32 output either way: the sums run in f32 over the same inputs
    assert _rel_err(y, ref.axllm_matmul_ref(x, qt)) < 1e-5
    # a bf16 output is the f32 output rounded once, to nearest even
    assert torch.equal(axllm_matmul_cuda(x, qt, torch.bfloat16),
                       y.to(torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qcfg", [
    QuantConfig(8), QuantConfig(8, "affine", "per_group", group_size=64),
    QuantConfig(4, "affine", pack=True), QuantConfig(4, "affine", pack=False),
    QuantConfig(4, "codebook"), QuantConfig(8, "codebook")],
    ids=["int8", "int8-group", "int4", "int4-unpacked", "nf4", "cb8"])
@pytest.mark.parametrize("m,k,n", [(8, 192, 96), (37, 256, 512),
                                   (63, 256, 512), (64, 256, 512),
                                   (65, 768, 256), (300, 768, 256),
                                   (300, 200, 256), (1000, 768, 256),
                                   (0, 64, 64)])
def test_reuse_matmul_kernel(card, m, k, n, qcfg, dtype):
    g = torch.Generator(device=card).manual_seed(m + n)
    qcfg = _fit_group(qcfg, k)
    x = torch.randn(m, k, generator=g, device=card).to(dtype)
    qt = quantize(torch.randn(k, n, generator=g, device=card), qcfg)
    before = dict(_build.LAUNCHES)
    y, mults = reuse_matmul_cuda(x, qt, with_stats=True)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["reuse_matmul"] == before.get("reuse_matmul",
                                                         0) + 1
    assert _build.LAUNCHES["reuse_matmul.wgmma"] == before.get(
        "reuse_matmul.wgmma", 0) + int(tensor_core_path(m, dtype, qt))
    assert int(mults) == ref.reuse_mult_count(qt, segment(n))
    assert y.shape == (m, n)
    if m:
        assert _rel_err(y, ref.reuse_matmul_ref(x, qt)) < 1e-5
    y2, none = reuse_matmul_cuda(x, qt)        # serving: no count
    torch.cuda.synchronize()
    assert none is None and torch.equal(y, y2)
    y3, _ = reuse_matmul_cuda(x, qt, out_dtype=torch.bfloat16)
    assert torch.equal(y3, y.to(torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8kv"])
def test_paged_decode_attention_kernel(card, quant, dtype):
    g = torch.Generator(device=card).manual_seed(2)
    b, h, hk, d, bs, mb = 4, 12, 4, 64, 16, 8
    nb = b * mb + 2
    q = torch.randn(b, h, d, generator=g, device=card).to(dtype)
    bt = (1 + torch.randperm(nb - 1, generator=g, device=card)[:b * mb])
    bt = bt.reshape(b, mb).to(torch.int32)
    bt[1, :2] = bt[0, :2]                       # a shared prefix
    bt[0, 3:] = 0                               # trash past the length
    length = torch.tensor([3 * bs - 5, 0, mb * bs, mb * bs + 40],
                          dtype=torch.int32, device=card)
    if quant:
        kp = torch.randint(-127, 128, (nb, bs, hk, d), generator=g,
                           device=card, dtype=torch.int8)
        vp = torch.randint(-127, 128, (nb, bs, hk, d), generator=g,
                           device=card, dtype=torch.int8)
        ks = torch.rand(nb, bs, hk, 1, generator=g, device=card) * 0.02
        vs = torch.rand(nb, bs, hk, 1, generator=g, device=card) * 0.02
    else:
        kp = torch.randn(nb, bs, hk, d, generator=g, device=card).to(dtype)
        vp = torch.randn(nb, bs, hk, d, generator=g, device=card).to(dtype)
        ks = vs = None
    out = paged_decode_attention_cuda(q, kp, vp, bt, length, ks, vs)
    torch.cuda.synchronize()
    assert out.dtype == dtype
    assert torch.count_nonzero(out[1]) == 0
    want = ref.paged_decode_attention_ref(q, kp, vp, bt, length, ks, vs)
    assert _rel_err(out, want) < _tol(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8kv"])
def test_decode_attention_kernel(card, quant, dtype):
    g = torch.Generator(device=card).manual_seed(1)
    b, s, h, hk, d = 4, 80, 12, 4, 64
    q = torch.randn(b, h, d, generator=g, device=card).to(dtype)
    length = torch.tensor([0, 7, s, s + 5], dtype=torch.int32, device=card)
    if quant:
        kc = torch.randint(-127, 128, (b, s, hk, d), generator=g,
                           device=card, dtype=torch.int8)
        vc = torch.randint(-127, 128, (b, s, hk, d), generator=g,
                           device=card, dtype=torch.int8)
        ks = torch.rand(b, s, hk, 1, generator=g, device=card) * 0.02
        vs = torch.rand(b, s, hk, 1, generator=g, device=card) * 0.02
    else:
        kc = torch.randn(b, s, hk, d, generator=g, device=card).to(dtype)
        vc = torch.randn(b, s, hk, d, generator=g, device=card).to(dtype)
        ks = vs = None
    out = decode_attention_cuda(q, kc, vc, length, ks, vs)
    torch.cuda.synchronize()
    assert out.dtype == dtype
    assert torch.count_nonzero(out[0]) == 0
    want = ref.decode_attention_ref(q, kc, vc, length, ks, vs)
    assert _rel_err(out, want) < _tol(dtype)


@pytest.mark.parametrize("dtype,path", [
    (torch.float32, "simt"), (torch.bfloat16, "simt"),
    (torch.bfloat16, "wgmma")], ids=["f32-simt", "bf16-simt", "bf16-wgmma"])
@pytest.mark.parametrize("sq,sk,causal", [(128, 128, True), (70, 70, True),
                                          (50, 190, True), (50, 190, False)])
def test_flash_attention_kernel(card, sq, sk, causal, dtype, path):
    g = torch.Generator(device=card).manual_seed(sq)
    q = torch.randn(2, sq, 12, 64, generator=g, device=card).to(dtype)
    k = torch.randn(2, sk, 4, 64, generator=g, device=card).to(dtype)
    v = torch.randn(2, sk, 4, 64, generator=g, device=card).to(dtype)
    before = dict(_build.LAUNCHES)
    out = flash_attention_launch(q, k, v, causal, path == "wgmma")
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention.wgmma"] == before.get(
        "flash_attention.wgmma", 0) + (path == "wgmma")
    want = ref.attention_ref(q, k, v, causal)
    assert _rel_err(out, want) < _tol(dtype)
    if dtype == torch.bfloat16:     # the wrapper's own choice
        assert flash_attention_tensor_core_path(q)
        assert torch.equal(flash_attention_cuda(q, k, v, causal),
                           flash_attention_launch(q, k, v, causal, True))
    if path == "wgmma":             # its arithmetic, to one output rounding
        emu = ref.flash_attention_tc_ref(q.float(), k.float(), v.float(),
                                         causal)
        assert _rel_err(out, emu) < 2.0 ** -8


@pytest.mark.parametrize("b,sq,sk,d,causal", [
    (8, 512, 512, 64, True), (2, 256, 1024, 64, True),
    (2, 256, 1024, 64, False), (2, 256, 1024, 128, True),
    (1, 130, 300, 128, False), (3, 1, 9, 64, True),
    (1, 256, 4096, 64, False), (1, 64, 5000, 128, True),
    (1, 100, 3000, 64, True)])
def test_flash_attention_tensor_core_kernel(card, b, sq, sk, d, causal):
    """The tensor-core kernel at the serving wave's shape, at Sq < Sk, at
    long key ranges (ragged ones too), at d = 128 and at a single query;
    held against its emulation to one bf16 rounding of the output, and
    against the plain version at the bf16 tolerance."""
    g = torch.Generator(device=card).manual_seed(sk + d)
    q = torch.randn(b, sq, 12, d, generator=g, device=card).to(torch.bfloat16)
    k = torch.randn(b, sk, 4, d, generator=g, device=card).to(torch.bfloat16)
    v = torch.randn(b, sk, 4, d, generator=g, device=card).to(torch.bfloat16)
    out = flash_attention_launch(q, k, v, causal, True)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out.float()).all())
    emu = ref.flash_attention_tc_ref(q.float(), k.float(), v.float(), causal)
    assert _rel_err(out, emu) < 2.0 ** -8
    assert _rel_err(out, ref.attention_ref(q, k, v, causal)) < _tol(
        torch.bfloat16)
    assert torch.equal(out, flash_attention_launch(q, k, v, causal, True))


def test_flash_attention_misaligned_bf16_raises(card):
    """bf16 at d = 64 takes the tensor-core kernel whatever its address:
    a base that TMA cannot read (not 16-byte aligned) raises from the
    launch and falls back to nothing."""
    n = 1 * 64 * 4 * 64
    buf = torch.randn(n + 1, device=card).to(torch.bfloat16)
    q = buf[1:].view(1, 64, 4, 64)                 # 2 bytes past a base
    assert q.is_contiguous() and q.data_ptr() % 16
    before = _build.LAUNCHES["flash_attention"]
    with pytest.raises(RuntimeError):
        flash_attention_cuda(q, q, q, True)
    assert _build.LAUNCHES["flash_attention"] == before


def _decode_split_case(card, quant, dtype, b, s, h, hk, d, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn(b, h, d, generator=g, device=card).to(dtype)
    if quant:
        kc = torch.randint(-127, 128, (b, s, hk, d), generator=g,
                           device=card, dtype=torch.int8)
        vc = torch.randint(-127, 128, (b, s, hk, d), generator=g,
                           device=card, dtype=torch.int8)
        ks = torch.rand(b, s, hk, 1, generator=g, device=card) * 0.02
        vs = torch.rand(b, s, hk, 1, generator=g, device=card) * 0.02
        return q, kc, vc, ks, vs
    kc = torch.randn(b, s, hk, d, generator=g, device=card).to(dtype)
    vc = torch.randn(b, s, hk, d, generator=g, device=card).to(dtype)
    return q, kc, vc, None, None


def _emu_tol(dtype):
    # f32: another order of f32 additions; bf16: one rounding of the output
    return 1e-5 if dtype == torch.float32 else 2.0 ** -8


# (H, Hk, d) of the body's instantiations: the serving shape (4 query heads
# per KV head in registers), 8 per KV head at d = 32, d = 128 with 8, 16
# per KV head (two groups of 8 blocks read the same KV: glm4-9b's layout)
# and d = 16 (the merge on half a warp)
HEADS = [(12, 4, 64), (16, 2, 32), (8, 1, 128), (32, 2, 128), (4, 2, 16)]


@pytest.mark.parametrize("heads", HEADS, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8kv"])
def test_decode_attention_split_kernel(card, quant, dtype, heads):
    """One decode step at the serving shape and the other head layouts:
    lengths 0, 1, each side of a split boundary, the whole cache and past
    it; held against the split emulation and the plain version. The
    counters are left at 0, so a second launch gives the same bits."""
    (h, hk, d), b, s = heads, 9, 1024
    q, kc, vc, ks, vs = _decode_split_case(card, quant, dtype, b, s, h, hk, d,
                                           3)
    n_split, split_len = decode_split_plan(s, plan_rows(b, h, hk),
                                           _build.sm_count(card))
    assert n_split > 1
    length = torch.tensor([0, 1, split_len - 1, split_len, split_len + 1,
                           3 * split_len, 700, s, s + 9], dtype=torch.int32,
                          device=card)
    out = decode_attention_cuda(q, kc, vc, length, ks, vs)
    torch.cuda.synchronize()
    assert torch.count_nonzero(out[0]) == 0
    emu = ref.decode_attention_split_ref(q, kc, vc, length, ks, vs, n_split,
                                         split_len)
    assert _rel_err(out, emu) < _emu_tol(dtype)
    assert _rel_err(out, ref.decode_attention_ref(q, kc, vc, length, ks,
                                                  vs)) < _tol(dtype)
    assert torch.equal(out, decode_attention_cuda(q, kc, vc, length, ks, vs))


@pytest.mark.parametrize("heads", HEADS, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8kv"])
def test_paged_decode_attention_split_kernel(card, quant, dtype, heads):
    """The paged body at the serving shape (16-key blocks, 64 a row,
    shuffled and shared) and the other head layouts, lengths at split
    boundaries, 0 and past the table; a table entry out of the pool is
    clamped into it."""
    (h, hk, d), b, bs, mb = heads, 8, 16, 64
    nb = 2 * b * mb + 2
    g = torch.Generator(device=card).manual_seed(5)
    q, kp, vp, ks, vs = _decode_split_case(card, quant, dtype, nb, bs, h, hk,
                                           d, 6)
    q = q[:b].contiguous()
    bt = (1 + torch.randperm(nb - 1, generator=g, device=card)[:b * mb])
    bt = bt.reshape(b, mb).to(torch.int32)
    bt[1:, :16] = bt[0, :16]                  # a shared 256-token prefix
    n_split, split_len = decode_split_plan(mb * bs, plan_rows(b, h, hk),
                                           _build.sm_count(card), bs)
    length = torch.tensor([0, split_len - 1, split_len, split_len + 1, 511,
                           1000, mb * bs, mb * bs + 300], dtype=torch.int32,
                          device=card)
    bt[2, 1] = nb + 7                         # clamped to NB - 1
    out = paged_decode_attention_cuda(q, kp, vp, bt, length, ks, vs)
    torch.cuda.synchronize()
    assert torch.count_nonzero(out[0]) == 0
    emu = ref.paged_decode_attention_split_ref(q, kp, vp, bt, length, ks, vs,
                                               n_split, split_len)
    assert _rel_err(out, emu) < _emu_tol(dtype)
    clamped = torch.clamp(bt, 0, nb - 1)
    assert _rel_err(out, ref.paged_decode_attention_ref(
        q, kp, vp, clamped, length, ks, vs)) < _tol(dtype)


@pytest.mark.parametrize("bits", [8, 4, 7, 3, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(768, 2048), (2, 300, 100), (3, 9, 64),
                                   (8192, 130), (8192, 2048), (65536, 96),
                                   (3, 300, 130), (2, 70, 37)])
def test_quantize_kernel(card, shape, dtype, bits):
    """Every route of the plan: held slices (clusters of 1 to 16 blocks),
    K beyond what a cluster holds (K65536: the streamed route), N ragged
    against 16, 8 and 4 columns (N130, N100, N37; stacked), bits 2 to 8;
    codes and scales equal to the plain version's on the card."""
    g = torch.Generator(device=card).manual_seed(len(shape) + shape[-1])
    w = (torch.randn(shape, generator=g, device=card) * 0.05).to(dtype)
    w[..., 1, 3] = 0.0                  # a tie column: absmax 127 * 2^-7
    w[..., 0, 3] = 127 * 2.0 ** -7
    w[..., 2, 3] = 2.5 * 2.0 ** -7
    before = _build.LAUNCHES["quantize"]
    codes, scale = quantize_cuda(w, bits)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["quantize"] == before + 1
    # the IEEE float32 quotient: float64 division rounded once to float32
    qmax = (1 << (bits - 1)) - 1
    absmax = w.float().abs().amax(-2, keepdim=True).clamp(min=1e-8)
    assert torch.equal(scale, (absmax.double() / qmax).float())
    want_codes, want_scale = ref.quantize_ref(w, bits)
    assert torch.equal(scale, want_scale)
    assert torch.equal(codes, want_codes)
    if bits == 8:
        assert int(codes[..., 2, 3].flatten()[0]) == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(768, 2048), (3, 300, 130), (2, 70, 37),
                                   (65536, 96)])
def test_quantize_kernel_nan_inf_zero_columns(card, shape, dtype):
    """A NaN anywhere in a column gives it a NaN scale and codes 0, an inf
    an inf scale (finite weights round to 0, the inf itself is inf / inf:
    code 0), a column of zeros the 1e-8 floor and codes 0: the plain
    version's answer on the card and on the CPU (where
    tests/test_torch_quantize.py holds it to JAX's)."""
    g = torch.Generator(device=card).manual_seed(shape[-1])
    w = (torch.randn(shape, generator=g, device=card) * 0.05).to(dtype)
    w[..., 5, 0] = float("nan")
    w[..., 0, 1] = float("inf")
    w[..., 7, 2] = float("-inf")
    w[..., 3, 5] = float("nan")
    w[..., 9, 5] = float("inf")
    w[..., :, 4] = 0.0
    codes, scale = quantize_cuda(w, 8)
    torch.cuda.synchronize()
    want_codes, want_scale = ref.quantize_ref(w, 8)
    cpu_codes, cpu_scale = ref.quantize_ref(w.cpu(), 8)
    assert torch.equal(want_codes.cpu(), cpu_codes)
    torch.testing.assert_close(want_scale.cpu(), cpu_scale, rtol=0, atol=0,
                               equal_nan=True)
    assert torch.equal(codes, want_codes)
    torch.testing.assert_close(scale, want_scale, rtol=0, atol=0,
                               equal_nan=True)
    assert bool(scale[..., 0].isnan().all() & scale[..., 5].isnan().all())
    assert bool(scale[..., 1].isinf().all() & scale[..., 2].isinf().all())
    assert not codes[..., [0, 1, 2, 4, 5]].any()
    assert bool((scale[..., 4] == np.float32(1e-8) / np.float32(127)).all())


def test_wrappers_reject_what_kernels_do_not_take(card):
    x = torch.randn(8, 64, device=card)
    qt = quantize(torch.randn(64, 32, device=card), QuantConfig())
    with pytest.raises(ValueError):
        axllm_matmul_cuda(x.t().contiguous().t(), qt)   # not contiguous
    q = torch.randn(2, 8, 48, device=card)              # head dim 48
    kc = torch.randn(2, 16, 2, 48, device=card)
    with pytest.raises(ValueError):
        decode_attention_cuda(q, kc, kc, torch.ones(2, dtype=torch.int32,
                                                    device=card))
    q4 = torch.randn(1, 32, 4, 64, device=card)
    with pytest.raises(TypeError):
        flash_attention_cuda(q4, q4.to(torch.bfloat16), q4)
    q = torch.randn(2, 8, 64, device=card)
    pool = torch.randn(5, 16, 2, 64, device=card)
    one = torch.ones(2, dtype=torch.int32, device=card)
    with pytest.raises(ValueError):                     # int64 tables
        paged_decode_attention_cuda(q, pool, pool,
                                    torch.ones(2, 3, dtype=torch.int64,
                                               device=card), one)
    with pytest.raises(TypeError):
        quantize_cuda(torch.ones(4, 4, dtype=torch.float16, device=card))
    with pytest.raises(ValueError):
        quantize_cuda(torch.ones(4, 4, device=card), bits=9)
    with pytest.raises(ValueError):                     # scale shape
        paged_decode_attention_cuda(
            q, pool.to(torch.int8), pool.to(torch.int8),
            torch.ones(2, 3, dtype=torch.int32, device=card), one,
            torch.ones(5, 16, 2, 2, device=card),
            torch.ones(5, 16, 2, 2, device=card))


CODEBOOKS = [QuantConfig(4, "codebook"), QuantConfig(4, "codebook", pack=False),
             QuantConfig(8, "codebook"),
             QuantConfig(4, "codebook", "per_group", group_size=64),
             QuantConfig(8, "codebook", "per_group", group_size=128),
             QuantConfig(4, "codebook", "per_group", group_size=320),
             QuantConfig(4, "codebook", "per_group", group_size=1024)]
CODEBOOK_IDS = ["nf4", "nf4-unpacked", "cb8", "nf4-group64", "cb8-group128",
                "nf4-group320", "nf4-group1024"]


@pytest.mark.parametrize("qcfg", CODEBOOKS, ids=CODEBOOK_IDS)
@pytest.mark.parametrize("kernel", ["axllm_matmul", "reuse_matmul"])
def test_quant_gemm_codebook_kernel(card, kernel, qcfg):
    """The codebook route of the tensor-core kernel, from the threshold M
    to a prefill wave, ragged K and M included, and scale rows longer than
    a partial sum's span (groups of 320 and 1024 rows): one launch of its
    wgmma entry point, within 1e-5 of the output scale of its plain version
    and of its emulation, the same bits on a second launch, a bf16 output
    equal to the f32 output rounded once, and (reuse) the Result Cache's
    count."""
    g = torch.Generator(device=card).manual_seed(11)
    plain = ref.axllm_matmul_ref if kernel == "axllm_matmul" else \
        ref.reuse_matmul_ref
    ran = 0
    for m, k, n in ((17, 256, 128), (300, 200, 256), (300, 640, 256),
                    (1000, 768, 512), (4096, 2048, 768)):
        fields = _fit_group(qcfg, k)
        if fields.granularity == "per_group" and fields.group_size % 64:
            continue        # 8-row groups take the tile kernels
        ran += 1
        qt = quantize(torch.randn(k, n, generator=g, device=card)
                      * k ** -0.5, fields)
        x = torch.randn(m, k, generator=g, device=card).to(torch.bfloat16)
        assert tensor_core_path(m, x.dtype, qt)
        before = dict(_build.LAUNCHES)
        y, mults = _gemv_call(kernel, x, qt, torch.float32, True)
        torch.cuda.synchronize()
        case = f"M{m} K{k} N{n}"
        assert _build.LAUNCHES[f"{kernel}.wgmma"] == before.get(
            f"{kernel}.wgmma", 0) + 1, case
        assert _rel_err(y, plain(x, qt)) < 1e-5, case
        assert _rel_err(y, ref.quant_gemm_ref(x, qt)) < 1e-5, case
        if mults is not None:
            assert int(mults) == ref.reuse_mult_count(qt, segment(n)), case
        again, _ = _gemv_call(kernel, x, qt, torch.float32)
        assert torch.equal(again, y), case
        y16, _ = _gemv_call(kernel, x, qt, torch.bfloat16)
        assert torch.equal(y16, y.to(torch.bfloat16)), case
    assert ran > 0


@pytest.mark.parametrize("mode", ["dense", "paged-reuse"])
def test_engine_kernel_path_matches_plain_path(card, mode):
    cfg = CONFIG.reduced(dtype="float32", remat=False)
    params = get_model(cfg).init(seed=0, device=card)
    head = list(range(1, 17))
    prompts = [torch.arange(1, n + 1).numpy() for n in (8, 12, 31, 5)] + \
        [head + [40 + i, 50 + i] for i in range(4)]
    kw, impls, kernels = {}, ("cuda", "ref"), (
        "axllm_matmul", "axllm_matmul.gemv", "decode_attention",
        "flash_attention")
    if mode == "paged-reuse":
        kw = dict(paged=True, kv_block_size=8)
        impls, kernels = ("reuse", "reuse_ref"), (
            "reuse_matmul", "reuse_matmul.gemv", "paged_decode_attention",
            "flash_attention")
    runs = {}
    for impl in impls:
        eng = ServeEngine(cfg, params, n_slots=2, max_len=64, quantize=True,
                          decode_chunk=8, impl=impl, device=card, **kw)
        _build.reset_launches()
        runs[impl] = (eng.generate(prompts, max_new=16),
                      dict(_build.LAUNCHES))
    kernel_run, plain_run = (runs[i] for i in impls)
    assert kernel_run[0] == plain_run[0]
    assert sorted(kernel_run[1]) == sorted(kernels)
    assert all(kernel_run[1][k] > 0 for k in kernels)
    assert plain_run[1] == {}


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_lora_engine_kernel_path_matches_plain_path(card, paged):
    """Fused projections and a mixed batch of base and LoRA requests on
    the reuse kernels give the plain path's tokens."""
    cfg = CONFIG.reduced(dtype="float32", remat=False)
    params = get_model(cfg).init(seed=0, device=card)
    rng = np.random.default_rng(0)
    reg = AdapterRegistry(cfg, max_loras=2, device=card)
    for name in ("a0", "a1"):
        ad = {}
        for t in reg.targets:
            n_in, n_out = target_dims(cfg, t)
            ad[t] = {"lora_a": rng.standard_normal(
                (cfg.n_layers, n_in, 16)).astype(np.float32) / 4,
                "lora_b": rng.standard_normal(
                (cfg.n_layers, 16, n_out)).astype(np.float32) * 0.05}
        reg.add(name, ad)
    prompts = [torch.arange(1, n + 1).numpy() for n in (8, 12, 31, 5, 9, 20)]
    names = [None, "a0", "a1", None, "a1", "a0"]
    kw = dict(paged=True, kv_block_size=8) if paged else {}
    runs = {}
    for impl in ("reuse", "reuse_ref"):
        eng = ServeEngine(cfg, params, n_slots=2, max_len=64, quantize=True,
                          decode_chunk=8, impl=impl, fuse_qkv=True,
                          adapters=reg, device=card, **kw)
        _build.reset_launches()
        runs[impl] = (eng.generate(prompts, max_new=16, adapters=names),
                      dict(_build.LAUNCHES))
    kernels = ("reuse_matmul", "reuse_matmul.gemv", "flash_attention",
               "paged_decode_attention" if paged else "decode_attention")
    assert runs["reuse"][0] == runs["reuse_ref"][0]
    assert sorted(runs["reuse"][1]) == sorted(kernels)
    assert runs["reuse_ref"][1] == {}


# the split-K decode kernels: the seven projections' K x N and the two
# fused ones, every alphabet
GEMV_SHAPES = [(768, 768), (768, 256), (768, 2048), (2048, 768), (768, 1280),
               (768, 4096)]
GEMV_ALPHABETS = [
    QuantConfig(8), QuantConfig(4, "affine", pack=True),
    QuantConfig(4, "affine", pack=False),
    QuantConfig(8, "affine", "per_tensor"),
    QuantConfig(8, "affine", "per_group", group_size=64),
    QuantConfig(8, "affine", "per_group", group_size=128),
    QuantConfig(4, "codebook", pack=True), QuantConfig(8, "codebook")]
GEMV_IDS = ["int8", "int4", "int4-unpacked", "per-tensor", "group64",
            "group128", "nf4", "cb8"]


def _gemv_call(kernel, x, qt, out_dtype, with_stats=False):
    if kernel == "axllm_matmul":
        return axllm_matmul_cuda(x, qt, out_dtype), None
    return reuse_matmul_cuda(x, qt, with_stats, out_dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qcfg", GEMV_ALPHABETS, ids=GEMV_IDS)
@pytest.mark.parametrize("kernel", ["axllm_matmul", "reuse_matmul"])
def test_quant_gemv_kernel(card, kernel, qcfg, dtype):
    """Each decode kernel at M 1, 2, 8 and 16 and every projection shape:
    one launch of its own path key, within 1e-5 of the output scale of its
    plain version and of its split emulation, the same bits on a second
    launch, a bf16 output equal to the f32 output rounded once, and (reuse)
    the Result Cache's count."""
    g = torch.Generator(device=card).manual_seed(7)
    plain = ref.axllm_matmul_ref if kernel == "axllm_matmul" else \
        ref.reuse_matmul_ref
    for k, n in GEMV_SHAPES:
        qt = quantize(torch.randn(k, n, generator=g, device=card)
                      * k ** -0.5, qcfg)
        for m in (1, 2, 8, 16):
            x = torch.randn(m, k, generator=g, device=card).to(dtype)
            before = dict(_build.LAUNCHES)
            y, mults = _gemv_call(kernel, x, qt, torch.float32, True)
            torch.cuda.synchronize()
            case = f"M{m} K{k} N{n}"
            assert _build.LAUNCHES[kernel] == before.get(kernel, 0) + 1, case
            assert _build.LAUNCHES[f"{kernel}.gemv"] == before.get(
                f"{kernel}.gemv", 0) + 1, case
            assert y.dtype == torch.float32 and y.shape == (m, n)
            assert _rel_err(y, plain(x, qt)) < 1e-5, case
            plan = gemv_buffers(x, qt, torch.cuda.current_stream(
                card).cuda_stream, kernel == "reuse_matmul")[0]
            emu = ref.quant_gemv_split_ref(x, qt, plan,
                                           kernel == "reuse_matmul")
            assert _rel_err(y, emu) < 1e-5, case
            if mults is not None:
                assert int(mults) == ref.reuse_mult_count(qt, segment(n))
            again, _ = _gemv_call(kernel, x, qt, torch.float32)
            assert torch.equal(again, y), case
            y16, _ = _gemv_call(kernel, x, qt, torch.bfloat16)
            assert y16.dtype == torch.bfloat16
            assert torch.equal(y16, y.to(torch.bfloat16)), case


@pytest.mark.parametrize("kernel", ["axllm_matmul", "reuse_matmul"])
def test_quant_gemv_is_one_launch_a_call(card, kernel):
    """A decode call at the serving shape (M8 K768 N2048, bf16 in and
    out) runs one kernel on the card and nothing else: no cast, no sum
    kernel, no workspace memset, read from a torch.profiler trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator(device=card).manual_seed(3)
    qt = quantize(torch.randn(768, 2048, generator=g, device=card) * 0.03,
                  QuantConfig(8))
    x = torch.randn(8, 768, generator=g, device=card).to(torch.bfloat16)
    _gemv_call(kernel, x, qt, torch.bfloat16)      # plan, scratch, build
    torch.cuda.synchronize()
    # a first trace of the process may record no device events while the
    # tracer starts up: trace one call, and read a second trace
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        _gemv_call(kernel, x, qt, torch.bfloat16)
        torch.cuda.synchronize()
    before = dict(_build.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        y, _ = _gemv_call(kernel, x, qt, torch.bfloat16)
        torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16
    ops = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(ops) == 1 and "gemv" in ops[0], ops
    grown = {key: v - before.get(key, 0) for key, v in _build.LAUNCHES.items()
             if v != before.get(key, 0)}
    assert grown == {kernel: 1, f"{kernel}.gemv": 1}


def test_quant_gemv_takes_the_tile_kernel_for_unaligned_codes(card):
    """Codes the decode kernels cannot read in 16-byte vectors (N = 88)
    take the tile kernels, and give the plain version's result."""
    qt = quantize(torch.randn(192, 88, device=card), QuantConfig(8))
    x = torch.randn(8, 192, device=card)
    for kernel in ("axllm_matmul", "reuse_matmul"):
        before = dict(_build.LAUNCHES)
        y, _ = _gemv_call(kernel, x, qt, torch.float32)
        torch.cuda.synchronize()
        assert _build.LAUNCHES.get(f"{kernel}.gemv", 0) == before.get(
            f"{kernel}.gemv", 0)
        assert _rel_err(y, ref.axllm_matmul_ref(x, qt)) < 1e-5


@pytest.mark.parametrize("mode", ["dense", "paged-reuse", "nf4-reuse"])
def test_engine_tokens_pass_the_token_gate(card, mode):
    """A bf16 reduced model served through the kernels: every greedy
    token's plain-path logit (teacher-forced on the kernel path's own
    prefix) lies within twice the logits tolerance of the plain maximum;
    the decode steps ran the split-K kernels, and the NF4 engine's
    prefill waves the codebook route of the tensor cores."""
    cfg = CONFIG.reduced(remat=False)
    assert cfg.dtype == "bfloat16"
    params = get_model(cfg).init(seed=0, device=card)
    rng = np.random.default_rng(1)
    head = rng.integers(0, cfg.vocab_size, size=16).astype(np.int32)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (8, 12, 31, 5)] + [
        np.concatenate([head, rng.integers(0, cfg.vocab_size, size=3 + i)
                        .astype(np.int32)]) for i in range(4)]
    kw, impl, plain, gemv = {}, "cuda", "ref", "axllm_matmul.gemv"
    if mode == "paged-reuse":
        kw, impl, plain, gemv = (dict(paged=True, kv_block_size=8), "reuse",
                                 "reuse_ref", "reuse_matmul.gemv")
    if mode == "nf4-reuse":
        kw, impl, plain, gemv = (dict(quant_bits=4, quant_mode="codebook"),
                                 "reuse", "reuse_ref", "reuse_matmul.gemv")
    eng = ServeEngine(cfg, params, n_slots=4, max_len=64, quantize=True,
                      decode_chunk=8, impl=impl, device=card, **kw)
    _build.reset_launches()
    toks = eng.generate(prompts, max_new=24)
    assert _build.LAUNCHES[gemv] > 0
    if mode == "nf4-reuse":     # every matmul launch on wgmma or gemv
        launches = dict(_build.LAUNCHES)
        assert launches["reuse_matmul.wgmma"] > 0
        assert launches["reuse_matmul"] == launches["reuse_matmul.wgmma"] \
            + launches["reuse_matmul.gemv"]
    gate = token_gate(cfg, eng.params, prompts, toks, impl=plain,
                      tol_rel=5e-2, device=card)
    assert gate.positions == 24 * len(prompts)
    assert gate.ok, gate.failures[:5]


def test_overload_engine_tokens_pass_the_token_gate(card):
    """A bf16 reduced paged engine under a prefill budget, with all but 12
    free pool blocks held outside it: it preempts, restores as often,
    chunks its prefill, keeps its books after every step, launches the
    paged decode kernel, and every generated token passes the token
    gate."""
    cfg = CONFIG.reduced(remat=False)
    params = get_model(cfg).init(seed=0, device=card)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (8, 12, 31, 5, 20, 31, 9, 16)]
    eng = ServeEngine(cfg, params, n_slots=4, max_len=64, quantize=True,
                      decode_chunk=4, paged=True, kv_block_size=8,
                      prefill_budget=16, device=card)
    held = [eng.pager.alloc() for _ in range(len(eng.pager._free) - 12)]
    for p in prompts:
        eng.submit(p, max_new=24)
    _build.reset_launches()
    while eng.step():
        eng.pager.check_consistency(external=held)
    st = eng.stats
    assert st.preempted > 0 and st.restored == st.preempted
    assert st.prefill_chunks > st.prefill_waves
    assert _build.LAUNCHES["paged_decode_attention"] > 0
    done = {r.rid: r for r in eng.finished}
    assert [done[i].finish_reason for i in range(len(prompts))] == \
        ["max_new"] * len(prompts)
    gate = token_gate(cfg, eng.params, prompts,
                      [done[i].tokens for i in range(len(prompts))],
                      impl="ref", tol_rel=5e-2, device=card)
    assert gate.positions == 24 * len(prompts)
    assert gate.ok, gate.failures[:5]


def test_chaos_scenarios_on_the_card(card):
    """The eight chaos scenarios through the kernels: no request lost, no
    block or pin leaked, the pager consistent after every step (the
    harness checks it), and any request whose tokens differ from the
    card's own fault-free run within the token gate."""
    from repro_torch.serve import chaos
    from repro_torch.serve.adapters import make_synthetic_adapters
    for rep in chaos.run(smoke=True, device=card):
        assert rep.lost == 0 and not rep.errors, (rep.scenario, rep.errors)
        for m in rep.mismatches:
            registry = None if m["adapter"] is None else \
                make_synthetic_adapters(chaos.CFG, 2, device=card)[0]
            gate = token_gate(chaos.CFG, rep.engine.params, [m["prompt"]],
                              [m["tokens"]], impl="ref", tol_rel=5e-2,
                              device=card, registry=registry,
                              names=[m["adapter"]])
            assert gate.ok, (rep.scenario, m["rid"], gate.failures[:5])


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_speculative_engine_matches_target_only_on_the_card(card, paged):
    """A bf16 reduced int8 engine with a packed-int4 draft, dense and
    paged: its greedy tokens equal the target-only engine's on the card,
    every emitted token past the prefill's came from a round, the draft's
    decode took the split-K kernel on int4 codes, and (paged) the pager's
    books hold after every step."""
    cfg = CONFIG.reduced(remat=False)
    params = get_model(cfg).init(seed=0, device=card)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (8, 12, 31, 5, 20, 16)]
    kw = dict(n_slots=4, max_len=64, quantize=True, decode_chunk=8,
              device=card)
    if paged:
        kw.update(paged=True, kv_block_size=8)
    want = ServeEngine(cfg, params, **kw).generate(prompts, max_new=24)
    eng = ServeEngine(cfg, params, speculate=True, spec_k=4, draft_bits=4,
                      **kw)
    assert eng.draft_params["layers"]["attn"]["wq"].packed
    for p in prompts:
        eng.submit(p, max_new=24)
    _build.reset_launches()
    while eng.step():
        if paged:
            eng.pager.check_consistency()
    done = {r.rid: r.tokens for r in eng.finished}
    assert [done[i] for i in range(len(prompts))] == want
    assert eng.stats.spec_emitted_tokens == \
        sum(len(t) for t in want) - len(prompts)
    launches = dict(_build.LAUNCHES)
    assert launches["axllm_matmul.gemv"] > 0
    assert launches["decode_attention"] > 0
    if paged:
        assert launches["paged_decode_attention"] > 0
        assert eng.pager.blocks_in_use == eng.pager.evictable_blocks()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,causal", [(128, 128, True), (50, 190, True),
                                          (50, 190, False)])
def test_flash_attention_simt_head_dim_16(card, sq, sk, causal, dtype):
    """Head dim 16 (the chaos harness's model) takes the SIMT kernel."""
    g = torch.Generator(device=card).manual_seed(sq + 16)
    q = torch.randn(2, sq, 4, 16, generator=g, device=card).to(dtype)
    k = torch.randn(2, sk, 2, 16, generator=g, device=card).to(dtype)
    v = torch.randn(2, sk, 2, 16, generator=g, device=card).to(dtype)
    assert not flash_attention_tensor_core_path(q)
    out = flash_attention_cuda(q, k, v, causal)
    torch.cuda.synchronize()
    assert _rel_err(out, ref.attention_ref(q, k, v, causal)) < _tol(dtype)


def test_moe_engine_kernel_path_matches_plain_path(card):
    """The reduced qwen2-moe (f32, int8 weights) served paged, on the reuse
    kernels and speculating (an int4 draft) gives the plain path's
    tokens; the expert banks are dequantized products, every projection a
    kernel."""
    cfg = get_config("qwen2-moe-a2.7b").reduced(dtype="float32",
                                                remat=False)
    params = get_model(cfg).init(seed=0, device=card)
    rng = np.random.default_rng(5)
    head = list(rng.integers(0, cfg.vocab_size, size=16))
    heads = [np.array(head + [40 + i, 50 + i], np.int32) for i in range(3)]
    # one head-sharing prompt a wave: the first publishes what the others hit
    prompts = [heads[0]] + [rng.integers(0, cfg.vocab_size, size=n).astype(
        np.int32) for n in (8, 12)] + [heads[1], rng.integers(
            0, cfg.vocab_size, size=31).astype(np.int32), heads[2]]
    runs = {}
    for impl in ("reuse", "reuse_ref"):
        eng = ServeEngine(cfg, params, n_slots=3, max_len=64, quantize=True,
                          decode_chunk=4, impl=impl, paged=True,
                          kv_block_size=8, speculate=True, spec_k=4,
                          device=card)
        _build.reset_launches()
        runs[impl] = (eng.generate(prompts, max_new=12),
                      dict(_build.LAUNCHES), eng.stats)
    (got, launches, st), (want, plain, _) = runs["reuse"], runs["reuse_ref"]
    assert got == want
    assert st.spec_rounds > 0 and st.prefix_hit_tokens > 0
    for name in ("reuse_matmul", "reuse_matmul.gemv",
                 "paged_decode_attention", "decode_attention",
                 "flash_attention"):
        assert launches.get(name, 0) > 0, name
    assert plain == {}


@pytest.mark.parametrize("dtype,path", [
    (torch.float32, "simt"), (torch.bfloat16, "simt"),
    (torch.bfloat16, "wgmma")], ids=["f32-simt", "bf16-simt", "bf16-wgmma"])
@pytest.mark.parametrize("b,sq,sk", [(2, 200, 70), (3, 12, 9), (1, 300, 64)])
def test_flash_attention_non_causal_sq_above_sk(card, b, sq, sk, dtype,
                                                path):
    """Whisper's cross-attention under a decoder prompt longer than the
    frames: non-causal with Sq > Sk on both kernels (every query sees
    every key; no causal offset), against the plain version (and the
    tensor-core kernel against its emulation). A causal call at Sq > Sk
    still raises."""
    h, hk = 12, 12 if sk == 9 else 4
    g = torch.Generator(device=card).manual_seed(sq + sk)
    q = torch.randn(b, sq, h, 64, generator=g, device=card).to(dtype)
    k = torch.randn(b, sk, hk, 64, generator=g, device=card).to(dtype)
    v = torch.randn(b, sk, hk, 64, generator=g, device=card).to(dtype)
    out = flash_attention_launch(q, k, v, False, path == "wgmma")
    torch.cuda.synchronize()
    assert _rel_err(out, ref.attention_ref(q, k, v, False)) < _tol(dtype)
    if path == "wgmma":
        emu = ref.flash_attention_tc_ref(q.float(), k.float(), v.float(),
                                         False)
        assert _rel_err(out, emu) < 2.0 ** -8
    with pytest.raises(ValueError, match="Sq <= Sk"):
        flash_attention_cuda(q, k, v, True)


@pytest.mark.parametrize("sq", [1500, 200], ids=["encoder", "cross"])
def test_flash_attention_whisper_f32_shapes(card, sq):
    """Whisper-small's f32 flash calls on the SIMT kernel, non-causal,
    H12 d64 over 1500 frames: the encoder's self-attention (Sq = Sk =
    1500, not a multiple of the tile) and a prefill's cross-attention (Sq
    200), held to 1e-5 of the scale against the plain version."""
    g = torch.Generator(device=card).manual_seed(sq)
    q = torch.randn(2, sq, 12, 64, generator=g, device=card)
    k = torch.randn(2, 1500, 12, 64, generator=g, device=card)
    v = torch.randn(2, 1500, 12, 64, generator=g, device=card)
    assert not flash_attention_tensor_core_path(q)
    before = dict(_build.LAUNCHES)
    out = flash_attention_cuda(q, k, v, False)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention"] == \
        before.get("flash_attention", 0) + 1
    assert _build.LAUNCHES.get("flash_attention.wgmma", 0) == \
        before.get("flash_attention.wgmma", 0)
    assert _rel_err(out, ref.attention_ref(q, k, v, False)) < 1e-5


def test_decode_attention_whisper_cross_cache(card):
    """Whisper's cross-attention at decode: bf16, H12 Hk12 d64 over a dense
    cache of S = 1500 frames at full length on every row; against the
    split emulation and the plain version."""
    b, s, h, hk, d = 8, 1500, 12, 12, 64
    q, kc, vc, _, _ = _decode_split_case(card, False, torch.bfloat16, b, s,
                                         h, hk, d, 15)
    length = torch.full((b,), s, dtype=torch.int32, device=card)
    n_split, split_len = decode_split_plan(s, plan_rows(b, h, hk),
                                           _build.sm_count(card))
    out = decode_attention_cuda(q, kc, vc, length)
    torch.cuda.synchronize()
    emu = ref.decode_attention_split_ref(q, kc, vc, length, None, None,
                                         n_split, split_len)
    assert _rel_err(out, emu) < _emu_tol(torch.bfloat16)
    assert _rel_err(out, ref.decode_attention_ref(q, kc, vc, length)) < \
        _tol(torch.bfloat16)


@pytest.mark.parametrize("m,dtype", [(12000, torch.float32),
                                     (37, torch.float32),
                                     (8, torch.float32), (8, torch.bfloat16)])
def test_axllm_matmul_whisper_frontend_k80(card, m, dtype):
    """Whisper's frontend projection: K = 80 frame features (not a
    multiple of any K tile) to N768, int8 per channel. f32 activations at
    a wave's M = 8 x 1500 take the tile kernel; M <= 16 the split-K decode
    kernel; held against the plain version."""
    g = torch.Generator(device=card).manual_seed(m)
    x = torch.randn(m, 80, generator=g, device=card).to(dtype)
    qt = quantize(torch.randn(80, 768, generator=g, device=card) * 0.1,
                  QuantConfig(8))
    path = axllm_kernel.matmul_path(m, dtype, qt)
    assert path == ("gemv" if m <= 16 else "tile")
    before = dict(_build.LAUNCHES)
    y = axllm_matmul_cuda(x, qt)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["axllm_matmul"] == \
        before.get("axllm_matmul", 0) + 1
    assert _rel_err(y, ref.axllm_matmul_ref(x, qt)) < 1e-5


def test_audio_model_kernel_path_matches_plain_path(card):
    """The reduced whisper-small (bf16, int8 weights): a ragged prefill
    whose longest decoder prompt (80 tokens) is longer than its 64 frames
    (cross-attention at Sq > Sk on the kernel) and 6 decode steps through
    the kernels, against the plain path's logits within 5e-2 of the
    scale; the greedy tokens pass the token gate on their own frames."""
    from repro_torch.core.axllm_linear import deploy_quantize
    from repro_torch.serve.decode import decode_steps
    cfg = get_config("whisper-small").reduced(remat=False)
    assert cfg.dtype == "bfloat16"
    params = deploy_quantize(get_model(cfg).init(seed=0, device=card),
                             QuantConfig(8))
    g = torch.Generator(device=card).manual_seed(4)
    b, lens = 3, [80, 16, 40]
    frames = torch.randn(b, cfg.enc_seq, cfg.d_feat, generator=g,
                         device=card)
    toks = torch.randint(0, cfg.vocab_size, (b, max(lens)), generator=g,
                         device=card, dtype=torch.int32)
    lengths = torch.tensor(lens, dtype=torch.int32, device=card)
    out = {}
    for impl in ("auto", "ref"):
        api = get_model(cfg, impl=impl)
        _build.reset_launches()
        logits, cache = api.prefill(params, {"frames": frames,
                                             "tokens": toks},
                                    api.init_cache(b, 128, card),
                                    lengths=lengths)
        first = torch.argmax(logits[:, :cfg.vocab_size], -1).to(torch.int32)
        chunk = decode_steps(api.decode, params, first, cache, None,
                             torch.zeros(b, dtype=torch.bool, device=card),
                             torch.ones(b, dtype=torch.int32, device=card),
                             torch.full((b,), 7, dtype=torch.int32,
                                        device=card), n=6,
                             vocab_size=cfg.vocab_size, max_len=128)
        out[impl] = (logits, first, chunk.tokens, dict(_build.LAUNCHES))
    logits, first, steps, launches = out["auto"]
    assert _rel_err(logits, out["ref"][0]) < 5e-2
    for name in ("axllm_matmul", "axllm_matmul.gemv", "flash_attention",
                 "decode_attention"):
        assert launches.get(name, 0) > 0, name
    assert out["ref"][3] == {}
    prompts = [toks[i, :n].cpu().numpy() for i, n in enumerate(lens)]
    generated = [[int(first[i])] + steps[:, i].tolist() for i in range(b)]
    gate = token_gate(cfg, params, prompts, generated, impl="ref",
                      tol_rel=5e-2, device=card, frames=list(frames))
    assert gate.ok, gate.failures[:5]


# -- training: the flash backward kernel and the step on the card ------------

# (B, Sq, Sk, H, Hk, d, causal): the training step's GQA 3, the families'
# 1, 8 and 16, head dims 16 to 128, ragged lengths, whisper's non-causal
# Sq < Sk and Sq > Sk
BWD_CASES = [(2, 256, 256, 12, 4, 64, True), (1, 130, 130, 16, 16, 128, True),
             (1, 200, 200, 64, 8, 128, True), (1, 96, 96, 32, 2, 128, True),
             (2, 70, 190, 4, 2, 16, True), (2, 33, 33, 6, 2, 32, True),
             (1, 200, 1500, 12, 12, 64, False),
             (2, 200, 64, 12, 12, 64, False),
             (1, 1, 40, 4, 4, 64, True)]


def _bwd_inputs(card, case, dtype, seed):
    b, sq, sk, h, hk, d, _ = case
    g = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn(b, sq, h, d, generator=g, device=card).to(dtype)
    k = torch.randn(b, sk, hk, d, generator=g, device=card).to(dtype)
    v = torch.randn(b, sk, hk, d, generator=g, device=card).to(dtype)
    do = torch.randn(b, sq, h, d, generator=g, device=card).to(dtype)
    return q, k, v, do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", BWD_CASES, ids=[
    "B{}-Sq{}-Sk{}-H{}-Hk{}-d{}-{}".format(*c[:6], "causal" if c[6]
                                           else "full") for c in BWD_CASES])
def test_flash_attention_bwd_kernel(card, case, dtype):
    """The backward kernel against its plain version on the same q, k, v,
    o (the forward kernel's) and dO: within 1e-5 of each gradient's scale
    in f32, 1e-2 in bf16 (one rounding of the output); a second launch
    gives the same bits; one launch a call."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    q, k, v, do = _bwd_inputs(card, case, dtype, sum(case[:6]))
    causal = case[-1]
    o = flash_attention_cuda(q, k, v, causal)
    before = _build.LAUNCHES["flash_attention_bwd"]
    got = flash_attention_bwd_cuda(q, k, v, o, do, causal)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention_bwd"] == before + 1
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, causal)
    again = flash_attention_bwd_cuda(q, k, v, o, do, causal)
    for g_, w, a in zip(got, want, again):
        assert g_.dtype == dtype and g_.shape == w.shape
        assert bool(torch.isfinite(g_.float()).all())
        assert _rel_err(g_, w) < _tol(dtype)
        assert torch.equal(g_, a)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32-simt", "bf16-wgmma"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_attention_fn_gradients(card, dtype, causal):
    """``ops.flash_attention`` under autograd takes ``FlashAttentionFn``
    (forward kernel, then the backward kernel): its gradients against
    autograd of the plain path, to 1e-5 of the scale in f32 and 2e-2 in
    bf16 (the tensor-core forward rounds P to bf16 before P V; the
    backward recomputes P in f32). Under ``inference_mode`` the same call
    launches the forward alone."""
    from repro_torch.kernels import ops
    case = (2, 128, 128, 12, 4, 64, causal)
    q, k, v, do = _bwd_inputs(card, case, dtype, 7)
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(ops.flash_attention(*plain, causal=causal,
                                                   impl="ref"), plain, do)
    kern = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = dict(_build.LAUNCHES)
    out = ops.flash_attention(*kern, causal=causal)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, kern, do)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention"] == before.get(
        "flash_attention", 0) + 1
    assert _build.LAUNCHES["flash_attention_bwd"] == before.get(
        "flash_attention_bwd", 0) + 1
    for g_, w in zip(got, want):
        assert _rel_err(g_, w) < (1e-5 if dtype == torch.float32 else 2e-2)
        assert bool((g_ != 0).any())
    with torch.inference_mode():
        served = ops.flash_attention(*kern, causal=causal)
    assert served.grad_fn is None
    assert _build.LAUNCHES["flash_attention_bwd"] == before.get(
        "flash_attention_bwd", 0) + 1


def test_flash_attention_bwd_refusals(card):
    """The backward wrapper checks like the forward's and launches
    nothing for what the kernel does not take."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    q, k, v, do = _bwd_inputs(card, (1, 16, 16, 4, 2, 64, True),
                              torch.float32, 1)
    o = flash_attention_cuda(q, k, v, True)
    before = _build.LAUNCHES["flash_attention_bwd"]
    with pytest.raises(ValueError):      # causal Sq > Sk
        flash_attention_bwd_cuda(q, k[:, :8], v[:, :8], o, do, True)
    with pytest.raises(ValueError):      # dO of another shape
        flash_attention_bwd_cuda(q, k, v, o, do[:, :8].contiguous(), True)
    with pytest.raises(ValueError):      # dO of another dtype
        flash_attention_bwd_cuda(q, k, v, o, do.to(torch.bfloat16), True)
    with pytest.raises(ValueError):      # a non-contiguous dO
        flash_attention_bwd_cuda(q, k, v, o, do.transpose(1, 2)
                                 .contiguous().transpose(1, 2), True)
    with pytest.raises(ValueError):      # head dim 48
        flash_attention_bwd_cuda(q[..., :48].contiguous(),
                                 k[..., :48].contiguous(),
                                 v[..., :48].contiguous(),
                                 o[..., :48].contiguous(),
                                 do[..., :48].contiguous(), True)
    assert _build.LAUNCHES["flash_attention_bwd"] == before


def _grad_close(got, want, tol):
    """A gradient leaf of the kernel path against the plain path's: not
    all zero where the plain one is not, zero in at most 1 in 1000
    entries where the plain one is nonzero, and within ``tol`` of the
    plain leaf's largest entry."""
    got, want = got.float(), want.float()
    scale = float(want.abs().max())
    assert bool(got.any()) or scale == 0.0
    lost = ((got == 0) & (want != 0)).float().mean()
    assert float(lost) <= 1e-3
    assert float((got - want).abs().max()) <= tol * max(scale, 1e-30)


def test_train_step_on_card_matches_plain_and_repeats(card):
    """One training step of a reduced bf16 repro-100m (remat on) through
    the kernels against the same step through the plain path on the card
    (``_grad_close`` at 5e-2: bf16 activations, the forward's P in bf16);
    under the launcher's deterministic mode two steps give the same
    bits."""
    from repro_torch.launch.train import deterministic
    from repro_torch.optim import adamw
    from repro_torch.train.loop import _grad_fn, make_train_step
    cfg = CONFIG.reduced(head_dim=64, n_heads=4, n_kv_heads=2)
    assert cfg.dtype == "bfloat16" and cfg.remat
    params = get_model(cfg).init(seed=0, device=card)
    g = torch.Generator(device=card).manual_seed(3)
    tok = torch.randint(0, cfg.vocab_size, (4, 128), generator=g,
                        device=card, dtype=torch.int32)
    batch = {"tokens": tok, "targets": torch.roll(tok, -1, 1)}
    with deterministic():
        before = dict(_build.LAUNCHES)
        _, got = _grad_fn(get_model(cfg))(params, batch)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["flash_attention_bwd"] == before.get(
            "flash_attention_bwd", 0) + cfg.n_layers
        # remat: each layer's forward runs twice
        assert _build.LAUNCHES["flash_attention"] == before.get(
            "flash_attention", 0) + 2 * cfg.n_layers
        _, want = _grad_fn(get_model(cfg, impl="ref"))(params, batch)
        for a, b in zip(adamw.tree_leaves(got), adamw.tree_leaves(want)):
            _grad_close(a, b, 5e-2)
        ocfg = adamw.AdamWConfig(lr=1e-3)
        step = make_train_step(get_model(cfg), ocfg, total_steps=10,
                               warmup=2)
        outs = [step(params, adamw.init(params, ocfg), batch, 1)
                for _ in range(2)]
    for a, b in zip(adamw.tree_leaves(outs[0][:2]),
                    adamw.tree_leaves(outs[1][:2])):
        assert torch.equal(a, b)


def _seqsharded_case(lengths, quantized, seed=0):
    b, s, h, hk, d = len(lengths), 32, 4, 2, 16
    rng = np.random.default_rng(seed)
    c = dict(q=rng.normal(size=(b, h, d)).astype(np.float32))
    if quantized:
        for k, shape in (("k", (b, s, hk, d)), ("v", (b, s, hk, d)),
                         ("nk", (b, hk, d)), ("nv", (b, hk, d))):
            c[k] = rng.integers(-127, 128, size=shape).astype(np.int8)
        for k, shape in (("ks", (b, s, hk, 1)), ("vs", (b, s, hk, 1)),
                         ("nks", (b, hk, 1)), ("nvs", (b, hk, 1))):
            c[k] = rng.uniform(0.01, 0.05, size=shape).astype(np.float32)
    else:
        for k, shape in (("k", (b, s, hk, d)), ("v", (b, s, hk, d)),
                         ("nk", (b, hk, d)), ("nv", (b, hk, d))):
            c[k] = rng.normal(size=shape).astype(np.float32)
    c["length"] = np.asarray(lengths, np.int32)
    c["pos"] = c["length"] - 1
    return c


def test_sharded_decode_on_shared_card_matches_cpu(card):
    """``decode_attention_seqsharded`` on 2 ranks sharing the card (gloo
    carrying CUDA tensors: all-reduce MAX and SUM) against the same ranks
    on the CPU: int8 codes and bf16 K/V, a length-0 row exactly 0. The
    caches' rows are bit-equal; the outputs agree within 1e-5 of the
    scale (f32 sums in other orders; the bf16 case within one bf16
    rounding, 1e-2)."""
    import torch_tp_ranks
    from repro_torch.launch.mesh import run_ranks
    cases = [(_seqsharded_case([5, 32, 0, 1], True), "float32"),
             (_seqsharded_case([0, 9, 32, 17], False, seed=1), "bfloat16")]
    got = run_ranks(torch_tp_ranks.run_jobs, 2, "cuda",
                    [("seqsharded", (cases,))])
    want = run_ranks(torch_tp_ranks.run_jobs, 2, "cpu",
                     [("seqsharded", (cases,))], threads=1)
    for rank in range(2):
        for (_, dtype), g, w in zip(cases, got[rank][0], want[rank][0]):
            for gc, wc in zip(g[1:], w[1:]):
                np.testing.assert_array_equal(gc, wc)
            tol = 1e-2 if dtype == "bfloat16" else 1e-5
            assert _rel_err(torch.from_numpy(g[0]),
                            torch.from_numpy(w[0])) < tol
    assert np.all(got[0][0][0][0][2] == 0)      # the length-0 row
    assert np.all(got[0][0][1][0][0] == 0)


def test_mesh_engine_on_shared_card_passes_the_token_gate(card):
    """A reduced bf16 repro-100m at mesh 1x2, both ranks on the card over
    gloo: every rank serves the same tokens, launches the matmul's `.gemv`
    and `.wgmma` entry points, decode attention and flash at its shapes,
    and every token passes the token gate on the unsharded model."""
    import torch_tp_ranks
    from repro_torch.launch.mesh import run_ranks
    cfg = CONFIG.reduced(remat=False)
    lens = (8, 12, 31, 5, 40, 17)
    modes = {"int8": dict(quantize=True, decode_chunk=8)}
    res = run_ranks(torch_tp_ranks.run_jobs, 2, "cuda",
                    [("serve_modes", (cfg, 0, modes, lens, 24))])
    got = [r[0]["int8"] for r in res]
    assert got[0]["tokens"] == got[1]["tokens"]
    assert got[0]["layout"]["heads"] and got[0]["layout"]["kv_heads"]
    for r in got:
        for name in ("axllm_matmul.gemv", "axllm_matmul.wgmma",
                     "decode_attention", "flash_attention"):
            assert r["launches"].get(name, 0) > 0, (name, r["launches"])
    params = get_model(cfg).init(seed=0, device=card)
    plain = ServeEngine(cfg, params, n_slots=2, max_len=64, quantize=True,
                        device=card)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in lens]
    gate = token_gate(cfg, plain.params, prompts, got[0]["tokens"],
                      impl="ref", tol_rel=5e-2, device=card)
    assert gate.positions == sum(map(len, got[0]["tokens"]))
    assert gate.ok, gate.failures[:5]
