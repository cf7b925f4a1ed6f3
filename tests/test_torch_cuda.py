"""Card tests: each hand-written CUDA kernel against its plain version on
an NVIDIA GPU, and the engine's kernel path against its plain path.

Marked ``cuda``; each test decides inside the ``card`` fixture whether a
card exists and skips with the reason where none does. Run them on the
card with ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.

Tolerances: float32 kernels agree with the plain versions to 1e-5
relative to the output scale (other summation orders); bfloat16 outputs
to 1e-2 of the scale (one bfloat16 rounding of the result, 2^-8).
"""

import pytest
import torch

from repro_torch.configs.repro_100m import CONFIG
from repro_torch.core.quantization import QuantConfig, quantize
from repro_torch.kernels import _build, ref
from repro_torch.kernels.axllm_matmul import axllm_matmul_cuda
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.models.model import get_model
from repro_torch.serve.engine import ServeEngine

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qcfg", [
    QuantConfig(8), QuantConfig(8, "affine", "per_group", group_size=64),
    QuantConfig(4, "affine", pack=True), QuantConfig(4, "codebook")],
    ids=["int8", "int8-group", "int4", "nf4"])
@pytest.mark.parametrize("m", [8, 37, 300])
def test_axllm_matmul_kernel(card, m, qcfg, dtype):
    g = torch.Generator(device=card).manual_seed(m)
    x = torch.randn(m, 192, generator=g, device=card).to(dtype)
    qt = quantize(torch.randn(192, 96, generator=g, device=card), qcfg)
    before = _build.LAUNCHES["axllm_matmul"]
    y = axllm_matmul_cuda(x, qt)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["axllm_matmul"] == before + 1
    # f32 output either way: the sums run in f32 over the same inputs
    assert _rel_err(y, ref.axllm_matmul_ref(x, qt)) < 1e-5


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,causal", [(128, 128, True), (70, 70, True),
                                          (50, 190, True), (50, 190, False)])
def test_flash_attention_kernel(card, sq, sk, causal, dtype):
    g = torch.Generator(device=card).manual_seed(sq)
    q = torch.randn(2, sq, 12, 64, generator=g, device=card).to(dtype)
    k = torch.randn(2, sk, 4, 64, generator=g, device=card).to(dtype)
    v = torch.randn(2, sk, 4, 64, generator=g, device=card).to(dtype)
    out = flash_attention_cuda(q, k, v, causal)
    torch.cuda.synchronize()
    want = ref.attention_ref(q, k, v, causal)
    assert _rel_err(out, want) < _tol(dtype)


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


def test_engine_kernel_path_matches_plain_path(card):
    cfg = CONFIG.reduced(dtype="float32", remat=False)
    params = get_model(cfg).init(seed=0, device=card)
    prompts = [torch.arange(1, n + 1).numpy() for n in (8, 12, 31, 5)]
    runs = {}
    for impl in ("cuda", "ref"):
        eng = ServeEngine(cfg, params, n_slots=2, max_len=64, quantize=True,
                          decode_chunk=8, impl=impl, device=card)
        _build.reset_launches()
        runs[impl] = (eng.generate(prompts, max_new=16),
                      dict(_build.LAUNCHES))
    assert runs["cuda"][0] == runs["ref"][0]
    assert all(runs["cuda"][1][k] > 0 for k in _build.SIGNATURES)
    assert runs["ref"][1] == {}
