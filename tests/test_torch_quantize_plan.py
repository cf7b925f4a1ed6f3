"""The quantization kernel's launch plan (``kernels.quantize.quantize_plan``,
a function of shapes only): for the shapes the port quantizes (the PERF.md
table's, every projection leaf of full-width repro-100m) and ragged ones,
the plan's splits cover K exactly once, its clusters and shared memory fit
the card, its access width divides the rows of w and of the codes, and the
grid fills 132 SMs where the matrix has the bytes for it. The kernel
itself runs only on the card (``tests/test_torch_cuda.py``)."""

import pytest
import torch

from repro_torch.configs.repro_100m import CONFIG
from repro_torch.kernels import quantize as Q
from repro_torch.kernels.quantize import quantize_plan

SMS = 132
# (batch, K, N): single matrices of the kernel phase
TABLE = [(1, 768, 2048), (1, 768, 768), (1, 768, 256), (1, 2048, 768),
         (1, 8192, 2048)]
_D, _F = CONFIG.d_model, CONFIG.d_ff
_Q, _KV = CONFIG.n_heads * CONFIG.head_dim, CONFIG.n_kv_heads * CONFIG.head_dim
# the stacked projection leaves of the deploy pass: wq, wk/wv, wo, gate/up,
# down
DEPLOY = sorted({(CONFIG.n_layers, _D, _Q), (CONFIG.n_layers, _D, _KV),
                 (CONFIG.n_layers, _Q, _D), (CONFIG.n_layers, _D, _F),
                 (CONFIG.n_layers, _F, _D)})
RAGGED = [(2, 300, 100), (3, 300, 130), (2, 70, 37), (3, 9, 64),
          (1, 8192, 130), (1, 65536, 96), (1, 1, 1), (4, 63, 17)]
DTYPES = [torch.float32, torch.bfloat16]


def _id(s):
    return "x".join(map(str, s))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", TABLE + DEPLOY + RAGGED, ids=_id)
def test_plan_fits_shapes_and_card(shape, dtype):
    b, k, n = shape
    p = quantize_plan(b, k, n, dtype, SMS)
    elem = 2 if dtype == torch.bfloat16 else 4
    # the splits cover K exactly once, none of them empty
    ranges = p.k_ranges()
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(a < b_ for a, b_ in ranges)
    assert all(r[1] == s[0] for r, s in zip(ranges, ranges[1:]))
    assert 1 <= p.cluster <= 16
    assert p.smem <= 227 * 1024
    # the access width divides the row strides of w and of the codes
    assert n % p.vec == 0
    assert (n * elem) % p.piece == 0 and p.piece <= 16
    assert p.strip % p.vec == 0 and (p.strip * elem) % 16 == 0
    assert p.strips * p.strip >= n > (p.strips - 1) * p.strip
    chunk = p.chunk_rows * p.strip * elem
    if p.held:
        assert p.chunk_rows == p.rows
        assert chunk <= Q.STASH_BYTES and p.smem > Q.HELD_SLOTS * chunk
    else:
        assert p.chunk_rows < p.rows and p.smem > Q.RING * chunk


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(1, 8192, 2048)] + DEPLOY, ids=_id)
def test_plan_fills_the_card(shape, dtype):
    """At K8192 N2048 and every deploy leaf the grid has a block for every
    SM, and each weight is read once (the held route)."""
    p = quantize_plan(*shape, dtype, SMS)
    assert p.blocks >= SMS
    assert p.route == "held"


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_plan_streams_where_a_cluster_cannot_hold_k(dtype):
    """K65536 N96: a strip of K is more than 16 blocks hold in their shared
    memory budget, so the blocks stream their slices; K is not capped."""
    p = quantize_plan(1, 65536, 96, dtype, SMS)
    assert p.route == "streamed" and p.cluster == 16
    assert p.rows * p.strip * (2 if dtype == torch.bfloat16 else 4) \
        > Q.STASH_BYTES
    elem = 2 if dtype == torch.bfloat16 else 4
    assert p.chunk_rows * p.strip * elem <= Q.CHUNK_BYTES


@pytest.mark.parametrize("n,dtype,align,vec", [
    (2048, torch.bfloat16, 16, 16), (96, torch.float32, 16, 16),
    (100, torch.bfloat16, 16, 4), (130, torch.float32, 16, 2),
    (37, torch.bfloat16, 16, 1), (2048, torch.bfloat16, 8, 4),
    (2048, torch.float32, 4, 1), (2048, torch.bfloat16, 2, 1)])
def test_plan_access_width(n, dtype, align, vec):
    """16 columns an access where N and w's address allow (a 16-byte load
    of f32 or two of bf16, one 16-byte store of codes), else the widest
    that divides both."""
    p = quantize_plan(1, 256, n, dtype, SMS, align)
    assert p.vec == vec
    assert align % p.piece == 0


def test_plan_is_cached_and_checked():
    assert quantize_plan(12, 768, 2048, torch.bfloat16) is quantize_plan(
        12, 768, 2048, torch.bfloat16)
    with pytest.raises(TypeError):
        quantize_plan(1, 8, 8, torch.float16)
    with pytest.raises(ValueError):
        quantize_plan(1, 0, 8, torch.float32)
