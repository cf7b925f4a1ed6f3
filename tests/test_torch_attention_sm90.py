"""The redesigned attention kernels on the CPU: the tensor-core flash
kernel's arithmetic (``ref.flash_attention_tc_ref``: per 64-row query
tile, per key tile, P rounded to bf16 before P V) and the split-KV decode
body's
(``ref.decode_attention_split_ref`` and its paged form: per-split
partials, an empty split weighing 0), each against the JAX package on the
same numpy inputs; and the host-side choices made before a launch
(``tensor_core_path``, the decode split plan) as functions of shapes
alone.

Tolerances: the flash emulation rounds P to bf16 where JAX keeps f32, so
it agrees with JAX's oracle and interpret-mode kernel within 2^-8 of the
output scale. The decode emulation runs in f32 on bf16-valued (or int8)
inputs and differs from JAX only in the order of f32 additions and in
exp2 of log2-scaled scores for exp: within 1e-5 of the output scale, and
within 2^-8 when its output is rounded to bf16. A length-0 row must be
exactly 0.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.decode_attention import (SPLIT_KEYS, TABLE,
                                                  split_buffers, split_plan)

FLASH_TOL = 2.0 ** -8
DECODE_TOL = 1e-5


def _bf16_valued(rng, shape):
    """f32 numpy values that bf16 holds exactly."""
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.to(torch.bfloat16).to(torch.float32).numpy()


def _within_scale(got, want, tol):
    got = np.asarray(torch.as_tensor(got).float(), np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


# ---------------------------------------------------------------------------
# flash attention, tensor-core path
# ---------------------------------------------------------------------------

# (B, Sq, Sk, H, Hk, d, causal): one full tile, ragged Sq = Sk, Sq < Sk
# ragged against both tiles, non-causal, more than one query tile, d = 128
FLASH_CASES = [
    (2, 64, 64, 4, 2, 64, True),
    (1, 70, 70, 4, 2, 64, True),
    (1, 50, 190, 4, 2, 64, True),
    (1, 50, 190, 4, 2, 64, False),
    (1, 130, 300, 2, 1, 128, True),
    (2, 96, 96, 4, 4, 64, False),
]


def _flash_inputs(case, seed):
    b, sq, sk, h, hk, d, _ = case
    rng = np.random.default_rng(seed)
    return (_bf16_valued(rng, (b, sq, h, d)), _bf16_valued(rng, (b, sk, hk, d)),
            _bf16_valued(rng, (b, sk, hk, d)))


# larger scores make the online softmax rescale more across key tiles and
# P's bf16 rounding matter more: scale q by these
Q_SCALES = [1.0, 4.0, 16.0]


@pytest.mark.parametrize("q_scale", Q_SCALES)
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_tc_emulation_matches_jax(case, q_scale):
    causal = case[-1]
    q, k, v = _flash_inputs(case, seed=case[1] + int(q_scale))
    q = q * np.float32(q_scale)      # a power of 2: still bf16-valued
    want = np.asarray(jref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=causal))
    got = ref.flash_attention_tc_ref(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), causal)
    assert got.dtype == torch.float32
    _within_scale(got, want, FLASH_TOL)


@pytest.mark.parametrize("case", [(1, 64, 64, 2, 1, 64, True),
                                  (1, 70, 70, 4, 2, 64, True),
                                  (1, 50, 190, 4, 2, 64, False),
                                  (1, 128, 256, 2, 1, 128, True)], ids=str)
def test_flash_tc_emulation_matches_pallas_interpret(case):
    causal = case[-1]
    q, k, v = _flash_inputs(case, seed=7)
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        impl="pallas_interpret"))
    got = ref.flash_attention_tc_ref(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), causal)
    _within_scale(got, want, FLASH_TOL)


def test_flash_tc_emulation_masked_tile_weighs_nothing():
    """Causal, Sq < Sk by less than a key tile (d = 128: 64-key tiles):
    the first query tile's second key tile lies wholly above the diagonal
    for its first rows, which must take exactly 0 weight from it (no
    exp(0) leaks), and the tile's padding rows past Sq stay finite."""
    case = (1, 60, 70, 2, 1, 128, True)
    q, k, v = _flash_inputs(case, seed=3)
    want = np.asarray(jref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=True))
    got = ref.flash_attention_tc_ref(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), True)
    _within_scale(got, want, FLASH_TOL)


def test_flash_tc_emulation_bf16_output():
    case = FLASH_CASES[2]
    q, k, v = _flash_inputs(case, seed=11)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = ref.flash_attention_tc_ref(tq, tk, tv, True)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=True))
    # one more bf16 rounding of the output: 2^-8 of it on top
    _within_scale(got, want, 2 * FLASH_TOL)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 128, True),
    (torch.bfloat16, 32, False), (torch.float32, 64, False),
    (torch.float32, 128, False)])
def test_tensor_core_path_reads_shapes_only(dtype, d, want):
    # a meta tensor has a shape and a dtype but no values to read
    q = torch.empty(2, 512, 12, d, dtype=dtype, device="meta")
    assert fa.tensor_core_path(q) is want


# ---------------------------------------------------------------------------
# split-KV decode attention
# ---------------------------------------------------------------------------

S = 256
SPLIT = 64
# an empty row, one key, a split boundary -1/0/+1, the whole cache, past it
LENGTHS = [0, 1, SPLIT - 1, SPLIT, SPLIT + 1, S, S + 9]


def _decode_inputs(quant, seed, b=len(LENGTHS), s=S, h=6, hk=2, d=64):
    rng = np.random.default_rng(seed)
    q = _bf16_valued(rng, (b, h, d))
    length = np.array(LENGTHS, np.int32)[:b]
    if quant:
        kc = rng.integers(-127, 128, (b, s, hk, d)).astype(np.int8)
        vc = rng.integers(-127, 128, (b, s, hk, d)).astype(np.int8)
        ks = (rng.random((b, s, hk, 1)) * 0.02).astype(np.float32)
        vs = (rng.random((b, s, hk, 1)) * 0.02).astype(np.float32)
        return q, kc, vc, length, ks, vs
    return (q, _bf16_valued(rng, (b, s, hk, d)),
            _bf16_valued(rng, (b, s, hk, d)), length, None, None)


def _opt(a, conv):
    return None if a is None else conv(a)


# (n_split, split_len): one split, the boundary splits, uneven cover (the
# last split shorter), one key per split
SPLITS = [(1, None), (S // SPLIT, SPLIT), (3, 96), (S, 1)]


@pytest.mark.parametrize("splits", SPLITS, ids=str)
@pytest.mark.parametrize("quant", [False, True], ids=["bf16kv", "int8kv"])
def test_decode_split_emulation_matches_jax(quant, splits):
    q, kc, vc, length, ks, vs = _decode_inputs(quant, seed=len(str(splits)))
    want = np.asarray(jref.decode_attention_ref(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(length),
        _opt(ks, jnp.asarray), _opt(vs, jnp.asarray)))
    t = torch.from_numpy
    got = ref.decode_attention_split_ref(
        t(q), t(kc), t(vc), t(length), _opt(ks, t), _opt(vs, t), *splits)
    _within_scale(got, want, DECODE_TOL)
    assert torch.count_nonzero(got[0]) == 0           # length 0 -> exactly 0
    # the port's own oracle, which the card holds the kernels to
    _within_scale(got, ref.decode_attention_ref(
        t(q), t(kc), t(vc), t(length), _opt(ks, t), _opt(vs, t)).numpy(),
        DECODE_TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16kv", "int8kv"])
def test_decode_split_emulation_bf16(quant):
    q, kc, vc, length, ks, vs = _decode_inputs(quant, seed=21)
    want = np.asarray(jref.decode_attention_ref(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(length),
        _opt(ks, jnp.asarray), _opt(vs, jnp.asarray)))
    bf = (lambda a: torch.from_numpy(a).to(torch.bfloat16))
    t = torch.from_numpy
    kv = (t(kc), t(vc)) if quant else (bf(kc), bf(vc))
    got = ref.decode_attention_split_ref(bf(q), *kv, t(length), _opt(ks, t),
                                         _opt(vs, t), S // SPLIT, SPLIT)
    assert got.dtype == torch.bfloat16
    _within_scale(got, want, FLASH_TOL)
    assert torch.count_nonzero(got[0]) == 0


def _paged_inputs(quant, seed, bs=16):
    """The dense inputs laid out in a shuffled pool: row i's block j at
    pool block table[i, j]; blocks past a row's length point at trash 0."""
    q, kc, vc, length, ks, vs = _decode_inputs(quant, seed)
    b, s = kc.shape[:2]
    mb = s // bs
    rng = np.random.default_rng(seed + 100)
    nb = b * mb + 1
    table = (1 + rng.permutation(nb - 1)).reshape(b, mb).astype(np.int32)

    def pool(x):
        p = np.zeros((nb, bs, *x.shape[2:]), x.dtype)
        p[table.reshape(-1)] = x.reshape(b * mb, bs, *x.shape[2:])
        return p

    used = (np.minimum(length, s)[:, None] + bs - 1) // bs
    table = np.where(np.arange(mb)[None, :] < used, table, 0).astype(np.int32)
    return (q, pool(kc), pool(vc), table, length, _opt(ks, pool),
            _opt(vs, pool))


@pytest.mark.parametrize("splits", SPLITS[:3], ids=str)
@pytest.mark.parametrize("quant", [False, True], ids=["bf16kv", "int8kv"])
def test_paged_decode_split_emulation_matches_jax(quant, splits):
    q, kp, vp, table, length, ks, vs = _paged_inputs(quant, seed=5)
    want = np.asarray(jref.paged_decode_attention_ref(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(length), _opt(ks, jnp.asarray), _opt(vs, jnp.asarray)))
    t = torch.from_numpy
    got = ref.paged_decode_attention_split_ref(
        t(q), t(kp), t(vp), t(table), t(length), _opt(ks, t), _opt(vs, t),
        *splits)
    _within_scale(got, want, DECODE_TOL)
    assert torch.count_nonzero(got[0]) == 0


@pytest.mark.parametrize("quant", [False, True], ids=["bf16kv", "int8kv"])
def test_decode_every_split_empty_is_exactly_zero(quant):
    """Rows of length 0 (and negative) with many splits: every split is
    empty, the merge weighs each by 0, and the output is exactly 0."""
    q, kc, vc, _, ks, vs = _decode_inputs(quant, seed=9)
    t = torch.from_numpy
    length = torch.tensor([0, -3, 0, 0, 0, 0, 0], dtype=torch.int32)
    got = ref.decode_attention_split_ref(t(q), t(kc), t(vc), length,
                                         _opt(ks, t), _opt(vs, t), 8, 32)
    assert torch.isfinite(got).all()
    assert torch.count_nonzero(got) == 0


def test_decode_split_emulation_must_cover_the_cache():
    q, kc, vc, length, _, _ = _decode_inputs(False, seed=1)
    t = torch.from_numpy
    with pytest.raises(ValueError):
        ref.decode_attention_split_ref(t(q), t(kc), t(vc), t(length),
                                       n_split=3, split_len=64)


@pytest.mark.parametrize("limit,rows,bs", [
    (1024, 32, None), (1024, 32, 16), (80, 16, None), (32768, 4, None),
    (32768, 4, 1), (64, 256, None), (1000, 8, 8), (4096, 1, 16)])
def test_split_plan_from_shapes(limit, rows, bs):
    params = list(inspect.signature(split_plan).parameters)
    assert params == ["limit", "rows", "sms", "bs"]  # no tensor to read
    n, length = split_plan(limit, rows, 132, bs)
    assert length % SPLIT_KEYS == 0 and length >= SPLIT_KEYS
    assert n * length >= limit > (n - 1) * length    # covers, no empty tail
    if bs is not None:
        assert length <= (TABLE - 1) * bs or length == SPLIT_KEYS
    if (limit, rows) == (1024, 32):
        assert (n, length) == (8, 128)    # the serve shape: 256 blocks


def test_split_buffers_read_no_values(monkeypatch):
    # meta tensors: shapes only; the scratch holds every split's partial,
    # the counters one per (row, KV head), and both are kept per shape.
    # The SM count is a host-side property of the card (an H100's here)
    monkeypatch.setattr(_build, "sm_count", lambda device: 132)
    q = torch.empty(8, 12, 64, dtype=torch.bfloat16, device="meta")
    n, length, part, counters = split_buffers(q, 1024, 8 * 4, stream=0)
    assert (n, length) == split_plan(1024, 32, 132) == (8, 128)
    assert part.device.type == "meta" and part.dtype == torch.float32
    assert part.numel() == 8 * 4 * 8 * 3 * (64 + 1)
    assert counters.dtype == torch.int32 and counters.numel() == 32
    assert split_buffers(q, 1024, 32, stream=0)[2] is part
    assert split_buffers(q, 1024, 32, stream=1)[2] is not part
    # a split of the whole cache (few keys, many rows): no scratch
    assert split_buffers(q, 64, 32, stream=0)[2:] == (None, None)


# (H, Hk, d) beyond one block's 8 query heads a KV head (glm4-9b's ratio
# 16: two groups) and at head dim 16 (the merge on half a warp)
GROUP_LAYOUTS = [(32, 2, 128), (4, 2, 16), (24, 1, 32)]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16kv", "int8kv"])
@pytest.mark.parametrize("layout", GROUP_LAYOUTS, ids=str)
def test_decode_group_and_split_plan_matches_oracle(layout, quant, paged):
    """The decode kernels' plan at these layouts: the query heads of a KV
    head in groups of at most ``MAX_REP`` (each group's blocks one plan
    row), the keys split as ``split_plan`` gives for those rows on an
    H100 (132 SMs); the split emulation under that plan agrees with the
    port's and JAX's oracles, and a length-0 row is exactly 0."""
    from repro_torch.kernels.decode_attention import (MAX_REP, head_groups,
                                                      plan_rows)
    h, hk, d = layout
    n_grp, gs = head_groups(h, hk)
    assert n_grp * gs >= h // hk > (n_grp - 1) * gs and gs <= MAX_REP
    b = len(LENGTHS)
    rows = plan_rows(b, h, hk)
    assert rows == b * hk * n_grp
    q, kc, vc, length, ks, vs = _decode_inputs(quant, seed=h + d, h=h,
                                               hk=hk, d=d)
    t = torch.from_numpy
    want = ref.decode_attention_ref(t(q), t(kc), t(vc), t(length),
                                    _opt(ks, t), _opt(vs, t))
    jwant = np.asarray(jref.decode_attention_ref(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(length),
        _opt(ks, jnp.asarray), _opt(vs, jnp.asarray)))
    if paged:
        # this case's rows laid out in a shuffled pool of 16-key blocks
        bs = 16
        mb = S // bs
        nb = b * mb + 1
        perm = (1 + np.random.default_rng(d).permutation(nb - 1)).reshape(
            b, mb).astype(np.int32)

        def pool(x):
            p = np.zeros((nb, bs, *x.shape[2:]), x.dtype)
            p[perm.reshape(-1)] = x.reshape(b * mb, bs, *x.shape[2:])
            return p

        n_split, split_len = split_plan(mb * bs, rows, 132, bs)
        got = ref.paged_decode_attention_split_ref(
            t(q), t(pool(kc)), t(pool(vc)), t(perm), t(length),
            _opt(ks, lambda a: t(pool(a))), _opt(vs, lambda a: t(pool(a))),
            n_split, split_len)
    else:
        n_split, split_len = split_plan(S, rows, 132)
        got = ref.decode_attention_split_ref(
            t(q), t(kc), t(vc), t(length), _opt(ks, t), _opt(vs, t),
            n_split, split_len)
    assert n_split > 1
    _within_scale(got, want.numpy(), DECODE_TOL)
    _within_scale(got, jwant, DECODE_TOL)
    zero = [i for i, n in enumerate(LENGTHS) if n <= 0]
    assert zero and torch.count_nonzero(got[zero]) == 0
