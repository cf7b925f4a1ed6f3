"""Port parity for speculative decoding: the host rules of
``serve/speculative.py``, ``derive_draft_params`` and the speculative
``ServeEngine``, against the JAX package on the same weights and prompts
(the model and workload of ``tests/test_speculative.py``), on the CPU.

- The host rules: the module's doctests, and hypothesis properties under
  which the port's ``accept_length`` / ``emitted_tokens`` / ``round_k``
  equal the JAX package's and keep its invariants.
- The drafts: int4 codes and scales byte-equal to JAX's; shift-add
  weights equal to JAX's (float64 numpy in both, cast to float32).
- The engine, one fast case per axis (int8 target with an int4 draft,
  float target with a shift-add draft, paged, fused, multi-LoRA, spec_k 1
  and 8): the port's speculative tokens equal the port's target-only
  tokens AND the JAX speculative engine's, and the speculative stats
  equal the JAX engine's. No case here sits on a near-tie between the
  frameworks: every case compares with JAX.
- More engine cases, within the port (the JAX battery's own checks): EOS
  inside an acceptance, a cache-full truncation, restore after preemption
  by recompute, the refusals, and the paged rollback leaving the pager
  consistent after every step.
"""

import doctest
import math

import hypothesis
import hypothesis.strategies as st
import jax
import numpy as np
import pytest
import torch
from hypothesis import given

from repro.configs.base import ModelConfig as JModelConfig
from repro.core import quantization as JQ
from repro.launch.serve import make_synthetic_adapters as j_synthetic_adapters
from repro.models.model import get_model as j_get_model
from repro.serve import speculative as jspec
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import ModelConfig
from repro_torch.core import quantization as TQ
from repro_torch.serve import speculative as tspec
from repro_torch.serve.adapters import make_synthetic_adapters
from repro_torch.serve.engine import ServeEngine
from test_torch_engine import jax_tree_to_numpy

# the profile of tests/test_speculative.py, under the same name
hypothesis.settings.register_profile(
    "ci", deadline=None, max_examples=25,
    suppress_health_check=[hypothesis.HealthCheck.too_slow])
hypothesis.settings.load_profile("ci")

FIELDS = dict(name="s", family="dense", n_layers=2, d_model=64, n_heads=4,
              n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
              vocab_pad_multiple=64, dtype="float32")
JCFG, TCFG = JModelConfig(**FIELDS), ModelConfig(**FIELDS)
MIXED = [np.arange(8) + 1, np.arange(12) + 3, np.arange(31) + 7,
         np.arange(12) + 40, np.arange(8) + 60]
SPEC_STATS = ("spec_rounds", "spec_slot_rounds", "drafted_tokens",
              "accepted_draft_tokens", "spec_emitted_tokens", "steps",
              "decode_tokens", "decode_chunks", "prefill_waves")


@pytest.fixture(scope="module")
def weights():
    jparams = j_get_model(JCFG).init(jax.random.PRNGKey(0))
    return jparams, params_from_numpy(jax_tree_to_numpy(jparams), "cpu")


def _engine(cls, params, adapters=None, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("decode_chunk", 4)
    if cls is ServeEngine:
        kw["device"] = "cpu"
    return cls(JCFG if cls is JServeEngine else TCFG, params, greedy=True,
               adapters=adapters, **kw)


def _generate(eng, prompts, max_new, names):
    """The engine's requests for ``prompts``, in order."""
    kw = {} if names is None else {
        "adapters": (names * len(prompts))[:len(prompts)]}
    return eng.generate(prompts, max_new=max_new, return_requests=True, **kw)


def _tokens(reqs):
    return [r.tokens for r in reqs]


def _assert_identical(params, *, max_new=12, prompts=MIXED, adapters=None,
                      names=None, spec_k=4, **kw):
    """The port's target-only and speculative engines on one workload:
    equal tokens and finish reasons, and the speculative stats' own
    identities. Returns (the speculative requests, its engine)."""
    target_kw = {k: v for k, v in kw.items() if not k.startswith("draft")}
    ref = _generate(_engine(ServeEngine, params, adapters, **target_kw),
                    prompts, max_new, names)
    eng = _engine(ServeEngine, params, adapters, speculate=True,
                  spec_k=spec_k, **kw)
    reqs = _generate(eng, prompts, max_new, names)
    out = _tokens(reqs)
    assert out == _tokens(ref)
    assert [r.finish_reason for r in reqs] == [r.finish_reason for r in ref]
    assert eng.stats.spec_rounds > 0
    # first tokens come from prefill
    assert eng.stats.spec_emitted_tokens == \
        sum(len(t) for t in out) - len(prompts)
    if eng.paged:
        eng.pager.check_consistency()
    return reqs, eng


AXES = {
    "int8_target_int4_draft": dict(quantize=True, draft_bits=4),
    "float_target_shiftadd_draft": dict(quantize=False,
                                        draft_mode="shiftadd", draft_bits=8),
    "paged": dict(quantize=True, paged=True, kv_block_size=8),
    "fused": dict(quantize=True, fuse_qkv=True),
    "multi_lora": dict(quantize=True),
    "spec_k1": dict(quantize=True, spec_k=1),
    "spec_k8": dict(quantize=True, spec_k=8),
}


@pytest.mark.parametrize("axis", list(AXES))
def test_spec_axis_matches_target_only_and_jax(weights, axis):
    jparams, tparams = weights
    kw = dict(AXES[axis])
    jadapters = tadapters = names = None
    if axis == "multi_lora":
        jadapters, jnames = j_synthetic_adapters(JCFG, 2)
        tadapters, tnames = make_synthetic_adapters(TCFG, 2, device="cpu")
        assert jnames == tnames
        names = [tnames[0], None, tnames[1]]
    reqs, eng = _assert_identical(tparams, adapters=tadapters, names=names,
                                  **kw)
    jeng = _engine(JServeEngine, jparams, jadapters, speculate=True, **kw)
    assert _tokens(_generate(jeng, MIXED, 12, names)) == _tokens(reqs)
    for name in SPEC_STATS:
        assert getattr(eng.stats, name) == getattr(jeng.stats, name), name
    assert eng.stats.acceptance_rate == jeng.stats.acceptance_rate
    assert eng.stats.accepted_tokens_per_step == \
        jeng.stats.accepted_tokens_per_step
    if axis in ("int8_target_int4_draft", "float_target_shiftadd_draft"):
        # the JAX battery's gate in miniature: speculation beats one token
        # a round on this fixed workload
        assert eng.stats.accepted_tokens_per_step > 1.0
        assert 0.0 < eng.stats.acceptance_rate <= 1.0


def test_spec_eos_mid_acceptance(weights):
    """An EOS inside the accepted prefix cuts the request exactly where
    target-only decode stops."""
    _, tparams = weights
    ref = _engine(ServeEngine, tparams, quantize=True).generate(
        MIXED[:2], max_new=12)
    # an eos id from the middle of a stream, so that the stop lands inside
    # a round for some spec_k
    eos = int(ref[0][len(ref[0]) // 2])
    for spec_k in (2, 4):
        reqs, _ = _assert_identical(tparams, quantize=True, eos_id=eos,
                                    spec_k=spec_k, prompts=MIXED[:2])
        assert reqs[0].finish_reason == "eos"
        assert reqs[0].tokens[-1] == eos and len(reqs[0].tokens) < 12


def test_spec_cache_full_truncation(weights):
    """Under max_len pressure the k clamp keeps every verify write in
    bounds and the cache_full stop fires as in target-only decode."""
    _, tparams = weights
    prompts = [np.arange(6) + 1, np.arange(10) + 2]
    reqs, _ = _assert_identical(tparams, quantize=True, max_len=16,
                                max_new=32, prompts=prompts)
    assert all(r.finish_reason == "cache_full" for r in reqs)
    assert [len(r.tokens) for r in reqs] == [17 - len(p) for p in prompts]


def test_spec_restore_after_preemption(weights):
    """A speculating slot preempted mid-flight resumes token-identically:
    the recompute restore rebuilds the target's and the draft's KV, and
    the fast restore stays off."""
    _, tparams = weights
    base = dict(quantize=True, paged=True, kv_block_size=8, n_slots=2,
                max_len=64)
    want = _engine(ServeEngine, tparams, **base).generate(MIXED, max_new=12)
    eng = _engine(ServeEngine, tparams, speculate=True, spec_k=4, **base)
    for p in MIXED[:2]:
        eng.submit(p, max_new=12)
    eng.step()
    victim = next(i for i, s in enumerate(eng.slots) if s is not None)
    eng._preempt_slot(victim)
    eng.pager.check_consistency()
    assert eng.stats.preempted == 1
    assert [r._swap is not None for r in eng.queue] == [True]
    for p in MIXED[2:]:
        eng.submit(p, max_new=12)
    eng.run()
    got = {r.rid: r.tokens for r in eng.finished}
    assert [got[i] for i in sorted(got)] == want
    assert eng.stats.restored >= 1
    assert eng.stats.fast_restores == 0


def test_spec_refusals(weights):
    _, tparams = weights
    with pytest.raises(ValueError, match="greedy"):
        ServeEngine(TCFG, tparams, speculate=True, greedy=False,
                    device="cpu")
    with pytest.raises(ValueError, match="spec_k"):
        ServeEngine(TCFG, tparams, speculate=True, spec_k=0, device="cpu")
    with pytest.raises(ValueError, match="draft mode"):
        ServeEngine(TCFG, tparams, speculate=True, draft_mode="fp64",
                    device="cpu")
    with pytest.raises(ValueError, match="prefill_budget"):
        ServeEngine(TCFG, tparams, speculate=True, paged=True,
                    prefill_budget=64, device="cpu")
    ssm = ModelConfig(name="m", family="ssm", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=4, d_ff=0, vocab_size=256)
    with pytest.raises(ValueError, match="speculative"):
        ServeEngine(ssm, tparams, speculate=True, device="cpu")


def test_spec_rollback_returns_blocks_every_round(weights):
    """After every round each running slot holds exactly ceil(kv_len /
    block) blocks (the k+1 window's surplus went back to the pool), the
    books balance at every step, and nothing is left at drain."""
    _, tparams = weights
    eng = _engine(ServeEngine, tparams, speculate=True, spec_k=4,
                  quantize=True, paged=True, kv_block_size=8,
                  prefix_cache=False)
    for prompt in MIXED:
        eng.submit(prompt, max_new=12)
    while eng.step():
        eng.pager.check_consistency()
        for i, r in enumerate(eng.slots):
            if r is None:
                continue
            kv_len = len(r.prompt) + len(r.tokens) - 1
            assert len(eng.pager.slot_blocks(i)) == math.ceil(kv_len / 8)
    assert eng.pager.blocks_in_use == 0
    eng.pager.check_consistency()


def test_spec_paged_with_prefix_cache_publishes_and_matches(weights):
    """With the radix index on, a finished speculating request publishes
    its full blocks; at drain the blocks in use are the published
    prefixes alone, and evicting them empties the pool."""
    _, tparams = weights
    shared = [np.concatenate([np.arange(16) + 5, np.arange(4) + 100 + i])
              for i in range(4)]
    _, eng = _assert_identical(tparams, quantize=True, paged=True,
                               kv_block_size=8, prompts=shared)
    assert eng.stats.prefix_hit_tokens > 0
    assert all(not eng.pager.slot_blocks(i) for i in range(eng.n_slots))
    assert eng.pager.blocks_in_use == eng.pager.evictable_blocks() > 0
    eng.pager.evict_prefixes()
    assert eng.pager.blocks_in_use == 0


# ---------------------------------------------------------------------------
# derive_draft_params against the JAX package
# ---------------------------------------------------------------------------

def _qtensors(tree, prefix=""):
    """(path, leaf) pairs; a JAX QTensor carried to numpy (a dict holding
    "codes") is a leaf."""
    if isinstance(tree, dict) and "codes" not in tree:
        for k, v in tree.items():
            yield from _qtensors(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["affine", "codebook"])
def test_int4_draft_codes_and_scales_byte_equal(mode, dtype):
    jcfg = JModelConfig(**{**FIELDS, "dtype": dtype})
    jraw = j_get_model(jcfg).init(jax.random.PRNGKey(1))
    traw = params_from_numpy(jax_tree_to_numpy(jraw), "cpu")
    jdraft = jax_tree_to_numpy(JQ.derive_draft_params(jraw, bits=4,
                                                      mode=mode))
    tdraft = TQ.derive_draft_params(traw, bits=4, mode=mode)
    n_q = 0
    for (path, t), (_, j) in zip(_qtensors(tdraft), _qtensors(jdraft)):
        if isinstance(t, TQ.QTensor):
            n_q += 1
            assert (t.bits, t.mode, t.packed) == (4, mode, True), path
            assert t.codes.numpy().tobytes() == \
                np.asarray(j["codes"]).tobytes(), path
            assert t.scale.numpy().tobytes() == \
                np.asarray(j["scale"], np.float32).tobytes(), path
        else:
            assert not isinstance(j, dict) or "codes" not in j, path
    assert n_q == 8          # seven projections a layer and the lm head


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shiftadd_draft_weights_equal_jax(dtype):
    jcfg = JModelConfig(**{**FIELDS, "dtype": dtype})
    jraw = j_get_model(jcfg).init(jax.random.PRNGKey(2))
    traw = params_from_numpy(jax_tree_to_numpy(jraw), "cpu")
    jdraft = jax_tree_to_numpy(JQ.derive_draft_params(
        jraw, bits=8, mode="shiftadd"))
    tdraft = TQ.derive_draft_params(traw, bits=8, mode="shiftadd")
    for name in ("wq", "wk", "wv", "wo"):
        t = tdraft["layers"]["attn"][name]
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(
            t.numpy(), jdraft["layers"]["attn"][name])
    for name in ("gate", "up", "down"):
        np.testing.assert_array_equal(
            tdraft["layers"]["ffn"][name].numpy(),
            jdraft["layers"]["ffn"][name])
    # norms and the embedding are untouched
    assert tdraft["embed"]["embedding"] is traw["embed"]["embedding"]


def test_unknown_draft_mode_raises():
    with pytest.raises(ValueError, match="draft mode"):
        TQ.derive_draft_params({}, mode="fp64")


# ---------------------------------------------------------------------------
# Host acceptance rules
# ---------------------------------------------------------------------------

def test_speculative_doctests():
    res = doctest.testmod(tspec)
    assert res.failed == 0 and res.attempted >= 13


@st.composite
def draft_target_pairs(draw, max_k=8, vocab=16):
    """(draft, target) with target one longer, over a small vocab so
    agreements happen."""
    k = draw(st.integers(0, max_k))
    draft = draw(st.lists(st.integers(0, vocab - 1), min_size=k,
                          max_size=k))
    target = draw(st.lists(st.integers(0, vocab - 1), min_size=k + 1,
                           max_size=k + 1))
    return draft, target


@given(draft_target_pairs())
def test_accept_and_emit_match_jax(pair):
    draft, target = pair
    m = tspec.accept_length(draft, target)
    assert m == jspec.accept_length(draft, target)
    assert 0 <= m <= len(draft)
    assert all(draft[i] == target[i] for i in range(m))
    if m < len(draft):
        assert draft[m] != target[m]
    out = tspec.emitted_tokens(draft, target)
    assert out == jspec.emitted_tokens(draft, target)
    assert out == [int(t) for t in target[:m + 1]]
    assert 1 <= len(out) <= len(draft) + 1


@given(st.lists(st.integers(0, 15), min_size=0, max_size=8))
def test_accept_all_when_target_agrees(draft):
    target = list(draft) + [99]
    assert tspec.accept_length(draft, target) == len(draft)
    assert tspec.emitted_tokens(draft, target) == list(draft) + [99]


def test_accept_length_shape_mismatch():
    with pytest.raises(ValueError):
        tspec.accept_length([1, 2], [1, 2])


@given(st.integers(1, 16), st.integers(4, 64),
       st.lists(st.integers(0, 60), min_size=1, max_size=4),
       st.lists(st.integers(1, 40), min_size=1, max_size=4),
       st.integers(0, 12).map(lambda n: n or None))
def test_round_k_matches_jax(spec_k, max_len, positions, budgets, max_n):
    hypothesis.assume(all(p <= max_len - 1 for p in positions))
    kw = dict(max_len=max_len, positions=positions, budgets=budgets,
              max_n=max_n)
    k = tspec.round_k(spec_k, **kw)
    assert k == jspec.round_k(spec_k, **kw)
    assert 0 <= k <= spec_k
    assert max(positions) + k <= max_len - 1
    assert k == 0 or k + 1 <= max(budgets) + 1
    assert k in (0, spec_k) or (k & (k - 1)) == 0


def test_round_k_rejects_bad_spec_k():
    with pytest.raises(ValueError):
        tspec.round_k(0, max_len=8, positions=[1], budgets=[4])
