"""Port parity: the dense ``ServeEngine`` against the JAX engine on the
serve_bench smoke workload (``n_slots=2``, ``max_len=64``, prompt lengths
8/12/31, ``max_new=16``, 6 requests) on
``repro_100m.CONFIG.reduced(dtype="float32", remat=False)``, with the JAX
weights carried across by ``bridge.params_from_numpy``.

Greedy tokens must be identical, request for request, and so must the
scheduler's counters, for fp32 and int8 weights at decode chunk 1 and 8.
"""

import dataclasses

import jax
import numpy as np
import pytest

from repro.configs.repro_100m import CONFIG as J_CONFIG
from repro.core import quantization as JQ
from repro.models.model import get_model as j_get_model
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.repro_100m import CONFIG as T_CONFIG
from repro_torch.serve.engine import ServeEngine, _pow2_bucket

SMOKE = dict(n_slots=2, max_len=64, requests=6, max_new=16,
             prompt_lens=(8, 12, 31))
COUNTERS = ("admitted", "finished", "truncated", "steps", "decode_tokens",
            "decode_chunks", "prefill_waves", "prefill_tokens")


def jax_tree_to_numpy(tree):
    if isinstance(tree, JQ.QTensor):
        d = {f.name: getattr(tree, f.name)
             for f in dataclasses.fields(JQ.QTensor)}
        d["codes"], d["scale"] = np.asarray(tree.codes), np.asarray(tree.scale)
        return d
    if isinstance(tree, dict):
        return {k: jax_tree_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def weights():
    overrides = dict(dtype="float32", remat=False)
    jcfg = J_CONFIG.reduced(**overrides)
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax_tree_to_numpy(jparams), "cpu")
    return jcfg, jparams, T_CONFIG.reduced(**overrides), tparams


def _prompts(vocab):
    rng = np.random.default_rng(0)
    lens = SMOKE["prompt_lens"]
    return [rng.integers(0, vocab, size=lens[i % len(lens)]).astype(np.int32)
            for i in range(SMOKE["requests"])]


def _serve(engine_cls, cfg, params, quantize, chunk, **kw):
    eng = engine_cls(cfg, params, n_slots=SMOKE["n_slots"],
                     max_len=SMOKE["max_len"], quantize=quantize,
                     decode_chunk=chunk, **kw)
    for p in _prompts(cfg.vocab_size):
        eng.submit(p, max_new=SMOKE["max_new"])
    eng.run()
    return eng


@pytest.mark.parametrize("chunk", [1, 8])
@pytest.mark.parametrize("quantize", [False, True], ids=["fp32", "int8"])
def test_greedy_tokens_match_jax_engine(weights, quantize, chunk):
    jcfg, jparams, tcfg, tparams = weights
    jeng = _serve(JServeEngine, jcfg, jparams, quantize, chunk)
    teng = _serve(ServeEngine, tcfg, tparams, quantize, chunk, device="cpu")
    jres = {r.rid: r for r in jeng.finished}
    tres = {r.rid: r for r in teng.finished}
    assert sorted(tres) == sorted(jres) == list(range(SMOKE["requests"]))
    for rid in jres:
        assert tres[rid].tokens == jres[rid].tokens, rid
        assert tres[rid].finish_reason == jres[rid].finish_reason
    for name in COUNTERS:
        assert getattr(teng.stats, name) == getattr(jeng.stats, name), name


def test_cache_full_and_long_prompt(weights):
    """A prompt longer than max_len - 1 is truncated to its tail, and the
    request stops cache_full with the same tokens as the JAX engine."""
    jcfg, jparams, tcfg, tparams = weights
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, jcfg.vocab_size, size=80).astype(np.int32)
    kw = dict(n_slots=2, max_len=32, decode_chunk=8)
    jr = JServeEngine(jcfg, jparams, **kw).generate(
        [prompt], max_new=40, return_requests=True)[0]
    tr = ServeEngine(tcfg, tparams, device="cpu", **kw).generate(
        [prompt], max_new=40, return_requests=True)[0]
    assert tr.prompt_truncated and len(tr.prompt) == 31
    assert tr.finish_reason == jr.finish_reason == "cache_full"
    assert tr.truncated and tr.tokens == jr.tokens


def test_free_slot_cursor_runs_past_max_len(weights):
    """One long request keeps decoding while the other slot sits free:
    the free slot's cursor passes max_len and its writes are dropped."""
    _, _, tcfg, tparams = weights
    eng = ServeEngine(tcfg, tparams, n_slots=2, max_len=16, decode_chunk=8,
                      device="cpu")
    long_ = np.arange(1, 3, dtype=np.int32)
    eng.submit(np.arange(1, 7, dtype=np.int32), max_new=2)
    eng.submit(long_, max_new=14)
    eng.run()
    by_rid = {r.rid: r for r in eng.finished}
    assert [by_rid[i].finish_reason for i in (0, 1)] == ["max_new"] * 2
    assert int(eng.cache["pos"][0]) > eng.max_len     # the freed slot
    alone = ServeEngine(tcfg, tparams, n_slots=2, max_len=16,
                        decode_chunk=8, device="cpu").generate(
        [long_], max_new=14)[0]
    assert by_rid[1].tokens == alone


def test_unported_options_raise(weights):
    _, _, tcfg, tparams = weights
    for kw in (dict(paged=True), dict(adapters=object()),
               dict(fuse_qkv=True), dict(mesh=object()),
               dict(speculate=True), dict(prefill_budget=64),
               dict(max_queue=4)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ServeEngine(tcfg, tparams, device="cpu", **kw)
    eng = ServeEngine(tcfg, tparams, device="cpu")
    for kw in (dict(on_token=print), dict(deadline_s=1.0),
               dict(priority=1), dict(adapter="a")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            eng.submit([1, 2, 3], **kw)


def test_pow2_bucket():
    assert [_pow2_bucket(n, 8, 64) for n in (1, 8, 9, 31, 100)] == \
        [8, 8, 16, 32, 64]
