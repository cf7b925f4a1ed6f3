"""Port parity for the transformer families (dense, moe, vlm): the config
registry, the decoder of the moe and vlm families against
``repro.models.transformer``, and the vlm family's serving engine against
the JAX engine, on the CPU.

- Every registered config's fields, ``n_params()`` and
  ``n_active_params()`` equal the JAX config's (the recurrent configs
  xlstm-1.3b, zamba2-1.2b and the audio whisper-small among them);
  ``get_model`` serves dense, moe, vlm, ssm, hybrid and audio.
- Logits of ``forward``, a ragged ``prefill`` and 8 teacher-forced
  ``decode_step``s on the ``reduced()`` qwen2-moe, arctic and chameleon
  configs (f32), with f32 and int8 weights carried across from JAX:
  rtol 1e-4 with an atol of 1e-4 times the logit scale, as in
  ``tests/test_torch_model.py`` (other orders of f32 additions).
- ``chameleon-34b.reduced()`` (qk_norm) served in the seven modes of
  ``tests/test_torch_moe.py``: greedy tokens and every integer
  ``EngineStats`` counter equal to the JAX engine's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as J_REGISTRY
from repro.core import quantization as JQ
from repro.core.axllm_linear import deploy_quantize as j_deploy
from repro.models.model import get_model as j_get_model
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import REGISTRY, get_config
from repro_torch.models.model import ATTENTION_FAMILIES, get_model
from test_torch_engine import jax_tree_to_numpy
from test_torch_moe import MODES, assert_same_serving, serve_both

TRANSFORMERS = ("repro-100m", "qwen2-moe-a2.7b", "arctic-480b",
                "chameleon-34b", "glm4-9b", "granite-3-8b", "internlm2-20b",
                "qwen2-72b")
RECURRENT = ("xlstm-1.3b", "zamba2-1.2b")
AUDIO = ("whisper-small",)


def test_registry_holds_the_transformer_configs():
    assert sorted(REGISTRY) == sorted(TRANSFORMERS + RECURRENT + AUDIO)
    assert sorted(REGISTRY) == sorted(J_REGISTRY)
    with pytest.raises(KeyError, match="known"):
        get_config("whisper-medium")


@pytest.mark.parametrize("name", TRANSFORMERS + RECURRENT + AUDIO)
def test_config_equals_jax(name):
    t, j = get_config(name), J_REGISTRY[name]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.n_params() == j.n_params()
    assert t.n_active_params() == j.n_active_params()
    assert (t.padded_experts, t.padded_vocab, t.resolved_head_dim,
            t.supports_long_context, t.has_decoder) == (
        j.padded_experts, j.padded_vocab, j.resolved_head_dim,
        j.supports_long_context, j.has_decoder)
    small = dict(dtype="float32", remat=False)
    assert dataclasses.asdict(t.reduced(**small)) == \
        dataclasses.asdict(j.reduced(**small))


@pytest.mark.parametrize("family", ["dense", "moe", "vlm", "ssm", "hybrid",
                                    "audio"])
def test_get_model_serves_the_transformer_families(family):
    base = {"ssm": "xlstm-1.3b", "hybrid": "zamba2-1.2b"}.get(
        family, "qwen2-moe-a2.7b")
    cfg = dataclasses.replace(get_config(base).reduced(), family=family)
    api = get_model(cfg)
    assert api.cfg.family == family
    assert api.ragged_prefill == (family in ATTENTION_FAMILIES
                                  or family == "audio")
    assert api.supports_lora == (family in ATTENTION_FAMILIES)
    assert (api.init_paged_cache is None) == \
        (family not in ATTENTION_FAMILIES)


MAX_LEN = 40
LENGTHS = np.array([5, 16, 11], np.int32)


def _close(got, want, atol_factor=1e-4):
    want = np.asarray(want, np.float32)
    atol = atol_factor * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=atol)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "arctic-480b",
                                  "chameleon-34b"])
def test_forward_prefill_decode_match_jax(name, quant):
    overrides = dict(dtype="float32", remat=False)
    jcfg = J_REGISTRY[name].reduced(**overrides)
    tcfg = get_config(name).reduced(**overrides)
    japi, tapi = j_get_model(jcfg), get_model(tcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    if quant:
        jparams = j_deploy(jparams, JQ.QuantConfig())
    tparams = params_from_numpy(jax_tree_to_numpy(jparams), "cpu")
    rng = np.random.default_rng(1)
    b, s = len(LENGTHS), 16
    toks = rng.integers(0, jcfg.vocab_size, size=(b, s)).astype(np.int32)

    _close(tapi.forward(tparams, {"tokens": torch.from_numpy(toks)}),
           japi.forward(jparams, {"tokens": jnp.asarray(toks)}))
    jlog, jcache = jax.jit(japi.prefill)(
        jparams, {"tokens": jnp.asarray(toks)}, japi.init_cache(b, MAX_LEN),
        lengths=jnp.asarray(LENGTHS))
    tlog, tcache = tapi.prefill(
        tparams, {"tokens": torch.from_numpy(toks)},
        tapi.init_cache(b, MAX_LEN, "cpu"), lengths=torch.from_numpy(LENGTHS))
    _close(tlog, jlog)
    jdecode = jax.jit(japi.decode)
    for _ in range(8):
        nxt = np.array(jnp.argmax(jlog[:, :jcfg.vocab_size], -1), np.int32)
        jlog, jcache = jdecode(jparams, jnp.asarray(nxt), jcache)
        tlog, tcache = tapi.decode(tparams, torch.from_numpy(nxt), tcache)
        _close(tlog, jlog)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))


@pytest.fixture(scope="module")
def vlm():
    overrides = dict(dtype="float32", remat=False)
    jcfg = J_REGISTRY["chameleon-34b"].reduced(**overrides)
    tcfg = get_config("chameleon-34b").reduced(**overrides)
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, tcfg, jparams, params_from_numpy(
        jax_tree_to_numpy(jparams), "cpu")


@pytest.mark.parametrize("mode", list(MODES))
def test_vlm_engine_matches_jax_engine(vlm, mode):
    jcfg, tcfg, jparams, tparams = vlm
    assert tcfg.family == "vlm" and tcfg.qk_norm
    assert_same_serving(*serve_both(jcfg, tcfg, jparams, tparams, mode),
                        mode)
