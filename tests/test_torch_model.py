"""Port parity: the dense decoder of ``repro_torch.models`` against the JAX
package on ``repro_100m.CONFIG.reduced(dtype="float32", remat=False)``,
with the JAX weights carried across by ``bridge.params_from_numpy``.

Compared: logits of ``forward``, of a ragged ``prefill`` and of 16
``decode_step``s (teacher-forced with the same tokens), for fp32 weights,
int8 weights and an int8 KV cache. Tolerance: float32 logits agree to
rtol 1e-4 with an atol of 1e-4 times the logit scale (the two frameworks
sum in other orders, and RoPE's pow/sin/cos differ in the last ulp). With
the int8 KV cache the atol is 1e-3 times the scale: a key or value that
sits on a rounding boundary may take the neighbouring code in one
framework, which moves that entry by a whole code step (1/127 of its
row's absmax).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.repro_100m import CONFIG as J_CONFIG
from repro.core import quantization as JQ
from repro.core.axllm_linear import deploy_quantize as j_deploy
from repro.models.model import get_model as j_get_model
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.repro_100m import CONFIG as T_CONFIG
from repro_torch.models import transformer as T
from repro_torch.models.model import get_model as t_get_model

MAX_LEN = 48
LENGTHS = np.array([5, 16, 11], np.int32)


def jax_tree_to_numpy(tree):
    """A JAX parameter tree as nested dicts of numpy arrays (QTensors as
    dicts of their fields) -- the form the bridge takes."""
    if isinstance(tree, JQ.QTensor):
        d = {f.name: getattr(tree, f.name)
             for f in dataclasses.fields(JQ.QTensor)}
        d["codes"], d["scale"] = np.asarray(tree.codes), np.asarray(tree.scale)
        return d
    if isinstance(tree, dict):
        return {k: jax_tree_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def _close(got, want, atol_factor=1e-4):
    want = np.asarray(want, np.float32)
    atol = atol_factor * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=atol)


def _models(quant_weights: bool, quant_kv: bool):
    overrides = dict(dtype="float32", remat=False, quant_kv=quant_kv)
    jcfg = J_CONFIG.reduced(**overrides)
    tcfg = T_CONFIG.reduced(**overrides)
    japi = j_get_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    if quant_weights:
        jparams = j_deploy(jparams, JQ.QuantConfig())
    tparams = params_from_numpy(jax_tree_to_numpy(jparams), "cpu")
    return jcfg, tcfg, japi, jparams, t_get_model(tcfg), tparams


MODES = [(False, False), (True, False), (True, True)]
MODE_IDS = ["fp32", "int8", "int8-kv8"]


@pytest.mark.parametrize("quant_weights,quant_kv", MODES, ids=MODE_IDS)
def test_forward_prefill_decode_match_jax(quant_weights, quant_kv):
    jcfg, tcfg, japi, jparams, tapi, tparams = _models(quant_weights,
                                                       quant_kv)
    atol_factor = 1e-3 if quant_kv else 1e-4
    rng = np.random.default_rng(1)
    b, s = len(LENGTHS), 16
    toks = rng.integers(0, jcfg.vocab_size, size=(b, s)).astype(np.int32)

    _close(tapi.forward(tparams, {"tokens": torch.from_numpy(toks)}),
           japi.forward(jparams, {"tokens": jnp.asarray(toks)}))

    jcache = japi.init_cache(b, MAX_LEN)
    tcache = tapi.init_cache(b, MAX_LEN, "cpu")
    jlog, jcache = jax.jit(japi.prefill)(jparams, {"tokens": jnp.asarray(toks)},
                                         jcache, lengths=jnp.asarray(LENGTHS))
    tlog, tcache = tapi.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                                tcache, lengths=torch.from_numpy(LENGTHS))
    _close(tlog, jlog)
    np.testing.assert_array_equal(tcache["pos"].numpy(), LENGTHS)

    jdecode = jax.jit(japi.decode)
    for _ in range(16):
        nxt = np.array(jnp.argmax(jlog[:, :jcfg.vocab_size], -1), np.int32)
        jlog, jcache = jdecode(jparams, jnp.asarray(nxt), jcache)
        tlog, tcache = tapi.decode(tparams, torch.from_numpy(nxt), tcache)
        _close(tlog, jlog, atol_factor)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))


@pytest.mark.parametrize("quant_kv", [False, True], ids=["fp32kv", "int8kv"])
def test_decode_past_cache_end_drops_write_like_jax(quant_kv):
    """A free slot's cursor runs past max_len: JAX drops that row's
    out-of-bounds scatter write; the port must neither raise nor touch any
    other entry, and give the same logits and cache."""
    jcfg, tcfg, japi, jparams, tapi, tparams = _models(True, quant_kv)
    b, s = 3, 8
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jcfg.vocab_size, size=(b, s)).astype(np.int32)
    lengths = np.array([8, 3, 6], np.int32)
    jcache = japi.init_cache(b, s)
    tcache = tapi.init_cache(b, s, "cpu")
    _, jcache = japi.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcache,
                             lengths=jnp.asarray(lengths))
    tapi.prefill(tparams, {"tokens": torch.from_numpy(toks)}, tcache,
                 lengths=torch.from_numpy(lengths))
    pos = np.array([s + 5, 3, s], np.int32)       # rows 0, 2 past the end
    jcache = dict(jcache, pos=jnp.asarray(pos))
    tcache["pos"] = torch.from_numpy(pos)
    before = {k: v.clone() for k, v in tcache.items()}
    nxt = np.array([1, 2, 3], np.int32)
    jlog, jcache = japi.decode(jparams, jnp.asarray(nxt), jcache)
    tlog, tcache = tapi.decode(tparams, torch.from_numpy(nxt), tcache)
    _close(tlog, jlog)
    for name in ("k", "v") + (("k_scale", "v_scale") if quant_kv else ()):
        got = tcache[name].numpy()
        np.testing.assert_allclose(got, np.asarray(jcache[name]), rtol=1e-4,
                                   atol=1e-3 if quant_kv else 1e-5)
        # rows past the end are untouched; row 1 changed only at pos 3
        for row in (0, 2):
            np.testing.assert_array_equal(got[:, row],
                                          before[name][:, row].numpy())
        changed = np.any(got[:, 1] != before[name][:, 1].numpy(),
                         axis=(0, 2, 3))
        assert changed.nonzero()[0].tolist() == [3]
    np.testing.assert_array_equal(tcache["pos"].numpy(), pos + 1)


def test_init_params_layout_and_seed():
    cfg = T_CONFIG.reduced(dtype="float32")
    p1 = T.init_params(cfg, seed=3, device="cpu")
    p2 = T.init_params(cfg, seed=3, device="cpu")
    wq = p1["layers"]["attn"]["wq"]
    assert wq.shape == (cfg.n_layers, cfg.d_model,
                        cfg.n_heads * cfg.resolved_head_dim)
    assert p1["embed"]["embedding"].shape == (cfg.padded_vocab, cfg.d_model)
    assert torch.equal(wq, p2["layers"]["attn"]["wq"])
    assert float(wq.abs().max()) <= 3 * cfg.d_model ** -0.5 + 1e-6


def test_unported_family_raises():
    cfg = dataclasses.replace(T_CONFIG, family="moe")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_get_model(cfg)
