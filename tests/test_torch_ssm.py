"""Port parity for the recurrent cells (``repro_torch.models.ssm`` and
``repro_torch.models.xlstm``) against ``repro.models.ssm`` and
``repro.models.xlstm``, on the CPU.

Every case of ``tests/test_ssm.py`` runs on both packages, at its shapes
and tolerances, the inputs made with numpy from a seed and the JAX
weights carried across by ``bridge.params_from_numpy``:

- the chunked SSD scan against the naive recurrence and against JAX
  (rtol 1e-4, atol 1e-5: other orders of f32 additions), chunk-size
  invariance, and a 512-step sequence of strong decays staying finite;
- the Mamba2 mixer's forward and its step, each against JAX and the step
  against the forward (1e-4 / 1e-5);
- the mLSTM's chunkwise forward and its stabilized step, each against
  JAX, the step against the forward at rtol/atol 2e-3 (the reference's
  own gap between its two paths: it rounds k / sqrt(hd) and the
  normalizer's floor apart), and the chunkwise-to-step state hand-off;
- the sLSTM forward and step against JAX and each other (1e-4 / 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.models import ssm as JS
from repro.models import xlstm as JX
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm as TS
from repro_torch.models import xlstm as TX
from test_torch_engine import jax_tree_to_numpy

RTOL, ATOL = 1e-4, 1e-5
RNN_TOL = 2e-3


def naive_ssd(x, la, b, c):
    bsz, t_len, h, p = x.shape
    h_state = np.zeros((bsz, h, p, b.shape[-1]))
    ys = []
    for t in range(t_len):
        h_state = h_state * np.exp(la[:, t])[..., None, None] + \
            np.einsum("bhp,bhn->bhpn", x[:, t], b[:, t])
        ys.append(np.einsum("bhpn,bhn->bhp", h_state, c[:, t]))
    return np.stack(ys, 1), h_state


def _inputs(seed, bsz, seq, h, p, n, shift=0.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, seq, h, p)).astype(np.float32)
    raw = rng.standard_normal((bsz, seq, h)).astype(np.float32) - shift
    la = -np.logaddexp(raw, 0.0).astype(np.float32)     # -softplus
    b = rng.standard_normal((bsz, seq, h, n)).astype(np.float32)
    c = rng.standard_normal((bsz, seq, h, n)).astype(np.float32)
    return x, la, b, c


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("seq,chunk", [(13, 4), (32, 8), (7, 16), (64, 64)])
def test_ssd_chunked_matches_naive_and_jax(seq, chunk):
    arrays = _inputs(0, 2, seq, 3, 5, 4)
    y, h = TS.ssd_chunked(*_t(*arrays), chunk=chunk)
    y_ref, h_ref = naive_ssd(*arrays)
    _close(y, y_ref)
    _close(h, h_ref)
    jy, jh = JS.ssd_chunked(*_j(*arrays), chunk=chunk)
    _close(y, jy)
    _close(h, jh)


def test_ssd_chunk_size_invariance():
    arrays = _t(*_inputs(1, 1, 24, 2, 4, 3))
    y1, h1 = TS.ssd_chunked(*arrays, chunk=4)
    y2, h2 = TS.ssd_chunked(*arrays, chunk=24)
    _close(y1, y2.numpy())
    _close(h1, h2.numpy())


def test_ssd_decay_stability_long_sequence():
    """No overflow or NaN over 512 steps of strong decays (f32), and the
    same values as JAX."""
    arrays = _inputs(10, 1, 512, 2, 4, 4, shift=3.0)
    y, h = TS.ssd_chunked(*_t(*arrays), chunk=128)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    jy, jh = JS.ssd_chunked(*_j(*arrays), chunk=128)
    _close(y, jy)
    _close(h, jh)


def test_segsum_is_jax_segsum():
    la = np.random.default_rng(2).standard_normal((2, 3, 6)).astype(
        np.float32)
    got = TS._segsum(torch.from_numpy(la)).numpy()
    want = np.asarray(JS._segsum(jnp.asarray(la)))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)


KW = dict(dtype="float32")
MCFG_KW = dict(name="m", family="hybrid", n_layers=1, d_model=64,
               n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=128,
               ssm_state=16, ssm_head_dim=16, **KW)
XCFG_KW = dict(name="x", family="ssm", n_layers=2, d_model=64, n_heads=4,
               n_kv_heads=4, d_ff=0, vocab_size=128, vocab_pad_multiple=64,
               xlstm_slstm_every=2, remat=False, **KW)


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _carry(tree):
    return params_from_numpy(jax_tree_to_numpy(tree), "cpu")


def test_mamba2_forward_and_step_match_jax():
    jcfg, tcfg = JModelConfig(**MCFG_KW), ModelConfig(**MCFG_KW)
    jp = JS.init_mamba2(jax.random.PRNGKey(2), jcfg)
    tp = _carry(jp)
    x = _x(3, (2, 20, 64))
    y, (cv_t, h_t) = TS.mamba2_fwd(tp, torch.from_numpy(x), tcfg,
                                   return_state=True)
    jy, (jcv, jh) = JS.mamba2_fwd(jp, jnp.asarray(x), jcfg,
                                  return_state=True)
    _close(y, jy)
    _close(cv_t, jcv)
    _close(h_t, jh)
    cv, st = TS.init_mamba_state(tcfg, 2, device="cpu")
    jcv, jst = JS.init_mamba_state(jcfg, 2)
    ys = []
    for t in range(20):
        yt, (cv, st) = TS.mamba2_step(tp, torch.from_numpy(x[:, t:t + 1]),
                                      tcfg, cv, st)
        jyt, (jcv, jst) = JS.mamba2_step(jp, jnp.asarray(x[:, t:t + 1]),
                                         jcfg, jcv, jst)
        _close(yt, jyt)
        ys.append(yt)
    _close(torch.cat(ys, 1), y.numpy())
    _close(st, h_t.numpy())
    _close(st, jst)


def test_mlstm_forward_and_step_match_jax():
    jcfg, tcfg = JModelConfig(**XCFG_KW), ModelConfig(**XCFG_KW)
    jp = JX.init_mlstm(jax.random.PRNGKey(4), jcfg)
    tp = _carry(jp)
    x = _x(5, (2, 16, 64))
    y = TX.mlstm_fwd(tp, torch.from_numpy(x), tcfg)
    _close(y, JX.mlstm_fwd(jp, jnp.asarray(x), jcfg))
    state = TX.init_mlstm_state(tcfg, 2, device="cpu")
    jstate = JX.init_mlstm_state(jcfg, 2)
    ys = []
    for t in range(16):
        yt, state = TX.mlstm_step(tp, torch.from_numpy(x[:, t:t + 1]), tcfg,
                                  state)
        jyt, jstate = JX.mlstm_step(jp, jnp.asarray(x[:, t:t + 1]), jcfg,
                                    jstate)
        _close(yt, jyt)
        ys.append(yt)
    for got, want in zip(state, jstate):
        _close(got, want)
    _close(torch.cat(ys, 1), y.numpy(), rtol=RNN_TOL, atol=RNN_TOL)


def test_slstm_forward_and_step_match_jax():
    jcfg, tcfg = JModelConfig(**XCFG_KW), ModelConfig(**XCFG_KW)
    jp = JX.init_slstm(jax.random.PRNGKey(6), jcfg)
    tp = _carry(jp)
    x = _x(7, (2, 12, 64))
    y, st = TX.slstm_fwd(tp, torch.from_numpy(x), tcfg, return_state=True)
    jy, jst = JX.slstm_fwd(jp, jnp.asarray(x), jcfg, return_state=True)
    _close(y, jy)
    for got, want in zip(st, jst):
        _close(got, want)
    state = TX.init_slstm_state(tcfg, 2, device="cpu")
    ys = []
    for t in range(12):
        yt, state = TX.slstm_step(tp, torch.from_numpy(x[:, t:t + 1]), tcfg,
                                  state)
        ys.append(yt)
    _close(torch.cat(ys, 1), y.numpy())
    for got, want in zip(state, st):
        _close(got, want.numpy())


def test_mlstm_state_handoff_matches_jax():
    """The chunkwise path's emitted state continues in the step path: a
    prefix of 12 tokens through the chunkwise form, the next 8 through
    the step, against the full chunkwise pass (2e-3) and against JAX's
    hand-off (1e-4 / 1e-5)."""
    jcfg, tcfg = JModelConfig(**XCFG_KW), ModelConfig(**XCFG_KW)
    jp = JX.init_mlstm(jax.random.PRNGKey(8), jcfg)
    tp = _carry(jp)
    x = _x(9, (1, 20, 64))
    y_full = TX.mlstm_fwd(tp, torch.from_numpy(x), tcfg)
    _, state = TX.mlstm_fwd(tp, torch.from_numpy(x[:, :12]), tcfg,
                            return_state=True)
    _, jstate = JX.mlstm_fwd(jp, jnp.asarray(x[:, :12]), jcfg,
                             return_state=True)
    for got, want in zip(state, jstate):
        _close(got, want)
    ys = []
    for t in range(12, 20):
        yt, state = TX.mlstm_step(tp, torch.from_numpy(x[:, t:t + 1]), tcfg,
                                  state)
        jyt, jstate = JX.mlstm_step(jp, jnp.asarray(x[:, t:t + 1]), jcfg,
                                    jstate)
        _close(yt, jyt)
        ys.append(yt)
    _close(torch.cat(ys, 1), y_full[:, 12:].numpy(), rtol=RNN_TOL,
           atol=RNN_TOL)


def test_mixers_keep_the_axllm_matmul_under_reuse():
    """As in the JAX package, a recurrent mixer's projections take the
    AxLLM matmul whatever the engine's impl: "reuse" runs them on it and
    "reuse_ref" on its plain version."""
    assert TS.mixer_impl("reuse") == "auto"
    assert TS.mixer_impl("reuse_ref") == "ref"
    assert TS.mixer_impl("cuda") == "cuda"
