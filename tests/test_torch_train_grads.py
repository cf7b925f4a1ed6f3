"""Port parity for the gradients training takes, on the CPU.

- Every family's ``get_model(cfg).loss`` (dense, moe, vlm, ssm, hybrid,
  audio; the ``reduced()`` float32 configs with their own ``remat=True``)
  against ``jax.value_and_grad`` (jitted) of the JAX package's ``loss``
  on the same weights (``bridge.params_from_numpy``) and batch: the loss
  within 1e-5
  relative, every parameter leaf's gradient within 1e-4 of that leaf's
  largest JAX gradient (the two frameworks sum in other orders; the
  largest gap seen is 4e-6), in the same leaf order and shape. The JAX
  side differentiates its plain attention (``impl="auto"`` is its ``ref``
  off a TPU): its Pallas flash kernel has no VJP.
- Remat changes no gradient: the port's dense loss with and without
  ``remat`` gives the same gradients.
- ``ref.flash_attention_bwd_ref`` (the backward kernel's plain version,
  by its formula) against autograd of ``ref.attention_ref``: GQA ratios
  1, 3 and 8, causal and not, Sq < Sk, Sq = Sk and (non-causal) Sq > Sk,
  head dims 16 to 128, within 2e-6 of each gradient's scale in float32.
- ``FlashAttentionFn`` (forward and backward through the wrappers, which
  take the plain versions for CPU tensors) gives autograd's gradients of
  the plain path, and ``ops.flash_attention`` stays differentiable on the
  CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models.model import get_model as j_get_model
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as t_get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import FlashAttentionFn
from repro_torch.models.model import get_model as t_get_model
from repro_torch.optim import adamw
from repro_torch.train.loop import _grad_fn
from test_torch_model import jax_tree_to_numpy
from test_torch_train import one_intra_op_thread  # noqa: F401 (autouse)

FAMILIES = {"dense": "repro-100m", "moe": "qwen2-moe-a2.7b",
            "vlm": "chameleon-34b", "ssm": "xlstm-1.3b",
            "hybrid": "zamba2-1.2b", "audio": "whisper-small"}


def _batch(cfg, seed, b=2, s=16):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    out = {"tokens": tok, "targets": np.roll(tok, -1, axis=1)}
    if cfg.is_encoder_decoder:
        out["frames"] = rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_feat)).astype(np.float32)
    return out


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_gradients_match_jax(family):
    arch = FAMILIES[family]
    jcfg = j_get_config(arch).reduced(dtype="float32")
    tcfg = t_get_config(arch).reduced(dtype="float32")
    assert jcfg.remat and tcfg.remat
    japi, tapi = j_get_model(jcfg), t_get_model(tcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax_tree_to_numpy(jparams), "cpu")
    batch = _batch(jcfg, 1)
    jloss, jgrads = jax.jit(jax.value_and_grad(japi.loss))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, tgrads = _grad_fn(tapi)(
        tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
    # the API's loss is the same function without the gradient
    with torch.no_grad():
        again = tapi.loss(tparams, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    assert float(again) == float(tloss)
    want = jax.tree_util.tree_leaves(jgrads)
    got = adamw.tree_leaves(tgrads)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        tol = 1e-4 * max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g.numpy() - w).max()) <= tol


def test_remat_changes_no_gradient():
    cfg = t_get_config("repro-100m").reduced(dtype="float32")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 2).items()}
    params = t_get_model(cfg).init(seed=0, device="cpu")
    _, with_remat = _grad_fn(t_get_model(cfg))(params, batch)
    _, without = _grad_fn(t_get_model(
        dataclasses.replace(cfg, remat=False)))(params, batch)
    for a, b in zip(adamw.tree_leaves(with_remat),
                    adamw.tree_leaves(without)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# (B, Sq, Sk, H, Hk, d, causal)
BWD_CASES = [(2, 16, 16, 4, 4, 16, True), (2, 24, 24, 6, 2, 32, True),
             (1, 40, 40, 8, 1, 64, True), (1, 9, 33, 16, 2, 128, True),
             (2, 20, 64, 4, 2, 16, False), (1, 30, 12, 6, 2, 32, False),
             (1, 33, 33, 3, 1, 64, False)]


def _qkv(case, seed):
    b, sq, sk, h, hk, d, _ = case
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, sq, h, d, generator=g)
    k = torch.randn(b, sk, hk, d, generator=g)
    v = torch.randn(b, sk, hk, d, generator=g)
    return q, k, v, torch.randn(b, sq, h, d, generator=g)


def _scale_close(got, want, rel):
    tol = rel * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol


@pytest.mark.parametrize("case", BWD_CASES,
                         ids=["B{}-Sq{}-Sk{}-H{}-Hk{}-d{}-{}".format(
                             *c[:6], "causal" if c[6] else "full")
                             for c in BWD_CASES])
def test_flash_attention_bwd_ref_matches_autograd(case):
    q, k, v, do = _qkv(case, 3)
    causal = case[-1]
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ref.attention_ref(*leaves, causal=causal)
    want = torch.autograd.grad(out, leaves, do)
    got = ref.flash_attention_bwd_ref(q, k, v, out.detach(), do, causal)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        _scale_close(g, w, 2e-6)


@pytest.mark.parametrize("case", [BWD_CASES[1], BWD_CASES[4],
                                  BWD_CASES[5]], ids=["causal", "full",
                                                      "sq-above-sk"])
def test_flash_attention_fn_matches_plain_autograd(case):
    q, k, v, do = _qkv(case, 4)
    causal = case[-1]
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fn = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want_out = ref.attention_ref(*plain, causal=causal)
    want = torch.autograd.grad(want_out, plain, do)
    out = FlashAttentionFn.apply(*fn, causal)
    got = torch.autograd.grad(out, fn, do)
    torch.testing.assert_close(out, want_out, rtol=0, atol=0)
    for g, w in zip(got, want):
        _scale_close(g, w, 2e-6)
    # the plain path stays differentiable through the public op on the CPU
    again = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got_ops = torch.autograd.grad(
        ops.flash_attention(*again, causal=causal), again, do)
    for g, w in zip(got_ops, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
