"""Port parity for the training step (``repro_torch.train.loop``) and the
data pipeline (``repro_torch.data.pipeline``) on the CPU, on the JAX
training tests' tiny dense model (2 layers, d64, f32).

- The data: ``SyntheticLM`` (with and without frames) and ``ByteCorpus``
  batches equal the JAX package's bit for bit at several steps;
  ``make_dataset`` picks the same source; ``shard_batch`` gives tensors
  on the device and refuses a mesh (item 12c).
- ``tests/test_train.py``'s cases on the port: the loss falls, int8
  moments track f32, two accumulated microbatches equal the full batch,
  clipping shrinks the update and the norm is reported before the clip,
  and ``make_eval_step`` is the loss.
- A 25-step trajectory from the same weights on the same batches: the
  port's loss at every step within 2e-4 of JAX's (relative), its
  ``lr_scale`` within an f32 ulp and its ``grad_norm`` within 1e-4. Both
  start from the same weights and state but round differently, so
  parameters are not compared elementwise after the steps: at step 1
  Adam's step is about sign(g) lr, and an entry whose gradient is about
  0 can move by lr either way in the two frameworks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.data import pipeline as JD
from repro.models.model import get_model as j_get_model
from repro.optim import adamw as JA
from repro.train.loop import make_train_step as j_make_train_step
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.data import pipeline as TD
from repro_torch.dist.sharding import param_specs
from repro_torch.launch.mesh import Mesh, single_device_mesh
from repro_torch.models.model import get_model, make_batch
from repro_torch.optim import adamw
from repro_torch.train.loop import make_eval_step, make_train_step
from test_torch_model import jax_tree_to_numpy

TINY = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
            vocab_pad_multiple=64, dtype="float32")
CFG = TConfig(**TINY)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """The tiny models' training steps run many small ops, which one
    intra-op thread does far faster than a pool contending with the other
    test workers' pools (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """The JAX init of the tiny model and the same weights in the port."""
    jparams = j_get_model(JConfig(**TINY)).init(jax.random.PRNGKey(0))
    return jparams, params_from_numpy(jax_tree_to_numpy(jparams), "cpu")


def _run(params, ocfg, steps=25, accum=1, batch=8, seq=32):
    cfg = dataclasses.replace(CFG, grad_accum=accum)
    opt = adamw.init(params, ocfg)
    fn = make_train_step(get_model(cfg), ocfg, total_steps=100, warmup=5)
    ds = TD.make_dataset(cfg, batch=batch, seq=seq, seed=0)
    metrics = []
    for s in range(steps):
        params, opt, m = fn(params, opt, TD.shard_batch(ds.batch_at(s),
                                                        device="cpu"), s)
        metrics.append({k: float(v) for k, v in m.items()})
    return params, [m["loss"] for m in metrics], metrics


# -- data ---------------------------------------------------------------------

@pytest.mark.parametrize("frames", [None, (12, 5)], ids=["lm", "frames"])
def test_synthetic_batches_equal_jax(frames):
    want = JD.SyntheticLM(vocab_size=300, batch=3, seq=17, seed=4,
                          frames=frames)
    got = TD.SyntheticLM(vocab_size=300, batch=3, seq=17, seed=4,
                         frames=frames)
    for step in (0, 1, 7, 1000):
        a, b = want.batch_at(step), got.batch_at(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(got.batch_at(0)["tokens"],
                              got.batch_at(1)["tokens"])
    first = next(iter(got))
    np.testing.assert_array_equal(first["tokens"], got.batch_at(0)["tokens"])


def test_byte_corpus_batches_equal_jax():
    root = "src/repro_torch/configs"
    want = JD.ByteCorpus(batch=4, seq=24, root=root, seed=2)
    got = TD.ByteCorpus(batch=4, seq=24, root=root, seed=2)
    for step in (0, 5):
        a, b = want.batch_at(step), got.batch_at(step)
        for k in ("tokens", "targets"):
            np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["targets"][:, :-1])


def test_make_dataset_and_shard_batch():
    audio = dataclasses.replace(CFG, is_encoder_decoder=True, enc_seq=6,
                                d_feat=3)
    for cfg, jcfg in ((CFG, JConfig(**TINY)),
                      (audio, dataclasses.replace(JConfig(**TINY),
                                                  is_encoder_decoder=True,
                                                  enc_seq=6, d_feat=3))):
        a = JD.make_dataset(jcfg, batch=2, seq=8, seed=1).batch_at(3)
        b = TD.make_dataset(cfg, batch=2, seq=8, seed=1).batch_at(3)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        t = TD.shard_batch(b, device="cpu")
        for k in b:
            assert isinstance(t[k], torch.Tensor)
            np.testing.assert_array_equal(t[k].numpy(), b[k])
    assert isinstance(TD.make_dataset(CFG, 2, 8, source="bytes"),
                      TD.ByteCorpus)
    # on a mesh, rank 1 of ("data", "model") = (2, 1) keeps its row
    rows = TD.shard_batch(b, mesh=Mesh(2, 1, 1, "cpu"), device="cpu")
    for k in b:
        np.testing.assert_array_equal(rows[k].numpy(), b[k][1:2])


# -- the step -----------------------------------------------------------------

@pytest.fixture(scope="module")
def f32_run(weights):
    """25 steps at lr 1e-3 with f32 moments: (params, losses, metrics)."""
    return _run(weights[1], adamw.AdamWConfig(lr=1e-3))


def test_loss_decreases(f32_run):
    _, losses, _ = f32_run
    assert losses[-1] < losses[0] - 0.3


def test_int8_moments_track_f32(weights, f32_run):
    _, l32, _ = f32_run
    _, l8, _ = _run(weights[1], adamw.AdamWConfig(lr=1e-3,
                                                  int8_moments=True))
    assert l8[-1] < l8[0] - 0.3
    assert abs(l8[-1] - l32[-1]) < 0.3


def test_grad_accum_matches_full_batch(weights):
    """accum=2 over the same global batch = one full-batch step (equal
    microbatches, so the mean loss is the mean of their means)."""
    ocfg = adamw.AdamWConfig(lr=1e-3)
    p1, l1, _ = _run(weights[1], ocfg, steps=3, accum=1)
    p2, l2, _ = _run(weights[1], ocfg, steps=3, accum=2)
    np.testing.assert_allclose(l1[-1], l2[-1], rtol=1e-4)
    for a, b in zip(adamw.tree_leaves(p1), adamw.tree_leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-5)


def test_grad_accum_in_bf16(weights):
    """``grad_accum_dtype="bfloat16"`` sums the microbatches' gradients
    in bf16: the step runs and stays near the f32 accumulation."""
    ocfg = adamw.AdamWConfig(lr=1e-3)
    cfg = dataclasses.replace(CFG, grad_accum=2,
                              grad_accum_dtype="bfloat16")
    batch = TD.shard_batch(TD.make_dataset(cfg, 8, 32).batch_at(0), None,
                           "cpu")
    outs = []
    for c in (cfg, dataclasses.replace(cfg, grad_accum_dtype="float32")):
        fn = make_train_step(get_model(c), ocfg, total_steps=100, warmup=5)
        outs.append(fn(weights[1], adamw.init(weights[1], ocfg), batch, 3))
    assert float(outs[0][2]["loss"]) == float(outs[1][2]["loss"])
    assert float(outs[0][2]["grad_norm"]) == pytest.approx(
        float(outs[1][2]["grad_norm"]), rel=1e-2)


def test_gradient_clipping_shrinks_update(weights):
    """With a clip far below the norm, epsilon dominates sqrt(v) and the
    clipped step is much smaller; the reported norm is the pre-clip one."""
    params = weights[1]
    batch = make_batch(CFG, 0, 8, 32, device="cpu")

    def delta(clip):
        ocfg = adamw.AdamWConfig(lr=1e-3, clip_norm=clip, weight_decay=0.0)
        fn = make_train_step(get_model(CFG), ocfg, total_steps=100, warmup=1)
        p2, _, m = fn(params, adamw.init(params, ocfg), batch, 5)
        d = sum(float((a - c).abs().sum()) for a, c in zip(
            adamw.tree_leaves(params), adamw.tree_leaves(p2)))
        return d, float(m["grad_norm"])

    d_clip, gn1 = delta(1e-12)
    d_free, gn2 = delta(1e9)
    assert d_clip < d_free * 0.5
    assert gn1 == pytest.approx(gn2, rel=1e-5)


def test_eval_step_is_the_loss_and_specs_raise(weights):
    """``make_eval_step`` is the loss; ``grad_specs`` without a
    NamedSharding a leaf raises, and specs on a mesh of one cut nothing:
    the step is the single-device one."""
    api = get_model(CFG)
    batch = make_batch(CFG, 1, 4, 16, device="cpu")
    assert float(make_eval_step(api)(weights[1], batch)) == \
        float(api.loss(weights[1], batch))
    with pytest.raises(ValueError, match="NamedSharding"):
        make_train_step(api, adamw.AdamWConfig(), grad_specs={})
    ocfg = adamw.AdamWConfig(lr=1e-3)
    specs = param_specs(weights[1], single_device_mesh("cpu"))
    outs = [make_train_step(api, ocfg, grad_specs=g)(
        weights[1], adamw.init(weights[1], ocfg), batch, 0)
        for g in (None, specs)]
    assert float(outs[0][2]["loss"]) == float(outs[1][2]["loss"])
    for a, b in zip(adamw.tree_leaves(outs[0][0]),
                    adamw.tree_leaves(outs[1][0])):
        assert torch.equal(a, b)


def test_trajectory_matches_jax(weights, f32_run):
    jparams = weights[0]
    jcfg = JConfig(**TINY)
    jocfg = JA.AdamWConfig(lr=1e-3)
    jfn = jax.jit(j_make_train_step(j_get_model(jcfg), jocfg,
                                    total_steps=100, warmup=5))
    ds = JD.make_dataset(jcfg, batch=8, seq=32, seed=0)
    p, o = jparams, JA.init(jparams, jocfg)
    want = []
    for s in range(25):
        b = jax.tree_util.tree_map(jnp.asarray, ds.batch_at(s))
        p, o, m = jfn(p, o, b, s)
        want.append({k: float(v) for k, v in m.items()})
    _, _, got = f32_run
    for w, g in zip(want, got):
        assert g["loss"] == pytest.approx(w["loss"], rel=2e-4)
        assert abs(g["lr_scale"] - w["lr_scale"]) <= \
            float(np.spacing(np.float32(w["lr_scale"])))
        assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=1e-4)
    assert got[-1]["loss"] < got[0]["loss"] - 0.3
