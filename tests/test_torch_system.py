"""The paper's workflow on the port, end to end on the CPU
(``tests/test_system.py`` on ``repro_torch``): train a tiny dense model
with the port's step and data, deploy-quantize it to int8, read the Result
Cache's reuse rate off the trained codes and serve it.

- Training converges: the loss falls by more than 1 nat in 60 steps, and
  its trajectory stays within 1e-3 (relative) of the JAX package's on the
  same weights and batches at every logged step.
- The int8 model's loss on held-out batches lies within 2% of the float
  model's (the paper: int8 keeps accuracy within about 1%).
- Fig. 8's statistic on the trained weights: the reuse rate of layer 0's
  ``up`` codes (256-wide segments) exceeds 0.5, and the unsegmented rate
  is at least the segmented one.
- Quantized serving agrees with float serving on at least 75% of the
  greedy tokens, as in the JAX test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.data.pipeline import make_dataset as j_make_dataset
from repro.models.model import get_model as j_get_model
from repro.optim import adamw as JA
from repro.train.loop import make_train_step as j_make_train_step
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import ModelConfig
from repro_torch.core import reuse as R
from repro_torch.core.axllm_linear import deploy_quantize
from repro_torch.core.quantization import QTensor, QuantConfig, decode_codes
from repro_torch.data.pipeline import make_dataset, shard_batch
from repro_torch.models.model import get_model
from repro_torch.optim import adamw
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.loop import make_train_step
from test_torch_model import jax_tree_to_numpy
from test_torch_train import one_intra_op_thread  # noqa: F401 (autouse)

FIELDS = dict(name="sys", family="dense", n_layers=2, d_model=64, n_heads=4,
              n_kv_heads=2, d_ff=256, vocab_size=256, head_dim=16,
              vocab_pad_multiple=64, dtype="float32")
CFG = ModelConfig(**FIELDS)
STEPS, LOG = 60, (0, 9, 19, 29, 39, 49, 59)


@pytest.fixture(scope="module")
def trained():
    jcfg = JConfig(**FIELDS)
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    api = get_model(CFG)
    params = params_from_numpy(jax_tree_to_numpy(jparams), "cpu")
    ocfg = adamw.AdamWConfig(lr=2e-3)
    opt = adamw.init(params, ocfg)
    fn = make_train_step(api, ocfg, total_steps=80, warmup=5)
    ds = make_dataset(CFG, batch=16, seq=32, seed=0)
    losses = []
    for s in range(STEPS):
        params, opt, m = fn(params, opt, shard_batch(ds.batch_at(s),
                                                     device="cpu"), s)
        losses.append(float(m["loss"]))
    # the JAX package's run from the same weights, at the logged steps
    jocfg = JA.AdamWConfig(lr=2e-3)
    jfn = jax.jit(j_make_train_step(j_get_model(jcfg), jocfg,
                                    total_steps=80, warmup=5))
    jds = j_make_dataset(jcfg, batch=16, seq=32, seed=0)
    p, o, jlosses = jparams, JA.init(jparams, jocfg), []
    for s in range(STEPS):
        p, o, m = jfn(p, o, jax.tree_util.tree_map(jnp.asarray,
                                                   jds.batch_at(s)), s)
        jlosses.append(float(m["loss"]))
    return api, params, losses, jlosses


def test_training_converges_as_jax_does(trained):
    _, _, losses, jlosses = trained
    assert losses[-1] < losses[0] - 1.0
    for s in LOG:
        assert losses[s] == pytest.approx(jlosses[s], rel=1e-3)


def test_quantized_model_loss_within_band(trained):
    api, params, _, _ = trained
    qparams = deploy_quantize(params, QuantConfig())
    b = shard_batch(make_dataset(CFG, batch=16, seq=32, seed=99).batch_at(0),
                    device="cpu")
    with torch.no_grad():
        l_fp = float(api.loss(params, b))
        l_q = float(api.loss(qparams, b))
    assert abs(l_q - l_fp) / l_fp < 0.02


def test_reuse_rate_on_trained_weights(trained):
    _, params, _, _ = trained
    w = deploy_quantize(params, QuantConfig())["layers"]["ffn"]["up"]
    assert isinstance(w, QTensor)
    codes = decode_codes(w)[0].numpy()        # first layer [64, 256]
    rate = R.reuse_rate(codes, 256)
    assert rate > 0.5                         # 256-wide rows, 128 cells
    assert R.reuse_rate(codes, None) >= rate


def test_quantized_serving_agrees_after_training(trained):
    _, params, _, _ = trained
    prompts = [np.arange(8), np.arange(8) + 11]
    fp = ServeEngine(CFG, params, n_slots=2, max_len=64,
                     device="cpu").generate(prompts, max_new=8)
    q = ServeEngine(CFG, params, n_slots=2, max_len=64, quantize=True,
                    device="cpu").generate(prompts, max_new=8)
    agree = np.mean([a == b for A, B in zip(fp, q) for a, b in zip(A, B)])
    assert agree >= 0.75
