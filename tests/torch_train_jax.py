"""The single-device JAX references of the distributed training tests of
the moe, ssm, hybrid and audio families
(``tests/test_torch_dist_train_moe_audio.py``,
``tests/test_torch_dist_train_recurrent.py``): each family's reduced
float32 config (``torch_train_ranks.FAMILIES``), its weights from
``PRNGKey(0)`` and the jitted JAX train step's metrics on the pipeline's
batches. GSPMD keeps the arithmetic of the single-device program, so the
single-device step is the oracle of every mesh's.
"""

import functools

import jax
import jax.numpy as jnp

from repro.configs import get_config
from repro.data import pipeline as JD
from repro.models.model import get_model
from repro.optim import adamw as JA
from repro.train.loop import make_train_step

import torch_train_ranks as R


def config(family):
    arch, kw, _ = R.FAMILIES[family]
    return get_config(arch).reduced(dtype="float32", **kw)


@functools.lru_cache(maxsize=None)
def params(family):
    """The family's JAX weights from ``PRNGKey(0)`` (the init jitted)."""
    return jax.jit(get_model(config(family)).init)(jax.random.PRNGKey(0))


def trajectory(family, steps, lr=1e-3):
    """Each step's metrics of the jitted single-device JAX step from
    :func:`params` on the pipeline's batches (seed 0, B8 S32), AdamW at
    ``lr``, warmup 5 of 100 steps."""
    cfg = config(family)
    fn = jax.jit(make_train_step(get_model(cfg), JA.AdamWConfig(lr=lr),
                                 total_steps=100, warmup=5))
    ds = JD.make_dataset(cfg, batch=R.BATCH, seq=R.SEQ, seed=0)
    p = params(family)
    o = JA.init(p, JA.AdamWConfig(lr=lr))
    out = []
    for s in range(steps):
        p, o, m = fn(p, o, jax.tree_util.tree_map(jnp.asarray,
                                                  ds.batch_at(s)), s)
        out.append({k: float(v) for k, v in m.items()})
    return out
