"""The port's ``dist`` modules on the CPU, in one 4-rank spawn over gloo
(``launch.mesh.run_ranks``; rank bodies in ``tests/torch_train_ranks.py``),
held to the JAX modules run under ``shard_map`` on the forced host devices:

- ``compression``: each rank's value on the wire equals JAX's
  ``_block_quantize`` of its input within one code step (its block's
  scale); the exchanged mean is within rel 0.02 of the exact mean (the
  JAX test's bound); eight steps of error feedback on the same gradient
  accumulate to within rel 0.005 of the exact sum (the module's claim);
  the residual is the input less its wire value; ``wire_bytes`` equals
  JAX's for the same shape and dtype.
- ``pipeline``: four stages of tanh(x @ w), six microbatches: equal to
  JAX's ``make_pipelined_apply`` on 4 host devices and to the stages run
  in sequence (rtol 1e-4, atol 1e-5), from the whole stacked weights and
  from each rank's [1] block.
- ``collective_matmul``: both ring forms, dense at model 4, equal JAX's
  under ``shard_map`` within 1e-4; on QTensor blocks in the dyadic regime
  (integer activations, power-of-two scales; ``tests/test_reuse_kernel.py``'s
  ring goldens) per-channel, per-group and packed int4, through
  ``impl="reuse"``, bit-equal to the reuse matmul's plain version on the
  gathered operand (and to JAX's); the two ValueErrors of JAX's
  ``_qslice`` are raised with its texts.
"""

import concurrent.futures
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from repro.core.quantization import QTensor as JQTensor
from repro.dist import collective_matmul as JR
from repro.dist import compression as JZ
from repro.dist.pipeline import make_pipelined_apply as j_pipelined
from repro.kernels import ops as jops
from repro_torch.core.quantization import QTensor, pack_int4
from repro_torch.kernels import ops
from repro_torch.launch import mesh as TM

import torch_jax_cache  # noqa: F401 (the worker's compilation cache)
import torch_train_ranks as R

WORLD = 4
S_STAGES, D, N_MICRO = 4, 32, 6
MQ, KQ, NQ = 16, 512, 256          # the ring goldens' reuse shapes
SCALE = 127.0 * 2.0 ** -3          # dyadic: every product exact


def _inputs():
    rng = np.random.default_rng(0)
    xs = (rng.standard_normal((WORLD, 1024)) *
          (1 + np.arange(WORLD)[:, None])).astype(np.float32)
    g = rng.standard_normal((WORLD, 512)).astype(np.float32)
    ws = (rng.standard_normal((S_STAGES, D, D)) / np.sqrt(D)).astype(
        np.float32)
    x = rng.standard_normal((N_MICRO, 8, D)).astype(np.float32)
    xd = rng.standard_normal((16, 64)).astype(np.float32)
    wd = rng.standard_normal((64, 32)).astype(np.float32)
    xq = rng.integers(-8, 9, size=(MQ, KQ)).astype(np.float32)
    codes = rng.integers(-127, 128, size=(KQ, NQ)).astype(np.int8)
    codes4 = rng.integers(-7, 8, size=(KQ, NQ)).astype(np.int8)
    quant = {
        "per_channel": dict(codes=codes, bits=8, granularity="per_channel",
                            scale=np.full((1, NQ), SCALE, np.float32)),
        "per_group": dict(codes=codes, bits=8, granularity="per_group",
                          group_size=128, scale=np.full(
                              (KQ // 128, 1, NQ), SCALE, np.float32)),
        "int4": dict(codes=pack_int4(torch.from_numpy(codes4)).numpy(),
                     raw=codes4, bits=4, granularity="per_channel",
                     packed=True,
                     scale=np.full((1, NQ), 7.0 * 2.0 ** -3, np.float32)),
    }
    for d in quant.values():
        d["n"] = NQ
    return dict(xs=xs, g=g, ws=ws, x=x, xd=xd, wd=wd, xq=xq, quant=quant)


IN = _inputs()
FORMS = {"per_channel": "ag", "per_group": "ag", "int4": "ag",
         "per_channel_rs": "rs"}


def _quant_jobs():
    q = IN["quant"]
    jobs = {name: (IN["xq"], q[name.replace("_rs", "")], form)
            for name, form in FORMS.items()}
    errs = [(q["per_group"], 64, 0), (q["int4"], 3, 1)]
    return jobs, errs


def _spawn():
    jobs, errs = _quant_jobs()
    return TM.run_ranks(R.run_jobs, WORLD, "cpu", [
        ("compression", (IN["xs"], IN["g"], 8)),
        ("pipeline", (IN["ws"], IN["x"], N_MICRO)),
        ("rings", (IN["xd"], IN["wd"], jobs, errs))],
        mesh_shape={"pod": WORLD}, threads=1)


def _jax_refs():
    devs = jax.devices()[:WORLD]
    out = {}
    out["deq"] = [np.asarray(JZ._block_quantize(jnp.asarray(r), JZ.BLOCK))
                  for r in IN["xs"]]
    out["wire"] = JZ.wire_bytes(jnp.asarray(IN["xs"][0]))
    smesh = jax.make_mesh((WORLD,), ("stage",), devices=devs)
    # jitted: shard_map dispatched op by op takes ten times as long
    out["pipe"] = np.asarray(jax.jit(j_pipelined(
        lambda w, a: jnp.tanh(a @ w), smesh, N_MICRO))(
            jnp.asarray(IN["ws"]), jnp.asarray(IN["x"])))
    mmesh = jax.make_mesh((WORLD,), ("model",), devices=devs)

    @jax.jit
    @partial(shard_map, mesh=mmesh,
             in_specs=(P(None, "model"), P(None, "model")),
             out_specs=P(None, "model"))
    def ag(xs, ws):
        return JR.ring_allgather_matmul(xs, ws, "model")

    @jax.jit
    @partial(shard_map, mesh=mmesh, in_specs=(P(None, "model"), P("model")),
             out_specs=P(None, "model"))
    def rs(xs, ws):
        return JR.ring_matmul_reducescatter(xs, ws, "model")

    xd, wd = jnp.asarray(IN["xd"]), jnp.asarray(IN["wd"])
    out["ag"], out["rs"] = np.asarray(ag(xd, wd)), np.asarray(rs(xd, wd))
    out["reuse"] = {}
    for name, d in IN["quant"].items():
        raw = d.get("raw", d["codes"])
        qt = JQTensor(codes=jnp.asarray(d["codes"]),
                      scale=jnp.asarray(d["scale"]), codebook=None,
                      bits=d["bits"], mode="affine",
                      granularity=d["granularity"],
                      group_size=d.get("group_size", 128),
                      packed=bool(d.get("packed")), shape=raw.shape)
        out["reuse"][name] = np.asarray(jops.reuse_matmul(
            jnp.asarray(IN["xq"]), qt, impl="reuse_ref")[0])
    try:
        JR._qslice(JQTensor(
            codes=jnp.asarray(IN["quant"]["per_group"]["codes"]),
            scale=jnp.asarray(IN["quant"]["per_group"]["scale"]),
            codebook=None, bits=8, mode="affine", granularity="per_group",
            group_size=128, packed=False, shape=(KQ, NQ)), 0, 64, 0)
    except ValueError as e:
        out["err_k"] = str(e)
    d4 = IN["quant"]["int4"]
    try:
        JR._qslice(JQTensor(codes=jnp.asarray(d4["codes"]),
                            scale=jnp.asarray(d4["scale"]), codebook=None,
                            bits=4, mode="affine",
                            granularity="per_channel", group_size=128,
                            packed=True, shape=(KQ, NQ)), 0, 3, 1)
    except ValueError as e:
        out["err_n"] = str(e)
    return out


@pytest.fixture(scope="module")
def runs():
    """One 4-rank spawn beside the JAX references (in a second thread)."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(_spawn)
        ref = _jax_refs()
        return ranks.result(), ref


def _job(runs, i):
    return [r[i] for r in runs[0]]


def test_compressed_values_are_jax_block_quantize(runs):
    ranks, ref = runs
    for r, got in enumerate(_job(runs, 0)):
        want = ref["deq"][r]
        step = np.abs(IN["xs"][r]).reshape(-1, 256).max(1) / 127.0
        assert np.all(np.abs(got["deq"] - want).reshape(-1, 256)
                      <= step[:, None] * (1 + 1e-6))
        np.testing.assert_array_equal(got["err"], IN["xs"][r] - got["deq"])


def test_compressed_mean_and_wire_bytes(runs):
    exact = IN["xs"].mean(0)
    outs = _job(runs, 0)
    for got in outs:
        np.testing.assert_array_equal(got["mean"], outs[0]["mean"])
        assert np.linalg.norm(got["mean"] - exact) / np.linalg.norm(exact) \
            < 0.02
        assert tuple(got["wire"]) == tuple(runs[1]["wire"])
        assert got["wire"][0] < got["wire"][1] / 3.5


def test_error_feedback_accumulates_to_the_exact_sum(runs):
    exact = 8 * IN["g"].mean(0)
    for got in _job(runs, 0):
        assert np.linalg.norm(got["acc"] - exact) / np.linalg.norm(exact) \
            < 0.005


def test_pipeline_matches_jax_and_sequential(runs):
    seq = torch.from_numpy(IN["x"])
    for s in range(S_STAGES):
        seq = torch.tanh(seq @ torch.from_numpy(IN["ws"][s]))
    for got in _job(runs, 1):
        for key in ("whole", "block"):
            np.testing.assert_allclose(got[key], runs[1]["pipe"], rtol=1e-4,
                                       atol=1e-5)
            np.testing.assert_allclose(got[key], seq.numpy(), rtol=1e-4,
                                       atol=1e-5)


@pytest.mark.parametrize("form", ["ag", "rs"])
def test_dense_rings_match_jax(runs, form):
    blocks = np.concatenate([g[form] for g in _job(runs, 2)], axis=-1)
    np.testing.assert_allclose(blocks, runs[1][form], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(blocks, IN["xd"] @ IN["wd"], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("name", list(FORMS))
def test_quantized_rings_bit_equal_reuse_on_gathered(runs, name):
    d = IN["quant"][name.replace("_rs", "")]
    qt = QTensor(codes=torch.from_numpy(d["codes"]),
                 scale=torch.from_numpy(d["scale"]), codebook=None,
                 bits=d["bits"], mode="affine", granularity=d["granularity"],
                 group_size=d.get("group_size", 128),
                 packed=bool(d.get("packed")), shape=(KQ, NQ))
    want, _ = ops.reuse_matmul(torch.from_numpy(IN["xq"]), qt, impl="reuse")
    got = np.concatenate([g[name] for g in _job(runs, 2)], axis=-1)
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(got, runs[1]["reuse"][
        name.replace("_rs", "")])


def test_qslice_value_errors_are_jax_texts(runs):
    for got in _job(runs, 2):
        assert got["errors"] == [runs[1]["err_k"], runs[1]["err_n"]]
