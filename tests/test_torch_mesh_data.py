"""Serving on a mesh with a "data" axis above 1 (``ServeEngine(...,
mesh=)`` at (2, 1) and (2, 2)), on the CPU: ranks spawned over gloo by
``launch.mesh.run_ranks``, once per mesh for the module (the rank bodies,
``tests/torch_tp_ranks.py``, import no JAX).

The model and requests are ``tests/test_sharded_serve.py``'s (2 layers,
d 64, H4/Hk2, head dim 16, vocab 256, float32; prompts 5/9/3/12/7/4, 8 new
tokens, 2 slots, max_len 64). The JAX mesh engine serves no token under the
installed JAX (ROADMAP §3), so every rank is held to the single-device JAX
engine, whose tokens the JAX docstring says a mesh engine gives:

- the six modes of ``tests/test_sharded_serve.py`` (fp32, int8, reuse,
  fused, lora, paged): tokens and stats equal the JAX engine's on every
  rank; a rank runs its block of the slots' rows (2 slots over D 2: one
  row a rank), and the paged engine every row (its pool is whole on every
  data rank);
- speculation and chunked prefill, 3 slots that D does not divide (the
  rows fall back to whole), and sampled decoding (a row draws the same
  number whichever data rank runs it) with every third request ending on
  its first token (the next request then takes a slot of the other data
  rank, and its prefilled KV rows move there): tokens and stats equal the
  port's single-device engine;
- one KV head (the cache cut along its sequence over "model" and its rows
  over "data"): the engine's decode runs the sequence-sharded decode with
  batch axes ("data",), and its tokens and stats equal the JAX engine's;
- ``decode_attention_seqsharded`` with batch axes ("data",) at (2, 2)
  equals JAX's own ``shard_map`` body on a (2, 2) mesh of host devices
  (rtol 1e-4, atol 1e-6, float32 queries over an int8 KV with its scales
  and over a float32 KV), and each rank's rows of the caches equal JAX's
  exactly.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import ModelConfig as JModelConfig
from repro.kernels.sharded_decode import decode_attention_seqsharded as j_sd
from repro.launch.mesh import make_host_mesh
from repro.models.model import get_model as j_get_model
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as TM

import torch_tp_ranks as R
from test_torch_engine import jax_tree_to_numpy
from test_torch_sharded_decode import _case
from test_torch_sharded_serve import JAX_MODES, PROMPT_LENS, TINY, _jax_serve

CFG = ModelConfig(**TINY)
SHAPES = ((2, 1), (2, 2))
SIX = ("fp32", "int8", "reuse", "fused", "lora", "paged")
ALL4 = ("wq", "wk", "wv", "wo")
PORT_MODES = {
    "spec": dict(quantize=True, speculate=True, spec_k=3),
    "chunked": dict(quantize=True, paged=True, kv_block_size=8,
                    prefill_budget=8, lora=ALL4),
    "odd-slots": dict(quantize=True, n_slots=3),
    # sampled rows draw the same numbers whichever data rank runs them;
    # a request that ends on its first token seats the next one in the
    # other data rank's slot, whose KV rows then move
    "sampled": dict(quantize=True, greedy=False, seed=3, max_new=(1, 8, 8)),
}
ONE_KV = dict(TINY, n_kv_heads=1)
SEQ_MODES = {"seq-int8": dict(quantize=True)}
SD_CASES = {"int8": _case([5, 32, 17, 1]),
            "f32": _case([5, 32, 17, 1], seed=3, quantized=False)}


def _jax_one_kv(jparams):
    jcfg = JModelConfig(**ONE_KV)
    rng = np.random.default_rng(0)
    eng = JServeEngine(jcfg, jparams, n_slots=2, max_len=64, quantize=True)
    for n in PROMPT_LENS:
        eng.submit(rng.integers(0, jcfg.vocab_size, size=n).astype(np.int32),
                   max_new=8)
    eng.run()
    st = eng.stats.as_dict()
    st.pop("prefill_wall_s")
    st.pop("prefill_compiles")
    return {"tokens": [list(map(int, r.tokens)) for r in
                       sorted(eng.finished, key=lambda r: r.rid)],
            "stats": st}


def _jax_seqsharded(inputs):
    i = {k: jnp.asarray(a) for k, a in inputs.items()}
    scales = {}
    if "ks" in i:
        scales = dict(k_scale=i["ks"], v_scale=i["vs"],
                      new_k_scale=i["nks"], new_v_scale=i["nvs"])
    return [np.asarray(x) for x in j_sd(
        i["q"], i["k"], i["v"], i["nk"], i["nv"], i["pos"], i["length"],
        make_host_mesh(2, 2), seq_axes=("model",), batch_axes=("data",),
        **scales)]


@pytest.fixture(scope="module")
def runs(eight_cpu_devices):
    """The JAX engine's runs, JAX's sequence-sharded decode, the port's
    single-device runs and every rank's runs at (2, 1) and (2, 2): both
    spawns beside the JAX work."""
    jcfg = JModelConfig(**TINY)
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    params = jax_tree_to_numpy(jparams)
    jone = j_get_model(JModelConfig(**ONE_KV)).init(jax.random.PRNGKey(1))
    six = {m: JAX_MODES[m] for m in SIX}
    cases = [(inputs, "float32") for inputs, _ in SD_CASES.values()]
    jobs = [("serve_modes", (CFG, params, six, PROMPT_LENS)),
            ("serve_modes", (CFG, params, PORT_MODES, PROMPT_LENS)),
            ("serve_modes", (ModelConfig(**ONE_KV), jax_tree_to_numpy(jone),
                             SEQ_MODES, PROMPT_LENS))]
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        futs = {shape: pool.submit(
            TM.run_ranks, R.run_jobs, shape[0] * shape[1], "cpu",
            jobs + ([("seqsharded", (cases, ("data",)))]
                    if shape == (2, 2) else []),
            mesh_shape=shape, threads=1) for shape in SHAPES}
        sd = pool.submit(lambda: {name: _jax_seqsharded(inputs)
                                  for name, (inputs, _) in SD_CASES.items()})
        jax_out = {m: _jax_serve(jcfg, jparams, m) for m in SIX}
        jax_out["seq-int8"] = _jax_one_kv(jone)
        single = R.run_jobs(None, jobs[1:2])[0]
        meshes = {shape: f.result() for shape, f in futs.items()}
        jax_sd = sd.result()
    merged = {shape: [{k: v for job in rank[:3] for k, v in job.items()}
                      for rank in res] for shape, res in meshes.items()}
    seq = [rank[3] for rank in meshes[(2, 2)]]
    return jax_out, single, merged, seq, jax_sd


@pytest.mark.parametrize("shape", SHAPES, ids=["2x1", "2x2"])
@pytest.mark.parametrize("mode", SIX)
def test_data_axis_engine_matches_single_device_jax_engine(runs, mode,
                                                           shape):
    jax_out, _, meshes, _, _ = runs
    want = jax_out[mode]
    for rank, res in enumerate(meshes[shape]):
        got = res[mode]
        assert got["tokens"] == want["tokens"], (mode, shape, rank)
        assert got["stats"] == want["stats"], (mode, shape, rank)
        data_rank = rank // shape[1]
        # 2 slots over D 2: a row a rank; the paged pool's rows whole
        assert got["rows"] == ((0, 2) if mode == "paged"
                               else (data_rank, 1)), (mode, rank)
        assert (got["layout"] is None) == (shape[1] == 1)


@pytest.mark.parametrize("shape", SHAPES, ids=["2x1", "2x2"])
@pytest.mark.parametrize("mode", sorted(PORT_MODES))
def test_data_axis_modes_match_single_device(runs, mode, shape):
    _, single, meshes, _, _ = runs
    want = single[mode]
    for rank, res in enumerate(meshes[shape]):
        assert res[mode]["tokens"] == want["tokens"], (mode, shape, rank)
        assert res[mode]["stats"] == want["stats"], (mode, shape, rank)
    st = want["stats"]
    assert st["finished"] == len(PROMPT_LENS) and st["decode_tokens"] > 0
    rows = [res[mode]["rows"] for res in meshes[shape]]
    if mode == "spec":
        assert st["spec_rounds"] > 0 and st["drafted_tokens"] > 0
        assert rows == [(r // shape[1], 1) for r in range(len(rows))]
    if mode == "chunked":
        assert st["prefill_chunks"] > len(PROMPT_LENS)
        assert rows == [(0, 2)] * len(rows)
    if mode == "odd-slots":     # 3 % 2: every rank runs the three rows
        assert rows == [(0, 3)] * len(rows)
    if mode == "sampled":
        assert [len(t) for t in want["tokens"]] == [
            1 if i % 3 == 0 else 8 for i in range(len(PROMPT_LENS))]
        assert rows == [(r // shape[1], 1) for r in range(len(rows))]


def test_sequence_and_rows_cut_engine_matches_jax_engine(runs):
    """One KV head at (2, 2): the dense cache is cut along its sequence
    over "model" and its rows over "data", so decode runs the
    sequence-sharded decode with batch axes ("data",)."""
    jax_out, _, meshes, _, _ = runs
    want = jax_out["seq-int8"]
    for rank, res in enumerate(meshes[(2, 2)]):
        got = res["seq-int8"]
        assert got["tokens"] == want["tokens"], rank
        assert got["stats"] == want["stats"], rank
        assert got["layout"]["seq"] and not got["layout"]["kv_heads"]
        assert got["cut"]["batch_axes"] == ("data",)
        assert got["rows"] == (rank // 2, 1)


@pytest.mark.parametrize("name", sorted(SD_CASES))
def test_seqsharded_batch_axes_matches_jax_shard_map(runs, name):
    """The port's (2, 2) ranks, the batch cut over "data" and the sequence
    over "model", against JAX's shard_map body on (2, 2) host devices."""
    inputs, _ = SD_CASES[name]
    per_rank = [r[list(SD_CASES).index(name)] for r in runs[3]]
    jres = runs[4][name]
    n, s_loc = inputs["q"].shape[0] // 2, inputs["k"].shape[1] // 2
    for rank, res in enumerate(per_rank):
        d, m = divmod(rank, 2)
        rows = slice(d * n, (d + 1) * n)
        np.testing.assert_allclose(res[0], jres[0][rows], rtol=1e-4,
                                   atol=1e-6)
        for got, cache in zip(res[1:], jres[1:]):
            np.testing.assert_array_equal(
                got, cache[rows, m * s_loc:(m + 1) * s_loc])
