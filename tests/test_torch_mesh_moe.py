"""Expert-parallel serving of the moe family on a mesh, on the CPU: ranks
spawned over gloo by ``launch.mesh.run_ranks``, once per mesh for the
module (the rank bodies, ``tests/torch_tp_ranks.py``, import no JAX).

The model is the launcher tests' tiny moe (float32, 2 layers, d 64, H4/Hk2,
head dim 16, vocab 256, d_ff 32, top-2 of 4 routed experts and one shared
expert, capacity factor 1.25, so prefill drops pairs), served with
``tests/test_sharded_serve.py``'s requests (prompts 5/9/3/12/7/4, 8 new
tokens, 2 slots, max_len 64). The JAX mesh engine serves no token under the
installed JAX (ROADMAP §3), so every rank is held to the single-device JAX
engine:

- 4 experts at (1, 2), (1, 4) and (2, 2), and 6 experts at (1, 4), where
  6 % 4 falls back to whole stacks (and at (1, 2), where 6 divides): in
  the int8, reuse and paged modes, tokens and stats equal the JAX
  engine's on every rank;
- a rank holds the codes of E/P experts where P divides E, of all of them
  in the fallback;
- a raw checkpoint restored onto a rank's blocks under the engine's
  layout, as the launcher restores it, gives every cut leaf (the expert
  stacks on their expert dim) as the whole leaf's block.
"""

import concurrent.futures

import jax
import numpy as np
import pytest

from repro.configs.base import ModelConfig as JModelConfig
from repro.models.model import get_model as j_get_model
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as TM
from repro_torch.models.model import get_model
from repro_torch.train import checkpoint as C

import torch_tp_ranks as R
from test_torch_engine import jax_tree_to_numpy
from test_torch_sharded_serve import PROMPT_LENS

MOE = dict(name="m", family="moe", n_layers=2, d_model=64, n_heads=4,
           n_kv_heads=2, d_ff=32, vocab_size=256, head_dim=16,
           vocab_pad_multiple=64, n_experts=4, top_k=2, n_shared_experts=1,
           expert_pad_to=1, dtype="float32")
CONFIGS = {"e4": MOE, "e6": dict(MOE, n_experts=6)}
MODES = {"int8": dict(quantize=True),
         "reuse": dict(quantize=True, impl="reuse"),
         "paged": dict(quantize=True, paged=True, kv_block_size=8)}
# the meshes each config is served on
MESHES = {"e4": ((1, 2), (1, 4), (2, 2)), "e6": ((1, 2), (1, 4))}


def _jax_serve(jcfg, jparams, kw):
    rng = np.random.default_rng(0)
    eng = JServeEngine(jcfg, jparams, n_slots=2, max_len=64, **kw)
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX engine's runs and every rank's runs on each mesh: the three
    spawns beside the JAX engines."""
    jparams, jobs, jax_out = {}, {}, {}
    for name, kw in CONFIGS.items():
        jparams[name] = j_get_model(JModelConfig(**kw)).init(
            jax.random.PRNGKey(0))
        cfg = ModelConfig(**kw)
        ckpt = str(tmp_path_factory.mktemp(f"moe_{name}"))
        C.save(ckpt, 1, get_model(cfg).init(seed=0, device="cpu"))
        jobs[name] = [("serve_modes", (cfg, jax_tree_to_numpy(jparams[name]),
                                       MODES, PROMPT_LENS)),
                      ("restore_layout", (cfg, ckpt))]
    shapes = sorted({s for v in MESHES.values() for s in v})
    with concurrent.futures.ThreadPoolExecutor(len(shapes) + 1) as pool:
        futs = {s: pool.submit(
            TM.run_ranks, R.run_jobs, s[0] * s[1], "cpu",
            [job for name in CONFIGS if s in MESHES[name]
             for job in jobs[name]], mesh_shape=s, threads=1)
            for s in shapes}
        # the JAX engines in two threads: most of their time is compiling
        refs = {(name, mode): pool.submit(_jax_serve, JModelConfig(**kw),
                                          jparams[name], mkw)
                for name, kw in list(CONFIGS.items())[1:]
                for mode, mkw in MODES.items()}
        for name, kw in list(CONFIGS.items())[:1]:
            for mode, mkw in MODES.items():
                jax_out[name, mode] = _jax_serve(JModelConfig(**kw),
                                                 jparams[name], mkw)
        jax_out.update({k: f.result() for k, f in refs.items()})
        meshes = {}
        for s, f in futs.items():
            names = [n for n in CONFIGS if s in MESHES[n]]
            meshes[s] = [{n: (rank[2 * i], rank[2 * i + 1])
                          for i, n in enumerate(names)} for rank in f.result()]
    return jax_out, meshes


CASES = [(name, s) for name in CONFIGS for s in MESHES[name]]
IDS = [f"{name}-{s[0]}x{s[1]}" for name, s in CASES]


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name,shape", CASES, ids=IDS)
def test_moe_mesh_engine_matches_single_device_jax_engine(runs, name, shape,
                                                          mode):
    jax_out, meshes = runs
    want = jax_out[name, mode]
    for rank, res in enumerate(meshes[shape]):
        got = res[name][0][mode]
        assert got["tokens"] == want["tokens"], (name, shape, mode, rank)
        assert got["stats"] == want["stats"], (name, shape, mode, rank)


@pytest.mark.parametrize("name,shape", CASES, ids=IDS)
def test_moe_rank_holds_its_experts_codes(runs, name, shape):
    """A rank quantizes and holds the codes of E/P experts [L, E/P, d, f];
    where P does not divide E the stacks stay whole on every rank."""
    _, meshes = runs
    e, p = CONFIGS[name]["n_experts"], shape[1]
    held = e // p if e % p == 0 else e
    for rank, res in enumerate(meshes[shape]):
        for mode in MODES:
            got = res[name][0][mode]
            assert got["experts"] == (2, held, 64, 32), (mode, rank)
            assert got["cut"]["experts"] == (e % p == 0), (mode, rank)


@pytest.mark.parametrize("name,shape", CASES, ids=IDS)
def test_restore_gives_each_rank_its_expert_blocks(runs, name, shape):
    _, meshes = runs
    e, p = CONFIGS[name]["n_experts"], shape[1]
    for rank, res in enumerate(meshes[shape]):
        blocks = res[name][1]
        assert blocks and all(eq for _, _, eq in blocks.values()), rank
        experts = {k: v for k, v in blocks.items() if "/expert_" in k}
        if e % p:
            assert experts == {}
        else:
            assert sorted(k.rsplit("/", 1)[1] for k in experts) == [
                "expert_down", "expert_gate", "expert_up"]
            assert all(v[0][1] * p == v[1][1] for v in experts.values())
