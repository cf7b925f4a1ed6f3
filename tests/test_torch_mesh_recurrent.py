"""The recurrent families (ssm: xLSTM, hybrid: zamba2) served on a mesh, on
the CPU: ranks spawned over gloo by ``launch.mesh.run_ranks``, once per
mesh for the module (the rank bodies, ``tests/torch_tp_ranks.py``, import
no JAX).

The models are the registry's xlstm-1.3b and zamba2-1.2b reduced to
float32, 4 layers (xLSTM: two mLSTM + sLSTM super-blocks; zamba2: two
shared-attention sites), d 64, head dim 16 and vocab 256; the requests
pair their lengths (5/9/5/9/7/7, 8 new tokens, 2 slots, max_len 64), so
that the equal-length prefill sub-waves are two rows wide and cut over a
data axis. The JAX mesh engine serves no token under the installed JAX
(ROADMAP §3), so every rank is held to the single-device JAX engine:

- at (1, 2) (the mLSTM up and down cut, the Mamba2 out_proj cut and the
  shared attention block cut along heads; every state whole) and at
  (2, 1) (a rank runs one slot row), in the int8 and reuse modes, tokens
  and stats equal the JAX engine's on every rank;
- a raw checkpoint restored onto a rank's blocks under the engine's
  layout, as the launcher restores it, gives every cut leaf as the whole
  leaf's block;
- a zamba2 whose Mamba2 ``in_proj`` segments [z 64 | x 64 | B 62 | C 62 |
  dt 4] put the 2-way cut on a segment boundary (d 32, state 62) has its
  in_proj cut too, and serves the port's single-device engine's tokens
  and stats at (1, 2).
"""

import concurrent.futures

import jax
import numpy as np
import pytest

from repro.configs import REGISTRY as J_REGISTRY
from repro.models.model import get_model as j_get_model
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.launch import mesh as TM
from repro_torch.models.model import get_model
from repro_torch.train import checkpoint as C

import torch_tp_ranks as R
from test_torch_engine import jax_tree_to_numpy

SMALL = dict(d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
             vocab_size=256, dtype="float32", remat=False)
NAMES = {"xlstm": "xlstm-1.3b", "zamba2": "zamba2-1.2b"}
EXTRA = {"xlstm": {}, "zamba2": dict(d_ff=128)}
PROMPT_LENS = (5, 9, 5, 9, 7, 7)
MODES = {"int8": dict(quantize=True),
         "reuse": dict(quantize=True, impl="reuse")}
SHAPES = ((1, 2), (2, 1))
# in_proj's 256 columns cut at 128, between its x and B segments
SEG_KW = dict(SMALL, d_model=32, d_ff=128, ssm_state=62)


def _cfgs(name):
    kw = dict(SMALL, **EXTRA[name])
    return (J_REGISTRY[NAMES[name]].reduced(**kw),
            get_config(NAMES[name]).reduced(**kw))


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
    jobs, jax_out, jparams = [], {}, {}
    for name in NAMES:
        jcfg, cfg = _cfgs(name)
        assert cfg.n_layers == 4
        jparams[name] = j_get_model(jcfg).init(jax.random.PRNGKey(0))
        ckpt = str(tmp_path_factory.mktemp(f"rec_{name}"))
        C.save(ckpt, 1, get_model(cfg).init(seed=0, device="cpu"))
        jobs += [("serve_modes", (cfg, jax_tree_to_numpy(jparams[name]),
                                  MODES, PROMPT_LENS)),
                 ("restore_layout", (cfg, ckpt))]
    seg = get_config(NAMES["zamba2"]).reduced(**SEG_KW)
    seg_job = ("serve_modes", (seg, 0, {"int8": MODES["int8"]},
                               PROMPT_LENS))
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        futs = {s: pool.submit(TM.run_ranks, R.run_jobs, 2, "cpu",
                               jobs + [seg_job] * (s == (1, 2)),
                               mesh_shape=s, threads=1) for s in SHAPES}
        # the JAX engines in two threads: most of their time is compiling
        refs = {("zamba2", mode): pool.submit(
            _jax_serve, _cfgs("zamba2")[0], jparams["zamba2"], kw)
            for mode, kw in MODES.items()}
        # the in_proj-cut zamba2 is held to the port's single-device engine
        jax_out["seg"] = R.run_jobs(None, [seg_job])[0]["int8"]
        for mode, kw in MODES.items():
            jax_out["xlstm", mode] = _jax_serve(_cfgs("xlstm")[0],
                                                jparams["xlstm"], kw)
        jax_out.update({k: f.result() for k, f in refs.items()})
        meshes = {s: f.result() for s, f in futs.items()}
    return jax_out, meshes


@pytest.mark.parametrize("shape", SHAPES, ids=["1x2", "2x1"])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", sorted(NAMES))
def test_recurrent_mesh_engine_matches_single_device_jax_engine(
        runs, name, mode, shape):
    jax_out, meshes = runs
    want = jax_out[name, mode]
    i = 2 * list(NAMES).index(name)
    for rank, res in enumerate(meshes[shape]):
        got = res[i][mode]
        assert got["tokens"] == want["tokens"], (name, mode, shape, rank)
        assert got["stats"] == want["stats"], (name, mode, shape, rank)
        if shape == (2, 1):
            assert got["rows"] == (rank, 1) and got["layout"] is None
        else:
            lay, cut = got["layout"], got["cut"]
            assert lay["mlp"] and lay["vocab"]
            # zamba2's in_proj [z|x|B|C|dt] (296 columns) would be cut
            # inside x: it stays whole, out_proj is cut
            assert (lay["heads"], cut["ssm_in"], cut["ssm_out"]) == (
                (True, False, True) if name == "zamba2" else
                (False, False, False))


@pytest.mark.parametrize("name", sorted(NAMES))
def test_restore_gives_each_rank_its_recurrent_blocks(runs, name):
    _, meshes = runs
    i = 2 * list(NAMES).index(name) + 1
    want = {"xlstm": {"up", "down", "embedding", "lm_head"},
            "zamba2": {"out_proj", "embedding", "wq", "wk", "wv", "wo",
                       "up", "down"}}[name]
    for rank, res in enumerate(meshes[(1, 2)]):
        blocks = res[i]
        assert all(eq for _, _, eq in blocks.values()), rank
        assert {k.rsplit("/", 1)[1] for k in blocks} >= want - {"lm_head"}
        assert all(a != b for a, b, _ in blocks.values())
    for res in meshes[(2, 1)]:
        assert res[i] == {}     # no model axis: nothing is cut


def test_in_proj_cut_on_segment_boundaries_matches_single_device(runs):
    jax_out, meshes = runs
    want = jax_out["seg"]
    for rank, res in enumerate(meshes[(1, 2)]):
        got = res[-1]["int8"]
        assert got["cut"]["ssm_in"] and got["cut"]["ssm_out"], rank
        assert got["tokens"] == want["tokens"], rank
        assert got["stats"] == want["stats"], rank
