"""Tensor-parallel serving of the port (``ServeEngine(..., mesh=...)``) on
the CPU: ranks spawned over gloo by ``launch.mesh.run_ranks``, once per
mesh for the module (the rank bodies, ``tests/torch_tp_ranks.py``, import
no JAX).

The model and requests are ``tests/test_sharded_serve.py``'s (2 layers,
d 64, H4/Hk2, head dim 16, vocab 256, float32; prompts 5/9/3/12/7/4, 8 new
tokens, 2 slots, max_len 64). The JAX mesh engine produces no tokens under
the installed JAX (a ShardingTypeError on the vocab-sharded embedding
gather, ROADMAP §3), so the port's mesh engine is held against the
single-device JAX engine, whose tokens the JAX docstring says a mesh
engine gives:

- at mesh (1, 2) (head-sharded: Hk 2 divides 2) and (1, 4)
  (sequence-sharded: wk/wv whole, decode through
  ``kernels.sharded_decode``), on every rank, in the six modes of
  ``tests/test_sharded_serve.py`` (fp32, int8, reuse, fused, lora, paged)
  and LoRA on all four attention projections (wo row-parallel): tokens
  and stats equal the JAX engine's;
- chunked prefill, priority preemption with swap-out, speculation (dense
  and paged, affine and shift-add drafts), sampled decoding, an int8 KV
  cache and per-group weights whose row cut misses the group boundary
  (d_ff 96, groups of 32): tokens and stats equal the port's
  single-device engine;
- each rank quantizes its own raw blocks into the codes and scales of the
  whole weights quantized and then cut;
- mesh (1, 1) equals ``mesh=None`` in every token and counter;
- a moe engine and an engine with a data axis above 1 build their blocks
  and rows; an encoder-decoder raises the JAX engine's error;
- the sequence-sharded decode with its sequence cut over ("model",
  "data") and its batch over ("pod", "data"), on 4 ranks of other meshes
  beside the (1, 4) spawn, equals the unsharded plain decode.
"""

import concurrent.futures

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.launch.serve import make_synthetic_adapters as j_adapters
from repro.models.model import get_model as j_get_model
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as TM
from repro_torch.models.model import get_model
from repro_torch.serve.engine import ServeEngine

import torch_tp_ranks as R
from test_torch_engine import jax_tree_to_numpy

TINY = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
            vocab_pad_multiple=64, dtype="float32")
CFG = ModelConfig(**TINY)
PROMPT_LENS = (5, 9, 3, 12, 7, 4)
ALL4 = ("wq", "wk", "wv", "wo")

# the modes held against the JAX engine: tests/test_sharded_serve.py's six
# and LoRA on every attention projection
JAX_MODES = {
    "fp32": {},
    "int8": dict(quantize=True),
    "reuse": dict(quantize=True, impl="reuse"),
    "fused": dict(quantize=True, fuse_qkv=True),
    "lora": dict(quantize=True, lora=("wq", "wv")),
    "paged": dict(quantize=True, paged=True, kv_block_size=8),
    "lora-all": dict(quantize=True, lora=ALL4, fuse_qkv=True),
}
# the modes held against the port's single-device engine
PORT_MODES = {
    "chunked": dict(quantize=True, paged=True, kv_block_size=8,
                    prefill_budget=8, lora=ALL4),
    "preempt": dict(quantize=True, paged=True, kv_block_size=8, late=2,
                    decode_chunk=2),
    "spec": dict(quantize=True, speculate=True, spec_k=3),
    "spec-paged": dict(quantize=True, paged=True, kv_block_size=8,
                       impl="reuse", speculate=True, spec_k=2,
                       draft_mode="shiftadd", draft_bits=8),
    "sampled": dict(quantize=True, greedy=False, seed=3, kv_block_size=8,
                    paged=True),
}
KV_MODES = {"kv-int8": dict(quantize=True, fuse_qkv=True)}
GROUP_CFG = ModelConfig(**dict(TINY, d_ff=96, quant_kv=True))
GROUP_MODES = {"per-group": dict(per_group=32),
               "per-group-paged": dict(per_group=32, paged=True,
                                       kv_block_size=8)}
KV_CFG = ModelConfig(**dict(TINY, quant_kv=True))


def _seq_case(quantized: bool, seed: int):
    """A decode state of 4 rows over 32 positions (int8 codes and f32
    scales, or float K/V) and the cache expected after the update."""
    b, s, h, hk, d = 4, 32, 4, 2, 16
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    if quantized:
        kv = [rng.integers(-127, 128, size=shape).astype(np.int8)
              for shape in ((b, s, hk, d),) * 2 + ((b, hk, d),) * 2]
    else:
        kv = [rng.normal(size=shape).astype(np.float32)
              for shape in ((b, s, hk, d),) * 2 + ((b, hk, d),) * 2]
    length = np.asarray([5, 32, 17, 1], np.int32)
    inputs = dict(q=q, k=kv[0], v=kv[1], nk=kv[2], nv=kv[3],
                  pos=length - 1, length=length)
    if quantized:
        sc = [rng.uniform(0.01, 0.05, size=shape).astype(np.float32)
              for shape in ((b, s, hk, 1),) * 2 + ((b, hk, 1),) * 2]
        inputs.update(ks=sc[0], vs=sc[1], nks=sc[2], nvs=sc[3])
    exp = {k: inputs[k].copy() for k in ("k", "v", "ks", "vs")
           if k in inputs}
    for i, p in enumerate(inputs["pos"]):
        for k, new in (("k", "nk"), ("v", "nv"), ("ks", "nks"),
                       ("vs", "nvs")):
            if k in exp:
                exp[k][i, p] = inputs[new][i]
    return inputs, exp


SEQ_CASES_NAMED = {"int8": (_seq_case(True, 0), "float32"),
                   "bf16": (_seq_case(False, 1), "bfloat16")}
SEQ_CASES = [(inputs, dtype) for (inputs, _), dtype in
             SEQ_CASES_NAMED.values()]
# the 4-rank cuts of the sequence-sharded decode beside the 1x4 serving
# mesh: (name, batch axes, sequence axes, mesh axes)
SEQ_CUTS = {
    "seq model,data": ("seq model,data", (), ("model", "data"),
                       {"data": 2, "model": 2}),
    "batch pod,data": ("batch pod,data", ("pod", "data"), ("model",),
                       {"pod": 2, "data": 1, "model": 2}),
    "batch pod,data 2x2x1": ("batch pod,data 2x2x1", ("pod", "data"),
                             ("model",), {"pod": 2, "data": 2, "model": 1}),
}


def _seq_oracle(name, cut, per_rank):
    """Every rank's output rows and cache blocks of ``SEQ_CUTS[cut]`` on
    case ``name`` put together, against the updated cache and the port's
    unsharded ``kernels.ref.decode_attention_ref`` on it."""
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels.ref import decode_attention_ref
    (inputs, exp), dtype = SEQ_CASES_NAMED[name]
    i = list(SEQ_CASES_NAMED).index(name)
    _, batch_axes, seq_axes, axes = SEQ_CUTS[cut]
    b = inputs["q"].shape[0]
    out = np.zeros(inputs["q"].shape, np.float32)
    caches = {k: np.zeros(v.shape, np.float32) for k, v in exp.items()}
    for r, res in enumerate(per_rank):
        mesh = TM.Mesh(axes=axes, rank=r, device="cpu")
        rows = shd.block_index((b,), (batch_axes or None,), mesh, r)[0]
        got = res["seqsharded"][cut][i]
        out[rows] = got[0]
        for key, block in zip(("k", "v", "ks", "vs"), got[1:]):
            idx = shd.block_index(exp[key].shape, (batch_axes or None,
                                                   seq_axes), mesh, r)
            caches[key][idx] = block
    t = {k: torch.from_numpy(v) for k, v in exp.items()}
    q = torch.from_numpy(inputs["q"])
    if dtype == "bfloat16":
        q, t["k"], t["v"] = (x.to(torch.bfloat16).float()
                             for x in (q, t["k"], t["v"]))
    for key, want in t.items():     # the owners' writes are exact
        np.testing.assert_array_equal(caches[key], want.float().numpy())
    ref = decode_attention_ref(q, t["k"], t["v"],
                               torch.from_numpy(inputs["length"]),
                               k_scale=t.get("ks"), v_scale=t.get("vs"))
    ref = ref.float().numpy()
    tol = dict(rtol=0, atol=1e-2 * float(np.abs(ref).max())) \
        if dtype == "bfloat16" else dict(rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(out, ref, **tol)


def _jax_serve(jcfg, jparams, mode):
    kw = dict(JAX_MODES[mode])
    targets = kw.pop("lora", None)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, size=n).astype(np.int32)
               for n in PROMPT_LENS]
    reg, names = None, [None] * len(prompts)
    if targets:
        reg, ns = j_adapters(jcfg, 2, targets=targets)
        names = [None if i % 3 == 0 else ns[i % 2]
                 for i in range(len(prompts))]
    eng = JServeEngine(jcfg, jparams, n_slots=2, max_len=64, adapters=reg,
                       **kw)
    for p, a in zip(prompts, names):
        eng.submit(p, max_new=8, adapter=a)
    eng.run()
    reqs = sorted(eng.finished, key=lambda r: r.rid)
    st = eng.stats.as_dict()
    st.pop("prefill_wall_s")
    st.pop("prefill_compiles")
    return {"tokens": [list(map(int, r.tokens)) for r in reqs], "stats": st}


@pytest.fixture(scope="module")
def runs():
    """The JAX engine's runs, the port's single-device runs and every
    rank's runs at mesh (1, 2) and (1, 4): both spawns run beside the JAX
    engines."""
    jcfg = JModelConfig(**TINY)
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    params = jax_tree_to_numpy(jparams)
    gparams = _np(get_model(GROUP_CFG).init(seed=1, device="cpu"))
    jobs = [("serve_modes", (CFG, params, JAX_MODES, PROMPT_LENS)),
            ("serve_modes", (CFG, params, PORT_MODES, PROMPT_LENS)),
            ("serve_modes", (GROUP_CFG, gparams, GROUP_MODES, PROMPT_LENS)),
            ("serve_modes", (KV_CFG, params, KV_MODES, PROMPT_LENS)),
            ("quantized_blocks", (CFG, params))]
    seq = [("seqsharded_meshes", (SEQ_CASES, list(SEQ_CUTS.values())))]
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futs = {w: pool.submit(TM.run_ranks, R.run_jobs, w, "cpu",
                               jobs + (seq if w == 4 else []), threads=1)
                for w in (2, 4)}
        jax_out = {m: _jax_serve(jcfg, jparams, m) for m in JAX_MODES}
        single = [R.run_jobs(None, [job])[0] for job in jobs]
        meshes = {w: f.result() for w, f in futs.items()}
    merged = {}
    for w, res in meshes.items():
        merged[w] = [{k: v for job in rank for k, v in job.items()}
                     for rank in res]
    one = {k: v for job in single for k, v in job.items()}
    return jax_out, one, merged


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.numpy()


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("mode", sorted(JAX_MODES))
def test_mesh_engine_matches_single_device_jax_engine(runs, mode, world):
    jax_out, one, meshes = runs
    want = jax_out[mode]
    assert one[mode]["tokens"] == want["tokens"]
    for rank, res in enumerate(meshes[world]):
        got = res[mode]
        assert got["tokens"] == want["tokens"], (mode, world, rank)
        assert got["stats"] == want["stats"], (mode, world, rank)
    lay = meshes[world][0][mode]["layout"]
    if world == 2:      # Hk 2 divides 2: heads cut, cache along heads
        assert lay == dict(heads=True, kv_heads=True, seq=False, mlp=True,
                           vocab=True)
    else:               # 2 % 4: wk/wv whole; the dense cache along its rows
        assert lay == dict(heads=True, kv_heads=False,
                           seq=mode != "paged", mlp=True, vocab=True)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("mode", sorted(PORT_MODES) + sorted(GROUP_MODES)
                         + sorted(KV_MODES))
def test_mesh_engine_modes_match_single_device(runs, mode, world):
    _, one, meshes = runs
    want = one[mode]
    for rank, res in enumerate(meshes[world]):
        assert res[mode]["tokens"] == want["tokens"], (mode, world, rank)
        assert res[mode]["stats"] == want["stats"], (mode, world, rank)
    st = want["stats"]
    assert st["finished"] == len(PROMPT_LENS) and st["decode_tokens"] > 0
    if mode == "chunked":
        assert st["prefill_chunks"] > len(PROMPT_LENS)   # some took two
    if mode == "preempt":
        assert st["preempted"] > 0 and st["restored"] == st["preempted"]
    if mode.startswith("spec"):
        assert st["spec_rounds"] > 0 and st["drafted_tokens"] > 0
    if mode.startswith("per-group"):
        # down's K/P (48, 24) misses the groups of 32: the MLP stays whole;
        # wo's K/4 (16) too, so at 4 attention stays whole as well
        lay = meshes[world][0][mode]["layout"]
        assert not lay["mlp"] and lay["heads"] == (world == 2)


@pytest.mark.parametrize("world", [2, 4])
def test_rank_quantization_gives_the_single_device_codes(runs, world):
    """Each rank quantizes only its raw blocks, wo and down cut along
    their rows (one all-reduce MAX of the per-column maxima), and gets the
    codes and scales of the whole weights quantized and then cut."""
    _, _, meshes = runs
    for rank, res in enumerate(meshes[world]):
        got = res["quantized_blocks"]
        assert got == {"int8": True, "int8_row_cut": True, "int4": True,
                       "int4_row_cut": True, "nf4": True,
                       "nf4_row_cut": True}, (world, rank)


def test_mesh_1x1_is_the_single_device_engine():
    """A (1, 1) mesh has no layout: every token and counter equal
    ``mesh=None``'s, in a mode that touches every path (paged, reuse,
    LoRA on all four projections)."""
    params = _np(get_model(CFG).init(seed=2, device="cpu"))
    modes = {"all": dict(quantize=True, paged=True, kv_block_size=8,
                         impl="reuse", lora=ALL4),
             "dense": dict(quantize=True, fuse_qkv=True)}
    a = R.serve_modes(None, CFG, params, modes, PROMPT_LENS)
    b = R.serve_modes(TM.single_device_mesh("cpu"), CFG, params, modes,
                      PROMPT_LENS)
    assert a == b
    assert b["all"]["layout"] is None


@pytest.mark.parametrize("cut", list(SEQ_CUTS))
@pytest.mark.parametrize("name", list(SEQ_CASES_NAMED))
def test_seqsharded_cuts_on_4_ranks_match_ref(runs, name, cut):
    """The sequence cut over ("model", "data") (the "cache_seq_long"
    rule) at 2x2, and the batch cut over ("pod", "data") at 2x1x2 and
    2x2x1, bf16 and int8 KV, on 4 gloo ranks: the rows put together equal
    the updated cache and the unsharded plain decode."""
    _seq_oracle(name, cut, runs[2][4])


def test_unserved_meshes_raise_item_12b(runs):
    """The meshes item 12b lifted build their engines (served on ranks:
    tests/test_torch_mesh_moe.py, tests/test_torch_mesh_recurrent.py,
    tests/test_torch_mesh_data.py): a moe engine on rank 1 of (1, 2) holds
    the second half of the expert stacks, a dense engine on rank 3 of
    (2, 2) its slot row and its KV heads. What stays refused names its
    item: an encoder-decoder raises the JAX engine's error, mesh or not. A
    sequence cut over ("model", "data") (the dry-run's "cache_seq_long"
    rule), which item 12d lifted, equals the unsharded plain decode on
    every rank of a 2x2 mesh."""
    from repro_torch.kernels.sharded_decode import \
        decode_attention_seqsharded
    moe = get_config("qwen2-moe-a2.7b").reduced(dtype="float32")
    mp = get_model(moe).init(seed=0, device="cpu")
    eng = ServeEngine(moe, mp, device="cpu", mesh=TM.Mesh(1, 2, 1, "cpu"))
    held = moe.padded_experts // 2
    assert eng._layout.experts and eng._rows is None
    torch_equal = [(eng.params["layers"]["ffn"][k] ==
                    mp["layers"]["ffn"][k][:, held:]).all()
                   for k in ("expert_gate", "expert_up", "expert_down")]
    assert all(bool(t) for t in torch_equal)
    params = get_model(CFG).init(seed=0, device="cpu")
    dense = ServeEngine(CFG, params, device="cpu", n_slots=2, max_len=64,
                        mesh=TM.Mesh(2, 2, 3, "cpu"))
    assert (dense._rows.lo, dense._rows.n) == (1, 1)
    assert dense.cache["k"].shape == (2, 1, 64, 1, 16)
    _seq_oracle("int8", "seq model,data", runs[2][4])
    x = torch.zeros((2, 4, 16))
    kv = torch.zeros((2, 16, 2, 16))
    with pytest.raises(ValueError, match="not over an axis the sequence"):
        decode_attention_seqsharded(
            x, kv, kv, x[:, :2], x[:, :2], torch.zeros(2, dtype=torch.int32),
            torch.ones(2, dtype=torch.int32), TM.Mesh(2, 2, 0, "cpu"),
            ("model", "data"), ("data",))
    whisper = get_config("whisper-small").reduced(dtype="float32")
    with pytest.raises(NotImplementedError,
                       match="encoder-decoder serving needs a frames"):
        ServeEngine(whisper, None, device="cpu", mesh=TM.Mesh(1, 2, 0, "cpu"))
