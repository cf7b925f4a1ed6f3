"""Port parity of the sharding rules (``repro_torch.dist.sharding``) with
the JAX package's ``repro.dist.sharding``, and the port's cut
(``local_shard``, ``qslice``, ``dist.tensor_parallel``'s layout).

- ``resolve_spec`` on the cases of ``tests/test_sharding.py``, and
  ``serve_rules_for`` / ``_param_names``, equal JAX's.
- ``param_specs`` (dense, int8 per channel, packed int4 per group),
  ``cache_specs`` (plain and long-context), ``paged_cache_specs`` and
  ``adapter_specs`` give JAX's specs entry for entry on the full trees of
  repro-100m and glm4-9b (abstract on both sides: JAX ``eval_shape``,
  the port on the meta device) and on the tiny test tree, on meshes of
  model 1, 2, 4, 8 and 16, under every rule set.
- ``local_shard`` cuts tensors and QTensors (packed int4 in whole bytes,
  per-group scales with their rows) into blocks that put the whole back
  together; ``qslice`` refuses a scale that does not cover its codes.
- The layout: where it cuts whole heads it is ``param_specs`` itself; for
  glm4-9b at model 4 it keeps wk/wv whole where ``param_specs`` would
  split a head, and a per-group row cut off the group boundary keeps its
  block whole.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as j_get_config
from repro.core import quantization as JQ
from repro.core.axllm_linear import LoRAConfig as JLoRAConfig
from repro.dist import sharding as jshd
from repro.models.model import get_model as j_get_model
from repro.serve.adapters import AdapterRegistry as JRegistry
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import quantization as TQ
from repro_torch.core.axllm_linear import LoRAConfig
from repro_torch.dist import sharding as shd
from repro_torch.dist import tensor_parallel as tp
from repro_torch.launch import mesh as TM
from repro_torch.serve.adapters import AdapterRegistry

RULE_SETS = ("DEFAULT_RULES", "SERVE_RULES", "SERVE_HEAD_RULES",
             "DP_SERVE_RULES")
MODELS = (1, 2, 4, 8, 16)
TINY = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
            vocab_pad_multiple=64, dtype="float32")


class Stub:
    def __init__(self, **shape):
        self.shape = shape


def _jmesh(model):
    return AbstractMesh((1, model), ("data", "model"))


# ---------------------------------------------------------------------------
# resolve_spec: the cases of tests/test_sharding.py
# ---------------------------------------------------------------------------

RESOLVE_CASES = [
    ((256, 4096), ("batch", "mlp"), dict(data=16, model=16)),
    ((64, 2), ("embed", "kv_heads"), dict(data=16, model=16)),
    ((1, 1024), ("batch", "seq"), dict(data=16, model=16)),
    ((64, 64), ("heads", "vocab"), dict(data=4, model=16)),
    ((256, 128), ("batch", None), dict(pod=2, data=16, model=16)),
    ((16,), ("batch",), dict(pod=2, data=16, model=16)),
    ((256, 4096), ("batch", "mlp"), dict(data=1, model=1)),
    ((256, 4096), ("batch", "mlp"), dict(data=1, model=8)),
    ((8, 512, 2, 128), ("batch", "cache_seq", "kv_heads", None),
     dict(data=1, model=4)),
    ((8, 500, 4, 64), ("batch", "cache_seq", "kv_heads", None),
     dict(data=1, model=4)),
    ((4096, 151552), ("embed", "vocab"), dict(data=2, model=8)),
]


@pytest.mark.parametrize("rules", RULE_SETS)
@pytest.mark.parametrize("case", range(len(RESOLVE_CASES)))
def test_resolve_spec_matches_jax(case, rules):
    shape, names, mesh = RESOLVE_CASES[case]
    got = shd.resolve_spec(shape, names, Stub(**mesh), getattr(shd, rules))
    want = jshd.resolve_spec(shape, names, Stub(**mesh), getattr(jshd, rules))
    assert isinstance(got, tuple)
    assert got == tuple(want)


def test_rule_sets_and_names_match_jax():
    for name in RULE_SETS:
        assert getattr(shd, name) == getattr(jshd, name)
    for key in ("wq", "wk", "wv", "wo", "gate", "up", "down", "embedding",
                "lm_head", "router", "expert_gate", "scale", "wqkv"):
        for nd in (1, 2, 3, 4):
            assert shd._param_names(key, nd) == jshd._param_names(key, nd)
    for model in MODELS:
        for hk in (1, 2, 4, 8, 16, 32):
            assert shd.serve_rules_for(Stub(data=1, model=model), hk) == \
                jshd.serve_rules_for(Stub(data=1, model=model), hk)
    assert shd.serve_rules_for(Stub(data=1, model=2), 2)["cache_seq"] is None
    assert shd.serve_rules_for(Stub(data=1, model=8), 2)["cache_seq"] == \
        "model"


# ---------------------------------------------------------------------------
# Whole trees, abstract on both sides
# ---------------------------------------------------------------------------

def _meta(tree):
    """The port's mirror of a JAX abstract tree, on the meta device."""
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, JQ.QTensor):
        return TQ.QTensor(
            codes=torch.empty(tree.codes.shape, dtype=torch.int8,
                              device="meta"),
            scale=torch.empty(tree.scale.shape, device="meta"),
            codebook=None, bits=tree.bits, mode=tree.mode,
            granularity=tree.granularity, group_size=tree.group_size,
            packed=tree.packed, shape=tuple(tree.shape))
    return torch.empty(tree.shape, device="meta")


def _pairs(jspecs, tspecs, path=""):
    """(path, jax spec, port spec) of every leaf of two spec trees."""
    if isinstance(jspecs, dict):
        assert set(jspecs) == set(tspecs), path
        for k in jspecs:
            yield from _pairs(jspecs[k], tspecs[k], f"{path}/{k}")
    elif isinstance(jspecs, JQ.QTensor):
        assert isinstance(tspecs, shd.QSharding), path
        yield path + "@codes", jspecs.codes.spec, tspecs.codes.spec
        yield path + "@scale", jspecs.scale.spec, tspecs.scale.spec
        assert (jspecs.codebook is None) == (tspecs.codebook is None)
    else:
        assert isinstance(tspecs, shd.NamedSharding), path
        yield path, jspecs.spec, tspecs.spec


def _assert_equal(jspecs, tspecs):
    n = 0
    for path, want, got in _pairs(jspecs, tspecs):
        assert got == tuple(want), (path, got, want)
        n += 1
    assert n > 0


QUANT = {"dense": None,
         "int8": JQ.QuantConfig(bits=8),
         "int4-group": JQ.QuantConfig(bits=4, granularity="per_group",
                                      group_size=32)}


@pytest.fixture(scope="module")
def trees():
    """{arch: (jcfg, {quant: abstract JAX params}, abstract cache, paged)}:
    full-width repro-100m and glm4-9b, and the tiny test model."""
    out = {}
    for arch in ("repro-100m", "glm4-9b", "tiny"):
        if arch == "tiny":
            from repro.configs.base import ModelConfig as JModelConfig
            jcfg = JModelConfig(**TINY)
        else:
            jcfg = j_get_config(arch)
        api = j_get_model(jcfg)
        raw = jax.eval_shape(api.init, jax.random.PRNGKey(0))
        params = {q: raw if c is None else jax.eval_shape(
            lambda p, c=c: JQ.quantize_tree(p, c), raw)
            for q, c in QUANT.items()}
        cache = jax.eval_shape(lambda: api.init_cache(8, 512))
        paged = jax.eval_shape(lambda: api.init_paged_cache(8, 66, 16, 32))
        out[arch] = (jcfg, params, cache, paged)
    return out


@pytest.mark.parametrize("quant", sorted(QUANT))
@pytest.mark.parametrize("arch", ["repro-100m", "glm4-9b", "tiny"])
def test_param_specs_match_jax(trees, arch, quant):
    _, params, _, _ = trees[arch]
    tparams = _meta(params[quant])
    for model in MODELS:
        for rules in RULE_SETS:
            _assert_equal(
                jshd.param_specs(params[quant], _jmesh(model),
                                 getattr(jshd, rules)),
                shd.param_specs(tparams, Stub(data=1, model=model),
                                getattr(shd, rules)))


@pytest.mark.parametrize("arch", ["repro-100m", "glm4-9b", "tiny"])
def test_cache_specs_match_jax(trees, arch):
    _, _, cache, paged = trees[arch]
    tcache, tpaged = _meta(cache), _meta(paged)
    for model in MODELS:
        jm, tm = _jmesh(model), Stub(data=1, model=model)
        for rules in RULE_SETS:
            jr, tr = getattr(jshd, rules), getattr(shd, rules)
            for long_context in (False, True):
                _assert_equal(
                    jshd.cache_specs(cache, jm, 8, 512, long_context, jr),
                    shd.cache_specs(tcache, tm, 8, 512, long_context, tr))
            _assert_equal(jshd.paged_cache_specs(paged, jm, jr),
                          shd.paged_cache_specs(tpaged, tm, tr))


@pytest.mark.parametrize("arch", ["repro-100m", "tiny"])
def test_adapter_specs_match_jax(arch):
    targets = ("wq", "wk", "wv", "wo")
    if arch == "tiny":
        from repro.configs.base import ModelConfig as JModelConfig
        jcfg, tcfg = JModelConfig(**TINY), ModelConfig(**TINY)
    else:
        jcfg, tcfg = j_get_config(arch), get_config(arch)
    jreg = JRegistry(jcfg, JLoRAConfig(rank=4, targets=targets))
    treg = AdapterRegistry(tcfg, LoRAConfig(rank=4, targets=targets),
                           device="meta")
    for model in MODELS:
        for rules in RULE_SETS:
            _assert_equal(
                jshd.adapter_specs(jreg.stacked, _jmesh(model),
                                   getattr(jshd, rules)),
                shd.adapter_specs(treg.stacked, Stub(data=1, model=model),
                                  getattr(shd, rules)))


def test_activate_binds_rules_and_layout():
    assert shd._current() is None and shd.current_layout() is None
    mesh = Stub(data=1, model=2)
    with shd.activate(mesh, shd.SERVE_RULES, layout="L"):
        assert shd._current() == (mesh, shd.SERVE_RULES)
        assert shd.current_layout() == "L"
        with shd.activate(mesh):
            assert shd._current()[1] == shd.DEFAULT_RULES
            assert shd.current_layout() is None
        assert shd._active_rules(None) == shd.SERVE_RULES
    assert shd._current() is None
    assert shd._active_rules(None) == shd.DEFAULT_RULES


# ---------------------------------------------------------------------------
# local_shard and qslice
# ---------------------------------------------------------------------------

def _rank_meshes(model):
    return [TM.Mesh(1, model, r) for r in range(model)]


@pytest.mark.parametrize("model", [2, 4])
def test_local_shard_tensor_blocks_rebuild_the_whole(model):
    x = torch.arange(3 * 8 * 16, dtype=torch.float32).reshape(3, 8, 16)
    for spec, dim in (((None, "model", None), 1), ((None, None, "model"), 2)):
        blocks = [shd.local_shard(x, spec, m, m.rank)
                  for m in _rank_meshes(model)]
        assert all(b.is_contiguous() for b in blocks)
        torch.testing.assert_close(torch.cat(blocks, dim), x, rtol=0, atol=0)
    assert shd.local_shard(x, (), TM.Mesh(1, model), 0) is x
    arr = np.arange(64).reshape(8, 8)
    got = shd.local_shard(arr, ("model",), TM.Mesh(1, model, 1), 1)
    np.testing.assert_array_equal(got, arr[8 // model:2 * 8 // model])
    with pytest.raises(ValueError, match="split"):
        shd.local_shard(torch.zeros(6), ("model",), TM.Mesh(1, 4), 0)


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("kind", ["int8-channel", "int4-group", "nf4"])
def test_local_shard_qtensor_dequantizes_to_the_block(kind, model):
    gen = torch.Generator().manual_seed(0)
    w = torch.randn((2, 256, 64), generator=gen)
    cfg = {"int8-channel": TQ.QuantConfig(bits=8),
           "int4-group": TQ.QuantConfig(bits=4, granularity="per_group",
                                        group_size=32),
           "nf4": TQ.QuantConfig(bits=4, mode="codebook")}[kind]
    qt = TQ.quantize(w, cfg)
    full = TQ.dequantize(qt)
    for key, dim in (("wq", -1), ("wo", -2)):
        spec = shd.param_specs({key: qt}, Stub(data=1, model=model),
                               shd.SERVE_RULES)[key]
        blocks = [shd.local_shard(qt, spec, m, m.rank)
                  for m in _rank_meshes(model)]
        for b in blocks:
            assert b.shape[dim] == 256 // model if dim == -2 else \
                64 // model
        torch.testing.assert_close(
            torch.cat([TQ.dequantize(b) for b in blocks], dim), full,
            rtol=0, atol=0)


def test_qslice_refuses_a_scale_that_does_not_cover_the_codes():
    qt = TQ.quantize(torch.randn(64, 32), TQ.QuantConfig(bits=8))
    with pytest.raises(ValueError, match="does not cover"):
        TQ.qslice(qt, qt.codes[:, :16], qt.scale)     # columns, whole scale
    g = TQ.quantize(torch.randn(64, 32), TQ.QuantConfig(
        bits=8, granularity="per_group", group_size=16))
    with pytest.raises(ValueError, match="does not cover"):
        TQ.qslice(g, g.codes[:32], g.scale)            # rows, every group
    half = TQ.qslice(g, g.codes[:32], g.scale[:2])
    assert half.shape == (32, 32) and half.kernel_scale.shape == (2, 32)


# ---------------------------------------------------------------------------
# The layout
# ---------------------------------------------------------------------------

def _plan(cfg, model, trees=(), paged=False, max_len=512):
    mesh = TM.Mesh(1, model)
    return tp.plan(cfg, mesh, shd.serve_rules_for(mesh, cfg.n_kv_heads),
                   n_slots=8, max_len=max_len, paged=paged, trees=trees)


@pytest.mark.parametrize("model", [2, 4])
def test_head_layout_is_param_specs(trees, model):
    """repro-100m's 4 KV heads divide 2 and 4: the layout cuts whole heads,
    and its physical specs of the projections and the vocabulary tables
    are param_specs under SERVE_HEAD_RULES. The stacked norm scales [L, d]
    read as matrices there ("embed", "mlp") and would be cut along d; the
    port keeps them whole, as they scale replicated activations."""
    cfg = get_config("repro-100m")
    for quant in ("dense", "int8"):
        tparams = _meta(trees["repro-100m"][1][quant])
        lay = _plan(cfg, model, [tparams])
        assert (lay.heads, lay.kv_heads, lay.seq, lay.mlp, lay.vocab) == \
            (True, True, False, True, True)
        specs = shd.param_specs(tparams, lay.mesh, shd.SERVE_HEAD_RULES)
        phys = tp.layout_specs(tparams, specs, lay)
        pairs = list(_pairs_port(specs, phys))
        cut = [p for p in pairs if p[0].split("/")[-1].split("@")[0]
               in tp._GROUPS]
        assert len(cut) == 2 * 7 + 1 - 7 * (quant == "dense")
        assert [p for p in cut if p[1] != p[2]] == []
        norms = [p for p in pairs if p[0].endswith("/scale")]
        assert norms and all(p[2] == (None,) * 4 for p in norms)


def _pairs_port(a, b, path=""):
    """(path, spec, spec) of two port spec trees, each spec padded with
    None to 4 entries (a whole leaf may be written () or all None)."""
    def pad(spec):
        return tuple(spec) + (None,) * (4 - len(spec))
    if isinstance(a, dict):
        for k in a:
            yield from _pairs_port(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, shd.QSharding):
        yield path + "@codes", pad(a.codes.spec), pad(b.codes.spec)
        yield path + "@scale", pad(a.scale.spec), pad(b.scale.spec)
    else:
        yield path, pad(a.spec), pad(b.spec)


def test_glm4_layout_keeps_whole_heads(trees):
    """glm4-9b at model 4: 2 KV heads do not divide 4, so the dense cache
    is cut along its sequence and wk/wv stay whole, though param_specs
    cuts their 256 columns (half a head a rank); paged, the pool stays
    whole."""
    cfg = get_config("glm4-9b")
    tparams = _meta(trees["glm4-9b"][1]["int8"])
    lay = _plan(cfg, 4, [tparams])
    assert (lay.heads, lay.kv_heads, lay.seq, lay.mlp, lay.vocab) == \
        (True, False, True, True, True)
    specs = shd.param_specs(tparams, lay.mesh, shd.SERVE_RULES)
    phys = tp.layout_specs(tparams, specs, lay)
    attn, pattn = specs["layers"]["attn"], phys["layers"]["attn"]
    assert attn["wk"].codes.spec == (None, None, "model")
    assert pattn["wk"].codes.spec == ()
    assert pattn["wq"].codes.spec == attn["wq"].codes.spec
    assert pattn["wo"].codes.spec == attn["wo"].codes.spec
    paged = _plan(cfg, 4, [tparams], paged=True)
    assert not paged.seq and not paged.kv_heads and paged.heads
    odd = _plan(cfg, 4, [tparams], max_len=514)     # 514 % 4: whole cache
    assert not odd.seq and not odd.kv_heads


def test_per_group_row_cut_off_the_group_keeps_the_block_whole():
    """d_ff 96 in groups of 32: down's K/P (48 at 2, 24 at 4) is not a
    multiple of 32, so the MLP block stays whole; wo's K/P (32 at 2) is,
    at 4 (16) it is not and attention stays whole too."""
    cfg = ModelConfig(**dict(TINY, d_ff=96))
    from repro_torch.models.model import get_model
    params = get_model(cfg).init(seed=0, device="cpu")
    q = TQ.quantize_tree(params, TQ.QuantConfig(
        bits=8, granularity="per_group", group_size=32))
    two, four = _plan(cfg, 2, [q], max_len=64), _plan(cfg, 4, [q], max_len=64)
    assert (two.heads, two.mlp) == (True, False)
    assert (four.heads, four.kv_heads, four.mlp) == (False, False, False)
    assert _plan(cfg, 2, [params], max_len=64).mlp     # dense cuts anywhere
    with pytest.raises(ValueError, match="fuse"):
        from repro_torch.models.transformer import fuse_params
        _plan(cfg, 2, [fuse_params(q, cfg)], max_len=64)


def test_mesh_helpers_need_no_group():
    one = TM.single_device_mesh()
    assert one.shape == {"data": 1, "model": 1} and one.size == 1
    assert TM.make_host_mesh(1, 1).group is None
    assert TM.make_serve_mesh("1").shape == one.shape
    with pytest.raises(RuntimeError, match="run_ranks"):
        TM.make_serve_mesh("2")
    with pytest.raises(ValueError):
        TM.make_serve_mesh("2x0")
    assert shd.mesh_coords(TM.Mesh(2, 4), 6) == {"data": 1, "model": 2}
    assert tp.plan(ModelConfig(**TINY), one, shd.SERVE_HEAD_RULES,
                   n_slots=2, max_len=64, paged=False) is None
    assert dataclasses.is_dataclass(tp.Layout)


def test_restore_specs_and_blocks_given_already():
    """The launcher restores every leaf the layout cuts as its block (wo
    and down as row blocks: the engine quantizes blocks); the engine reads
    the whole shapes back from the blocks, takes a leaf given as its block
    as it is, and refuses a block where the layout keeps the whole."""
    from repro_torch.models.model import get_model
    cfg = ModelConfig(**TINY)
    params = get_model(cfg).init(seed=0, device="cpu")
    mesh = TM.Mesh(1, 2, 1)
    rules = shd.serve_rules_for(mesh, cfg.n_kv_heads)
    lay = tp.plan(cfg, mesh, rules, n_slots=8, max_len=64, paged=False,
                  trees=[params])
    specs = tp.layout_specs(params, shd.param_specs(params, mesh, rules),
                            lay)
    attn, ffn = specs["layers"]["attn"], specs["layers"]["ffn"]
    assert attn["wq"].spec == (None, None, "model")
    assert attn["wo"].spec == (None, "model", None)
    assert ffn["down"].spec == (None, "model", None)
    assert specs["layers"]["ln1"]["scale"].spec == ()
    blocks = tp.shard_params(params, params, specs)
    whole = tp.whole_like(blocks, cfg, mesh, rules)
    assert all(
        w.shape == x.shape for (_, w), (_, x) in zip(tp._leaves(whole),
                                                     tp._leaves(params)))
    again = tp.shard_params(blocks, whole, specs)
    assert torch.equal(again["layers"]["attn"]["wo"], shd.local_shard(
        params["layers"]["attn"]["wo"], attn["wo"], mesh, 1))
    assert torch.equal(again["embed"]["embedding"],
                       params["embed"]["embedding"][128:])
    whole_mlp = dataclasses.replace(lay, mlp=False)
    with pytest.raises(ValueError, match="keeps whole"):
        tp.shard_params(blocks, whole, tp.layout_specs(
            whole, shd.param_specs(whole, mesh, rules), whole_mlp))
