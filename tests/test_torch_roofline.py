"""Port parity of the roofline analysis (``repro_torch.roofline.analysis``)
with the JAX package's ``repro.roofline.analysis``.

- The formulas (``model_flops``, ``useful_hbm_bytes`` with its weight and
  KV byte options, ``extrapolate``) equal JAX's for every assigned config
  and every shape, at rel 1e-12.
- ``roofline_terms`` at the H100's peaks: each term dominates where it
  should, and the inter-node bytes move at the network's rate.
- The collective counter on a fake world of 8 (a subprocess: the fake
  process group is global to a process) gives ``tests/test_roofline.py``'s
  bytes per kind for the same collectives, an all-reduce counted 2x, and
  splits them by node.
- The cost counter's FLOPs, bytes, transcendentals and live peak on meta
  tensors, and ``memory_dict``'s argument, output and alias bytes.
"""

import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.roofline import analysis as jra
from repro_torch.configs import ASSIGNED, get_config
from repro_torch.launch.shapes import SHAPES
from repro_torch.roofline import analysis as ra

from torch_dryrun_ranks import run_job

@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_formulas_equal_jax(arch, shape):
    cfg, jcfg, spec = get_config(arch), j_get_config(arch), SHAPES[shape]
    args = (spec.kind, spec.seq, spec.global_batch)
    assert ra.model_flops(cfg, *args) == pytest.approx(
        jra.model_flops(jcfg, *args), rel=1e-12)
    for w in (2.0, 1.0, 0.5):
        for kv in (2.0, 1.0):
            assert ra.useful_hbm_bytes(
                cfg, *args, weight_bytes_per_param=w, kv_bytes=kv) == \
                pytest.approx(jra.useful_hbm_bytes(
                    jcfg, *args, weight_bytes_per_param=w, kv_bytes=kv),
                    rel=1e-12)
    n = {"ssm": cfg.n_layers / max(cfg.xlstm_slstm_every, 1),
         "hybrid": cfg.n_layers / max(cfg.hybrid_attn_every, 1)}.get(
        cfg.family, cfg.n_layers)
    c1 = ra.model_flops(cfg, *args) / 7
    assert ra.extrapolate(c1, 1.5 * c1, n) == pytest.approx(
        jra.extrapolate(c1, 1.5 * c1, n), rel=1e-12)


CHIPS = 256
DOMINANCE = {
    # (flops, hbm bytes, intra-node bytes, inter-node bytes) -> (term, s)
    "compute": ((989e12 * CHIPS, 1e9, 1e9, 0.0), ("compute", 1.0)),
    "memory": ((1e12, 3.35e12 * CHIPS * 2, 1e9, 0.0), ("memory", 2.0)),
    "collective": ((1e12, 1e9, 450e9 * CHIPS * 3, 0.0), ("collective", 3.0)),
    "inter-node": ((1e12, 1e9, 1e9, 50e9 * CHIPS * 4),
                   ("collective", 4.0 + 1e9 / (450e9 * CHIPS))),
}


@pytest.mark.parametrize("case", list(DOMINANCE))
def test_roofline_terms_dominance_at_h100_peaks(case):
    (fl, by, co, inter), (dom, secs) = DOMINANCE[case]
    t = ra.roofline_terms(fl, by, co, CHIPS, inter_bytes=inter)
    assert t["dominant"] == dom
    assert t[f"{dom}_s"] == pytest.approx(secs, rel=1e-12)
    assert t["bound_step_s"] == pytest.approx(secs, rel=1e-12)
    if inter == 0.0:      # JAX's signature and behaviour, at the H100 rates
        assert ra.roofline_terms(fl, by, co, CHIPS) == t


@pytest.fixture(scope="module")
def counted(tmp_path_factory):
    return run_job("collectives", tmp_path_factory.mktemp("coll"))


@pytest.mark.parametrize("node", ["8", "4"])
def test_collective_counter_on_a_fake_world_of_8(counted, node):
    coll = counted[node]
    # the bytes tests/test_roofline.py expects of the same HLO collectives
    assert coll["all-gather"]["count"] == 2
    assert coll["all-gather"]["bytes"] == 16 * 512 * 2 + 2 * 4 * 4 * 4
    assert coll["all-reduce"] == dict(count=1, bytes=2 * 1024 * 4,
                                      inter_bytes=coll["all-reduce"]
                                      ["inter_bytes"])
    assert coll["reduce-scatter"]["bytes"] == 64 * 32 * 4
    assert coll["collective-permute"]["bytes"] == 128
    assert coll["all-to-all"]["bytes"] == 8 * 8 * 64 * 2
    assert ra.total_collective_bytes(coll) == sum(
        v["bytes"] for v in coll.values())
    # the world of 8 is one node of 8, two of 4 (the pair [0, 1], and the
    # send from 0 to 1, inside one)
    spans = {k: v["inter_bytes"] == v["bytes"] for k, v in coll.items()}
    if node == "8":
        assert ra.inter_collective_bytes(coll) == 0.0
    else:
        assert spans == {"all-gather": False, "all-reduce": True,
                         "reduce-scatter": True, "collective-permute": False,
                         "all-to-all": True}
        assert coll["all-gather"]["inter_bytes"] == 16 * 512 * 2


def test_count_cost_on_meta_tensors():
    a = torch.empty(64, 128, device="meta")
    b = torch.empty(128, 32, dtype=torch.float32, device="meta")
    with ra.count_cost() as c:
        y = a @ b                          # 64 x 32 f32 made
        z = torch.exp(y)                   # and another
        del y
        v = z.view(32, 64)                 # a view moves nothing
        z.add_(1.0)                        # in place: read and write
    assert c.flops == 2 * 64 * 128 * 32
    assert c.flops_by_op == {"mm": 2 * 64 * 128 * 32}
    out = 64 * 32 * 4
    assert c.bytes_accessed == (64 * 128 * 4 + 128 * 32 * 4 + out) \
        + 2 * out + 2 * out
    assert c.transcendentals == 64 * 32
    assert c.temp_bytes == 2 * out         # y and z alive together
    assert c.collectives == {}
    assert v.shape == (32, 64)


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_count_cost_flops_equal_flop_counter_mode(kind):
    """The counter's FLOPs (the flop counter's formulas on each op, a
    composite op as its parts, a memo for ops seen before) equal
    ``FlopCounterMode``'s on a whole cell, train and decode (under
    inference mode: matmul and einsum arrive whole), on a (1, 1) mesh."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs.base import ModelConfig
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import Mesh
    from torch_dryrun_ranks import MINI, MINI_SHAPES, VARIANT
    cfg, spec = ModelConfig(**MINI), MINI_SHAPES[kind]
    mesh = Mesh(1, 1, 0, "meta")
    with shd.activate(mesh, DR.cell_rules(VARIANT, spec)):
        built = DR.build_cell(cfg, spec, mesh, VARIANT)
        with ra.count_cost() as c:
            built.fn(*built.args)
        built = DR.build_cell(cfg, spec, mesh, VARIANT)
        with FlopCounterMode(display=False) as f:
            built.fn(*built.args)
    assert c.flops == f.get_total_flops() > 0
    assert c.flops_by_op == {str(op).split(".")[-1]: n for op, n in
                             f.get_flop_counts()["Global"].items()}


def test_memory_dict_counts_blocks_once():
    from repro_torch.core.quantization import QuantConfig, quantize
    w = torch.empty(64, 32, device="meta")
    qt = quantize(w, QuantConfig(bits=8))
    cache = torch.empty(4, 16, device="meta", dtype=torch.bfloat16)
    args = ({"w": qt, "n": w}, cache)
    fresh = torch.empty(4, 32, device="meta")
    mem = ra.memory_dict(args, (fresh, cache))
    q_bytes = 64 * 32 + 32 * 4 + 32 * 4     # codes, scale, kernel scale
    assert mem == {"argument_size_in_bytes": q_bytes + 64 * 32 * 4
                   + 4 * 16 * 2,
                   "output_size_in_bytes": 4 * 32 * 4 + 4 * 16 * 2,
                   "alias_size_in_bytes": 4 * 16 * 2}
    assert "generated_code_size_in_bytes" not in mem
