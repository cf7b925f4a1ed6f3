"""The port's dry-run tools (``repro_torch.launch.{shapes,dryrun,report}``)
against the JAX package's, on the CPU.

- ``all_cells()`` gives JAX's keys and skip reasons; the input specs give
  JAX's shapes, dtypes and axis names under a (1, 1) mesh, and JAX's
  resolved specs under a 16 x 16 one.
- The (2, 2, 2) ("pod", "data", "model") miniature of the 2 x 16 x 16
  mesh (JAX's ``test_mini_production_mesh_compiles_multipod_shape``,
  whose reference fails: ROADMAP §3), train and decode, on all 8 ranks
  over a fake process group: each rank's argument bytes equal the bytes
  of its ``sharding.local_shard`` blocks; the matmul FLOPs summed over the
  ranks equal the (1, 1) count, except, at decode, the KV projections
  ``wk`` and ``wv``, which the layout keeps whole on both "model" ranks
  (the cache is cut along its sequence: glm4-9b's case).
- At 4 layer groups, ``extrapolate`` of the 1- and 2-group counts equals
  the full eager count.
- qwen2-moe-a2.7b:decode_32k and zamba2-1.2b:long_500k, cut to one layer
  group, end ``ok`` on the 16 x 16 fake mesh through the CLI, and
  ``report.main`` renders their records.

Every run that opens the fake group is a subprocess
(``tests/torch_dryrun_ranks.py``): the group is global to a process.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.dist import sharding as jshd
from repro.launch import shapes as jshp
from repro.configs import get_config as j_get_config
from repro_torch.configs import get_config
from repro_torch.launch import report, shapes as shp
from repro_torch.launch.mesh import Mesh

from torch_dryrun_ranks import MINI, run_job

JAX_CELLS = jshp.all_cells()
DTYPES = {torch.int32: jnp.int32, torch.float32: jnp.float32}


@pytest.mark.parametrize("i", range(len(JAX_CELLS)))
def test_all_cells_equal_jax(i):
    cells = shp.all_cells()
    assert len(cells) == len(JAX_CELLS) == 40
    assert (cells[i].key, cells[i].skip) == (JAX_CELLS[i].key,
                                             JAX_CELLS[i].skip)
    assert shp.SHAPES[cells[i].shape] == shp.ShapeSpec(
        *jshp.SHAPES[cells[i].shape].__dict__.values())


class _Stub:
    def __init__(self, shape):
        self.shape = shape


def _port_specs(cfg, spec, mesh):
    out = shp.batch_input_specs(cfg, spec, mesh)
    out["token"] = shp.token_input_specs(cfg, spec, mesh)
    return out


@pytest.mark.parametrize("shape", list(shp.SHAPES))
@pytest.mark.parametrize("arch", ["glm4-9b", "whisper-small"])
def test_input_specs_equal_jax(arch, shape):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    spec, jspec = shp.SHAPES[shape], jshp.SHAPES[shape]
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    want = jshp.batch_input_specs(jcfg, jspec, jmesh)
    want["token"] = jshp.token_input_specs(jcfg, jspec, jmesh)
    got = _port_specs(cfg, spec, Mesh(1, 1, 0, "meta"))
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == tuple(w.shape) and DTYPES[g.dtype] == w.dtype
        assert g.sharding.spec == tuple(w.sharding.spec)
        assert tuple(g.block.shape) == g.shape
    # on the production mesh: JAX's rules resolve the same names alike
    axes = {"data": 16, "model": 16}
    got = _port_specs(cfg, spec, Mesh(axes=axes, rank=17, device="meta"))
    names = {"tokens": ("batch", "seq"), "targets": ("batch", "seq"),
             "frames": ("batch", None, None), "token": ("batch",)}
    for k, g in got.items():
        jspec_k = jshd.resolve_spec(g.shape, names[k], _Stub(axes),
                                    jshd.DEFAULT_RULES)
        assert g.sharding.spec == tuple(jspec_k)
        rows = g.shape[0] // (16 if jspec_k[0] == "data" else 1)
        assert g.block.shape[0] == rows


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    return run_job("mini", tmp_path_factory.mktemp("mini"))


def _kv_projection_flops(cfg, rows: int) -> float:
    """The FLOPs of wk and wv at a decode step of ``rows`` rows, every
    layer."""
    return 2 * 2.0 * rows * cfg["d_model"] * cfg["n_kv_heads"] * \
        cfg["head_dim"] * cfg["n_layers"]


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_mini_production_mesh_multipod_shape(mini, kind):
    ranks, one = mini[kind]["ranks"], mini[kind]["one"]
    assert len(ranks) == 8
    for r in ranks:
        assert r["args"] == r["expected"] > 0
        assert r["collectives"]["all-reduce"]["count"] > 0
    summed = {op: sum(r["flops_by_op"][op] for r in ranks) for op in one}
    assert set(one) == {"mm", "bmm"}
    assert summed["bmm"] == one["bmm"]
    # the KV projections run whole on both "model" ranks at decode
    extra = 0.0 if kind == "train" else (2 - 1) * _kv_projection_flops(
        MINI, 8)
    assert summed["mm"] == one["mm"] + extra


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_extrapolate_at_4_groups_equals_full_count(mini, kind):
    from repro_torch.roofline.analysis import extrapolate
    e = mini["extrapolate"][kind]
    assert e["n_groups"] == 4
    keys = ("flops", "bytes", "collective_bytes") if kind == "decode" \
        else ("flops",)
    for i, key in enumerate(keys):
        assert extrapolate(e["g1"][key], e["g2"][key], 4) == e["full"][i]


CELLS = ("qwen2-moe-a2.7b:decode_32k", "zamba2-1.2b:long_500k")


@pytest.fixture(scope="module")
def production(tmp_path_factory):
    out = tmp_path_factory.mktemp("production")
    return run_job("one_group", out, out / "records", *CELLS), out / "records"


@pytest.mark.parametrize("cell", CELLS)
def test_production_cells_at_one_group_end_ok(production, cell):
    rec = next(r for r in production[0] if r["cell"] == cell)
    assert rec["status"] == "ok", rec.get("error")
    assert (rec["mesh"], rec["chips"], rec["rank"]) == ("gpu16x16", 256, 0)
    mem = rec["memory"]
    assert min(mem.values()) >= 0 and mem["argument_size_in_bytes"] > 0
    assert "generated_code_size_in_bytes" not in mem
    assert rec["cost_analysis"]["flops"] > 0
    assert rec["collective_bytes"] == sum(
        v["bytes"] for v in rec["collectives"].values())
    # the model group (16 ranks, row-major 8 to a node) spans two nodes
    assert rec["collective_inter_bytes"] > 0


def test_report_renders_the_ports_records(production):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        report.main(["--dir", str(production[1])])
    lines = buf.getvalue().splitlines()
    rows = [ln for ln in lines if ln.startswith("| ") and ":" in ln]
    assert [r.split(" | ")[0][2:] for r in rows] == sorted(CELLS)
    for r in rows:
        cols = r.strip("| ").split(" | ")
        assert cols[1].rstrip("*") in ("compute", "memory", "collective")
        assert all(float(c) >= 0 for c in cols[2:6])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        report.main(["--dir", str(production[1]), "--variants"])
    assert sum(ln.startswith("| ") and ":" in ln
               for ln in buf.getvalue().splitlines()) == len(CELLS)
