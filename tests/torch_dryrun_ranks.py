"""Rank bodies of the port's dry-run tests (``tests/test_torch_dryrun.py``,
``tests/test_torch_roofline.py``), run in a subprocess of their own: the
fake process group they open is global to the process. No JAX.

    python tests/torch_dryrun_ranks.py <job> <out.json> [args...]

:func:`run_job` runs one so from a test.
"""

import json
import os
import subprocess
import sys

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantization import QTensor, quantize_tree
from repro_torch.dist import sharding as shd
from repro_torch.dist import tensor_parallel as tp
from repro_torch.launch import dryrun as DR
from repro_torch.launch import shapes as shp
from repro_torch.launch.mesh import Mesh, make_fake_mesh
from repro_torch.models.model import get_model
from repro_torch.optim import adamw

# JAX's test_mini_production_mesh_compiles_multipod_shape's model and cells
MINI = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
            vocab_pad_multiple=64, grad_accum=2)
MINI_SHAPES = {"train": shp.ShapeSpec("mini_train", 64, 8, "train"),
               "decode": shp.ShapeSpec("mini_decode", 128, 8, "decode")}
MINI_AXES = {"pod": 2, "data": 2, "model": 2}
VARIANT = "axllm-int8"
HERE = os.path.dirname(os.path.abspath(__file__))


def run_job(job, tmp_path, *args):
    """``python tests/torch_dryrun_ranks.py <job>`` in a subprocess of
    its own; the JSON it writes."""
    out = tmp_path / f"{job}.json"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(HERE, "..", "src"), HERE,
         os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, os.path.join(HERE, "torch_dryrun_ranks.py"),
                    job, str(out), *map(str, args)], check=True, env=env,
                   timeout=600)
    return json.loads(out.read_text())


def _bytes(tree) -> int:
    """Every tensor of a tree, each child of a QTensor (codes, scale,
    kernel scale) or a Q8 (codes, scales) counted: the bytes a rank
    holds."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_bytes(v) for v in tree)
    if isinstance(tree, QTensor):
        return _bytes([tree.codes, tree.scale, tree.kernel_scale])
    if isinstance(tree, adamw.Q8):
        return _bytes([tree.codes, tree.scale])
    return 0


def _cut(tree, specs, mesh):
    if isinstance(tree, dict):
        return {k: _cut(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_cut(t, s, mesh) for t, s in zip(tree, specs)]
    return shd.local_shard(tree, specs, mesh, mesh.rank)


def expected_argument_bytes(cfg, spec, mesh) -> int:
    """A rank's argument bytes from ``sharding.local_shard`` of each whole
    leaf, as the port's layout cuts it: the parameters (train:
    ``param_specs``; serving: the layout's specs of the quantized tree),
    the moments (``adamw.state_specs``) and count, the batch or token rows
    and the cache."""
    api = get_model(cfg)
    whole = api.init(seed=0, device="meta")
    entry = shd.resolve_spec((spec.global_batch,), ("batch",), mesh,
                             shd.DEFAULT_RULES)[0]
    rows = spec.global_batch // mesh.axis_size(*shd._axes(entry))
    if spec.kind == "train":
        pspec = shd.param_specs(whole, mesh, shd.DEFAULT_RULES)
        opt = adamw.init(whole, adamw.AdamWConfig(
            int8_moments=cfg.int8_optimizer))
        ospec = adamw.state_specs(opt, pspec)
        return (_bytes(_cut(whole, pspec, mesh))
                + _bytes(_cut(opt["m"], ospec["m"], mesh))
                + _bytes(_cut(opt["v"], ospec["v"], mesh))
                + _bytes(opt["count"]) + 2 * rows * spec.seq * 4)
    rules = DR.cell_rules(VARIANT, spec)
    q = quantize_tree(whole, DR._qcfg(cfg))
    lay = tp.plan(cfg, mesh, rules, n_slots=spec.global_batch,
                  max_len=spec.seq, paged=False, trees=(q,))
    specs = tp.layout_specs(q, shd.param_specs(q, mesh, rules), lay)
    meta = api.init_cache(rows, spec.seq, "meta")
    cache = _cut(meta, tp.cache_layout_specs(meta, lay, paged=False), mesh)
    return _bytes(_cut(q, specs, mesh)) + _bytes(cache) + rows * 4


def mini(out_path):
    """Every rank of the (2, 2, 2) mini production mesh and the (1, 1)
    mesh, train and decode: the argument bytes counted and expected, and
    the FLOPs by op; then the extrapolation at 4 groups against the full
    count on rank 0."""
    cfg = ModelConfig(**MINI)
    out = {}
    for kind, spec in MINI_SHAPES.items():
        rules = DR.cell_rules(VARIANT, spec)
        one = DR.count_cell(cfg, spec, Mesh(1, 1, 0, "meta"), VARIANT, rules)
        ranks = []
        for rank in range(8):
            mesh = make_fake_mesh(MINI_AXES, rank)
            rec = DR.count_cell(cfg, spec, mesh, VARIANT, rules)
            ranks.append({"args": rec["memory"]["argument_size_in_bytes"],
                          "expected": expected_argument_bytes(cfg, spec,
                                                              mesh),
                          "flops_by_op": rec["flops_by_op"],
                          "collectives": rec["collectives"]})
        out[kind] = {"one": one["flops_by_op"], "ranks": ranks}
    # a 4-group config (no remat, one microbatch: what the aux runs count)
    four = ModelConfig(**dict(MINI, n_layers=4, remat=False, grad_accum=1))
    mesh = make_fake_mesh(MINI_AXES, 0)
    out["extrapolate"] = {}
    for kind, spec in MINI_SHAPES.items():
        rules = DR.cell_rules(VARIANT, spec)
        full = DR.count_cell(four, spec, mesh, VARIANT, rules)
        aux = DR.run_aux(four, spec, mesh, VARIANT, rules)
        out["extrapolate"][kind] = {
            "full": [full["cost_analysis"]["flops"],
                     full["cost_analysis"]["bytes accessed"],
                     full["collective_bytes"]],
            "g1": aux["g1"], "g2": aux["g2"], "n_groups": aux["n_groups"]}
    json.dump(out, open(out_path, "w"))


def one_group(out_path, out_dir, *cells):
    """The production cells ``cells`` at 1 layer group on the 16 x 16 fake
    mesh, through the CLI (``--set n_layers=``), which writes their records
    to ``out_dir``; returns those records."""
    import glob
    for key in cells:
        cfg = DR._aux_config(get_config(key.split(":")[0]), 1)
        DR.main(["--cells", key, "--out", out_dir, "--tag", "g1",
                 "--set", f"n_layers={cfg.n_layers}"])
    recs = [json.load(open(f)) for f in
            sorted(glob.glob(os.path.join(out_dir, "*.json")))]
    json.dump(recs, open(out_path, "w"))


def collectives(out_path):
    """The collective counter on a fake world of 8 (one node of 8, and
    nodes of 4): the collectives of ``tests/test_roofline.py``'s HLO
    sample."""
    import torch.distributed as dist
    from repro_torch.roofline import analysis as ra
    mesh = make_fake_mesh({"model": 8}, 0)
    world = mesh.groups[("model",)]
    pair = dist.new_group([0, 1])
    m = "meta"
    out = {}
    for node in (8, 4):
        with ra.count_collectives(node_size=node) as c:
            dist.all_gather_into_tensor(
                torch.empty(16, 512, dtype=torch.bfloat16, device=m),
                torch.empty(2, 512, dtype=torch.bfloat16, device=m),
                group=world)
            dist.all_gather([torch.empty(4, 4, device=m) for _ in range(2)],
                            torch.empty(4, 4, device=m), group=pair)
            dist.all_reduce(torch.empty(1024, device=m), group=world)
            dist.reduce_scatter_tensor(torch.empty(64, 32, device=m),
                                       torch.empty(512, 32, device=m),
                                       group=world)
            dist.send(torch.empty(128, dtype=torch.uint8, device=m), dst=1)
            dist.all_to_all_single(
                torch.empty(8, 8, 64, dtype=torch.bfloat16, device=m),
                torch.empty(8, 8, 64, dtype=torch.bfloat16, device=m),
                group=world)
        out[node] = c.collectives
    json.dump(out, open(out_path, "w"))


if __name__ == "__main__":
    globals()[sys.argv[1]](*sys.argv[2:])
