"""Production-mesh dry run: count one rank's program of every (arch x shape)
cell on the GPU production meshes, and record its memory, cost and
collectives (PyTorch port of the JAX package's ``launch/dryrun.py``).

JAX lowers and compiles the whole 256- or 512-device program and reads
XLA's analyses of it. PyTorch has nothing to compile, so the port runs
one rank's program eagerly, at full width and depth, on meta tensors
(shapes and dtypes, no data, no allocation), in the port's own layout:
its blocks of the parameters, moments, caches and inputs under
``dist.sharding``'s rules and ``dist.tensor_parallel``'s layouts, and its
collectives over a process group of torch's "fake" backend
(``launch.mesh.make_production_mesh``), which returns at once. What it
does is counted (``roofline.analysis.count_cost``): FLOPs, bytes
accessed, the peak of its live intermediates, and the bytes of each
collective by kind, split by whether the group spans nodes of 8 cards.
Like JAX's tool this never needs an accelerator.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun                  # all cells
  ... --cells granite-3-8b:train_4k,glm4-9b:decode_32k              # subset
  ... --mesh multi                                                  # 2-pod
  ... --variant baseline-bf16                                       # serve cells unquantized
  ... --aux                                                         # 1/2-group runs, a check of extrapolate
  ... --rank 17                                                     # another rank's figures

Results go to results/dryrun_torch/<cell>__<mesh>__<variant>.json, one
file a cell (incremental and resumable). The records keep JAX's keys;
the figures are rank 0's unless ``--rank`` picks another, as JAX's are
per device; ``count_s`` (the counted run's seconds) stands where JAX has
its lowering and compile times.

The port's layout, where it differs from JAX's GSPMD program:

- serving parameters are held as the layout's blocks (a group the layout
  keeps whole, such as glm4-9b's two KV heads, is whole on every rank),
  and a block cut over "data" by the FSDP rule (the default variant's
  "embed") is gathered whole over "data" before the forward, as GSPMD's
  all-gather does;
- a prefill cell's cache keeps every position on every rank (the port's
  prefill computes them all; the engine keeps its rows after), a decode
  cell's cache is cut as the rules say;
- a train cell's microbatches are the rank's rows split ``grad_accum``
  ways, or as many ways as the rows allow (``grad_accum`` in the record
  when it was cut);
- on the meta device a MoE layer runs every expert of the rank at
  capacity: JAX's static program's work.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantization import (QTensor, QuantConfig, qslice,
                                           quantize_tree)
from repro_torch.dist import sharding as shd
from repro_torch.dist import tensor_parallel as tp
from repro_torch.launch import shapes as shp
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import get_model
from repro_torch.optim import adamw
from repro_torch.roofline import analysis as ra
from repro_torch.train.loop import make_train_step

RESULTS_DIR = "results/dryrun_torch"
MESH_NAMES = {False: "gpu16x16", True: "gpu2x16x16"}


def _aux_config(cfg: ModelConfig, groups: int) -> ModelConfig:
    """Unrolled `groups`-group variant for the per-layer cost delta."""
    upd = dict(scan_layers=False, remat=False, grad_accum=1)
    if cfg.family == "ssm":
        upd["n_layers"] = groups * cfg.xlstm_slstm_every
    elif cfg.family == "hybrid":
        upd["n_layers"] = groups * cfg.hybrid_attn_every
    else:
        upd["n_layers"] = groups
        if cfg.is_encoder_decoder:
            upd["n_enc_layers"] = groups
    return dataclasses.replace(cfg, **upd)


def _n_groups(cfg: ModelConfig) -> float:
    if cfg.family == "ssm":
        return cfg.n_layers / cfg.xlstm_slstm_every
    if cfg.family == "hybrid":
        return cfg.n_layers / cfg.hybrid_attn_every
    return cfg.n_layers


def _variant_rules(variant: str, kind: str):
    """Hillclimb levers: '-tp' serve variants use TP-only weight sharding
    (no FSDP all-gather per token); '-dp' replicates weights entirely and
    spreads batch over all axes (small-arch serving)."""
    if kind == "train":
        return shd.DEFAULT_RULES
    if variant.endswith("-dp"):
        return shd.DP_SERVE_RULES
    if variant.endswith("-tp"):
        return shd.SERVE_RULES
    return shd.DEFAULT_RULES


def _blocks(tree, specs, mesh):
    """This rank's block of each leaf of a meta tree (nested dicts, lists
    and tuples of tensors, QTensors and Q8 moments) under ``specs``."""
    if isinstance(tree, dict):
        return {k: _blocks(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_blocks(t, s, mesh) for t, s in zip(tree, specs))
    return shd.local_shard(tree, specs, mesh, mesh.rank)


def _gather_axes(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """``t`` gathered whole over every axis of its spec but "model" (the
    layout's cut), the innermost axis of a dim first."""
    for dim, entry in enumerate(spec):
        axes = [a for a in shd._axes(entry) if a != "model"]
        if axes and len(axes) < len(shd._axes(entry)):
            raise ValueError(f"spec {spec}: a dim cut over 'model' and "
                             f"{axes} together")
        for ax in reversed(axes):
            t = tp._gather_dim(t, mesh, ax, dim)
    return t


def gather_fsdp(tree, specs, mesh):
    """The tree the serving forward reads: each block cut over an axis
    other than "model" (the FSDP rule's "data") gathered whole over it,
    the "model" cut kept."""
    if isinstance(tree, dict):
        return {k: gather_fsdp(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        codes = _gather_axes(tree.codes, specs.codes.spec, mesh)
        scale = _gather_axes(tree.scale, specs.scale.spec, mesh)
        if codes is tree.codes and scale is tree.scale:
            return tree
        return qslice(tree, codes, scale)
    return _gather_axes(tree, specs.spec, mesh)


def _qcfg(cfg: ModelConfig) -> QuantConfig:
    return QuantConfig(
        bits=cfg.quant_bits,
        mode="codebook" if cfg.quant_bits == 4 else "affine",
        granularity="per_channel", pack=cfg.quant_bits == 4)


def _train_rows(spec: shp.ShapeSpec, mesh) -> int:
    """The rank's rows of a train batch (the "batch" rule's cut)."""
    entry = shd.resolve_spec((spec.global_batch,), ("batch",), mesh,
                             shd.DEFAULT_RULES)[0]
    return spec.global_batch // math.prod(mesh.shape[a]
                                          for a in shd._axes(entry))


@dataclasses.dataclass
class Built:
    """A cell ready to count: ``fn(*args)`` is the rank's program on its
    meta blocks; ``cfg`` the config that runs (its ``grad_accum`` cut to
    the rank's rows where they do not split)."""
    fn: object
    args: tuple
    cfg: ModelConfig


def build_cell(cfg: ModelConfig, spec: shp.ShapeSpec, mesh, variant: str,
               aux_batch: int = 0) -> Built:
    """The rank's program of a cell and its meta arguments, under the
    rules of the innermost ``dist.sharding.activate`` context.

    Variant grammar (serve cells): base in {baseline-bf16, axllm-int8,
    axllm-int4} with optional modifiers "-kvq" (int8 KV cache) and "-tp" /
    "-dp" (the weight rules, ``_variant_rules``)."""
    if "-kvq" in variant and spec.kind != "train":
        cfg = dataclasses.replace(cfg, quant_kv=True)
    if variant.startswith("axllm-int4"):
        cfg = dataclasses.replace(cfg, quant_bits=4)
    if aux_batch:
        spec = dataclasses.replace(spec, global_batch=aux_batch)
    rules = shd._active_rules(None)
    quantize = variant.startswith("axllm-int") and spec.kind != "train"

    if spec.kind == "train":
        rows = _train_rows(spec, mesh)
        accum = max(cfg.grad_accum, 1)
        if rows % accum:
            cfg = dataclasses.replace(cfg, grad_accum=math.gcd(rows, accum))
        api = get_model(cfg, impl="auto")
        ocfg = adamw.AdamWConfig(int8_moments=cfg.int8_optimizer)
        whole = api.init(seed=0, device="meta")
        pspec = shd.param_specs(whole, mesh, shd.DEFAULT_RULES)
        opt_whole = adamw.init(whole, ocfg)
        ospec = adamw.state_specs(opt_whole, pspec)
        step = make_train_step(api, ocfg, grad_specs=pspec)
        opt = {"m": _blocks(opt_whole["m"], ospec["m"], mesh),
               "v": _blocks(opt_whole["v"], ospec["v"], mesh),
               "count": opt_whole["count"]}
        batch = {k: v.block for k, v in
                 shp.batch_input_specs(cfg, spec, mesh).items()}
        args = (_blocks(whole, pspec, mesh), opt, batch, 0)
        return Built(step, args, cfg)

    # serving cells
    api = get_model(cfg, impl="auto")
    whole = api.init(seed=0, device="meta")
    if quantize:
        whole = quantize_tree(whole, _qcfg(cfg))
    b, seq = spec.global_batch, spec.seq
    lay = tp.plan(cfg, mesh, rules, n_slots=b, max_len=seq, paged=False,
                  trees=(whole,))
    specs = shd.param_specs(whole, mesh, rules)
    if lay is not None:
        specs = tp.layout_specs(whole, specs, lay)
    params = _blocks(whole, specs, mesh)
    if spec.kind == "prefill":
        inputs = {k: v.block for k, v in
                  shp.batch_input_specs(cfg, spec, mesh,
                                        targets=False).items()}
        rows = inputs["tokens"].shape[0]
    else:
        inputs = shp.token_input_specs(cfg, spec, mesh).block
        rows = inputs.shape[0]
    meta = api.init_cache(rows, seq, "meta")
    if lay is not None:
        cache = _blocks(meta, tp.cache_layout_specs(
            meta, lay, paged=False, wave=spec.kind == "prefill"), mesh)
    else:       # no "model" axis: every position on the rank's rows
        cache = meta

    def serve(p, x, c):
        with torch.inference_mode(), shd.activate(mesh, rules, lay):
            pc = gather_fsdp(p, specs, mesh)
            if spec.kind == "prefill":
                return api.prefill(pc, x, c)
            return api.decode(pc, x, c)

    return Built(serve, (params, inputs, cache), cfg)


def count_cell(cfg: ModelConfig, spec: shp.ShapeSpec, mesh, variant: str,
               rules, aux_batch: int = 0) -> dict:
    """Build and count a cell on ``mesh`` under ``rules``: JAX's record
    keys (``memory``, ``cost_analysis``, ``collectives``,
    ``collective_bytes``) with ``collective_inter_bytes``,
    ``flops_by_op``, ``grad_accum`` and ``count_s``."""
    with shd.activate(mesh, rules):
        built = build_cell(cfg, spec, mesh, variant, aux_batch)
        t0 = time.time()
        with ra.count_cost() as counts:
            out = built.fn(*built.args)
        count_s = time.time() - t0
    mem = ra.memory_dict(built.args, out)
    mem["temp_size_in_bytes"] = counts.temp_bytes
    rec = {"grad_accum": built.cfg.grad_accum} if spec.kind == "train" \
        else {}
    return {**rec, "memory": mem, "cost_analysis": counts.cost_dict(),
            "flops_by_op": counts.flops_by_op,
            "collectives": counts.collectives,
            "collective_bytes": ra.total_collective_bytes(
                counts.collectives),
            "collective_inter_bytes": ra.inter_collective_bytes(
                counts.collectives),
            "count_s": round(count_s, 1)}


def cell_rules(variant: str, spec: shp.ShapeSpec) -> dict:
    rules = dict(_variant_rules(variant, spec.kind))
    if spec.name == "long_500k":
        # the idle data axis absorbs the 500k cache (batch=1)
        rules["cache_seq"] = rules["cache_seq_long"]
    return rules


def run_cell(cell: shp.Cell, multi_pod: bool, variant: str,
             with_aux: bool = False, rank: int = 0, cfg=None) -> dict:
    """The record of one cell on a production mesh, as rank ``rank``
    counts it (``cfg`` in place of the cell's registry config: a cut
    one)."""
    cfg = cfg or get_config(cell.arch)
    spec = shp.SHAPES[cell.shape]
    rec = {"cell": cell.key, "mesh": MESH_NAMES[multi_pod],
           "variant": variant, "chips": 512 if multi_pod else 256,
           "rank": rank}
    if cell.skip:
        rec.update(status="skipped", reason=cell.skip)
        return rec
    mesh = make_production_mesh(multi_pod=multi_pod, rank=rank)
    rules = cell_rules(variant, spec)
    try:
        rec.update(count_cell(cfg, spec, mesh, variant, rules))
        rec["status"] = "ok"
        if with_aux and not multi_pod:
            rec["aux"] = run_aux(cfg, spec, mesh, variant, rules)
    except Exception as e:  # record, don't abort the sweep
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    return rec


def run_aux(cfg: ModelConfig, spec: shp.ShapeSpec, mesh, variant: str,
            rules) -> dict:
    """1-group / 2-group runs for the per-layer delta. The full run is
    eager, so its count needs no correction: these check
    ``extrapolate``. Batch is scaled down for train (grad_accum=1
    microbatch equivalent)."""
    out = {}
    aux_batch = max(mesh.shape.get("data", 1) * mesh.shape.get("pod", 1),
                    spec.global_batch // max(cfg.grad_accum, 1)) \
        if spec.kind == "train" else spec.global_batch
    for g in (1, 2):
        rec = count_cell(_aux_config(cfg, g), spec, mesh, variant, rules,
                         aux_batch=aux_batch)
        out[f"g{g}"] = {
            "flops": rec["cost_analysis"]["flops"],
            "bytes": rec["cost_analysis"]["bytes accessed"],
            "collective_bytes": rec["collective_bytes"],
            "collective_inter_bytes": rec["collective_inter_bytes"],
            "aux_batch": aux_batch,
        }
    out["n_groups"] = _n_groups(cfg)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", default="",
                    help="comma-separated arch:shape filters")
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--variant", default="axllm-int8",
                    help="baseline-bf16 | axllm-int8 | axllm-int4, with "
                    "optional -kvq / -tp modifiers (e.g. axllm-int8-kvq-tp)")
    ap.add_argument("--aux", action="store_true",
                    help="run the 1/2-group roofline aux counts")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value applied to every cell "
                    "in this invocation (hillclimb lever); use with --tag")
    ap.add_argument("--tag", default="",
                    help="suffix for result filenames (override experiments)")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank whose program is counted")
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)

    overrides = dict(kv.split("=", 1) for kv in args.set)
    configure = (lambda c: c)
    if overrides:
        from repro_torch.configs import apply_overrides
        configure = (lambda c: apply_overrides(c, overrides))

    os.makedirs(args.out, exist_ok=True)
    wanted = set(args.cells.split(",")) if args.cells else None
    meshes = {"single": [False], "multi": [True], "both": [False, True]}
    tag = f"__{args.tag}" if args.tag else ""
    for cell in shp.all_cells():
        if wanted and cell.key not in wanted:
            continue
        for multi in meshes[args.mesh]:
            mesh_name = MESH_NAMES[multi]
            fname = os.path.join(
                args.out,
                f"{cell.key.replace(':', '__')}__{mesh_name}"
                f"__{args.variant}{tag}.json")
            if os.path.exists(fname):
                with open(fname) as f:
                    prev = json.load(f)
                if prev.get("status") in ("ok", "skipped") and \
                        prev.get("rank", 0) == args.rank and \
                        (not args.aux or "aux" in prev or
                         prev.get("status") == "skipped" or multi):
                    print(f"[skip-cached] {cell.key} {mesh_name}")
                    continue
            print(f"[run] {cell.key} {mesh_name} {args.variant}", flush=True)
            rec = run_cell(cell, multi, args.variant, with_aux=args.aux,
                           rank=args.rank,
                           cfg=configure(get_config(cell.arch)))
            with open(fname, "w") as f:
                json.dump(rec, f, indent=1)
            print(f"  -> {rec['status']} "
                  f"(count {rec.get('count_s', '-')}s)", flush=True)
            if rec["status"] == "error":
                print(rec["error"], flush=True)


if __name__ == "__main__":
    main()
