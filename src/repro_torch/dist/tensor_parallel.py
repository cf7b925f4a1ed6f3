"""Tensor-parallel serving: the layout a rank holds, its cut of parameters,
caches and adapters, and the collectives of the forward.

JAX's GSPMD partitions the serving program from the sharding rules
(``dist/sharding.py``); PyTorch has no GSPMD, so the port writes the
partition out in Megatron's form, which those rules encode. Over the
"model" axis of P ranks:

- wq/wk/wv and gate/up are column-parallel (a rank holds its heads' and
  its d_ff/P columns), wo and down row-parallel (the matching rows), and
  each attention block and each MLP block ends in one all-reduce (summed
  in float32, cast back);
- the vocabulary is cut over the ranks for the embedding (ids outside a
  rank's range read zeros, then one all-reduce) and for the head (the
  logits are gathered on every rank, so every rank samples the same
  token);
- the KV cache (dense or paged) is cut along KV heads when they divide P
  (``serve_rules_for`` gives ``SERVE_HEAD_RULES``). Otherwise wk/wv stay
  whole on every rank, and the dense cache is cut along its sequence axis
  (``SERVE_RULES``): prefill computes every position's K/V and each rank
  keeps its rows; decode gathers q over all heads, runs
  ``kernels.sharded_decode.decode_attention_seqsharded`` and takes its
  heads' slice of the output for wo.

Which dim of a weight, cache or adapter is cut, and whether its size
divides, is what ``param_specs``, ``cache_specs``, ``paged_cache_specs``
and ``adapter_specs`` say (the tested copies of JAX's). The layout
(:func:`plan`) only keeps a group of leaves whole where those would split
a head (glm4-9b's two KV heads of 128 are 256 columns, which divide 4) or
a group of a per-group scale (a row-parallel K/P that is not a multiple
of the group): GSPMD repairs such a split with communication, the port
keeps the block whole on every rank and needs none. Each rank quantizes
its own raw blocks (:func:`quantize_blocks`), so no rank holds the whole
quantized model. With mesh size 1 there is no layout and every path is
the single-device one.

The other families take the same principle, each leaf as the rules cut it
where that cut is exact and whole where it is not:

- moe: the routed expert stacks ``expert_gate/up/down`` [E, d, f] are cut
  on their expert dim (``param_specs``' "expert" -> "model"; "mlp" stays
  whole, the axis is taken). Every rank routes the same tokens, runs the
  experts it holds, and one float32 all-reduce sums the routed partial
  with the shared (or dense-residual) expert's row-parallel partial. An
  expert count the axis does not divide keeps the stacks whole.
- ssm (xLSTM): the mLSTM block's ``up`` [d, 2 di] is column-parallel and
  gathered whole (its [x | z] halves feed the conv, q/k and the gate,
  which run whole), its ``down`` [di, d] row-parallel on the rank's slice
  of the normed output. Whole on every rank: ``wq``/``wk`` (the SSD core
  takes every head), ``wif`` (``param_specs`` would put the i gates on one
  rank and the f gates on another), ``conv_w``/``conv_b``, ``if_bias``,
  the norms, and the whole sLSTM block (``wx``, ``r``, ``gate_bias`` and
  its GeGLU ``ff_gate``/``ff_up``/``ff_down``): its cell is a recurrence
  over positions that every rank runs. The states stay whole over "model"
  (JAX's ``_cache_names`` cuts them on the batch only).
- hybrid (zamba2): the Mamba2 ``in_proj`` [d, z|x|B|C|dt] is
  column-parallel and gathered whole only where every block boundary is a
  segment boundary (``_segments_whole``; at every width and P of the
  registry one falls inside x, so it stays whole); ``out_proj`` follows
  ``param_specs``, which cuts its output columns (it is not one of
  wo/down): column-parallel and gathered, exact. ``conv_w``, ``a_log``,
  ``dt_bias``, ``d_skip``, the norms and ``concat_proj`` stay whole; the
  conv, the SSD scan and the states run whole on every rank. The shared
  attention block takes the dense layout (its KV caches, one a site, cut
  as a dense cache is).

Over the "data" axis (:class:`Rows`) a rank runs the device rows of its
block of the engine's slots, where ``cache_specs`` cuts the batch over
"data" (the slot count divisible by D), and all of them where it falls
back to whole; the host schedule is whole on every rank, and each step's
rows are gathered over the data group (:func:`gather_rows`).

Collectives take only all-reduce (SUM, MAX) and broadcast, which gloo also
carries on CUDA tensors (ranks sharing a card); a gather is an all-reduce
over a zero-filled buffer, exact in any type. The tensor-parallel ones run
over the "model" group, the row gathers over the "data" group and the host
broadcast over the whole world. A failing collective raises: nothing moves
to the CPU in its place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.quantization import (QTensor, QuantConfig,
                                           _is_weight_matrix, quantize)
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import NamedSharding, QSharding


@dataclasses.dataclass(frozen=True)
class Layout:
    """Which blocks a rank of ``mesh`` holds cut over its "model" axis.

    heads: q heads (wq columns, wo rows); kv_heads: wk/wv columns and the
    KV cache's heads (implies heads); seq: the dense cache's sequence axis;
    mlp: gate/up columns and down rows (the mLSTM block's up and down in
    the ssm family); vocab: embedding rows and lm_head columns; experts:
    the routed expert stacks' expert dim; ssm_in / ssm_out: the Mamba2
    ``in_proj`` / ``out_proj`` columns. ``groups``: the leaf (or LoRA
    target) names of this family that the forward takes as blocks, by
    flag. ``rules``: the serving rules every spec resolves under.
    ``batch_axes``: the axes the dense cache's slot rows are cut over
    (any of ``("pod", "data")``, or none), which the sequence-sharded
    decode takes; in a training layout (``train``, :func:`train_layout`)
    the axes the batch's rows are cut over. ``seq_axes``: the axes the
    dense cache's sequence is cut over where ``seq`` ("model", or
    ("model", "data") under the "cache_seq_long" rule)."""
    mesh: object
    rules: Dict[str, object]
    groups: Dict[str, str]
    heads: bool
    kv_heads: bool
    seq: bool
    mlp: bool
    vocab: bool
    experts: bool = False
    ssm_in: bool = False
    ssm_out: bool = False
    batch_axes: Tuple[str, ...] = ()
    train: bool = False
    seq_axes: Tuple[str, ...] = ("model",)

    @property
    def size(self) -> int:
        return self.mesh.shape["model"]

    @property
    def rank(self) -> int:
        return self.mesh.model_rank

    def cuts(self, key: str) -> bool:
        """Whether the forward takes leaf (or LoRA target) ``key`` as this
        rank's block."""
        return key in self.groups and getattr(self, self.groups[key])


@dataclasses.dataclass(frozen=True)
class Rows:
    """The engine's slot rows (``total``) that a rank of ``mesh``'s "data"
    axis runs on its device: ``n`` rows from ``lo``, a block where
    ``cache_specs`` cuts the batch over "data", every row where it falls
    back to whole (or the engine keeps them whole: the paged pool)."""
    mesh: object
    total: int
    lo: int
    n: int

    @property
    def cut(self) -> bool:
        return self.n < self.total

    def take(self, a):
        """This rank's rows of ``a`` (host or device, ``total`` rows on its
        first dim)."""
        return a[self.lo:self.lo + self.n] if self.cut else a


def slot_rows(mesh, rules, total: int, whole: bool = False) -> Rows:
    """The rows of ``total`` that this rank runs: ``cache_specs``' cut of a
    batch of ``total`` over "data" (``resolve_spec`` of the "batch" name,
    its divisibility fallback included), or every row when ``whole``."""
    spec = shd.resolve_spec((total,), ("batch",), mesh, rules)[0]
    if whole or spec is None:
        return Rows(mesh, total, 0, total)
    n = total // mesh.shape["data"]
    return Rows(mesh, total, mesh.data_rank * n, n)


def active() -> Optional[Layout]:
    """The layout of the innermost engine context, or None."""
    return shd.current_layout()


# ---------------------------------------------------------------------------
# The layout
# ---------------------------------------------------------------------------

# The leaves (and LoRA targets) a transformer's forward takes as blocks, by
# the group of heads or columns (the layout's flag) each belongs to: a
# group is cut whole or not at all, and every other leaf, such as a norm
# scale, stays whole. On which dim a leaf is cut, and whether its size
# divides, is ``param_specs``' (and ``adapter_specs``', ``cache_specs``',
# ``paged_cache_specs``') alone.
_GROUPS = {"embedding": "vocab", "lm_head": "vocab",
           "wq": "heads", "wq_bias": "heads", "wo": "heads",
           "wk": "kv_heads", "wk_bias": "kv_heads",
           "wv": "kv_heads", "wv_bias": "kv_heads",
           "gate": "mlp", "up": "mlp", "down": "mlp"}
_FLAGS = ("heads", "kv_heads", "seq", "mlp", "vocab", "experts", "ssm_in",
          "ssm_out")
_FUSED = ("wqkv", "wqkv_bias", "gate_up")


def _mamba_segments(cfg):
    di = cfg.ssm_expand * cfg.d_model
    n, nh = cfg.ssm_state, di // cfg.ssm_head_dim
    return [di, di, n, n, nh]


def _table(cfg) -> Dict[str, Tuple[str, set]]:
    """Each leaf a family's forward can take as a block: (its flag, the
    single-device sizes of its cut dim)."""
    hd, d = cfg.resolved_head_dim, cfg.d_model
    vocab = ("vocab", {cfg.padded_vocab})
    if cfg.family == "ssm":     # xLSTM: the mLSTM up [d, 4d], down [2d, d]
        return {"embedding": vocab, "lm_head": vocab,
                "up": ("mlp", {4 * d}), "down": ("mlp", {2 * d})}
    size = {"vocab": vocab[1], "heads": {cfg.n_heads * hd},
            "kv_heads": {cfg.n_kv_heads * hd},
            "mlp": {cfg.d_ff, cfg.d_ff * max(cfg.n_shared_experts, 1)}}
    table = {k: (f, size[f]) for k, f in _GROUPS.items()}
    if cfg.family == "moe":
        table.update(dict.fromkeys(("expert_gate", "expert_up",
                                    "expert_down"),
                                   ("experts", {cfg.padded_experts})))
    if cfg.family == "hybrid":
        table.update(in_proj=("ssm_in", {sum(_mamba_segments(cfg))}),
                     out_proj=("ssm_out", {d}))
    return table


def groups_for(cfg) -> Dict[str, str]:
    """The leaf names a family's forward can take as blocks, by flag."""
    return {k: f for k, (f, _) in _table(cfg).items()}


def _segments_whole(sizes, p: int) -> bool:
    """Whether a P-way cut of a concatenation of ``sizes`` puts every
    block boundary on a segment boundary."""
    total = sum(sizes)
    if total % p:
        return False
    bounds = {sum(sizes[:i]) for i in range(len(sizes) + 1)}
    return all(total // p * i in bounds for i in range(p + 1))


def _leaves(tree, key=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, k)
    else:
        yield key, tree


def _spec(key, x, mesh, rules):
    return shd.param_specs({key: x}, mesh, rules)[key]


def whole_like(tree, cfg, mesh, rules):
    """The single-device tree of a parameter tree given whole or as this
    rank's blocks (``restore(shardings=...)``): a raw leaf as a meta
    tensor of its whole shape, a QTensor (given whole) as itself. A leaf is
    a block where one dim is 1/P of a whole size of its key and
    ``param_specs`` of the shape with that dim whole cuts it there."""
    p, table = mesh.shape["model"], _table(cfg)

    def whole(key, x):
        shape = tuple(x.shape)
        for i, n in enumerate(shape if key in table else ()):
            cand = shape[:i] + (n * p,) + shape[i + 1:]
            if n * p in table[key][1] and _spec(
                    key, torch.empty(cand, device="meta"), mesh,
                    rules).spec[i] == "model":
                shape = cand
                break
        if isinstance(x, QTensor):
            if shape != tuple(x.shape):
                raise ValueError(f"{key!r}: a QTensor block; a mesh engine "
                                 "takes QTensors whole, raw leaves either way")
            return x
        return torch.empty(shape, dtype=x.dtype, device="meta")

    def walk(node, key):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return whole(key, node)
    return walk(tree, "")


def _cut_in_table(key, leaf, sizes, mesh, rules) -> bool:
    """Whether ``param_specs`` cuts a whole leaf on a dim of one of its
    table ``sizes`` (not another dim it falls back to), and a QTensor's
    codes and scale with that cut: packed int4 codes in whole bytes, the
    scale rows of a per-group row cut in whole groups."""
    if isinstance(leaf, QTensor):
        logical = shd.resolve_spec(
            leaf.shape, shd._param_names(key, len(leaf.shape)), mesh, rules)
        q = _spec(key, leaf, mesh, rules)
        if tuple(q.codes.spec) != logical:
            return False
        if leaf.granularity == "per_group" and logical[-2] is not None \
                and q.scale.spec[-3] is None:
            return False
    else:
        logical = _spec(key, leaf, mesh, rules).spec
    return any(ax == "model" and leaf.shape[i] in sizes
               for i, ax in enumerate(logical))


def plan(cfg, mesh, rules, *, n_slots: int, max_len: int, paged: bool,
         trees=()) -> Optional[Layout]:
    """The layout of ``cfg``'s serving on ``mesh`` under ``rules`` (None
    when the "model" axis has size 1): the groups of the family's table
    that the rules cut, and the KV heads or the sequence as the cache's
    specs cut them. ``trees`` are the whole parameter trees the engine
    will cut, as it will serve them (quantized: target and draft): a
    group with a leaf that ``param_specs`` does not cut, or a QTensor it
    does not cut in whole bytes and groups, stays whole. Two cuts the
    specs cannot see keep a group whole too: one inside a q head, and a
    Mamba2 ``in_proj`` cut inside one of its segments."""
    if mesh.shape["model"] == 1:
        return None
    hk, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    table = _table(cfg)
    groups = {k: f for k, (f, _) in table.items()}
    flags = dict.fromkeys(_FLAGS, False)
    flags.update(dict.fromkeys(groups.values(), True))
    flags["heads"] &= shd.resolve_spec((cfg.n_heads,), ("heads",), mesh,
                                       rules)[0] is not None
    if "in_proj" in groups:
        flags["ssm_in"] = _segments_whole(_mamba_segments(cfg),
                                          mesh.shape["model"])
    k = shd.cache_specs(
        {"k": torch.empty((n_slots, max_len, hk, hd), device="meta")},
        mesh, n_slots, max_len, rules=rules)["k"].spec
    batch, seq_axes = shd._axes(k[0]), shd._axes(k[1]) or ("model",)
    if paged:
        k = shd.paged_cache_specs(
            {"k": torch.empty((1, 1, hk, hd), device="meta")}, mesh,
            rules)["k"].spec
        flags["kv_heads"] &= k[2] is not None
    else:
        flags["seq"] = "wk" in groups and k[1] is not None
        flags["kv_heads"] &= k[2] is not None
    for tree in trees:
        for key, leaf in _leaves(tree):
            if key in _FUSED:
                raise ValueError(
                    f"{key!r}: a mesh engine cuts unfused projections and "
                    "fuses each rank's block (fuse_qkv=True), so that no "
                    "rank mixes q, k and v heads")
            if key in table and not _cut_in_table(key, leaf, table[key][1],
                                                  mesh, rules):
                flags[groups[key]] = False
    if not flags["heads"]:
        flags["kv_heads"] = False   # a rank's q heads must own its KV heads
    return Layout(mesh, dict(rules), groups,
                  batch_axes=batch if not paged else (), seq_axes=seq_axes,
                  **flags)


# ---------------------------------------------------------------------------
# Specs and the cut
# ---------------------------------------------------------------------------

def _whole(x, mesh):
    whole = NamedSharding(mesh, ())
    if isinstance(x, QTensor):
        return QSharding(whole, whole,
                         None if x.codebook is None else whole)
    return whole


def layout_specs(tree, specs, lay: Layout):
    """``specs`` (``param_specs`` of a whole parameter tree, or
    ``adapter_specs`` of a registry's stacked adapters, under
    ``lay.rules``) with every leaf the layout keeps whole replicated: a
    group it does not cut, a leaf the forward takes whole such as a norm
    scale. A leaf belongs to the nearest enclosing key that names a group
    (an adapter's A and B to their target)."""
    def walk(node, spec, key):
        if isinstance(node, dict):
            return {k: walk(node[k], spec[k], k if k in lay.groups else key)
                    for k in node}
        if not lay.cuts(key):
            return _whole(node, lay.mesh)
        if isinstance(node, QTensor) and lay.groups[key] == "experts":
            # the scale follows the codes' expert cut, not its columns
            cut = spec.codes.spec[:-2] + (None, None)
            return dataclasses.replace(spec, scale=NamedSharding(lay.mesh,
                                                                 cut))
        return spec
    return walk(tree, specs, "")


def _mesh_of(spec):
    return (spec.codes if isinstance(spec, QSharding) else spec).mesh


def shard_params(params, whole, specs):
    """This rank's block of each leaf of ``params`` under ``specs`` (of the
    ``whole`` tree, ``whole_like`` of ``params``): a leaf of the whole
    shape is cut, one given as its block is taken as it is."""
    if isinstance(params, dict):
        return {k: shard_params(v, whole[k], specs[k])
                for k, v in params.items()}
    mesh = _mesh_of(specs)
    if isinstance(params, QTensor) or params.shape == whole.shape:
        return shd.local_shard(params, specs, mesh, mesh.rank)
    if params.shape == shd.local_shard(whole, specs, mesh, mesh.rank).shape:
        return params
    raise ValueError(f"a block of shape {tuple(params.shape)} of a "
                     f"{tuple(whole.shape)} leaf that the layout keeps whole")


def quantize_blocks(blocks, specs, qcfg: QuantConfig):
    """``quantize_tree`` of this rank's raw blocks (``specs``: theirs) into
    the single-device engine's codes. A scale that spans a cut dim (per
    channel: the rows of a row-parallel wo or down; per tensor: any cut) is
    the max over every rank's partial maximum, one all-reduce MAX; columns
    and the whole groups of a per-group row cut quantize alone."""
    def walk(prefix, node, spec):
        if isinstance(node, dict):
            return {k: walk(f"{prefix}/{k}", node[k], spec[k]) for k in node}
        if not _is_weight_matrix(prefix, node):
            return node
        nd = node.ndim
        dims = {"per_tensor": (nd - 2, nd - 1),
                "per_channel": (nd - 2,)}.get(qcfg.granularity, ())
        amax = None
        if any(spec.spec[d] is not None for d in dims
               if d < len(spec.spec)):
            amax = all_reduce_max(
                node.abs().amax(dim=dims, keepdim=True).float(), spec.mesh)
        return quantize(node, qcfg, amax=amax)
    return walk("", blocks, specs)


def cache_layout_specs(meta, lay: Layout, *, paged: bool,
                       wave: bool = False):
    """The shardings of a cache (``init_cache`` / ``init_paged_cache`` on
    the meta device, of this rank's slot rows: the batch is not cut again)
    under ``lay``: ``cache_specs`` or ``paged_cache_specs`` under the
    layout's rules (a recurrent state whole), with KV heads cut only
    where the layout cuts them and the sequence only in the serving cache
    of a sequence-cut layout (a prefill ``wave`` keeps every position)."""
    rules = dict(lay.rules, cache_seq_long=None, batch=None)
    if not lay.kv_heads:
        rules["kv_heads"] = None
    if wave or not lay.seq:
        rules["cache_seq"] = None
    if paged:
        return shd.paged_cache_specs(meta, lay.mesh, rules)
    batch = meta["pos"].shape[0]
    return shd.cache_specs(meta, lay.mesh, batch, 0, rules=rules)


def local_cache(meta, specs, device):
    """Zeros of this rank's block of each leaf of ``meta`` (nested dicts
    and tuples) under ``specs``."""
    if isinstance(meta, dict):
        return {k: local_cache(v, specs[k], device) for k, v in meta.items()}
    if isinstance(meta, (tuple, list)):
        return type(meta)(local_cache(t, s, device)
                          for t, s in zip(meta, specs))
    block = shd.local_shard(meta, specs, specs.mesh, specs.mesh.rank)
    return torch.zeros(block.shape, dtype=meta.dtype, device=device)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def _all_reduce(x: torch.Tensor, group, op: str) -> torch.Tensor:
    import torch.distributed as dist
    x = x.contiguous()
    dist.all_reduce(x, op=getattr(dist.ReduceOp, op), group=group)
    return x


def all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over the "model" group of every rank's ``x`` (the
    row-parallel partials), taken in float32 and cast back to x's type.
    Under autograd it is the Megatron exit of a row-parallel block
    (identity backward: the sum's gradient is the same on every rank)."""
    if _differentiable(x):
        return _Leave.apply(x, mesh.group, True)
    return _all_reduce(x.to(torch.float32, copy=True), mesh.group,
                       "SUM").to(x.dtype)


def all_reduce_max(x: torch.Tensor, mesh) -> torch.Tensor:
    return _all_reduce(x.clone(), mesh.group, "MAX")


def gather_last(x: torch.Tensor, mesh) -> torch.Tensor:
    """[..., n] on each rank of the "model" group -> [..., P n], rank r's
    block at r: a sum over a zero-filled buffer, exact in any type. Under
    autograd its backward takes the rank's slice (the gathered tensor's
    gradient is the same on every rank)."""
    if _differentiable(x):
        return _Gather.apply(x, mesh, "model", x.ndim - 1, False)
    return _gather_dim(x, mesh, "model", x.ndim - 1)


def gather_index(x: torch.Tensor, index, total: int, mesh,
                 dim: int = 0) -> torch.Tensor:
    """Rows ``index`` of a batch of ``total`` (``x``'s rows on ``dim``,
    each row computed on one rank of the "data" group) -> every row, on
    every rank of the group: a sum over a zero-filled buffer, exact in any
    type."""
    shape = list(x.shape)
    shape[dim] = total
    full = x.new_zeros(shape)
    full.index_copy_(dim, torch.as_tensor(index, dtype=torch.long,
                                          device=x.device), x)
    return _all_reduce(full, mesh.data_group, "SUM")


def gather_rows(x: torch.Tensor, rows: Rows, dim: int = 0) -> torch.Tensor:
    """This rank's ``rows`` of a step's result (``rows.n`` on ``dim``) ->
    every row, on every rank of the "data" group. Rows run whole take data
    rank 0's values."""
    mesh = rows.mesh
    if rows.cut:
        return gather_index(x, range(rows.lo, rows.lo + rows.n), rows.total,
                            mesh, dim)
    full = x.clone() if mesh.data_rank == 0 else torch.zeros_like(x)
    return _all_reduce(full, mesh.data_group, "SUM")


def broadcast_host(value: float, mesh) -> float:
    """Global rank 0's ``value`` on every rank (over the mesh's host group,
    the whole world)."""
    import torch.distributed as dist
    t = torch.tensor([value], dtype=torch.float64)
    dist.broadcast(t, src=0, group=mesh.host_group)
    return float(t.item())


# ---------------------------------------------------------------------------
# Forward pieces
# ---------------------------------------------------------------------------

def vocab_embed(table: torch.Tensor, tokens: torch.Tensor,
                lay: Layout) -> torch.Tensor:
    """Rows of a vocab-parallel embedding: a rank reads the ids in its
    range and zeros elsewhere, and one all-reduce sums them (exact)."""
    n = table.shape[0]
    local = tokens.long() - lay.rank * n
    inside = (local >= 0) & (local < n)
    rows = table[torch.clamp(local, 0, n - 1)]
    rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    if _differentiable(rows):     # backward reaches the rank's rows only
        return _Leave.apply(rows, lay.mesh.group, False)
    return _all_reduce(rows, lay.mesh.group, "SUM")


def head_range(cfg, lay: Layout):
    """(first q head, q heads) of this rank."""
    n = cfg.n_heads // lay.size if lay.heads else cfg.n_heads
    return (lay.rank * n if lay.heads else 0), n


def local_heads(cfg, lay: Optional[Layout]):
    """(q heads, KV heads) a rank's projections produce."""
    if lay is None:
        return cfg.n_heads, cfg.n_kv_heads
    p = lay.size
    return (cfg.n_heads // p if lay.heads else cfg.n_heads,
            cfg.n_kv_heads // p if lay.kv_heads else cfg.n_kv_heads)


def kv_for_heads(kv: torch.Tensor, cfg, lay: Layout) -> torch.Tensor:
    """The KV heads (dim -2) that this rank's q heads read, from a tensor
    holding all of them, so that q heads and KV heads keep a uniform
    grouping: a slice when the rank's heads cover whole groups or lie in
    one group, else one KV head per q head."""
    lo, n = head_range(cfg, lay)
    rep = cfg.n_heads // cfg.n_kv_heads
    if n % rep == 0:
        sel = kv.narrow(-2, lo // rep, n // rep)
    elif rep % n == 0:
        sel = kv.narrow(-2, lo // rep, 1)
    else:
        idx = (lo + torch.arange(n, device=kv.device)) // rep
        sel = kv.index_select(-2, idx)
    return sel.contiguous()


# ---------------------------------------------------------------------------
# Training: the layout, the gather of the compute tree and the collectives
# that autograd goes through
# ---------------------------------------------------------------------------

# the dim of each leaf of a family's table (``_table``) that the training
# forward cuts over "model" (Megatron: column-parallel out dims, among
# them the mLSTM up and Mamba2's in_proj/out_proj, row-parallel in dims,
# the vocabulary, the expert stacks' expert dim)
_TRAIN_DIM = {"embedding": -2, "lm_head": -1, "wq": -1, "wq_bias": -1,
              "wk": -1, "wk_bias": -1, "wv": -1, "wv_bias": -1, "wo": -2,
              "gate": -1, "up": -1, "down": -2, "expert_gate": -3,
              "expert_up": -3, "expert_down": -3, "in_proj": -1,
              "out_proj": -1}


def _differentiable(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """A fresh tensor of the SUM of ``x`` over ``group`` (None: one rank)."""
    x = x.contiguous().clone()
    if group is not None:
        _all_reduce(x, group, "SUM")
    return x


def _gather_dim(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Every rank's block of ``x`` along ``dim`` over ``axis`` (block i at
    rank i of the axis): a sum over a zero-filled buffer, exact."""
    p = mesh.shape[axis]
    if p == 1:
        return x
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * p
    full = x.new_zeros(shape)
    full.narrow(dim, mesh.coords[axis] * n, n).copy_(x)
    return _all_reduce(full, mesh.group_of(axis), "SUM")


def _take_dim(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    p = mesh.shape[axis]
    if p == 1:
        return x
    n = x.shape[dim] // p
    return x.narrow(dim, mesh.coords[axis] * n, n).contiguous()


class _Enter(torch.autograd.Function):
    """Identity forward, SUM over ``group`` backward: a tensor every rank
    holds whole that each rank uses for its part (Megatron's entry into a
    column-parallel block; a weight a batch shard reads whole)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g, ctx.group), None


class _Leave(torch.autograd.Function):
    """SUM over ``group`` forward (in float32 and cast back when ``f32``),
    identity backward: the exit of a row-parallel block, whose sum every
    rank then uses whole."""

    @staticmethod
    def forward(ctx, x, group, f32):
        y = x.to(torch.float32) if f32 else x
        return _sum_over(y, group).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    """All-gather of ``dim`` over ``axis`` forward; backward the rank's
    slice of the gradient, summed over the axis first when each rank's
    gradient is only its ``partial`` part (a reduce-scatter: FSDP's
    gather over a batch axis, a weight a column-parallel block reads
    whole). The sum is an all-reduce and a slice, as gloo carries
    all-reduce on card tensors."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim, partial):
        ctx.args = (mesh, axis, dim, partial)
        return _gather_dim(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim, partial = ctx.args
        if partial:
            g = _sum_over(g, mesh.group_of(axis))
        return _take_dim(g, mesh, axis, dim), None, None, None, None


def enter(x: torch.Tensor, mesh) -> torch.Tensor:
    """The entry of a column-parallel block over "model" (identity; under
    autograd the input's gradient is summed over the ranks)."""
    if _differentiable(x):
        return _Enter.apply(x, mesh.group)
    return x


def batch_axes(mesh) -> Tuple[str, ...]:
    """The axes a training batch's rows are cut over: those of the
    "batch" rule ("pod", "data") that the mesh has above one."""
    return tuple(a for a in ("pod", "data") if mesh.shape.get(a, 1) > 1)


def _entries(spec, ndim: int):
    entries = tuple(spec.spec) + (None,) * (ndim - len(spec.spec))
    return entries[:ndim]


def _check_spec(path, spec, shape, mesh):
    if not isinstance(spec, NamedSharding):
        raise ValueError(f"{path}: the training step takes a NamedSharding "
                         f"a leaf, got {type(spec).__name__}")
    if dict(spec.mesh.shape) != dict(mesh.shape) or \
            spec.mesh.rank != mesh.rank:
        raise ValueError(f"{path}: its spec is on another mesh "
                         f"({spec.mesh.shape}) than {mesh.shape}")
    if len(spec.spec) > len(shape):
        raise ValueError(f"{path}: spec {spec.spec} has more entries than "
                         f"its leaf {tuple(shape)} has dims")
    used = set()
    for d, e in zip(shape, _entries(spec, len(shape))):
        if e is None:
            continue
        if not isinstance(e, str):
            raise ValueError(
                f"{path}: spec {spec.spec} cuts a dim over several axes; the "
                "training step gathers blocks of one axis a dim")
        if e not in mesh.shape or e == "stage" or e in used:
            raise ValueError(f"{path}: spec {spec.spec} names axis {e!r}, "
                             f"which a training mesh {mesh.shape} cannot "
                             "cut a parameter over")
        used.add(e)
        if d % mesh.shape[e]:
            raise ValueError(f"{path}: dim {d} of {tuple(shape)} does not "
                             f"split over {e!r} of size {mesh.shape[e]}")


def _walk_paths(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _walk_paths(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _group_key(path, groups) -> str:
    """The key of a leaf path that names its group in ``groups``."""
    for k in reversed(path):
        if k in groups:
            return k
    return path[-1] if path else ""


def train_layout(cfg, mesh, specs, whole) -> Optional[Layout]:
    """The layout of ``cfg``'s training step on ``mesh`` (None for a mesh
    of one): the parameters are stored as the blocks of ``specs`` (a
    NamedSharding a leaf of the ``whole`` tree, usually ``param_specs``
    under ``DEFAULT_RULES``: FSDP over "data", tensor-parallel over
    "model"), and the forward cuts over "model" each group of the
    family's table (``groups_for``, the one serving's ``plan`` reads)
    whose every leaf ``specs`` cuts over "model" on its Megatron dim
    (``_TRAIN_DIM``), with whole heads (q heads dividing the axis; the KV
    heads cut only with them, else each rank reads the KV heads its q
    heads need) and a Mamba2 ``in_proj`` only where its cut falls on
    segment boundaries. Every other leaf is gathered whole for the
    forward. The batch is cut over ("pod", "data"). Raises ValueError for
    specs the step cannot honour (another mesh, an axis a parameter
    cannot be cut over, a dim that does not split)."""
    if mesh.size == 1:
        return None
    groups = groups_for(cfg)
    cut = {}

    def visit(path, leaf):
        spec = _at(specs, path)
        _check_spec("/".join(path), spec, leaf.shape, mesh)
        key = _group_key(path, groups)
        if key in groups and path[-1] in _TRAIN_DIM:
            entries = _entries(spec, leaf.ndim)
            ok = entries[_TRAIN_DIM[path[-1]]] == "model"
            cut[groups[key]] = cut.get(groups[key], True) and ok
        return None

    _walk_paths(whole, visit)
    m = mesh.shape.get("model", 1)
    flags = {f: bool(cut.get(f)) and m > 1 for f in _FLAGS if f != "seq"}
    flags["heads"] &= cfg.n_heads % m == 0
    flags["kv_heads"] &= flags["heads"] and cfg.n_kv_heads % m == 0
    if "in_proj" in groups:
        flags["ssm_in"] &= _segments_whole(_mamba_segments(cfg), m)
    return Layout(mesh, dict(shd.DEFAULT_RULES), groups, seq=False,
                  batch_axes=batch_axes(mesh), train=True, **flags)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _inside(path, lay: Layout) -> bool:
    """Whether the forward reads leaf ``path`` whole inside a block it cuts
    over "model", so that each rank's gradient is only its part: the MoE
    router, whose weights combine only the rank's experts' outputs; the
    KV projections a rank's q heads regroup, the q/k norms of its
    heads."""
    if lay.experts and path[-1] == "router":
        return True
    if not lay.heads:
        return False
    if "q_norm" in path or "k_norm" in path:
        return True
    return not lay.kv_heads and _group_key(path, lay.groups) in (
        "wk", "wv", "wk_bias", "wv_bias")


def to_compute(params, specs, lay: Layout):
    """The tree the forward reads, from this rank's blocks ``params``
    (under ``specs``): every leaf gathered whole over the axes it is cut
    over, except over "model" on the dim the layout cuts its group; under
    autograd each gather's backward gives the gradient of the rank's
    block, summed over the ranks whose gradients are parts (a batch axis;
    "model" for a leaf read whole inside a cut block), and a leaf not cut
    over such an axis has its gradient summed over it. So ``autograd.grad``
    of the loss over the blocks is the gradient of the whole batch's loss,
    cut as the blocks are."""
    mesh = lay.mesh

    def leaf(path, x):
        spec = _entries(_at(specs, path), x.ndim)
        key = _group_key(path, lay.groups)
        keep = None
        if lay.cuts(key) and path[-1] in _TRAIN_DIM:
            keep = x.ndim + _TRAIN_DIM[path[-1]]
        for axis in mesh.shape:
            if mesh.shape[axis] == 1:
                continue
            partial = axis in lay.batch_axes or (
                axis == "model" and _inside(path, lay))
            if axis in spec:
                dim = spec.index(axis)
                if axis == "model" and dim == keep:
                    continue
                x = _Gather.apply(x, mesh, axis, dim, partial) \
                    if _differentiable(x) else _gather_dim(x, mesh, axis, dim)
            elif partial and _differentiable(x):
                x = _Enter.apply(x, mesh.group_of(axis))
        return x

    return _walk_paths(params, leaf)


def sum_over_batch(x: torch.Tensor, lay: Optional[Layout]) -> torch.Tensor:
    """A rank's loss partial summed over the batch's ranks (no gradient)."""
    if lay is None or not lay.batch_axes:
        return x.detach()
    return _sum_over(x.detach(), lay.mesh.group_of(*lay.batch_axes))
