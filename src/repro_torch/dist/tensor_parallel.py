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

Collectives take only all-reduce (SUM, MAX) and broadcast, which gloo also
carries on CUDA tensors (ranks sharing a card); a gather is an all-reduce
over a zero-filled buffer, exact in any type. A failing collective raises:
nothing moves to the CPU in its place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

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
    mlp: gate/up columns and down rows; vocab: embedding rows and lm_head
    columns. ``rules``: the serving rules every spec resolves under."""
    mesh: object
    rules: Dict[str, object]
    heads: bool
    kv_heads: bool
    seq: bool
    mlp: bool
    vocab: bool

    @property
    def size(self) -> int:
        return self.mesh.shape["model"]

    @property
    def rank(self) -> int:
        return self.mesh.model_rank

    def cuts(self, key: str) -> bool:
        """Whether the forward takes leaf (or LoRA target) ``key`` as this
        rank's block."""
        return key in _GROUPS and getattr(self, _GROUPS[key])


def active() -> Optional[Layout]:
    """The layout of the innermost engine context, or None."""
    return shd.current_layout()


# ---------------------------------------------------------------------------
# The layout
# ---------------------------------------------------------------------------

# The leaves (and LoRA targets) the forward takes as blocks, by the group
# of heads or columns each belongs to: a group is cut whole or not at all,
# and every other leaf, such as a norm scale, stays whole. On which dim a
# leaf is cut, and whether its size divides, is ``param_specs``' (and
# ``adapter_specs``', ``cache_specs``', ``paged_cache_specs``') alone.
_GROUPS = {"embedding": "vocab", "lm_head": "vocab",
           "wq": "heads", "wq_bias": "heads", "wo": "heads",
           "wk": "kv_heads", "wk_bias": "kv_heads",
           "wv": "kv_heads", "wv_bias": "kv_heads",
           "gate": "mlp", "up": "mlp", "down": "mlp"}
_FUSED = ("wqkv", "wqkv_bias", "gate_up")


def _full_sizes(cfg) -> Dict[str, int]:
    """The single-device size of each group's cut dim."""
    hd = cfg.resolved_head_dim
    return {"vocab": cfg.padded_vocab, "heads": cfg.n_heads * hd,
            "kv_heads": cfg.n_kv_heads * hd, "mlp": cfg.d_ff}


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
    a block where one dim is 1/P of its group's size and ``param_specs``
    of the shape with that dim whole cuts it there."""
    p, full = mesh.shape["model"], _full_sizes(cfg)

    def whole(key, x):
        shape = tuple(x.shape)
        for i, n in enumerate(shape if key in _GROUPS else ()):
            cand = shape[:i] + (n * p,) + shape[i + 1:]
            if n * p == full[_GROUPS[key]] and _spec(
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


def _carries_cut(key, qt: QTensor, mesh, rules) -> bool:
    """Whether ``param_specs`` cuts a QTensor's codes and scale with its
    logical cut: packed int4 codes in whole bytes, the scale rows of a
    per-group row cut in whole groups."""
    logical = shd.resolve_spec(qt.shape, shd._param_names(key, len(qt.shape)),
                               mesh, rules)
    q = _spec(key, qt, mesh, rules)
    if tuple(q.codes.spec) != logical:
        return False
    if qt.granularity == "per_group" and logical[-2] is not None:
        return q.scale.spec[-3] is not None
    return True


def plan(cfg, mesh, rules, *, n_slots: int, max_len: int, paged: bool,
         trees=()) -> Optional[Layout]:
    """The layout of ``cfg``'s serving on ``mesh`` under ``rules`` (None
    when the "model" axis has size 1): the groups whose sizes the rules
    cut, and the KV heads or the sequence as the cache's specs cut them.
    ``trees`` are the whole parameter trees the engine will cut, as it
    will serve them (quantized: target and draft): a group with a QTensor
    that ``param_specs`` does not cut in whole bytes and groups stays
    whole."""
    if mesh.shape["model"] == 1:
        return None
    hk, hd = cfg.n_kv_heads, cfg.resolved_head_dim

    def sharded(size, name):
        return shd.resolve_spec((size,), (name,), mesh, rules)[0] is not None

    flags = {"heads": sharded(cfg.n_heads, "heads"),
             "mlp": sharded(cfg.d_ff, "mlp"),
             "vocab": sharded(cfg.padded_vocab, "vocab")}
    if paged:
        k = shd.paged_cache_specs(
            {"k": torch.empty((1, 1, hk, hd), device="meta")}, mesh,
            rules)["k"].spec
        seq, flags["kv_heads"] = False, k[2] is not None
    else:
        k = shd.cache_specs(
            {"k": torch.empty((n_slots, max_len, hk, hd), device="meta")},
            mesh, n_slots, max_len, rules=rules)["k"].spec
        seq, flags["kv_heads"] = k[1] is not None, k[2] is not None
    for tree in trees:
        for key, leaf in _leaves(tree):
            if key in _FUSED:
                raise ValueError(
                    f"{key!r}: a mesh engine cuts unfused projections and "
                    "fuses each rank's block (fuse_qkv=True), so that no "
                    "rank mixes q, k and v heads")
            if key in _GROUPS and isinstance(leaf, QTensor) \
                    and not _carries_cut(key, leaf, mesh, rules):
                flags[_GROUPS[key]] = False
    if not flags["heads"]:
        flags["kv_heads"] = False   # a rank's q heads must own its KV heads
    return Layout(mesh, dict(rules), seq=seq, **flags)


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
            return {k: walk(node[k], spec[k], k if k in _GROUPS else key)
                    for k in node}
        return spec if lay.cuts(key) else _whole(node, lay.mesh)
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
    """The shardings of a KV cache (``init_cache`` / ``init_paged_cache``
    on the meta device) under ``lay``: ``cache_specs`` or
    ``paged_cache_specs`` under the layout's rules, with KV heads cut only
    where the layout cuts them and the sequence only in the serving cache
    of a sequence-cut layout (a prefill ``wave`` keeps every position)."""
    rules = dict(lay.rules, cache_seq_long=None)
    if not lay.kv_heads:
        rules["kv_heads"] = None
    if wave or not lay.seq:
        rules["cache_seq"] = None
    if paged:
        return shd.paged_cache_specs(meta, lay.mesh, rules)
    batch = meta["pos"].shape[0]
    return shd.cache_specs(meta, lay.mesh, batch, 0, rules=rules)


def local_cache(meta, specs, device):
    """Zeros of this rank's block of each leaf of ``meta`` under
    ``specs``."""
    return {name: torch.zeros(shd.local_shard(t, specs[name],
                                              specs[name].mesh,
                                              specs[name].mesh.rank).shape,
                              dtype=t.dtype, device=device)
            for name, t in meta.items()}


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def _all_reduce(x: torch.Tensor, mesh, op: str) -> torch.Tensor:
    import torch.distributed as dist
    x = x.contiguous()
    dist.all_reduce(x, op=getattr(dist.ReduceOp, op), group=mesh.group)
    return x


def all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of every rank's ``x`` (the row-parallel partials), taken in
    float32 and cast back to x's type."""
    return _all_reduce(x.to(torch.float32, copy=True), mesh,
                       "SUM").to(x.dtype)


def all_reduce_max(x: torch.Tensor, mesh) -> torch.Tensor:
    return _all_reduce(x.clone(), mesh, "MAX")


def gather_last(x: torch.Tensor, mesh) -> torch.Tensor:
    """[..., n] on each rank -> [..., P n], rank r's block at r: a sum over
    a zero-filled buffer, exact in any type."""
    n, r = x.shape[-1], mesh.model_rank
    full = x.new_zeros(*x.shape[:-1], n * mesh.shape["model"])
    full[..., r * n:(r + 1) * n] = x
    return _all_reduce(full, mesh, "SUM")


def broadcast_host(value: float, mesh) -> float:
    """Rank 0's ``value`` on every rank (over the mesh's host group)."""
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
    return _all_reduce(rows, lay.mesh, "SUM")


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
