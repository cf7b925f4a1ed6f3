"""Logical-axis sharding: rule translation from logical dim names to mesh
axes, with divisibility fallback and duplicate-axis avoidance (PyTorch port
of the JAX package's ``dist/sharding.py``, copied, not imported).

Model code never names mesh axes. Dims carry *logical* names ("batch",
"seq", "mlp", "heads", "cache_seq", ...) and the active rule set decides
which mesh axes those names occupy. Rules map a logical name to one mesh
axis, a tuple of axes (the dim is sharded over their product, greedy prefix
by divisibility), or None (replicate). A dim whose size does not divide the
axis product falls back to replication, and an axis already consumed by an
earlier dim of the same tensor is never reused.

Rule sets: ``DEFAULT_RULES`` (train and serve default: FSDP weights over
"data", TP over "model"), ``SERVE_RULES`` (TP-only weights),
``SERVE_HEAD_RULES`` (head-sharded KV caches) and ``DP_SERVE_RULES``
(replicated weights, batch over every axis).

A spec is a tuple with the entries of JAX's ``PartitionSpec`` (None, an
axis name, or a tuple of names per dim); :class:`NamedSharding` pairs one
with its mesh. ``param_specs``, ``cache_specs``, ``paged_cache_specs`` and
``adapter_specs`` give the JAX package's specs entry for entry.
:func:`local_shard` cuts the block of one rank out of a tensor (or a
``QTensor``): the port's layout is explicit, each rank holding its block
and the model code running the collectives itself
(``dist/tensor_parallel.py``). So JAX's ``shard()``, a constraint that
hints GSPMD about an activation, has no counterpart here: no activation
needs a hint.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.quantization import QTensor, qslice
from repro_torch.optim.adamw import BLOCK as Q8_BLOCK, Q8

# ---------------------------------------------------------------------------
# Rule sets
# ---------------------------------------------------------------------------

DEFAULT_RULES: Dict[str, Any] = {
    # activations / data
    "batch": ("pod", "data"),
    "seq": None,
    "expert": "model",
    # weights: FSDP along the embedding dim, TP along the wide dim
    "embed": "data",
    "mlp": "model",
    "heads": "model",
    "kv_heads": "model",
    "vocab": "model",
    # KV-cache sequence dim (decode): shard over "model"; the long-context
    # variant also absorbs the idle "data" axis
    "cache_seq": "model",
    "cache_seq_long": ("model", "data"),
    # pipeline stages
    "stage": "stage",
}

SERVE_RULES: Dict[str, Any] = dict(DEFAULT_RULES, embed=None)

# Tensor-parallel serving with head-sharded KV caches: when every layer's
# kv-head count divides the "model" axis, shard the cache along heads and
# keep the sequence dim local, so decode attention needs no cross-shard
# softmax combine. The engine picks between this and SERVE_RULES (whose
# "cache_seq" rule routes decode through decode_attention_seqsharded) via
# `serve_rules_for`.
SERVE_HEAD_RULES: Dict[str, Any] = dict(
    SERVE_RULES, cache_seq=None, cache_seq_long=None)

DP_SERVE_RULES: Dict[str, Any] = dict(
    DEFAULT_RULES,
    batch=("pod", "data", "model"),
    embed=None, mlp=None, heads=None, kv_heads=None, vocab=None,
    expert=None, cache_seq=None, cache_seq_long=None,
)

Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: JAX's ``NamedSharding`` (``.mesh``, ``.spec``)."""
    mesh: Any
    spec: Spec


@dataclasses.dataclass(frozen=True)
class QSharding:
    """The shardings of a ``QTensor``'s children (JAX mirrors the QTensor
    itself; the port's QTensor derives its kernel scale from its scale, so
    the specs get a record of their own)."""
    codes: NamedSharding
    scale: NamedSharding
    codebook: Optional[NamedSharding]


# ---------------------------------------------------------------------------
# Mesh context
# ---------------------------------------------------------------------------

_state = threading.local()


def _stack():
    if not hasattr(_state, "stack"):
        _state.stack = []
    return _state.stack


def _current() -> Optional[Tuple[Any, Dict[str, Any]]]:
    """(mesh, rules) of the innermost active context, or None."""
    stack = _stack()
    return stack[-1][:2] if stack else None


def current_binding():
    """(mesh, rules, layout) of the innermost active context, or None: what
    a function run later, on another thread, rebinds (the autograd engine
    recomputes a checkpointed layer on the device's thread)."""
    stack = _stack()
    return stack[-1] if stack else None


def current_layout():
    """The tensor-parallel layout bound by the innermost context (None
    without one, or when the context bound none)."""
    stack = _stack()
    return stack[-1][2] if stack else None


@contextlib.contextmanager
def activate(mesh, rules: Optional[Dict[str, Any]] = None, layout=None):
    """Bind (mesh, rules) for spec inference, and the engine's
    tensor-parallel ``layout`` (``tensor_parallel.Layout``) for the model
    code, which reads it at each call (PyTorch runs eagerly: there is no
    trace to bind at)."""
    _stack().append((mesh, dict(DEFAULT_RULES if rules is None else rules),
                     layout))
    try:
        yield mesh
    finally:
        _stack().pop()


def active_mesh(mesh=None):
    """``mesh``, or the mesh of the innermost active context (where JAX's
    collectives name an axis of the ``shard_map`` they run in)."""
    if mesh is not None:
        return mesh
    ctx = _current()
    if ctx is None:
        raise RuntimeError("no mesh: pass mesh= or call inside "
                           "dist.sharding.activate(mesh)")
    return ctx[0]


def _active_rules(rules: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    if rules is not None:
        return rules
    ctx = _current()
    return ctx[1] if ctx is not None else DEFAULT_RULES


# ---------------------------------------------------------------------------
# Rule resolution
# ---------------------------------------------------------------------------

def resolve_spec(shape: Sequence[int], names: Sequence[Optional[str]], mesh,
                 rules: Dict[str, Any]) -> Spec:
    """Translate logical dim names into a spec (a PartitionSpec's entries)
    against ``mesh``.

    Per dim: look up the rule (None / missing name -> replicate); keep the
    greedy prefix of rule axes that exist in the mesh, are unused by earlier
    dims, and whose cumulative product divides the dim size. ``mesh`` only
    needs a ``.shape`` mapping {axis: size} (tests pass stubs)."""
    axis_sizes = dict(mesh.shape)
    used = set()
    entries = []
    for dim, name in zip(shape, names):
        if name is None or name not in rules or rules[name] is None:
            entries.append(None)
            continue
        rule = rules[name]
        axes = (rule,) if isinstance(rule, str) else tuple(rule)
        chosen = []
        prod = 1
        for ax in axes:
            if ax not in axis_sizes or ax in used:
                continue
            if axis_sizes[ax] == 1:
                # a trivial axis contributes nothing: mesh size 1 must give
                # exactly the unsharded computation
                continue
            if dim % (prod * axis_sizes[ax]):
                break  # growing the product cannot restore divisibility
            chosen.append(ax)
            prod *= axis_sizes[ax]
        for ax in chosen:
            used.add(ax)
        if not chosen:
            entries.append(None)
        elif len(chosen) == 1:
            entries.append(chosen[0])
        else:
            entries.append(tuple(chosen))
    return tuple(entries)


# ---------------------------------------------------------------------------
# Whole-tree spec inference (params / KV caches)
# ---------------------------------------------------------------------------

def _param_names(key: str, ndim: int) -> Tuple[Optional[str], ...]:
    """Logical names for a parameter leaf, right-aligned on its dims.

    Leading dims (stacked layers) replicate; the trailing [in, out] matrix
    takes ("embed", "mlp") -> (FSDP, TP). Named exceptions: embeddings, the
    untied head, MoE expert stacks (the expert dim is the TP dim) and
    routers (replicated out dim).

    The block-output projections "wo" and "down" flip to ("mlp", "embed"):
    their *input* dim is the wide one, so the TP axis shards the
    contraction (row-parallel). Paired with column-parallel wqkv/gate_up
    this is the Megatron split: each attention/MLP block needs exactly one
    all-reduce, after the row-parallel matmul."""
    if ndim < 2:
        return (None,) * ndim
    if key == "embedding":
        return (None,) * (ndim - 2) + ("vocab", "embed")
    if key == "lm_head":
        return (None,) * (ndim - 2) + ("embed", "vocab")
    if key.startswith("expert_") and ndim >= 3:
        return (None,) * (ndim - 3) + ("expert", "embed", "mlp")
    if key == "router":
        return (None,) * (ndim - 2) + ("embed", None)
    if key in ("wo", "down"):
        return (None,) * (ndim - 2) + ("mlp", "embed")
    return (None,) * (ndim - 2) + ("embed", "mlp")


def _qtensor_specs(qt: QTensor, key: str, mesh, rules) -> QSharding:
    """Shardings of a QTensor's children. Codes keep the weight's logical
    names (packed int4 codes' trailing dim fails divisibility more often and
    replicates); scales take the out-dim name on their last axis, and a
    per-group scale's group-row dim the weight's in-dim name, so
    row-parallel codes keep their scale rows local."""
    names = _param_names(key, len(qt.shape))
    codes_spec = NamedSharding(
        mesh, resolve_spec(qt.codes.shape, names[-qt.codes.ndim:], mesh,
                           rules))
    scale_names = [None] * (qt.scale.ndim - 1) + [names[-1]]
    if qt.granularity == "per_group" and qt.scale.ndim >= 3:
        scale_names[-3] = names[-2]
    scale_spec = NamedSharding(
        mesh, resolve_spec(qt.scale.shape, tuple(scale_names), mesh, rules))
    cb_spec = None if qt.codebook is None else NamedSharding(mesh, ())
    return QSharding(codes=codes_spec, scale=scale_spec, codebook=cb_spec)


def _walk(node, key, leaf_fn):
    if isinstance(node, dict):
        return {k: _walk(v, k, leaf_fn) for k, v in node.items()}
    if isinstance(node, (list, tuple)) and not hasattr(node, "shape"):
        return type(node)(_walk(v, key, leaf_fn) for v in node)
    return leaf_fn(key, node)


def param_specs(params, mesh, rules: Optional[Dict[str, Any]] = None):
    """NamedSharding tree for a parameter tree (QSharding at a QTensor),
    of the same structure as ``params``."""
    rules = _active_rules(rules)

    def leaf(key, node):
        if isinstance(node, QTensor):
            return _qtensor_specs(node, key, mesh, rules)
        names = _param_names(key, len(node.shape))
        return NamedSharding(mesh,
                             resolve_spec(node.shape, names, mesh, rules))

    return _walk(params, "", leaf)


_CACHE_KV_KEYS = ("k", "v", "k_scale", "v_scale")


def _cache_names(key: str, shape, batch: int) -> Tuple[Optional[str], ...]:
    ndim = len(shape)
    if key in _CACHE_KV_KEYS and ndim >= 4:
        # [*stack, B, S, Hk, hd|1]
        return ((None,) * (ndim - 4)
                + ("batch", "cache_seq", "kv_heads", None))
    if key == "pos":
        return ("batch",) + (None,) * (ndim - 1)
    # recurrent state: shard the batch dim only, the leftmost dim whose
    # size matches the batch (leading dims are stacked layer counts)
    names = [None] * ndim
    for i, d in enumerate(shape):
        if d == batch:
            names[i] = "batch"
            break
    return tuple(names)


def cache_specs(cache, mesh, batch: int, max_len: int,
                long_context: bool = False,
                rules: Optional[Dict[str, Any]] = None):
    """NamedSharding tree for a KV/state cache. ``long_context=True`` routes
    the sequence dim through the "cache_seq_long" rule."""
    rules = dict(_active_rules(rules))
    if long_context and "cache_seq_long" in rules:
        rules["cache_seq"] = rules["cache_seq_long"]

    def leaf(key, node):
        names = _cache_names(key, node.shape, batch)
        return NamedSharding(mesh,
                             resolve_spec(node.shape, names, mesh, rules))

    return _walk(cache, "", leaf)


def _paged_names(key: str, shape) -> Tuple[Optional[str], ...]:
    ndim = len(shape)
    if key in _CACHE_KV_KEYS and ndim >= 4:
        # pool leaves [*stack, NB, bs, Hk, hd|1]: shard heads only; the
        # block axis is the pager's address space and stays whole on every
        # shard, so block tables index identically everywhere
        return (None,) * (ndim - 2) + ("kv_heads", None)
    if key == "pos":
        return ("batch",) + (None,) * (ndim - 1)
    return (None,) * ndim  # block_tables replicated (host-written)


def paged_cache_specs(cache, mesh, rules: Optional[Dict[str, Any]] = None):
    """NamedSharding tree for a block-paged KV cache: only the kv-head dim
    shards, so the host-side pager, the radix prefix index and the
    copy-on-write block copies stay shard-oblivious."""
    rules = _active_rules(rules)

    def leaf(key, node):
        names = _paged_names(key, node.shape)
        return NamedSharding(mesh,
                             resolve_spec(node.shape, names, mesh, rules))

    return _walk(cache, "", leaf)


def adapter_specs(stacked, mesh, rules: Optional[Dict[str, Any]] = None):
    """NamedSharding tree for AdapterRegistry's stacked LoRA tensors
    ({target: {"lora_a": [L, M, n_in, r], "lora_b": [L, M, r, n_out]}}).

    A is replicated (its output is the tiny rank dim); B shards its out dim
    with the logical name of the target projection's out dim:
    column-parallel for wq/wk/wv, replicated for wo."""
    rules = _active_rules(rules)
    out = {}
    for target, mats in stacked.items():
        b = mats["lora_b"]
        out_name = "embed" if target in ("wo", "down") else "mlp"
        b_names = (None,) * (b.ndim - 1) + (out_name,)
        out[target] = {
            "lora_a": NamedSharding(mesh, ()),
            "lora_b": NamedSharding(
                mesh, resolve_spec(b.shape, b_names, mesh, rules)),
        }
    return out


def serve_rules_for(mesh, n_kv_heads: int) -> Dict[str, Any]:
    """The serving rule set for a mesh: head-sharded KV caches when the
    kv-head count divides the "model" axis, otherwise SERVE_RULES, whose
    "cache_seq" rule shards the cache sequence dim (decode then runs
    ``kernels.sharded_decode.decode_attention_seqsharded``)."""
    model = int(dict(mesh.shape).get("model", 1))
    if model <= 1 or n_kv_heads % model == 0:
        return SERVE_HEAD_RULES
    return SERVE_RULES


# ---------------------------------------------------------------------------
# One rank's block
# ---------------------------------------------------------------------------

def mesh_coords(mesh, rank: int) -> Dict[str, int]:
    """Rank ``rank``'s index along each axis of ``mesh`` (ranks laid out
    row-major over ``mesh.shape``'s axes, in order)."""
    coords = {}
    for ax, size in reversed(list(dict(mesh.shape).items())):
        coords[ax] = rank % size
        rank //= size
    return coords


def _cut(x, spec: Spec, mesh, rank: int):
    sizes, coords = dict(mesh.shape), mesh_coords(mesh, rank)
    spec = tuple(spec) + (None,) * (x.ndim - len(spec))
    index, cut = [], False
    for dim, entry in zip(x.shape, spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        n = math.prod(sizes[a] for a in axes)
        if dim % n:
            raise ValueError(f"dim {dim} does not split into {n} blocks "
                             f"(spec {spec})")
        i = 0
        for a in axes:
            i = i * sizes[a] + coords[a]
        step = dim // n
        index.append(slice(i * step, (i + 1) * step))
        cut = cut or n > 1
    if not cut:
        return x
    block = x[tuple(index)]
    if isinstance(x, np.ndarray):
        return np.ascontiguousarray(block)
    return block.clone(memory_format=torch.contiguous_format)


def _spec_of(s) -> Spec:
    return s.spec if isinstance(s, NamedSharding) else tuple(s)


def local_shard(x, spec, mesh, rank: int):
    """The block of ``x`` that rank ``rank`` of ``mesh`` holds under
    ``spec`` (a spec tuple, a :class:`NamedSharding`, or a
    :class:`QSharding` for a ``QTensor``). A tensor comes back as a fresh
    contiguous tensor when it is cut and as itself when it is not; a numpy
    array (a checkpoint leaf read through ``mmap``) as a contiguous array.

    A QTensor's codes and scale are cut by their own specs (packed int4
    codes in whole bytes), the codebook stays whole, and the logical shape
    and the kernel scale follow. A ``Q8`` moment is cut by its
    :func:`moment_spec`: its codes by the spec, its block scales by the
    same entries (the last one over its blocks of 256)."""
    if isinstance(x, QTensor):
        if not isinstance(spec, QSharding):
            raise TypeError("a QTensor is cut by a QSharding")
        codes = _cut(x.codes, _spec_of(spec.codes), mesh, rank)
        scale = _cut(x.scale, _spec_of(spec.scale), mesh, rank)
        return qslice(x, codes, scale)
    if isinstance(x, Q8):
        codes = _cut(x.codes, _spec_of(spec), mesh, rank)
        scale = _cut(x.scale, _spec_of(spec), mesh, rank)
        return Q8(codes, scale, tuple(codes.shape),
                  q8_pad(codes.shape[-1], scale.shape[-1]))
    return _cut(x, _spec_of(spec), mesh, rank)


def q8_pad(last: int, n_blocks: int) -> int:
    """The padding of a Q8 moment whose codes' last dim is ``last`` and
    whose scale holds ``n_blocks`` blocks."""
    return n_blocks * Q8_BLOCK - last


def moment_spec(spec, shape, int8: bool):
    """The sharding of an AdamW moment of a parameter of whole ``shape``
    cut by ``spec`` (a NamedSharding): the parameter's own, except that an
    int8 (``Q8``) moment keeps its last dim whole over an axis whose blocks
    would not hold whole groups of 256 (a block scale of the whole leaf
    would then span two ranks), so that its codes and scales are those of
    the whole leaf's moment."""
    entries = tuple(spec.spec) + (None,) * (len(shape) - len(spec.spec))
    last = entries[-1] if entries else None
    if int8 and last is not None:
        n = math.prod(spec.mesh.shape[a] for a in _axes(last))
        if (shape[-1] // n) % Q8_BLOCK:
            entries = entries[:-1] + (None,)
    return NamedSharding(spec.mesh, entries)


def _axes(entry) -> Tuple[str, ...]:
    return () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))


def block_index(shape, spec, mesh, rank: int):
    """The slices of a whole tensor of ``shape`` that rank ``rank`` holds
    under ``spec`` (the inverse of :func:`local_shard`'s cut)."""
    sizes, coords = dict(mesh.shape), mesh_coords(mesh, rank)
    spec = tuple(_spec_of(spec)) + (None,) * (len(shape) - len(_spec_of(spec)))
    index = []
    for dim, entry in zip(shape, spec):
        n, i = 1, 0
        for a in _axes(entry):
            n *= sizes[a]
            i = i * sizes[a] + coords[a]
        step = dim // n
        index.append(slice(i * step, (i + 1) * step))
    return tuple(index)


def whole_shape(block_shape, spec, mesh) -> Tuple[int, ...]:
    """The whole shape of a block of ``block_shape`` cut by ``spec``."""
    spec = tuple(_spec_of(spec)) + (None,) * (len(block_shape)
                                              - len(_spec_of(spec)))
    return tuple(d * math.prod(mesh.shape[a] for a in _axes(e))
                 for d, e in zip(block_shape, spec))
