"""Roofline terms of a dry-run cell, from the port's own counts (PyTorch
port of the JAX package's ``roofline/analysis.py``).

Three terms per (arch x shape x mesh), in seconds, at the published peaks
of one NVIDIA H100 SXM (80 GB HBM3); these are data-sheet figures, not
measurements:

    compute    = FLOPs / (chips * 989e12)
    memory     = HBM bytes / (chips * 3.35e12)
    collective = intra-node bytes / (chips * 450e9)
                 + inter-node bytes / (chips * 50e9)

A collective whose group stays inside an HGX node of 8 cards moves at
NVLink 4's rate; one that spans nodes moves at the network's per-card
rate (one NDR InfiniBand port, 400 Gb/s). The dry run splits its
collective bytes by whether a group's ranks (row-major, 8 to a node)
share a node.

Sources. JAX compiles the whole program and reads XLA's analyses of it;
PyTorch has nothing to compile, so the port runs one rank's program
eagerly on meta tensors (no allocation, no kernel) and counts what it
does:

* FLOPs: ``torch.utils.flop_counter``'s formulas (``FlopCounterMode``'s
  registry: matmuls, their batched forms, convolutions), applied to each
  op as it runs, a composite op (``matmul``, ``einsum``) as the ops it is
  made of, as ``FlopCounterMode`` does;
* bytes accessed: the input plus output bytes of each aten op that moves
  data (views are free), as XLA's cost analysis counts an op's operands
  and result; transcendentals: the output elements of exp, log, tanh,
  sigmoid and the like;
* collective bytes: each ``c10d`` op's output bytes by JAX's kinds, an
  all-reduce counted 2x (the reduce-scatter and all-gather phases of a
  ring); send and recv count as collective-permute. The port's gathers
  are all-reduces over a zero-filled buffer (gloo carries no all-gather
  on card tensors), so they count as all-reduces;
* memory: argument, output and alias bytes from the rank's blocks; temp
  bytes the peak of the intermediates alive at once.

The meta device's own kernels are Python decompositions of most ops and
cost far more than the count; so a functional op seen before on inputs
of the same metadata takes its results' metadata from a memo, which is
all a meta kernel computes.

Eager execution runs every layer, so the counts have none of XLA's
scan-body undercount; :func:`extrapolate` from 1- and 2-group runs is a
check of the full count, not a correction. The counts are of the ops the
meta run takes, which are the plain versions (``kernels/ref.py``), not
the CUDA kernels: a dequantizing matmul's temporaries are counted, no
kernel time and no overlap of compute with communication are seen.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

PEAK_FLOPS = 989e12          # bf16 dense / card: H100 SXM data sheet
HBM_BW = 3.35e12             # B/s / card: H100 SXM HBM3 (PERF.md §3, layer 4)
LINK_BW = 450e9              # B/s / card, one direction: NVLink 4 (18 links)
NET_BW = 50e9                # B/s / card: one NDR InfiniBand port, 400 Gb/s
NODE_SIZE = 8                # cards of an HGX H100 node

# c10d op -> JAX's collective kind
_KINDS = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
    "recv_": "collective-permute",
    "broadcast_": "broadcast",
}

_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log1p", "log2", "tanh",
                   "sigmoid", "rsqrt", "sqrt", "sin", "cos", "erf", "pow",
                   "silu", "gelu", "softplus", "logsigmoid", "_softmax",
                   "_log_softmax", "reciprocal"}


def _tensors(tree, out=None):
    """The tensors of nested lists, tuples and dicts of op arguments."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_ranks(name: str, args):
    """The global ranks a c10d op's bytes move between: its process
    group's, or, for send and recv, this rank's and its peer's."""
    import torch.distributed as dist
    for a in args:
        if isinstance(a, torch.ScriptObject) and \
                "ProcessGroup" in str(a._type()):
            ranks = dist.get_process_group_ranks(dist.ProcessGroup.unbox(a))
            if name in ("send", "recv_"):
                return [dist.get_rank(), ranks[args[2]]]
            return ranks
    return None


class count_collectives(TorchDispatchMode):
    """Sums the output bytes of every ``c10d`` op run under it, by JAX's
    kind (``.collectives``: {kind: {"count", "bytes", "inter_bytes"}}).
    ``inter_bytes`` are those of ops whose group spans more than one node
    of ``node_size`` ranks."""

    def __init__(self, node_size: int = NODE_SIZE):
        super().__init__()
        self.node_size = node_size
        self.collectives: Dict[str, Dict[str, float]] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "c10d":
            name = func._schema.name.split("::")[-1]
            kind = _KINDS.get(name)
            if kind is not None:
                self.add(kind, _collective_bytes(args),
                         _group_ranks(name, args))
        return out

    def add(self, kind: str, nbytes: float, ranks=None) -> None:
        if kind == "all-reduce":
            nbytes *= 2.0
        d = self.collectives.setdefault(
            kind, {"count": 0, "bytes": 0.0, "inter_bytes": 0.0})
        d["count"] += 1
        d["bytes"] += nbytes
        if ranks is not None and \
                len({r // self.node_size for r in ranks}) > 1:
            d["inter_bytes"] += nbytes


def _collective_bytes(args) -> float:
    """The output bytes of a c10d op: its first argument is what it
    writes (the reduced or received tensors, a gather's output list or
    tensor) or, for send, what it sends."""
    return float(sum(_nbytes(t) for t in _tensors(args[0])))


def total_collective_bytes(coll: Dict[str, Dict[str, float]]) -> float:
    return sum(v["bytes"] for v in coll.values())


def inter_collective_bytes(coll: Dict[str, Dict[str, float]]) -> float:
    return sum(v.get("inter_bytes", 0.0) for v in coll.values())


def _arg_key(a):
    if isinstance(a, torch.Tensor):
        if a.device.type != "meta":
            raise TypeError
        return (tuple(a.shape), a.stride(), a.dtype)
    if isinstance(a, (list, tuple)):
        return tuple(_arg_key(x) for x in a)
    if a is None or isinstance(a, (bool, int, float, str, torch.dtype,
                                   torch.device, torch.layout,
                                   torch.memory_format)):
        return a
    raise TypeError


def _memo_key(func, args, kwargs):
    """The memo key of a functional op on meta tensors (its schema, its
    tensors' shapes, strides and dtypes, its other arguments), or None
    for an op that is not functional or has an argument of another kind."""
    schema = func._schema
    if any(r.alias_info is not None for r in schema.returns) or any(
            a.alias_info is not None and a.alias_info.is_write
            for a in schema.arguments):
        return None
    try:
        return (func, _arg_key(args), tuple(sorted(
            (k, _arg_key(v)) for k, v in kwargs.items())))
    except TypeError:
        return None


def _is_view(func) -> bool:
    """Whether every result of ``func`` aliases an input without writing
    it: a view, which moves no bytes."""
    rets = func._schema.returns
    return bool(rets) and all(
        r.alias_info is not None and not r.alias_info.is_write for r in rets)


def _fresh_outputs(func, out):
    """The results of ``func`` that alias no input: new buffers."""
    rets = func._schema.returns
    outs = out if isinstance(out, (tuple, list)) else (out,)
    fresh = []
    for r, o in zip(rets, outs):
        if r.alias_info is None:
            fresh.extend(_tensors(o))
    return fresh


class _CostMode(count_collectives):
    """FLOPs by op (``torch.utils.flop_counter``'s formulas, the ones
    ``FlopCounterMode`` applies), bytes accessed, transcendentals, the
    live bytes of the buffers made under it (their peak) and, as
    :class:`count_collectives`, the collectives."""

    def __init__(self, node_size: int = NODE_SIZE):
        super().__init__(node_size)
        self.flops: Dict[str, float] = {}
        self.bytes = 0.0
        self.transcendentals = 0.0
        self.live = 0
        self.peak = 0
        self.memo: Dict[tuple, tuple] = {}

    def _free(self, n: int) -> None:
        self.live -= n

    def _run(self, func, args, kwargs):
        """``func`` on meta tensors, its results made from a memo where
        the same op ran on inputs of the same metadata: on the meta device
        a result's shape, strides and dtype are a function of those alone,
        and an op the meta device decomposes in Python costs far more than
        the memo. A view or an op writing an input runs itself."""
        key = _memo_key(func, args, kwargs)
        if key is None:
            return func(*args, **kwargs)
        spec = self.memo.get(key)
        if spec is not None:
            made = [None if m is None else torch.empty_strided(
                m[0], m[1], dtype=m[2], device="meta") for m in spec[1]]
            return made[0] if spec[0] else tuple(made)
        out = func(*args, **kwargs)
        single = isinstance(out, torch.Tensor)
        outs = (out,) if single else out
        if isinstance(outs, (tuple, list)) and all(
                o is None or (isinstance(o, torch.Tensor)
                              and o.device.type == "meta") for o in outs):
            self.memo[key] = (single, [None if o is None else (
                tuple(o.shape), o.stride(), o.dtype) for o in outs])
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "c10d":
            return super().__torch_dispatch__(func, types, args, kwargs)
        packet = func._overloadpacket
        if packet not in flop_registry:
            # a composite op (matmul, einsum under inference mode) counted
            # as the ops it is made of, as autograd would dispatch them
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = self._run(func, args, kwargs)
        if packet in flop_registry:
            name = func._schema.name.split("::")[-1]
            self.flops[name] = self.flops.get(name, 0.0) + float(
                flop_registry[packet](*args, **kwargs, out_val=out))
        if not _is_view(func):
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in _tensors(out))
        if func._schema.name.split("::")[-1] in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in _tensors(out))
        for t in _fresh_outputs(func, out):
            n = _nbytes(t)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._free, n)
        return out


@dataclasses.dataclass
class Counts:
    """What one run under :func:`count_cost` did: ``flops``,
    ``flops_by_op`` ({aten op: FLOPs}), ``bytes_accessed``,
    ``transcendentals``, ``temp_bytes`` (the peak of the buffers made in
    the run alive at once) and ``collectives``."""
    flops: float = 0.0
    flops_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    bytes_accessed: float = 0.0
    transcendentals: float = 0.0
    temp_bytes: int = 0
    collectives: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)

    def cost_dict(self) -> dict:
        """JAX's ``cost_analysis`` keys."""
        return {"flops": self.flops, "bytes accessed": self.bytes_accessed,
                "transcendentals": self.transcendentals}


@contextlib.contextmanager
def count_cost(node_size: int = NODE_SIZE):
    """Count what the body runs: FLOPs, bytes accessed, transcendentals,
    the peak of its live intermediates and its collectives. Yields a
    :class:`Counts`, filled in when the body ends."""
    counts = Counts()
    mode = _CostMode(node_size)
    with mode:
        yield counts
    counts.flops_by_op = mode.flops
    counts.flops = sum(mode.flops.values())
    counts.bytes_accessed = mode.bytes
    counts.transcendentals = mode.transcendentals
    counts.temp_bytes = mode.peak
    counts.collectives = mode.collectives


def tree_bytes(tree) -> int:
    """The bytes of the distinct tensors of a tree (dicts, lists, tuples,
    and the children of a ``QTensor`` or a ``Q8``: codes, scales and the
    kernel scale), each counted once."""
    seen, total = set(), 0
    for t in _leaf_tensors(tree):
        if id(t) not in seen:
            seen.add(id(t))
            total += _nbytes(t)
    return total


def _leaf_tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaf_tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaf_tensors(v)
    elif hasattr(tree, "codes") and hasattr(tree, "scale"):
        for name in ("codes", "scale", "codebook", "kernel_scale"):
            t = getattr(tree, name, None)
            if isinstance(t, torch.Tensor):
                yield t


def memory_dict(args, outputs) -> dict:
    """JAX's ``memory_analysis`` keys from the rank's blocks: the bytes of
    the arguments, of the outputs, and of the outputs that are arguments
    updated in place (the donated buffers' counterpart). Temp bytes come
    from the run (:class:`Counts`); a key with no counterpart here, such
    as ``generated_code_size_in_bytes``, is absent."""
    arg_ids = {id(t) for t in _leaf_tensors(args)}
    alias, seen = 0, set()
    for t in _leaf_tensors(outputs):
        if id(t) in arg_ids and id(t) not in seen:
            seen.add(id(t))
            alias += _nbytes(t)
    return {"argument_size_in_bytes": tree_bytes(args),
            "output_size_in_bytes": tree_bytes(outputs),
            "alias_size_in_bytes": alias}


def extrapolate(cost1: float, cost2: float, n_groups: int) -> float:
    """cost(1 group), cost(2 groups) -> cost(n_groups) for homogeneous
    stacks: base + n * delta."""
    delta = cost2 - cost1
    base = cost1 - delta
    return base + n_groups * delta


# ---------------------------------------------------------------------------
# Analytic MODEL_FLOPS
# ---------------------------------------------------------------------------

def model_flops(cfg, shape_kind: str, seq: int, global_batch: int) -> float:
    """6·N·D (+ attention 12·L·d_head·H·S per token, causal halved) —
    training counts fwd+bwd (3x fwd); decode counts one token."""
    n_active = cfg.n_active_params()
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, hk, l = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers

    def attn_flops_per_token(kv_len):
        # qk and pv per layer; causal average kv_len/2 during prefill
        return l * (2 * h * hd * kv_len + 2 * h * hd * kv_len)

    if shape_kind == "train":
        tokens = seq * global_batch
        fwd = 2 * n_active * tokens + tokens * attn_flops_per_token(seq / 2)
        return 3 * fwd                      # fwd + 2x bwd
    if shape_kind == "prefill":
        tokens = seq * global_batch
        return 2 * n_active * tokens + tokens * attn_flops_per_token(seq / 2)
    # decode: one token against a seq-length cache
    tokens = global_batch
    kv = seq if cfg.family not in ("ssm",) else cfg.ssm_state
    return 2 * n_active * tokens + tokens * attn_flops_per_token(kv)


def useful_hbm_bytes(cfg, shape_kind: str, seq: int, global_batch: int,
                     weight_bytes_per_param: float = 1.0,
                     kv_bytes: float = 2.0) -> float:
    """Physics floor on global HBM traffic per step: bytes the hardware MUST
    move (each weight read once; the KV/state cache read once per decoded
    token; activations touched a small constant number of times).

    weight_bytes_per_param: 2.0 bf16 baseline, 1.0 int8 codes, 0.5 int4.
    kv_bytes: 2.0 bf16 cache, 1.0 int8-quantized cache.
    """
    n_active = cfg.n_active_params()
    l, hk, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    d = cfg.d_model
    act_round = 12 * l * d * 2.0                      # bytes/token/pass

    if shape_kind == "decode":
        w = n_active * weight_bytes_per_param
        if cfg.family == "ssm":
            state = cfg.n_layers * (2 * d) * (2 * d // cfg.n_heads + 1) * 4
            cache = global_batch * state
        elif cfg.family == "hybrid":
            sites = cfg.n_layers // max(cfg.hybrid_attn_every, 1)
            cache = global_batch * (
                sites * 2 * seq * hk * hd * kv_bytes
                + cfg.n_layers * 2 * d * cfg.ssm_state * 4)
        else:
            cache = global_batch * 2 * l * seq * hk * hd * kv_bytes
        return w + cache + global_batch * act_round
    if shape_kind == "prefill":
        tokens = seq * global_batch
        w = n_active * weight_bytes_per_param
        kv_write = global_batch * 2 * l * seq * hk * hd * kv_bytes \
            if cfg.family not in ("ssm",) else 0.0
        return w + tokens * act_round + kv_write
    # train: per optimizer step
    tokens = seq * global_batch
    accum = max(cfg.grad_accum, 1)
    w_bytes = cfg.n_params() * 2.0                    # bf16 compute params
    opt_bytes = cfg.n_params() * (4.0 if not cfg.int8_optimizer else 10.0)
    grads = cfg.n_params() * 4.0
    # weights re-read fwd+bwd per microbatch; activations 3 passes w/ remat
    return (2 * accum * w_bytes + grads + opt_bytes
            + 3 * tokens * act_round)


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float,
                   chips: int, inter_bytes: float = 0.0) -> dict:
    """The three terms (global counts over ``chips`` cards); ``coll_bytes``
    moves at the NVLink rate and ``inter_bytes`` at the network's."""
    comp = flops / (chips * PEAK_FLOPS)
    mem = hbm_bytes / (chips * HBM_BW)
    coll = coll_bytes / (chips * LINK_BW) + inter_bytes / (chips * NET_BW)
    dom = max(("compute", comp), ("memory", mem), ("collective", coll),
              key=lambda kv: kv[1])
    return {"compute_s": comp, "memory_s": mem, "collective_s": coll,
            "dominant": dom[0],
            "bound_step_s": max(comp, mem, coll)}
