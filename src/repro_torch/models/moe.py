"""Mixture-of-Experts FFN with sort-based capacity dispatch (the JAX
package's ``models/moe.py``).

In each batch row the (token, choice) pairs are sorted by expert id (a
stable sort, as ``jnp.argsort``, so real tokens take an expert's capacity
before the row's right padding), each expert keeps its first ``cap``
pairs, the kept tokens are gathered into an ``[E, B, cap, d]`` buffer, run
through the stacked expert FFNs as batched products on dequantized
weights (the JAX package's einsums; no AxLLM kernel), and combined back
with the router weights. The combine gathers each token's ``k`` outputs
back in (token, choice) order and sums them in a fixed order, so a run
repeats bit for bit on the card (no ``index_add_``).

Only the experts that hold a token are dequantized and multiplied; the
others' outputs would be masked at the combine, so the result is the
whole bank's. That set is read back from the device once a layer.

The two MoE variants of the registry:
  arctic-480b     128 routed top-2 + dense residual FFN in parallel
  qwen2-moe-a2.7b 60 routed top-4 (padded to 64) + 4 shared experts
Padded experts get a router logit of -1e30, so padding is exact.

Expert-parallel under a layout that cuts the experts
(``dist/tensor_parallel.py``): a rank holds the stacks of experts [r E/P,
(r+1) E/P), routes the same replicated tokens as every rank (the same
capacity drops), runs the experts it holds among those that hold a pair,
and one float32 all-reduce sums its combined partial with the shared (or
dense-residual) expert's row-parallel partial. In the training step the
tokens enter the block (their gradient summed over the ranks), and the
router, read whole, has its gradient summed over them too
(``tensor_parallel._inside``). Capacity is per batch row, so a batch cut
over "data" keeps the pairs one device keeps.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.quantization import QTensor, dequantize
from repro_torch.dist import tensor_parallel as tp
from repro_torch.models import layers as L


def _w(p, name, dtype, experts=None):
    """Expert bank ``name`` [E, n_in, n_out] as a dense tensor of
    ``dtype``, only the ``experts`` rows (a 1-D index) when given; a
    QTensor is dequantized."""
    w = p[name]
    if experts is not None:
        w = (dataclasses.replace(
            w, codes=w.codes[experts], scale=w.scale[experts],
            kernel_scale=w.kernel_scale[experts],
            shape=(experts.numel(), *w.shape[1:]))
             if isinstance(w, QTensor) else w[experts])
    if isinstance(w, QTensor):
        return dequantize(w, dtype)
    return w.to(dtype)


def init_moe(gen, cfg, dtype=torch.float32, lead=()):
    d, dff = cfg.d_model, cfg.d_ff
    e = cfg.padded_experts
    p = {
        "router": L.init_linear(gen, d, e, torch.float32, lead),
        "expert_gate": L.truncated_normal(gen, (*lead, e, d, dff),
                                          d ** -0.5, dtype),
        "expert_up": L.truncated_normal(gen, (*lead, e, d, dff), d ** -0.5,
                                        dtype),
        "expert_down": L.truncated_normal(gen, (*lead, e, dff, d),
                                          dff ** -0.5, dtype),
    }
    if cfg.n_shared_experts:
        p["shared"] = L.init_mlp(gen, cfg, dtype, lead,
                                 d_ff=dff * cfg.n_shared_experts)
    if cfg.moe_dense_residual:
        p["dense"] = L.init_mlp(gen, cfg, dtype, lead)
    return p


def _route(p, x2, cfg):
    """x2: [T, d] -> (weights [T, k] f32, experts [T, k] int64). The
    product is in f32; of tied logits the lower expert index wins, as in
    ``lax.top_k``; the softmax runs over the k selected logits."""
    logits = torch.matmul(x2.to(torch.float32),
                          p["router"].to(torch.float32))
    if cfg.padded_experts > cfg.n_experts:
        pad = torch.arange(cfg.padded_experts,
                           device=logits.device) >= cfg.n_experts
        logits = logits.masked_fill(pad, -1e30)
    vals, experts = torch.sort(logits, dim=-1, descending=True, stable=True)
    weights = torch.softmax(vals[:, :cfg.top_k], dim=-1)
    return weights, experts[:, :cfg.top_k]


def capacity(cfg, s: int) -> int:
    """Pairs an expert keeps in a batch row of ``s`` positions (the real
    ``n_experts``, not the padded count)."""
    k = cfg.top_k
    cap = int(cfg.capacity_factor * s * k / max(cfg.n_experts, 1))
    return max(4, min(cap, s * k))


def _dispatch_row(weights, experts, e: int, cap: int, k: int):
    """Dispatch metadata of every batch row at once (the JAX vmap).
    weights/experts: [B, S, k]. Returns (e_sorted, pos_clip, tok_sorted,
    w_sorted, keep, order), each [B, S * k]: the pairs in stable expert
    order, each one's position in its expert (``cap`` where dropped: a row
    that is sliced off), its token, its weight, whether it is kept, and
    the sort's permutation."""
    b, s, _ = experts.shape
    e_flat = experts.reshape(b, s * k)
    order = torch.argsort(e_flat, dim=-1, stable=True)
    e_sorted = torch.gather(e_flat, 1, order)
    w_sorted = torch.gather(weights.reshape(b, s * k), 1, order)
    ids = torch.arange(e, device=e_flat.device).expand(b, e).contiguous()
    seg_starts = torch.searchsorted(e_sorted, ids, side="left")     # [B, E]
    pos_in_e = torch.arange(s * k, device=e_flat.device) - torch.gather(
        seg_starts, 1, e_sorted)
    keep = pos_in_e < cap
    pos_clip = torch.where(keep, pos_in_e, torch.full_like(pos_in_e, cap))
    return e_sorted, pos_clip, order // k, w_sorted, keep, order


def _combine_row(y_sorted, w_sorted, order, s: int, k: int):
    """y_sorted: [B, S * k, d] expert outputs of the pairs in sorted order
    (0 where dropped) -> [B, S, d]: each pair weighted, gathered back to
    (token, choice) order through the inverse permutation and summed over
    the k choices in a fixed order."""
    b, _, d = y_sorted.shape
    y_pairs = y_sorted * w_sorted[..., None].to(y_sorted.dtype)
    inv = torch.empty_like(order)
    inv.scatter_(1, order, torch.arange(s * k, device=order.device).expand(
        b, s * k).contiguous())
    y_tok = torch.gather(y_pairs, 1, inv[..., None].expand(b, s * k, d))
    y_tok = y_tok.reshape(b, s, k, d)
    y = y_tok[:, :, 0]
    for j in range(1, k):
        y = y + y_tok[:, :, j]
    return y


def moe_ffn(p, x, cfg, impl: str = "auto"):
    """x: [B, S, d] -> [B, S, d]. Capacity is per batch row: ``cap = cf *
    S * k / n_experts`` (:func:`capacity`), S the padded length of the
    batch (a wave, a chunk, a suffix, or 1 at a decode step)."""
    b, s, d = x.shape
    k = cfg.top_k
    e = cfg.padded_experts
    cap = capacity(cfg, s)
    lay = tp.active()
    ep = lay is not None and lay.experts
    # the routed tokens enter the rank's experts (under autograd x's
    # gradient is summed over the ranks; the shared MLP enters on its own)
    xr = tp.enter(x, lay.mesh) if ep else x
    weights, experts = _route(p, xr.reshape(-1, d), cfg)
    e_sorted, pos_clip, tok_sorted, w_sorted, keep, order = _dispatch_row(
        weights.reshape(b, s, k), experts.reshape(b, s, k), e, cap, k)

    # the experts that hold a pair (every such expert keeps its first one),
    # of those this rank holds under an expert cut
    held = e // lay.size if ep else e
    lo = lay.rank * held if ep else 0
    if x.device.type == "meta":
        # no values to route by: every expert of the rank runs at capacity,
        # the work of JAX's static program (an einsum over every expert)
        run = torch.arange(lo, lo + held, device=x.device)
    else:
        run = torch.unique(e_sorted)
        if ep:
            run = run[(run >= lo) & (run < lo + held)]
    n_run = run.numel()
    # slot n_run takes the pairs of experts this rank does not run, and row
    # cap of each expert the dropped pairs; both are sliced off
    slot_of = torch.full((e,), n_run, dtype=torch.int64, device=x.device)
    slot_of[run] = torch.arange(n_run, device=x.device)
    slot = slot_of[e_sorted]                                   # [B, S * k]
    rows = torch.arange(b, device=x.device)[:, None].expand_as(slot)
    out_buf = torch.zeros((n_run + 1, b, cap + 1, d), dtype=x.dtype,
                          device=x.device)
    if n_run:
        buf = torch.zeros((n_run + 1, b, cap + 1, d), dtype=x.dtype,
                          device=x.device)
        buf[slot, rows, pos_clip] = torch.gather(
            xr, 1, tok_sorted[..., None].expand(b, s * k, d))
        buf = buf[:n_run, :, :cap].reshape(n_run, b * cap, d)
        local = run - lo
        h = torch.bmm(buf, _w(p, "expert_gate", x.dtype, local))
        u = torch.bmm(buf, _w(p, "expert_up", x.dtype, local))
        out = torch.bmm(F.silu(h) * u, _w(p, "expert_down", x.dtype, local))
        out_buf[:n_run, :, :cap] = out.reshape(n_run, b, cap, d)
    y_sorted = out_buf[slot, rows, pos_clip]    # elsewhere: a zero row
    y = _combine_row(y_sorted, w_sorted, order, s, k)

    if not ep:
        if "shared" in p:
            y = y + L.mlp_fwd(p["shared"], x, cfg, impl=impl)
        if "dense" in p:
            y = y + L.mlp_fwd(p["dense"], x, cfg, impl=impl)
        return y
    # one all-reduce: the routed partial and the row-parallel partials of
    # the shared and dense-residual experts, in float32
    part = y.to(torch.float32)
    whole = [p[n] for n in ("shared", "dense") if n in p]
    if lay.mlp:
        for sp in whole:
            part = part + L.mlp_fwd(sp, x, cfg, impl=impl, reduce=False)
        whole = []
    y = tp.all_reduce_sum(part, lay.mesh).to(x.dtype)
    for sp in whole:
        y = y + L.mlp_fwd(sp, x, cfg, impl=impl)
    return y


def moe_ffn_dense_oracle(p, x, cfg):
    """O(T·E) reference: every expert on every token, masked by the router;
    the tests' oracle for the sort-based dispatch. No serve path calls it."""
    b, s, d = x.shape
    x2 = x.reshape(-1, d)
    weights, experts = _route(p, x2, cfg)
    h = torch.einsum("td,edf->tef", x2, _w(p, "expert_gate", x.dtype))
    u = torch.einsum("td,edf->tef", x2, _w(p, "expert_up", x.dtype))
    y_all = torch.einsum("tef,efd->ted", F.silu(h) * u,
                         _w(p, "expert_down", x.dtype))        # [T, E, d]
    comb = torch.zeros((x2.shape[0], cfg.padded_experts),
                       dtype=torch.float32, device=x.device)
    comb.scatter_(1, experts, weights)       # top-k experts are distinct
    y2 = torch.einsum("te,ted->td", comb.to(x.dtype), y_all)
    if "shared" in p:
        y2 = y2 + L.mlp_fwd(p["shared"], x2, cfg)
    if "dense" in p:
        y2 = y2 + L.mlp_fwd(p["dense"], x2, cfg)
    return y2.reshape(b, s, d)
