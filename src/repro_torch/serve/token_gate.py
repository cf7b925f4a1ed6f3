"""Teacher-forced token gate: the greedy tokens one serving path generated,
held against another path's logits at every generated position.

Two paths whose logits agree within a tolerance can still pick different
greedy tokens where two logits nearly tie, and from there on their
continuations share nothing, so comparing the two token streams says
little. The gate instead judges each generated token given its own
path's prefix: one prefill of the prompt followed by the generated
tokens, through the reference path (the plain versions), gives the
reference logits ``ref[p]`` at every generated position p, and the gate
requires

    ref[p][tok[p]] >= max(ref[p]) - 2 * tol

where ``tol`` is the logits tolerance the two paths are held to (a share
``tol_rel`` of the request's logit scale). A path whose logits lie within
``tol`` of the reference picks the argmax of its own logits, whose
reference logit is at most ``2 * tol`` below the reference maximum; a
defect that moves the logits further trips the gate, at whatever step it
first shows.

One prefill of the whole sequence computes what serving computed only
where a position's output does not depend on how the sequence was
batched. A moe layer's capacity does: an expert keeps ``cap(S)`` pairs
of a batch row of padded length S, a prompt's tokens compete for it in
the prefill wave and a decode step's single token never does. For such a
model the gate is given each request's served prefill length and replays
the serving schedule instead (:func:`replayed_logits`): the prompt
right-padded to that length, then one teacher-forced decode step a
generated token.

A moe layer's routing is discrete as well: where two experts' router
logits nearly tie, paths that agree within ``tol`` may choose different
experts, and with a capacity one changed choice moves which later pairs
drop. The gate's tolerance argument then fails for reasons that are not
defects. Given the served path's routing (:class:`Routes`, recorded from
a pass of the served path), the replay takes the served expert choices
and holds the continuous rest to the gate, and a routing gate holds each
choice instead: every expert the served path chose for a token must have
a reference router logit within ``2 * tol`` of the reference's k-th
largest, ``tol = tol_rel * max(1, the token's largest |router logit|)``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.models.model import get_model


@dataclasses.dataclass
class GateResult:
    positions: int        # generated positions checked
    differ: int           # where the token is not the reference's argmax
    min_slack: float      # least ref[tok] - (max(ref) - 2 tol), over all
    worst: tuple          # (request, position) of min_slack
    failures: List[tuple]  # (request, position, slack) below 0
    routes: Optional["Routes"] = None   # the routing gate's account

    @property
    def ok(self) -> bool:
        return not self.failures and (self.routes is None
                                      or self.routes.ok)


class Routes:
    """The expert choices of a moe model's layers by (request, layer,
    position): recorded from a pass of one path (:meth:`record`), then
    forced on a pass of another (:meth:`force`), which keeps the account
    of the routing gate.

    Before each model call the caller says what its batch rows hold
    (:meth:`at`); the moe layers of the call then count themselves in
    order. Within either block ``repro_torch.models.moe._route`` is
    replaced, so only one pass may run at a time."""

    def __init__(self):
        self.book = {}          # (request, layer, position) -> experts
        self.rows, self.pos, self.layer = [], np.zeros((0, 0)), 0
        self.tokens = self.differ = self.missing = 0
        self.min_slack, self.failures = float("inf"), []

    @property
    def ok(self) -> bool:
        return not self.failures and not self.missing

    def at(self, rows, pos) -> None:
        """Before a model call: batch row b holds request ``rows[b]``
        (None: no request) at positions ``pos[b]`` (an [B, S] array, -1
        at padding)."""
        self.rows, self.pos, self.layer = list(rows), np.asarray(pos), 0

    def _tokens(self, layer: int):
        """(flat token index, (request, layer, position)) of every real
        token of the current call."""
        s = self.pos.shape[1]
        for b, r in enumerate(self.rows):
            if r is None:
                continue
            for j in np.nonzero(self.pos[b] >= 0)[0]:
                yield b * s + int(j), (r, layer, int(self.pos[b, j]))

    @contextlib.contextmanager
    def _route_by(self, fn):
        from repro_torch.models import moe as M
        orig = M._route
        M._route = lambda p, x2, cfg: fn(orig, p, x2, cfg)
        try:
            yield self
        finally:
            M._route = orig

    def record(self):
        """Within the block every moe layer routes as before and records
        its real tokens' choices."""
        def fn(orig, p, x2, cfg):
            weights, experts = orig(p, x2, cfg)
            layer, self.layer = self.layer, self.layer + 1
            got = experts.cpu().numpy()
            for t, key in self._tokens(layer):
                self.book[key] = got[t]
            return weights, experts
        return self._route_by(fn)

    def force(self, tol_rel: float):
        """Within the block every moe layer takes the recorded choices of
        its real tokens (weights: the softmax of its own router logits at
        them) and holds each recorded choice to its own router logits;
        tokens without a record route as before and are counted."""
        def fn(orig, p, x2, cfg):
            _, experts = orig(p, x2, cfg)
            layer, self.layer = self.layer, self.layer + 1
            logits = torch.matmul(x2.to(torch.float32),
                                  p["router"].to(torch.float32))
            n, k = cfg.n_experts, cfg.top_k
            logits[:, n:] = -1e30
            idx, rec = [], []
            for t, key in self._tokens(layer):
                got = self.book.get(key)
                if got is None:
                    self.missing += 1
                else:
                    idx.append(t)
                    rec.append(got)
            experts = experts.clone()
            if idx:
                dev = experts.device
                it = torch.tensor(idx, device=dev)
                rt = torch.from_numpy(np.stack(rec)).to(dev)
                plain = torch.sort(experts[it], -1).values
                experts[it] = rt
                lg = logits[it, :n]
                kth = torch.topk(lg, k, dim=-1).values[:, -1]
                tol = tol_rel * torch.clamp(lg.abs().amax(-1), min=1.0)
                slack = (lg.gather(1, rt).amin(-1) - (kth - 2.0 * tol)).cpu()
                self.tokens += len(idx)
                self.differ += int((torch.sort(rt, -1).values != plain)
                                   .any(-1).sum())
                j = int(slack.argmin())
                self.min_slack = min(self.min_slack, float(slack[j]))
                keys = [key for _, key in self._tokens(layer)
                        if key in self.book]
                self.failures += [(keys[i], float(slack[i])) for i in
                                  torch.nonzero(slack < 0)[:, 0].tolist()]
            weights = torch.softmax(logits.gather(1, experts), dim=-1)
            return weights, experts
        return self._route_by(fn)


def _batch(toks, frames, device) -> dict:
    """A prefill batch: the tokens, and an encoder-decoder model's frames
    (one [enc_seq, d_feat] array or tensor a request) stacked."""
    batch = {"tokens": toks}
    if frames is not None:
        batch["frames"] = torch.stack([torch.as_tensor(f) for f in frames]
                                      ).to(device=device,
                                           dtype=torch.float32)
    return batch


def teacher_forced_logits(cfg, params, prompts, generated, *, impl: str,
                          device, registry=None, names=None,
                          frames=None) -> list:
    """Per request, [len(generated[i]), vocab] f32 logits of ``impl``'s
    prefill of ``prompts[i]`` followed by ``generated[i]``: row p is the
    distribution ``generated[i][p]`` was drawn from. Request i takes the
    ``registry`` adapter ``names[i]`` (None: base) and, for an
    encoder-decoder model, its own ``frames[i]``. Every request's
    sequence (its prompt and all its tokens but the last) must have one
    length: the requests run as one prefill with no padding, which
    computes what each alone would."""
    seqs = [np.concatenate([np.asarray(p, np.int64),
                            np.asarray(g[:-1], np.int64)])
            for p, g in zip(prompts, generated)]
    if len({len(q) for q in seqs}) != 1:
        raise ValueError("teacher_forced_logits: sequences of one length "
                         "only (prompt plus all tokens but the last)")
    toks = torch.from_numpy(np.stack(seqs)).to(device)
    api = get_model(cfg, impl=impl)
    lora = {}
    if registry is not None:
        rows = [-1 if n is None else registry.index_of(n)
                for n in names or [None] * len(prompts)]
        lora = dict(adapters=registry.stacked, lora_scaling=registry.scaling,
                    adapter_idx=torch.tensor(rows, dtype=torch.int32,
                                             device=device))
    with torch.inference_mode():
        logits = api.prefill(params, _batch(toks, frames, device),
                             api.init_cache(len(seqs), toks.shape[1], device),
                             all_positions=True, **lora)[0]
    return [logits[i, len(p) - 1:len(p) - 1 + len(g),
                   :cfg.vocab_size].float()
            for i, (p, g) in enumerate(zip(prompts, generated))]


def replayed_logits(cfg, params, prompts, generated, prefill_len: int, *,
                    impl: str, device, registry=None, names=None,
                    routes: Optional[Routes] = None, rids=None,
                    frames=None) -> list:
    """Per request, [len(generated[i]), vocab] f32 logits of ``impl``
    replaying the serving schedule: the prompts in one prefill wave
    right-padded to ``prefill_len`` (the first token's logits), then one
    decode step a generated token, teacher-forced with the served
    tokens. With ``routes`` (inside its :meth:`Routes.force` block) the
    moe layers take the choices recorded for request ``rids[i]``;
    ``frames`` as in :func:`teacher_forced_logits`."""
    b = len(prompts)
    steps = max(len(g) for g in generated)
    toks = np.zeros((b, prefill_len), np.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    lengths = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                           device=device)
    api = get_model(cfg, impl=impl)
    lora = {}
    if registry is not None:
        rows = [-1 if n is None else registry.index_of(n)
                for n in names or [None] * b]
        lora = dict(adapters=registry.stacked, lora_scaling=registry.scaling,
                    adapter_idx=torch.tensor(rows, dtype=torch.int32,
                                             device=device))
    cache = api.init_cache(b, prefill_len + steps, device)
    rids = list(range(b)) if rids is None else rids
    ar = np.arange(prefill_len)
    with torch.inference_mode():
        if routes is not None:
            routes.at(rids, np.where(ar[None, :] < np.array(
                [len(p) for p in prompts])[:, None], ar[None, :], -1))
        logits, cache = api.prefill(
            params, _batch(torch.from_numpy(toks).to(device), frames,
                           device), cache, lengths=lengths, **lora)
        out = [logits[:, :cfg.vocab_size].float()]
        for t in range(1, steps):
            fed = torch.tensor([g[t - 1] if t - 1 < len(g) else 0
                                for g in generated], device=device)
            if routes is not None:
                routes.at(rids, [[len(p) + t - 1 if t - 1 < len(g) else -1]
                                 for p, g in zip(prompts, generated)])
            logits, cache = api.decode(params, fed, cache, **lora)
            out.append(logits[:, :cfg.vocab_size].float())
    ref = torch.stack(out, 1)
    return [ref[i, :len(g)] for i, g in enumerate(generated)]


def token_gate(cfg, params, prompts, generated, *, impl: str, tol_rel: float,
               device, registry=None, names=None,
               prefill_lens: Optional[Sequence[int]] = None,
               routes: Optional[Routes] = None,
               frames=None) -> GateResult:
    """Hold ``generated[i]`` (the tokens a path served for ``prompts[i]``,
    with adapter ``names[i]``) against ``impl``'s teacher-forced logits:
    at every position the token's reference logit must lie within
    ``2 * tol`` of the reference maximum, ``tol = tol_rel * max(1, the
    request's largest |logit|)``. The reference is a teacher-forced
    prefill of requests of one sequence length at a time, at most 8 a
    batch (:func:`teacher_forced_logits`). With ``prefill_lens`` (each
    request's served prefill length) it replays the serving schedule
    instead (:func:`replayed_logits`, requests of one length a batch); with
    ``routes`` as well (recorded from the served path, request i under
    key i) it takes the served expert choices and keeps the routing
    gate's account in ``routes``. ``frames`` (one [enc_seq, d_feat] a
    request) teacher-forces an encoder-decoder model on each request's
    own frames."""
    pick = (lambda part: None) if frames is None else \
        (lambda part: [frames[i] for i in part])
    names = names or [None] * len(prompts)
    if routes is not None and prefill_lens is None:
        raise ValueError("routes= needs prefill_lens=: the routing of a "
                         "moe model is held on the serving schedule")
    refs = {}
    with contextlib.nullcontext() if routes is None else \
            routes.force(tol_rel):
        for pl in sorted(set(prefill_lens or ())):
            idx = [i for i, n in enumerate(prefill_lens)
                   if n == pl and len(generated[i])]
            for j0 in range(0, len(idx), 8):     # at most 8 rows a batch
                part = idx[j0:j0 + 8]
                refs.update(zip(part, replayed_logits(
                    cfg, params, [prompts[i] for i in part],
                    [generated[i] for i in part], pl, impl=impl,
                    device=device, registry=registry,
                    names=[names[i] for i in part], routes=routes,
                    rids=part, frames=pick(part))))
    by_len = {}
    for i, (prompt, toks) in enumerate(zip(prompts, generated)):
        if len(toks) and i not in refs:
            by_len.setdefault(len(prompt) + len(toks) - 1, []).append(i)
    for idx in by_len.values():
        for j0 in range(0, len(idx), 8):         # at most 8 rows a batch
            part = idx[j0:j0 + 8]
            refs.update(zip(part, teacher_forced_logits(
                cfg, params, [prompts[i] for i in part],
                [generated[i] for i in part], impl=impl, device=device,
                registry=registry, names=[names[i] for i in part],
                frames=pick(part))))
    positions = differ = 0
    min_slack, worst, failures = float("inf"), None, []
    for i, (prompt, toks) in enumerate(zip(prompts, generated)):
        if not len(toks):
            continue
        ref = refs[i]
        tol = tol_rel * max(1.0, float(ref.abs().max()))
        t = torch.as_tensor(np.asarray(toks, np.int64), device=ref.device)
        top = ref.max(-1).values
        slack = ref.gather(1, t[:, None])[:, 0] - (top - 2.0 * tol)
        positions += len(toks)
        differ += int((ref.argmax(-1) != t).sum())
        j = int(slack.argmin())
        if float(slack[j]) < min_slack:
            min_slack, worst = float(slack[j]), (i, j)
        failures += [(i, int(p), float(slack[p]))
                     for p in torch.nonzero(slack < 0)[:, 0].tolist()]
    return GateResult(positions, differ, min_slack, worst, failures, routes)
