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
"""

from __future__ import annotations

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

    @property
    def ok(self) -> bool:
        return not self.failures


def teacher_forced_logits(cfg, params, prompt: Sequence[int],
                          tokens: Sequence[int], *, impl: str, device,
                          registry=None, adapter: Optional[str] = None
                          ) -> torch.Tensor:
    """[len(tokens), vocab] f32 logits of ``impl``'s prefill of ``prompt``
    followed by ``tokens``: row p is the distribution ``tokens[p]`` was
    drawn from. ``adapter`` names a ``registry`` adapter (None: base)."""
    seq = np.concatenate([np.asarray(prompt, np.int64),
                          np.asarray(tokens[:-1], np.int64)])
    toks = torch.from_numpy(seq[None]).to(device)
    api = get_model(cfg, impl=impl)
    lora = {}
    if registry is not None:
        idx = -1 if adapter is None else registry.index_of(adapter)
        lora = dict(adapters=registry.stacked, lora_scaling=registry.scaling,
                    adapter_idx=torch.tensor([idx], dtype=torch.int32,
                                             device=device))
    with torch.inference_mode():
        logits = api.prefill(params, {"tokens": toks},
                             api.init_cache(1, len(seq), device),
                             all_positions=True, **lora)[0]
    first = len(prompt) - 1
    return logits[0, first:first + len(tokens), :cfg.vocab_size].float()


def token_gate(cfg, params, prompts, generated, *, impl: str, tol_rel: float,
               device, registry=None, names=None) -> GateResult:
    """Hold ``generated[i]`` (the tokens a path served for ``prompts[i]``,
    with adapter ``names[i]``) against ``impl``'s teacher-forced logits:
    at every position the token's reference logit must lie within
    ``2 * tol`` of the reference maximum, ``tol = tol_rel * max(1, the
    request's largest |logit|)``."""
    names = names or [None] * len(prompts)
    positions = differ = 0
    min_slack, worst, failures = float("inf"), None, []
    for i, (prompt, toks) in enumerate(zip(prompts, generated)):
        if not len(toks):
            continue
        ref = teacher_forced_logits(cfg, params, prompt, toks, impl=impl,
                                    device=device, registry=registry,
                                    adapter=names[i])
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
    return GateResult(positions, differ, min_slack, worst, failures)
