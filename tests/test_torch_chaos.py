"""Port parity for the serving fault-injection harness: each of the eight
chaos scenarios (smoke mode), speculation_storm included, runs on the
JAX harness and on the port's, on the same weights
(``bridge.params_from_numpy``) and on the CPU. The port's report must be ok, every request's tokens and finish
reason must equal the JAX harness's, and so must the report's counts
(preemptions, restores, faults, retries, sheds). Both harnesses run one
model, head dim 16 included.
"""

import dataclasses

import jax  # noqa: F401  (keeps JAX on the CPU, as tests/conftest.py sets)
import pytest

from repro.serve import chaos as jchaos
from repro_torch.bridge import params_from_numpy
from repro_torch.serve import chaos as tchaos
from test_torch_engine import jax_tree_to_numpy

COUNTS = ("submitted", "finished", "rejected", "expired", "cancelled",
          "preempted", "preempted_prefill", "restored", "fast_restores",
          "faults_injected", "step_retries", "lost", "mismatched")


@pytest.fixture(scope="module")
def params():
    jparams = jchaos._params()
    return jparams, params_from_numpy(jax_tree_to_numpy(jparams), "cpu")


def test_models_differ_only_in_head_dim():
    # they no longer differ at all: the card's kernels take head dim 16
    assert dataclasses.asdict(tchaos.CFG) == dataclasses.asdict(jchaos.CFG)
    assert (jchaos.CFG.head_dim, tchaos.CFG.head_dim) == (16, 16)


def _record_outcomes(mod, monkeypatch) -> list:
    """Wrap ``mod._audit`` so that each audited engine's outcomes, rid ->
    (tokens, finish_reason), are recorded before the audit."""
    seen = []
    audit = mod._audit

    def wrapped(eng, *args, **kw):
        seen.append({r.rid: (list(r.tokens), r.finish_reason)
                     for r in eng.finished})
        return audit(eng, *args, **kw)

    monkeypatch.setattr(mod, "_audit", wrapped)
    return seen


@pytest.mark.parametrize("name", list(tchaos.SCENARIOS))
def test_scenario_matches_jax(params, name, monkeypatch):
    jparams, tparams = params
    jseen = _record_outcomes(jchaos, monkeypatch)
    tseen = _record_outcomes(tchaos, monkeypatch)
    jrep = jchaos.SCENARIOS[name](jparams, True)
    trep = tchaos.SCENARIOS[name](tparams, True, "cpu")
    assert jrep.ok, jrep.errors
    assert trep.ok, (trep.errors, trep.mismatches)
    assert tseen == jseen and len(tseen) == 1
    for count in COUNTS:
        assert getattr(trep, count) == getattr(jrep, count), count


def test_scenario_set_and_speculation_storm_raises():
    """The port runs every scenario of the JAX harness, in its order;
    speculation_storm no longer raises (it runs in
    ``test_scenario_matches_jax``) and its faults hit the speculative
    phases."""
    assert list(tchaos.SCENARIOS) == list(jchaos.SCENARIOS)
    assert not hasattr(tchaos, "NOT_PORTED")
    [rep] = tchaos.run(["speculation_storm"], smoke=True, device="cpu")
    assert rep.ok and rep.faults_injected == 4 and rep.preempted > 0


def test_main_runs_on_the_cpu_with_its_own_weights(capsys):
    assert tchaos.main(["--smoke", "--device", "cpu",
                        "--scenario", "dispatch_faults"]) == 0
    assert "chaos: 1/1 scenarios ok" in capsys.readouterr().out
