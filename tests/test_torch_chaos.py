"""Port parity for the serving fault-injection harness: each of the seven
ported chaos scenarios (smoke mode) runs on the JAX harness and on the
port's, on the same weights (``bridge.params_from_numpy``) and on the
CPU. The port's report must be ok, every request's tokens and finish
reason must equal the JAX harness's, and so must the report's counts
(preemptions, restores, faults, retries, sheds).

The port's harness model has head dim 32 where the JAX one has 16 (the
card's attention kernels take 32, 64 and 128), so the JAX harness runs
here with the port's model (its module config patched for the test).
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


def _jax_cfg():
    return dataclasses.replace(jchaos.CFG, head_dim=tchaos.CFG.head_dim)


@pytest.fixture(scope="module")
def params():
    mp = pytest.MonkeyPatch()
    mp.setattr(jchaos, "CFG", _jax_cfg())
    try:
        jparams = jchaos._params()
    finally:
        mp.undo()
    return jparams, params_from_numpy(jax_tree_to_numpy(jparams), "cpu")


def test_models_differ_only_in_head_dim():
    assert dataclasses.asdict(tchaos.CFG) == dataclasses.asdict(_jax_cfg())
    assert (jchaos.CFG.head_dim, tchaos.CFG.head_dim) == (16, 32)


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
    monkeypatch.setattr(jchaos, "CFG", _jax_cfg())
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
    assert set(tchaos.SCENARIOS) == set(jchaos.SCENARIOS) - \
        {"speculation_storm"}
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        tchaos.run(["speculation_storm"], smoke=True, device="cpu")


def test_main_runs_on_the_cpu_with_its_own_weights(capsys):
    assert tchaos.main(["--smoke", "--device", "cpu",
                        "--scenario", "dispatch_faults"]) == 0
    assert "chaos: 1/1 scenarios ok" in capsys.readouterr().out
