"""Distributed training of the recurrent families on the CPU: xlstm-1.3b
(ssm) and zamba2-1.2b (hybrid) in the sharded train step and the training
launcher's rank body, at ("data", "model") = (1, 2), with the ranks
spawned over gloo by ``launch.mesh.run_ranks`` (rank bodies:
``tests/torch_train_ranks.py``, no JAX) beside the JAX references
(``tests/torch_train_jax.py``) in the main thread.

The configs are each family's ``reduced(dtype="float32")``; the batches
are the pipeline's (seed 0, B8 S32), 3 steps at lr 1e-3. Every rank is
held to the single-device JAX step (``loss`` within rel 2e-4,
``grad_norm`` within rel 1e-4, ``lr_scale`` within one f32 ulp, at each
step) and the parameters and first moments its blocks gather to to the
port's single-device step (rtol 1e-3, atol 1e-5;
``torch_train_ranks.assert_params_close``). Each rank holds a strict block
of the leaf its family cuts: xLSTM's mLSTM ``up`` (flag "mlp"; the
recurrences and every leaf they read stay whole) and Mamba2's
``out_proj`` (flag "ssm_out"; ``in_proj`` stays whole, as no cut of it
falls on its segments' boundaries). The launcher's rank body
(``launch.train.train_ranks``, what ``--mesh 1x2`` runs on each rank)
prints the launcher's lines for both.
"""

import concurrent.futures
import dataclasses

import numpy as np
import pytest

from repro_torch.launch import mesh as TM

import torch_jax_cache  # noqa: F401 (the worker's compilation cache)
import torch_train_jax as J
import torch_train_ranks as R
from test_torch_model import jax_tree_to_numpy
from test_torch_train import one_intra_op_thread  # noqa: F401 (autouse)

FAMS = ("ssm", "hybrid")
ARCH = {f: R.FAMILIES[f][0] for f in FAMS}
STEPS = 3
WEIGHTS = {f: jax_tree_to_numpy(J.params(f)) for f in FAMS}


def _kw(family):
    return dataclasses.asdict(R.reduced(family))


def _spawn():
    jobs = [("steps", (_kw(f), WEIGHTS[f], STEPS, False, None,
                       R.FAMILIES[f][2])) for f in FAMS]
    jobs += [("launcher", (R.launch_argv(f),)) for f in FAMS]
    return TM.run_ranks(R.run_jobs, 2, "cpu", jobs, mesh_shape=(1, 2),
                        threads=1)


@pytest.fixture(scope="module")
def runs():
    """The spawn (a second thread) beside the JAX trajectories and the
    port's single-device runs."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(_spawn)
        jax_ref = {f: J.trajectory(f, STEPS) for f in FAMS}
        single = {f: R.port_single(_kw(f), WEIGHTS[f], STEPS) for f in FAMS}
        ranks = spawned.result()
    return ranks, jax_ref, single


def _steps_of(runs, family):
    return [r[FAMS.index(family)] for r in runs[0]]


@pytest.mark.parametrize("family", FAMS)
def test_sharded_step_matches_single_device_jax(runs, family):
    for rank in _steps_of(runs, family):
        R.assert_rank_agrees_with_jax(rank["metrics"], runs[1][family])


@pytest.mark.parametrize("family", FAMS)
def test_gathered_params_match_port_single_device(runs, family):
    whole, metrics, grads = runs[2][family]
    ranks = _steps_of(runs, family)
    R.assert_params_close(ranks[0]["whole"][0], whole[0], grads, metrics)
    R.assert_close(ranks[0]["whole"][1]["m"], whole[1]["m"], rtol=1e-3,
                   atol=1e-5)
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks)


@pytest.mark.parametrize("family", FAMS)
def test_each_rank_holds_a_strict_block_of_its_cut_leaf(runs, family):
    ranks = _steps_of(runs, family)
    whole = R.at(ranks[0]["whole"][0], R.FAMILIES[family][2]).shape
    for r in ranks:
        assert np.prod(r["gate"]) < np.prod(whole)
    assert len({r["gate"] for r in ranks}) == 1
    lay = ranks[0]["layout"]
    assert lay["vocab"] and not lay["experts"] and not lay["ssm_in"]
    if family == "ssm":     # no attention: only the mLSTM projections
        assert lay["mlp"] and not lay["heads"] and not lay["ssm_out"]
    else:                   # the shared block takes the dense layout
        assert lay["ssm_out"] and lay["heads"] and lay["kv_heads"]
        assert lay["mlp"]
    assert lay["batch_axes"] == ()


@pytest.mark.parametrize("family", FAMS)
def test_launcher_rank_body_trains_at_1x2(runs, family):
    body = [r[len(FAMS) + FAMS.index(family)] for r in runs[0]]
    out = body[0]["out"].splitlines()
    assert all(b["out"] == body[0]["out"] for b in body)
    assert out[0] == f"arch={ARCH[family]} devices=2 mesh={{'data': 1, " \
        "'model': 2}"
    assert [ln.split()[1] for ln in out[1:-1]] == ["4"]
    assert out[-1].startswith("done: restarts=0")
    for b in body:
        assert b["bytes"] == b["spec_bytes"]
        assert 0.4 < b["bytes"] / b["whole_bytes"] < 0.6
