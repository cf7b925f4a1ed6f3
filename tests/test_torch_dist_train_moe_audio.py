"""Distributed training of the moe and audio families on the CPU:
qwen2-moe-a2.7b expert-parallel and whisper-small in the sharded train
step, restore and restart on a mesh and the training launcher's
``--mesh``, with the ranks spawned over gloo by ``launch.mesh.run_ranks``:
one spawn of four ranks for the (2, 2) mesh, one of two for (1, 2) and
the launcher's own side by side, then two ranks restoring the (2, 2)
checkpoint (rank bodies: ``tests/torch_train_ranks.py``, no JAX), all
beside the JAX references (``tests/torch_train_jax.py``) in the main
thread.

The configs are each family's ``reduced(dtype="float32")``, the moe's
with ``grad_accum=2``; the batches are the pipeline's (seed 0, B8 S32,
with frames for whisper), 3 steps at lr 1e-3. JAX's sharded step fails
under the installed JAX (ROADMAP §3), and GSPMD keeps the arithmetic of
the single-device program, so every rank is held to:

- the single-device JAX step: ``loss`` within rel 2e-4, ``grad_norm``
  within rel 1e-4 and ``lr_scale`` within one f32 ulp at each step, both
  families at ("data", "model") = (1, 2) and (2, 2);
- the port's single-device step: the parameters and first moments the
  blocks gather to within rtol 1e-3, atol 1e-5
  (``torch_train_ranks.assert_params_close`` says where Adam's step is
  the sign of rounding noise), with f32 moments and, for the moe at
  (1, 2), int8 moments;
- each rank holds a strict block of the leaf its family cuts (the moe's
  ``expert_gate``, whisper's decoder ``wq``).

Then: at (2, 2) the moe keeps the (token, choice) pairs one device keeps
(capacity is per batch row; at qwen2-moe's own capacity factor 1.25,
where the reduced config's 8.0 drops none); a moe checkpoint saved at
(2, 2) restores at (1, 2) and on one device with every leaf bit-equal;
``resilient_train(shardings=)`` for the moe at (1, 2) with a failure at
step 2 ends bit-equal to the uninterrupted run; ``python -m
repro_torch.launch.train --arch whisper-small --mesh 1x2`` with the
reduced ``--set`` flags prints what its rank body prints, and the moe's
rank body prints the launcher's lines at (2, 2).
"""

import concurrent.futures
import contextlib
import dataclasses
import io

import numpy as np
import pytest

from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import ModelConfig
from repro_torch.data import pipeline as TD
from repro_torch.launch import mesh as TM
from repro_torch.launch import train as TT
from repro_torch.models.model import get_model
from repro_torch.optim import adamw
from repro_torch.train import checkpoint as C

import torch_jax_cache  # noqa: F401 (the worker's compilation cache)
import torch_train_jax as J
import torch_train_ranks as R
from test_torch_model import jax_tree_to_numpy
from test_torch_train import one_intra_op_thread  # noqa: F401 (autouse)

FAMS = ("moe", "audio")
STEPS = 3
CASES = [("moe", (1, 2)), ("moe", (2, 2)), ("audio", (1, 2)),
         ("audio", (2, 2))]
IDS = ["moe-1x2", "moe-2x2", "audio-1x2", "audio-2x2"]
# qwen2-moe-a2.7b's own capacity factor, which drops pairs at S32
MOE_CAPACITY = 1.25
WEIGHTS = {f: jax_tree_to_numpy(J.params(f)) for f in FAMS}


def _kw(family):
    return dataclasses.asdict(R.reduced(family))


def _spawns(tmp):
    """The module's spawns, side by side: four ranks for the (2, 2) mesh
    (its moe run saves the checkpoint that (1, 2) restores), two for
    (1, 2) and the launcher's own two; then two more restore the (2, 2)
    checkpoint."""
    d22 = str(tmp / "ckpt22")
    moe = (_kw("moe"), WEIGHTS["moe"])
    audio = (_kw("audio"), WEIGHTS["audio"])
    leaf = {f: R.FAMILIES[f][2] for f in FAMS}
    capped = (dict(_kw("moe"), capacity_factor=MOE_CAPACITY), WEIGHTS["moe"])
    four = [("steps", moe + (STEPS, False, d22, leaf["moe"])),
            ("steps", audio + (STEPS, False, None, leaf["audio"])),
            ("pairs", capped),
            ("launcher", (R.launch_argv("moe"),))]
    two = [("steps", moe + (STEPS, False, None, leaf["moe"])),
           ("steps", audio + (STEPS, False, None, leaf["audio"])),
           ("steps", moe + (STEPS, True, None, leaf["moe"])),
           ("resilient", moe + ((str(tmp / "a"), str(tmp / "b")), 2)),
           ("launcher", (R.launch_argv("audio"),))]
    out = {}
    # the launcher's spawn beside the module's (nothing else prints)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        launched = pool.submit(_launch_1x2)
        r4 = pool.submit(TM.run_ranks, R.run_jobs, 4, "cpu", four,
                         mesh_shape=(2, 2), threads=1)
        out["1x2"] = TM.run_ranks(R.run_jobs, 2, "cpu", two,
                                  mesh_shape=(1, 2), threads=1)
        out["2x2"] = r4.result()
        out["restore"] = TM.run_ranks(R.run_jobs, 2, "cpu",
                                      [("restore", moe + (d22,))],
                                      mesh_shape=(1, 2), threads=1)
        out["main"], out["main_out"] = launched.result()
    return out, d22


def _launch_1x2():
    """``launch.train.main --arch whisper-small --mesh 1x2``: (each rank's
    result, stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ranks = TT.main(R.launch_argv("audio") + ["--mesh", "1x2"],
                        device="cpu")
    return ranks, buf.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The spawns (a second thread) beside the JAX trajectories and the
    port's single-device runs."""
    tmp = tmp_path_factory.mktemp("dist_train_moe_audio")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(_spawns, tmp)
        jax_ref = {f: J.trajectory(f, STEPS) for f in FAMS}
        single = {f: R.port_single(_kw(f), WEIGHTS[f], STEPS) for f in FAMS}
        single["int8"] = R.port_single(_kw("moe"), WEIGHTS["moe"], STEPS,
                                       int8=True)
        ranks, d22 = spawned.result()
    return ranks, jax_ref, single, d22


def _steps_of(runs, family, shape, int8=False):
    """Every rank's ``steps`` result of a case."""
    if shape == (2, 2):
        i = FAMS.index(family)
    else:
        i = {("moe", False): 0, ("audio", False): 1, ("moe", True): 2}[
            family, int8]
    return [r[i] for r in runs[0]["x".join(map(str, shape))]]


@pytest.mark.parametrize("family,shape", CASES, ids=IDS)
def test_sharded_step_matches_single_device_jax(runs, family, shape):
    for rank in _steps_of(runs, family, shape):
        R.assert_rank_agrees_with_jax(rank["metrics"], runs[1][family])


@pytest.mark.parametrize("family,shape", CASES, ids=IDS)
def test_gathered_params_match_port_single_device(runs, family, shape):
    whole, metrics, grads = runs[2][family]
    ranks = _steps_of(runs, family, shape)
    R.assert_params_close(ranks[0]["whole"][0], whole[0], grads, metrics)
    # the first moments (linear in the gradients), and the metrics agree
    # on every rank
    R.assert_close(ranks[0]["whole"][1]["m"], whole[1]["m"], rtol=1e-3,
                   atol=1e-5)
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks)


@pytest.mark.parametrize("family,shape", CASES, ids=IDS)
def test_each_rank_holds_a_strict_block_of_its_cut_leaf(runs, family,
                                                        shape):
    ranks = _steps_of(runs, family, shape)
    whole = R.at(ranks[0]["whole"][0], R.FAMILIES[family][2]).shape
    for r in ranks:
        assert np.prod(r["gate"]) < np.prod(whole)
    assert len({r["gate"] for r in ranks}) == 1
    lay = ranks[0]["layout"]
    assert lay["heads"] and lay["kv_heads"] and lay["vocab"] and lay["mlp"]
    assert lay["experts"] == (family == "moe")
    assert not lay["ssm_in"] and not lay["ssm_out"]
    assert lay["batch_axes"] == (("data",) if shape[0] > 1 else ())


def test_int8_moments_at_1x2_match_single_device(runs):
    whole, metrics, grads = runs[2]["int8"]
    ranks = _steps_of(runs, "moe", (1, 2), int8=True)
    for r in ranks:
        for w, g in zip(metrics, r["metrics"]):
            assert g["loss"] == pytest.approx(w["loss"], rel=2e-4)
            assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=1e-4)
    R.assert_params_close(ranks[0]["whole"][0], whole[0], grads, metrics,
                          int8=True)
    # the int8 moments: the codes and block scales of the whole leaves'
    # (the expert stacks' last dim is never cut)
    gate = ranks[0]["whole"][1]["m"]["layers"]["ffn"]["expert_gate"]
    assert isinstance(gate, tuple) and gate[0].dtype == np.int8
    for k in ("m", "v"):
        R.assert_q8_close(ranks[0]["whole"][1][k], whole[1][k], STEPS)


def test_moe_capacity_at_2x2_keeps_the_single_device_pairs(runs):
    ranks = [r[2] for r in runs[0]["2x2"]]
    cfg = ModelConfig(**dict(_kw("moe"), capacity_factor=MOE_CAPACITY))
    batch = TD.make_dataset(cfg, R.BATCH, R.SEQ, seed=0).batch_at(0)
    want = R.kept_pairs(get_model(cfg), params_from_numpy(WEIGHTS["moe"],
                                                          "cpu"),
                        TD.shard_batch(batch, device="cpu"))
    assert len(want) == cfg.n_layers
    assert not all(w.all() for w in want)       # the capacity drops pairs
    by = {(r["coords"]["data"], r["coords"]["model"]): r["pairs"]
          for r in ranks}
    for layer, w in enumerate(want):
        for m in (0, 1):
            got = np.concatenate([by[d, m][layer] for d in (0, 1)])
            np.testing.assert_array_equal(got, w)


def test_checkpoint_saved_at_2x2_restores_at_1x2_and_one_device(runs):
    ranks, _, _, d22 = runs
    saved = ranks["2x2"][0][0]["whole"]
    cfg = ModelConfig(**_kw("moe"))
    like = get_model(cfg).init(seed=1, device="cpu")
    one, step = C.restore(d22, (like, adamw.init(like, adamw.AdamWConfig())))
    assert step == STEPS
    R.assert_equal_trees(R.np_tree(one), saved)
    got = ranks["restore"][0][0]
    assert got["step"] == STEPS
    R.assert_equal_trees(got["whole"], saved)


def test_resilient_train_on_mesh_resumes_bit_equal(runs):
    for rank in runs[0]["1x2"]:
        clean, failed = rank[3]
        assert clean["restarts"] == 0 and failed["restarts"] == 1
        assert clean["history"] == failed["history"]
        assert len(clean["history"]) == 4
    clean, failed = runs[0]["1x2"][0][3]
    R.assert_equal_trees(clean["whole"], failed["whole"])


def test_launcher_mesh_1x2_prints_its_rank_body_lines(runs):
    ranks = runs[0]
    body = [r[4] for r in ranks["1x2"]]
    out = ranks["main_out"].splitlines()
    assert out == body[0]["out"].splitlines()
    assert all(b["out"] == body[0]["out"] for b in body)
    assert all(m["out"] == body[0]["out"] for m in ranks["main"])
    assert out[0] == "arch=whisper-small devices=2 mesh={'data': 1, " \
        "'model': 2}"
    assert [ln.split()[1] for ln in out[1:-1]] == ["4"]
    assert out[-1].startswith("done: restarts=0")
    # a rank holds the blocks its specs give it, about half of the whole
    for b in body:
        assert b["bytes"] == b["spec_bytes"]
        assert 0.45 < b["bytes"] / b["whole_bytes"] < 0.55
    # the one-card launcher's loss line, within the mesh's tolerance
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        TT.main(R.launch_argv("audio"), device="cpu")
    one = buf.getvalue().splitlines()
    assert float(one[1].split()[-1]) == pytest.approx(
        float(out[1].split()[-1]), abs=2e-4)


def test_launcher_rank_body_trains_the_moe_at_2x2(runs):
    body = [r[3] for r in runs[0]["2x2"]]
    out = body[0]["out"].splitlines()
    assert all(b["out"] == body[0]["out"] for b in body)
    assert out[0] == "arch=qwen2-moe-a2.7b devices=4 mesh={'data': 2, " \
        "'model': 2}"
    assert out[-1].startswith("done: restarts=0")
    for b in body:
        assert b["bytes"] == b["spec_bytes"]
        assert 0.2 < b["bytes"] / b["whole_bytes"] < 0.3
