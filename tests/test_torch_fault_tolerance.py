"""The port's fault tolerance (``repro_torch.train.fault_tolerance``) and
training launcher (``repro_torch.launch.train``) on the CPU, on the JAX
tests' tiny dense model (2 layers, d64, f32).

- ``tests/test_fault_tolerance.py``'s cases on the port: a run that
  crashes at step 7 and resumes from its step-4 checkpoint ends with
  every parameter and moment bit-equal to the uninterrupted run's, two
  failures within the budget, a failure before the first checkpoint
  restarts from step 0, a budget exceeded raises, the straggler monitor,
  random access by step, and ``shardings=`` on a mesh of one.
- The launcher: the two launchers' parsers have the same flags (option
  strings, dest, action, type, default, choices, help);
  ``main(argv, device="cpu")`` prints the JAX launcher's lines (``arch=
  ... devices=1 mesh={'data': 1, 'model': 1}``, ``step N  loss X`` per
  logged step, ``done: restarts=0 stragglers=...``); a second run with
  ``--ckpt`` resumes from the first's last step and runs only the new
  steps; its checkpoint is one the serving launcher restores; a mesh of
  one in any form runs, a larger mesh is the JAX launcher's, and
  ``--distributed`` outside torchrun raises; without a card and without
  ``device="cpu"`` it fails.
"""

import contextlib
import io
import re
import tempfile

import numpy as np
import pytest
import torch

from repro.launch import train as JT
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import make_dataset
from repro_torch.dist.sharding import param_specs
from repro_torch.launch.mesh import single_device_mesh
from repro_torch.launch import serve as TS
from repro_torch.launch import train as TT
from repro_torch.models.model import get_model
from repro_torch.optim import adamw
from repro_torch.train import checkpoint as C
from repro_torch.train.fault_tolerance import (FailureInjector, StepMonitor,
                                               resilient_train)
from repro_torch.train.loop import make_train_step
from test_torch_launch import _flags, _parser_of
from test_torch_train import one_intra_op_thread  # noqa: F401 (autouse)

CFG = ModelConfig(name="t", family="dense", n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
                  head_dim=16, vocab_pad_multiple=64, dtype="float32")
TINY = ["n_layers=2", "d_model=64", "n_heads=4", "n_kv_heads=2", "d_ff=128",
        "head_dim=16", "vocab_size=256", "vocab_pad_multiple=64",
        "dtype=float32"]
SETS = [a for kv in TINY for a in ("--set", kv)]


@pytest.fixture(scope="module")
def setup():
    api = get_model(CFG)
    params = api.init(seed=0, device="cpu")
    ocfg = adamw.AdamWConfig(lr=1e-3)
    opt = adamw.init(params, ocfg)
    step_fn = make_train_step(api, ocfg, total_steps=100, warmup=5)

    def wrapped(p, o, batch, step):
        return step_fn(p, o, {k: torch.from_numpy(v)
                              for k, v in batch.items()}, step)

    ds = make_dataset(CFG, batch=8, seq=32, seed=0)
    return wrapped, params, opt, ds


def _train(setup, ckpt_dir, fail_at=(), total=12, save_every=4):
    wrapped, params, opt, ds = setup
    return resilient_train(
        train_step=wrapped, params=params, opt_state=opt, dataset=ds,
        ckpt_dir=ckpt_dir, total_steps=total, save_every=save_every,
        fail_hook=FailureInjector(fail_at=fail_at) if fail_at else None)


def test_bitwise_resume_after_crash(setup):
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        pA, oA, hA, rA = _train(setup, d1)
        pB, oB, hB, rB = _train(setup, d2, fail_at=[7])
        assert rA == 0 and rB == 1
        assert hA == hB
        for a, b in zip(adamw.tree_leaves((pA, oA)),
                        adamw.tree_leaves((pB, oB))):
            assert torch.equal(a, b)
        assert C.latest_step(d2) == 12


def test_multiple_failures_within_budget(setup):
    with tempfile.TemporaryDirectory() as d:
        _, _, _, restarts = _train(setup, d, fail_at=[5, 9], total=12)
        assert restarts == 2


def test_failure_before_first_checkpoint_restarts_from_scratch(setup):
    with tempfile.TemporaryDirectory() as d:
        _, opt, _, restarts = _train(setup, d, fail_at=[2], total=8,
                                     save_every=100)
        assert restarts == 1   # restarted from step 0, still completed
        # the steps before the failure and the 8 after it
        assert int(opt["count"]) == 2 + 8


def test_restart_budget_exceeded_raises(setup):
    wrapped, params, opt, ds = setup
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(RuntimeError):
            resilient_train(
                train_step=wrapped, params=params, opt_state=opt,
                dataset=ds, ckpt_dir=d, total_steps=10, save_every=100,
                max_restarts=1,
                fail_hook=FailureInjector(fail_at=[1, 2, 3]))


def test_shardings_raise(setup):
    """``shardings=`` restores onto a mesh (the mesh runs are
    ``tests/test_torch_dist_train.py``); on a mesh of one the specs cut
    nothing, and a run that crashes and resumes with them ends bit-equal
    to the plain run."""
    wrapped, params, opt, ds = setup
    mesh = single_device_mesh("cpu")
    specs = (param_specs(params, mesh),
             {"m": param_specs(params, mesh), "v": param_specs(params, mesh),
              "count": None})
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        pA, oA, hA, _ = _train(setup, d1, total=6)
        pB, oB, hB, rB = resilient_train(
            train_step=wrapped, params=params, opt_state=opt, dataset=ds,
            ckpt_dir=d2, total_steps=6, save_every=4, shardings=specs,
            fail_hook=FailureInjector(fail_at=[5]))
        assert rB == 1 and hA == hB
        for a, b in zip(adamw.tree_leaves((pA, oA)),
                        adamw.tree_leaves((pB, oB))):
            assert torch.equal(a, b)


def test_straggler_monitor():
    mon = StepMonitor(straggler_factor=3.0, warmup_steps=2)
    for s in range(6):
        assert not mon.observe(s, 0.1)
    assert mon.observe(6, 1.0)          # 10x EMA -> straggler
    assert len(mon.events) == 1
    assert not mon.observe(7, 0.1)


def test_data_pipeline_random_access():
    ds = make_dataset(CFG, batch=4, seq=16, seed=3)
    b1, b2 = ds.batch_at(10), ds.batch_at(10)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(b1["tokens"], ds.batch_at(11)["tokens"])


# -- the launcher -------------------------------------------------------------

def test_parsers_have_the_jax_flags():
    assert _flags(_parser_of(TT.main)) == _flags(_parser_of(JT.main))
    assert _flags(_parser_of(TT.main)) == _flags(_parser_of(TT.parse_args))


def _main(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        TT.main(argv, device="cpu")
    return buf.getvalue().splitlines()


def test_launcher_lines_resume_and_serve():
    with tempfile.TemporaryDirectory() as d:
        argv = ["--arch", "repro-100m", "--batch", "4", "--seq", "32",
                "--steps", "12", "--lr", "1e-3", "--save-every", "4",
                "--ckpt", d, *SETS]
        lines = _main(argv)
        assert lines[0] == "arch=repro-100m devices=1 mesh={'data': 1, " \
                           "'model': 1}"
        steps = [re.fullmatch(r"step +(\d+)  loss (\d+\.\d{4})", ln)
                 for ln in lines[1:-1]]
        assert [int(m.group(1)) for m in steps] == [10, 12]
        assert re.fullmatch(r"done: restarts=0 stragglers=\d+", lines[-1])
        assert C.latest_step(d) == 12
        # resume: 4 more steps from step 12's checkpoint
        again = _main(argv[:7] + ["16"] + argv[8:])
        assert [ln.split()[1] for ln in again[1:-1]] == ["16"]
        assert C.latest_step(d) == 16
        # the serving launcher restores what training wrote
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            TS.main(["--arch", "repro-100m", "--ckpt", d, "--requests", "2",
                     "--max-new", "4", "--slots", "2", "--max-len", "64",
                     *SETS], device="cpu")
        assert f"restored step 16 from {d}" in out.getvalue().splitlines()


@pytest.mark.parametrize("mesh,want", [
    ("auto", {"data": 1, "model": 1}), ("1x1", {"data": 1, "model": 1}),
    ("1x1x1", {"pod": 1, "data": 1, "model": 1})])
def test_mesh_of_one(mesh, want):
    assert TT.build_mesh(mesh) == want


@pytest.mark.parametrize("argv,want", [
    (["--mesh", "4x2"], {"data": 4, "model": 2}),
    (["--mesh", "2x1x1"], {"pod": 2, "data": 1, "model": 1}),
    (["--distributed"], None)],
    ids=["mesh-4x2", "mesh-2x1x1", "distributed"])
def test_launcher_refuses_more_than_one_card(argv, want, monkeypatch):
    """A mesh above one card is the JAX launcher's mesh over its ranks
    (the launcher would spawn them; the spawned runs are
    ``tests/test_torch_dist_train.py``); ``--distributed`` outside torchrun
    says where it must run."""
    args = TT.parse_args(argv + SETS)
    if want is not None:
        assert TT.configure(args)[1] == want
        return
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        TT.main(argv + SETS, device="cpu")


def test_launcher_needs_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="on the card"):
        TT.main(["--steps", "1"])
