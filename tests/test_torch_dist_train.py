"""Distributed training on the CPU: the sharded train step, restore and
restart on a mesh and the training launcher's ``--mesh``, with the ranks
spawned over gloo by ``launch.mesh.run_ranks``: one spawn of four ranks
for the (2, 2) and (2, 1, 2) meshes, then one of two for (1, 2) and
(2, 1) beside the launcher's own (rank bodies: ``tests/torch_train_ranks.py``,
no JAX), all beside the JAX references in the main thread.

The config is JAX's ``test_sharded_train_step_runs``: 2 layers, d64, 4/2
heads of 16, d_ff 128, vocab 256, float32, ``grad_accum=2``; the batches
are the pipeline's (seed 0, B8 S32), 3 steps at lr 1e-3. JAX's sharded
step fails under the installed JAX (ROADMAP §3), and GSPMD keeps the
arithmetic of the single-device program, so every rank is held to:

- the single-device JAX step: ``loss`` within rel 2e-4, ``grad_norm``
  within rel 1e-4 and ``lr_scale`` within one f32 ulp at each step (the
  tolerances of ``test_torch_train.test_trajectory_matches_jax``), dense
  at ("data", "model") = (1, 2), (2, 1), (2, 2) and ("pod", "data",
  "model") = (2, 1, 2), vlm (qk-norm) at (1, 2);
- the port's single-device step: the parameters the blocks gather to
  within rtol 1e-3, atol 1e-5 (``test_grad_accum_matches_full_batch``'s),
  with f32 moments and, at (1, 2), int8 moments (their leaves cut on the
  last dim are kept whole over "model", ``dist.sharding.moment_spec``);
- each rank holds a strict block of ``layers.ffn.gate``.

Then: a checkpoint saved at (2, 2) restores at (1, 2) and on one device
with every leaf bit-equal; ``resilient_train(shardings=)`` with a failure
at step 2 on every rank ends bit-equal to the uninterrupted mesh run;
``python -m repro_torch.launch.train --mesh 2x2`` prints what its rank
body prints in the module's 2x2 spawn, every rank the same lines;
``jit_train_step`` cuts whole inputs to the same step; ``param_specs``
under ``DEFAULT_RULES`` resolves every leaf as JAX's on meshes with a
"data" axis; ``shard_batch`` and ``batch_specs`` cut as JAX's; the moe,
ssm, hybrid and audio families' steps build on a mesh with the layout
their forwards take (their training on a mesh is held to JAX in
``tests/test_torch_dist_train_moe_audio.py`` and
``tests/test_torch_dist_train_recurrent.py``).
"""

import concurrent.futures
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs.base import ModelConfig as JConfig
from repro.data import pipeline as JD
from repro.dist import sharding as jshd
from repro.models.model import get_model as j_get_model
from repro.optim import adamw as JA
from repro.train.loop import make_train_step as j_make_train_step
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data import pipeline as TD
from repro_torch.dist import sharding as shd
from repro_torch.launch import mesh as TM
from repro_torch.launch import train as TT
from repro_torch.models.model import get_model
from repro_torch.optim import adamw
from repro_torch.train import checkpoint as C
from repro_torch.train.loop import make_train_step

import torch_jax_cache  # noqa: F401 (the worker's compilation cache)
import torch_train_ranks as R
from test_torch_model import jax_tree_to_numpy
from test_torch_sharding import _assert_equal
from test_torch_train import one_intra_op_thread  # noqa: F401 (autouse)

DENSE = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
             vocab_pad_multiple=64, dtype="float32", grad_accum=2)
VLM = dict(DENSE, family="vlm", qk_norm=True)
CFGS = {"dense": DENSE, "vlm": VLM}
STEPS = 3
SETS = [a for kv in ("n_layers=2", "d_model=64", "n_heads=4", "n_kv_heads=2",
                     "d_ff=128", "head_dim=16", "vocab_size=256",
                     "vocab_pad_multiple=64", "dtype=float32")
        for a in ("--set", kv)]
LAUNCH = ["--arch", "repro-100m", "--batch", "8", "--seq", "32", "--steps",
          "4", "--lr", "1e-3", "--save-every", "100", *SETS]
# (family, mesh shape) of every sharded-step case
CASES = [("dense", (1, 2)), ("dense", (2, 1)), ("dense", (2, 2)),
         ("dense", {"pod": 2, "data": 1, "model": 2}), ("vlm", (1, 2))]
IDS = ["dense-1x2", "dense-2x1", "dense-2x2", "dense-2x1x2", "vlm-1x2"]


def _jparams(family):
    return j_get_model(JConfig(**CFGS[family])).init(jax.random.PRNGKey(0))


WEIGHTS = {f: jax_tree_to_numpy(_jparams(f)) for f in CFGS}


def _key(shape):
    return "x".join(str(n) for n in (shape.values() if isinstance(shape, dict)
                                     else shape))


def _spawns(tmp):
    """The module's spawns: four ranks for the (2, 2) and (2, 1, 2) meshes
    (the former saves the checkpoint that (1, 2) restores), then two for
    (1, 2) and (2, 1) beside the launcher's own."""
    d22 = str(tmp / "ckpt22")
    dense, vlm = (CFGS["dense"], WEIGHTS["dense"]), (CFGS["vlm"],
                                                     WEIGHTS["vlm"])
    four = [("steps", dense + (STEPS, False, d22), {"data": 2, "model": 2}),
            ("resilient", dense + ((str(tmp / "a"), str(tmp / "b")), 2),
             {"data": 2, "model": 2}),
            ("launcher", (LAUNCH,), {"data": 2, "model": 2}),
            ("steps", dense + (STEPS,), {"pod": 2, "data": 1, "model": 2})]
    two = [("steps", dense + (STEPS,)), ("steps", vlm + (STEPS,)),
           ("steps", dense + (STEPS, True)), ("restore", dense + (d22,)),
           ("jit", dense), ("steps", dense + (STEPS,), {"data": 2,
                                                        "model": 1})]
    out = {}
    r4 = TM.run_ranks(R.run_jobs, 4, "cpu", four, threads=1)
    out["2x2"] = [r[:3] for r in r4]
    out["2x1x2"] = [r[3:] for r in r4]
    # the launcher's spawn beside the two ranks (nothing else prints)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        launched = pool.submit(_launch_2x2)
        r2 = TM.run_ranks(R.run_jobs, 2, "cpu", two, mesh_shape=(1, 2),
                          threads=1)
        out["main"], out["main_out"] = launched.result()
    out["1x2"] = [r[:5] for r in r2]
    out["2x1"] = [r[5:] for r in r2]
    return out, d22


def _launch_2x2():
    """``launch.train.main --mesh 2x2``: (each rank's result, stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ranks = TT.main(LAUNCH + ["--mesh", "2x2"], device="cpu")
    return ranks, buf.getvalue()


def _jax_trajectory(family):
    jcfg = JConfig(**CFGS[family])
    fn = jax.jit(j_make_train_step(j_get_model(jcfg), JA.AdamWConfig(lr=1e-3),
                                   total_steps=100, warmup=5))
    ds = JD.make_dataset(jcfg, batch=R.BATCH, seq=R.SEQ, seed=0)
    p = _jparams(family)
    o = JA.init(p, JA.AdamWConfig(lr=1e-3))
    out = []
    for s in range(STEPS):
        p, o, m = fn(p, o, jax.tree_util.tree_map(jnp.asarray,
                                                  ds.batch_at(s)), s)
        out.append({k: float(v) for k, v in m.items()})
    return out


def _port_single(family, int8=False):
    cfg = ModelConfig(**CFGS[family])
    ocfg = adamw.AdamWConfig(lr=1e-3, int8_moments=int8)
    params = params_from_numpy(WEIGHTS[family], "cpu")
    opt = adamw.init(params, ocfg)
    fn = make_train_step(get_model(cfg), ocfg, total_steps=100, warmup=5)
    ds = TD.make_dataset(cfg, batch=R.BATCH, seq=R.SEQ, seed=0)
    metrics = []
    for s in range(STEPS):
        params, opt, m = fn(params, opt, TD.shard_batch(ds.batch_at(s),
                                                        device="cpu"), s)
        metrics.append({k: float(v) for k, v in m.items()})
    return R.np_tree((params, opt)), metrics


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The spawns (a second thread) beside the JAX trajectories and the
    port's single-device runs."""
    tmp = tmp_path_factory.mktemp("dist_train")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(_spawns, tmp)
        jax_ref = {f: _jax_trajectory(f) for f in CFGS}
        single = {"dense": _port_single("dense"), "vlm": _port_single("vlm"),
                  "int8": _port_single("dense", int8=True)}
        ranks, d22 = spawned.result()
    return ranks, jax_ref, single, d22


def _steps_of(runs, family, shape, int8=False):
    """Every rank's ``steps`` result of a case."""
    ranks = runs[0][_key(shape)]
    if _key(shape) == "1x2":
        i = {("dense", False): 0, ("vlm", False): 1, ("dense", True): 2}[
            family, int8]
    else:
        i = 0
    return [r[i] for r in ranks]


def _assert_close_trees(a, b, **tol):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_close_trees(a[k], b[k], **tol)
    elif isinstance(a, tuple):
        for x, y in zip(a, b):
            _assert_close_trees(x, y, **tol)
    else:
        np.testing.assert_allclose(a, b, **tol)


def _assert_equal_trees(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_equal_trees(a[k], b[k])
    elif isinstance(a, tuple):
        for x, y in zip(a, b):
            _assert_equal_trees(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("family,shape", CASES, ids=IDS)
def test_sharded_step_matches_single_device_jax(runs, family, shape):
    want = runs[1][family]
    for rank in _steps_of(runs, family, shape):
        for w, g in zip(want, rank["metrics"]):
            assert g["loss"] == pytest.approx(w["loss"], rel=2e-4)
            assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=1e-4)
            assert abs(g["lr_scale"] - w["lr_scale"]) <= \
                float(np.spacing(np.float32(w["lr_scale"])))


@pytest.mark.parametrize("family,shape", CASES, ids=IDS)
def test_gathered_params_match_port_single_device(runs, family, shape):
    whole, _ = runs[2][family]
    ranks = _steps_of(runs, family, shape)
    _assert_close_trees(ranks[0]["whole"][0], whole[0], rtol=1e-3, atol=1e-5)
    # the moments too, and the metrics agree on every rank
    _assert_close_trees(ranks[0]["whole"][1]["m"], whole[1]["m"], rtol=1e-3,
                        atol=1e-5)
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks)


@pytest.mark.parametrize("family,shape", CASES, ids=IDS)
def test_each_rank_holds_a_strict_block_of_gate(runs, family, shape):
    ranks = _steps_of(runs, family, shape)
    whole = ranks[0]["whole"][0]["layers"]["ffn"]["gate"].shape
    for r in ranks:
        assert np.prod(r["gate"]) < np.prod(whole)
    assert len({r["gate"] for r in ranks}) == 1
    lay = ranks[0]["layout"]
    model = shape.get("model", 1) if isinstance(shape, dict) else shape[1]
    assert lay["mlp"] == lay["heads"] == lay["vocab"] == (model > 1)
    assert lay["kv_heads"] == (model > 1)
    data = (shape["pod"], shape["data"]) if isinstance(shape, dict) \
        else (1, shape[0])
    assert lay["batch_axes"] == tuple(a for a, n in zip(("pod", "data"), data)
                                      if n > 1)


def test_int8_moments_at_1x2_match_single_device(runs):
    whole, metrics = runs[2]["int8"]
    ranks = _steps_of(runs, "dense", (1, 2), int8=True)
    for r in ranks:
        for w, g in zip(metrics, r["metrics"]):
            assert g["loss"] == pytest.approx(w["loss"], rel=2e-4)
            assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=1e-4)
    _assert_close_trees(ranks[0]["whole"][0], whole[0], rtol=1e-3, atol=1e-5)
    # the int8 moments' codes and block scales are the whole leaves'
    gate = ranks[0]["whole"][1]["m"]["layers"]["ffn"]["gate"]
    assert isinstance(gate, tuple) and gate[0].dtype == np.int8
    np.testing.assert_allclose(gate[1], whole[1]["m"]["layers"]["ffn"]["gate"]
                               [1], rtol=1e-3, atol=1e-7)


def test_checkpoint_saved_at_2x2_restores_at_1x2_and_one_device(runs):
    ranks, _, _, d22 = runs
    saved = ranks["2x2"][0][0]["whole"]
    cfg = ModelConfig(**DENSE)
    like = get_model(cfg).init(seed=1, device="cpu")
    one, step = C.restore(d22, (like, adamw.init(like, adamw.AdamWConfig())))
    assert step == STEPS
    _assert_equal_trees(R.np_tree(one), saved)
    got = ranks["1x2"][0][3]
    assert got["step"] == STEPS
    _assert_equal_trees(got["whole"], saved)


def test_resilient_train_on_mesh_resumes_bit_equal(runs):
    for rank in runs[0]["2x2"]:
        clean, failed = rank[1]
        assert clean["restarts"] == 0 and failed["restarts"] == 1
        assert clean["history"] == failed["history"]
        assert len(clean["history"]) == 4
    clean, failed = runs[0]["2x2"][0][1]
    _assert_equal_trees(clean["whole"], failed["whole"])


def test_launcher_mesh_2x2_prints_its_rank_body_lines(runs):
    ranks = runs[0]
    body = [r[2] for r in ranks["2x2"]]
    out = ranks["main_out"].splitlines()
    assert out == body[0]["out"].splitlines()
    assert all(b["out"] == body[0]["out"] for b in body)
    assert all(m["out"] == body[0]["out"] for m in ranks["main"])
    assert out[0] == "arch=repro-100m devices=4 mesh={'data': 2, 'model': 2}"
    assert [ln.split()[1] for ln in out[1:-1]] == ["4"]
    assert out[-1].startswith("done: restarts=0")
    # a rank holds about a quarter of the parameters and moments
    for b in body:
        assert 0.2 < b["bytes"] / b["whole_bytes"] < 0.3
    # the one-card launcher's loss line, within the mesh's tolerance
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        TT.main(LAUNCH, device="cpu")
    one = buf.getvalue().splitlines()
    assert float(one[1].split()[-1]) == pytest.approx(
        float(out[1].split()[-1]), abs=2e-4)


def test_jit_train_step_cuts_whole_inputs(runs):
    for r in runs[0]["1x2"]:
        got = r[4]
        assert got["same_metrics"] and got["blocks"]


@pytest.mark.parametrize("shape", [(2, 2), (4, 2), (8, 1), (2, 1, 2),
                                   (2, 4, 1)], ids=str)
@pytest.mark.parametrize("arch", ["dense", "vlm", "repro-100m"])
def test_default_rules_param_specs_match_jax(arch, shape):
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    jcfg = JConfig(**CFGS[arch]) if arch in CFGS else \
        __import__("repro.configs", fromlist=["x"]).get_config(arch)
    cfg = ModelConfig(**CFGS[arch]) if arch in CFGS else get_config(arch)
    jtree = jax.eval_shape(j_get_model(jcfg).init, jax.random.PRNGKey(0))
    ttree = get_model(cfg).init(seed=0, device="meta")
    _assert_equal(jshd.param_specs(jtree, AbstractMesh(shape, axes),
                                   jshd.DEFAULT_RULES),
                  shd.param_specs(ttree, TM.Mesh(axes=dict(zip(axes, shape)),
                                                 device="cpu"),
                                  shd.DEFAULT_RULES))


def test_shard_batch_and_batch_specs_cut_as_jax():
    mesh = TM.Mesh(axes={"pod": 2, "data": 2, "model": 2}, rank=5,
                   device="cpu")
    batch = TD.make_dataset(ModelConfig(**DENSE), 8, 16).batch_at(0)
    rows = TD.shard_batch(batch, mesh)
    # rank 5 is (pod 1, data 0, model 1): rows block 2 of 4
    for k in batch:
        np.testing.assert_array_equal(rows[k].numpy(), batch[k][4:6])
    with pytest.raises(ValueError, match="do not split"):
        TD.shard_batch({k: v[:6] for k, v in batch.items()}, mesh)
    jmesh = AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    audio = dataclasses.replace(ModelConfig(**DENSE), is_encoder_decoder=True,
                                enc_seq=6, d_feat=3)
    jaudio = dataclasses.replace(JConfig(**DENSE), is_encoder_decoder=True,
                                 enc_seq=6, d_feat=3)
    for cfg, jcfg, b in ((ModelConfig(**DENSE), JConfig(**DENSE), 8),
                         (audio, jaudio, 8), (ModelConfig(**DENSE),
                                              JConfig(**DENSE), 6)):
        with jshd.activate(jmesh):
            want = JD.batch_specs(jcfg, b, 16, jmesh, train=False)
        got = TD.batch_specs(cfg, b, 16, mesh, train=False)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].shape == want[k].shape
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
            assert got[k].sharding.spec == tuple(want[k].sharding.spec)
            assert got[k].meta.is_meta


# the layout flags the step of each family takes at full width on (1, 2)
FAMILY_FLAGS = {"qwen2-moe-a2.7b": ("experts", "heads"),
                "xlstm-1.3b": ("mlp",),
                "zamba2-1.2b": ("ssm_out",),
                "whisper-small": ("heads", "kv_heads", "mlp", "vocab")}


@pytest.mark.parametrize("arch", list(FAMILY_FLAGS))
def test_families_off_the_mesh_raise_item_12e(arch):
    """The families that once raised here (ROADMAP item 12e) now train on
    a mesh: the step of each at full width builds on a (1, 2) CPU mesh
    from ``param_specs`` of its meta tree, and ``train_layout`` cuts the
    groups its forward takes as blocks (zamba2's ``in_proj`` stays whole:
    no cut of it falls on its segments' boundaries)."""
    cfg = get_config(arch)
    api = get_model(cfg)
    mesh = TM.Mesh(axes={"data": 1, "model": 2}, device="cpu")
    specs = shd.param_specs(api.init(seed=0, device="meta"), mesh,
                            shd.DEFAULT_RULES)
    lay = make_train_step(api, adamw.AdamWConfig(), grad_specs=specs).layout
    assert lay.train and lay.batch_axes == ()
    for flag in FAMILY_FLAGS[arch]:
        assert getattr(lay, flag), flag
    assert not lay.ssm_in and not lay.seq
    assert lay.experts == (cfg.family == "moe")
    assert lay.ssm_out == (cfg.family == "hybrid")


def test_specs_the_step_cannot_honour_raise():
    cfg = ModelConfig(**DENSE)
    api = get_model(cfg)
    mesh = TM.Mesh(axes={"data": 1, "model": 2}, device="cpu")
    specs = shd.param_specs(api.init(seed=0, device="meta"), mesh)
    bad = dict(specs, final_norm={"scale": shd.NamedSharding(
        TM.Mesh(axes={"data": 1, "model": 2}, device="cpu"), ("model",))})
    with pytest.raises(ValueError, match="one mesh"):
        make_train_step(api, adamw.AdamWConfig(), grad_specs=bad)
    specs["final_norm"]["scale"] = shd.NamedSharding(mesh, ("stage",))
    with pytest.raises(ValueError, match="stage"):
        make_train_step(api, adamw.AdamWConfig(), grad_specs=specs)
    specs["final_norm"]["scale"] = shd.NamedSharding(mesh, (("data",
                                                             "model"),))
    with pytest.raises(ValueError, match="several axes"):
        make_train_step(api, adamw.AdamWConfig(), grad_specs=specs)


def test_local_shard_cuts_a_q8_moment_as_the_whole_leaf():
    mesh = TM.Mesh(axes={"data": 2, "model": 2}, rank=3, device="cpu")
    x = torch.randn(4, 1024)
    q = adamw._q8(x)
    spec = shd.moment_spec(shd.NamedSharding(mesh, ("data", "model")),
                           x.shape, True)
    assert spec.spec == ("data", "model")       # 512 columns: whole blocks
    got = shd.local_shard(q, spec, mesh, 3)
    assert torch.equal(got.codes, q.codes[2:, 512:])
    assert torch.equal(got.scale, q.scale[2:, 2:]) and got.pad == 0
    small = shd.moment_spec(shd.NamedSharding(mesh, (None, "model")),
                            (4, 384), True)
    assert small.spec == (None, None)            # 192 columns: kept whole
