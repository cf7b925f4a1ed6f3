"""Checkpoint restore onto shards and the serving launcher on a mesh, on the
CPU with ranks spawned over gloo (``launch.mesh.run_ranks``).

- ``train.checkpoint.restore(shardings=)`` on 2 ranks: a JAX-written
  checkpoint of the tiny model's raw and int8 weights, restored by each
  rank with ``dist.sharding.param_specs`` under ``SERVE_HEAD_RULES``,
  gives each rank exactly the block JAX's own placement gives device r of
  a (1, 2) mesh (``jax.device_put`` against the same specs), QTensors
  with their block's logical shape.
- ``python -m repro_torch.launch.serve --mesh-shape 2`` (``main(argv,
  device="cpu")``, which spawns its two ranks) from a JAX checkpoint
  prints the JAX launcher's restore line, the same first three requests'
  tokens and ``--stats`` JSON as the single-device JAX launcher, and its
  summary line with the ``, mesh 2`` tag, plain and with ``--paged
  --reuse --lora 2 --fuse-qkv``; the launcher's column-parallel leaves are
  restored onto the shards.
"""

import re

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding

from repro.configs import apply_overrides as j_apply
from repro.configs import get_config as j_get_config
from repro.core import quantization as JQ
from repro.dist import sharding as jshd
from repro.launch import serve as JS
from repro.launch.mesh import make_host_mesh
from repro.models.model import get_model as j_get_model
from repro.train import checkpoint as JC
from repro_torch.launch import serve as TS
from repro_torch.launch.mesh import run_ranks

import torch_tp_ranks as R
from test_torch_engine import jax_tree_to_numpy
from test_torch_launch import SETS, TINY, _run, jax_ckpt  # noqa: F401


def _jax_blocks(tree, mesh, path=""):
    """{path: [block of device r]} under JAX's own placement."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_jax_blocks(v, mesh, f"{path}/{k}"))
        return out
    specs = jshd.param_specs({path.rsplit("/", 1)[-1]: tree}, mesh,
                             jshd.SERVE_HEAD_RULES)
    spec = next(iter(specs.values()))
    leaves = {"": (tree, spec)} if not isinstance(tree, JQ.QTensor) else {
        "@codes": (tree.codes, spec.codes), "@scale": (tree.scale,
                                                       spec.scale)}
    for suffix, (arr, sharding) in leaves.items():
        placed = jax.device_put(arr, NamedSharding(mesh, sharding.spec))
        shards = sorted(placed.addressable_shards, key=lambda s: s.device.id)
        out[path + suffix] = [np.asarray(s.data, np.float32) for s in shards]
    return out


@pytest.fixture(scope="module")
def restored(tmp_path_factory, eight_cpu_devices):
    d = str(tmp_path_factory.mktemp("sharded_ckpt"))
    cfg = j_apply(j_get_config("repro-100m"),
                  dict(kv.split("=", 1) for kv in TINY))
    raw = j_get_model(cfg).init(jax.random.PRNGKey(3))
    tree = {"raw": raw, "q": JQ.quantize_tree(raw, JQ.QuantConfig(bits=8))}
    JC.save(d, 4, tree)
    ranks = run_ranks(R.run_jobs, 2, "cpu",
                      [("restore_blocks", (d, jax_tree_to_numpy(tree)))],
                      threads=1)
    return tree, [r[0] for r in ranks]


def test_restore_onto_two_ranks_gives_jax_blocks(restored):
    tree, ranks = restored
    want = _jax_blocks(tree, make_host_mesh(1, 2))
    cut = 0
    for rank, (step, blocks) in enumerate(ranks):
        assert step == 4
        for path, per_device in want.items():
            np.testing.assert_array_equal(
                blocks[path].astype(np.float32), per_device[rank], path)
            cut += per_device[0].shape != per_device[1].shape or \
                not np.array_equal(per_device[0], per_device[1])
        # a QTensor's logical shape is its block's: wq's heads are cut
        assert blocks["/q/layers/attn/wq@shape"] == (2, 64, 32)
        assert blocks["/q/layers/attn/wo@shape"] == (2, 32, 64)
    assert cut > 0


LAUNCH_MODES = {"default": [],
                "paged+reuse+lora": ["--paged", "--reuse", "--lora", "2",
                                     "--fuse-qkv"]}


@pytest.mark.parametrize("mode", sorted(LAUNCH_MODES))
def test_launcher_mesh2_matches_jax(jax_ckpt, mode):  # noqa: F811
    argv = ["--arch", "repro-100m", "--ckpt", jax_ckpt, "--requests", "6",
            "--max-new", "8", "--slots", "4", "--max-len", "64",
            "--prompt-lens", "5,9,17", "--stats"] + SETS + LAUNCH_MODES[mode]
    jlines, jstats = _run(JS.main, argv)
    tlines, tstats = _run(lambda a: TS.main(a, device="cpu"),
                          argv + ["--mesh-shape", "2"])
    assert tlines[0] == jlines[0] == f"restored step 5 from {jax_ckpt}"
    tokens = [ln for ln in tlines if ln.startswith("  -> ")]
    assert len(tokens) == 3
    assert tokens == [ln for ln in jlines if ln.startswith("  -> ")]
    jsum = next(ln for ln in jlines if ln.startswith("[axllm"))
    tsum = next(ln for ln in tlines if ln.startswith("[axllm"))
    assert tsum.endswith(", mesh 2")
    assert re.sub(r"[\d.]+ tok/s", "", tsum) == re.sub(
        r"[\d.]+ tok/s", "", jsum[:-len(" (host fallback path)")]
        + ", mesh 2")
    assert [ln for ln in tlines if ln.startswith(("  paged", "registered"))] \
        == [ln for ln in jlines if ln.startswith(("  paged", "registered"))]
    tstats.pop("prefill_wall_s")
    jstats.pop("prefill_wall_s")
    jstats.pop("prefill_compiles")
    assert tstats == jstats and tstats["finished"] == 6
