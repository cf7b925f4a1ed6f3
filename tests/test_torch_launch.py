"""Port parity for the serving launcher and its checkpoint restore
(``repro_torch.launch.serve``, ``launch.mesh``, ``train.checkpoint``,
``optim.adamw``) against the JAX package on the CPU.

- The two launchers' parsers have the same flags: option strings, dest,
  action, type, default, choices and help, read from both parsers.
- ``parse_mesh_shape``'s doctests pass and it parses (and refuses) as the
  JAX function does; ``--mesh-shape 2x2`` serves a moe arch from a
  checkpoint restored onto the ranks' blocks and prints what its
  in-process run prints; an encoder-decoder arch
  raises the JAX engine's text; without a card and without
  ``device="cpu"`` the launcher fails.
- ``adamw.init`` builds the JAX moments' leaves (names, shapes, dtypes),
  f32 and blockwise int8.
- Checkpoints: the same tree (bf16 and f32 leaves, an int32 scalar,
  QTensors affine and NF4-packed and one carrying a codebook, Q8 moments)
  saved by both packages gives the same files byte for byte; JAX ``save``
  -> port ``restore`` and port ``save`` -> JAX ``restore`` give every leaf
  back bit-equal in its saved dtype; ``latest``, ``keep`` and the async
  saver behave alike.
- From one JAX-written checkpoint of a tiny float32 repro-100m, the JAX
  launcher and ``main(argv, device="cpu")`` print the same restore line,
  the same first three requests' tokens and the same ``--stats`` JSON
  (apart from the timing field ``prefill_wall_s`` and the JAX engine's
  compile count ``prefill_compiles``, which the port has no counterpart
  for), in the default, ``--reuse``, ``--paged`` and ``--lora 2`` modes.
"""

import argparse
import contextlib
import doctest
import io
import json
import os
import re

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import apply_overrides as j_apply
from repro.configs import get_config as j_get_config
from repro.core import quantization as JQ
from repro.launch import mesh as JM
from repro.launch import serve as JS
from repro.models.model import get_model as j_get_model
from repro.optim import adamw as JA
from repro.train import checkpoint as JC
from repro_torch.core import quantization as TQ
from repro_torch.launch import mesh as TM
from repro_torch.launch import serve as TS
from repro_torch.models.model import get_model
from repro_torch.optim import adamw as TA
from repro_torch.train import checkpoint as TC

TINY = ["n_layers=2", "d_model=64", "n_heads=4", "n_kv_heads=2", "d_ff=128",
        "head_dim=16", "vocab_size=256", "vocab_pad_multiple=64",
        "dtype=float32"]
SETS = [a for kv in TINY for a in ("--set", kv)]


class _Parsed(Exception):
    def __init__(self, parser):
        self.parser = parser


def _parser_of(main):
    """The ArgumentParser a launcher's ``main`` builds, caught at its
    ``parse_args``."""
    orig = argparse.ArgumentParser.parse_args

    def catch(self, *a, **k):
        raise _Parsed(self)

    argparse.ArgumentParser.parse_args = catch
    try:
        main([])
    except _Parsed as got:
        return got.parser
    finally:
        argparse.ArgumentParser.parse_args = orig
    raise AssertionError("main() did not parse its arguments")


def _flags(parser):
    return {a.dest: (tuple(a.option_strings), type(a).__name__, a.type,
                     a.default, a.choices, a.help, a.nargs, a.const)
            for a in parser._actions}


def test_flags_match_jax():
    jax_flags = _flags(_parser_of(JS.main))
    port_flags = _flags(TS.build_parser())
    assert port_flags == jax_flags
    assert _flags(_parser_of(TS.main)) == jax_flags
    assert "ckpt" in port_flags and "speculate" in port_flags


def test_parse_mesh_shape_doctests_and_refusals():
    result = doctest.testmod(TM)
    assert result.attempted >= 2 and result.failed == 0
    for spec in ("1", "8", "2x4", "2,4", "1X1"):
        assert TM.parse_mesh_shape(spec) == JM.parse_mesh_shape(spec)
    for bad in ("", "0", "2x0", "1x2x3", "x"):
        with pytest.raises(ValueError):
            JM.parse_mesh_shape(bad)
        with pytest.raises(ValueError):
            TM.parse_mesh_shape(bad)


def test_mesh_shape_above_one_raises(tmp_path):
    """Outside the ranks' process group a mesh above 1 cannot be made; the
    launcher spawns its ranks itself: ``--mesh-shape 2x2`` serves a moe
    arch (its 16 padded experts cut 8 a rank: rank 1's hold only padding,
    so it runs no routed expert) from a checkpoint restored onto each
    rank's blocks, and prints what its in-process run prints, every rank
    with the same tokens."""
    with pytest.raises(RuntimeError, match="run_ranks or torchrun"):
        TM.make_serve_mesh("2")
    assert TM.make_serve_mesh("1").shape == {"data": 1, "model": 1}
    moe = ["--arch", "qwen2-moe-a2.7b", "--set", "n_layers=1", "--set",
           "d_model=64", "--set", "n_heads=4", "--set", "n_kv_heads=4",
           "--set", "head_dim=16", "--set", "d_ff=32", "--set",
           "vocab_size=256", "--set", "n_experts=4", "--set", "top_k=2",
           "--set", "n_shared_experts=1", "--set", "dtype=float32"]
    cfg = TS.apply_overrides(TS.get_config("qwen2-moe-a2.7b"), dict(
        kv.split("=", 1) for kv in moe[3::2]))
    params = get_model(cfg).init(seed=5, device="cpu")
    TC.save(str(tmp_path), 3, (params, TA.init(params, TA.AdamWConfig())))
    argv = moe + ["--ckpt", str(tmp_path), "--requests", "6", "--max-new",
                  "6", "--slots", "2", "--max-len", "64", "--prompt-lens",
                  "5,9,17", "--stats"]
    lines, stats = _run(lambda a: TS.main(a, device="cpu"), argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ranks = TS.main(argv + ["--mesh-shape", "2x2"], device="cpu")
    out = buf.getvalue()
    mlines = out[:out.find("{")].splitlines()
    mstats = json.loads(out[out.find("{"):])
    assert mlines[0] == lines[0] == f"restored step 3 from {tmp_path}"
    assert [ln for ln in mlines if ln.startswith("  -> ")] == \
        [ln for ln in lines if ln.startswith("  -> ")]
    msum = next(ln for ln in mlines if ln.startswith("[axllm"))
    tsum = next(ln for ln in lines if ln.startswith("[axllm"))
    assert re.sub(r"[\d.]+ tok/s", "", msum) == re.sub(
        r"[\d.]+ tok/s", "", tsum) + ", mesh 2x2"
    mstats.pop("prefill_wall_s")
    stats.pop("prefill_wall_s")
    assert mstats == stats and stats["finished"] == 6
    assert len(ranks) == 4
    assert all(r["tokens"] == ranks[0]["tokens"] for r in ranks)


def test_encoder_decoder_arch_raises_the_engine_error():
    with pytest.raises(NotImplementedError) as jerr:
        JS.main(["--arch", "whisper-small", "--set", "n_layers=1",
                 "--set", "n_enc_layers=1", "--set", "d_model=64",
                 "--set", "n_heads=4", "--set", "n_kv_heads=4",
                 "--set", "head_dim=16", "--set", "d_ff=128",
                 "--set", "vocab_size=256", "--set", "enc_seq=9"])
    with pytest.raises(NotImplementedError) as terr:
        TS.main(["--arch", "whisper-small"], device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_launcher_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.main(["--requests", "1"] + SETS)


def _names(tree, flatten):
    return [(n, tuple(np.shape(x)), str(np.asarray(x).dtype)
             if not isinstance(x, torch.Tensor) else
             str(x.dtype).replace("torch.", ""))
            for n, x in flatten(tree)]


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_adamw_init_matches_jax(int8):
    cfg = j_apply(j_get_config("repro-100m"),
                  dict(kv.split("=", 1) for kv in TINY))
    jp = j_get_model(cfg).init(jax.random.PRNGKey(0))
    tp = get_model(cfg).init(seed=0, device="cpu")
    jopt = JA.init(jp, JA.AdamWConfig(int8_moments=int8))
    topt = TA.init(tp, TA.AdamWConfig(int8_moments=int8))
    assert _names(topt, TC._flatten) == _names(jopt, JC._flatten)
    assert _names((tp, topt), TC._flatten) == _names((jp, jopt), JC._flatten)
    if int8:
        q = topt["m"]["embed"]["embedding"]
        assert isinstance(q, TA.Q8) and q.pad == (-cfg.d_model) % TA.BLOCK


def _trees():
    """The same values as a JAX tree and a port tree."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((2, 64, 48)).astype(np.float32)
    bf = rng.standard_normal((5, 7)).astype(ml_dtypes.bfloat16)
    qa = JQ.quantize(jnp.asarray(w), JQ.QuantConfig(8, "affine",
                                                    "per_channel"))
    qn = JQ.quantize(jnp.asarray(w[0]), JQ.QuantConfig(4, "codebook",
                                                       "per_group", 16))
    cb = JQ.QTensor(qn.codes, qn.scale, JQ.nf4_codebook(), qn.bits, qn.mode,
                    qn.granularity, qn.group_size, qn.packed, qn.shape)
    q8c = rng.integers(-128, 128, size=(3, 300)).astype(np.int8)
    q8s = rng.random((3, 2)).astype(np.float32)

    def tq(q, codebook=None):
        return TQ.QTensor(codes=torch.from_numpy(np.array(q.codes)),
                          scale=torch.from_numpy(np.array(q.scale)),
                          codebook=codebook, bits=q.bits, mode=q.mode,
                          granularity=q.granularity, group_size=q.group_size,
                          packed=q.packed, shape=tuple(q.shape))

    jtree = ({"w": jnp.asarray(w), "bf": jnp.asarray(bf), "qa": qa,
              "qn": qn, "cb": cb, "list": [jnp.asarray(w[0, 0])]},
             {"m": JA.Q8(jnp.asarray(q8c), jnp.asarray(q8s), (3, 300), 212),
              "count": jnp.asarray(7, jnp.int32)})
    ttree = ({"w": torch.from_numpy(w),
              "bf": torch.from_numpy(bf.view(np.int16)).view(torch.bfloat16),
              "qa": tq(qa), "qn": tq(qn),
              "cb": tq(qn, torch.from_numpy(np.array(JQ.nf4_codebook()))),
              "list": [torch.from_numpy(w[0, 0].copy())]},
             {"m": TA.Q8(torch.from_numpy(q8c), torch.from_numpy(q8s),
                         (3, 300), 212),
              "count": torch.tensor(7, dtype=torch.int32)})
    return jtree, ttree


def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes() + str(tuple(x.shape)).encode()
    x = np.asarray(x)
    return x.tobytes() + str(x.shape).encode()


def _files(d):
    return {os.path.join(r, f)[len(d):]: open(os.path.join(r, f), "rb").read()
            for r, _, fs in os.walk(d) for f in fs}


def test_checkpoint_files_equal_jax_byte_for_byte(tmp_path):
    jtree, ttree = _trees()
    JC.save(str(tmp_path / "j"), 3, jtree, extra={"arch": "x"})
    TC.save(str(tmp_path / "t"), 3, ttree, extra={"arch": "x"})
    jf, tf = _files(str(tmp_path / "j")), _files(str(tmp_path / "t"))
    assert sorted(jf) == sorted(tf)
    assert "/step_00000003/0__cb__@qt_codebook.npy" in tf
    assert "/step_00000003/1__m__@q8_scale.npy" in tf
    for name in jf:
        assert tf[name] == jf[name], name


def test_checkpoint_round_trips_bit_equal(tmp_path):
    jtree, ttree = _trees()
    JC.save(str(tmp_path / "j"), 3, jtree)
    got, step = TC.restore(str(tmp_path / "j"), ttree)
    assert step == 3
    assert got[0]["bf"].dtype == torch.bfloat16
    assert isinstance(got[0]["qn"], TQ.QTensor) and got[0]["qn"].packed
    assert got[0]["cb"].codebook is not None and got[0]["qn"].codebook is None
    assert isinstance(got[1]["m"], TA.Q8) and got[1]["m"].pad == 212
    assert [_bits(x) for _, x in TC._flatten(got)] == \
        [_bits(x) for _, x in TC._flatten(ttree)]
    assert torch.equal(got[0]["qa"].kernel_scale, ttree[0]["qa"].kernel_scale)

    TC.save(str(tmp_path / "t"), 4, ttree)
    back, step = JC.restore(str(tmp_path / "t"), jtree)
    assert step == 4
    assert back[0]["bf"].dtype == jnp.bfloat16
    assert [_bits(x) for _, x in JC._flatten(back)] == \
        [_bits(x) for _, x in JC._flatten(jtree)]


def test_checkpoint_latest_and_gc_match_jax(tmp_path):
    jtree, ttree = _trees()
    for pkg, tree, d in ((JC, jtree, tmp_path / "j"),
                         (TC, ttree, tmp_path / "t")):
        assert pkg.latest_step(str(d)) is None
        with pytest.raises(FileNotFoundError):
            pkg.restore(str(d), tree)
        for step in (1, 2, 5, 9):
            pkg.save(str(d), step, tree, keep=2)
    assert sorted(os.listdir(tmp_path / "t")) == \
        sorted(os.listdir(tmp_path / "j")) == \
        ["latest", "step_00000005", "step_00000009"]
    assert TC.latest_step(str(tmp_path / "t")) == \
        JC.latest_step(str(tmp_path / "j")) == 9
    assert TC.restore(str(tmp_path / "j"), ttree, step=5)[1] == 5
    os.rename(tmp_path / "t" / "step_00000009", tmp_path / "t" / "gone")
    assert TC.latest_step(str(tmp_path / "t")) is None


def test_checkpoint_async_saver_and_shardings(tmp_path):
    _, ttree = _trees()
    saver = TC.AsyncSaver()
    saver.save(str(tmp_path / "a"), 2, ttree)
    saver.save(str(tmp_path / "a"), 3, ttree)
    saver.wait()
    TC.save(str(tmp_path / "s"), 3, ttree)
    a, s = _files(str(tmp_path / "a")), _files(str(tmp_path / "s"))
    assert all(a.get(k) == v for k, v in s.items())
    # onto a (1, 1) mesh every leaf comes back whole (a mesh of ranks:
    # tests/test_torch_sharded_launch.py)
    from repro_torch.dist import sharding as shd
    one = TM.single_device_mesh("cpu")
    whole = (shd.param_specs(ttree[0], one), None)   # moments: whole
    got, step = TC.restore(str(tmp_path / "s"), ttree, shardings=whole)
    want, _ = TC.restore(str(tmp_path / "s"), ttree)
    assert step == 3
    for (name, a), (_, b) in zip(TC._flatten(got), TC._flatten(want)):
        assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A JAX-written checkpoint of a tiny float32 repro-100m: params from
    JAX's seed 7 (not the port's init) and fresh AdamW moments."""
    d = str(tmp_path_factory.mktemp("ckpt"))
    cfg = j_apply(j_get_config("repro-100m"),
                  dict(kv.split("=", 1) for kv in TINY))
    params = j_get_model(cfg).init(jax.random.PRNGKey(7))
    JC.save(d, 5, (params, JA.init(params, JA.AdamWConfig())))
    return d


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    out = buf.getvalue()
    start = out.find("{")
    stats = json.loads(out[start:]) if start >= 0 else {}
    lines = out[:start].splitlines() if start >= 0 else out.splitlines()
    return lines, stats


MODES = {"default": [], "reuse": ["--reuse"], "paged": ["--paged"],
         "lora2": ["--lora", "2"]}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_launcher_matches_jax(jax_ckpt, mode):
    argv = ["--arch", "repro-100m", "--ckpt", jax_ckpt, "--requests", "6",
            "--max-new", "8", "--slots", "4", "--max-len", "64",
            "--prompt-lens", "5,9,17", "--stats"] + SETS + MODES[mode]
    jlines, jstats = _run(JS.main, argv)
    tlines, tstats = _run(lambda a: TS.main(a, device="cpu"), argv)
    assert tlines[0] == jlines[0] == f"restored step 5 from {jax_ckpt}"
    tokens = [ln for ln in tlines if ln.startswith("  -> ")]
    assert len(tokens) == 3
    assert tokens == [ln for ln in jlines if ln.startswith("  -> ")]
    # the summary line: the same but the rate and JAX's path note
    jsum = next(ln for ln in jlines if ln.startswith("[axllm"))
    tsum = next(ln for ln in tlines if ln.startswith("[axllm"))
    assert jsum.endswith(" (host fallback path)")
    assert re.sub(r"[\d.]+ tok/s", "", tsum) == re.sub(
        r"[\d.]+ tok/s", "", jsum[:-len(" (host fallback path)")])
    assert [ln for ln in tlines if ln.startswith(("  paged", "registered"))] \
        == [ln for ln in jlines if ln.startswith(("  paged", "registered"))]
    assert tstats.pop("prefill_wall_s") >= 0
    jstats.pop("prefill_wall_s")
    assert jstats.pop("prefill_compiles") > 0
    assert tstats == jstats
    assert tstats["finished"] == 6 and tstats["decode_tokens"] > 0
    if mode == "lora2":
        assert tstats["lora_requests"] == 4
