"""Port parity for AdamW (``repro_torch.optim.adamw``) against the JAX
package's ``repro.optim.adamw`` on the CPU, inputs from numpy seeds.

- ``_q8`` / ``_deq8``: codes, scales and dequantized values equal JAX's
  bit for bit, signed and in the sqrt domain, with and without padding of
  the last dim to the 256-wide block, and stacked leading dims; ``_q8``
  rounds half to even, as ``jnp.round`` does.
- ``update``: given the same parameters, gradients and state (JAX's own
  state after one step, carried across by ``bridge.opt_state_from_numpy``),
  f32 and blockwise-int8 moments, bf16 and f32 parameters: the new
  parameters within 4 f32 ulps of their scale (the two frameworks round
  ``pow`` and the gradient norm's sums differently, by an ulp), f32
  moments within 1e-6 of each leaf's largest entry (an ulp of the clip
  factor moves an entry that nearly cancels by more than its own ulps),
  int8 moment codes equal up to a code at a rounding boundary (at most 1
  in 1000 codes, by one), scales within 1e-6; the reported norm is the
  pre-clip norm; the count advances.
- ``global_norm`` and ``warmup_cosine`` (steps 0, 10, 100 and between)
  within one f32 ulp of JAX's.
- The update is functional, and weight decay reaches matrices only.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as JA
from repro_torch.bridge import opt_state_from_numpy
from repro_torch.optim import adamw as TA

# leaves of every kind the models have: stacked matrices, a last dim that
# pads to the block (300 -> 512, 100 -> 256), vectors above and below one
# block
SHAPES = {"attn": {"wq": (2, 64, 300), "wo": (2, 300, 64)},
          "norm": (2, 256), "bias": (7,), "emb": (3, 100), "vec": (512,)}


def _tree(rng, scale, shapes=SHAPES):
    if isinstance(shapes, dict):
        return {k: _tree(rng, scale, v) for k, v in shapes.items()}
    return (rng.standard_normal(shapes) * scale).astype(np.float32)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree, dtype=torch.float32):
    return jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a, np.float32)).to(dtype), tree)


def _state_np(state):
    """A JAX AdamW state as numpy (Q8 moments as dicts of their fields)."""
    def moment(x):
        if isinstance(x, JA.Q8):
            return dict(codes=np.asarray(x.codes), scale=np.asarray(x.scale),
                        shape=x.shape, pad=x.pad)
        if isinstance(x, dict):
            return {k: moment(v) for k, v in x.items()}
        return np.asarray(x)
    return {"m": moment(state["m"]), "v": moment(state["v"]),
            "count": np.asarray(state["count"])}


def _moments(tree):
    return jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, JA.Q8))


Q8_CASES = [((4, 300), 0), ((512,), 1), ((2, 3, 256), 2), ((3, 700), 3),
            ((1, 256), 4)]


@pytest.mark.parametrize("unsigned_sqrt", [False, True], ids=["signed",
                                                              "sqrt"])
@pytest.mark.parametrize("shape,seed", Q8_CASES,
                         ids=[str(s) for s, _ in Q8_CASES])
def test_q8_and_deq8_match_jax(shape, seed, unsigned_sqrt):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if unsigned_sqrt:
        x = x * x * 1e-3           # a second moment: non-negative, small
    x[..., 0] = 0.0                # an exact zero in every row
    jq = JA._q8(jnp.asarray(x), unsigned_sqrt=unsigned_sqrt)
    tq = TA._q8(torch.from_numpy(x), unsigned_sqrt=unsigned_sqrt)
    assert (tq.shape, tq.pad) == (jq.shape, jq.pad)
    assert tq.codes.dtype == torch.int8 and tq.codes.is_contiguous()
    np.testing.assert_array_equal(tq.codes.numpy(), np.asarray(jq.codes))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    jd = JA._deq8(jq, unsigned_sqrt=unsigned_sqrt)
    td = TA._deq8(tq, unsigned_sqrt=unsigned_sqrt)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_q8_rounds_half_to_even():
    """Values on a half code: 127 * [0.5, 1.5, 2.5, -0.5, -2.5] / 127
    against a block max of 1 round to even codes in both packages."""
    x = np.zeros((256,), np.float32)
    x[:6] = np.array([1.0, 0.5, 1.5, 2.5, -0.5, -2.5], np.float32) / 127.0
    x[0] = 1.0                      # the block max: scale exactly 1/127
    tq = TA._q8(torch.from_numpy(x))
    jq = JA._q8(jnp.asarray(x))
    np.testing.assert_array_equal(tq.codes.numpy(), np.asarray(jq.codes))
    assert tq.codes[1:6].tolist() == [0, 2, 2, 0, -2]


@pytest.mark.parametrize("step", [0, 1, 5, 10, 37, 99, 100, 250])
def test_warmup_cosine_matches_jax(step):
    want = float(JA.warmup_cosine(jnp.asarray(step), 10, 100))
    got = TA.warmup_cosine(step, 10, 100)
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= float(np.spacing(np.float32(want)))


def test_warmup_cosine_values():
    """The JAX test's values: 0 at step 0, 1 at the end of the warmup,
    the floor 0.1 at the last step."""
    assert float(TA.warmup_cosine(0, 10, 100)) == 0.0
    assert float(TA.warmup_cosine(10, 10, 100)) == pytest.approx(1.0)
    assert float(TA.warmup_cosine(100, 10, 100)) == pytest.approx(0.1,
                                                                  abs=1e-6)
    assert float(TA.warmup_cosine(torch.tensor(10), 10, 100)) == \
        pytest.approx(1.0)


def test_global_norm_matches_jax():
    g = _tree(np.random.default_rng(5), 0.3)
    want = float(JA.global_norm(_jax(g)))
    got = TA.global_norm(_torch(g))
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 2 * float(np.spacing(np.float32(want)))


def test_tree_leaves_follow_jax_order():
    tree = {"z": 1, "a": {"y": 2, "b": 3}, "m": (4, 5)}
    assert TA.tree_leaves(tree) == jax.tree_util.tree_leaves(tree)
    back = TA.tree_unflatten(tree, TA.tree_leaves(tree))
    assert back == tree and list(back) == list(tree)


def _close_ulps(got: torch.Tensor, want, ulps: int = 4):
    want = np.asarray(want, np.float32)
    got = got.to(torch.float32).numpy()
    scale = max(float(np.abs(want).max()), 1e-30)
    tol = ulps * float(np.spacing(np.float32(scale)))
    assert float(np.abs(got - want).max()) <= tol


UPDATE_CASES = [(False, "float32"), (True, "float32"), (False, "bfloat16"),
                (True, "bfloat16")]


@pytest.mark.parametrize("int8,dtype", UPDATE_CASES,
                         ids=[f"{'q8' if i else 'f32'}-{d}"
                              for i, d in UPDATE_CASES])
def test_update_matches_jax(int8, dtype):
    """One update from JAX's own state after a first step, fed the same
    gradients (large enough that the clip acts)."""
    rng = np.random.default_rng(11)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    p0 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt),
                                _tree(rng, 0.05))
    g1, g2 = _tree(rng, 0.1), _tree(rng, 0.1)
    cfg = JA.AdamWConfig(lr=1e-3, int8_moments=int8)
    state = JA.init(p0, cfg)
    p1, s1, _ = JA.update(p0, _jax(g1), state, cfg,
                          JA.warmup_cosine(jnp.asarray(3), 5, 100))
    p2, s2, jm = JA.update(p1, _jax(g2), s1, cfg,
                           JA.warmup_cosine(jnp.asarray(4), 5, 100))

    tdt = getattr(torch, dtype)
    tp1 = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a, np.float32)).to(tdt), p1)
    ts1 = opt_state_from_numpy(_state_np(s1), "cpu")
    tcfg = TA.AdamWConfig(lr=1e-3, int8_moments=int8)
    tp2, ts2, tm = TA.update(tp1, _torch(g2), ts1, tcfg,
                             TA.warmup_cosine(4, 5, 100))

    assert float(jm["grad_norm"]) > 1.0      # the clip acts
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
        2 * float(np.spacing(np.float32(jm["grad_norm"])))
    assert int(ts2["count"]) == int(s2["count"]) == 2
    for want, got in zip(jax.tree_util.tree_leaves(p2),
                         TA.tree_leaves(tp2)):
        assert got.dtype == tdt and tuple(got.shape) == want.shape
        if dtype == "bfloat16":   # one rounding of an f32 within 4 ulps
            diff = np.abs(got.to(torch.float32).numpy()
                          - np.asarray(want, np.float32))
            ulp = np.spacing(np.abs(np.asarray(want, np.float32))
                             .astype(np.float32)) * 2 ** 16
            assert np.all(diff <= ulp)
            assert np.mean(diff > 0) <= 1e-2
        else:
            _close_ulps(got, want)
    for key in ("m", "v"):
        for want, got in zip(_moments(s2[key]), TA.tree_leaves(ts2[key])):
            if isinstance(want, JA.Q8):
                assert isinstance(got, TA.Q8)
                assert (got.shape, got.pad) == (want.shape, want.pad)
                d = np.abs(got.codes.numpy().astype(np.int32)
                           - np.asarray(want.codes, np.int32))
                assert d.max() <= 1 and np.mean(d > 0) <= 1e-3
                np.testing.assert_allclose(got.scale.numpy(),
                                           np.asarray(want.scale),
                                           rtol=1e-6, atol=0)
            else:
                want = np.asarray(want)
                np.testing.assert_allclose(
                    got.numpy(), want, rtol=0,
                    atol=1e-6 * float(np.abs(want).max()))


def test_update_is_functional_and_decays_matrices_only():
    """``update`` writes into none of its inputs; with a zero gradient and
    fresh f32 moments the step is 0, so a matrix moves by lr * wd * p and
    a vector not at all."""
    p = {"w": torch.full((2, 3), 2.0), "b": torch.full((3,), 2.0)}
    g = {"w": torch.zeros(2, 3), "b": torch.zeros(3)}
    cfg = TA.AdamWConfig(lr=0.5, weight_decay=0.1)
    state = TA.init(p, cfg)
    before = {k: v.clone() for k, v in p.items()}
    new_p, new_state, _ = TA.update(p, g, state, cfg)
    for k in p:
        assert torch.equal(p[k], before[k])
        assert new_p[k] is not p[k]
    assert int(state["count"]) == 0 and int(new_state["count"]) == 1
    assert torch.allclose(new_p["w"], torch.full((2, 3), 2.0 - 0.5 * 0.2))
    assert torch.equal(new_p["b"], before["b"])


def test_opt_state_from_numpy_has_init_layout():
    """A JAX state (f32 and int8 moments) comes across in the layout of
    the port's own ``init``: the same leaves, kinds, shapes and pads."""
    params_np = _tree(np.random.default_rng(2), 0.05)
    for int8 in (False, True):
        jstate = JA.init(_jax(params_np), JA.AdamWConfig(int8_moments=int8))
        got = opt_state_from_numpy(_state_np(jstate), "cpu")
        want = TA.init(_torch(params_np), TA.AdamWConfig(int8_moments=int8))
        assert got["count"].dtype == torch.int32 and got["count"].ndim == 0
        for key in ("m", "v"):
            for a, b in zip(TA.tree_leaves(got[key]),
                            TA.tree_leaves(want[key])):
                assert type(a) is type(b)
                if isinstance(a, TA.Q8):
                    assert (a.shape, a.pad) == (b.shape, b.pad)
                    assert a.codes.shape == b.codes.shape
                    assert a.scale.shape == b.scale.shape
                else:
                    assert a.shape == b.shape and a.dtype == b.dtype


def test_config_fields_match_jax():
    assert [(f.name, f.default) for f in dataclasses.fields(TA.AdamWConfig)] \
        == [(f.name, f.default) for f in dataclasses.fields(JA.AdamWConfig)]
