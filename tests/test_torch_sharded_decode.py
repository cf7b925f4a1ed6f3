"""Port parity of the sequence-sharded decode
(``repro_torch.kernels.sharded_decode.decode_attention_seqsharded``) with
the JAX package, on 2 and 4 ranks over gloo (spawned once for the module;
the ranks import no JAX).

Each rank holds its rows of the cache. Against the JAX goldens of
``tests/test_sharded_serve.py``: the owner's update is exact (int8 codes and
f32 scales; every rank's rows concatenated equal the expected cache), the
output equals JAX's ``decode_attention_ref`` on the updated cache and
``paged_decode_attention_ref`` on its block-pool layout (rtol 1e-4, atol
1e-6, float32 sums in another order), and JAX's own
``decode_attention_seqsharded`` on a (1, 4) mesh of host devices; the same
on a bf16 cache (within 1e-2 of the output scale: the output is rounded to
bf16). Every rank gives the same output. A length-0 row is exactly 0,
never NaN, and writes nothing.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from repro.kernels.ref import decode_attention_ref, paged_decode_attention_ref
from repro.kernels.sharded_decode import decode_attention_seqsharded as j_sd
from repro.launch.mesh import make_host_mesh
from repro_torch.launch.mesh import run_ranks

import torch_tp_ranks

WORLDS = (2, 4)


def _case(lengths, seed=0, quantized=True):
    """The JAX test's random decode state (int8 codes + scales, or float
    K/V) and the cache it expects after the update."""
    b, s, h, hk, d = len(lengths), 32, 4, 2, 16
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    if quantized:
        k = rng.integers(-127, 128, size=(b, s, hk, d)).astype(np.int8)
        v = rng.integers(-127, 128, size=(b, s, hk, d)).astype(np.int8)
        nk = rng.integers(-127, 128, size=(b, hk, d)).astype(np.int8)
        nv = rng.integers(-127, 128, size=(b, hk, d)).astype(np.int8)
    else:
        k = rng.normal(size=(b, s, hk, d)).astype(np.float32)
        v = rng.normal(size=(b, s, hk, d)).astype(np.float32)
        nk = rng.normal(size=(b, hk, d)).astype(np.float32)
        nv = rng.normal(size=(b, hk, d)).astype(np.float32)
    length = np.asarray(lengths, np.int32)
    pos = length - 1                    # write slot; -1 when length == 0
    inputs = dict(q=q, k=k, v=v, nk=nk, nv=nv, pos=pos, length=length)
    exp = {"k": k.copy(), "v": v.copy()}
    if quantized:
        inputs.update(
            ks=rng.uniform(0.01, 0.05, size=(b, s, hk, 1)).astype(np.float32),
            vs=rng.uniform(0.01, 0.05, size=(b, s, hk, 1)).astype(np.float32),
            nks=rng.uniform(0.01, 0.05, size=(b, hk, 1)).astype(np.float32),
            nvs=rng.uniform(0.01, 0.05, size=(b, hk, 1)).astype(np.float32))
        exp.update(ks=inputs["ks"].copy(), vs=inputs["vs"].copy())
    for i, p in enumerate(pos):
        if p >= 0:
            exp["k"][i, p], exp["v"][i, p] = nk[i], nv[i]
            if quantized:
                exp["ks"][i, p] = inputs["nks"][i]
                exp["vs"][i, p] = inputs["nvs"][i]
    return inputs, exp


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


CASES = {
    "int8": (_case([5, 32, 17, 1]), "float32"),
    "bf16": (_case([5, 32, 17, 1], seed=1, quantized=False), "bfloat16"),
    "length0": (_case([0, 3]), "float32"),
    "length0-bf16": (_case([0, 9], seed=2, quantized=False), "bfloat16"),
}


@pytest.fixture(scope="module")
def ranks():
    """{world: {case: per-rank [out, k rows, v rows(, ks rows, vs rows)]}},
    one spawn a world."""
    cases = [(inputs, dtype) for (inputs, _), dtype in CASES.values()]
    out = {}
    for world in WORLDS:
        res = run_ranks(torch_tp_ranks.run_jobs, world, "cpu",
                        [("seqsharded", (cases,))], threads=1)
        out[world] = {name: [r[0][i] for r in res]
                      for i, name in enumerate(CASES)}
    return out


def _assembled(per_rank):
    """The output (the same on every rank) and the caches put together
    from every rank's rows."""
    outs = [r[0] for r in per_rank]
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    caches = [np.concatenate([r[i] for r in per_rank], axis=1)
              for i in range(1, len(per_rank[0]))]
    return outs[0], caches


def _refs(inputs, exp, dtype):
    """JAX's dense and paged reference outputs on the expected cache."""
    q, k, v = inputs["q"], exp["k"], exp["v"]
    if dtype == "bfloat16":
        q, k, v = _bf16(q), _bf16(k), _bf16(v)
    scales = {}
    if "ks" in exp:
        scales = dict(k_scale=exp["ks"], v_scale=exp["vs"])
    length = jnp.asarray(inputs["length"])
    dense = decode_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), length,
                                 **{n: jnp.asarray(a) for n, a in
                                    scales.items()})
    b, s = k.shape[:2]
    bs, nb = 8, s // 8

    def pool(cache):
        trash = np.zeros((1, bs) + cache.shape[2:], cache.dtype)
        return jnp.asarray(np.concatenate(
            [trash, cache.reshape(b * nb, bs, *cache.shape[2:])]))

    tables = jnp.asarray(1 + np.arange(b * nb, dtype=np.int32).reshape(b, nb))
    paged = paged_decode_attention_ref(
        jnp.asarray(q), pool(k), pool(v), tables, length,
        **{n: pool(a) for n, a in scales.items()})
    return np.asarray(dense), np.asarray(paged)


def _tol(dtype, ref):
    if dtype == "bfloat16":
        return dict(rtol=0, atol=1e-2 * float(np.abs(ref).max()))
    return dict(rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["int8", "bf16"])
def test_seqsharded_matches_dense_and_paged_refs(ranks, name, world):
    (inputs, exp), dtype = CASES[name]
    out, caches = _assembled(ranks[world][name])
    keys = ("k", "v", "ks", "vs")[:len(caches)]
    for key, got in zip(keys, caches):      # the owner's write is exact
        want = _bf16(exp[key]) if dtype == "bfloat16" else exp[key]
        np.testing.assert_array_equal(got, want)
    dense, paged = _refs(inputs, exp, dtype)
    np.testing.assert_allclose(out, dense, **_tol(dtype, dense))
    np.testing.assert_allclose(out, paged, **_tol(dtype, dense))


def test_seqsharded_matches_jax_shard_map(ranks, eight_cpu_devices):
    """The port's 4 ranks against JAX's shard_map body on (1, 4) host
    devices, on the int8 golden."""
    world = 4
    (inputs, _), _ = CASES["int8"]
    i = {k: jnp.asarray(a) for k, a in inputs.items()}
    jres = j_sd(i["q"], i["k"], i["v"], i["nk"], i["nv"], i["pos"],
                i["length"], make_host_mesh(1, world), seq_axes=("model",),
                batch_axes=(), k_scale=i["ks"], v_scale=i["vs"],
                new_k_scale=i["nks"], new_v_scale=i["nvs"])
    out, caches = _assembled(ranks[world]["int8"])
    np.testing.assert_allclose(out, np.asarray(jres[0]), rtol=1e-4,
                               atol=1e-6)
    for got, want in zip(caches, jres[1:]):
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["length0", "length0-bf16"])
def test_seqsharded_length0_row_is_exact_zero(ranks, name, world):
    (inputs, exp), dtype = CASES[name]
    out, caches = _assembled(ranks[world][name])
    assert np.all(out[0] == 0.0), "a length-0 row must be exactly zero"
    assert not np.any(np.isnan(out))
    # row 0's pos is -1: no rank owns it, its rows are untouched
    want_k = _bf16(inputs["k"]) if dtype == "bfloat16" else inputs["k"]
    np.testing.assert_array_equal(caches[0][0], want_k[0])
    dense, _ = _refs(inputs, exp, dtype)
    np.testing.assert_allclose(out[1], dense[1], **_tol(dtype, dense))
