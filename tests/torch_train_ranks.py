"""Rank bodies of the distributed training and ``dist`` module tests
(``tests/test_torch_dist_train.py``, ``tests/test_torch_dist_modules.py``):
each runs in a process that ``repro_torch.launch.mesh.run_ranks`` spawns,
takes its mesh first and returns host values. The module imports no JAX,
so a spawned rank does not load it; the test modules compare the results
with the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import make_dataset, shard_batch
from repro_torch.dist import sharding as shd
from repro_torch.launch import mesh as TM
from repro_torch.models.model import get_model
from repro_torch.optim import adamw
from repro_torch.train import checkpoint as C
from repro_torch.train.loop import make_train_step

BATCH, SEQ = 8, 32

# each family's arch, its reduced config's overrides (beyond float32) and
# the leaf its layout cuts over "model"
FAMILIES = {
    "moe": ("qwen2-moe-a2.7b", {"grad_accum": 2}, ("layers", "ffn",
                                                   "expert_gate")),
    "ssm": ("xlstm-1.3b", {}, ("mlstm", "up")),
    "hybrid": ("zamba2-1.2b", {}, ("mamba", "out_proj")),
    "audio": ("whisper-small", {}, ("dec_layers", "self_attn", "wq")),
}


def reduced(family):
    """The family's reduced float32 config (a ModelConfig)."""
    from repro_torch.configs import get_config
    arch, kw, _ = FAMILIES[family]
    return get_config(arch).reduced(dtype="float32", **kw)


def launch_argv(family):
    """The training launcher's flags for the family's reduced config: its
    arch, B8 S32, 4 steps at lr 1e-3, and a ``--set`` for each field the
    reduction changes."""
    import dataclasses
    from repro_torch.configs import get_config
    arch = FAMILIES[family][0]
    full, red = get_config(arch), reduced(family)
    sets = [a for f in dataclasses.fields(red)
            if getattr(red, f.name) != getattr(full, f.name)
            for a in ("--set", f"{f.name}={getattr(red, f.name)}")]
    return ["--arch", arch, "--batch", str(BATCH), "--seq", str(SEQ),
            "--steps", "4", "--lr", "1e-3", "--save-every", "100",
            *sets]


def _np(x):
    return x.detach().float().cpu().numpy() if x.dtype == torch.bfloat16 \
        else x.detach().cpu().numpy()


def np_tree(tree):
    """A tree of tensors (and Q8 moments) as numpy, Q8 as (codes, scale)."""
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(np_tree(v) for v in tree)
    if isinstance(tree, adamw.Q8):
        return (_np(tree.codes), _np(tree.scale))
    return _np(tree)


def start(mesh, cfg_kw, params_np, int8=False):
    """(cfg, step, blocks, opt blocks, param specs, state specs) of a
    training state on ``mesh`` from the whole weights ``params_np``."""
    from repro_torch.launch.train import init_blocks
    cfg = ModelConfig(**cfg_kw)
    api = get_model(cfg)
    ocfg = adamw.AdamWConfig(lr=1e-3, int8_moments=int8)
    params, opt, pspec, (_, ospec) = init_blocks(
        api, ocfg, mesh, params_from_numpy(params_np, mesh.device))
    step = make_train_step(api, ocfg, total_steps=100, warmup=5,
                           grad_specs=pspec)
    return cfg, step, params, opt, pspec, ospec


GATE = ("layers", "ffn", "gate")
FLAGS = ("heads", "kv_heads", "mlp", "vocab", "experts", "ssm_in", "ssm_out",
         "batch_axes")


def at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def steps(mesh, cfg_kw, params_np, n=3, int8=False, save=None, leaf=GATE):
    """``n`` steps of the mesh's training step from ``params_np`` on the
    pipeline's batches (seed 0, B8 S32): each step's metrics, the whole
    parameters and moments the blocks gather to (rank 0; None elsewhere),
    the rank's block shape of the leaf at path ``leaf`` and the layout's
    cuts. ``save``: a directory to checkpoint the final state in
    (gathered, written by rank 0)."""
    cfg, step, params, opt, pspec, ospec = start(mesh, cfg_kw, params_np,
                                                 int8)
    ds = make_dataset(cfg, batch=BATCH, seq=SEQ, seed=0)
    metrics = []
    for s in range(n):
        params, opt, m = step(params, opt, shard_batch(ds.batch_at(s), mesh),
                              s)
        metrics.append({k: float(v) for k, v in m.items()})
    if save is not None:
        C.save(save, n, (params, opt), shardings=(pspec, ospec))
    whole = C.gather_whole((params, opt), (pspec, ospec))
    lay = step.layout
    return {"metrics": metrics,
            "whole": None if whole is None else np_tree(whole),
            "gate": tuple(at(params, leaf).shape),
            "layout": None if lay is None else {
                k: getattr(lay, k) for k in FLAGS}}


def pairs(mesh, cfg_kw, params_np):
    """The MoE layers' kept (token, choice) pairs (:func:`kept_pairs`) in
    the training forward of the first batch's rows of this rank, with the
    rank's coordinates."""
    cfg, step, params, _, pspec, _ = start(mesh, cfg_kw, params_np)
    batch = make_dataset(cfg, batch=BATCH, seq=SEQ, seed=0).batch_at(0)
    return {"pairs": kept_pairs(get_model(cfg), params,
                                shard_batch(batch, mesh), pspec,
                                step.layout),
            "coords": dict(mesh.coords)}


def kept_pairs(api, params, batch, specs=None, lay=None):
    """Each MoE layer's kept (token, choice) pairs in one forward of
    ``batch``: a [B, S k] bool array a layer, in (token, choice) order;
    on a mesh (``lay``) of this rank's blocks ``params`` under ``specs``
    and its rows."""
    from repro_torch.dist import tensor_parallel as tp
    from repro_torch.models import moe as M
    got, real = [], M._dispatch_row

    def spy(weights, experts, e, cap, k):
        out = real(weights, experts, e, cap, k)
        keep, order = out[4], out[5]
        tok = torch.empty_like(keep)
        tok.scatter_(1, order, keep)
        got.append(tok.cpu().numpy())
        return out

    M._dispatch_row = spy
    try:
        with torch.no_grad():
            if lay is None:
                api.loss(params, batch)
            else:
                with shd.activate(lay.mesh, lay.rules, lay):
                    api.loss(tp.to_compute(params, specs, lay), batch)
    finally:
        M._dispatch_row = real
    return got


def restore(mesh, cfg_kw, params_np, ckpt_dir, int8=False):
    """A checkpoint restored onto this rank's blocks and gathered back
    (rank 0; None elsewhere), with its step."""
    _, _, params, opt, pspec, ospec = start(mesh, cfg_kw, params_np, int8)
    tree, step = C.restore(ckpt_dir, (params, opt), shardings=(pspec, ospec))
    whole = C.gather_whole(tree, (pspec, ospec))
    return {"step": step, "whole": None if whole is None else np_tree(whole)}


def resilient(mesh, cfg_kw, params_np, dirs, fail_at, total=4, every=2):
    """``resilient_train(shardings=)`` uninterrupted (``dirs[0]``) and with
    a failure injected on every rank at ``fail_at`` (``dirs[1]``): each
    run's history, restarts and gathered final state (rank 0)."""
    from repro_torch.train.fault_tolerance import (FailureInjector,
                                                   resilient_train)
    out = []
    for d, fail in zip(dirs, (None, fail_at)):
        cfg, step, params, opt, pspec, ospec = start(mesh, cfg_kw, params_np)
        ds = make_dataset(cfg, batch=BATCH, seq=SEQ, seed=0)
        p, o, hist, restarts = resilient_train(
            train_step=lambda p, o, b, s: step(p, o, shard_batch(b, mesh), s),
            params=params, opt_state=opt, dataset=ds, ckpt_dir=d,
            total_steps=total, save_every=every, log_every=1,
            fail_hook=None if fail is None else FailureInjector([fail]),
            shardings=(pspec, ospec))
        whole = C.gather_whole((p, o), (pspec, ospec))
        out.append({"history": hist, "restarts": restarts,
                    "whole": None if whole is None else np_tree(whole)})
    return out


def jit(mesh, cfg_kw, params_np):
    """``jit_train_step`` given the whole parameters, a whole (zero) AdamW
    state and the host batch: whether its metrics equal the block step's
    and it returns blocks."""
    from repro_torch.train.loop import jit_train_step
    from repro_torch.data.pipeline import batch_specs
    cfg, step, params, opt, pspec, ospec = start(mesh, cfg_kw, params_np)
    ds = make_dataset(cfg, batch=BATCH, seq=SEQ, seed=0)
    _, _, want = step(params, opt, shard_batch(ds.batch_at(0), mesh), 0)
    whole = params_from_numpy(params_np, mesh.device)
    fn = jit_train_step(step, mesh, pspec, ospec,
                        batch_specs(cfg, BATCH, SEQ, mesh))
    p, o, got = fn(whole, adamw.init(whole, step.opt_cfg), ds.batch_at(0), 0)
    return {"same_metrics": {k: float(v) for k, v in got.items()} ==
            {k: float(v) for k, v in want.items()},
            "blocks": all(a.shape == b.shape for a, b in zip(
                adamw.tree_leaves(p), adamw.tree_leaves(params)))}


def launcher(mesh, argv):
    """The training launcher's rank body (``launch.train.train_ranks``)."""
    from repro_torch.launch.train import train_ranks
    return train_ranks(mesh, argv)


# -- the dist modules ---------------------------------------------------------

def compression(mesh, xs, g, n_feedback):
    """On a {"pod": 4} mesh: the exchanged value and mean of rank r's row
    ``xs[r]``, and ``n_feedback`` steps of error feedback on ``g[r]``."""
    from repro_torch.dist import compression as Z
    pod = TM.make_host_mesh({"pod": mesh.size}, device=mesh.device)
    r = pod.coords["pod"]
    x = torch.from_numpy(xs[r])
    mean, err = Z.compressed_allreduce_mean(x, "pod", mesh=pod)
    deq = Z._block_quantize(x, Z.BLOCK).numpy()
    acc = torch.zeros(g.shape[1:])
    e = None
    with shd.activate(pod):         # the active mesh, as shard_map binds
        for _ in range(n_feedback):
            m, e = Z.compressed_allreduce_mean(torch.from_numpy(g[r]), "pod",
                                               e)
            acc = acc + m
    return {"mean": mean.numpy(), "deq": deq, "err": err.numpy(),
            "acc": acc.numpy(), "wire": Z.wire_bytes(x)}


def pipeline(mesh, ws, x, n_micro):
    """``make_pipelined_apply`` of tanh(x @ w) stages on a {"stage": S}
    mesh, with the whole stacked weights and with the rank's [1] block."""
    from repro_torch.dist.pipeline import make_pipelined_apply
    stage = TM.make_host_mesh({"stage": mesh.size}, device=mesh.device)
    apply = make_pipelined_apply(lambda w, a: torch.tanh(a @ w), stage,
                                 n_micro)
    s = stage.coords["stage"]
    w = torch.from_numpy(ws)
    return {"whole": apply(w, torch.from_numpy(x)).numpy(),
            "block": apply(w[s:s + 1], torch.from_numpy(x)).numpy()}


def _qt(d, lo, hi, axis):
    """A QTensor of the numpy children ``d`` cut to [lo, hi) on ``axis``
    (0: rows, with per-group scale rows; 1: columns)."""
    from repro_torch.core.quantization import QTensor
    codes, scale = d["codes"], d["scale"]
    g = d.get("group_size", 128)
    if axis == 0:
        codes = codes[lo:hi]
        if d["granularity"] == "per_group":
            scale = scale[lo // g:hi // g]
    else:
        c = 2 if d.get("packed") else 1
        codes = codes[:, lo // c:hi // c]
        if d["granularity"] != "per_tensor":
            scale = scale[..., lo:hi]
    n = codes.shape[-1] * (2 if d.get("packed") else 1)
    return QTensor(codes=torch.from_numpy(np.ascontiguousarray(codes)),
                   scale=torch.from_numpy(np.ascontiguousarray(scale)),
                   codebook=None, bits=d["bits"], mode="affine",
                   granularity=d["granularity"], group_size=g,
                   packed=bool(d.get("packed")), shape=(codes.shape[0], n))


def rings(mesh, x, w, quant, errs):
    """Both ring matmuls on a {"model": P} mesh: dense (x's and w's blocks
    cut from the whole ``x`` [B, K] and ``w`` [K, N]), and for each of
    ``quant`` ({name: (xq, QTensor children, form)}) the ring form on the
    rank's QTensor block with ``impl="reuse"``; then the two ValueErrors
    of the ring's block cut (``errs``: (QTensor children, block, axis))."""
    from repro_torch.dist import collective_matmul as R
    model = TM.make_host_mesh({"model": mesh.size}, device=mesh.device)
    p, r = model.size, model.coords["model"]
    k, n = w.shape
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    kl, nl = k // p, n // p
    out = {"ag": R.ring_allgather_matmul(
        xt[:, r * kl:(r + 1) * kl], wt[:, r * nl:(r + 1) * nl], "model",
        mesh=model).numpy()}
    with shd.activate(model):
        out["rs"] = R.ring_matmul_reducescatter(
            xt[:, r * kl:(r + 1) * kl], wt[r * kl:(r + 1) * kl], "model"
        ).numpy()
    for name, (xq, d, form) in quant.items():
        kq, nq = d["codes"].shape[0], d["n"]
        xb = torch.from_numpy(xq[:, r * kq // p:(r + 1) * kq // p])
        if form == "ag":
            wb = _qt(d, r * nq // p, (r + 1) * nq // p, 1)
            y = R.ring_allgather_matmul(xb, wb, "model", impl="reuse",
                                        mesh=model)
        else:
            wb = _qt(d, r * kq // p, (r + 1) * kq // p, 0)
            y = R.ring_matmul_reducescatter(xb, wb, "model", impl="reuse",
                                            mesh=model)
        out[name] = y.numpy()
    errors = []
    for d, size, axis in errs:
        try:
            R._qslice(_qt(d, 0, d["n"] if axis else d["codes"].shape[0],
                          1 if axis else 0), 0, size, axis)
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    return out


def run_jobs(mesh, jobs):
    """Every ``(name, args)`` or ``(name, args, axes)`` of ``jobs`` in turn:
    the rank body ``name`` of this module on ``mesh``, or on a mesh of
    ``axes`` over the same ranks, so that one spawn serves several mesh
    shapes of a test module."""
    meshes, out = {}, []
    for name, args, *axes in jobs:
        m = mesh
        if axes:
            key = tuple(axes[0].items())
            if key not in meshes:       # every rank makes it, in order
                meshes[key] = TM.make_host_mesh(axes[0], device=mesh.device)
            m = meshes[key]
        out.append(globals()[name](m, *args))
    return out


# -- comparisons of the tests' results (no JAX) -------------------------------

def port_single(cfg_kw, weights, n, int8=False, lr=1e-3):
    """``n`` steps of the port's single-device run from the whole weights
    ``weights`` (numpy) on the pipeline's batches: (the final parameters
    and moments, each step's metrics, each step's whole-batch gradients),
    as numpy."""
    from repro_torch.train.loop import _grad_fn
    cfg = ModelConfig(**cfg_kw)
    api = get_model(cfg)
    ocfg = adamw.AdamWConfig(lr=lr, int8_moments=int8)
    params = params_from_numpy(weights, "cpu")
    opt = adamw.init(params, ocfg)
    fn = make_train_step(api, ocfg, total_steps=100, warmup=5)
    ds = make_dataset(cfg, batch=BATCH, seq=SEQ, seed=0)
    metrics, grads = [], []
    for s in range(n):
        batch = shard_batch(ds.batch_at(s), device="cpu")
        grads.append(np_tree(_grad_fn(api)(params, batch)[1]))
        params, opt, m = fn(params, opt, batch, s)
        metrics.append({k: float(v) for k, v in m.items()})
    return np_tree((params, opt)), metrics, grads


def leaves(tree, path=()):
    """(path, leaf) of a numpy tree (dicts by sorted key, tuples by
    index)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    elif isinstance(tree, tuple):
        for i, t in enumerate(tree):
            yield from leaves(t, path + (i,))
    else:
        yield path, tree


def assert_params_close(got, want, grads, metrics, int8=False, lr=1e-3):
    """Parameters ``got`` within rtol 1e-3, atol 1e-5 of ``want`` (the
    single-device run's), but for elements whose single-device gradient
    (``grads``, each step's) was at some step a nonzero value within 1e-5
    of its leaf's largest. There the mesh's gradient (summed in another
    order, within about 2e-6 of that scale) may have the other sign, and
    Adam's step (the gradient over its own root mean square) then differs
    by as much as a step can: such an element may miss the tolerance by
    no more than twice the clipped step (3) times lr times the sum of the
    steps' lr_scale, and no more than one element in a thousand may. With
    ``int8`` moments any element may: a moment within rounding of a code
    boundary may take the next code on one side (:func:`assert_q8_close`),
    and a small second moment's code is a coarse step of its block's
    scale."""
    bound = 2 * 3 * lr * sum(m["lr_scale"] for m in metrics)
    missed = total = 0
    for path, w in leaves(want):
        g = at(got, path)
        noisy = np.full(w.shape, int8)
        for step in grads:
            s = np.abs(at(step, path))
            noisy |= (s > 0) & (s <= 1e-5 * s.max())
        far = np.abs(g - w) > 1e-5 + 1e-3 * np.abs(w)
        name = "/".join(map(str, path))
        assert not np.any(far & ~noisy), name
        assert np.all(np.abs(g - w)[far] <= bound), name
        missed += int(far.sum())
        total += w.size
    assert missed <= total / 1000


def assert_close(got, want, **tol):
    """Numpy trees within ``tol`` (``np.testing.assert_allclose``)."""
    for path, w in leaves(want):
        np.testing.assert_allclose(at(got, path), w, err_msg="/".join(
            map(str, path)), **tol)


def assert_q8_close(got, want, steps):
    """Moments of a mesh run against one device's after ``steps`` steps:
    an int8 moment's codes off by ``steps`` at most (each step's
    requantization of a moment within rounding of a code boundary may
    take the next code on one side, and the moments carry it), in no more
    than one element in a thousand; its block scales and a float32 moment
    (a leaf too small for codes) within rtol 1e-3, atol 1e-7."""
    off = total = 0
    for path, w in leaves(want):
        g = at(got, path)
        assert g.shape == w.shape and g.dtype == w.dtype
        if w.dtype == np.int8:
            d = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert d.max() <= steps
            off += int((d > 0).sum())
            total += w.size
        else:
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-7)
    assert off <= total / 1000


def assert_equal_trees(a, b):
    """Numpy trees bit-equal, leaf for leaf."""
    la, lb = list(leaves(a)), list(leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (_, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def assert_rank_agrees_with_jax(rank_metrics, want):
    """One rank's metrics against the single-device JAX step's at each
    step: ``loss`` within rel 2e-4, ``grad_norm`` within rel 1e-4,
    ``lr_scale`` within one f32 ulp."""
    import pytest
    assert len(rank_metrics) == len(want)
    for w, g in zip(want, rank_metrics):
        assert g["loss"] == pytest.approx(w["loss"], rel=2e-4)
        assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=1e-4)
        assert abs(g["lr_scale"] - w["lr_scale"]) <= \
            float(np.spacing(np.float32(w["lr_scale"])))
