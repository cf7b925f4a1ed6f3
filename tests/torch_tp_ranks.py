"""Rank bodies of the tensor-parallel tests (``tests/test_torch_sharded_*``,
``tests/test_torch_sharding.py``): each runs in a process that
``repro_torch.launch.mesh.run_ranks`` spawns, takes its mesh first and
returns host values. The module imports no JAX, so a spawned rank does not
load it; the test modules compare the results with the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.bridge import params_from_numpy
from repro_torch.serve.adapters import make_synthetic_adapters
from repro_torch.serve.engine import ServeEngine

def _requests(cfg, prompt_lens, lora, seed=0):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in prompt_lens]
    names = [None] * len(prompts)
    if lora:
        names = [None if i % 3 == 0 else f"adapter{i % 2}"
                 for i in range(len(prompts))]
    return prompts, names


def stats_of(eng) -> dict:
    """The engine's stats without its host timing."""
    st = eng.stats.as_dict()
    st.pop("prefill_wall_s")
    return st


def serve_modes(mesh, cfg, params_np, modes, prompt_lens, max_new=8):
    """Tokens and stats of one engine a mode on ``mesh`` (None: one CPU
    device), its weights ``params_np`` (numpy) or made from the seed
    ``params_np`` on the rank's device. ``modes``: {name: ServeEngine
    keywords, plus "lora": adapter
    targets (two synthetic adapters, requests cycling base and both),
    "per_group": a group size (the weights quantized per group before the
    engine takes them), "late": requests submitted at priority 1 after the
    first step (paged: they preempt), "n_slots": the slots (default 2),
    "max_new": the requests' budgets, cycled (default ``max_new``)}."""
    from repro_torch.core.quantization import QuantConfig, quantize_tree
    from repro_torch.kernels import _build
    from repro_torch.models.model import get_model
    dev = "cpu" if mesh is None else mesh.device
    params = get_model(cfg).init(seed=params_np, device=dev) \
        if isinstance(params_np, int) else params_from_numpy(params_np, dev)
    out = {}
    for mode, kw in modes.items():
        kw = dict(kw)
        targets, group = kw.pop("lora", None), kw.pop("per_group", None)
        late, n_slots = kw.pop("late", 0), kw.pop("n_slots", 2)
        budgets = kw.pop("max_new", (max_new,))
        reg = None
        if targets:
            reg, _ = make_synthetic_adapters(cfg, 2, targets=targets,
                                             device=dev)
        p = params if group is None else quantize_tree(params, QuantConfig(
            bits=8, granularity="per_group", group_size=group))
        prompts, names = _requests(cfg, prompt_lens, targets)
        eng = ServeEngine(cfg, p, n_slots=n_slots, max_len=64, mesh=mesh,
                          adapters=reg, device=dev, **kw)
        _build.reset_launches()
        n = len(prompts) - late
        for i in range(n):
            eng.submit(prompts[i], max_new=budgets[i % len(budgets)],
                       adapter=names[i])
        if late:
            eng.step()
            for i in range(n, len(prompts)):
                eng.submit(prompts[i], max_new=budgets[i % len(budgets)],
                           adapter=names[i], priority=1)
        eng.run()
        reqs = sorted(eng.finished, key=lambda r: r.rid)
        out[mode] = {"tokens": [list(map(int, r.tokens)) for r in reqs],
                     "stats": stats_of(eng),
                     "launches": dict(_build.LAUNCHES),
                     "layout": None if eng._layout is None else {
                         k: getattr(eng._layout, k) for k in
                         ("heads", "kv_heads", "seq", "mlp", "vocab")},
                     "rows": None if eng._rows is None else
                     (eng._rows.lo, eng._rows.n),
                     "cut": None if eng._layout is None else {
                         k: getattr(eng._layout, k) for k in
                         ("experts", "ssm_in", "ssm_out", "batch_axes")},
                     "experts": _expert_codes(eng.params)}
    return out


def _expert_codes(params):
    """The shape of the first expert stack's codes an engine holds."""
    for key, leaf in _items(params):
        if key == "expert_gate":
            return tuple(leaf.codes.shape if hasattr(leaf, "codes")
                         else leaf.shape)
    return None


def _items(tree, key=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, k)
    else:
        yield key, tree


def restore_layout(mesh, cfg, ckpt_dir, n_slots=2):
    """A raw checkpoint restored onto this rank's blocks under the engine's
    layout (``ServeEngine.mesh_layout``, ``tensor_parallel.layout_specs``,
    as the launcher restores it): {leaf path: (block shape, whole shape,
    equal to the whole leaf cut by ``local_shard``)} for every leaf the
    layout cuts (none without a model axis)."""
    from repro_torch.dist import sharding as shd
    from repro_torch.dist import tensor_parallel as tp
    from repro_torch.models.model import get_model
    from repro_torch.train import checkpoint as C
    like = get_model(cfg).init(seed=0, device="cpu")
    whole_tree, _ = C.restore(ckpt_dir, like)
    _, lay, whole = ServeEngine.mesh_layout(cfg, mesh, like, n_slots=n_slots,
                                            max_len=64, paged=False)
    if lay is None:             # no model axis: the launcher restores whole
        return {}
    specs = tp.layout_specs(whole, shd.param_specs(whole, mesh, lay.rules),
                            lay)
    got, _ = C.restore(ckpt_dir, like, shardings=specs)
    out = {}

    def walk(path, a, b, spec):
        if isinstance(a, dict):
            for k in a:
                walk(f"{path}/{k}", a[k], b[k], spec[k])
        elif any(e is not None for e in spec.spec):
            want = shd.local_shard(b, spec, mesh, mesh.rank)
            out[path] = (tuple(a.shape), tuple(b.shape),
                         bool(torch.equal(a, want)))
    walk("", got, whole_tree, specs)
    return out


def seqsharded(mesh, cases, batch_axes=(), seq_axes=("model",), axes=None):
    """``decode_attention_seqsharded`` on this rank's rows of each case's
    caches (numpy, the JAX test's layout; ``dtype`` "bfloat16" casts the
    float inputs), the sequence cut over ``seq_axes`` (block i * D + j at
    model rank i and data rank j for ("model", "data")) and the batch over
    ``batch_axes``; ``axes`` builds another mesh of the same ranks for it
    (such as {"pod": 2, "data": 1, "model": 2}). Returns each case's output
    and the rank's rows."""
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels.sharded_decode import decode_attention_seqsharded
    if axes is not None:
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh(axes, device=mesh.device)
    out = []
    for inputs, dtype in cases:
        t = {k: torch.from_numpy(np.array(v)).to(mesh.device)
             for k, v in inputs.items()}
        if batch_axes:
            rows = shd.block_index((t["q"].shape[0],), (tuple(batch_axes),),
                                   mesh, mesh.rank)[0]
            t = {k: v[rows] for k, v in t.items()}
        if dtype == "bfloat16":
            for k in ("q", "k", "v", "nk", "nv"):
                t[k] = t[k].to(torch.bfloat16)
        cut = shd.block_index(t["k"].shape, (None, tuple(seq_axes)), mesh,
                              mesh.rank)
        rows = {k: t[k][cut].clone() for k in ("k", "v", "ks", "vs")
                if k in t}
        scales = {}
        if "ks" in rows:
            scales = dict(k_scale=rows["ks"], v_scale=rows["vs"],
                          new_k_scale=t["nks"], new_v_scale=t["nvs"])
        res = decode_attention_seqsharded(
            t["q"], rows["k"], rows["v"], t["nk"], t["nv"], t["pos"],
            t["length"], mesh, seq_axes, batch_axes, **scales)
        out.append([x.float().cpu().numpy() if x.dtype == torch.bfloat16
                    else x.cpu().numpy() for x in res])
    return out


def restore_blocks(mesh, ckpt_dir, like_np):
    """This rank's blocks of a checkpoint restored with the layout specs
    of ``like_np``'s tree (``dist.sharding.param_specs`` under
    ``SERVE_HEAD_RULES``)."""
    from repro_torch.dist import sharding as shd
    from repro_torch.train import checkpoint as C
    like = params_from_numpy(like_np, "cpu")
    specs = shd.param_specs(like, mesh, shd.SERVE_HEAD_RULES)
    tree, step = C.restore(ckpt_dir, like, shardings=specs)
    flat = {}

    def walk(path, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{path}/{k}", v)
        elif hasattr(node, "codes"):
            flat[path + "@codes"] = node.codes.numpy()
            flat[path + "@scale"] = node.scale.numpy()
            flat[path + "@shape"] = tuple(node.shape)
        else:
            flat[path] = node.float().numpy()
    walk("", tree)
    return step, flat


def quantized_blocks(mesh, cfg, params_np):
    """Whether the engine's per-rank quantization (``tp.quantize_blocks`` of
    this rank's raw blocks, wo and down cut along their rows) gives the
    codes and scales of the whole weights quantized and then cut, for
    int8, packed int4 and 4-bit codebook levels: {name: equal}."""
    from repro_torch.core.quantization import QuantConfig, quantize_tree
    from repro_torch.dist import sharding as shd
    from repro_torch.dist import tensor_parallel as tp
    if mesh is None:
        return {"quantized_blocks": None}
    params = params_from_numpy(params_np, mesh.device)
    out = {}
    for name, q in (("int8", QuantConfig(bits=8)),
                    ("int4", QuantConfig(bits=4)),
                    ("nf4", QuantConfig(bits=4, mode="codebook"))):
        _, lay, whole = ServeEngine.mesh_layout(
            cfg, mesh, params, n_slots=2, max_len=64, paged=False, quant=q)
        specs = tp.layout_specs(whole, shd.param_specs(whole, mesh,
                                                       lay.rules), lay)
        got = tp.quantize_blocks(tp.shard_params(params, whole, specs),
                                 specs, q)
        qwhole = quantize_tree(params, q)
        want = tp.shard_params(qwhole, qwhole, tp.layout_specs(
            qwhole, shd.param_specs(qwhole, mesh, lay.rules), lay))
        pairs = list(zip(_flat(got), _flat(want)))
        out[name] = bool(pairs) and all(
            torch.equal(a.codes, b.codes) and torch.equal(a.scale, b.scale)
            if hasattr(a, "codes") else torch.equal(a, b) for a, b in pairs)
        out[name + "_row_cut"] = lay.mlp and lay.heads
    return {"quantized_blocks": out}


def _flat(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flat(v)]
    return [tree]


def run_jobs(mesh, jobs):
    """Every ``(name, args)`` of ``jobs`` in turn: the rank body ``name`` of
    this module on ``mesh``, so that one spawn serves a test module."""
    return [globals()[name](mesh, *args) for name, args in jobs]


def seqsharded_meshes(mesh, cases, cuts):
    """{"seqsharded": {name: :func:`seqsharded` of ``cases``}}, one entry a
    ``(name, batch_axes, seq_axes, axes)`` of ``cuts``: the cuts of the
    sequence and the batch on other meshes of the same ranks."""
    return {"seqsharded": {name: seqsharded(mesh, cases, b, s, axes)
                           for name, b, s, axes in cuts}}
