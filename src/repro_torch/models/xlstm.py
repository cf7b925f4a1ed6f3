"""xLSTM-1.3B: alternating mLSTM / sLSTM blocks (arXiv:2405.04517), the
``ssm`` family (PyTorch port of ``repro.models.xlstm``).

Structure xLSTM[7:1]: every ``cfg.xlstm_slstm_every``-th block is an
sLSTM, the rest are mLSTM. Layers form super-blocks of (every-1 mLSTM + 1
sLSTM); mLSTM parameters and states are stacked ``[n_super, m_per, ...]``,
sLSTM ones ``[n_super, ...]``, and nested Python loops take the place of
the JAX package's two nested scans.

mLSTM (matrix memory): C_t = f_t C_{t-1} + i_t k_t v_t^T, n_t = f_t n_{t-1}
+ i_t k_t, h = (C_t q_t) / max(|n_t . q_t|, 1). Prefill reuses the
chunkwise SSD core (per-head B=k, C=q, decay=log sigmoid(f)) with v
augmented by a ones-column, so the normalizer rides along as an extra
value channel. Decode runs the exact stabilized recurrence (running max
m_t); the two agree in exact arithmetic. The reference rounds them apart
in two places, and so does the port: the step path divides k by sqrt(hd)
in the activation's dtype and the chunkwise path in f32, and the step
path floors the normalizer at exp(-m). The exponential input gate is
clamped (log i <= EXP_CLAMP) in both.

sLSTM (scalar memory): recurrent gates with block-diagonal per-head R
matrices, stabilized exponential gating, then the paper's
post-up-projection GeGLU FFN (factor 4/3); a Python loop over positions.

Prefill and decode write the cache's stacked state in place.

Under a tensor-parallel layout that cuts the mLSTM projections
(``dist/tensor_parallel.py``, which lists every leaf as cut or whole and
why), ``up`` is column-parallel and its output gathered whole, and
``down`` row-parallel on the rank's slice of the normed output, with one
all-reduce; the conv, q/k, the gates, the cells and every state run whole
on each rank. In the training step both blocks' inputs enter them (their
gradients summed over the ranks), so every leaf read whole gets its whole
gradient.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.axllm_linear import concat_weights, linear
from repro_torch.dist import tensor_parallel as tp
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.transformer import layer_slice, param_dtype

EXP_CLAMP = 10.0


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------

def _mlstm_dims(cfg):
    di = 2 * cfg.d_model                 # up-projection factor 2
    nh = cfg.n_heads
    return di, nh, di // nh


def init_mlstm(gen, cfg, dtype=torch.float32, lead=()):
    d = cfg.d_model
    di, nh, _ = _mlstm_dims(cfg)
    dev = gen.device
    if_bias = torch.cat([torch.zeros(nh, device=dev),
                         torch.linspace(3.0, 6.0, nh, device=dev)])
    return {
        "ln": L.init_norm(cfg, dev, lead=lead),
        "up": L.init_linear(gen, d, 2 * di, dtype, lead),   # [x_in, z-gate]
        "conv_w": L.truncated_normal(gen, (*lead, cfg.ssm_conv, di), 0.2,
                                     dtype),
        "conv_b": torch.zeros((*lead, di), dtype=dtype, device=dev),
        "wq": L.init_linear(gen, di, di, dtype, lead),
        "wk": L.init_linear(gen, di, di, dtype, lead),
        "wif": L.init_linear(gen, di, 2 * nh, torch.float32, lead),
        "if_bias": if_bias.expand(*lead, 2 * nh).contiguous(),
        "norm_h": L.init_norm(cfg, dev, lead=lead, d=di),
        "down": L.init_linear(gen, di, d, dtype, lead),
    }


def _mlstm_gates(p, xc, nh, impl):
    raw = linear(xc.to(torch.float32), p["wif"], impl=impl,
                 out_dtype=torch.float32) + p["if_bias"]
    log_i = torch.clamp(raw[..., :nh], max=EXP_CLAMP)   # exponential gate
    log_f = F.logsigmoid(raw[..., nh:])                  # sigmoid forget
    return log_i, log_f


def _mlstm_qk(p, xc, impl):
    """q/k projections over the conv stream; the fused wqk when deployed
    so."""
    if "wqk" in p:
        return torch.chunk(linear(xc, p["wqk"], impl=impl), 2, dim=-1)
    return linear(xc, p["wq"], impl=impl), linear(xc, p["wk"], impl=impl)


def _mlstm_up(p, xn, impl):
    """(x_in, z): the up-projection's halves, gathered whole when the
    layout cuts its columns (the input entering the column block)."""
    lay = tp.active()
    cut = lay is not None and lay.mlp
    if cut:
        xn = tp.enter(xn, lay.mesh)
    y = linear(xn, p["up"], impl=impl)
    if cut:
        y = tp.gather_last(y, lay.mesh)
    return torch.chunk(y, 2, dim=-1)


def _mlstm_out(p, y, z, cfg, impl):
    y = L.norm_fwd(p["norm_h"], y, cfg.norm_eps) * F.silu(z)
    lay = tp.active()
    if lay is None or not lay.mlp:
        return linear(y, p["down"], impl=impl)
    # the whole normed output enters the row block: under autograd the
    # rank's slice has a gradient only on its rows, summed over the ranks
    y = tp.enter(y, lay.mesh)
    n = y.shape[-1] // lay.size
    return L.row_parallel(y[..., lay.rank * n:(lay.rank + 1) * n]
                          .contiguous(), p["down"], impl, lay)


def mlstm_fwd(p, x, cfg, state=None, *, impl: str = "auto",
              return_state: bool = False):
    """x: [B, S, d] -> [B, S, d] (chunkwise-parallel form). With
    ``return_state`` also the step path's state (conv, C_aug, m)."""
    b, s, _ = x.shape
    di, nh, hd = _mlstm_dims(cfg)
    mi = S.mixer_impl(impl)
    xn = L.norm_fwd(p["ln"], x, cfg.norm_eps)
    xin, z = _mlstm_up(p, xn, mi)
    conv_prev = state[0] if state is not None else None
    xc, new_conv = S.causal_conv(xin, p["conv_w"], p["conv_b"], conv_prev)
    q, k = _mlstm_qk(p, xc, mi)
    q = q.reshape(b, s, nh, hd)
    k = k.reshape(b, s, nh, hd)
    v = xin.reshape(b, s, nh, hd)
    log_i, log_f = _mlstm_gates(p, xc, nh, mi)          # [B,S,H]

    # v augmented with ones so the normalizer n = sum decayed i*k rides along
    gate = torch.exp(log_i)[..., None]
    v_aug = torch.cat([v.to(torch.float32) * gate, gate], dim=-1)
    kf = k.to(torch.float32) / (hd ** 0.5)
    qf = q.to(torch.float32)
    y_aug, h_t = S.ssd_chunked(v_aug, log_f, kf, qf)    # [B,S,H,hd+1]
    y, nq = y_aug[..., :hd], y_aug[..., hd:]
    y = y / torch.clamp(nq.abs(), min=1.0)
    y = y.reshape(b, s, di).to(x.dtype)
    out = _mlstm_out(p, y, z, cfg, mi)
    if return_state:
        # the SSD state is [B,H,P=v,N=k]; the step path keeps [B,H,k,v]
        # with the stabilizer m (relative, so m=0 is valid for a fresh
        # conversion)
        c_aug = h_t.transpose(-1, -2)
        return out, (new_conv, c_aug,
                     torch.zeros((b, nh), dtype=torch.float32,
                                 device=x.device))
    return out


def mlstm_step(p, x, cfg, state, *, impl: str = "auto"):
    """The exact stabilized recurrence for one token. state = (conv, C_aug,
    m) with C_aug: [B, H, hd, hd+1] holding [C | n] columns, scaled by
    exp(-m). Returns (out [B, 1, d], new state)."""
    b = x.shape[0]
    di, nh, hd = _mlstm_dims(cfg)
    mi = S.mixer_impl(impl)
    conv_prev, c_aug, m = state
    xn = L.norm_fwd(p["ln"], x, cfg.norm_eps)
    xin, z = _mlstm_up(p, xn, mi)
    xc, new_conv = S.causal_conv(xin, p["conv_w"], p["conv_b"], conv_prev)
    q, k = _mlstm_qk(p, xc, mi)
    q = q.reshape(b, nh, hd)
    k = k.reshape(b, nh, hd) / (hd ** 0.5)     # in the activation's dtype
    v = xin.reshape(b, nh, hd)
    log_i, log_f = _mlstm_gates(p, xc[:, 0], nh, mi)    # [B,H]

    m_new = torch.maximum(log_f + m, log_i)
    i_s = torch.exp(log_i - m_new)
    f_s = torch.exp(log_f + m - m_new)
    v_aug = torch.cat([v.to(torch.float32),
                       torch.ones((b, nh, 1), dtype=torch.float32,
                                  device=x.device)], dim=-1)
    outer = k.to(torch.float32)[..., :, None] * v_aug[..., None, :]
    c_new = c_aug * f_s[..., None, None] + outer * i_s[..., None, None]
    y_aug = torch.einsum("bhkv,bhk->bhv", c_new, q.to(torch.float32))
    y, nq = y_aug[..., :hd], y_aug[..., hd]
    # stabilized normalizer: states carry exp(-m), so the floor is exp(-m)
    y = y / torch.maximum(nq.abs(), torch.exp(-m_new))[..., None]
    y = y.reshape(b, 1, di).to(x.dtype)
    return _mlstm_out(p, y, z, cfg, mi), (new_conv, c_new, m_new)


def init_mlstm_state(cfg, batch: int, dtype=torch.float32, device="cuda",
                     lead=()):
    """(conv [*lead, B, K-1, di] in ``dtype``, C_aug [*lead, B, H, hd,
    hd+1] f32, m [*lead, B, H] f32), zeros."""
    di, nh, hd = _mlstm_dims(cfg)
    conv = torch.zeros((*lead, batch, cfg.ssm_conv - 1, di), dtype=dtype,
                       device=device)
    c_aug = torch.zeros((*lead, batch, nh, hd, hd + 1), dtype=torch.float32,
                        device=device)
    m = torch.zeros((*lead, batch, nh), dtype=torch.float32, device=device)
    return conv, c_aug, m


# ---------------------------------------------------------------------------
# sLSTM block
# ---------------------------------------------------------------------------

def init_slstm(gen, cfg, dtype=torch.float32, lead=()):
    d = cfg.d_model
    nh = cfg.n_heads
    hd = d // nh
    dff = ((4 * d // 3) + 63) // 64 * 64     # paper: GeGLU factor 4/3
    dev = gen.device
    gate_bias = torch.cat([torch.zeros(d, device=dev),        # i
                           torch.ones(d, device=dev),         # f
                           torch.zeros(2 * d, device=dev)])   # z, o
    return {
        "ln": L.init_norm(cfg, dev, lead=lead),
        "wx": L.init_linear(gen, d, 4 * d, dtype, lead),       # i,f,z,o gates
        "r": L.truncated_normal(gen, (*lead, nh, hd, 4 * hd), hd ** -0.5,
                                dtype),
        "gate_bias": gate_bias.expand(*lead, 4 * d).contiguous(),
        "norm_h": L.init_norm(cfg, dev, lead=lead),
        "ln_ff": L.init_norm(cfg, dev, lead=lead),
        "ff_gate": L.init_linear(gen, d, dff, dtype, lead),
        "ff_up": L.init_linear(gen, d, dff, dtype, lead),
        "ff_down": L.init_linear(gen, dff, d, dtype, lead),
    }


def _slstm_cell(p, gx_t, state, nh, hd):
    """One sLSTM step. gx_t: [B, 4d] pre-activations from the input
    path."""
    c, n, h, m = state                                  # [B, d] each
    b = gx_t.shape[0]
    d = nh * hd
    hh = h.reshape(b, nh, hd)
    gr = torch.einsum("bhk,hkj->bhj", hh, p["r"].to(h.dtype))   # [B,H,4hd]
    gr = gr.reshape(b, nh, 4, hd).transpose(1, 2).reshape(b, 4 * d)
    g = gx_t + gr + p["gate_bias"]
    gi, gf, gz, go = torch.chunk(g, 4, dim=-1)
    log_i = torch.clamp(gi, max=EXP_CLAMP)
    log_f = F.logsigmoid(gf)
    m_new = torch.maximum(log_f + m, log_i)
    i_s = torch.exp(log_i - m_new)
    f_s = torch.exp(log_f + m - m_new)
    c_new = f_s * c + i_s * torch.tanh(gz)
    n_new = f_s * n + i_s
    h_new = torch.sigmoid(go) * c_new / torch.clamp(n_new, min=1e-6)
    return (c_new, n_new, h_new, m_new), h_new


def slstm_fwd(p, x, cfg, state=None, *, impl: str = "auto",
              return_state: bool = False):
    """x: [B, S, d] -> [B, S, d]: the recurrence over positions, then the
    GeGLU FFN. With ``return_state`` also the state (c, n, h, m)."""
    b, s, d = x.shape
    nh = cfg.n_heads
    hd = d // nh
    mi = S.mixer_impl(impl)
    xn = L.norm_fwd(p["ln"], x, cfg.norm_eps)
    gx = linear(xn.to(torch.float32), p["wx"], impl=mi,
                out_dtype=torch.float32)
    if state is None:
        state = init_slstm_state(cfg, b, x.device)
    hs = []
    for t in range(s):
        state, h_t = _slstm_cell(p, gx[:, t], state, nh, hd)
        hs.append(h_t)
    y = torch.stack(hs, 1).to(x.dtype)                  # [B, S, d]
    y = L.norm_fwd(p["norm_h"], y, cfg.norm_eps)
    x = x + y
    hn = L.norm_fwd(p["ln_ff"], x, cfg.norm_eps)
    if "ff_gateup" in p:   # fused GeGLU: one [d, 2·dff] activation pass
        fg, fu = torch.chunk(linear(hn, p["ff_gateup"], impl=mi), 2, dim=-1)
    else:
        fg = linear(hn, p["ff_gate"], impl=mi)
        fu = linear(hn, p["ff_up"], impl=mi)
    ff = F.gelu(fg, approximate="tanh") * fu
    x = x + linear(ff, p["ff_down"], impl=mi)
    if return_state:
        return x, state
    return x


def slstm_step(p, x, cfg, state, *, impl: str = "auto"):
    return slstm_fwd(p, x, cfg, state, impl=impl, return_state=True)


def init_slstm_state(cfg, batch: int, device="cuda", lead=()):
    """(c, n, h, m), each [*lead, B, d] f32 zeros (four tensors: the
    cache writes them in place)."""
    return tuple(torch.zeros((*lead, batch, cfg.d_model),
                             dtype=torch.float32, device=device)
                 for _ in range(4))


# ---------------------------------------------------------------------------
# Full model: the super-block stack
# ---------------------------------------------------------------------------

def _superblock_counts(cfg) -> Tuple[int, int]:
    """(n_super, m_per_super)."""
    if cfg.xlstm_slstm_every:
        every = cfg.xlstm_slstm_every
        if cfg.n_layers % every:
            raise ValueError(f"n_layers={cfg.n_layers} must divide into "
                             f"superblocks of {every}")
        return cfg.n_layers // every, every - 1
    return 1, cfg.n_layers


def init_params(cfg, seed: int = 0, device="cuda"):
    """Random weights made from ``seed`` on ``device`` (on "meta": their
    shapes and dtypes only)."""
    dtype = param_dtype(cfg)
    gen = L.generator(device, seed)
    n_super, m_per = _superblock_counts(cfg)
    return {
        "embed": L.init_embed(gen, cfg, dtype),
        "mlstm": init_mlstm(gen, cfg, dtype, (n_super, m_per)),
        "slstm": init_slstm(gen, cfg, dtype, (n_super,)),
        "final_norm": L.init_norm(cfg, device),
    }


def fuse_params(params, cfg):
    """Deploy-time fused-projection rewrite: mLSTM q/k run over the same
    conv stream and fuse into wqk; the sLSTM GeGLU gate/up fuse into
    ff_gateup. (The mLSTM up-projection is fused at init already.) Apply
    after ``deploy_quantize``, so QTensors concatenate exactly."""
    mlstm = dict(params["mlstm"])
    if "wqk" not in mlstm and "wq" in mlstm:
        mlstm["wqk"] = concat_weights([mlstm.pop("wq"), mlstm.pop("wk")])
    slstm = dict(params["slstm"])
    if "ff_gateup" not in slstm and "ff_gate" in slstm:
        slstm["ff_gateup"] = concat_weights(
            [slstm.pop("ff_gate"), slstm.pop("ff_up")])
    return {**params, "mlstm": mlstm, "slstm": slstm}


def _embed(params, tokens, cfg):
    return L.embed_fwd(params["embed"], tokens).to(param_dtype(cfg))


def forward(params, tokens, cfg, impl: str = "auto"):
    """tokens: [B, S] -> logits [B, S, V_padded]."""
    n_super, m_per = _superblock_counts(cfg)
    x = _embed(params, tokens, cfg)
    for si in range(n_super):
        mp = layer_slice(params["mlstm"], si)
        for j in range(m_per):     # rematerialized as in the JAX package
            x = L.remat(cfg, lambda p, x: x + mlstm_fwd(p, x, cfg, impl=impl),
                        layer_slice(mp, j), x)
        x = slstm_fwd(layer_slice(params["slstm"], si), x, cfg, impl=impl)
    x = L.norm_fwd(params["final_norm"], x, cfg.norm_eps)
    return L.head_fwd(params["embed"], x, cfg, impl=impl)


def loss_fn(params, batch, cfg, impl: str = "auto"):
    """Mean cross-entropy of ``forward`` on ``batch["tokens"]`` against
    ``batch["targets"]``."""
    logits = forward(params, batch["tokens"], cfg, impl=impl)
    return L.cross_entropy(logits, batch["targets"], cfg.vocab_size)


def init_cache(cfg, batch: int, max_len: int = 0, device="cuda"):
    """Recurrent state only: O(1) in sequence length, so ``max_len`` is
    unused."""
    n_super, m_per = _superblock_counts(cfg)
    return {"mlstm": init_mlstm_state(cfg, batch, param_dtype(cfg), device,
                                      (n_super, m_per)),
            "slstm": init_slstm_state(cfg, batch, device, (n_super,)),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def cache_spec(cfg):
    """Batch axis per cache leaf. mLSTM states are stacked
    [n_super, m_per, B, ...] (batch axis 2), sLSTM [n_super, B, ...]
    (axis 1), pos [B] (axis 0)."""
    return {
        "mlstm": (2, 2, 2),        # (conv, c_aug, m)
        "slstm": (1, 1, 1, 1),     # (c, n, h, m)
        "pos": 0,
    }


def _put(stack, idx, new):
    """Write each state tensor of ``new`` into entry ``idx`` of the
    matching stacked cache tensor, in place."""
    for buf, t in zip(stack, new):
        buf[idx] = t


def decode_step(params, token, cfg, cache, impl: str = "auto"):
    """token: [B] int -> (logits [B, V], cache advanced by one in place)."""
    n_super, m_per = _superblock_counts(cfg)
    x = _embed(params, token[:, None], cfg)
    for si in range(n_super):
        mp = layer_slice(params["mlstm"], si)
        for j in range(m_per):
            st = tuple(t[si, j] for t in cache["mlstm"])
            out, new = mlstm_step(layer_slice(mp, j), x, cfg, st, impl=impl)
            _put(cache["mlstm"], (si, j), new)
            x = x + out
        st = tuple(t[si] for t in cache["slstm"])
        x, new = slstm_step(layer_slice(params["slstm"], si), x, cfg, st,
                            impl=impl)
        _put(cache["slstm"], si, new)
    x = L.norm_fwd(params["final_norm"], x, cfg.norm_eps)
    logits = L.head_fwd(params["embed"], x, cfg, impl=impl)[:, 0]
    cache["pos"] = cache["pos"] + 1
    return logits, cache


def prefill(params, tokens, cfg, cache, impl: str = "auto", lengths=None,
            all_positions: bool = False):
    """Parallel prefill: chunkwise mLSTM and the sequential sLSTM over the
    prompt, writing every block's recurrent state into ``cache`` in place
    for the decode that follows. tokens: [B, S] -> (last-position logits
    [B, V], cache); ``all_positions`` returns [B, S, V], the logits of
    every position (a teacher-forced pass, ``serve/token_gate.py``).

    Recurrent state folds every input position in, so right-padding would
    corrupt it: ragged (``lengths``) prefill is refused, and the serve
    engine splits mixed-length waves into equal-length sub-batches."""
    if lengths is not None:
        raise NotImplementedError(
            "xlstm prefill is recurrent: padded positions would enter the "
            "state. Batch equal-length prompts only (ragged_prefill=False).")
    n_super, m_per = _superblock_counts(cfg)
    b, s = tokens.shape
    x = _embed(params, tokens, cfg)
    for si in range(n_super):
        mp = layer_slice(params["mlstm"], si)
        for j in range(m_per):
            out, st = mlstm_fwd(layer_slice(mp, j), x, cfg, impl=impl,
                                return_state=True)
            _put(cache["mlstm"], (si, j), st)
            x = x + out
        x, st = slstm_fwd(layer_slice(params["slstm"], si), x, cfg,
                          impl=impl, return_state=True)
        _put(cache["slstm"], si, st)
    if not all_positions:
        x = x[:, -1:]
    x = L.norm_fwd(params["final_norm"], x, cfg.norm_eps)
    logits = L.head_fwd(params["embed"], x, cfg, impl=impl)
    cache["pos"] = torch.full((b,), s, dtype=torch.int32, device=x.device)
    return (logits if all_positions else logits[:, 0]), cache
