"""Mamba2 (SSD) mixer: the chunkwise-parallel form for prefill and the
recurrent step for decode (PyTorch port of ``repro.models.ssm``).

The chunked SSD scan (Dao & Gu, 2024) takes per-head B/C tensors, so one
core serves Mamba2 (B/C broadcast over heads) and the xLSTM mLSTM cell
(k/q per head). State recurrence:

    h_t = a_t * h_{t-1} + x_t ⊗ B_t          h: [H, P, N]
    y_t = (h_t · C_t) + D * x_raw_t

with a_t = exp(A * dt_t) in (0, 1) and x_t pre-scaled by dt_t. Chunkwise:
an intra-chunk attention-like term plus an inter-chunk state scan. The
JAX package's einsums stay ``torch.einsum`` calls and its ``lax.scan``
over chunks a Python loop; the scan runs in f32, as there. No Pallas
kernel runs here: the projections go through the AxLLM matmul
(``core.axllm_linear.linear``) and the rest are plain PyTorch ops.

Under a tensor-parallel layout (``dist/tensor_parallel.py``) ``in_proj``
and ``out_proj`` are column-parallel where the layout cuts them, each
output gathered whole; the conv, the scan and the states run whole on
every rank.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.axllm_linear import linear
from repro_torch.dist import tensor_parallel as tp
from repro_torch.kernels import ops
from repro_torch.models import layers as L


def mixer_impl(impl: str) -> str:
    """The impl a recurrent mixer's projections take. The JAX package
    calls them without one, so under ``impl="reuse"`` they take the AxLLM
    matmul (only the attention block and the head take the reuse
    kernel), and under ``"reuse_ref"`` its plain version."""
    return ops._base_impl(impl)


def _segsum(la: torch.Tensor) -> torch.Tensor:
    """la: [..., Q] log-decays -> [..., Q, Q] cumulative segment sums,
    M[i, j] = sum_{j < t <= i} la_t for i >= j, -inf above the diagonal."""
    q = la.shape[-1]
    cs = torch.cumsum(la, dim=-1)
    m = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=la.device))
    return torch.where(mask, m, torch.full_like(m, -math.inf))


def ssd_chunked(x, log_a, b, c, chunk: int = 128):
    """Chunkwise SSD scan.

    x:     [B, S, H, P]   (dt/input-gate pre-scaled)
    log_a: [B, S, H]      log decay per step (<= 0)
    b, c:  [B, S, H, N]   per-head input/output projections
    Returns y: [B, S, H, P] and the final state h: [B, H, P, N].
    """
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    q = min(chunk, s)
    pad = (-s) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        log_a = F.pad(log_a, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
    nc = x.shape[1] // q
    xc = x.reshape(bsz, nc, q, h, p)
    lac = log_a.reshape(bsz, nc, q, h).permute(0, 1, 3, 2)     # [B,nc,H,Q]
    bc = b.reshape(bsz, nc, q, h, n)
    cc = c.reshape(bsz, nc, q, h, n)

    # 1) intra-chunk (masked attention-like term)
    lmat = torch.exp(_segsum(lac))                             # [B,nc,H,Q,Q]
    scores = torch.einsum("bcqhn,bckhn->bchqk", cc, bc)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", scores * lmat, xc)

    # 2) per-chunk end states
    acum = torch.cumsum(lac, dim=-1)                           # [B,nc,H,Q]
    decay_to_end = torch.exp(acum[..., -1:] - acum)            # [B,nc,H,Q]
    states = torch.einsum("bckhn,bckhp->bchpn",
                          bc * decay_to_end.permute(0, 1, 3, 2)[..., None],
                          xc)                                  # [B,nc,H,P,N]

    # 3) inter-chunk recurrence: the state before each chunk
    chunk_decay = torch.exp(acum[..., -1])                     # [B,nc,H]
    hstate = torch.zeros((bsz, h, p, n), dtype=x.dtype, device=x.device)
    h_prev = []
    for i in range(nc):
        h_prev.append(hstate)
        hstate = hstate * chunk_decay[:, i, :, None, None] + states[:, i]
    h_prev = torch.stack(h_prev, 1)                            # [B,nc,H,P,N]

    # 4) contribution of the carried-in state
    state_decay = torch.exp(acum)                              # [B,nc,H,Q]
    y_off = torch.einsum("bcqhn,bchpn->bcqhp", cc, h_prev) \
        * state_decay.permute(0, 1, 3, 2)[..., None]

    y = (y_diag + y_off).reshape(bsz, nc * q, h, p)
    return y[:, :s], hstate


def ssd_step(hstate, x_t, log_a_t, b_t, c_t):
    """One recurrent step. hstate: [B,H,P,N]; x_t: [B,H,P]; log_a_t:
    [B,H]; b_t, c_t: [B,H,N] -> (y_t [B,H,P], new state)."""
    a = torch.exp(log_a_t)[..., None, None]
    new = hstate * a + x_t[..., :, None] * b_t[..., None, :]
    y = torch.einsum("bhpn,bhn->bhp", new, c_t)
    return y, new


# ---------------------------------------------------------------------------
# Mamba2 mixer block
# ---------------------------------------------------------------------------

def _dims(cfg):
    di = cfg.ssm_expand * cfg.d_model
    return di, cfg.ssm_state, di // cfg.ssm_head_dim


def init_mamba2(gen, cfg, dtype=torch.float32, lead=()):
    """Random weights made from ``gen``; ``lead`` adds stacking dims."""
    d = cfg.d_model
    di, n, nh = _dims(cfg)
    dev = gen.device
    # fused in_proj: [z (di), x (di), B (n), C (n), dt (nh)]
    out_dim = 2 * di + 2 * n + nh
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = L.uniform(gen, (*lead, nh)) * (hi - lo) + lo
    a_log = torch.log(torch.linspace(1.0, 16.0, nh, device=dev))
    return {
        "ln": L.init_norm(cfg, dev, lead=lead),
        "in_proj": L.init_linear(gen, d, out_dim, dtype, lead),
        "conv_w": L.truncated_normal(gen, (*lead, cfg.ssm_conv, di + 2 * n),
                                     0.2, dtype),
        "conv_b": torch.zeros((*lead, di + 2 * n), dtype=dtype, device=dev),
        "a_log": a_log.expand(*lead, nh).contiguous(),
        "dt_bias": torch.log(torch.expm1(torch.exp(u))),
        "d_skip": torch.ones((*lead, nh), device=dev),
        "norm_y": L.init_norm(cfg, dev, lead=lead, d=di),
        "out_proj": L.init_linear(gen, di, d, dtype, lead),
    }


def _column(x, w, impl, cut: str):
    """``linear(x, w)``; when the layout cuts ``w``'s columns (flag
    ``cut``) the input enters the column block and the output is gathered
    whole."""
    lay = tp.active()
    cut = lay is not None and getattr(lay, cut)
    if cut:
        x = tp.enter(x, lay.mesh)
    y = linear(x, w, impl=mixer_impl(impl))
    if cut:
        y = tp.gather_last(y, lay.mesh)
    return y


def _mamba_preact(p, x, cfg, impl):
    di, n, nh = _dims(cfg)
    zxbcdt = _column(x, p["in_proj"], impl, "ssm_in")
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * n, nh], dim=-1)
    return z, xbc, dt, di, n, nh


def causal_conv(xbc, w, b, prev=None):
    """Depthwise causal conv. xbc: [B, S, C]; w: [K, C]; prev: [B, K-1, C].
    Products and sums in xbc's dtype (the weight cast to it), as in the
    JAX package."""
    k = w.shape[0]
    if prev is None:
        prev = torch.zeros((xbc.shape[0], k - 1, xbc.shape[-1]),
                           dtype=xbc.dtype, device=xbc.device)
    full = torch.cat([prev, xbc], dim=1)
    s = xbc.shape[1]
    out = full[:, 0:s] * w[0].to(xbc.dtype)
    for i in range(1, k):
        out = out + full[:, i:i + s] * w[i].to(xbc.dtype)
    new_prev = full[:, -(k - 1):] if k > 1 else prev
    return F.silu(out + b.to(xbc.dtype)), new_prev


def _gate_out(p, y, z, cfg, impl):
    y = L.norm_fwd(p["norm_y"], y * F.silu(z), cfg.norm_eps)
    return _column(y, p["out_proj"], impl, "ssm_out")


def mamba2_fwd(p, x, cfg, conv_state=None, *, impl: str = "auto",
               return_state: bool = False):
    """Full-sequence Mamba2 mixer. x: [B, S, d] -> [B, S, d]; with
    ``return_state`` also (conv state [B, K-1, di+2n], SSD state [B, H,
    P, N])."""
    xn = L.norm_fwd(p["ln"], x, cfg.norm_eps)
    z, xbc, dt, di, n, nh = _mamba_preact(p, xn, cfg, impl)
    xbc, new_conv = causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xi, bmat, cmat = torch.split(xbc, [di, n, n], dim=-1)
    bsz, s, _ = x.shape
    hd = cfg.ssm_head_dim
    xh = xi.reshape(bsz, s, nh, hd)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])       # [B,S,H]
    log_a = -torch.exp(p["a_log"]) * dt                         # <= 0
    xs = xh.to(torch.float32) * dt[..., None]
    bh = bmat.to(torch.float32)[:, :, None, :].expand(bsz, s, nh, n)
    ch = cmat.to(torch.float32)[:, :, None, :].expand(bsz, s, nh, n)
    y, h_t = ssd_chunked(xs, log_a, bh, ch)
    y = y + xh.to(torch.float32) * p["d_skip"][:, None]
    y = y.reshape(bsz, s, di).to(x.dtype)
    out = _gate_out(p, y, z, cfg, impl)
    if return_state:
        return out, (new_conv, h_t)
    return out


def mamba2_step(p, x, cfg, conv_state, ssm_state, *, impl: str = "auto"):
    """Single-token decode. x: [B, 1, d]; conv_state: [B, K-1, di+2n];
    ssm_state: [B, H, P, N] -> (out [B, 1, d], (new conv, new ssm))."""
    xn = L.norm_fwd(p["ln"], x, cfg.norm_eps)
    z, xbc, dt, di, n, nh = _mamba_preact(p, xn, cfg, impl)
    xbc, new_conv = causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xi, bmat, cmat = torch.split(xbc, [di, n, n], dim=-1)
    bsz = x.shape[0]
    hd = cfg.ssm_head_dim
    xh = xi[:, 0].reshape(bsz, nh, hd).to(torch.float32)
    dt = F.softplus(dt[:, 0].to(torch.float32) + p["dt_bias"])
    log_a = -torch.exp(p["a_log"]) * dt                         # [B,H]
    xs = xh * dt[..., None]
    bh = bmat[:, 0].to(torch.float32)[:, None, :].expand(bsz, nh, n)
    ch = cmat[:, 0].to(torch.float32)[:, None, :].expand(bsz, nh, n)
    y, new_ssm = ssd_step(ssm_state, xs, log_a, bh, ch)
    y = y + xh * p["d_skip"][:, None]
    y = y.reshape(bsz, 1, di).to(x.dtype)
    return _gate_out(p, y, z, cfg, impl), (new_conv, new_ssm)


def init_mamba_state(cfg, batch: int, dtype=torch.float32, device="cuda",
                     lead=()):
    """(conv state [*lead, B, K-1, di+2n] in ``dtype``, SSD state [*lead,
    B, H, P, N] f32), zeros."""
    di, n, nh = _dims(cfg)
    conv = torch.zeros((*lead, batch, cfg.ssm_conv - 1, di + 2 * n),
                       dtype=dtype, device=device)
    ssm = torch.zeros((*lead, batch, nh, cfg.ssm_head_dim, n),
                      dtype=torch.float32, device=device)
    return conv, ssm
