"""Quantization substrate for AxLLM computation reuse (PyTorch port).

A quantized weight is ``value = codebook[code] * scale``; for symmetric
("affine") quantization the codebook is the identity ramp, so
``value = code / qmax * scale``. Codes are int8, or int4 bit-packed two per
byte (low nibble = even index). Scales are per-tensor, per-channel (along
the output dim of an ``[in, out]`` weight) or per-group (``group_size``
rows of the input dim). The arithmetic follows the JAX package's
``core/quantization.py`` operation for operation, so codes agree byte for
byte and scales exactly (``torch.round`` and ``jnp.round`` both round half
to even).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Configuration of the quantized representation.

    bits: 8 or 4. mode: "affine" (uniform levels) or "codebook" (explicit
    ``2**bits``-entry table; NF4 levels at 4 bits). granularity:
    "per_tensor" | "per_channel" | "per_group" (``group_size`` input rows
    per scale). pack: bit-pack int4 codes two per byte (uint8 storage).
    """

    bits: int = 8
    mode: str = "affine"
    granularity: str = "per_channel"
    group_size: int = 128
    pack: bool = True

    def __post_init__(self):
        if self.bits not in (4, 8):
            raise ValueError(f"bits must be 4 or 8, got {self.bits}")
        if self.mode not in ("affine", "codebook"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.granularity not in ("per_tensor", "per_channel", "per_group"):
            raise ValueError(f"unknown granularity {self.granularity!r}")

    @property
    def qmax(self) -> int:
        return (1 << (self.bits - 1)) - 1  # 127 for int8, 7 for int4


@dataclasses.dataclass
class QTensor:
    """Quantized tensor: ``deq = codebook[codes] * scale`` (or affine).

    codes:    int8 [*leading, in, out] (uint8 [*, in, out//2] when packed)
    scale:    f32, per_tensor [*, 1, 1] | per_channel [*, 1, out] |
              per_group [*, in//g, 1, out]
    codebook: always None; the table is a function of (mode, bits), see
              :func:`resolve_codebook`.
    shape:    logical (unpacked) shape.
    kernel_scale: f32 [*, G, out] (G = in//g per_group, else 1) with the
              affine 1/qmax folded in: the form the CUDA kernels take.
              Derived from ``scale`` once, when the QTensor is made.
    """

    codes: torch.Tensor
    scale: torch.Tensor
    codebook: Optional[torch.Tensor]
    bits: int
    mode: str
    granularity: str
    group_size: int
    packed: bool
    shape: tuple
    kernel_scale: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.kernel_scale is None:
            self.kernel_scale = _fold_scale(self)

    def index(self, i: int) -> "QTensor":
        """The QTensor of entry ``i`` of the leading (stacked-layer) dim."""
        return dataclasses.replace(self, codes=self.codes[i],
                                   scale=self.scale[i], shape=self.shape[1:],
                                   kernel_scale=self.kernel_scale[i])

    def to(self, device) -> "QTensor":
        return dataclasses.replace(self, codes=self.codes.to(device),
                                   scale=self.scale.to(device),
                                   kernel_scale=self.kernel_scale.to(device))


def _fold_scale(qt: QTensor) -> torch.Tensor:
    """``qt.scale`` as [*, G, out] f32 with the affine 1/qmax folded in."""
    *lead, _, n = qt.shape
    if qt.granularity == "per_group":
        s = qt.scale.reshape(*lead, -1, n)
    else:   # [*, 1, out], or [*, 1, 1] per tensor
        s = qt.scale.expand(*lead, 1, n)
    if qt.mode == "affine":
        s = s / ((1 << (qt.bits - 1)) - 1)
    return s.to(torch.float32).contiguous()


# ---------------------------------------------------------------------------
# Codebooks
# ---------------------------------------------------------------------------

def identity_codebook(bits: int) -> torch.Tensor:
    """Uniform levels code/qmax for code in [-2^(b-1), 2^(b-1)-1]."""
    qmax = (1 << (bits - 1)) - 1
    lo = -(1 << (bits - 1))
    return torch.arange(lo, qmax + 1, dtype=torch.float32) / qmax


def nf4_codebook() -> torch.Tensor:
    """NF4-style 16-level codebook: N(0,1) quantiles normalized to [-1, 1]."""
    from scipy import stats

    neg = stats.norm.ppf((np.arange(8) + 0.5) / 16.0)      # 8 negative levels
    pos = -neg[::-1][:7]                                    # 7 positive levels
    levels = np.concatenate([neg, [0.0], pos])              # 16 total, has 0
    levels = levels / np.max(np.abs(levels))
    if levels.shape != (16,) or not np.all(np.isfinite(levels)):
        raise RuntimeError("nf4 codebook construction failed")
    return torch.from_numpy(np.sort(levels).astype(np.float32))


def make_codebook(cfg: QuantConfig) -> Optional[torch.Tensor]:
    if cfg.mode == "affine":
        return None
    return nf4_codebook() if cfg.bits == 4 else identity_codebook(8)


@functools.lru_cache(maxsize=None)
def _codebook_on(bits: int, device: str) -> torch.Tensor:
    # one constant table per (bits, device): the decode loop reads it for
    # every projection, so it is built and copied to the card once
    cb = nf4_codebook() if bits == 4 else identity_codebook(8)
    return cb.to(device)


def resolve_codebook(qt: QTensor) -> Optional[torch.Tensor]:
    """The codebook of ``qt`` on the device of its codes (None for affine)."""
    if qt.mode == "affine":
        return None
    return _codebook_on(qt.bits, str(qt.codes.device))


# ---------------------------------------------------------------------------
# int4 bit packing (two codes per byte; low nibble = even index)
# ---------------------------------------------------------------------------

def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """[..., out] int8 in [-8, 7] -> [..., out//2] uint8."""
    if codes.shape[-1] % 2:
        raise ValueError("int4 packing requires an even trailing dim")
    u = (codes.to(torch.int32) & 0xF).to(torch.uint8)
    lo, hi = u[..., 0::2], u[..., 1::2]
    return lo | (hi << 4)


def unpack_int4(packed: torch.Tensor, out_dim: int) -> torch.Tensor:
    """[..., out//2] uint8 -> [..., out] int8 in [-8, 7]."""
    lo = (packed & 0xF).to(torch.int8)
    hi = ((packed >> 4) & 0xF).to(torch.int8)
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    out = torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], -1)
    return out[..., :out_dim]


# ---------------------------------------------------------------------------
# Quantize / dequantize
# ---------------------------------------------------------------------------

def quantize(w: torch.Tensor, cfg: QuantConfig) -> QTensor:
    """Quantize a weight of shape [..., in, out] per ``cfg``."""
    w = w.to(torch.float32)
    if w.ndim < 2:
        raise ValueError("quantize expects [..., in, out]")
    eps = 1e-8
    if cfg.granularity == "per_group":
        *lead, n_in, n_out = w.shape
        g = cfg.group_size
        if n_in % g:
            raise ValueError(f"in dim {n_in} not divisible by group {g}")
        wg = w.reshape(*lead, n_in // g, g, n_out)
        scale = torch.clamp(wg.abs().amax(dim=-2, keepdim=True), min=eps)
        normed = wg / scale                                  # [*,G,g,out]
    else:
        nd = w.ndim
        dims = (nd - 2, nd - 1) if cfg.granularity == "per_tensor" \
            else (nd - 2,)
        scale = torch.clamp(w.abs().amax(dim=dims, keepdim=True), min=eps)
        normed = w / scale

    if cfg.mode == "codebook" and cfg.bits == 4:
        cb = make_codebook(cfg).to(normed.device)  # nearest of 16 levels
        idx = torch.argmin((normed[..., None] - cb).abs(), dim=-1)
        codes = (idx - 8).to(torch.int8)         # recenter to [-8, 7]
    else:
        # affine, or the 8-bit identity codebook (same codes, explicit table)
        codes = torch.clamp(torch.round(normed * cfg.qmax), -cfg.qmax,
                            cfg.qmax).to(torch.int8)
    if cfg.granularity == "per_group":
        codes = codes.reshape(*w.shape)

    packed = cfg.bits == 4 and cfg.pack
    if packed:
        codes = pack_int4(codes)
    return QTensor(codes=codes, scale=scale, codebook=None, bits=cfg.bits,
                   mode=cfg.mode, granularity=cfg.granularity,
                   group_size=cfg.group_size, packed=packed,
                   shape=tuple(w.shape))


def decode_codes(qt: QTensor) -> torch.Tensor:
    """Unpacked signed integer codes with qt.shape."""
    if qt.packed:
        return unpack_int4(qt.codes, qt.shape[-1])
    return qt.codes


def lookup(qt: QTensor, codes: torch.Tensor) -> torch.Tensor:
    """codebook[codes] in normalized space (``codes / qmax`` for affine)."""
    if qt.mode == "affine":
        qmax = (1 << (qt.bits - 1)) - 1
        return codes.to(torch.float32) / qmax
    cb = resolve_codebook(qt)
    offset = 1 << (qt.bits - 1)
    return cb[codes.to(torch.int64) + offset]


def dequantize(qt: QTensor, dtype=torch.float32) -> torch.Tensor:
    normed = lookup(qt, decode_codes(qt))
    if qt.granularity == "per_group":
        *lead, n_in, n_out = qt.shape
        g = qt.group_size
        normed = normed.reshape(*lead, n_in // g, g, n_out)
        w = (normed * qt.scale).reshape(*qt.shape)
    else:
        w = normed * qt.scale
    return w.to(dtype)


# ---------------------------------------------------------------------------
# Parameter-tree conversion (deploy time)
# ---------------------------------------------------------------------------

_EXCLUDE_PREFIXES = (
    # norms and their leaves
    "ln", "norm", "scale", "bias",
    # non-matmul surfaces: gathers, routing, convs, recurrences
    "embedding", "router", "lora_", "conv", "a_log", "dt_bias",
    "d_skip", "gate_bias", "if_bias", "pos_embed",
)
_EXCLUDE_EXACT = ("r",)  # sLSTM per-head recurrent stack


def _is_weight_matrix(path: str, x) -> bool:
    """True for 2-D (or stacked 3-D) matrices consumed by vector-matrix
    products. Norm scales, biases, embeddings, routers, convs and per-head
    recurrent matrices stay full precision."""
    if not hasattr(x, "ndim") or x.ndim < 2:
        return False
    for c in (c for c in path.split("/") if c):
        if c in _EXCLUDE_EXACT:
            return False
        if any(p in c for p in _EXCLUDE_PREFIXES):
            return False
    return True


def quantize_tree(params, cfg: QuantConfig, predicate=_is_weight_matrix):
    """Quantize every weight matrix in a nested-dict parameter tree."""

    def walk(prefix, node):
        if isinstance(node, dict):
            return {k: walk(f"{prefix}/{k}", v) for k, v in node.items()}
        if predicate(prefix, node):
            return quantize(node, cfg)
        return node

    return walk("", params)
