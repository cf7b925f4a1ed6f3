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
import math
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

def quantize(w: torch.Tensor, cfg: QuantConfig,
             amax: Optional[torch.Tensor] = None) -> QTensor:
    """Quantize a weight of shape [..., in, out] per ``cfg``.

    A stacked weight is quantized one leading entry at a time (every scale
    reduces within one matrix, so the result is the same): the f32
    temporaries of a whole stacked leaf, such as a full-width expert bank
    of 2.2 G weights, would not fit on the card beside the model.

    ``amax`` (per channel or per tensor: the float32 max of ``|w|`` over
    the scale's reduced dims, keepdim) replaces the max ``w`` itself
    gives: a block of a weight cut along its rows quantizes with the whole
    weight's scale."""
    if w.ndim < 2:
        raise ValueError("quantize expects [..., in, out]")
    if w.ndim > 2:
        parts = [quantize(w[i], cfg, None if amax is None else amax[i])
                 for i in range(w.shape[0])]
        return dataclasses.replace(
            parts[0], codes=torch.stack([q.codes for q in parts]),
            scale=torch.stack([q.scale for q in parts]),
            shape=tuple(w.shape),
            kernel_scale=torch.stack([q.kernel_scale for q in parts]))
    w = w.to(torch.float32)
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
        if amax is None:
            amax = w.abs().amax(dim=dims, keepdim=True)
        scale = torch.clamp(amax, min=eps)
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
# Cutting (tensor-parallel blocks)
# ---------------------------------------------------------------------------

def qslice(qt: QTensor, codes: torch.Tensor, scale: torch.Tensor) -> QTensor:
    """The QTensor of a block of ``qt``: ``codes`` and ``scale`` are the
    block's children, cut out of ``qt``'s (``dist.sharding.local_shard``).

    The logical shape follows the codes (packed int4 codes hold two columns
    a byte, so they are cut in whole bytes). A per-channel scale must have
    been cut with its output columns and a per-group scale's group rows with
    the codes' input rows; a block whose scale does not cover its codes
    raises, rather than scale a column or a group by another's value. The
    codebook stays whole and the kernel scale is derived again."""
    n = codes.shape[-1] * (2 if qt.packed else 1)
    shape = (*codes.shape[:-1], n)
    if qt.granularity == "per_group":
        ok = (scale.shape[-1] == n
              and scale.shape[-3] * qt.group_size == shape[-2])
    elif qt.granularity == "per_channel":
        ok = scale.shape[-1] == n
    else:
        ok = scale.shape[-1] == 1
    if not ok or scale.shape[:-3 if qt.granularity == "per_group" else -2] \
            != codes.shape[:-2]:
        raise ValueError(
            f"a {qt.granularity} scale {tuple(scale.shape)} does not cover "
            f"codes {tuple(codes.shape)} (logical {shape})")
    return dataclasses.replace(qt, codes=codes, scale=scale, shape=shape,
                               kernel_scale=None)


# ---------------------------------------------------------------------------
# Concatenation (fused-projection support)
# ---------------------------------------------------------------------------

def qconcat(qts) -> QTensor:
    """Concatenate QTensors along the output (N) axis without requantizing.

    The substrate of the fused wqkv / gate_up projections: one ``[K,
    N1+N2+...]`` matmul replaces several ``[K, Ni]`` matmuls over the same
    activations. Per-channel scales travel with their columns, so
    ``dequantize(qconcat(a, b)) == concat(dequantize(a), dequantize(b))``
    bit for bit.

    Inputs share K (and any leading stacked dims), bits, mode and packing,
    and per_group inputs one ``group_size``. per_tensor and per_channel
    inputs mix: a per_tensor scale broadcasts over its columns and the
    result is per_channel. per_group inputs must all be per_group. The
    result's ``kernel_scale`` is derived again from its own scale.
    """
    qts = list(qts)
    if len(qts) < 2:
        raise ValueError("qconcat needs at least two QTensors")
    q0 = qts[0]
    for qt in qts[1:]:
        if not isinstance(qt, QTensor):
            raise TypeError(f"qconcat expects QTensors, got {type(qt)}")
        if (qt.bits, qt.mode, qt.packed) != (q0.bits, q0.mode, q0.packed):
            raise ValueError(
                f"qconcat mismatch: ({qt.bits},{qt.mode},{qt.packed}) vs "
                f"({q0.bits},{q0.mode},{q0.packed})")
        if qt.shape[:-1] != q0.shape[:-1]:
            raise ValueError(f"qconcat K/leading mismatch: {qt.shape} vs "
                             f"{q0.shape}")
    grans = {qt.granularity for qt in qts}
    if "per_group" in grans:
        if grans != {"per_group"}:
            raise ValueError("qconcat cannot mix per_group with other "
                             "granularities")
        if len({qt.group_size for qt in qts}) != 1:
            raise ValueError("qconcat per_group inputs need one group_size")
        granularity = "per_group"
        scale = torch.cat([qt.scale for qt in qts], dim=-1)
    else:
        # per_tensor folds into per_channel: broadcast each input's scale
        # over its own columns, then concatenate along the channel dim
        granularity = "per_channel"
        lead = q0.shape[:-2]
        scale = torch.cat([qt.scale.to(torch.float32).expand(
            *lead, 1, qt.shape[-1]) for qt in qts], dim=-1)
    if q0.packed and any(qt.shape[-1] % 2 for qt in qts):
        raise ValueError("packed qconcat inputs need even output dims")
    codes = torch.cat([qt.codes for qt in qts], dim=-1)
    out = sum(qt.shape[-1] for qt in qts)
    return QTensor(codes=codes, scale=scale, codebook=None, bits=q0.bits,
                   mode=q0.mode, granularity=granularity,
                   group_size=q0.group_size, packed=q0.packed,
                   shape=(*q0.shape[:-1], out))


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


def derive_draft_params(params, *, bits: int = 4, mode: str = "affine",
                        predicate=_is_weight_matrix):
    """A low-precision *draft* model, derived from the raw (pre-quantization)
    parameters, for self-speculative decoding.

    The draft is the same model at a cheaper precision: same tokenizer,
    same cache layout, no training. Correctness never depends on it (the
    target verifies every token). Modes:

    - ``"affine"`` / ``"codebook"``: :func:`quantize_tree` at ``bits``
      (int4 is the intended draft point; int8 a sharper one for bf16
      targets).
    - ``"shiftadd"``: the ShiftAddLLM reparameterization (binary planes
      times power-of-two scales, ``core.shiftadd``), reconstructed in
      float64 numpy and returned as dense float32 on each weight's device
      (bit-equal to the JAX package's); ``bits`` is the number of binary
      planes.

    Feed it the ORIGINAL float parameters: a draft derived from quantized
    weights would compound two quantization errors."""
    if mode in ("affine", "codebook"):
        return quantize_tree(
            params, QuantConfig(bits=bits, mode=mode), predicate=predicate)
    if mode != "shiftadd":
        raise ValueError(f"unknown draft mode {mode!r} "
                         "(expected affine | codebook | shiftadd)")
    # function-local import: shiftadd pulls in the cycle simulator, which
    # imports this module
    from repro_torch.core.shiftadd import binarize, reconstruct

    def reparam(x: torch.Tensor) -> torch.Tensor:
        w = x.detach().to("cpu", torch.float64).numpy()
        flat = w.reshape((-1,) + w.shape[-2:])   # binarize() is 2-D only
        out = np.empty_like(flat)
        for i in range(flat.shape[0]):
            out[i] = reconstruct(*binarize(flat[i], q=bits))
        return torch.from_numpy(out.reshape(w.shape).astype(np.float32)).to(
            x.device)

    def walk(prefix, node):
        if isinstance(node, dict):
            return {k: walk(f"{prefix}/{k}", v) for k, v in node.items()}
        if predicate(prefix, node):
            return reparam(node)
        return node

    return walk("", params)


def tree_reuse_surface(params) -> int:
    """Total quantized weight elements (the surface AxLLM's Result Cache
    acts on): the logical sizes of every QTensor in the tree."""
    if isinstance(params, QTensor):
        return math.prod(params.shape)
    if isinstance(params, dict):
        return sum(tree_reuse_surface(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(tree_reuse_surface(v) for v in params)
    return 0
