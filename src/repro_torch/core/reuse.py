"""Computation-reuse analytics (paper §III.b, Fig. 8), PyTorch port.

A copy of the JAX package's ``core/reuse.py`` in numpy/scipy. The reuse
rate is the fraction of multiplications served from the Result Cache:
within one row segment of the weight matrix (the paper bounds segments to
the W_buff size, 256–512 columns), the first occurrence of each distinct
code pays a multiply and every repeat is a hit.

    reuse_rate = 1 - unique_codes / total_codes      (summed over segments)

Sign folding (§V): a value and its negative share a cell, so "distinct"
means distinct |code| (128 cells for 8-bit affine). A :class:`QTensor`
goes through ``decode_codes`` first, so packed int4 bytes are unpacked
and sign-extended before they are counted.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.quantization import (QTensor, decode_codes,
                                           identity_codebook, nf4_codebook)


def _as_numpy_codes(codes) -> np.ndarray:
    if isinstance(codes, QTensor):
        codes = decode_codes(codes)
    if isinstance(codes, torch.Tensor):
        codes = codes.cpu().numpy()
    return np.asarray(codes)


def fold_codes(codes, fold_sign: bool = True) -> np.ndarray:
    """Map codes to Result Cache cell indices (|code| under sign folding).

    ``fold_sign=True`` is only meaningful for sign-symmetric alphabets
    (affine mode); codebook consumers pass ``fold_sign=False`` (see
    :func:`rc_alphabet`). The unfolded branch offsets by 128 so every int4
    or int8 code lands in [0, 256).
    """
    c = _as_numpy_codes(codes).astype(np.int32)
    out = np.abs(c) if fold_sign else c + 128
    hi = 128 if fold_sign else 255
    if out.size and (out.min() < 0 or out.max() > hi):
        # signed codes never land here; raw packed-int4 bytes (uint8, two
        # nibbles per entry) read as 0..255 and overflow either mapping
        raise ValueError(
            f"codes map outside the RC cell range [0, {hi}] — raw "
            "packed-int4 bytes? pass the QTensor (or decode_codes) so "
            "nibbles are unpacked and sign-extended first")
    return out


def rc_alphabet(bits: int, mode: str):
    """The ``(levels, fold_sign)`` contract shared by the analytics and the
    reuse (LUT) matmul.

    ``levels`` is the float32 value table the product table is built over;
    ``fold_sign`` says whether code ``c`` reads cell ``|c|`` (the sign
    applied on read) or cell ``c + 2**(bits-1)``.

    * affine: the magnitude ramp ``[0 .. qmax]`` (``scale/qmax`` is applied
      outside the table), folded: ``2**(bits-1)`` cells.
    * codebook: the explicit ``2**bits`` table (NF4 for 4-bit, identity for
      8-bit), unfolded.
    """
    if mode == "affine":
        qmax = (1 << (bits - 1)) - 1
        return np.arange(qmax + 1, dtype=np.float32), True
    if mode != "codebook":
        raise ValueError(f"unknown quant mode {mode!r}")
    cb = nf4_codebook() if bits == 4 else identity_codebook(8)
    return cb.numpy().astype(np.float32), False


def segment_unique_counts(codes, segment: Optional[int] = 256,
                          fold_sign: bool = True) -> np.ndarray:
    """Unique cell counts per (row, segment) of ``[N, M]`` codes
    (``segment=None``: the whole row). Returns int64 ``[N, n_segments]``."""
    c = fold_codes(codes, fold_sign)
    if c.ndim != 2:
        raise ValueError(f"expected [N, M] codes, got {c.shape}")
    n, m = c.shape
    seg = m if segment is None else int(segment)
    n_seg = (m + seg - 1) // seg
    out = np.zeros((n, n_seg), dtype=np.int64)
    n_cells = 256  # upper bound on cell indices either way
    for s in range(n_seg):
        block = c[:, s * seg:(s + 1) * seg]
        flat = (np.arange(n)[:, None] * n_cells + block).ravel()
        counts = np.bincount(flat, minlength=n * n_cells).reshape(n, n_cells)
        out[:, s] = (counts > 0).sum(axis=1)
    return out


def reuse_rate(codes, segment: Optional[int] = 256,
               fold_sign: bool = True) -> float:
    """Fraction of multiplications the Result Cache eliminates."""
    uniq = segment_unique_counts(codes, segment, fold_sign).sum()
    total = _as_numpy_codes(codes).size
    return float(1.0 - uniq / total)


def expected_unique(seg_len: int, n_cells: int = 128,
                    dist: str = "gaussian") -> float:
    """Analytic E[#unique cells] for a segment of ``seg_len`` draws:
    ``sum_v 1 - (1 - p_v)^n``, with p_v from |N(0, sigma)| quantized by
    absmax (absmax ~ 4 sigma) for "gaussian", or 1/n_cells for "uniform"."""
    if dist == "uniform":
        p = np.full(n_cells, 1.0 / n_cells)
    else:
        from scipy import stats
        qmax = n_cells - 1
        sigma_codes = qmax / 4.0
        edges = np.arange(n_cells + 1) - 0.5
        edges[0] = 0.0
        cdf = stats.norm.cdf(edges / sigma_codes)
        p = 2.0 * np.diff(cdf)
        p[0] = 2.0 * (stats.norm.cdf(0.5 / sigma_codes) - 0.5)  # the 0 cell
        p = p / p.sum()
    return float(np.sum(1.0 - (1.0 - p) ** seg_len))


def expected_reuse_rate(seg_len: int, n_cells: int = 128,
                        dist: str = "gaussian") -> float:
    return 1.0 - expected_unique(seg_len, n_cells, dist) / seg_len


def lora_row_overlap(w_codes, a_codes, fold_sign: bool = True) -> float:
    """Fraction of A's elements whose cell already occurs in the same W
    row (paper §V). W is [N, M], A is [N, r]."""
    w = fold_codes(w_codes, fold_sign)
    a = fold_codes(a_codes, fold_sign)
    if w.shape[0] != a.shape[0]:
        raise ValueError("W and A must share the row (input) dimension")
    n = w.shape[0]
    n_cells = 256
    flat = (np.arange(n)[:, None] * n_cells + w).ravel()
    counts = np.bincount(flat, minlength=n * n_cells).reshape(n, n_cells)
    present = counts > 0
    return float(np.take_along_axis(present, a, axis=1).mean())


def per_matrix_report(codes, segments=(None, 256), fold_sign: bool = True):
    """Reuse rates at several buffer budgets: one Fig. 8 group."""
    return {("full" if s is None else str(s)): reuse_rate(codes, s, fold_sign)
            for s in segments}
