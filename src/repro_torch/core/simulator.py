"""Cycle-approximate simulator of the AxLLM microarchitecture (paper §III.c,
§IV), PyTorch port.

A copy of the JAX package's ``core/simulator.py``. It stays numpy: it is
the paper's accelerator model, a host-side computation over quantized
codes, not code that runs on the card, and it gives the same integers and
floats as the JAX module on the same codes. Codes may be numpy arrays,
tensors or :class:`~repro_torch.core.quantization.QTensor`s (through the
port's ``core.reuse``).

It models the 64-lane organization with per-lane W_buff/Out_buff (256
entries as four 64-entry slices), a single 3-cycle multiplier per lane, a
128-entry sign-folded Result Cache, dual multiply/reuse pipelines,
RC-slice collision queues, and the <2% RAW hazard stall.

Two models are provided:

* :func:`simulate_segment_exact` — a per-segment cycle-accurate event model of
  one lane (fetch/slice queues, multiplier issue, RC fill/hit, back-pressure).
  Used by tests to bound the analytic model.
* :func:`simulate_matrix` / :func:`simulate_model` — the fast vectorized
  analytic model used for whole-model numbers. Its per-segment formula

      cycles ≈ unique + hits / hit_throughput + drain + hazard_stalls

  reflects the serialization between the multiply path (1 issue/cycle) and the
  reuse path (≤P RC slices/cycle, balls-in-bins collision efficiency) observed
  in the paper's reported numbers: with ~70% reuse at 256-entry buffers it
  yields DistilBERT ≈ 1.87× (paper: 159.34M → 85.11M cycles) and a ~1.7×
  average across Table I — the calibration target. An idealized fully
  overlapped datapath would approach min-bound C/max(...) ≈ 3×; the exact
  event model sits between.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import reuse as reuse_lib


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Matches §V "Simulation setup": 64 lanes, 256-entry buffers in 4 slices."""
    lanes: int = 64
    buf: int = 256                # W_buff / Out_buff entries per lane (segment)
    slices: int = 4               # P-way slicing of W_buff / RC / Out_buff
    rc_entries: int = 128         # sign-folded 8-bit RC (§V)
    mult_latency: int = 3         # §IV pipeline: multiplier 3 cycles
    buf_latency: int = 1          # §IV pipeline: buffer access 1 cycle
    queue_depth: int = 4          # per-slice collision queues (§IV, Fig. 7)
    hazard_penalty: float = 0.0   # RAW-hazard stalls are absorbed into
    #   collision_efficiency (paper §IV: likelihood < 2%, "impact negligible");
    #   _hazard_counts() still *measures* the raw rate as a diagnostic.
    collision_efficiency: float = 0.86  # CALIBRATED constant (see below)
    fold_sign: bool = True

    @property
    def hit_throughput(self) -> float:
        """Effective RC retires/cycle across the P slices.

        Instantaneous balls-in-bins throughput (P·(1-(1-1/P)^P) ≈ 2.73 for
        P=4) ignores the per-slice queues of Fig. 7, which smooth collisions
        across cycles; the steady-state max-load bound (≈ 3.8) ignores
        head-of-line blocking and hazards. The effective value sits between;
        we calibrate ONE scalar, collision_efficiency = 0.86 (⇒ 3.44/cycle for
        P=4), to the single published absolute number — DistilBERT's 85.11M
        AxLLM cycles (§V) — and then treat every other paper result (1.7×
        average speedup, LoRA 1.8×, ShiftAddLLM +29%, power −28%) as a
        *prediction* to validate against. Re-derived by
        tests/test_torch_simulator.py (the JAX module's own cases).
        """
        return self.slices * self.collision_efficiency

    @property
    def hit_throughput_ballsbins(self) -> float:
        """Uncalibrated instantaneous lower bound (kept for the bounds test)."""
        p = self.slices
        return p * (1.0 - (1.0 - 1.0 / p) ** p)

    @property
    def drain(self) -> int:
        """Pipeline fill+drain per segment (shared stages, §IV)."""
        return self.mult_latency + 2 * self.buf_latency


@dataclasses.dataclass
class SegmentStats:
    cycles_axllm: float
    cycles_baseline: float
    mults: int
    rc_hits: int
    hazards: int


@dataclasses.dataclass
class SimReport:
    cycles_axllm: float
    cycles_baseline: float
    mults: int                 # multiplications actually executed
    rc_hits: int               # multiplications eliminated (reused)
    hazards: int
    total_ops: int

    @property
    def speedup(self) -> float:
        return self.cycles_baseline / max(self.cycles_axllm, 1.0)

    @property
    def reuse_rate(self) -> float:
        return self.rc_hits / max(self.total_ops, 1)

    @property
    def hazard_rate(self) -> float:
        return self.hazards / max(self.total_ops, 1)

    def merge(self, other: "SimReport") -> "SimReport":
        return SimReport(
            self.cycles_axllm + other.cycles_axllm,
            self.cycles_baseline + other.cycles_baseline,
            self.mults + other.mults,
            self.rc_hits + other.rc_hits,
            self.hazards + other.hazards,
            self.total_ops + other.total_ops,
        )


def _empty_report() -> SimReport:
    return SimReport(0.0, 0.0, 0, 0, 0, 0)


# ---------------------------------------------------------------------------
# Exact per-segment event model (one lane)
# ---------------------------------------------------------------------------

def simulate_segment_exact(cells: np.ndarray, cfg: SimConfig) -> int:
    """Cycle-accurate model of one lane processing one W_buff segment.

    ``cells`` are RC indices (already sign-folded). Structure per §IV/Fig. 7:
    the segment is split into ``slices`` contiguous sub-buffers fetched one
    code per slice per cycle (round-robin); a miss is queued to the single
    multiplier (1 issue/cycle, ``mult_latency`` to complete, then fills RC);
    a hit is queued to its RC slice (cell % slices), each slice retiring one
    read/cycle; a fetch targeting a *pending* cell (RAW hazard, §IV) waits in
    its slice queue until the fill lands. Bounded queues apply back-pressure
    to fetch (credit-based flow control).
    """
    n = len(cells)
    if n == 0:
        return 0
    p = cfg.slices
    # contiguous slice partition of the segment
    bounds = np.linspace(0, n, p + 1).astype(int)
    ptrs = bounds[:-1].copy()
    rc_valid = np.zeros(cfg.rc_entries, dtype=bool)
    rc_pending = np.zeros(cfg.rc_entries, dtype=bool)
    mult_q: deque = deque()
    slice_q: List[deque] = [deque() for _ in range(p)]  # (cell, needs_fill)
    inflight: List[Tuple[int, int]] = []  # (complete_cycle, cell)
    retired = 0
    cycle = 0
    max_cycles = 50 * n + 100  # safety net

    while retired < n and cycle < max_cycles:
        cycle += 1
        # multiplier completion → RC fill + Out_buff write (retire)
        still = []
        for done_at, cell in inflight:
            if done_at <= cycle:
                rc_valid[cell] = True
                rc_pending[cell] = False
                retired += 1
            else:
                still.append((done_at, cell))
        inflight = still
        # multiplier issue (1/cycle)
        if mult_q:
            cell = mult_q.popleft()
            inflight.append((cycle + cfg.mult_latency, cell))
        # RC slice retirement (1 read/cycle/slice); hazard entries wait
        for s in range(p):
            if slice_q[s]:
                cell = slice_q[s][0]
                if rc_valid[cell]:
                    slice_q[s].popleft()
                    retired += 1
                # else: head-of-line wait for the pending fill (hazard stall)
        # fetch: one code per slice, with credit back-pressure
        for s in range(p):
            if ptrs[s] >= bounds[s + 1]:
                continue
            cell = int(cells[ptrs[s]])
            if rc_valid[cell]:
                if len(slice_q[cell % p]) < cfg.queue_depth:
                    slice_q[cell % p].append(cell)
                    ptrs[s] += 1
            elif rc_pending[cell]:
                if len(slice_q[cell % p]) < cfg.queue_depth:
                    slice_q[cell % p].append(cell)  # waits on fill
                    ptrs[s] += 1
            else:
                if len(mult_q) < cfg.queue_depth:
                    mult_q.append(cell)
                    rc_pending[cell] = True
                    ptrs[s] += 1
    return cycle + cfg.drain


# ---------------------------------------------------------------------------
# Analytic per-segment model (calibrated to the paper)
# ---------------------------------------------------------------------------

def _hazard_counts(cells2d: np.ndarray, cfg: SimConfig) -> np.ndarray:
    """Per-row count of repeats arriving within the multiplier latency window
    of the first occurrence of their cell (§IV: measured < 2%)."""
    n_rows, seg = cells2d.shape
    window = cfg.mult_latency * cfg.slices  # positions per mult_latency cycles
    counts = np.zeros(n_rows, dtype=np.int64)
    for r in range(n_rows):
        first: Dict[int, int] = {}
        c = 0
        row = cells2d[r]
        for i in range(seg):
            v = row[i]
            if v in first:
                if i - first[v] <= window:
                    c += 1
                    first[v] = -10 ** 9  # only the immediate-follower stalls
            else:
                first[v] = i
        counts[r] = c
    return counts


def _segment_cycles(unique: np.ndarray, seg_len: int, hazards: np.ndarray,
                    cfg: SimConfig) -> Tuple[np.ndarray, float]:
    """Vectorized per-(row,segment) AxLLM cycles and the baseline scalar."""
    hits = seg_len - unique
    cyc = (unique
           + hits / cfg.hit_throughput
           + hazards * cfg.hazard_penalty
           + cfg.drain)
    baseline = seg_len + cfg.drain
    return cyc, baseline


def simulate_matrix(codes: np.ndarray, cfg: SimConfig = SimConfig(),
                    tokens: int = 1,
                    measure_hazards: bool = True) -> SimReport:
    """Simulate x[T, N] @ W[N, M] on the lane array for ``tokens`` inputs.

    Input-stationary order (Fig. 2): lanes take ``cfg.lanes`` consecutive rows
    of W; columns are processed in W_buff-sized segments (§IV); per (tile,
    segment) the wall time is the max over the lanes (the adder tree
    accumulates streamed partial sums off the critical path, Fig. 3); the RC
    is cleared between inputs/segments (§III.c), so every token pays the
    unique-value multiplies again — exactly the zero-setup-time property the
    paper claims vs LUT approaches.
    """
    cells = reuse_lib.fold_codes(codes, cfg.fold_sign)
    n, m = cells.shape
    # count uniques on the RAW codes with the configured fold — `cells` is
    # already folded, so folding it again (fold_sign=False adds the +128
    # offset a second time) would push cells past the 256-index bound
    uniq = reuse_lib.segment_unique_counts(codes, cfg.buf,
                                           fold_sign=cfg.fold_sign)
    n_seg = uniq.shape[1]

    ax_total = 0.0
    base_total = 0.0
    mults = 0
    hits_total = 0
    hazards_total = 0

    for s in range(n_seg):
        lo, hi = s * cfg.buf, min((s + 1) * cfg.buf, m)
        seg_len = hi - lo
        if measure_hazards:
            hz = _hazard_counts(cells[:, lo:hi], cfg)
        else:
            hz = np.zeros(n, dtype=np.int64)
        cyc, base = _segment_cycles(uniq[:, s], seg_len, hz, cfg)
        # lane tiling over rows: wall time = max over lanes in each tile
        n_tiles = math.ceil(n / cfg.lanes)
        for t in range(n_tiles):
            rows = slice(t * cfg.lanes, min((t + 1) * cfg.lanes, n))
            ax_total += float(cyc[rows].max())
            base_total += float(base)
        mults += int(uniq[:, s].sum())
        hits_total += int((seg_len - uniq[:, s]).sum())
        hazards_total += int(hz.sum())

    return SimReport(
        cycles_axllm=ax_total * tokens,
        cycles_baseline=base_total * tokens,
        mults=mults * tokens,
        rc_hits=hits_total * tokens,
        hazards=hazards_total * tokens,
        total_ops=n * m * tokens,
    )


# ---------------------------------------------------------------------------
# Whole-model simulation (Table I / Fig. 9)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MatrixSpec:
    name: str
    n_in: int
    n_out: int
    count: int = 1  # instances per layer


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """A transformer described by its per-layer weight matrices (Table I)."""
    name: str
    layers: int
    matrices: Tuple[MatrixSpec, ...]
    tokens: int = 240  # avg benchmark sequence length


def gaussian_codes(rng: np.random.Generator, n: int, m: int,
                   qmax: int = 127) -> np.ndarray:
    """8-bit absmax-quantized Gaussian weights (trained-LLM-like rows)."""
    w = rng.standard_normal((n, m)).astype(np.float32)
    scale = np.abs(w).max(axis=0, keepdims=True) / qmax
    return np.clip(np.round(w / scale), -qmax, qmax).astype(np.int32)


def simulate_model(spec: ModelSpec, cfg: SimConfig = SimConfig(),
                   seed: int = 0, codes_by_name: Optional[dict] = None,
                   measure_hazards: bool = False) -> SimReport:
    """Full-model cycles: sum over layers x matrices x tokens.

    ``codes_by_name`` may supply real quantized weights (e.g. from a trained
    checkpoint); otherwise realistic Gaussian-quantized rows are drawn. Only
    one layer's worth of distinct matrices is simulated and scaled by
    ``spec.layers`` (weight statistics are layer-stationary).
    """
    rng = np.random.default_rng(seed)
    total = _empty_report()
    for mat in spec.matrices:
        if codes_by_name and mat.name in codes_by_name:
            codes = np.asarray(codes_by_name[mat.name])
        else:
            codes = gaussian_codes(rng, mat.n_in, mat.n_out)
        rep = simulate_matrix(codes, cfg, tokens=spec.tokens,
                              measure_hazards=measure_hazards)
        scale = mat.count * spec.layers
        total = total.merge(SimReport(
            rep.cycles_axllm * scale, rep.cycles_baseline * scale,
            rep.mults * scale, rep.rc_hits * scale,
            rep.hazards * scale, rep.total_ops * scale))
    return total


def simulate_lora(w_codes: np.ndarray, a_codes: np.ndarray,
                  cfg: SimConfig = SimConfig(), tokens: int = 1) -> dict:
    """Adapter-matrix speedup via the combined [W ‖ A] scheme (Fig. 5).

    A's columns ride in the SAME processing round as W's final column
    segment (the combined matrix is one matrix; the RC is not cleared
    between W's tail and A — that is the whole point of Fig. 5), so A's
    elements hit RC entries already filled while streaming W. The W+A round
    stays within the 512-entry buffer bound of §IV. Adapter-attributable
    AxLLM cycles are the marginal cycles of that round; the baseline pays
    A's full r columns through the multiplier.
    """
    w = reuse_lib.fold_codes(w_codes, cfg.fold_sign)
    a = reuse_lib.fold_codes(a_codes, cfg.fold_sign)
    n, m = w.shape
    r = a.shape[1]
    last = w[:, (m // cfg.buf - 1) * cfg.buf:] if m >= cfg.buf else w
    comb = np.concatenate([last, a], axis=1)
    u_last = reuse_lib.segment_unique_counts(last, None, fold_sign=False)
    u_comb = reuse_lib.segment_unique_counts(comb, None, fold_sign=False)
    marg_u = (u_comb - u_last)[:, 0]                    # new uniques from A
    # both designs pay the pipeline fill/drain on the adapter tail
    ax = marg_u + (r - marg_u) / cfg.hit_throughput + cfg.drain
    base = float(r + cfg.drain)
    ax_total = 0.0
    base_total = 0.0
    for t in range(math.ceil(n / cfg.lanes)):
        rows = slice(t * cfg.lanes, min((t + 1) * cfg.lanes, n))
        ax_total += float(ax[rows].max())
        base_total += base
    overlap = reuse_lib.lora_row_overlap(w_codes, a_codes, cfg.fold_sign)
    rep_c = simulate_matrix(np.concatenate([w_codes, a_codes], 1), cfg,
                            tokens)
    return {
        "adapter_speedup": (base_total * tokens) / max(ax_total * tokens,
                                                       1.0),
        "row_overlap": overlap,
        "combined_speedup": rep_c.speedup,
    }


# ---------------------------------------------------------------------------
# Table I model specs (paper §V)
# ---------------------------------------------------------------------------

def _bert_like(name: str, d: int, layers: int, tokens: int) -> ModelSpec:
    return ModelSpec(name, layers, (
        MatrixSpec("wq", d, d), MatrixSpec("wk", d, d),
        MatrixSpec("wv", d, d), MatrixSpec("wo", d, d),
        MatrixSpec("ffn_up", d, 4 * d), MatrixSpec("ffn_down", 4 * d, d),
    ), tokens=tokens)


def _llama_like(name: str, d: int, d_ff: int, layers: int,
                tokens: int) -> ModelSpec:
    return ModelSpec(name, layers, (
        MatrixSpec("wq", d, d), MatrixSpec("wk", d, d),
        MatrixSpec("wv", d, d), MatrixSpec("wo", d, d),
        MatrixSpec("ffn_gate", d, d_ff), MatrixSpec("ffn_up", d, d_ff),
        MatrixSpec("ffn_down", d_ff, d),
    ), tokens=tokens)


# tokens=236 is fitted to the paper's published DistilBERT *baseline* cycle
# count (159.34M; we get 159.66M) and is consistent with the AG News mean
# sequence length. It is the second and last calibrated constant.
PAPER_MODELS: Dict[str, ModelSpec] = {
    "distilbert": _bert_like("distilbert", 768, 6, tokens=236),
    "bert-base": _bert_like("bert-base", 768, 12, tokens=236),
    "bert-large": _bert_like("bert-large", 1024, 24, tokens=236),
    "llama-7b": _llama_like("llama-7b", 4096, 11008, 32, tokens=236),
    "llama-13b": _llama_like("llama-13b", 5120, 13824, 40, tokens=236),
}
