#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

1. Fails (exit 1, no result) unless ``torch.cuda.is_available()``.
2. Prints the card's name and power limit, then builds every CUDA kernel
   of the serving paths from ``src/repro_torch/csrc`` (one nvcc per
   source, in parallel), prints the build time and the number of HGMMA
   (wgmma) instructions in each quantized-matmul library and in the flash
   attention library, and fails if there are none.
3. Kernel phase: each kernel against its plain PyTorch version on the
   card at the shapes of full-width repro-100m serving (the quantized
   matmuls also at the fused widths N1280 = wqkv and N4096 = gate_up, and
   at M4096 also per-group and packed int4, each case printing whether it
   took the tensor-core, the split-K decode or the tile kernel; a decode
   case also against its split emulation ``ref.quant_gemv_split_ref``, a
   second launch and its bf16 output, with the tile kernel's time beside
   it),
   flash attention at the prefill wave, at Sq256 Sk1024 causal and full
   and at the wave with head dim 128, through its wrapper (the
   tensor-core kernel, also held against its emulation
   ``ref.flash_attention_tc_ref``) and through the SIMT kernel; the
   split-KV decode kernels also against their split emulations;
   with its error, tolerance, device time (CUDA events, L2 flushed before
   each launch), the plain version's time, the least time the card could
   take (bound) and the time of one PyTorch library call computing the
   same function (a yardstick the port never calls). The reuse matmul's
   multiply count is held against ``reuse_mult_count``. The quantization
   kernel's codes and scales must equal its plain version's, at five
   shapes, bf16 and f32, 8 and 4 bits (each timed beside the strip
   kernel it replaced, built from
   ``src/repro_torch/baseline/quantize_strip.cu`` as a library of its
   own, and the launch floor, with its plan printed), on every route of
   its plan at 2 to 8 bits (K65536, ragged N in stacks), on columns
   holding a NaN, an inf or only zeros, and then in a deploy pass through
   ``ops.quantize_channels`` over every projection leaf of full-width
   repro-100m (84 matrices, one launch per stacked leaf), its path. The
   codebook route of the tensor-core path (NF4 and identity-8, per
   channel and per group of 128, at a prefill wave's M4096 and the
   projections' K x N) is held on both matmuls against the plain version
   and its emulation ``ref.quant_gemm_ref``, with the tile kernel it
   replaced timed beside it. The kernels of both quantized matmuls are
   timed from M1 to M4096 at N256 and N2048, int8 and NF4 (the decode
   kernels up to M16, the tensor-core ones from M16), where ``TC_MIN_M``
   and ``GEMV_MAX_M`` pick the path.
4. Small-input checks on the reduced float32 model: the dense int8 engine
   gives the same greedy tokens through the kernels as through the plain
   versions, and so does a ``paged=True, impl="reuse"`` engine against the
   dense engine through the plain versions.
5. End-to-end runs on full-width repro-100m (bf16, random weights from a
   seed), each with every launch count set to 0 just before it and read
   just after, and each checking its own kernels:
   a. dense: ``ServeEngine(quantize=True, n_slots=8, max_len=1024,
      decode_chunk=8)`` serves 16 requests (prompts 64/200/511 tokens,
      ``max_new=64``): axllm_matmul, decode_attention, flash_attention;
   b. reuse + paged: the same engine with ``impl="reuse", paged=True,
      kv_block_size=16`` serves 16 requests that share a 256-token prefix
      (tails 64/200/255 tokens): reuse_matmul, paged_decode_attention,
      and flash_attention on the wave with no prefix hit.
   c. LoRA on the reuse pipeline: the run-a engine with ``impl="reuse",
      fuse_qkv=True`` and an adapter registry of four rank-16 adapters
      (``LoRAConfig()``, A and B from numpy seeds, carried in by
      ``bridge.registry_from_numpy``) serves run a's prompts, the
      requests cycling base/a0/a1/a2/a3: reuse_matmul, decode_attention,
      flash_attention.
   d. NF4 reuse: the run-a engine with ``impl="reuse", quant_bits=4,
      quant_mode="codebook"`` (packed NF4, per channel) serves run a's
      prompts: reuse_matmul (prefill on the codebook route of its
      tensor-core path, one launch per projection and wave; decode on
      ``.gemv``, one per projection and step), decode_attention,
      flash_attention.
   e. overload + chunked prefill: the run-a engine with ``paged=True,
      kv_block_size=16, prefill_budget=1024`` and 111 usable pool blocks
      (the pager takes no pool below 514 blocks here, so the rest is held
      outside the engine for the whole run) serves 24 requests on run a's
      prompt cycle, 20 up front and 4 at priority 1 after the second step;
      request 1 streams through ``on_token``, request 4 raises
      ``StopStream`` after 10 tokens, request 19 is cancelled while
      queued. It requires every request to finish once as planned,
      preemptions for priority and for the pool with as many restores,
      each fast restore's KV bit-equal to its KV at swap-out, more
      chunks than waves with a continuation, no step above the budget,
      the pager consistent after every step and empty at the end, every
      ``axllm_matmul`` launch on ``.wgmma`` or ``.gemv``,
      ``paged_decode_attention`` and ``flash_attention.wgmma``, and the
      token gate on every generated token. It prints TTFT p50 / p99 and
      the largest step beside an unloaded engine of the same kernels
      (default pool, no budget) and the greedy-token agreement with it,
      and profiles a step that holds a continuation chunk (the plain
      ``prefix_attention``'s device share, annotated and replayed).
   Runs a to d each require its matmul's and flash attention's
   tensor-core paths (``<kernel>.wgmma``) to have launched in its prefill
   waves (every flash launch on the tensor cores) and its matmul's decode
   kernel (``<kernel>.gemv``) in its decode steps (every matmul launch
   one of the two), holds its first wave's logits against the plain path,
   holds every generated token to the token gate (``serve/token_gate.py``: the
   plain path's teacher-forced logit of the token within 2 x the logits
   tolerance of the plain maximum, at every position), profiles 4
   decode chunks for the device's idle share and its first wave's
   prefill for its device time (flash attention's share), serves the same
   requests through the plain path for greedy-token agreement. Run b also
   holds the first-token logits of its first prefix-hit wave, as served
   (prefix KV gathered out of the pool, suffix-only prefill), against a
   plain dense prefill of the whole prompts; runs b, c and d read the
   reuse rate the kernel achieves on each projection of layer 0 (run d
   on the decode and the prefill path, each count held against
   ``reuse_mult_count``). Run c also
   requires each adapter row's first-wave logits to differ from the same
   prompt's base logits by more than the tolerance.
6. Chaos phase: ``repro_torch.serve.chaos.run(smoke=True, device="cuda")``,
   the seven scenarios on the harness's own f32 model through the kernels:
   no request lost, no block or pin leaked, the pager consistent after
   every step, and a request whose tokens differ from the card's own
   fault-free run printed and held to the token gate.
7. Prints the ``kernels`` JSON line, then the result line.

Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 and f32 FLOP/s
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

N_SLOTS, MAX_LEN, DECODE_CHUNK = 8, 1024, 8
PROMPT_LENS, N_REQUESTS, MAX_NEW = (64, 200, 511), 16, 64
SHARED_PREFIX, TAIL_LENS, KV_BLOCK = 256, (64, 200, 255), 16
ADAPTERS = ("a0", "a1", "a2", "a3")   # run c: requests cycle base + these
LORA_B_STD = 0.01       # run c: B ~ N(0, 0.01^2), A ~ N(0, 1/r)
FUSED = ((768, 1280), (768, 4096))    # K x N of wqkv and gate_up
# the codebook route's kernel phase: the 7 projections' K x N and the fused
# ones at a prefill wave's M, NF4 (packed) and identity-8, per channel and
# in groups of 128 rows
CODEBOOK_SHAPES = ((768, 2048), (768, 768), (768, 256), (2048, 768)) + FUSED
THRESHOLD_M = (1, 8, 16, 32, 48, 64, 96, 128, 256)  # paths timed at each
GEMV_M = (1, 8, 16)     # where the decode kernels are timed as well
# flash kernel phase: (B, Sq, Sk, causal, head dim)
FLASH_CASES = ((N_SLOTS, 512, 512, True, 64), (2, 256, 1024, True, 64),
               (2, 256, 1024, False, 64), (N_SLOTS, 512, 512, True, 128))
LOGIT_TOL = 5e-2        # bf16 model, 12 layers: |kernel - plain| / scale
SPIN_CYCLES = 4_000_000  # ~2 ms of device spin ahead of each timed launch
# run e (overload + chunked prefill): 24 requests on run a's prompt cycle,
# the last 4 at priority 1 after the second step; 111 usable pool blocks
# against the 147 eight seated requests hold by their last step (the pager
# takes no pool below 8 x 64 + 2 = 514 blocks, so the engine gets that and
# the rest is held outside it for the whole run, as the chaos harness's
# BlockThief holds blocks); a prefill budget a step; request 1 streams,
# request 4 hangs up after 10 tokens, request 19 is cancelled while queued
E_REQUESTS, E_LATE, E_USABLE, E_BUDGET = 24, 4, 111, 1024
E_STREAM, E_HANGUP, E_HANGUP_AFTER, E_CANCEL = 1, 4, 10, 19


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def time_ms(fn, flush, iters: int = 20) -> float:
    """Median device time of ``fn`` in ms from CUDA events. Before each
    launch the L2 cache is flushed (the serving path finds it cold: twelve
    layers of weights and KV exceed its 50 MB) and a spin kernel keeps the
    card busy while the host enqueues ``fn``, so the events bracket device
    work and not the host's launch overhead."""
    import torch
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in events:
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in events)
    return times[len(times) // 2]


def device_busy_ms(fn) -> tuple:
    """(wall ms, device-busy ms, device ms of every kernel by name, the
    largest first) of ``fn`` under torch.profiler: the busy time is the
    sum of the card's kernel, memcpy and memset durations (one stream, so
    they do not overlap)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return wall, sum(by_name.values()), top


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes, t_ops = nbytes / HBM_BPS, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def path_of(m, x, qt) -> str:
    """The kernel a quantized-matmul call of this shape and type takes:
    "wgmma", "gemv" (the split-K decode kernel) or "tile"."""
    from repro_torch.kernels.axllm_matmul import matmul_path
    return matmul_path(m, x.dtype, qt, x.data_ptr() % 16 == 0)


def gemv_checks(name, x, qt, got, call, reuse) -> dict:
    """A split-K decode kernel's result ``got`` (f32) of ``call(dtype)``
    against its split emulation (within 1e-5 of the output scale), a
    second launch (the same bits) and its bf16 output (the f32 output
    rounded to nearest even)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.axllm_matmul import gemv_buffers
    plan = gemv_buffers(x, qt, torch.cuda.current_stream(x.device)
                        .cuda_stream, reuse)[0]
    emu = ref.quant_gemv_split_ref(x, qt, plan, reuse)
    err = float((got - emu).abs().max())
    tol = 1e-5 * max(1.0, float(emu.abs().max()))
    same = torch.equal(call(torch.float32), got)
    rne = torch.equal(call(torch.bfloat16), got.to(torch.bfloat16))
    print(f"kernel {name} [gemv] M{x.shape[0]} K{qt.shape[0]} "
          f"N{qt.shape[1]}: err vs its split emulation {err:.3e} (tol "
          f"{tol:.3e}); {plan.blocks} blocks ({plan.n_tiles} column x "
          f"{plan.m_tiles} M x {plan.splits} K splits of "
          f"{plan.k_per_split}); second launch identical {same}; bf16 out "
          f"= f32 out rounded {rne}", flush=True)
    check(err <= tol, f"{name} differs from its split emulation by {err}")
    check(same, f"{name}: a second launch gave other bits")
    check(rne, f"{name}: bf16 output is not the f32 output rounded")
    return dict(emulation_err=err, blocks=plan.blocks, splits=plan.splits)


def split_err(got, emu, name) -> float:
    """A split-KV decode kernel against its emulation (the same splits):
    within one bf16 rounding of the output (2^-8 of its scale)."""
    err = float((got.float() - emu.float()).abs().max())
    tol = 2.0 ** -8 * max(1.0, float(emu.float().abs().max()))
    print(f"kernel {name}: err vs its split emulation {err:.3e} "
          f"(tol {tol:.3e})", flush=True)
    check(err <= tol, f"{name} differs from its split emulation by {err}")
    return err


def case_row(name, shape, err, tol, ms, plain_ms, lib_ms, nb, flops, dtype,
             path=None):
    bound_ms, bound_by = bound(nb, flops, dtype)
    row = dict(kernel=name, shape=shape, max_abs_err=err, tolerance=tol,
               ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               library_ms=lib_ms, path=path)
    print(f"kernel {name}{'' if path is None else f' [{path}]'} {shape}: "
          f"err {err:.3e} (tol {tol:.3e}) "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}), library "
          f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}", flush=True)
    check(err <= tol, f"{name} {shape} error {err} > tolerance {tol}")
    return row


def kernel_phase(dev, flush):
    import torch
    import torch.nn.functional as F
    from repro_torch.core.quantization import QuantConfig, dequantize, \
        quantize
    from repro_torch.kernels import ref
    from repro_torch.kernels import _build
    from repro_torch.kernels import axllm_matmul
    from repro_torch.kernels.axllm_matmul import axllm_matmul_cuda
    from repro_torch.kernels.decode_attention import decode_attention_cuda, \
        split_plan

    g = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    rows = []

    # -- axllm_matmul: the 7 projections at decode M = n_slots, one prefill
    mm_cases = [(8, 768, 768, QuantConfig(8)), (8, 768, 256, QuantConfig(8)),
                (8, 768, 2048, QuantConfig(8)), (8, 2048, 768, QuantConfig(8)),
                (4096, 768, 2048, QuantConfig(8)),
                (4096, 2048, 768, QuantConfig(8)),
                (8, 768, 2048, QuantConfig(4, "affine", pack=True)),
                (8, 768, 2048, QuantConfig(8, "affine", "per_group")),
                (8, 768, 2048, QuantConfig(4, "codebook", pack=True))]
    mm_cases += [(m, k, n, QuantConfig(8)) for m in (N_SLOTS, 4096)
                 for k, n in FUSED]
    mm_cases += [(4096, 768, 2048, qc) for qc in (   # the prefill path
        QuantConfig(8, "affine", "per_group"),
        QuantConfig(4, "affine", pack=True))]
    for m, k, n, qc in mm_cases:
        x = torch.randn(m, k, generator=g, device=dev).to(bf16)
        qt = quantize(torch.randn(k, n, generator=g, device=dev) * k ** -0.5,
                      qc)
        want = ref.axllm_matmul_ref(x, qt)
        got = axllm_matmul_cuda(x, qt)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = 1e-5 * max(1.0, float(want.abs().max()))
        w_deq = dequantize(qt, bf16)
        ms = time_ms(lambda: axllm_matmul_cuda(x, qt), flush)
        plain = time_ms(lambda: ref.axllm_matmul_ref(x, qt), flush)
        lib = time_ms(lambda: torch.matmul(x, w_deq), flush)
        nb = nbytes(x, qt.codes, qt.kernel_scale, got)
        shape = f"M{m} K{k} N{n} {qc.bits}b-{qc.mode}-{qc.granularity}"
        path = path_of(m, x, qt)
        row = case_row("axllm_matmul", shape, err, tol, ms, plain, lib, nb,
                       2.0 * m * k * n, "bfloat16", path)
        if path == "gemv":   # beside it: its checks and the tile kernel
            row.update(gemv_checks(
                "axllm_matmul", x, qt, got,
                lambda dt: axllm_matmul_cuda(x, qt, dt), False))
            row["tile_ms"] = time_ms(lambda: axllm_matmul.launch(
                x, qt, torch.float32, "tile"), flush)
            print(f"kernel axllm_matmul [tile] {shape}: {row['tile_ms']:.4f}"
                  " ms", flush=True)
        rows.append(row)

    # -- decode_attention: one decode step of the 8 slots, S = max_len
    b, s, h, hk, d = N_SLOTS, MAX_LEN, 12, 4, 64
    length = torch.tensor([0, 64, 200, 511, 700, 1000, s, s + 300],
                          dtype=torch.int32, device=dev)
    valid = torch.clamp(length, 0, s)
    q = torch.randn(b, h, d, generator=g, device=dev).to(bf16)
    mask = (torch.arange(s, device=dev)[None, :] < valid[:, None])[:, None,
                                                                     None]
    for quant in (False, True):
        if quant:
            kc = torch.randint(-127, 128, (b, s, hk, d), generator=g,
                               device=dev, dtype=torch.int8)
            vc = torch.randint(-127, 128, (b, s, hk, d), generator=g,
                               device=dev, dtype=torch.int8)
            ks = torch.rand(b, s, hk, 1, generator=g, device=dev) * 0.02
            vs = torch.rand(b, s, hk, 1, generator=g, device=dev) * 0.02
            per_key = hk * (2 * d + 2 * 4)
        else:
            kc = torch.randn(b, s, hk, d, generator=g, device=dev).to(bf16)
            vc = torch.randn(b, s, hk, d, generator=g, device=dev).to(bf16)
            ks = vs = None
            per_key = hk * 2 * d * 2
        want = ref.decode_attention_ref(q, kc, vc, length, ks, vs)
        got = decode_attention_cuda(q, kc, vc, length, ks, vs)
        torch.cuda.synchronize()
        check(int(torch.count_nonzero(got[0])) == 0,
              "decode_attention: a length-0 row is not exactly 0")
        err = float((got.float() - want.float()).abs().max())
        tol = 2.0 ** -7 * max(1.0, float(want.float().abs().max()))
        split_err(got, ref.decode_attention_split_ref(
            q.float(), kc, vc, length, ks, vs,
            *split_plan(s, b * hk, _build.sm_count(dev))), "decode_attention")
        ms = time_ms(lambda: decode_attention_cuda(q, kc, vc, length, ks, vs),
                     flush)
        plain = time_ms(lambda: ref.decode_attention_ref(q, kc, vc, length,
                                                         ks, vs), flush)
        lib = None
        if not quant:   # one library call computes the dense case
            qs, kt, vt = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qs, kt, vt, attn_mask=mask, enable_gqa=True), flush)
        n_keys = int(valid.sum())
        nb = nbytes(q, length, got) + n_keys * per_key
        shape = f"B{b} S{s} H{h} Hk{hk} d{d} {'int8' if quant else 'bf16'}-kv"
        rows.append(case_row("decode_attention", shape, err, tol, ms, plain,
                             lib, nb, 4.0 * n_keys * h * d, "bfloat16"))

    # -- flash_attention: the prefill wave (8 x 512), Sq < Sk and the wave
    # at head dim 128; the wrapper's own choice (the tensor-core kernel,
    # also held against its emulation) and the SIMT kernel
    from repro_torch.kernels import flash_attention as fa
    for b, sq, sk, causal, dd in FLASH_CASES:
        q = torch.randn(b, sq, h, dd, generator=g, device=dev).to(bf16)
        k = torch.randn(b, sk, hk, dd, generator=g, device=dev).to(bf16)
        v = torch.randn(b, sk, hk, dd, generator=g, device=dev).to(bf16)
        want = ref.attention_ref(q, k, v, causal)
        tol = 2.0 ** -7 * max(1.0, float(want.float().abs().max()))
        check(fa.tensor_core_path(q), "bf16 attention does not take the "
                                      "tensor-core path")
        emu = ref.flash_attention_tc_ref(q.float(), k.float(), v.float(),
                                         causal)
        qt_, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        amask = None
        if causal:      # queries sit at the last sq key positions
            amask = (torch.arange(sq, device=dev)[:, None] + sk - sq
                     >= torch.arange(sk, device=dev)[None, :])
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qt_, kt, vt, attn_mask=amask, enable_gqa=True), flush)
        plain = time_ms(lambda: ref.attention_ref(q, k, v, causal), flush)
        pairs = sum(min(sk, i + sk - sq + 1) for i in range(sq)) if causal \
            else sq * sk
        shape = f"B{b} Sq{sq} Sk{sk} H{h} Hk{hk} d{dd} " \
                f"{'causal' if causal else 'full'}"
        for path, call in (
                ("wgmma", lambda: fa.flash_attention_cuda(q, k, v, causal)),
                ("simt", lambda: fa.launch(q, k, v, causal, False))):
            got = call()
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            ms = time_ms(call, flush)
            row = case_row("flash_attention", shape, err, tol, ms, plain, lib,
                           nbytes(q, k, v, got), 4.0 * b * h * dd * pairs,
                           "bfloat16", path)
            if path == "wgmma":
                emu_err = float((got.float() - emu).abs().max())
                emu_tol = 2.0 ** -8 * max(1.0, float(emu.abs().max()))
                print(f"kernel flash_attention [wgmma] {shape}: err vs its "
                      f"emulation {emu_err:.3e} (tol {emu_tol:.3e})",
                      flush=True)
                check(emu_err <= emu_tol, f"flash_attention {shape} differs "
                                          f"from its emulation by {emu_err}")
                row.update(emulation_err=emu_err)
            rows.append(row)
    return rows


def reuse_paged_kernel_phase(dev, flush):
    """The two kernels of the reuse + paged path: reuse_matmul at the 7
    projections' K x N (decode M = n_slots and a prefill wave of 8 x 512
    rows) and in every alphabet, paged_decode_attention at one decode
    step of the 8 slots through shuffled, shared block tables."""
    import torch
    from repro_torch.core.quantization import QuantConfig, dequantize, \
        quantize
    from repro_torch.kernels import ref
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import split_plan
    from repro_torch.kernels import reuse_matmul
    from repro_torch.kernels.paged_decode_attention import \
        paged_decode_attention_cuda
    from repro_torch.kernels.reuse_matmul import reuse_matmul_cuda, segment

    g = torch.Generator(device=dev).manual_seed(1)
    bf16 = torch.bfloat16
    rows = []
    int8 = QuantConfig(8)
    shapes = [(768, 768), (768, 256), (768, 2048), (2048, 768)]
    cases = [(m, k, n, int8) for m in (N_SLOTS, 4096)
             for k, n in shapes + list(FUSED)]
    cases += [(N_SLOTS, 768, 2048, QuantConfig(4, "affine", pack=True)),
              (N_SLOTS, 768, 2048, QuantConfig(8, "affine", "per_group")),
              (N_SLOTS, 768, 2048, QuantConfig(4, "codebook", pack=True))]
    cases += [(4096, 768, 2048, qc) for qc in (      # the prefill path
        QuantConfig(8, "affine", "per_group"),
        QuantConfig(4, "affine", pack=True))]
    for m, k, n, qc in cases:
        x = torch.randn(m, k, generator=g, device=dev).to(bf16)
        qt = quantize(torch.randn(k, n, generator=g, device=dev) * k ** -0.5,
                      qc)
        want = ref.reuse_matmul_ref(x, qt)
        got, mults = reuse_matmul_cuda(x, qt, with_stats=True)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = 1e-5 * max(1.0, float(want.abs().max()))
        count = ref.reuse_mult_count(qt, segment(n))
        rate = 1.0 - int(mults) / (k * n)
        shape = f"M{m} K{k} N{n} {qc.bits}b-{qc.mode}-{qc.granularity}"
        print(f"kernel reuse_matmul {shape}: mults {int(mults)} "
              f"(reuse_mult_count {count}), reuse rate {rate:.4f}",
              flush=True)
        check(int(mults) == count, f"reuse_matmul {shape} counted "
                                   f"{int(mults)} multiplies, not {count}")
        w_deq = dequantize(qt, bf16)
        ms = time_ms(lambda: reuse_matmul_cuda(x, qt), flush)
        plain = time_ms(lambda: ref.reuse_matmul_ref(x, qt), flush)
        lib = time_ms(lambda: torch.matmul(x, w_deq), flush)
        nb = nbytes(x, qt.codes, qt.kernel_scale, got)
        path = path_of(m, x, qt)
        row = case_row("reuse_matmul", shape, err, tol, ms, plain, lib, nb,
                       2.0 * m * k * n, "bfloat16", path)
        if path == "gemv":   # beside it: its checks and the tile kernel
            row.update(gemv_checks(
                "reuse_matmul", x, qt, got,
                lambda dt: reuse_matmul_cuda(x, qt, out_dtype=dt)[0], True))
            row["tile_ms"] = time_ms(lambda: reuse_matmul.launch(
                x, qt, False, torch.float32, "tile"), flush)
            print(f"kernel reuse_matmul [tile] {shape}: {row['tile_ms']:.4f}"
                  " ms", flush=True)
        rows.append(dict(row, mults=int(mults), reuse_rate=rate))

    # one decode step of the 8 slots: tables shuffled over the pool, rows
    # sharing prefix blocks, a length-0 row and one past its table
    b, h, hk, d, bs, mb = N_SLOTS, 12, 4, 64, KV_BLOCK, MAX_LEN // KV_BLOCK
    nb_pool = 2 * N_SLOTS * mb + 2
    bt = (1 + torch.randperm(nb_pool - 1, generator=g, device=dev)[:b * mb])
    bt = bt.reshape(b, mb).to(torch.int32)
    bt[1:, :SHARED_PREFIX // bs] = bt[0, :SHARED_PREFIX // bs]
    length = torch.tensor([0, 320, 456, 511, 700, 1000, mb * bs,
                           mb * bs + 300], dtype=torch.int32, device=dev)
    valid = torch.clamp(length, 0, mb * bs)
    q = torch.randn(b, h, d, generator=g, device=dev).to(bf16)
    for quant in (False, True):
        if quant:
            kp = torch.randint(-127, 128, (nb_pool, bs, hk, d), generator=g,
                               device=dev, dtype=torch.int8)
            vp = torch.randint(-127, 128, (nb_pool, bs, hk, d), generator=g,
                               device=dev, dtype=torch.int8)
            ks = torch.rand(nb_pool, bs, hk, 1, generator=g, device=dev) * .02
            vs = torch.rand(nb_pool, bs, hk, 1, generator=g, device=dev) * .02
            per_key = hk * (2 * d + 2 * 4)
        else:
            kp = torch.randn(nb_pool, bs, hk, d, generator=g,
                             device=dev).to(bf16)
            vp = torch.randn(nb_pool, bs, hk, d, generator=g,
                             device=dev).to(bf16)
            ks = vs = None
            per_key = hk * 2 * d * 2
        want = ref.paged_decode_attention_ref(q, kp, vp, bt, length, ks, vs)
        got = paged_decode_attention_cuda(q, kp, vp, bt, length, ks, vs)
        torch.cuda.synchronize()
        check(int(torch.count_nonzero(got[0])) == 0,
              "paged_decode_attention: a length-0 row is not exactly 0")
        split_err(got, ref.paged_decode_attention_split_ref(
            q.float(), kp, vp, bt, length, ks, vs,
            *split_plan(mb * bs, b * hk, _build.sm_count(dev), bs)),
            "paged_decode_attention")
        err = float((got.float() - want.float()).abs().max())
        tol = 2.0 ** -7 * max(1.0, float(want.float().abs().max()))
        ms = time_ms(lambda: paged_decode_attention_cuda(
            q, kp, vp, bt, length, ks, vs), flush)
        plain = time_ms(lambda: ref.paged_decode_attention_ref(
            q, kp, vp, bt, length, ks, vs), flush)
        n_keys = int(valid.sum())
        # the bytes the function must move: each distinct pool entry the
        # valid positions read (rows share their prefix blocks), once, and
        # the table entries the rows need
        pos = torch.arange(mb * bs, device=dev)
        entry = bt.long()[:, pos // bs] * bs + pos % bs
        n_entries = int(torch.unique(
            entry[pos[None, :] < valid[:, None]]).numel())
        nbt = int(((valid + bs - 1) // bs).sum()) * 4
        nb = nbytes(q, length, got) + n_entries * per_key + nbt
        shape = f"B{b} H{h} Hk{hk} d{d} bs{bs} MB{mb} " \
                f"{'int8' if quant else 'bf16'}-kv"
        rows.append(case_row("paged_decode_attention", shape, err, tol, ms,
                             plain, None, nb, 4.0 * n_keys * h * d,
                             "bfloat16"))
    return rows


def codebook_kernel_phase(dev, flush):
    """The codebook route of the tensor-core path (each level three bf16
    terms) on both quantized matmuls at a prefill wave (M4096), for NF4
    (packed) and identity-8, per channel and per group of 128 rows, at
    ``CODEBOOK_SHAPES``: each row held against its plain version and the
    route's emulation ``ref.quant_gemm_ref`` (within 1e-5 of the output
    scale), its bf16 output against its f32 output rounded to nearest even,
    a second launch against the first (the same bits), and the reuse
    kernel's count against ``reuse_mult_count``; beside its time the plain
    version's, ``torch.matmul`` on the dequantized bf16 weights and the old
    tile kernel's (the route these calls took before)."""
    import torch
    from repro_torch.core.quantization import QuantConfig, dequantize, \
        quantize
    from repro_torch.kernels import axllm_matmul, ref, reuse_matmul
    from repro_torch.kernels.reuse_matmul import segment

    g = torch.Generator(device=dev).manual_seed(5)
    bf16, f32 = torch.bfloat16, torch.float32
    m = 4096
    rows = []
    for qc in (QuantConfig(4, "codebook"),
               QuantConfig(4, "codebook", "per_group"),
               QuantConfig(8, "codebook"),
               QuantConfig(8, "codebook", "per_group")):
        for k, n in CODEBOOK_SHAPES:
            x = torch.randn(m, k, generator=g, device=dev).to(bf16)
            qt = quantize(torch.randn(k, n, generator=g, device=dev)
                          * k ** -0.5, qc)
            emu = ref.quant_gemm_ref(x, qt)
            w_deq = dequantize(qt, bf16)
            lib = time_ms(lambda: torch.matmul(x, w_deq), flush)
            shape = f"M{m} K{k} N{n} {qc.bits}b-{qc.mode}-{qc.granularity}"
            for name, plain_fn, call, tile in (
                    ("axllm_matmul", ref.axllm_matmul_ref,
                     lambda dt: axllm_matmul.launch(x, qt, dt, "wgmma"),
                     lambda: axllm_matmul.launch(x, qt, f32, "tile")),
                    ("reuse_matmul", ref.reuse_matmul_ref,
                     lambda dt: reuse_matmul.launch(x, qt, False, dt,
                                                    "wgmma")[0],
                     lambda: reuse_matmul.launch(x, qt, False, f32,
                                                 "tile")[0])):
                path = path_of(m, x, qt)
                check(path == "wgmma", f"{name} {shape} takes {path}")
                want = plain_fn(x, qt)
                got = call(f32)
                torch.cuda.synchronize()
                scale = max(1.0, float(want.abs().max()))
                err = float((got - want).abs().max())
                emu_err = float((got - emu).abs().max())
                same = torch.equal(call(f32), got)
                rne = torch.equal(call(bf16), got.to(bf16))
                check(emu_err <= 1e-5 * scale, f"{name} {shape} differs "
                      f"from its emulation by {emu_err}")
                check(same, f"{name} {shape}: a second launch gave other "
                            "bits")
                check(rne, f"{name} {shape}: bf16 output is not the f32 "
                           "output rounded")
                extra = {}
                if name == "reuse_matmul":   # the count, on the served call
                    _, mults = reuse_matmul.launch(x, qt, True, bf16,
                                                   "wgmma")
                    count = ref.reuse_mult_count(qt, segment(n))
                    check(int(mults) == count, f"{name} {shape} counted "
                          f"{int(mults)} multiplies, not {count}")
                    extra = dict(mults=int(mults),
                                 reuse_rate=1.0 - int(mults) / (k * n))
                ms = time_ms(lambda: call(f32), flush)
                plain = time_ms(lambda: plain_fn(x, qt), flush)
                tile_ms = time_ms(tile, flush)
                row = case_row(name, shape, err, 1e-5 * scale, ms, plain,
                               lib, nbytes(x, qt.codes, qt.kernel_scale,
                                           got), 2.0 * m * k * n,
                               "bfloat16", path)
                print(f"kernel {name} [wgmma] {shape}: err vs its emulation "
                      f"{emu_err:.3e}; second launch identical {same}; bf16 "
                      f"out = f32 out rounded {rne}; the tile kernel "
                      f"{tile_ms:.4f} ms"
                      + (f"; mults {extra['mults']} = reuse_mult_count"
                         if extra else ""), flush=True)
                rows.append(dict(row, emulation_err=emu_err,
                                 tile_ms=tile_ms, **extra))
    return rows


def tensor_core_phase(dev, flush):
    """Where the tensor-core path of the two quantized matmuls overtakes
    their skinny kernels: the tensor-core and tile kernels of both at K768
    N256 and N2048 (bf16, int8 and NF4 per-channel) for each M of
    ``THRESHOLD_M`` and M4096, and the split-K decode kernels at each M of
    ``GEMV_M``, each held against its plain version; and the bf16 output
    that the serving path asks for at M4096 N2048 (written by the kernel,
    no separate cast)."""
    import torch
    from repro_torch.core.quantization import QuantConfig, quantize
    from repro_torch.kernels import axllm_matmul, ref, reuse_matmul
    from repro_torch.kernels.axllm_matmul import TC_MIN_M

    g = torch.Generator(device=dev).manual_seed(4)
    bf16, f32 = torch.bfloat16, torch.float32
    sweep = []
    for (k, n), (alpha, qc) in itertools.product(
            ((768, 256), (768, 2048)),
            (("int8", QuantConfig(8)), ("nf4", QuantConfig(4, "codebook")))):
        qt = quantize(torch.randn(k, n, generator=g, device=dev) * k ** -0.5,
                      qc)
        for m in THRESHOLD_M + (4096,):
            x = torch.randn(m, k, generator=g, device=dev).to(bf16)
            want = ref.axllm_matmul_ref(x, qt)
            tol = 1e-5 * max(1.0, float(want.abs().max()))
            row = dict(m=m, k=k, n=n, alphabet=alpha)
            calls = [
                ("axllm_simt",
                 lambda: axllm_matmul.launch(x, qt, f32, "tile")),
                ("reuse_table", lambda: reuse_matmul.launch(
                    x, qt, False, f32, "tile")[0])]
            if m >= 16:
                calls += [
                    ("axllm_wgmma",
                     lambda: axllm_matmul.launch(x, qt, f32, "wgmma")),
                    ("reuse_wgmma", lambda: reuse_matmul.launch(
                        x, qt, False, f32, "wgmma")[0])]
            if m in GEMV_M:
                calls += [
                    ("axllm_gemv",
                     lambda: axllm_matmul.launch(x, qt, f32, "gemv")),
                    ("reuse_gemv", lambda: reuse_matmul.launch(
                        x, qt, False, f32, "gemv")[0])]
            for name, fn in calls:
                err = float((fn() - want).abs().max())
                check(err <= tol, f"{name} M{m} N{n}: error {err} > {tol}")
                row[name] = time_ms(fn, flush)
            if m == 4096 and n == 2048 and alpha == "int8":
                # the serving path's bf16 output
                got = axllm_matmul.launch(x, qt, bf16, "wgmma")
                check(torch.equal(got, axllm_matmul.launch(
                    x, qt, f32, "wgmma").to(bf16)), "bf16 output is not the "
                    "f32 output rounded to nearest even")
                row["axllm_wgmma_bf16_out"] = time_ms(
                    lambda: axllm_matmul.launch(x, qt, bf16, "wgmma"), flush)
                row["reuse_wgmma_bf16_out"] = time_ms(
                    lambda: reuse_matmul.launch(x, qt, False, bf16,
                                                "wgmma")[0], flush)
            print(f"tensor-core path vs skinny kernels, M{m} K{k} N{n} "
                  f"{alpha}: " + ", ".join(
                      f"{key} {v:.4f} ms" for key, v in row.items()
                      if key not in ("m", "k", "n", "alphabet")), flush=True)
            sweep.append(row)
    print(f"tensor-core path taken from M = {TC_MIN_M} (TC_MIN_M)",
          flush=True)
    return sweep


def sass_hgmma(lib: str) -> int:
    """The number of HGMMA (wgmma) instructions in a built library."""
    from repro_torch.kernels import _build
    sass = subprocess.run(
        ["/usr/local/cuda/bin/cuobjdump", "--dump-sass",
         str(_build.target(lib))], capture_output=True, text=True,
        check=True).stdout
    return sum("HGMMA" in line for line in sass.splitlines())


# the strip kernel that csrc/quantize.cu replaced, built as its own library
# only to time it beside the cluster kernel ("was"); no path calls it
STRIP_SOURCE = ROOT / "src/repro_torch/baseline/quantize_strip.cu"
# the quantization kernel's shapes: the table's (timed), then the routes of
# its plan (held bit-equal only): K beyond what a cluster holds, ragged N
# (not a multiple of 16, 8 or 4) in stacks
QUANT_TIMED = ((768, 768), (768, 256), (768, 2048), (2048, 768),
               (8192, 2048))
QUANT_ROUTES = ((65536, 96), (3, 300, 130), (2, 300, 100), (2, 70, 37),
                (8192, 130))


def start_strip_build():
    """Start nvcc on the strip kernel (in parallel with the port's build)."""
    from repro_torch.kernels import _build
    out = _build.BUILD_DIR / "quantize_strip.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
           str(STRIP_SOURCE)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), out


def strip_kernel(proc_out):
    """The strip kernel as a function w, bits -> (codes, scale)."""
    import ctypes
    import torch
    proc, out = proc_out
    log = proc.communicate()[0]
    check(proc.returncode == 0, f"nvcc failed for the strip kernel:\n{log}")
    fn = ctypes.CDLL(str(out)).quantize_strip_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(w, bits=8):
        *lead, k, n = w.shape
        codes = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        scale = torch.empty((*lead, 1, n), dtype=torch.float32,
                            device=w.device)
        err = fn(w.data_ptr(), int(w.dtype == torch.bfloat16),
                 codes.data_ptr(), scale.data_ptr(), w.numel() // (k * n), k,
                 n, bits, torch.cuda.current_stream(w.device).cuda_stream)
        check(err == 0, f"strip kernel launch failed: cudaError_t {err}")
        return codes, scale
    return run


def quantize_kernel_phase(dev, flush, strip):
    """The quantization kernel against its plain version: codes and scales
    equal at every shape, type and width (8 and 4 bits at the timed
    shapes, 2 to 8 bits on every route of the plan: K beyond what a
    cluster holds, ragged N, stacks), and on columns that hold a NaN, an
    inf or only zeros, with times at 8 bits beside the strip kernel it
    replaced (``strip``, "was") and the launch floor (a kernel that does
    nothing, timed the same way); then the deploy pass through
    ``ops.quantize_channels`` (the kernel's path) over every projection
    leaf of full-width repro-100m, with the launch count set to 0 just
    before it and read just after. Returns (rows, the pass's metrics)."""
    import torch
    from repro_torch.configs.repro_100m import CONFIG
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.quantize import quantize_cuda, quantize_plan
    from repro_torch.models.model import get_model

    g = torch.Generator(device=dev).manual_seed(2)
    rows = []

    def plan_of(w):
        *lead, k, n = w.shape
        return quantize_plan(w.numel() // (k * n), k, n, w.dtype,
                             _build.sm_count(w.device))

    def held(w, codes, scale, bits, what):
        want_codes, want_scale = ref.quantize_ref(w, bits)
        n_codes = int((codes != want_codes).sum())
        n_scales = int(((scale != want_scale)
                        & ~(scale.isnan() & want_scale.isnan())).sum())
        check(n_codes == 0 and n_scales == 0,
              f"quantize {what}: {n_codes} codes and {n_scales} scales "
              "differ from the plain version")
        return float((codes.int() - want_codes.int()).abs().max())

    floor = time_ms(lambda: torch.cuda._sleep(0), flush)
    print(f"quantize launch floor (a kernel that does nothing, timed the "
          f"same way): {floor:.4f} ms", flush=True)
    for k, n in QUANT_TIMED:
        for dtype in (torch.bfloat16, torch.float32):
            w = (torch.randn(k, n, generator=g, device=dev)
                 * k ** -0.5).to(dtype)
            for bits in (8, 4):
                codes, scale = quantize_cuda(w, bits)
                torch.cuda.synchronize()
                shape = f"K{k} N{n} {str(dtype)[6:]} {bits}b"
                err = held(w, codes, scale, bits, shape)
                ms = time_ms(lambda: quantize_cuda(w, bits), flush)
                plain = time_ms(lambda: ref.quantize_ref(w, bits), flush)
                row = case_row("quantize", shape, err, 0.0, ms, plain,
                               None, nbytes(w, codes, scale), 5.0 * k * n,
                               "float32", "cluster")
                was = time_ms(lambda: strip(w, bits), flush)
                print(f"kernel quantize {shape}: plan {plan_of(w).describe()}"
                      f"; was (strip kernel) {was:.4f} ms; launch floor "
                      f"{floor:.4f} ms", flush=True)
                rows.append(dict(row, was_ms=was, launch_floor_ms=floor,
                                 plan=plan_of(w).describe()))

    routes = []
    for shape in QUANT_ROUTES:
        for dtype in (torch.bfloat16, torch.float32):
            w = (torch.randn(shape, generator=g, device=dev)
                 * 0.05).to(dtype)
            w[..., 1, 3] = 0.0          # a tie column: absmax 127 * 2^-7
            w[..., 0, 3] = 127 * 2.0 ** -7
            w[..., 2, 3] = 2.5 * 2.0 ** -7
            for bits in (8, 7, 4, 3, 2):
                codes, scale = quantize_cuda(w, bits)
                torch.cuda.synchronize()
                held(w, codes, scale, bits, f"{shape} {dtype} {bits}b")
            routes.append(dict(shape=list(shape), dtype=str(dtype)[6:],
                               plan=plan_of(w).describe()))
            print(f"quantize {shape} {str(dtype)[6:]}, bits 8/7/4/3/2: codes "
                  f"and scales equal to the plain version; plan "
                  f"{plan_of(w).describe()}", flush=True)
    special = []
    for shape in ((768, 2048), (3, 300, 130), (65536, 96)):
        for dtype in (torch.bfloat16, torch.float32):
            w = (torch.randn(shape, generator=g, device=dev)
                 * 0.05).to(dtype)
            w[..., 5, 0] = float("nan")
            w[..., 0, 1] = float("inf")
            w[..., 7, 2] = float("-inf")
            w[..., :, 4] = 0.0
            codes, scale = quantize_cuda(w, 8)
            torch.cuda.synchronize()
            held(w, codes, scale, 8, f"NaN/inf/zero columns {shape}")
            check(bool(scale[..., 0].isnan().all()
                       & scale[..., 1].isinf().all())
                  and not codes[..., [0, 1, 2, 4]].any(),
                  f"NaN/inf/zero columns {shape}: wrong scale or codes")
            old_codes, old_scale = strip(w, 8)
            want_codes, want_scale = ref.quantize_ref(w, 8)
            torch.cuda.synchronize()
            old_bad = int((old_codes != want_codes).sum())
            special.append(dict(shape=list(shape), dtype=str(dtype)[6:],
                                strip_kernel_codes_off=old_bad))
            print(f"quantize NaN/inf/zero columns {shape} "
                  f"{str(dtype)[6:]}: codes and scales equal to the plain "
                  f"version (NaN scale, inf scale, codes 0); the strip "
                  f"kernel it replaced gets {old_bad} codes wrong",
                  flush=True)

    params = get_model(CONFIG).init(seed=0, device=dev)
    layers = params["layers"]
    leaves = [layers[grp][name] for grp, names in (
        ("attn", ("wq", "wk", "wv", "wo")), ("ffn", ("gate", "up", "down")))
        for name in names]
    torch.cuda.synchronize()
    _build.reset_launches()
    out = [ops.quantize_channels(w) for w in leaves]
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    check(launches == {"quantize": len(leaves)},
          f"deploy pass launched {launches}, not {len(leaves)} quantize")
    for w, (codes, scale) in zip(leaves, out):
        held(w, codes, scale, 8, f"deploy {tuple(w.shape)}")
    n_mat = sum(w.shape[0] for w in leaves)
    nb = sum(nbytes(w, c, sc) for w, (c, sc) in zip(leaves, out))
    n_w = sum(w.numel() for w in leaves)
    bound_ms, bound_by = bound(nb, 5.0 * n_w, "float32")
    ms = time_ms(lambda: [quantize_cuda(w) for w in leaves], flush, iters=10)
    plain = time_ms(lambda: [ref.quantize_ref(w) for w in leaves], flush,
                    iters=10)
    was = time_ms(lambda: [strip(w) for w in leaves], flush, iters=10)
    plans = {f"{tuple(w.shape)}": plan_of(w).describe() for w in leaves}
    print(f"quantize deploy pass: {n_mat} matrices ({n_w} weights, "
          f"{nb / 1e6:.1f} MB) in {launches['quantize']} launches, codes and "
          f"scales equal to the plain version; {ms:.4f} ms, plain "
          f"{plain:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), was (strip "
          f"kernel) {was:.4f} ms; plans {plans}", flush=True)
    deploy = dict(matrices=n_mat, weights=n_w, bytes=nb, launches=launches,
                  ms=ms, plain_ms=plain, bound_ms=bound_ms, bound_by=bound_by,
                  was_ms=was, launch_floor_ms=floor, plans=plans,
                  routes=routes, nan_inf_zero=special)
    return rows, deploy


def small_input_check(dev):
    """Reduced float32 repro-100m, int8 weights: greedy tokens through the
    kernels equal those through the plain versions, for the dense engine
    and for a paged reuse engine with prefix hits (against the dense
    engine's plain versions)."""
    import numpy as np
    from repro_torch.configs.repro_100m import CONFIG
    from repro_torch.kernels import _build
    from repro_torch.models.model import get_model
    from repro_torch.serve.engine import ServeEngine

    cfg = CONFIG.reduced(dtype="float32", remat=False)
    params = get_model(cfg).init(seed=0, device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (8, 12, 31, 8, 12, 31)]
    head = rng.integers(0, cfg.vocab_size, size=24).astype(np.int32)
    prompts += [np.concatenate([head, rng.integers(0, cfg.vocab_size,
                                                   size=n).astype(np.int32)])
                for n in (3, 9, 5, 12)]

    def serve(impl, **kw):
        return ServeEngine(cfg, params, n_slots=2, max_len=64, quantize=True,
                           impl=impl, device=dev, **kw)

    toks = {impl: serve(impl).generate(prompts, max_new=16)
            for impl in ("cuda", "ref", "reuse_ref")}
    check(toks["cuda"] == toks["ref"],
          "small-input tokens differ between kernel and plain paths")
    eng = serve("reuse", paged=True, kv_block_size=8)
    _build.reset_launches()
    paged = eng.generate(prompts, max_new=16)
    launches = dict(_build.LAUNCHES)
    check(paged == toks["reuse_ref"], "small-input tokens of the paged "
          "reuse engine differ from the dense plain path")
    check(eng.stats.prefix_hit_tokens > 0, "no prefix hit in the paged run")
    for name in ("reuse_matmul", "paged_decode_attention", "flash_attention"):
        check(launches.get(name, 0) > 0, f"{name} never launched in the "
                                         "small paged reuse run")
    print("small-input check: reduced fp32 int8 engine tokens identical "
          "(kernels vs plain versions); paged reuse engine through the "
          "kernels identical to the dense engine through the plain "
          f"versions ({eng.stats.prefix_hit_tokens} prefix-hit tokens)",
          flush=True)


def record_hit_wave(eng) -> dict:
    """Wrap a paged engine's prefill so that it records its first wave with
    a prefix hit: the rows' whole prompts and the first-token logits the
    paged path gave them."""
    import numpy as np
    rec, wave = {}, []
    group_fn, prefill_fn = eng._prefill_group_paged, eng._paged_prefill

    def group(g, free):
        wave[:] = [r.prompt for r in g]
        return group_fn(g, free)

    def prefill(toks, lengths, prefix_len, pbt, sbt, aidx):
        logits = prefill_fn(toks, lengths, prefix_len, pbt, sbt, aidx)
        if pbt is not None and not rec:
            for i, p in enumerate(wave):   # row i: cached head ++ its tail
                check(np.array_equal(np.concatenate(
                    [p[:prefix_len[i]], toks[i, :lengths[i]]]), p),
                    f"prefix-hit wave row {i} is not its request's prompt")
            rec.update(prompts=list(wave), logits=logits[:len(wave)].clone(),
                       hit_tokens=int(prefix_len[:len(wave)].sum()))
        return logits

    eng._prefill_group_paged, eng._paged_prefill = group, prefill
    return rec


def serve_run(dev, card, label, prompts, kernels, names=None,
              registry=None, **engine_kw):
    """One end-to-end run on full-width repro-100m: ``prompts`` through
    ``ServeEngine(quantize=True, n_slots=8, max_len=1024, decode_chunk=8,
    adapters=registry, **engine_kw)``, request i with adapter
    ``names[i]``, with every launch count set to 0 just before and read
    just after, each of ``kernels`` required to have launched. Returns
    (metrics, the engine)."""
    import numpy as np
    import torch
    from repro_torch.configs.repro_100m import CONFIG
    from repro_torch.kernels import _build
    from repro_torch.models.model import get_model
    from repro_torch.serve.engine import ServeEngine, _pow2_bucket
    from repro_torch.serve.token_gate import token_gate

    cfg = CONFIG
    params = get_model(cfg).init(seed=0, device=dev)
    impl = engine_kw.pop("impl", "auto")
    plain_impl = "reuse_ref" if impl == "reuse" else "ref"
    tag = f"e2e {label} [{card}]"
    names = names or [None] * len(prompts)

    def engine(impl):
        return ServeEngine(cfg, params, n_slots=N_SLOTS, max_len=MAX_LEN,
                           quantize=True, decode_chunk=DECODE_CHUNK,
                           impl=impl, adapters=registry, device=dev,
                           **engine_kw)

    engine(impl).generate(prompts[:2], max_new=8,     # warm-up (cuBLAS, etc.)
                          adapters=names[:2])
    eng = engine(impl)
    hit_wave = record_hit_wave(eng) if eng.paged else None
    for p, name in zip(prompts, names):
        eng.submit(p, max_new=MAX_NEW, adapter=name)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    done = {r.rid: r for r in eng.finished}
    check(sorted(done) == list(range(len(prompts))),
          f"{label}: only {len(done)} of {len(prompts)} requests finished")
    for r in done.values():
        check(r.finish_reason == "max_new" and len(r.tokens) == MAX_NEW,
              f"{label}: request {r.rid} stopped {r.finish_reason} after "
              f"{len(r.tokens)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.tokens),
              f"{label}: request {r.rid} has a token outside the vocab")
    for name in kernels:
        check(launches.get(name, 0) > 0, f"{label}: {name} never launched "
                                         "on the main path")
    # every quantized-matmul launch took the tensor cores (prefill) or the
    # split-K decode kernel (decode): none the tile kernel
    for lib in ("axllm_matmul", "reuse_matmul"):
        check(launches.get(lib, 0) == launches.get(f"{lib}.wgmma", 0)
              + launches.get(f"{lib}.gemv", 0), f"{label}: {lib} launches "
              f"{launches.get(lib, 0)} are not wgmma "
              f"{launches.get(f'{lib}.wgmma', 0)} + gemv "
              f"{launches.get(f'{lib}.gemv', 0)}")
    # bf16 prefill: every flash launch takes the tensor cores, 12 (one a
    # layer) per wave that runs flash attention
    check(launches.get("flash_attention.wgmma") ==
          launches.get("flash_attention"), f"{label}: flash launches "
          f"{launches.get('flash_attention')} of which "
          f"{launches.get('flash_attention.wgmma')} on the tensor cores")
    generated = sum(len(r.tokens) for r in done.values())
    st = eng.stats
    print(f"{tag}: {generated} tokens in {wall:.3f} s = "
          f"{generated / wall:.1f} tok/s; decode {st.decode_tokens} tokens "
          f"in {st.steps} steps; prefill {st.prefill_waves} waves, "
          f"{st.prefill_tokens} tokens, {st.prefill_wall_s:.3f} s; "
          f"prefix-hit tokens {st.prefix_hit_tokens}; LoRA requests "
          f"{st.lora_requests}; peak memory "
          f"{peak / 2**30:.3f} GiB", flush=True)
    print(f"{tag}: launches {launches}", flush=True)

    # the token gate: each request's tokens, teacher-forced through the
    # plain path on the kernel path's own prefix
    gate = token_gate(cfg, eng.params, prompts,
                      [done[i].tokens for i in range(len(prompts))],
                      impl=plain_impl, tol_rel=LOGIT_TOL, device=dev,
                      registry=registry, names=names)
    print(f"{tag}: token gate: {gate.positions} generated positions checked "
          f"against the plain path's teacher-forced logits; {gate.differ} "
          f"where the token is not the plain path's argmax; smallest slack "
          f"{gate.min_slack:.4e} (request {gate.worst[0]}, position "
          f"{gate.worst[1]}); {len(gate.failures)} positions more than "
          f"2 x tol below the plain maximum", flush=True)
    check(gate.ok, f"{label}: token gate failed at (request, position, "
                   f"slack) {gate.failures[:5]}")
    def dense_logits(which, wave, wave_names=None):
        """First-token logits of a plain dense prefill of ``wave``, row i
        with adapter ``wave_names[i]`` (all base when None)."""
        pl = _pow2_bucket(max(len(p) for p in wave), 8, MAX_LEN)
        toks = np.zeros((len(wave), pl), np.int32)
        for i, p in enumerate(wave):
            toks[i, :len(p)] = p
        lengths = torch.tensor([len(p) for p in wave], dtype=torch.int32,
                               device=dev)
        lora = {}
        if registry is not None:
            rows = [-1 if n is None else registry.index_of(n)
                    for n in wave_names or [None] * len(wave)]
            lora = dict(adapters=registry.stacked,
                        adapter_idx=torch.tensor(rows, dtype=torch.int32,
                                                 device=dev),
                        lora_scaling=registry.scaling)
        api = get_model(cfg, impl=which)
        with torch.inference_mode():
            return api.prefill(
                eng.params, {"tokens": torch.from_numpy(toks).to(dev)},
                api.init_cache(len(wave), pl, dev), lengths=lengths,
                **lora)[0]

    def hold(what, a, b):
        a, b = a.float(), b.float()
        check(bool(torch.isfinite(a).all()), f"{label}: non-finite {what}")
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        ka = a[:, :cfg.vocab_size].argmax(-1)
        kb = b[:, :cfg.vocab_size].argmax(-1)
        agree = float((ka == kb).float().mean())
        # where the argmax differs: the plain path's own margin between its
        # top token and the kernel path's (a near-tie when below err)
        gaps = [float(b[i, kb[i]] - b[i, ka[i]])
                for i in range(len(ka)) if ka[i] != kb[i]]
        print(f"{tag}: {what} |kernel - plain| = {err:.4e}, scale "
              f"{scale:.4f}, tolerance {LOGIT_TOL * max(1.0, scale):.4e}; "
              f"argmax agreement {agree:.3f}"
              + ("" if not gaps else "; plain-path logit margin of the "
                 "differing rows " + ", ".join(f"{x:.4e}" for x in gaps)),
              flush=True)
        check(err <= LOGIT_TOL * max(1.0, scale),
              f"{label}: {what} differ by {err}")
        return err, scale, agree

    # first wave (no prefix hit: the plain ragged prefill) against the
    # plain path, same card and weights
    wave, wave_names = prompts[:N_SLOTS], names[:N_SLOTS]
    served = dense_logits(impl, wave, wave_names)
    logit_err, scale, argmax_agree = hold(
        "first-wave logits", served, dense_logits(plain_impl, wave,
                                                  wave_names))
    hit = {}
    if registry is not None:
        # the delta ran: each adapter row's logits move beyond the
        # tolerance from the same prompt's base logits
        base = dense_logits(impl, wave).float()
        tol = LOGIT_TOL * max(1.0, scale)
        moved = {}
        for i, name in enumerate(wave_names):
            if name is not None:
                moved[i] = float((served[i].float() - base[i]).abs().max())
                check(moved[i] > tol, f"{label}: row {i} ({name}) logits "
                                      f"moved only {moved[i]} from base")
        print(f"{tag}: adapter rows' first-wave logits move "
              f"{min(moved.values()):.4f}-{max(moved.values()):.4f} from "
              f"the same prompts' base logits (tolerance {tol:.4e})",
              flush=True)
        hit["adapter_logit_moved"] = moved
    if eng.paged:
        # the served wave with a prefix hit (prefix KV gathered out of the
        # pool, suffix-only prefill) against a plain dense prefill of the
        # whole prompts
        check(bool(hit_wave), f"{label}: no prefill wave had a prefix hit")
        err, hscale, agree = hold(
            f"prefix-hit wave ({len(hit_wave['prompts'])} rows, "
            f"{hit_wave['hit_tokens']} cached tokens) logits",
            hit_wave["logits"], dense_logits(plain_impl, hit_wave["prompts"]))
        hit = dict(hit_wave_logit_err=err, hit_wave_logit_scale=hscale,
                   hit_wave_argmax_agree=agree,
                   hit_wave_cached_tokens=hit_wave["hit_tokens"])

    # where the decode time goes: 4 chunks of 8 full slots, profiled
    prof_eng = engine(impl)
    for p, name in zip(prompts[:N_SLOTS], names):
        prof_eng.submit(p, max_new=MAX_NEW, adapter=name)
    prof_eng.step()                                  # prefill + 1st chunk
    wall_ms, busy_ms, top = device_busy_ms(
        lambda: [prof_eng.step() for _ in range(4)])
    idle = 1.0 - busy_ms / wall_ms
    print(f"{tag}: 4 decode chunks (32 steps, 8 slots): wall "
          f"{wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, idle share "
          f"{idle:.3f}", flush=True)
    for name, ms in top[:8]:
        print(f"{tag}:   device {ms:8.3f} ms  {name[:90]}", flush=True)
    # where a prefill wave's time goes: the first wave's prefill through
    # the kernel path (as served: the same model call), profiled
    p_wall, p_busy, p_top = device_busy_ms(
        lambda: dense_logits(impl, wave, wave_names))
    flash_ms = sum(ms for name, ms in p_top if "flash" in name)
    print(f"{tag}: one prefill wave ({len(wave)} rows): wall {p_wall:.2f} "
          f"ms, device busy {p_busy:.2f} ms, idle share "
          f"{1.0 - p_busy / p_wall:.3f}; flash attention {flash_ms:.3f} ms "
          f"device", flush=True)

    plain = engine(plain_impl)
    for p, name in zip(prompts, names):
        plain.submit(p, max_new=MAX_NEW, adapter=name)
    plain.run()
    ptoks = {r.rid: r.tokens for r in plain.finished}
    same = sum(done[i].tokens == ptoks[i] for i in done)
    agree = np.mean([np.mean(np.equal(done[i].tokens, ptoks[i]))
                     for i in done])
    print(f"{tag}: greedy tokens vs plain path: {same}/{len(prompts)} "
          f"requests identical, {agree:.3f} of positions equal", flush=True)
    return dict(tokens=generated, wall_s=wall, tok_per_s=generated / wall,
                prefill_wall_s=st.prefill_wall_s, steps=st.steps,
                prefill_waves=st.prefill_waves,
                prefill_tokens=st.prefill_tokens,
                lora_requests=st.lora_requests,
                prefix_hit_tokens=st.prefix_hit_tokens,
                blocks_in_use=st.blocks_in_use, peak_bytes=peak,
                launches=launches, logit_err=logit_err, logit_scale=scale,
                gate=dict(positions=gate.positions, differ=gate.differ,
                          min_slack=gate.min_slack,
                          failures=len(gate.failures)),
                first_wave_argmax_agree=argmax_agree, **hit,
                requests_identical=same, position_agree=float(agree),
                decode_profile=dict(wall_ms=wall_ms, busy_ms=busy_ms,
                                    idle_share=idle, top=top),
                prefill_profile=dict(wall_ms=p_wall, busy_ms=p_busy,
                                     flash_ms=flash_ms, top=p_top[:8])), eng


def run_a_prompts() -> list:
    """Run a's 16 prompts (64/200/511 tokens, numpy seed 0), which runs c
    and d serve too."""
    return prompt_cycle(N_REQUESTS)


def end_to_end(dev, card):
    return serve_run(dev, card, "dense", run_a_prompts(), (
        "axllm_matmul", "axllm_matmul.wgmma", "axllm_matmul.gemv",
        "decode_attention",
        "flash_attention", "flash_attention.wgmma"))[0]


def layer0_reuse_rates(eng, label, card, rows=(N_SLOTS,)) -> dict:
    """The reuse rate the kernel counts on each quantized projection of
    layer 0 of ``eng``'s served weights, on a call of each M in ``rows``
    (each through the path serving takes at that M), each count held
    against ``reuse_mult_count``, beside the analytic Gaussian model."""
    import torch
    from repro_torch.core.quantization import QTensor
    from repro_torch.core.reuse import expected_reuse_rate
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.reuse_matmul import segment
    from repro_torch.models.transformer import layer_slice

    layer0 = layer_slice(eng.params["layers"], 0)
    predicted = expected_reuse_rate(256, 128, "gaussian")
    rates = {}
    for group in ("attn", "ffn"):
        for name, qt in layer0[group].items():
            if not isinstance(qt, QTensor):
                continue
            k, n = qt.shape
            count = ref.reuse_mult_count(qt, segment(n))
            for m in rows:
                x = torch.ones((m, k), dtype=torch.bfloat16,
                               device=qt.codes.device)
                _, mults = ops.reuse_matmul(x, qt, impl="reuse",
                                            with_stats=True)
                check(int(mults) == count, f"{label}: layer-0 {name} M{m}: "
                      f"kernel counted {int(mults)}, host {count}")
            rates[name] = 1.0 - count / (k * n)
            print(f"e2e {label} [{card}]: layer 0 {name} K{k} N{n} "
                  f"{qt.bits}b-{qt.mode}: reuse rate {rates[name]:.4f} "
                  f"(kernel count {count} = reuse_mult_count at M "
                  f"{', '.join(f'{m} [{path_of(m, x, qt)}]' for m in rows)}"
                  f"; analytic gaussian model {predicted:.4f})", flush=True)
    return dict(reuse_rate_layer0=rates, reuse_rate_predicted=predicted)


def end_to_end_reuse_paged(dev, card):
    """Run b, and the reuse rate the kernel achieves on layer 0's seven
    projections of the served weights."""
    import numpy as np
    from repro_torch.configs.repro_100m import CONFIG

    rng = np.random.default_rng(1)
    vocab = CONFIG.vocab_size
    head = rng.integers(0, vocab, size=SHARED_PREFIX).astype(np.int32)
    prompts = [np.concatenate([head, rng.integers(
        0, vocab, size=TAIL_LENS[i % len(TAIL_LENS)]).astype(np.int32)])
        for i in range(N_REQUESTS)]
    e2e, eng = serve_run(dev, card, "reuse+paged", prompts, (
        "reuse_matmul", "reuse_matmul.wgmma", "reuse_matmul.gemv",
        "paged_decode_attention",
        "flash_attention", "flash_attention.wgmma"),
        impl="reuse", paged=True, kv_block_size=KV_BLOCK)
    check(e2e["prefix_hit_tokens"] >= N_SLOTS * SHARED_PREFIX,
          f"reuse+paged: only {e2e['prefix_hit_tokens']} prefix-hit tokens")
    e2e.update(layer0_reuse_rates(eng, "reuse+paged", card))
    return e2e


def end_to_end_lora(dev, card):
    """Run c: run a's prompts on the reuse pipeline with fused projections
    and four LoRA adapters, the requests cycling base/a0/a1/a2/a3; the
    counted reuse rate of layer 0's fused wqkv and gate_up."""
    import numpy as np
    from repro_torch.bridge import registry_from_numpy
    from repro_torch.configs.repro_100m import CONFIG
    from repro_torch.core.axllm_linear import LoRAConfig
    from repro_torch.serve.adapters import target_dims

    lcfg = LoRAConfig()
    rng = np.random.default_rng(3)
    nl, r, n_ad = CONFIG.n_layers, lcfg.rank, len(ADAPTERS)
    stacked = {}
    for t in lcfg.targets:
        n_in, n_out = target_dims(CONFIG, t)
        stacked[t] = {
            "lora_a": (rng.standard_normal((nl, n_ad, n_in, r))
                       / np.sqrt(r)).astype(np.float32),
            "lora_b": (rng.standard_normal((nl, n_ad, r, n_out))
                       * LORA_B_STD).astype(np.float32)}
    registry = registry_from_numpy(CONFIG, stacked, list(ADAPTERS), lcfg,
                                   device=dev)
    prompts = run_a_prompts()
    cycle = (None,) + ADAPTERS
    names = [cycle[i % len(cycle)] for i in range(N_REQUESTS)]
    e2e, eng = serve_run(dev, card, "lora+reuse+fused", prompts, (
        "reuse_matmul", "reuse_matmul.wgmma", "reuse_matmul.gemv",
        "decode_attention",
        "flash_attention", "flash_attention.wgmma"), names=names,
        registry=registry, impl="reuse", fuse_qkv=True)
    check(e2e["lora_requests"] == sum(n is not None for n in names),
          f"lora+reuse+fused: {e2e['lora_requests']} LoRA requests admitted")
    e2e.update(layer0_reuse_rates(eng, "lora+reuse+fused", card))
    check({"wqkv", "gate_up"} <= set(e2e["reuse_rate_layer0"]),
          "lora+reuse+fused: layer 0 is not fused")
    return e2e


def end_to_end_nf4(dev, card):
    """Run d: run a's prompts through a reuse engine on NF4 weights (4-bit
    codebook, packed, per channel: the QLoRA-style base). Every prefill
    projection takes the codebook route of the tensor cores and every
    decode projection the split-K table kernel; layer 0's counted reuse
    rates on both paths."""
    from repro_torch.configs.repro_100m import CONFIG
    from repro_torch.core.quantization import QTensor

    e2e, eng = serve_run(dev, card, "nf4+reuse", run_a_prompts(), (
        "reuse_matmul", "reuse_matmul.wgmma", "reuse_matmul.gemv",
        "decode_attention",
        "flash_attention", "flash_attention.wgmma"),
        impl="reuse", quant_bits=4, quant_mode="codebook")
    wq = eng.params["layers"]["attn"]["wq"]
    check(isinstance(wq, QTensor) and (wq.bits, wq.mode, wq.packed) ==
          (4, "codebook", True), "nf4+reuse: the engine does not serve "
          "packed NF4 weights")
    # one launch per projection and layer: every prefill one on the tensor
    # cores, every decode one on the split-K kernel
    n_proj = 7 * CONFIG.n_layers
    got = e2e["launches"]
    check(got.get("reuse_matmul.wgmma") == n_proj * e2e["prefill_waves"],
          f"nf4+reuse: {got.get('reuse_matmul.wgmma')} tensor-core launches "
          f"for {e2e['prefill_waves']} prefill waves of {n_proj} "
          "projections")
    check(got.get("reuse_matmul.gemv") == n_proj * e2e["steps"],
          f"nf4+reuse: {got.get('reuse_matmul.gemv')} decode launches for "
          f"{e2e['steps']} decode steps of {n_proj} projections")
    e2e.update(layer0_reuse_rates(eng, "nf4+reuse", card,
                                  rows=(N_SLOTS, 512)))
    return e2e


def prompt_cycle(n: int) -> list:
    """``n`` prompts on run a's cycle of lengths (64/200/511 tokens, numpy
    seed 0): the first 16 are run a's."""
    import numpy as np
    from repro_torch.configs.repro_100m import CONFIG
    rng = np.random.default_rng(0)
    return [rng.integers(0, CONFIG.vocab_size,
                         size=PROMPT_LENS[i % len(PROMPT_LENS)])
            .astype(np.int32) for i in range(n)]


def check_fast_restores(eng) -> dict:
    """Wrap a paged engine's swap-out and fast restore so that each fast
    restore is held to the KV its slot had at swap-out, bit for bit (the
    full blocks through the radix index, the tail through the host copy).
    Returns the running tally."""
    import torch
    tally, kv_at_swap = dict(checked=0), {}
    preempt, restore = eng._preempt_slot, eng._try_fast_restore

    def slot_kv(slot, n):
        idx = torch.tensor(eng.pager.slot_blocks(slot), device=eng.device)
        return {name: eng.cache[name][:, idx].flatten(1, 2)[:, :n].clone()
                for name in eng._pool_leaves}

    def preempt_slot(i):
        r = eng.slots[i]
        if not r.prefilling:
            kv_at_swap[r.rid] = slot_kv(i, len(eng._kv_seq(r)))
        preempt(i)

    def try_fast_restore(r, slot):
        if not restore(r, slot):
            return False
        want = kv_at_swap.pop(r.rid)
        got = slot_kv(slot, next(iter(want.values())).shape[1])
        for name in want:
            check(torch.equal(got[name], want[name]), f"fast restore of "
                  f"request {r.rid}: {name} differs from its KV at swap-out")
        tally["checked"] += 1
        return True

    eng._preempt_slot, eng._try_fast_restore = preempt_slot, try_fast_restore
    return tally


def percentiles(xs) -> tuple:
    import numpy as np
    return float(np.percentile(xs, 50)), float(np.percentile(xs, 99))


def end_to_end_overload(dev, card):
    """Run e: run a's prompt cycle on a paged int8 engine whose pool cannot
    hold eight seated requests to their end, under a prefill budget, with
    priority arrivals, two streams (one hanging up) and a cancel while
    queued; beside it the same prompts on an unloaded engine of the same
    kernels, and a profiled step that holds a continuation chunk."""
    import numpy as np
    import torch
    from repro_torch.configs.repro_100m import CONFIG
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import ref as plain
    from repro_torch.models.model import get_model
    from repro_torch.serve.engine import ServeEngine, StopStream
    from repro_torch.serve.token_gate import token_gate

    cfg = CONFIG
    params = get_model(cfg).init(seed=0, device=dev)
    prompts = prompt_cycle(E_REQUESTS)
    tag = f"e2e overload+chunked [{card}]"
    smallest_pool = N_SLOTS * -(-MAX_LEN // KV_BLOCK) + 2

    def engine(squeeze=False, **kw):
        """An engine of run e's kernels; ``squeeze``: run e's budget and a
        pool of E_USABLE free blocks (the rest held in ``eng.held``)."""
        if squeeze:
            kw.update(prefill_budget=E_BUDGET, num_blocks=smallest_pool)
        eng = ServeEngine(cfg, params, n_slots=N_SLOTS, max_len=MAX_LEN,
                          quantize=True, decode_chunk=DECODE_CHUNK,
                          paged=True, kv_block_size=KV_BLOCK, device=dev,
                          **kw)
        eng.held = [eng.pager.alloc() for _ in range(
            len(eng.pager._free) - E_USABLE)] if squeeze else []
        return eng

    def serve(eng, late_after=None):
        """Step ``eng`` to the end; the late requests go in after step
        ``late_after``. Returns per-step (wall s, prefill tokens, whether
        a slot was mid-prefill when the step began)."""
        steps = []
        while True:
            st = eng.stats
            before = st.prefill_tokens
            cont = any(s is not None and s.prefilling for s in eng.slots)
            t0 = time.perf_counter()
            more = eng.step()
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0,
                          st.prefill_tokens - before, cont))
            eng.pager.check_consistency(external=eng.held)
            if not more:
                return steps
            if len(steps) == late_after:
                free = sum(s is None for s in eng.slots)
                check(free < E_LATE, f"run e: {free} free slots take all "
                      "the priority arrivals")
                for i in range(E_REQUESTS - E_LATE, E_REQUESTS):
                    eng.submit(prompts[i], max_new=MAX_NEW, priority=1)

    engine(squeeze=True).generate(prompts[:2], max_new=8)     # warm-up
    eng = engine(squeeze=True)
    restores = check_fast_restores(eng)
    by_priority, priority_preempt = [0], eng._priority_preempt

    def counted_priority_preempt():
        before = eng.stats.preempted
        priority_preempt()
        by_priority[0] += eng.stats.preempted - before

    eng._priority_preempt = counted_priority_preempt
    streamed = {}

    def tap(req, tok):
        streamed.setdefault(req.rid, []).append(tok)

    def hang_up(req, tok):
        tap(req, tok)
        if len(streamed[req.rid]) == E_HANGUP_AFTER:
            raise StopStream()

    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    for i in range(E_REQUESTS - E_LATE):
        eng.submit(prompts[i], max_new=MAX_NEW,
                   on_token={E_STREAM: tap, E_HANGUP: hang_up}.get(i))
    check(eng.cancel(E_CANCEL), "run e: the queued cancel found nothing")
    steps = serve(eng, late_after=2)
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)

    st = eng.stats
    done = {r.rid: r for r in eng.finished}
    check(len(eng.finished) == len(done) == E_REQUESTS
          and sorted(done) == list(range(E_REQUESTS)),
          f"run e: {len(eng.finished)} finishes of {len(done)} requests")
    for rid, r in done.items():
        want = {E_CANCEL: ("cancelled", 0), E_HANGUP: (
            "cancelled", E_HANGUP_AFTER)}.get(rid, ("max_new", MAX_NEW))
        check((r.finish_reason, len(r.tokens)) == want, f"run e: request "
              f"{rid} ended {r.finish_reason} with {len(r.tokens)} tokens")
    for rid in (E_STREAM, E_HANGUP):
        check(streamed.get(rid) == done[rid].tokens, f"run e: request {rid} "
              "streamed other tokens than it holds")
    check(by_priority[0] > 0 and st.preempted > by_priority[0]
          and st.restored == st.preempted, f"run e: {st.preempted} "
          f"preemptions ({by_priority[0]} for priority), {st.restored} "
          "restores")
    check(restores["checked"] == st.fast_restores, "run e: a fast restore "
          "went unchecked")
    most = max(p for _, p, _ in steps)
    continuation_steps = sum(c for *_, c in steps)
    check(st.prefill_chunks > st.prefill_waves and continuation_steps > 0
          and most <= E_BUDGET, f"run e: {st.prefill_chunks} chunks in "
          f"{st.prefill_waves} waves, {continuation_steps} steps with a "
          f"continuation, at most {most} prefill tokens a step")
    check(not eng.queue and all(s is None for s in eng.slots)
          and eng.registry is None, "run e: the engine did not drain")
    for b in eng.held:
        eng.pager._release_block(b)
    eng.pager.evict_prefixes()
    check(eng.pager.blocks_in_use == 0, f"run e: {eng.pager.blocks_in_use} "
          "pool blocks held after the drain")
    check(launches.get("axllm_matmul", 0) == launches.get(
        "axllm_matmul.wgmma", 0) + launches.get("axllm_matmul.gemv", 0),
        f"run e: axllm_matmul launches {launches} are not wgmma + gemv")
    for name in ("axllm_matmul.wgmma", "axllm_matmul.gemv",
                 "paged_decode_attention", "flash_attention.wgmma"):
        check(launches.get(name, 0) > 0, f"run e: {name} never launched")
    check(launches.get("flash_attention") == launches.get(
        "flash_attention.wgmma"), f"run e: flash launches {launches}")
    generated = sum(len(r.tokens) for r in done.values())
    ttft = [r.t_first - r.t_submit for r in done.values()
            if r.t_first is not None]
    p50, p99 = percentiles(ttft)
    step_max = max(w for w, *_ in steps)
    print(f"{tag}: {generated} tokens in {wall:.3f} s = {generated / wall:.1f}"
          f" tok/s; {len(steps)} steps; preempted {st.preempted} (for "
          f"priority {by_priority[0]}, mid-prefill {st.preempted_prefill}), "
          f"restored {st.restored} (fast {st.fast_restores}, each bit-exact "
          f"to its KV at swap-out), cancelled {st.cancelled}; prefill "
          f"{st.prefill_chunks} chunks in {st.prefill_waves} waves, "
          f"{continuation_steps} steps with a "
          f"continuation, at most {most} prompt tokens a step (budget "
          f"{E_BUDGET}), {st.prefill_tokens} tokens, prefix-hit tokens "
          f"{st.prefix_hit_tokens}; pool {E_USABLE} usable blocks", flush=True)
    print(f"{tag}: launches {launches}", flush=True)
    gate = token_gate(cfg, eng.params, prompts,
                      [done[i].tokens for i in range(E_REQUESTS)],
                      impl="ref", tol_rel=LOGIT_TOL, device=dev)
    print(f"{tag}: token gate: {gate.positions} generated positions checked "
          f"against the plain path's teacher-forced logits; {gate.differ} "
          f"where the token is not the plain path's argmax; smallest slack "
          f"{gate.min_slack:.4e}; {len(gate.failures)} positions more than "
          f"2 x tol below the plain maximum", flush=True)
    check(gate.ok, f"run e: token gate failed at (request, position, slack) "
                   f"{gate.failures[:5]}")

    # the same prompts on an unloaded engine of the same kernels: default
    # pool, no budget, all at priority 0
    calm = engine()
    c0 = time.perf_counter()
    for p in prompts:
        calm.submit(p, max_new=MAX_NEW)
    calm_steps = serve(calm)
    calm_wall = time.perf_counter() - c0
    calm_done = {r.rid: r for r in calm.finished}
    c50, c99 = percentiles([r.t_first - r.t_submit
                            for r in calm_done.values()])
    served = [i for i in range(E_REQUESTS) if i not in (E_CANCEL, E_HANGUP)]
    same = sum(done[i].tokens == calm_done[i].tokens for i in served)
    agree = float(np.mean([np.mean(np.equal(done[i].tokens,
                                            calm_done[i].tokens))
                           for i in served]))
    calm_max = max(w for w, *_ in calm_steps)
    print(f"{tag}: TTFT p50 {p50 * 1e3:.1f} ms, p99 {p99 * 1e3:.1f} ms, "
          f"largest step {step_max * 1e3:.1f} ms; unloaded engine: TTFT p50 "
          f"{c50 * 1e3:.1f} ms, p99 {c99 * 1e3:.1f} ms, largest step "
          f"{calm_max * 1e3:.1f} ms, {len(calm_steps)} steps, "
          f"{calm_wall:.3f} s", flush=True)
    print(f"{tag}: greedy tokens vs the unloaded engine: {same}/{len(served)}"
          f" requests identical, {agree:.3f} of positions equal (not "
          "required: budgeted chunks and recompute restores run other "
          "shapes)", flush=True)

    # where a continuation step's time goes: a fresh loaded engine, its
    # second step (the first leaves a slot mid-prefill), profiled, with the
    # plain prefix attention's share (annotated, and its calls replayed)
    prof_eng = engine(squeeze=True)
    for p in prompts[:E_REQUESTS - E_LATE]:
        prof_eng.submit(p, max_new=MAX_NEW)
    prof_eng.step()
    check(any(s is not None and s.prefilling for s in prof_eng.slots),
          "run e: no slot is mid-prefill after the first step")
    calls, prefix_attention = [], ops.prefix_attention

    def annotated(*args, **kw):
        calls.append(args)
        with torch.profiler.record_function("prefix_attention"):
            return prefix_attention(*args, **kw)

    ops.prefix_attention = annotated
    try:
        p_wall, p_busy, p_top, p_prefix = profile_step(
            prof_eng.step, "prefix_attention")
    finally:
        ops.prefix_attention = prefix_attention
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    replayed = sum(time_ms(lambda a=a: plain.prefix_attention_ref(*a), flush)
                   for a in calls)
    rows = {tuple(a[0].shape[:2]) + (a[1].shape[1],) for a in calls}
    print(f"{tag}: one step with a continuation chunk ({len(calls)} prefix "
          f"attention calls, q B x S and prefix P {sorted(rows)}): wall "
          f"{p_wall:.2f} ms, device busy {p_busy:.2f} ms, idle share "
          f"{1.0 - p_busy / p_wall:.3f}; plain prefix_attention "
          f"{p_prefix:.3f} ms device ({p_prefix / p_busy:.3f} of busy); its "
          f"calls replayed alone (L2 flushed) {replayed:.3f} ms", flush=True)
    for name, ms in p_top[:8]:
        print(f"{tag}:   device {ms:8.3f} ms  {name[:90]}", flush=True)
    return dict(tokens=generated, wall_s=wall, tok_per_s=generated / wall,
                steps=len(steps), launches=launches, stats=st.as_dict(),
                priority_preemptions=by_priority[0],
                max_prefill_tokens_a_step=most,
                continuation_steps=continuation_steps,
                fast_restores_checked=restores["checked"],
                ttft_p50_s=p50, ttft_p99_s=p99, max_step_s=step_max,
                gate=dict(positions=gate.positions, differ=gate.differ,
                          min_slack=gate.min_slack,
                          failures=len(gate.failures)),
                unloaded=dict(ttft_p50_s=c50, ttft_p99_s=c99,
                              max_step_s=calm_max, steps=len(calm_steps),
                              wall_s=calm_wall, requests_identical=same,
                              position_agree=agree),
                continuation_profile=dict(
                    wall_ms=p_wall, busy_ms=p_busy,
                    prefix_attention_ms=p_prefix,
                    prefix_attention_share=p_prefix / p_busy,
                    prefix_attention_replayed_ms=replayed, calls=len(calls),
                    top=p_top[:8]))


def profile_step(fn, annotation: str) -> tuple:
    """``device_busy_ms`` of ``fn`` plus the device ms of the kernels
    launched inside ``record_function(annotation)`` ranges. The range also
    shows on the device's timeline (first kernel to last, idle gaps
    included); it is no kernel and counts in neither sum."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name, marked = {}, 0.0
    for e in prof.events():
        if e.name == annotation:
            if e.device_type == DeviceType.CPU:
                marked += e.device_time_total / 1e3
        elif e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return wall, sum(by_name.values()), top, marked


def chaos_phase(dev, card) -> dict:
    """The seven chaos scenarios (smoke mode) on the harness's own f32
    model through the kernels: no request lost, no block or pin leaked,
    the pager consistent after every step (checked inside the harness),
    and every request whose tokens differ from the card's own fault-free
    run held to the token gate."""
    from repro_torch.kernels import _build
    from repro_torch.serve import chaos
    from repro_torch.serve.adapters import make_synthetic_adapters
    from repro_torch.serve.token_gate import token_gate

    _build.reset_launches()
    t0 = time.perf_counter()
    reports = chaos.run(smoke=True, device=dev)
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    out = {}
    for rep in reports:
        tag = f"chaos {rep.scenario} [{card}]"
        check(rep.lost == 0 and not rep.errors,
              f"{tag}: lost {rep.lost}, errors {rep.errors}")
        for m in rep.mismatches:
            registry = None
            if m["adapter"] is not None:   # the scenario evicted its own
                registry, _ = make_synthetic_adapters(chaos.CFG, 2,
                                                      device=dev)
            gate = token_gate(chaos.CFG, rep.engine.params, [m["prompt"]],
                              [m["tokens"]], impl="ref", tol_rel=LOGIT_TOL,
                              device=dev, registry=registry,
                              names=[m["adapter"]])
            print(f"{tag}: request {m['rid']} ({m['finish_reason']}, "
                  f"preempted {m['preemptions']}x) tokens {m['tokens']} "
                  f"differ from the fault-free run's {m['reference']}; "
                  f"token gate smallest slack {gate.min_slack:.4e}",
                  flush=True)
            check(gate.ok, f"{tag}: request {m['rid']} fails the token gate "
                           f"at {gate.failures[:5]}")
        print(f"{tag}: {rep.submitted} submitted, {rep.finished} finished, "
              f"rejected {rep.rejected}, expired {rep.expired}, cancelled "
              f"{rep.cancelled}, preempted {rep.preempted} (mid-prefill "
              f"{rep.preempted_prefill}), restored {rep.restored} (fast "
              f"{rep.fast_restores}), faults {rep.faults_injected}, retries "
              f"{rep.step_retries}, lost 0, {rep.mismatched} differing from "
              "the fault-free run (each within the token gate)", flush=True)
        out[rep.scenario] = rep.as_dict()
    for name in ("axllm_matmul", "decode_attention", "paged_decode_attention",
                 "flash_attention"):
        check(launches.get(name, 0) > 0, f"chaos: {name} never launched")
    print(f"chaos [{card}]: {len(reports)} scenarios in {wall:.1f} s; "
          f"launches {launches}", flush=True)
    return dict(scenarios=out, wall_s=wall, launches=launches)


PREFILL_SHAPE = "M4096 K768 N2048 8b-affine-per_channel"
CODEBOOK_SHAPE = "M4096 K768 N2048 4b-codebook-per_channel"

# kernel -> (the TPU kernel it replaces, the main shape reported, the
# end-to-end run whose launch count is reported)
KERNELS = {
    "axllm_matmul": ("src/repro/kernels/axllm_matmul.py:104",
                     "M8 K768 N2048 8b-affine-per_channel", "dense"),
    "decode_attention": ("src/repro/kernels/decode_attention.py:71",
                         "B8 S1024 H12 Hk4 d64 bf16-kv", "dense"),
    "flash_attention": ("src/repro/kernels/flash_attention.py:81",
                        "B8 Sq512 Sk512 H12 Hk4 d64 causal", "dense"),
    "reuse_matmul": ("src/repro/kernels/reuse_matmul.py:115",
                     "M8 K768 N2048 8b-affine-per_channel", "reuse+paged"),
    "paged_decode_attention": (
        "src/repro/kernels/paged_decode_attention.py:81",
        "B8 H12 Hk4 d64 bs16 MB64 bf16-kv", "reuse+paged"),
    "quantize": ("src/repro/kernels/quantize.py:33", "K768 N2048 bfloat16 8b",
                 "deploy"),
}
# the path of each kernel's main row: the one its serving path takes
MAIN_PATH = {"flash_attention": "wgmma", "axllm_matmul": "gemv",
             "reuse_matmul": "gemv"}
ROW_KEYS = ("max_abs_err", "tolerance", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    card = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)

    t0 = time.perf_counter()
    strip_build = start_strip_build()
    logs = _build.build()
    strip = strip_kernel(strip_build)
    print(f"built {len(_build.LIBRARIES)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s ({len(logs)} compiled)",
          flush=True)
    hgmma = {lib: sass_hgmma(lib) for lib in ("axllm_matmul", "reuse_matmul",
                                              "flash_attention")}
    for lib, count in hgmma.items():
        print(f"sass {lib}: {count} HGMMA instructions", flush=True)
        check(count > 0, f"{lib} has no tensor-core (HGMMA) instruction")
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke_nvcc.log").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in logs.items()))

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = kernel_phase(dev, flush) + reuse_paged_kernel_phase(dev, flush)
    rows += codebook_kernel_phase(dev, flush)
    sweep = tensor_core_phase(dev, flush)
    q_rows, deploy = quantize_kernel_phase(dev, flush, strip)
    rows += q_rows
    small_input_check(dev)
    e2e = {"dense": end_to_end(dev, card),
           "reuse+paged": end_to_end_reuse_paged(dev, card),
           "lora+reuse+fused": end_to_end_lora(dev, card),
           "nf4+reuse": end_to_end_nf4(dev, card),
           "overload+chunked": end_to_end_overload(dev, card),
           "deploy": deploy}
    chaos = chaos_phase(dev, card)

    kernels = []
    for name, (replaces, main_shape, run) in KERNELS.items():
        row = next(r for r in rows
                   if r["kernel"] == name and r["shape"] == main_shape
                   and r["path"] == MAIN_PATH.get(name, r["path"]))
        kernels.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{name}.cu",
            replaces=replaces, launches=e2e[run]["launches"][name],
            **{key: row[key] for key in ROW_KEYS},
            shape=main_shape, launches_from=run))
        if name in ("axllm_matmul", "reuse_matmul"):
            # the main row is the decode kernel; beside it the tile kernel
            # at the same shape (for axllm_matmul the path the row took
            # before it; reuse_matmul's took a split-K table kernel that
            # the decode kernel replaced: chip_ab.py times it)
            kernels[-1].update(
                path="gemv", skeleton="src/repro_torch/csrc/quant_gemv.cuh",
                gemv_launches=e2e[run]["launches"][f"{name}.gemv"],
                tile_ms=row["tile_ms"], emulation_err=row["emulation_err"],
                blocks=row["blocks"])
            if name == "axllm_matmul":   # its tile kernel is the old path
                kernels[-1]["was"] = dict(path="simt", ms=row["tile_ms"])
            # the prefill path: the library's tensor-core entry point
            tc = next(r for r in rows if r["kernel"] == name
                      and r["shape"] == PREFILL_SHAPE)
            kernels[-1]["tensor_core"] = dict(
                source="src/repro_torch/csrc/quant_gemm_sm90.cuh",
                shape=PREFILL_SHAPE, hgmma_instructions=hgmma[name],
                launches=e2e[run]["launches"][f"{name}.wgmma"],
                **{key: tc[key] for key in ROW_KEYS})
            # its codebook route (NF4); run d serves it through reuse_matmul,
            # and no run serves axllm_matmul on a codebook: no count is read
            # for it
            cb = next(r for r in rows if r["kernel"] == name
                      and r["shape"] == CODEBOOK_SHAPE)
            served = name == "reuse_matmul"
            kernels[-1]["codebook"] = dict(
                source="src/repro_torch/csrc/quant_gemm_sm90.cuh",
                shape=CODEBOOK_SHAPE, path=cb["path"],
                launches=(e2e["nf4+reuse"]["launches"][f"{name}.wgmma"]
                          if served else None),
                launches_from="nf4+reuse" if served else None,
                emulation_err=cb["emulation_err"],
                was=dict(path="tile", ms=cb["tile_ms"]),
                **{key: cb[key] for key in ROW_KEYS})
        if name == "flash_attention":
            # the main row is the tensor-core kernel; the SIMT one beside it
            simt = next(r for r in rows if r["kernel"] == name
                        and r["shape"] == main_shape and r["path"] == "simt")
            kernels[-1].update(
                path="wgmma", hgmma_instructions=hgmma[name],
                wgmma_launches=e2e[run]["launches"][f"{name}.wgmma"],
                simt={key: simt[key] for key in ROW_KEYS})
        if name == "quantize":
            # the cluster kernel; beside it the strip kernel it replaced
            # and the deploy pass (its path)
            dep = e2e["deploy"]
            kernels[-1].update(
                path="cluster", plan=row["plan"],
                launch_floor_ms=row["launch_floor_ms"],
                was=dict(path="strip", ms=row["was_ms"]),
                deploy_pass={key: dep[key] for key in (
                    "matrices", "ms", "plain_ms", "bound_ms", "was_ms")})
    (OUT / "chip_smoke.json").write_text(json.dumps(
        dict(card=smi, kernels=kernels, cases=rows, tensor_core_sweep=sweep,
             e2e=e2e, chaos=chaos), indent=1, default=str))
    print(json.dumps({"kernels": kernels}), flush=True)
    # the run used one card, whatever else the machine shows
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
