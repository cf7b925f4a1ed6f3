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
   shapes, bf16 and f32, 8 and 4 bits, and then in a deploy pass through
   ``ops.quantize_channels`` over every projection leaf of full-width
   repro-100m (84 matrices, one launch per stacked leaf), its path. The
   kernels of both quantized matmuls are timed from M1 to M4096 at N256
   and N2048 (the decode kernels up to M16, the tensor-core ones from
   M16), where ``TC_MIN_M`` and ``GEMV_MAX_M`` pick the path.
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
   Each requires its matmul's and flash attention's tensor-core paths
   (``<kernel>.wgmma``) to have launched in its prefill waves (every
   flash launch on the tensor cores) and its matmul's decode kernel
   (``<kernel>.gemv``) in its decode steps (every matmul launch one of
   the two), holds its first wave's logits against the plain path, holds
   every generated token to the token gate (``serve/token_gate.py``: the
   plain path's teacher-forced logit of the token within 2 x the logits
   tolerance of the plain maximum, at every position), profiles 4
   decode chunks for the device's idle share and its first wave's
   prefill for its device time (flash attention's share), serves the same
   requests through the plain path for greedy-token agreement. Run b also
   holds the first-token logits of its first prefix-hit wave, as served
   (prefix KV gathered out of the pool, suffix-only prefill), against a
   plain dense prefill of the whole prompts; runs b and c read the reuse
   rate the kernel achieves on each projection of layer 0. Run c also
   requires each adapter row's first-wave logits to differ from the same
   prompt's base logits by more than the tolerance.
6. Prints the ``kernels`` JSON line, then the result line.

Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

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
THRESHOLD_M = (1, 8, 16, 32, 48, 64, 96, 128, 256)  # paths timed at each
GEMV_M = (1, 8, 16)     # where the decode kernels are timed as well
# flash kernel phase: (B, Sq, Sk, causal, head dim)
FLASH_CASES = ((N_SLOTS, 512, 512, True, 64), (2, 256, 1024, True, 64),
               (2, 256, 1024, False, 64), (N_SLOTS, 512, 512, True, 128))
LOGIT_TOL = 5e-2        # bf16 model, 12 layers: |kernel - plain| / scale
SPIN_CYCLES = 4_000_000  # ~2 ms of device spin ahead of each timed launch


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


def tensor_core_phase(dev, flush):
    """Where the tensor-core path of the two quantized matmuls overtakes
    their skinny kernels: the tensor-core and tile kernels of both at K768
    N256 and N2048 (bf16, int8 per-channel) for each M of ``THRESHOLD_M``
    and M4096, and the split-K decode kernels at each M of ``GEMV_M``,
    each held against its plain version; and the bf16 output that the
    serving path asks for at M4096 N2048 (written by the kernel, no
    separate cast)."""
    import torch
    from repro_torch.core.quantization import QuantConfig, quantize
    from repro_torch.kernels import axllm_matmul, ref, reuse_matmul
    from repro_torch.kernels.axllm_matmul import TC_MIN_M

    g = torch.Generator(device=dev).manual_seed(4)
    bf16, f32 = torch.bfloat16, torch.float32
    sweep = []
    for k, n in ((768, 256), (768, 2048)):
        qt = quantize(torch.randn(k, n, generator=g, device=dev) * k ** -0.5,
                      QuantConfig(8))
        for m in THRESHOLD_M + (4096,):
            x = torch.randn(m, k, generator=g, device=dev).to(bf16)
            want = ref.axllm_matmul_ref(x, qt)
            tol = 1e-5 * max(1.0, float(want.abs().max()))
            row = dict(m=m, k=k, n=n)
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
            if m == 4096 and n == 2048:   # the serving path's bf16 output
                got = axllm_matmul.launch(x, qt, bf16, "wgmma")
                check(torch.equal(got, axllm_matmul.launch(
                    x, qt, f32, "wgmma").to(bf16)), "bf16 output is not the "
                    "f32 output rounded to nearest even")
                row["axllm_wgmma_bf16_out"] = time_ms(
                    lambda: axllm_matmul.launch(x, qt, bf16, "wgmma"), flush)
                row["reuse_wgmma_bf16_out"] = time_ms(
                    lambda: reuse_matmul.launch(x, qt, False, bf16,
                                                "wgmma")[0], flush)
            print(f"tensor-core path vs skinny kernels, M{m} K{k} N{n} int8: "
                  + ", ".join(f"{key} {v:.4f} ms" for key, v in row.items()
                              if key not in ("m", "k", "n")), flush=True)
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


def quantize_kernel_phase(dev, flush):
    """The quantization kernel against its plain version: codes and scales
    equal at every shape, type and width, with times at 8 bits; then the
    deploy pass through ``ops.quantize_channels`` (the kernel's path)
    over every projection leaf of full-width repro-100m, with the launch
    count set to 0 just before it and read just after. Returns (rows, the
    pass's metrics)."""
    import torch
    from repro_torch.configs.repro_100m import CONFIG
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.quantize import quantize_cuda
    from repro_torch.models.model import get_model

    g = torch.Generator(device=dev).manual_seed(2)
    rows = []

    def held(w, codes, scale, bits, what):
        want_codes, want_scale = ref.quantize_ref(w, bits)
        n_codes = int((codes != want_codes).sum())
        n_scales = int((scale != want_scale).sum())
        check(n_codes == 0 and n_scales == 0,
              f"quantize {what}: {n_codes} codes and {n_scales} scales "
              "differ from the plain version")
        return float((codes.int() - want_codes.int()).abs().max())

    for k, n in ((768, 768), (768, 256), (768, 2048), (2048, 768),
                 (8192, 2048)):
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
                rows.append(case_row("quantize", shape, err, 0.0, ms, plain,
                                     None, nbytes(w, codes, scale),
                                     5.0 * k * n, "float32"))

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
    print(f"quantize deploy pass: {n_mat} matrices ({n_w} weights, "
          f"{nb / 1e6:.1f} MB) in {launches['quantize']} launches, codes and "
          f"scales equal to the plain version; {ms:.4f} ms, plain "
          f"{plain:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})", flush=True)
    deploy = dict(matrices=n_mat, weights=n_w, bytes=nb, launches=launches,
                  ms=ms, plain_ms=plain, bound_ms=bound_ms, bound_by=bound_by)
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


def end_to_end(dev, card):
    import numpy as np
    from repro_torch.configs.repro_100m import CONFIG
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, CONFIG.vocab_size,
                            size=PROMPT_LENS[i % len(PROMPT_LENS)])
               .astype(np.int32) for i in range(N_REQUESTS)]
    return serve_run(dev, card, "dense", prompts, (
        "axllm_matmul", "axllm_matmul.wgmma", "axllm_matmul.gemv",
        "decode_attention",
        "flash_attention", "flash_attention.wgmma"))[0]


def layer0_reuse_rates(eng, label, card) -> dict:
    """The reuse rate the kernel counts on each quantized projection of
    layer 0 of ``eng``'s served weights, each count held against
    ``reuse_mult_count``, beside the analytic Gaussian model."""
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
            x = torch.ones((N_SLOTS, k), dtype=torch.bfloat16,
                           device=qt.codes.device)
            _, mults = ops.reuse_matmul(x, qt, impl="reuse", with_stats=True)
            count = ref.reuse_mult_count(qt, segment(n))
            check(int(mults) == count, f"{label}: layer-0 {name}: kernel "
                                       f"counted {int(mults)}, host {count}")
            rates[name] = 1.0 - int(mults) / (k * n)
            print(f"e2e {label} [{card}]: layer 0 {name} K{k} N{n}: reuse "
                  f"rate {rates[name]:.4f} (kernel count {int(mults)} = "
                  f"reuse_mult_count; analytic gaussian model "
                  f"{predicted:.4f})", flush=True)
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
    rng = np.random.default_rng(0)           # run a's prompts
    prompts = [rng.integers(0, CONFIG.vocab_size,
                            size=PROMPT_LENS[i % len(PROMPT_LENS)])
               .astype(np.int32) for i in range(N_REQUESTS)]
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


PREFILL_SHAPE = "M4096 K768 N2048 8b-affine-per_channel"

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
    logs = _build.build()
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
    sweep = tensor_core_phase(dev, flush)
    q_rows, deploy = quantize_kernel_phase(dev, flush)
    rows += q_rows
    small_input_check(dev)
    e2e = {"dense": end_to_end(dev, card),
           "reuse+paged": end_to_end_reuse_paged(dev, card),
           "lora+reuse+fused": end_to_end_lora(dev, card),
           "deploy": deploy}

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
        if name == "flash_attention":
            # the main row is the tensor-core kernel; the SIMT one beside it
            simt = next(r for r in rows if r["kernel"] == name
                        and r["shape"] == main_shape and r["path"] == "simt")
            kernels[-1].update(
                path="wgmma", hgmma_instructions=hgmma[name],
                wgmma_launches=e2e[run]["launches"][f"{name}.wgmma"],
                simt={key: simt[key] for key in ROW_KEYS})
    (OUT / "chip_smoke.json").write_text(json.dumps(
        dict(card=smi, kernels=kernels, cases=rows, tensor_core_sweep=sweep,
             e2e=e2e), indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    # the run used one card, whatever else the machine shows
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
