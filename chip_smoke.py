#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

1. Fails (exit 1, no result) unless ``torch.cuda.is_available()``.
2. Prints the card's name and power limit, then builds every CUDA kernel
   of the serving path from ``src/repro_torch/csrc`` (one nvcc per
   source, in parallel) and prints the build time.
3. Kernel phase: each kernel against its plain PyTorch version on the
   card at the shapes of full-width repro-100m serving, with its error,
   tolerance, device time (CUDA events, L2 flushed before each launch),
   the plain version's time, the least time the card could take (bound)
   and the time of one PyTorch library call computing the same function
   (a yardstick the port never calls).
4. Small-input check: the reduced float32 model served through the
   kernels gives the same greedy tokens as through the plain versions.
5. End-to-end phase: ``ServeEngine(quantize=True, n_slots=8,
   max_len=1024, decode_chunk=8)`` on full-width repro-100m (bf16, random
   weights from a seed) serves 16 requests (prompts 64/200/511 tokens,
   ``max_new=64``); every kernel's launch count is read over that run.
   The first wave's logits are held against the plain path, 4 decode
   chunks are profiled for the device's idle share, and the plain path
   serves the same requests for greedy-token agreement.
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
    """(wall ms, device-busy ms, top kernels) of ``fn`` under
    torch.profiler: the busy time is the sum of the card's kernel, memcpy
    and memset durations (one stream, so they do not overlap)."""
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return wall, sum(by_name.values()), top


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes, t_ops = nbytes / HBM_BPS, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def case_row(name, shape, err, tol, ms, plain_ms, lib_ms, nb, flops, dtype):
    bound_ms, bound_by = bound(nb, flops, dtype)
    row = dict(kernel=name, shape=shape, max_abs_err=err, tolerance=tol,
               ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               library_ms=lib_ms)
    print(f"kernel {name} {shape}: err {err:.3e} (tol {tol:.3e}) "
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
    from repro_torch.kernels.axllm_matmul import axllm_matmul_cuda, \
        kernel_scale
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    g = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    rows = []

    # -- axllm_matmul: the 7 projections at decode M = n_slots, one prefill
    mm_cases = [(8, 768, 768, QuantConfig(8)), (8, 768, 256, QuantConfig(8)),
                (8, 768, 2048, QuantConfig(8)), (8, 2048, 768, QuantConfig(8)),
                (4096, 768, 2048, QuantConfig(8)),
                (8, 768, 2048, QuantConfig(4, "affine", pack=True)),
                (8, 768, 2048, QuantConfig(8, "affine", "per_group")),
                (8, 768, 2048, QuantConfig(4, "codebook", pack=True))]
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
        nb = nbytes(x, qt.codes, kernel_scale(qt), got)
        shape = f"M{m} K{k} N{n} {qc.bits}b-{qc.mode}-{qc.granularity}"
        rows.append(case_row("axllm_matmul", shape, err, tol, ms, plain, lib,
                             nb, 2.0 * m * k * n, "bfloat16"))

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

    # -- flash_attention: the prefill wave (8 x 512), and Sq < Sk
    for b, sq, sk, causal in ((N_SLOTS, 512, 512, True), (2, 256, 1024, True),
                              (2, 256, 1024, False)):
        q = torch.randn(b, sq, h, d, generator=g, device=dev).to(bf16)
        k = torch.randn(b, sk, hk, d, generator=g, device=dev).to(bf16)
        v = torch.randn(b, sk, hk, d, generator=g, device=dev).to(bf16)
        want = ref.attention_ref(q, k, v, causal)
        got = flash_attention_cuda(q, k, v, causal)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        tol = 2.0 ** -7 * max(1.0, float(want.float().abs().max()))
        ms = time_ms(lambda: flash_attention_cuda(q, k, v, causal), flush)
        plain = time_ms(lambda: ref.attention_ref(q, k, v, causal), flush)
        qt_, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        amask = None
        if causal:      # queries sit at the last sq key positions
            amask = (torch.arange(sq, device=dev)[:, None] + sk - sq
                     >= torch.arange(sk, device=dev)[None, :])
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qt_, kt, vt, attn_mask=amask, enable_gqa=True), flush)
        pairs = sum(min(sk, i + sk - sq + 1) for i in range(sq)) if causal \
            else sq * sk
        nb = nbytes(q, k, v, got)
        shape = f"B{b} Sq{sq} Sk{sk} H{h} Hk{hk} d{d} " \
                f"{'causal' if causal else 'full'}"
        rows.append(case_row("flash_attention", shape, err, tol, ms, plain,
                             lib, nb, 4.0 * b * h * d * pairs, "bfloat16"))
    return rows


def small_input_check(dev):
    """Reduced float32 repro-100m, int8 weights: greedy tokens through the
    kernels equal those through the plain versions."""
    import numpy as np
    from repro_torch.configs.repro_100m import CONFIG
    from repro_torch.models.model import get_model
    from repro_torch.serve.engine import ServeEngine

    cfg = CONFIG.reduced(dtype="float32", remat=False)
    params = get_model(cfg).init(seed=0, device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (8, 12, 31, 8, 12, 31)]
    toks = {impl: ServeEngine(cfg, params, n_slots=2, max_len=64,
                              quantize=True, impl=impl, device=dev)
            .generate(prompts, max_new=16) for impl in ("cuda", "ref")}
    check(toks["cuda"] == toks["ref"],
          "small-input tokens differ between kernel and plain paths")
    print("small-input check: reduced fp32 int8 engine tokens identical "
          "(kernels vs plain versions)", flush=True)


def end_to_end(dev, card):
    import numpy as np
    import torch
    from repro_torch.configs.repro_100m import CONFIG
    from repro_torch.kernels import _build
    from repro_torch.models.model import get_model
    from repro_torch.serve.engine import ServeEngine, _pow2_bucket

    cfg = CONFIG
    params = get_model(cfg).init(seed=0, device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size,
                            size=PROMPT_LENS[i % len(PROMPT_LENS)])
               .astype(np.int32) for i in range(N_REQUESTS)]

    def engine(impl="auto"):
        return ServeEngine(cfg, params, n_slots=N_SLOTS, max_len=MAX_LEN,
                           quantize=True, decode_chunk=DECODE_CHUNK,
                           impl=impl, device=dev)

    engine().generate(prompts[:2], max_new=8)       # warm-up (cuBLAS, etc.)
    eng = engine()
    for p in prompts:
        eng.submit(p, max_new=MAX_NEW)
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
    check(sorted(done) == list(range(N_REQUESTS)),
          f"only {len(done)} of {N_REQUESTS} requests finished")
    for r in done.values():
        check(r.finish_reason == "max_new" and len(r.tokens) == MAX_NEW,
              f"request {r.rid} stopped {r.finish_reason} after "
              f"{len(r.tokens)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.tokens),
              f"request {r.rid} has a token outside the vocab")
    for name in _build.SIGNATURES:
        check(launches.get(name, 0) > 0, f"{name} never launched on the "
                                         "main path")
    generated = sum(len(r.tokens) for r in done.values())
    st = eng.stats
    print(f"e2e [{card}]: {generated} tokens in {wall:.3f} s = "
          f"{generated / wall:.1f} tok/s; decode {st.decode_tokens} tokens "
          f"in {st.steps} steps; prefill {st.prefill_waves} waves, "
          f"{st.prefill_wall_s:.3f} s; peak memory {peak / 2**30:.3f} GiB",
          flush=True)
    print(f"e2e [{card}]: launches {launches}", flush=True)

    # first wave against the plain path, same card and weights
    wave = prompts[:N_SLOTS]
    pl = _pow2_bucket(max(len(p) for p in wave), 8, MAX_LEN)
    toks = np.zeros((N_SLOTS, pl), np.int32)
    for i, p in enumerate(wave):
        toks[i, :len(p)] = p
    lengths = torch.tensor([len(p) for p in wave], dtype=torch.int32,
                           device=dev)
    logits = {}
    with torch.inference_mode():
        for impl in ("cuda", "ref"):
            api = get_model(cfg, impl=impl)
            logits[impl], _ = api.prefill(
                eng.params, {"tokens": torch.from_numpy(toks).to(dev)},
                api.init_cache(N_SLOTS, pl, dev), lengths=lengths)
    a, b = logits["cuda"].float(), logits["ref"].float()
    check(bool(torch.isfinite(a).all()), "non-finite first-wave logits")
    scale = float(b.abs().max())
    logit_err = float((a - b).abs().max())
    argmax_agree = float((a[:, :cfg.vocab_size].argmax(-1)
                          == b[:, :cfg.vocab_size].argmax(-1)).float().mean())
    print(f"e2e [{card}]: first-wave logits |kernel - plain| = "
          f"{logit_err:.4e}, scale {scale:.4f}, tolerance "
          f"{LOGIT_TOL * max(1.0, scale):.4e}; argmax agreement "
          f"{argmax_agree:.3f}", flush=True)
    check(logit_err <= LOGIT_TOL * max(1.0, scale),
          f"first-wave logits differ by {logit_err}")

    # where the decode time goes: 4 chunks of 8 full slots, profiled
    prof_eng = engine()
    for p in prompts[:N_SLOTS]:
        prof_eng.submit(p, max_new=MAX_NEW)
    prof_eng.step()                                  # prefill + 1st chunk
    wall_ms, busy_ms, top = device_busy_ms(
        lambda: [prof_eng.step() for _ in range(4)])
    idle = 1.0 - busy_ms / wall_ms
    print(f"e2e [{card}]: 4 decode chunks (32 steps, 8 slots): wall "
          f"{wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, idle share "
          f"{idle:.3f}", flush=True)
    for name, ms in top:
        print(f"e2e [{card}]:   device {ms:8.3f} ms  {name[:90]}",
              flush=True)

    plain = engine("ref")
    for p in prompts:
        plain.submit(p, max_new=MAX_NEW)
    plain.run()
    ptoks = {r.rid: r.tokens for r in plain.finished}
    same = sum(done[i].tokens == ptoks[i] for i in done)
    agree = np.mean([np.mean(np.equal(done[i].tokens, ptoks[i]))
                     for i in done])
    print(f"e2e [{card}]: greedy tokens vs plain path: {same}/{N_REQUESTS} "
          f"requests identical, {agree:.3f} of positions equal", flush=True)
    return dict(tokens=generated, wall_s=wall, tok_per_s=generated / wall,
                prefill_wall_s=st.prefill_wall_s, steps=st.steps,
                prefill_waves=st.prefill_waves, peak_bytes=peak,
                launches=launches, logit_err=logit_err, logit_scale=scale,
                first_wave_argmax_agree=argmax_agree,
                requests_identical=same, position_agree=float(agree),
                decode_profile=dict(wall_ms=wall_ms, busy_ms=busy_ms,
                                    idle_share=idle, top=top))


KERNELS = {
    "axllm_matmul": ("src/repro/kernels/axllm_matmul.py:104",
                     "M8 K768 N2048 8b-affine-per_channel"),
    "decode_attention": ("src/repro/kernels/decode_attention.py:71",
                         "B8 S1024 H12 Hk4 d64 bf16-kv"),
    "flash_attention": ("src/repro/kernels/flash_attention.py:81",
                        "B8 Sq512 Sk512 H12 Hk4 d64 causal"),
}


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
    print(f"built {len(_build.SIGNATURES)} kernels in "
          f"{time.perf_counter() - t0:.1f} s ({len(logs)} compiled)",
          flush=True)
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke_nvcc.log").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in logs.items()))

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = kernel_phase(dev, flush)
    small_input_check(dev)
    e2e = end_to_end(dev, card)

    kernels = []
    for name, (replaces, main_shape) in KERNELS.items():
        row = next(r for r in rows
                   if r["kernel"] == name and r["shape"] == main_shape)
        kernels.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{name}.cu",
            replaces=replaces, launches=e2e["launches"][name],
            max_abs_err=row["max_abs_err"], tolerance=row["tolerance"],
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            shape=main_shape))
    (OUT / "chip_smoke.json").write_text(json.dumps(
        dict(card=smi, kernels=kernels, cases=rows, e2e=e2e), indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
