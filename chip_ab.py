#!/usr/bin/env python3
"""Same-card A/B of the port's end-to-end serve runs on one NVIDIA GPU.

    git archive <parent> | tar -x -C build/parent   # a second checkout
    python3 chip_ab.py build/parent

Runs ``chip_smoke.py``'s three serve runs (a dense, b reuse + paged, c
LoRA + reuse + fused; full-width repro-100m, random weights from a seed)
of two checkouts in turns, parent, this one, this one, parent, each in a
process of its own that builds and imports that checkout's kernels, run
a twice: first as ``dense-cold``, whose first waves pay each kernel's
first launch in the process (module loading, first-call set-up), then
as ``dense`` with every kernel warm. Each
prints its runs' prefill wall time (``EngineStats.prefill_wall_s``),
tokens per second, the profiled 4 decode chunks' wall time, device-busy
time, idle share, decode attention device time and the quantized
matmuls' decode device time (their kernels and, where a checkout has
one, the split-sum kernel), and, where the
checkout's ``chip_smoke`` profiles it (``prefill_profile``), the first
prefill wave's device-busy and flash attention time. Then the host time
of one wrapper call, in microseconds: ``flash_attention_cuda`` at the
prefill wave (B8 Sq=Sk=512 H12 Hk4 d64 bf16 causal) and
``decode_attention_cuda`` at a decode step (B8 S1024, bf16 KV), and
``axllm_matmul_cuda`` and ``reuse_matmul_cuda`` at a decode projection
(M8 K768 N2048 int8, bf16 out), each the median of 5 rounds of 200
calls enqueued behind a device spin, so that the host never waits for
the card. Then the device time of both quantized matmuls at each decode
projection (``kernels``: M8, int8, bf16 out, L2 flushed before each
launch, as ``chip_smoke.time_ms`` times a kernel). The last lines are the
per-checkout medians (of two runs each: their mean). Host clocks vary
from call to call, so compare the two checkouts only within one call.
Exits 1 without a GPU.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RUNS = ("dense-cold", "dense", "reuse+paged", "lora+reuse+fused", "host",
        "kernels")

WORKER = r'''
import json, statistics, sys, time
sys.path.insert(0, "src"); sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from repro_torch.kernels import _build
from repro_torch.core.quantization import QuantConfig, quantize
from repro_torch.kernels.axllm_matmul import axllm_matmul_cuda
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.reuse_matmul import reuse_matmul_cuda
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.build()
dev = torch.device("cuda")
card = torch.cuda.get_device_name(0)

out = {}
for name, fn in (("dense-cold", cs.end_to_end), ("dense", cs.end_to_end),
                 ("reuse+paged", cs.end_to_end_reuse_paged),
                 ("lora+reuse+fused", cs.end_to_end_lora)):
    r = fn(dev, card)
    if isinstance(r, tuple):      # (metrics, its tokens[, its engine])
        r = r[0]
    dp = r["decode_profile"]
    out[name] = dict(prefill_wall_s=r["prefill_wall_s"],
                     tok_per_s=r["tok_per_s"],
                     decode_wall_ms=dp["wall_ms"],
                     decode_busy_ms=dp["busy_ms"],
                     idle_share=dp["idle_share"],
                     decode_attention_ms=sum(
                         ms for k, ms in dp["top"]
                         if "decode_attention" in k or "paged_decode" in k),
                     decode_matmul_ms=sum(
                         ms for k, ms in dp["top"]
                         if "matmul" in k or "gemv" in k
                         or "sum_splits" in k))
    if "prefill_profile" in r:
        out[name].update(prefill_wave_busy_ms=r["prefill_profile"]["busy_ms"],
                         prefill_wave_flash_ms=r["prefill_profile"]
                         ["flash_ms"])


def host_us(fn, calls=200, rounds=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        torch.cuda._sleep(100_000_000)   # keeps the card busy meanwhile
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


g = torch.Generator(device=dev).manual_seed(0)
bf16 = torch.bfloat16
q = torch.randn(8, 512, 12, 64, generator=g, device=dev).to(bf16)
k = torch.randn(8, 512, 4, 64, generator=g, device=dev).to(bf16)
qd = torch.randn(8, 12, 64, generator=g, device=dev).to(bf16)
kc = torch.randn(8, 1024, 4, 64, generator=g, device=dev).to(bf16)
length = torch.tensor([0, 64, 200, 511, 700, 1000, 1024, 1324],
                      dtype=torch.int32, device=dev)
xm = torch.randn(8, 768, generator=g, device=dev).to(bf16)
qt = quantize(torch.randn(768, 2048, generator=g, device=dev) * 0.03,
              QuantConfig(8))
out["host"] = dict(
    flash_call_us=host_us(lambda: flash_attention_cuda(q, k, k, True)),
    decode_call_us=host_us(lambda: decode_attention_cuda(qd, kc, kc, length)),
    axllm_call_us=host_us(lambda: axllm_matmul_cuda(xm, qt, bf16)),
    reuse_call_us=host_us(lambda: reuse_matmul_cuda(xm, qt, False, bf16)))

# the quantized matmuls' device time at each decode projection (M8, int8,
# bf16 out), as chip_smoke times a kernel (L2 flushed before each launch)
flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
out["kernels"] = {}
for kk, nn in ((768, 2048), (768, 768), (768, 256), (2048, 768),
               (768, 1280), (768, 4096)):
    w = quantize(torch.randn(kk, nn, generator=g, device=dev) * kk ** -0.5,
                 QuantConfig(8))
    xk = torch.randn(8, kk, generator=g, device=dev).to(bf16)
    out["kernels"][f"axllm_K{kk}_N{nn}_ms"] = cs.time_ms(
        lambda: axllm_matmul_cuda(xk, w, bf16), flush)
    out["kernels"][f"reuse_K{kk}_N{nn}_ms"] = cs.time_ms(
        lambda: reuse_matmul_cuda(xk, w, False, bf16), flush)
print("AB " + json.dumps(out), flush=True)
'''


def run(checkout: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", WORKER], cwd=checkout,
                          capture_output=True, text=True)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
    if proc.returncode or not lines:
        raise RuntimeError(f"{checkout}: worker failed ({proc.returncode})\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return json.loads(lines[-1][3:])


def main() -> int:
    import torch
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print("usage: python3 chip_ab.py PARENT_CHECKOUT (on an NVIDIA GPU)",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    checkouts = {"parent": Path(sys.argv[1]).resolve(), "change": ROOT}
    results = {"parent": [], "change": []}
    for which in ("parent", "change", "change", "parent"):
        r = run(checkouts[which])
        results[which].append(r)
        for name in RUNS:
            print(f"{which} {name}: " + ", ".join(
                f"{k} {v:.6g}" for k, v in r[name].items()), flush=True)
    summary = {which: {name: {k: statistics.median(
        r[name][k] for r in rs) for k in rs[0][name]} for name in RUNS}
        for which, rs in results.items()}
    for which, runs in summary.items():
        for name, m in runs.items():
            print(f"median {which} {name}: " + ", ".join(
                f"{k} {v:.6g}" for k, v in m.items()), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_ab.json").write_text(json.dumps(
        dict(card=smi, runs=results, median=summary), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
