#!/usr/bin/env python3
"""Where the quantization kernel's time goes, on one NVIDIA GPU.

    python3 chip_quantize_trace.py

Builds three instrumented copies of ``src/repro_torch/csrc/quantize.cu``
into ``build/repro_torch/`` (the source itself is not changed):

- ``trace``: thread 0 of every block writes ``%globaltimer`` at each step
  of the held route's item loop (load and reduce, publish the maxima,
  round the previous item, wait at the cluster barrier, take the scales,
  the block barrier);
- ``no_check``: the rounding without its exactness check (every code the
  product's, so some codes are wrong: for timing only);
- ``no_round``: load, reduce and exchange the maxima, no codes.

For K8192 N2048 bf16 and the largest deploy leaf ([12, 768, 2048] bf16),
at the plan ``quantize_plan`` gives, it prints the median (10th, 90th
percentile) ns of each step for each item a cluster walks, and the device
time (``chip_smoke.time_ms``: L2 flushed, CUDA events) of the kernel, of
each copy, and of ``torch.clone`` of the same weights (a copy that reads
and writes every byte once). Results also go to
``chiprun_out/chip_quantize_trace.json``. Exits 1 without a GPU.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
STEPS = ("load_reduce", "publish", "round_previous", "barrier_wait",
         "take_scales", "block_sync")
TRACE = r'''
__device__ unsigned long long g_trace[1 << 21];
#define TRACE(n, i) if (threadIdx.x == 0 && (n) < 8 && blockIdx.x < 16384) { \
  unsigned long long t_; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); \
  g_trace[((size_t)blockIdx.x * 8 + (n)) * 8 + (i)] = t_; }
extern "C" int quantize_trace_read(void* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, g_trace, (size_t)n * 8); }
extern "C" int quantize_trace_clear() {
  static unsigned long long z[1 << 16];
  for (int i = 0; i < 32; ++i)
    if (cudaMemcpyToSymbol(g_trace, z, sizeof z, (size_t)i * sizeof z)) return 1;
  return 0; }
'''
COPIES = {
    "trace": [
        ("namespace cg = cooperative_groups;\n",
         "namespace cg = cooperative_groups;\n" + TRACE),
        ("      if (n < count) {\n#pragma unroll\n",
         "      TRACE(n, 0)\n      if (n < count) {\n#pragma unroll\n"),
        ("        publish(n & 1);\n        cluster_arrive(writer);\n",
         "        TRACE(n, 1)\n        publish(n & 1);\n        TRACE(n, 2)\n"
         "        cluster_arrive(writer);\n"),
        ("(n - 1) % kHeldSlots, (n - 1) & 1);\n",
         "(n - 1) % kHeldSlots, (n - 1) & 1);\n      TRACE(n, 3)\n"),
        ("        cluster_wait();   // every split's maxima of item n are "
         "published\n",
         "        cluster_wait();\n        TRACE(n, 4)\n"),
        ("      __syncthreads();   // the scales are visible; slot n - 1 is "
         "free\n",
         "      TRACE(n, 5)\n      __syncthreads();\n      TRACE(n, 6)\n")],
    "no_check": [("      if (!decided) {", "      if (false) {")],
    "no_round": [("        round_chunk(it - clusters, 0, (n - 1) % kHeldSlots, "
                  "(n - 1) & 1);\n", "\n")],
}


def build_copies():
    from repro_torch.kernels import _build
    src = (_build.CSRC / "quantize.cu").read_text()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in COPIES.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the source no longer has {old!r}")
            text = text.replace(old, new)
        path = _build.BUILD_DIR / f"quantize_{name}.cu"
        path.write_text(text)
        out = _build.BUILD_DIR / f"quantize_{name}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(out), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            out)
    libs = {}
    for name, (proc, out) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(out))
        lib.quantize_launch.argtypes = _build.SIGNATURES["quantize"][1]
        lib.quantize_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_quantize_trace: no GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import chip_smoke as cs
    from repro_torch.kernels import quantize as Q

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    libs = build_copies()
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)

    def launch(lib, w, p):
        *lead, k, n = w.shape
        codes = torch.empty(w.shape, dtype=torch.int8, device=dev)
        scale = torch.empty((*lead, 1, n), dtype=torch.float32, device=dev)
        err = lib.quantize_launch(
            w.data_ptr(), int(w.dtype == torch.bfloat16), codes.data_ptr(),
            scale.data_ptr(), p.batch, k, n, 8, p.strip, p.cluster, p.rows,
            p.chunk_rows, p.vec, p.smem, torch.cuda.current_stream().cuda_stream)
        cs.check(err == 0, f"launch failed: cudaError_t {err}")

    result = dict(card=smi, shapes={})
    for shape in ((8192, 2048), (12, 768, 2048)):
        w = (torch.randn(shape, generator=g, device=dev) * 0.05).to(
            torch.bfloat16)
        *lead, k, n = w.shape
        p = Q.quantize_plan(w.numel() // (k * n), k, n, w.dtype,
                            torch.cuda.get_device_properties(
                                dev).multi_processor_count)
        lib = libs["trace"]
        launch(lib, w, p)
        torch.cuda.synchronize()
        cs.check(lib.quantize_trace_clear() == 0, "trace clear failed")
        flush.zero_()
        torch.cuda._sleep(cs.SPIN_CYCLES)
        launch(lib, w, p)
        torch.cuda.synchronize()
        blocks = min(16384, p.blocks)
        buf = (ctypes.c_ulonglong * (blocks * 64))()
        cs.check(lib.quantize_trace_read(buf, blocks * 64) == 0,
                 "trace read failed")
        t = np.frombuffer(buf, dtype=np.uint64).reshape(
            blocks, 8, 8).astype(np.int64)
        items = []
        for i in range(8):
            done = (t[:, i, 0] > 0) & (t[:, i, 1] > 0)
            if not done.any():
                break
            d = np.diff(t[done, i, :7], axis=1)
            items.append({s: np.percentile(d[:, j], [50, 10, 90]).tolist()
                          for j, s in enumerate(STEPS)})
        row = dict(plan=p.describe(),
                   blocks_launched=int((t[:, 0, 0] > 0).sum()),
                   items=items,
                   ms=cs.time_ms(lambda: Q.quantize_cuda(w), flush),
                   no_check_ms=cs.time_ms(
                       lambda: launch(libs["no_check"], w, p), flush),
                   no_round_ms=cs.time_ms(
                       lambda: launch(libs["no_round"], w, p), flush),
                   clone_ms=cs.time_ms(lambda: w.clone(), flush))
        result["shapes"][str(shape)] = row
        print(f"{shape}: {row['plan']}; {row['blocks_launched']} blocks "
              f"launched; {row['ms']:.4f} ms, without the exactness check "
              f"{row['no_check_ms']:.4f}, without rounding "
              f"{row['no_round_ms']:.4f}, torch.clone "
              f"{row['clone_ms']:.4f}", flush=True)
        for i, steps in enumerate(items):
            print(f"  item {i}: " + ", ".join(
                f"{s} {v[0]:.0f} ({v[1]:.0f}-{v[2]:.0f})"
                for s, v in steps.items()) + " ns", flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "chip_quantize_trace.json").write_text(
        json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
