#!/usr/bin/env python3
"""The dry-run checks of ``chip_smoke.py`` alone, on one NVIDIA GPU: a
quick way to iterate on them without the whole script.

    python3 chip_dryrun.py

Builds the kernels, then runs ``chip_smoke.dryrun_phase`` (runs a-g's
decode step counted on the meta device against the same step on the
card: argument bytes within 1% of the allocation, temp bytes and the
roofline bound printed beside the step's peak and time), run q's module
phase (``chip_smoke.seqsharded_rank_phase`` on four ranks at 2x2 sharing
the card over gloo: the sequence-sharded decode with the sequence over
"model" and over ("model", "data"), each rank's rows against the
single-card kernel) and the dry-run CLI at ``chip_smoke.DRYRUN_CELLS`` on
a lane (``dryrun_submit`` / ``dryrun_check``). Exits 1 without a GPU.
"""
import subprocess
import sys
import time

sys.path.insert(0, "src")
sys.path.insert(0, ".")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_dryrun: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    import chip_smoke as C
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import run_ranks
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    t = time.time()
    _build.build()
    print(f"build {time.time() - t:.1f} s", flush=True)
    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    lane = C.CliLane()
    out = C.dryrun_submit(lane)
    t = time.time()
    C.dryrun_phase(dev, card, flush)
    print(f"dry-run phase {time.time() - t:.1f} s", flush=True)
    t = time.time()
    res = run_ranks(C.seqsharded_rank_phase, 4, "cuda", mesh_shape=(2, 2))
    print(f"seq phase {time.time() - t:.1f} s", flush=True)
    for kv in res[0]:
        print(kv, res[0][kv]["shape"], [(round(r[kv]["max_abs_err"], 6),
                                         round(r[kv]["tolerance"], 6),
                                         round(r[kv]["ms"], 3))
                                        for r in res], flush=True)
        for r in res:
            C.check(r[kv]["max_abs_err"] <= r[kv]["tolerance"],
                    f"sharded decode {kv}: error {r[kv]['max_abs_err']}")
    t = time.time()
    C.dryrun_check(card, lane, out)
    print(f"cli wait {time.time() - t:.1f} s", flush=True)
    lane.stop()
    print("chip_dryrun ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
