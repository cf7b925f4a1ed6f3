"""Serving launcher of the port: makes weights from a seed or restores a
checkpoint, deploys them through the AxLLM quantized path and serves a
synthetic mixed-length request stream through the continuous-batching
engine, on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch repro-100m \\
      --requests 16 --max-new 32 [--ckpt DIR] [--no-quantize] [--kv-int8] \\
      [--eos-id 0] [--long-prompt reject] [--lora 2] [--stats]

The flags, their defaults, choices and help are the JAX launcher's
(``repro.launch.serve``; ``docs/ARCHITECTURE.md`` has the table), and so
are the lines it prints. Of note:
  --ckpt DIR        restore ``(params, adamw.init(params))`` from the
                    latest step under DIR, written by either package
                    (``train/checkpoint.py``); without one, the weights
                    are the port's init from seed 0
  --decode-chunk N  decode steps per dispatch (default cfg value, 8)
  --paged           block-paged KV pool with radix-tree prefix reuse
                    (see --kv-block-size/--prefix-cache/--num-blocks)
  --fuse-qkv        fused wqkv/gate_up projections
  --reuse           quantized matmuls through the reuse (LUT) kernel
  --quant-bits N / --quant-mode M   deploy-quantization width, alphabet
  --lora N          N synthetic LoRA adapters, requests cycling over base
                    and adapters (--lora-rank/--lora-alpha/--lora-targets/
                    --max-loras)
  --arrival-rate A  open-loop arrivals ('poisson:<r>' / 'fixed:<r>'),
                    with --admission/--max-queue/--priority/--deadline-s
  --prefill-budget N  chunked prefill (paged only)
  --stream, --ttft-deadline-s, --itl-deadline-s   streaming and deadlines
  --speculate       self-speculative decoding (--spec-k, --draft-bits,
                    --draft-mode)
  --stats           the engine's stats as JSON
  --mesh-shape DxM  serving on a ("data", "model") mesh of D x M ranks
                    ('M' alone is '1xM')

As in the JAX launcher, ``--mesh-shape`` above 1 serves on a mesh, and
its summary line carries a ``, mesh DxM`` tag. Under ``torchrun``
(``RANK`` and ``WORLD_SIZE`` set) each process joins the group as one
rank; otherwise the launcher spawns its D x M ranks itself
(``launch.mesh.run_ranks``; NCCL with a card per rank, gloo when ranks
share a card). Every rank serves the same requests and rank 0 prints;
``--ckpt`` restores onto the shards (each rank reads its block of every
leaf the layout cuts over "model", the expert stacks and the recurrent
mixers' projections included, and the engine quantizes its blocks; with
a shiftadd draft, derived from the whole weights, they restore whole). An
encoder-decoder ``--arch``
(whisper-small) raises the engine's error. The launcher runs on the card,
and fails where there is none; a caller may ask for the CPU with
``main(argv, device="cpu")`` (a Python keyword, not a flag), as the tests
do.

    torchrun --nproc-per-node 4 -m repro_torch.launch.serve --mesh-shape 2x2
    PYTHONPATH=src python -m repro_torch.launch.serve --mesh-shape 2x2
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import time

import numpy as np
import torch

from repro_torch.configs import apply_overrides, get_config
from repro_torch.core.quantization import QuantConfig
from repro_torch.dist import sharding as shd
from repro_torch.dist import tensor_parallel as tp
from repro_torch.kernels import _build
from repro_torch.launch.mesh import (init_from_env, make_serve_mesh,
                                     parse_mesh_shape, run_ranks)
from repro_torch.models.model import get_model
from repro_torch.optim import adamw
from repro_torch.serve.adapters import make_synthetic_adapters
from repro_torch.serve.engine import ServeEngine, refuse_unservable
from repro_torch.serve.scheduler import arrival_times
from repro_torch.train import checkpoint as C


def build_parser() -> argparse.ArgumentParser:
    """The JAX launcher's flags, with its names, defaults, choices and
    help."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="repro-100m")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--no-quantize", action="store_true")
    ap.add_argument("--reuse", action="store_true",
                    help="dispatch quantized matmuls through the reuse "
                         "(LUT) kernel path instead of multiply-dequant")
    ap.add_argument("--quant-bits", type=int, default=None,
                    help="weight code width for deploy quantization "
                         "(default: cfg.quant_bits)")
    ap.add_argument("--quant-mode", choices=("affine", "codebook"),
                    default="affine",
                    help="deploy-quantization alphabet (codebook = NF4 "
                         "for 4-bit)")
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--decode-chunk", type=int, default=None,
                    help="on-device decode steps per dispatch (default: "
                         "cfg.decode_chunk)")
    ap.add_argument("--fuse-qkv", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="fused wqkv/gate_up projections (--no-fuse-qkv "
                         "overrides a config that enables them)")
    ap.add_argument("--paged", action="store_true",
                    help="block-paged KV cache with radix-tree prefix "
                         "reuse (attention families only)")
    ap.add_argument("--kv-block-size", type=int, default=16,
                    help="tokens per KV pool block (power of two)")
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="radix prefix index on the paged pool (disable "
                         "to page without reuse)")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="KV pool blocks (default: 2x the dense-equivalent "
                         "capacity plus trash and CoW spare)")
    ap.add_argument("--eos-id", type=int, default=None,
                    help="stop token id (-1: disable even if cfg sets one)")
    ap.add_argument("--long-prompt", choices=("truncate", "reject"),
                    default="truncate")
    ap.add_argument("--prompt-lens", default="8,12,31",
                    help="comma list of prompt lengths cycled over requests")
    ap.add_argument("--lora", type=int, default=0,
                    help="register N synthetic LoRA adapters and cycle "
                         "requests over base + adapters (0: base only)")
    ap.add_argument("--lora-rank", type=int, default=8,
                    help="adapter rank (all registered adapters share it)")
    ap.add_argument("--lora-alpha", type=float, default=16.0,
                    help="adapter alpha (scaling = alpha / rank)")
    ap.add_argument("--lora-targets", default="wq,wv",
                    help="comma list of attention projections the adapters "
                         "target (subset of wq,wk,wv,wo)")
    ap.add_argument("--max-loras", type=int, default=None,
                    help="registry capacity (default: max(4, --lora))")
    ap.add_argument("--mesh-shape", default="1",
                    help="tensor-parallel serving mesh: model-axis size "
                         "('8') or 'DATAxMODEL' ('2x4'); '1' (default) "
                         "serves single-device")
    ap.add_argument("--arrival-rate", default=None,
                    help="open-loop arrivals: 'poisson:<rate>' or "
                         "'fixed:<rate>' requests/s submitted on their own "
                         "clock (default: closed-loop, all requests "
                         "submitted up front)")
    ap.add_argument("--admission", choices=("block", "reject", "evict"),
                    default="block",
                    help="policy when the wait queue is full: block the "
                         "submitter, reject the newcomer, or evict the "
                         "lowest-priority queued request")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="wait-queue bound that arms --admission "
                         "(default: unbounded)")
    ap.add_argument("--priority", default="0",
                    help="comma list of priorities cycled over requests "
                         "(higher preempts lower under overload)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="queue-wait deadline per request; requests not "
                         "admitted in time finish as 'expired'")
    ap.add_argument("--prefill-budget", type=int, default=None,
                    help="chunked prefill: max prompt tokens prefilled per "
                         "engine step (paged only; bounds step time so "
                         "long prompts interleave with decode)")
    ap.add_argument("--stream", action="store_true",
                    help="streaming output: emit tokens through "
                         "submit(on_token=) at chunk-harvest time and "
                         "report per-stream counts")
    ap.add_argument("--ttft-deadline-s", type=float, default=None,
                    help="execution deadline on time-to-first-token; a "
                         "request that blows it finishes as 'expired'")
    ap.add_argument("--itl-deadline-s", type=float, default=None,
                    help="execution deadline on inter-token latency; a "
                         "stream that stalls longer finishes as 'expired'")
    ap.add_argument("--speculate", action="store_true",
                    help="self-speculative decoding: a low-bit draft of the "
                         "same model proposes --spec-k tokens per round, the "
                         "serving-precision target verifies them in one "
                         "chunked dispatch (bit-identical to target-only "
                         "greedy)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft tokens proposed per speculation round")
    ap.add_argument("--draft-bits", type=int, default=4,
                    help="draft quantization width (default int4)")
    ap.add_argument("--draft-mode",
                    choices=("affine", "codebook", "shiftadd"),
                    default="affine",
                    help="draft weight reconstruction: affine/codebook "
                         "low-bit quantization or the shift-add binary "
                         "reparameterization")
    ap.add_argument("--stats", action="store_true",
                    help="print scheduler stats JSON after the run")
    ap.add_argument("--set", action="append", default=[])
    return ap


def main(argv=None, device="cuda"):
    """Serve as the flags say; returns, for a mesh this call spawned, each
    rank's result (see :func:`_rank`), else None."""
    args = build_parser().parse_args(argv)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch.launch.serve serves on the card and "
                           "torch.cuda.is_available() is false (callers "
                           "that want the CPU pass main(argv, "
                           "device='cpu'))")
    data, model = parse_mesh_shape(args.mesh_shape)
    if data * model == 1:
        serve(args, device)
        return None
    rank_device = init_from_env(device)
    if rank_device is not None:         # one rank of torchrun's group
        serve(args, rank_device,
              make_serve_mesh(args.mesh_shape, device=rank_device))
        return None
    argv = sys.argv[1:] if argv is None else list(argv)
    results = run_ranks(_rank, data * model, device, argv,
                        mesh_shape=(data, model))
    print(results[0]["out"], end="")
    return results


def _rank(mesh, argv):
    """One spawned rank: serve, and return rank 0's printed lines
    (``out``), this rank's kernel launches and every request's tokens."""
    _build.reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        reqs = serve(build_parser().parse_args(argv), mesh.device, mesh)
    return {"out": buf.getvalue(), "launches": dict(_build.LAUNCHES),
            "tokens": [[int(t) for t in r.tokens] for r in reqs]}


def serve(args, device, mesh=None):
    """The launcher's body on ``device``, on ``mesh`` when given (each
    rank runs it; rank 0 prints). Returns the finished requests."""
    rank0 = mesh is None or mesh.rank == 0

    def say(*a, **k):
        if rank0:
            print(*a, **k)

    cfg = get_config(args.arch)
    overrides = dict(kv.split("=", 1) for kv in args.set)
    if args.kv_int8:
        overrides["quant_kv"] = "true"
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    refuse_unservable(cfg)      # before any weights are made

    api = get_model(cfg)
    params = api.init(seed=0, device=device)
    if args.ckpt and C.latest_step(args.ckpt) is not None:
        opt = adamw.init(params, adamw.AdamWConfig())
        shardings = None
        if mesh is not None and not (args.speculate
                                     and args.draft_mode == "shiftadd"):
            # each rank reads its blocks (a shiftadd draft is derived
            # from the whole weights: those restore whole)
            _, lay, whole = ServeEngine.mesh_layout(
                cfg, mesh, params, n_slots=args.slots, max_len=args.max_len,
                paged=args.paged, quant=None if args.no_quantize else
                QuantConfig(bits=cfg.quant_bits if args.quant_bits is None
                            else args.quant_bits, mode=args.quant_mode),
                speculate=args.speculate, draft_bits=args.draft_bits,
                draft_mode=args.draft_mode)
            if lay is not None:
                shardings = (tp.layout_specs(whole, shd.param_specs(
                    whole, lay.mesh, lay.rules), lay), None)
        (params, _), step = C.restore(args.ckpt, (params, opt),
                                      shardings=shardings, device=device)
        say(f"restored step {step} from {args.ckpt}")

    eos_id = args.eos_id
    if eos_id is not None and eos_id < 0:
        eos_id = None
        cfg = apply_overrides(cfg, {"eos_id": "none"})

    registry = None
    adapter_cycle = [None]
    if args.lora > 0:
        registry, names = make_synthetic_adapters(
            cfg, n=args.lora, rank=args.lora_rank, alpha=args.lora_alpha,
            targets=tuple(t for t in args.lora_targets.split(",") if t),
            max_loras=args.max_loras, device=device)
        adapter_cycle = [None] + names
        say(f"registered {len(names)} LoRA adapters "
              f"(rank {args.lora_rank}, targets {args.lora_targets}); "
              f"requests cycle over base + {names}")

    eng = ServeEngine(cfg, params, n_slots=args.slots,
                      max_len=args.max_len,
                      quantize=not args.no_quantize,
                      quant_bits=args.quant_bits,
                      quant_mode=args.quant_mode,
                      impl="reuse" if args.reuse else "auto",
                      eos_id=eos_id, long_prompt=args.long_prompt,
                      decode_chunk=args.decode_chunk,
                      fuse_qkv=args.fuse_qkv, adapters=registry,
                      paged=args.paged, kv_block_size=args.kv_block_size,
                      num_blocks=args.num_blocks,
                      prefix_cache=args.prefix_cache,
                      max_queue=args.max_queue, admission=args.admission,
                      speculate=args.speculate, spec_k=args.spec_k,
                      draft_bits=args.draft_bits,
                      draft_mode=args.draft_mode,
                      prefill_budget=args.prefill_budget, mesh=mesh,
                      device=device)
    rng = np.random.default_rng(0)
    lens = [int(x) for x in args.prompt_lens.split(",") if x]
    prompts = [rng.integers(0, cfg.vocab_size,
                            size=lens[i % len(lens)]).astype(np.int32)
               for i in range(args.requests)]
    adapters = [adapter_cycle[i % len(adapter_cycle)]
                for i in range(args.requests)]
    prios = [int(x) for x in args.priority.split(",") if x] or [0]
    streamed = {"tokens": 0, "streams": set()}
    on_token = None
    if args.stream:
        def on_token(req, tok):
            streamed["tokens"] += 1
            streamed["streams"].add(req.rid)
    per_req = dict(on_token=on_token,
                   ttft_deadline_s=args.ttft_deadline_s,
                   itl_deadline_s=args.itl_deadline_s)
    t0 = time.time()
    if args.arrival_rate:
        # open loop: requests land on their own clock; the engine keeps
        # stepping between arrivals and sheds per --admission/--deadline-s
        at = arrival_times(args.arrival_rate, len(prompts))
        i = 0
        while True:
            now = time.time() - t0
            if mesh is not None:        # one arrival clock for every rank
                now = tp.broadcast_host(now, mesh)
            while i < len(prompts) and at[i] <= now:
                eng.submit(prompts[i], max_new=args.max_new,
                           adapter=adapters[i],
                           priority=prios[i % len(prios)],
                           deadline_s=args.deadline_s, **per_req)
                i += 1
            if eng.step():
                continue
            if i >= len(prompts):
                break
            time.sleep(min(0.002, max(0.0, at[i] - (time.time() - t0))))
        reqs = list(eng.finished)
    elif args.stream or args.ttft_deadline_s is not None \
            or args.itl_deadline_s is not None:
        # closed loop with per-request streaming or deadline state: submit
        # explicitly instead of going through generate()
        for i, p in enumerate(prompts):
            eng.submit(p, max_new=args.max_new, adapter=adapters[i],
                       priority=prios[i % len(prios)],
                       deadline_s=args.deadline_s, **per_req)
        while eng.step():
            pass
        reqs = list(eng.finished)
    else:
        reqs = eng.generate(prompts, max_new=args.max_new,
                            return_requests=True, adapters=adapters)
    dt = time.time() - t0
    toks = sum(len(r.tokens) for r in reqs)
    bits = cfg.quant_bits if args.quant_bits is None else args.quant_bits
    mode = "bf16" if args.no_quantize else (
        f"axllm-{args.quant_mode}{bits}"
        + ("+reuse" if args.reuse else ""))
    lora_tag = f", {eng.stats.lora_requests} LoRA requests" if args.lora \
        else ""
    mesh_tag = f", mesh {args.mesh_shape}" if mesh is not None else ""
    say(f"[{mode}] {len(reqs)} requests, {toks} tokens, "
        f"{toks/dt:.1f} tok/s, occupancy "
        f"{eng.stats.mean_occupancy:.2f}{lora_tag}{mesh_tag}")
    st = eng.stats
    if args.arrival_rate:
        say(f"  open-loop [{args.arrival_rate}, admission="
              f"{args.admission}]: rejected={st.rejected} "
              f"expired={st.expired} preempted={st.preempted} "
              f"restored={st.restored} ({st.fast_restores} fast)")
    if args.stream:
        say(f"  streaming: {streamed['tokens']} tokens emitted across "
              f"{len(streamed['streams'])} streams at chunk harvest "
              f"(cancelled={st.cancelled}, expired={st.expired})")
    if args.prefill_budget:
        say(f"  chunked prefill [budget={args.prefill_budget}]: "
              f"{st.prefill_chunks} chunks over {st.prefill_waves} waves, "
              f"{st.preempted_prefill} mid-prefill preemptions")
    if args.speculate:
        say(f"  speculative [k={args.spec_k}, "
              f"{args.draft_mode}{args.draft_bits} draft]: "
              f"{st.accepted_draft_tokens}/{st.drafted_tokens} drafts "
              f"accepted ({st.acceptance_rate:.2f}), "
              f"{st.accepted_tokens_per_step:.2f} tokens/slot-round "
              f"over {st.spec_rounds} rounds")
    if args.paged:
        say(f"  paged: {st.prefix_hit_tokens} prefix-hit tokens, "
              f"{st.blocks_in_use} blocks cached, "
              f"{st.cow_copies} CoW copies "
              f"(block={args.kv_block_size}, "
              f"prefix_cache={'on' if args.prefix_cache else 'off'})")
    for r in reqs[:3]:
        tag = " [truncated]" if r.truncated else ""
        ad = f" [{r.adapter}]" if r.adapter else ""
        say(f"  -> {r.tokens[:12]}{tag}{ad}")
    if args.stats:
        say(json.dumps(eng.stats.as_dict(), indent=2, sort_keys=True))
    return reqs


if __name__ == "__main__":
    main()
